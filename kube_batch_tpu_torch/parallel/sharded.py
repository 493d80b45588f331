"""The device mesh of the node-sharded solve.

A mesh is an ordered tuple of ``torch.device``s, one per shard of the
node axis. It may name one device several times: each shard then keeps
its own node block on that device, which is how the CPU tests (``[cpu] *
m``) and a one-card run (``[cuda:0] * 4``) drive a multi-shard solve.

The node axis is split into contiguous blocks of equal size, padded up to
a multiple of the shard count; pad nodes are never candidates. A node's
global index is its encoded row, so ties break to the same node whatever
the split.
"""

from __future__ import annotations

import torch

# Arrays carrying the node dimension first (see ops/encode.py).
NODE_AXIS_ARRAYS = frozenset(
    {
        "node_idle",
        "node_rel",
        "node_used",
        "node_alloc",
        "node_ok",
        "node_valid",
        "node_max_tasks",
        "node_ntasks",
        "node_idle_has_sc",
        "node_rel_has_sc",
        "node_gid",
        "node_ports",
    }
)

AXIS_NAME = "nodes"


def make_mesh(n_devices: int | None = None, devices: list | None = None) -> tuple[torch.device, ...]:
    """A 1-D mesh over the node axis: ``devices`` as given (repeats
    allowed), or every visible CUDA device; the first ``n_devices`` of
    them when that is set. Raises RuntimeError when no CUDA device is
    visible and none were given: the mesh never falls back to the CPU."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices= to name them")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if n_devices is not None:
        if not 1 <= n_devices <= len(mesh):
            raise ValueError(f"n_devices={n_devices} outside 1..{len(mesh)}")
        mesh = mesh[:n_devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def node_blocks(n_nodes: int, m: int) -> list[tuple[int, int]]:
    """Contiguous [start, stop) blocks of the node axis for m shards, all
    of one size ceil(n_nodes / m); the last blocks may reach past
    ``n_nodes`` into pad nodes (global padded N = m * block size)."""
    if m < 1 or n_nodes < 1:
        raise ValueError(f"node_blocks needs n_nodes >= 1 and m >= 1, got {n_nodes}, {m}")
    size = -(-n_nodes // m)
    return [(k * size, (k + 1) * size) for k in range(m)]
