"""The device mesh of the node-sharded solve.

A mesh is an ordered tuple of ``torch.device``s, one per shard of the
node axis. It may name one device several times: each shard then keeps
its own node block on that device, which is how the CPU tests (``[cpu] *
m``) and a one-card run (``[cuda:0] * 4``) drive a multi-shard solve.

The node axis is split into contiguous blocks of equal size, padded up to
a multiple of the shard count; pad nodes are never candidates. A node's
global index is its encoded row, so ties break to the same node whatever
the split.

``ShardedSolver`` and ``sharded_solve_allocate`` are the JAX package's
GSPMD rung's surface (kube_batch_tpu/parallel/sharded.py). The port has
no GSPMD: on a mesh, that rung is the twin's loop with the node axis
sharded, which is what ``ShardedBlockSolver`` runs (kernel B4 on the
cards, its plain version on the CPU), so the surface is a thin layer over
it. The JAX module caches its jitted programs per (devices, key set,
flags) in ``_sharded_programs``; the port compiles nothing per snapshot
(its kernels are built once per process), and a solver holds one
snapshot's statics, so
that cache has no counterpart: what a warm cycle can reuse, the static
blocks, the tensor arena keeps (``arena=``).
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

# The axis a mesh slab of the tensor arena splits along (ops/encode_cache
# ``TensorArena``); other names are replicated on every shard. The
# node-axis arrays carry the node dimension first, pod_sc ([task groups,
# nodes]) second; the sharded rung's static blocks (``ShardedBlockSolver``)
# lay the padded node axis last.
SHARD_AXIS = {
    **{name: 0 for name in NODE_AXIS_ARRAYS},
    "pod_sc": 1,
    "sharded_cnode": 1,
    "sharded_nalloc": 1,
    "sharded_nmax": 0,
    "sharded_nihs": 0,
    "sharded_nrhs": 0,
    # kernel B4's per-card statics (ops/mesh_solve ``MeshSolve``): one row a
    # card, over a mesh of the cards
    "mesh_istatic": 0,
    "mesh_fstatic": 0,
    "mesh_gidx": 0,
}


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


class ShardedSolver:
    """The JAX package's multi-device solver surface: the port's sharded
    rung, ``ShardedBlockSolver`` on ``mesh`` (one shard per entry), over
    the encoder's float32 arrays (numpy or CPU tensors). ``solve(None)``
    starts fresh, ``solve(state)`` resumes after a host step; states come
    back as CPU tensors. ``arena`` keeps the static blocks resident. The
    JAX ``axis_name`` has no counterpart (a port mesh has one axis), nor
    its divisibility error: the rung pads the node axis itself."""

    def __init__(self, arrays: dict, mesh, enable_drf: bool = False, enable_proportion: bool = False, arena=None):
        from kube_batch_tpu_torch.ops.carry import arrays_from_numpy
        from kube_batch_tpu_torch.parallel.sharded_block import ShardedBlockSolver

        self.inner = ShardedBlockSolver(arrays_from_numpy(arrays), tuple(mesh), enable_drf, enable_proportion, arena=arena)

    def solve(self, state=None):
        return self.inner.solve(state)


def sharded_solve_allocate(arrays: dict, mesh, enable_drf: bool = False, enable_proportion: bool = False, arena=None):
    """One ``ShardedSolver(...).solve(None)`` as a ``SolveResult`` (CPU
    tensors)."""
    from kube_batch_tpu_torch.ops.kernels import result_of

    return result_of(ShardedSolver(arrays, mesh, enable_drf, enable_proportion, arena).solve(None))
