"""The thread-block-cluster geometry of both kernels, on the CPU.

Each kernel sweeps its node axis with one cluster of k CTAs, each owning a
contiguous slice, one node per thread: k = ceil(N / 512), at most 16,
slices of ceil(N / k) nodes (ops/cluster.py). The block step (B2) narrows
its CTAs to the slice; the fused solve (B1) keeps 512 threads and holds
its slice's node state, and where it fits the replicated job, queue and
class state, in shared memory (ops/fused_solve.py solve_geometry). The
kernels read this geometry from their argument structs, so the structs'
ctypes mirrors are checked against the CUDA sources too.
"""

import re

import pytest

from kube_batch_tpu_torch.ops import block_step as bs
from kube_batch_tpu_torch.ops import fused_solve as fs
from kube_batch_tpu_torch.ops import mesh_solve as ms
from kube_batch_tpu_torch.ops import nvcc
from kube_batch_tpu_torch.ops.cluster import CTA_WIDTH, MAX_CLUSTER, cluster_shape

SIZES = [1, 40, 256, 1023, 1024, 1025, 1280, 5120, 8192, 8193]


def dims(N: int, R: int = 2, J: int = 2048, Q: int = 1, C: int = 4) -> fs.Dims:
    return fs.Dims(T=50_000, N=N, J=J, Q=Q, C=C, GT=1, R=R, P=0, max_iter=1, drf=True, proportion=True)


@pytest.mark.parametrize("N", SIZES)
def test_block_geometry(N):
    g = cluster_shape(N)
    assert g.k == min(MAX_CLUSTER, -(-N // CTA_WIDTH))
    assert g.slice == -(-N // g.k)
    assert g.threads % 32 == 0 and g.threads <= CTA_WIDTH
    # one node per thread up to 16 x 512 nodes; a strided walk past that
    assert (g.threads >= g.slice) == (N <= MAX_CLUSTER * CTA_WIDTH)
    bounds = g.bounds(N)
    assert bounds[0][0] == 0 and bounds[-1][1] == N
    for (lo, hi), (nxt, _) in zip(bounds, bounds[1:]):
        assert hi == nxt
    assert all(0 < hi - lo <= g.slice for lo, hi in bounds), "every CTA owns nodes"


@pytest.mark.parametrize("N", SIZES)
def test_solve_geometry(N):
    g = fs.solve_geometry(dims(N))
    assert (g.shape.k, g.shape.slice) == (cluster_shape(N).k, cluster_shape(N).slice)
    assert g.shape.threads == CTA_WIDTH
    assert g.node_words == (3 * 2 + 2) * g.shape.slice
    assert g.rep_words == 2048 * (8 + 2) + 1 * (3 + 3 * 2) + 4 * (5 + 2 * 8)
    # the headline's state (J = 2,048 jobs at R = 2) fits beside the slice
    assert g.rep_in_smem
    assert g.smem_bytes == 4 * (g.node_words + g.rep_words) <= fs.SMEM_BUDGET
    fs.check_envelope(dims(N))


def test_replicated_state_moves_to_global_scratch_when_it_does_not_fit():
    g = fs.solve_geometry(dims(5120, J=6000))
    assert not g.rep_in_smem
    assert g.smem_bytes == 4 * g.node_words  # the node slice alone
    fs.check_envelope(dims(5120, J=6000))


def test_envelope_names_the_shared_memory_limit():
    # 16 CTAs of 8,192 nodes at R = 8: 104 B per node is 851,968 B per CTA
    with pytest.raises(ValueError, match="shared memory"):
        fs.solve_geometry(dims(16 * 8192, R=8))
    # the largest node axis at R = 2 that fits: 32 B per node
    per_cta = fs.SMEM_BUDGET // 32
    fs.solve_geometry(dims(MAX_CLUSTER * per_cta))
    with pytest.raises(ValueError, match="shared memory"):
        fs.solve_geometry(dims(MAX_CLUSTER * (per_cta + 1)))
    # the limit is the fused-solve kernel's alone: the packed layout (the
    # plain versions, the block step) takes the same dims
    fs.check_envelope(dims(16 * 8192, R=8))
    fs.check_envelope(dims(MAX_CLUSTER * (per_cta + 1)))


def test_world_past_the_kernels_shared_memory_still_solves_on_the_cpu():
    """A world whose node slices overflow B1's shared memory packs and
    solves through both plain paths (the fused rung's and the sharded
    rung's, which launch no fused-solve kernel); only the kernel's launch
    geometry refuses it."""
    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch.parallel import make_mesh
    from kube_batch_tpu_torch.solve import allocate, solver_arrays

    n_nodes = MAX_CLUSTER * (fs.SMEM_BUDGET // 32) + 1  # R = 2: 32 B per node
    cluster = models.synthetic(40, n_nodes, tasks_per_job=4)
    fused = allocate(cluster, device="cpu")
    sharded = allocate(cluster, mesh=make_mesh(devices=["cpu"] * 2))
    assert fused.encoded.n_nodes == n_nodes
    assert len(fused.binds) == 40
    assert (sharded.binds, sharded.pipelined) == (fused.binds, fused.pipelined)
    dims = fs.pack(solver_arrays(cluster)[1], True, True).dims
    with pytest.raises(ValueError, match="shared memory"):
        fs.solve_geometry(dims)


@pytest.mark.parametrize("J, Q, C, R", [(2048, 1, 4, 2), (37, 5, 9, 8), (1, 1, 1, 1), (6000, 3, 2, 4)])
def test_replicated_layout_matches_the_kernels(J, Q, C, R):
    """``_rep_words`` sizes each CTA's replicated region; the kernel lays
    it out in ``rep_layout`` (and traps on a launch whose sizes disagree).
    The sum of the source's strides must equal it."""
    text = _source("fused_solve.cu")
    body = re.search(r"Rep rep_layout\(.*?\{(.*?)\n\}", text, re.S).group(1)
    strides = re.findall(r"\b[wf] \+= ([^;]+);", body)
    assert len(strides) == 22  # one per array of the Rep struct
    env = {"J": J, "Q": Q, "C": C, "R": R, "R8": fs.R8}
    assert sum(eval(e, {}, env) for e in strides) == fs._rep_words(J, Q, C, R)


def _source(name: str) -> str:
    """A CUDA source with the csrc headers it includes appended: what the
    compiler sees of its structs (B1's and B4's shared loop lives in
    solve_loop.cuh)."""
    with open(f"{nvcc.CSRC_DIR}/{name}") as f:
        text = f.read()
    for header in re.findall(r'#include "([^"]+)"', text):
        text += "\n" + _source(header)
    return text


def test_empty_axis_counts_as_one_node():
    assert cluster_shape(0) == cluster_shape(1)


def _struct_fields(source: str, name: str) -> list[str]:
    """The field names of `struct name { ... };` in a CUDA source, in order."""
    body = re.search(r"struct " + name + r" \{(.*?)\n\};", source, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        first, *rest = decl.split(",")
        names.append(re.split(r"[\s*]+", first.strip())[-1])
        names += [r.strip().lstrip("*").strip() for r in rest]
    return [re.sub(r"\[.*\]", "", n) for n in names]


@pytest.mark.parametrize(
    "source, struct, mirror",
    [
        ("fused_solve.cu", "SolveArgs", fs._Args),
        ("block_step.cu", "BlockArgs", bs._Args),
        ("block_step.cu", "TaskFields", bs.Task),
        ("mesh_solve.cu", "MeshArgs", ms._Args),
        ("mesh_solve.cu", "SolveArgs", fs._Args),
    ],
)
def test_argument_structs_mirror_the_cuda_sources(source, struct, mirror):
    text = _source(source)
    assert _struct_fields(text, struct) == [name for name, _ in mirror._fields_]
