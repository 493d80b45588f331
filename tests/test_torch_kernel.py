"""The fused-solve CUDA kernel against its plain version, on the card.

The kernel has no CPU mode, so every test here carries the `cuda` marker
and skips without a GPU. This file imports only the port (no jax), so it
also runs where the JAX package is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel.py

Integer state must match exactly and float state bit for bit: both sides
run the same float32 operations in the same order (the kernel is built
without FMA contraction and divides with correct rounding).

The kernel runs as a cluster of CTAs, each owning a slice of the node axis
(``fs.solve_geometry``); the edited worlds below put the winner on a
slice's first or last node, tie the best scores across CTAs (with -0.0
against +0.0 too), leave no candidate, leave a whole slice of pad nodes,
pause at a host-only task and resume, and move the replicated state out of
shared memory.
"""

import numpy as np
import pytest
import torch

from kube_batch_tpu_torch import models
from kube_batch_tpu_torch.ops import fused_solve as fs
from kube_batch_tpu_torch.ops.carry import arrays_from_numpy
from kube_batch_tpu_torch.ops.kernels import init_state
from kube_batch_tpu_torch.solve import solver_arrays

WORLDS = {
    "synthetic_200_20": lambda: models.synthetic(200, 20),
    "multi_queue_400_40": lambda: models.multi_queue(400, 40, 4, 10),
    "multi_tenant_ml_8_8_3": lambda: models.multi_tenant_ml(8, 8, 3),
    "preempt_mix_2000_40_seed1": lambda: models.preempt_mix(2000, 40, seed=1),
}


def _arrays(cluster) -> dict:
    return arrays_from_numpy(solver_arrays(cluster)[1])


@pytest.mark.cuda
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_kernel_matches_plain_on_card(world):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    a = _arrays(WORLDS[world]())
    p = fs.pack(a, True, True)
    init = fs.pack_state(p.dims, init_state(a, True, True), a["job_queue"])
    plain = fs.fused_solve(p, fs.PackedState(p.dims, init.istate.clone(), init.fstate.clone()))
    launches = fs.fused_solve.launches
    dev = fs.fused_solve(p.to("cuda"), fs.PackedState(p.dims, init.istate.cuda(), init.fstate.cuda()))
    torch.cuda.synchronize()
    assert fs.fused_solve.launches == launches + 1
    assert torch.equal(dev.istate.cpu(), plain.istate)
    assert torch.equal(dev.fstate.cpu(), plain.fstate)


def _packed(world):
    a = _arrays(world)
    p = fs.pack(a, True, True)
    return p, fs.pack_state(p.dims, init_state(a, True, True), a["job_queue"])


def _solve_both(p, init):
    """(plain, kernel) final states from the same packed inputs."""
    plain = fs.fused_solve(p, fs.PackedState(p.dims, init.istate.clone(), init.fstate.clone()))
    launches = fs.fused_solve.launches
    dev = fs.fused_solve(p.to("cuda"), fs.PackedState(p.dims, init.istate.cuda(), init.fstate.cuda()))
    torch.cuda.synchronize()
    assert fs.fused_solve.launches == launches + 1
    return plain, fs.PackedState(p.dims, dev.istate.cpu(), dev.fstate.cpu())


def _assert_same(plain, dev):
    assert torch.equal(dev.istate, plain.istate)
    assert torch.equal(dev.fstate, plain.fstate)


def _slice_edges(p) -> list[int]:
    """The first and last node of every CTA's slice."""
    return sorted({n for lo, hi in fs.solve_geometry(p.dims).shape.bounds(p.dims.N) for n in (lo, hi - 1)})


def _only_candidates(v, nodes):
    cnode = v["cnode"].view(-1, v["nmax"].shape[0])
    keep = torch.zeros(cnode.shape[1], dtype=torch.bool)
    keep[nodes] = True
    cnode[:, ~keep] = 0


def _edit_slice_edges(p, init):
    _only_candidates(p.views(), _slice_edges(p))


def _edit_cross_cta_ties(p, init):
    """Identical nodes, so every score ties across the CTAs; the slice edges
    carry a bonus, so the first winners sit at slice ends."""
    v, s = p.views(), init.views()
    N = p.dims.N
    for name in ("idle", "rel", "used"):
        rows = s[name].view(-1, N)
        rows[:] = rows[:, :1]
    s["ntasks"][:] = 0
    nalloc = v["nalloc"].view(2, N)
    nalloc[:] = nalloc[:, :1]
    affw = v["affw"].view(-1, N)
    affw[:] = 0.0
    affw[:, _slice_edges(p)[1:]] = 5.0  # not node 0: the edges tie with each other


def _edit_signed_zero(p, init):
    """Negative nodeorder weights on zero allocatable: every score is
    -0.0 + affw, and affw alternates -0.0 and +0.0, so candidates in
    different CTAs tie at -0.0 against +0.0."""
    v = p.views()
    N = p.dims.N
    v["wts"][:] = -1.0
    v["nalloc"][:] = 0.0
    affw = v["affw"].view(-1, N)
    signs = torch.where(torch.arange(N) % 2 == 0, 1.0, -1.0)
    affw[:] = 0.0 * signs
    _only_candidates(v, _slice_edges(p))


def _edit_no_candidate(p, init):
    s = init.views()
    s["idle"][:] = 0.0
    s["rel"][:] = 0.0


def _edit_pad_slice(p, init):
    """The last CTA's slice is all pad nodes (cnode = 0, nmax = 0, no state)."""
    v, s = p.views(), init.views()
    N = p.dims.N
    lo, hi = fs.solve_geometry(p.dims).shape.bounds(N)[-1]
    v["cnode"].view(-1, N)[:, lo:hi] = 0
    v["nmax"][lo:hi] = 0
    for name in ("idle", "rel", "used"):
        s[name].view(-1, N)[:, lo:hi] = 0.0


EDITS = {
    "slice_edges": _edit_slice_edges,
    "cross_cta_ties": _edit_cross_cta_ties,
    "signed_zero": _edit_signed_zero,
    "no_candidate": _edit_no_candidate,
    "pad_slice": _edit_pad_slice,
}


def _cluster_world():
    """1,500 nodes: a cluster of three CTAs of 512 nodes."""
    return models.synthetic(1500, 1500)


@pytest.mark.cuda
@pytest.mark.parametrize("edit", sorted(EDITS))
def test_kernel_matches_plain_across_cluster_slices(edit):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    p, init = _packed(_cluster_world())
    assert fs.solve_geometry(p.dims).shape.k >= 3
    EDITS[edit](p, init)
    plain, dev = _solve_both(p, init)
    _assert_same(plain, dev)
    assigned = int(plain.views()["scal"][1])
    if edit == "no_candidate":
        assert assigned == 0
    else:
        assert assigned > 0
        if edit in ("slice_edges", "signed_zero"):
            placed = plain.views()["tnode"][plain.views()["tnode"] >= 0]
            assert set(placed.tolist()) <= set(_slice_edges(p))


@pytest.mark.cuda
def test_kernel_pauses_and_resumes_like_plain():
    """A host-only task mid-solve: both stop there with every node slice and
    the replicated state written back; both resume from the kernel's
    fetched state once the task may run on the device."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    p, init = _packed(_cluster_world())
    v = p.views()
    host_only = int(v["tcls"][p.dims.T // 2])
    v["cho"][host_only] = 1
    plain, dev = _solve_both(p, init)
    _assert_same(plain, dev)
    paused = int(plain.views()["scal"][3])
    assert paused >= 0 and int(v["tcls"][paused]) == host_only
    v["cho"][host_only] = 0
    plain, dev = _solve_both(p, dev)
    _assert_same(plain, dev)
    assert int(plain.views()["scal"][3]) < 0


@pytest.mark.cuda
def test_kernel_keeps_replicated_state_in_global_scratch_when_it_must():
    """6,000 one-task jobs: the replicated job state no longer fits beside
    the node slice, so each CTA keeps its copy in global scratch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    p, init = _packed(models.synthetic(6000, 1100, tasks_per_job=1))
    geo = fs.solve_geometry(p.dims)
    assert not geo.rep_in_smem and geo.shape.k >= 3
    plain, dev = _solve_both(p, init)
    _assert_same(plain, dev)
    assert int(plain.views()["scal"][1]) > 0
