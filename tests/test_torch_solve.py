"""The port's solve against the JAX package's, field for field.

The JAX package encodes each world once (float32, jax x64 off); the same
arrays enter the port through `carry.arrays_from_numpy`. Then

- the port's torch twin (ops/kernels.py) is held against the JAX twin
  `solve_allocate_state`, and
- the port's fused solve on the CPU — `FusedSolver(device="cpu")`, which
  runs `fused_solve_plain`, the CUDA kernel's plain version, over the
  kernel's packed buffers — against `PallasSolver(interpret=True)`.

Integer fields are exact; float state uses assert_allclose at its default
rtol, as tests/test_pallas_solve.py does. The kernel itself runs only on
the card (tests/test_torch_kernel.py).
"""

import functools
import random

import numpy as np
import pytest
import torch

from kube_batch_tpu import models as jax_models
from kube_batch_tpu.ops.kernels import solve_allocate_state
from kube_batch_tpu.ops.pallas_solve import PallasSolver
from kube_batch_tpu.testing import x64_enabled

from kube_batch_tpu_torch import models as torch_models
from kube_batch_tpu_torch.ops import carry, fused_solve as fs
from kube_batch_tpu_torch.ops import kernels as tk

from test_torch_encode import jax_encode, solver_arrays, torch_encode
from test_xla_allocate import gen_cluster

INT_FIELDS = (
    "it", "step", "cur", "ptr", "assigned_node", "assigned_kind", "assign_pos",
    "ntasks", "nports", "ready_cnt", "job_active", "q_dropped", "q_alloc_has_sc",
    "paused_at",
)
FLOAT_FIELDS = ("idle", "rel", "used", "job_alloc", "q_alloc")


def pod_affinity_world():
    """One plain gang plus a job whose second pod carries a required pod
    affinity term: the solve must pause there (host-only task)."""
    from kube_batch_tpu.apis.types import Affinity, PodAffinityTerm
    from kube_batch_tpu.testing import (
        build_cluster, build_node, build_pod, build_pod_group, build_queue,
        build_resource_list,
    )

    nodes = [build_node(f"n{i}", build_resource_list(cpu=4, memory="4Gi", pods=10)) for i in range(3)]
    pods = [
        build_pod(name=f"a-{i}", group_name="a", labels={"app": "a"},
                  req=build_resource_list(cpu=1, memory="256Mi"))
        for i in range(2)
    ]
    pods += [
        build_pod(name=f"b-{i}", group_name="b", req=build_resource_list(cpu=1, memory="256Mi"))
        for i in range(2)
    ]
    pods[3].affinity = Affinity(pod_affinity_required=[PodAffinityTerm(label_selector={"app": "a"})])
    pgs = [build_pod_group("a", min_member=2), build_pod_group("b", min_member=1)]
    return build_cluster(pods, nodes, pgs, [build_queue("default")])


# name -> (cluster factory, enable_drf, enable_proportion, compare with Pallas)
CASES = {
    "synthetic_40_5": (lambda: jax_models.synthetic(40, 5), True, True, True),
    "synthetic_200_20": (lambda: jax_models.synthetic(200, 20), True, True, True),
    "multi_tenant_ml_8_8_3": (lambda: jax_models.multi_tenant_ml(8, 8, 3), True, True, True),
    "no_drf_no_proportion": (lambda: jax_models.synthetic(60, 6), False, False, True),
    "drf_only": (lambda: jax_models.multi_queue(120, 12, 3, 6), True, False, True),
    "proportion_only": (lambda: jax_models.multi_queue(120, 12, 3, 6), False, True, True),
    "tasks_128": (lambda: jax_models.synthetic(128, 4, tasks_per_job=8), True, True, True),
    "tasks_129": (lambda: jax_models.synthetic(129, 5, tasks_per_job=3), True, True, True),
    "single_node_single_job": (lambda: jax_models.synthetic(6, 1, tasks_per_job=6), True, True, True),
    "more_tasks_than_capacity": (lambda: jax_models.synthetic(300, 2, tasks_per_job=10), True, True, True),
    "pod_affinity_pause": (pod_affinity_world, True, True, True),
    # ~1600 iterations: too long for the interpreted Pallas kernel; held
    # against the JAX twin (and, on the card, the kernel against its plain
    # version — chip_smoke.py)
    "preempt_mix_pipelines": (lambda: jax_models.preempt_mix(2000, 40, seed=1), True, True, False),
    **{f"gen_cluster_{s}": (functools.partial(gen_cluster, s), True, True, True) for s in range(4)},
}


@functools.lru_cache(maxsize=None)
def reference(case):
    """(solver arrays, JAX twin state, Pallas interpret state or None)."""
    make, drf, prop, with_pallas = CASES[case]
    a = solver_arrays(jax_encode(make(), drf, prop))
    with x64_enabled(False):
        twin = solve_allocate_state(a, None, enable_drf=drf, enable_proportion=prop)
        twin = type(twin)(*(np.asarray(x) for x in twin))
        pallas = (
            PallasSolver(a, drf, prop, interpret=True, fetch_f32=True).solve(None)
            if with_pallas
            else None
        )
    return a, twin, pallas


def assert_states_equal(ref, got, ctx):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(ref, f)), np.asarray(getattr(got, f)), err_msg=f"{ctx}: {f}"
        )
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(
            np.asarray(getattr(ref, f)), np.asarray(getattr(got, f)), err_msg=f"{ctx}: {f}"
        )


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_matches_jax_twin(case):
    a, twin, _ = reference(case)
    _, drf, prop, _ = CASES[case]
    got = tk.solve_allocate_state(carry.arrays_from_numpy(a), None, drf, prop)
    assert_states_equal(twin, carry.state_to_numpy(got), case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_plain_matches_pallas_interpret(case):
    a, twin, pallas = reference(case)
    _, drf, prop, with_pallas = CASES[case]
    launches = fs.fused_solve.launches
    got = fs.FusedSolver(carry.arrays_from_numpy(a), drf, prop, device="cpu").solve()
    assert fs.fused_solve.launches == launches  # CPU tensors never launch
    assert_states_equal(pallas if with_pallas else twin, carry.state_to_numpy(got), case)


@pytest.mark.parametrize("case", ["more_tasks_than_capacity", "preempt_mix_pipelines"])
def test_work_counter_leaves_the_solve_unchanged(case):
    """The twin's node-axis work counter (the operation count of the
    kernel's roofline bound) changes nothing in the solve, and its counts
    are ordered: every assignment scored at least one node, every scored
    node was fit-tested, and no popped task tested more than the valid
    nodes."""
    a, twin, _ = reference(case)
    _, drf, prop, _ = CASES[case]
    work = {}
    got = tk.solve_allocate_step(carry.arrays_from_numpy(a), None, drf, prop, work)
    assert_states_equal(twin, carry.state_to_numpy(got), case)
    popped = int((got.ptr.numpy() - a["job_start"]).sum())
    valid_nodes = int((a["node_ok"] & a["node_valid"]).sum())
    assert int(got.step) <= work["scored_nodes"] <= work["fit_nodes"] <= popped * valid_nodes
    assert work["scored_nodes"] > 0


def test_pause_resume_carries_jax_state():
    """A paused JAX state enters the port through state_from_numpy; both
    port solvers resume from it and pause again at the same host-only
    task with the state unchanged but for the iteration count."""
    a, twin, _ = reference("pod_affinity_pause")
    assert int(twin.paused_at) >= 0
    ta = carry.arrays_from_numpy(a)
    for resumed in (
        tk.solve_allocate_state(ta, carry.state_from_numpy(twin), True, True),
        fs.FusedSolver(ta, True, True, device="cpu").solve(carry.state_from_numpy(twin)),
    ):
        r = carry.state_to_numpy(resumed)
        assert int(r.paused_at) == int(twin.paused_at)
        assert int(r.it) == int(twin.it) + 1
        assert_states_equal(twin._replace(it=r.it), r, "resume")


def test_port_encode_feeds_the_same_solve():
    """The slice end to end on the CPU: the port's own encode of the
    port's own world solves to the JAX reference's state."""
    a, twin, _ = reference("preempt_mix_pipelines")
    ta = carry.arrays_from_numpy(solver_arrays(torch_encode(torch_models.preempt_mix(2000, 40, seed=1))))
    got = fs.FusedSolver(ta, True, True, device="cpu").solve()
    assert int((got.assigned_kind == tk.KIND_PIPELINED).sum()) > 0
    assert_states_equal(twin, carry.state_to_numpy(got), "port encode")


def test_pod_sc_refresh_refolds_affinity():
    """A caller that replaces a["pod_sc"] between solves (live
    InterPodAffinity scores) gets the re-folded affinity term, as the
    reference PallasSolver does."""
    a, _, _ = reference("synthetic_40_5")
    rng = np.random.default_rng(5)
    pod_sc = rng.integers(0, 11, a["pod_sc"].shape).astype(np.float32)
    ta = carry.arrays_from_numpy(a)
    solver = fs.FusedSolver(ta, True, True, device="cpu")
    solver.solve()
    ta["pod_sc"] = torch.from_numpy(pod_sc)
    got = carry.state_to_numpy(solver.solve())
    with x64_enabled(False):
        want = PallasSolver({**a, "pod_sc": pod_sc}, True, True, interpret=True, fetch_f32=True).solve(None)
    assert_states_equal(want, got, "pod_sc refresh")


@pytest.mark.parametrize("seed", [7, 3])
def test_float32_divide_is_correctly_rounded(seed):
    """torch's float32 `/` equals numpy's correctly rounded quotient and
    the twin's ieee_div bit for bit (the vectors of tests/test_ieee_div.py):
    the kernel's __fdiv_rn needs no Dekker correction."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(1e-3, 1e9, 100_000).astype(np.float32)
    y = rng.uniform(1e-3, 1e9, 100_000).astype(np.float32)
    got = torch.from_numpy(x) / torch.from_numpy(y)
    np.testing.assert_array_equal(got.numpy(), x / y)
    np.testing.assert_array_equal(tk.ieee_div(torch.from_numpy(x), torch.from_numpy(y)).numpy(), x / y)


def test_least_requested_floor_boundaries():
    """An empty node scores exactly 10 per dimension (floor of an exact
    quotient), on the vectors of tests/test_ieee_div.py."""
    rng = np.random.default_rng(0)
    cap = rng.integers(1000, 256_000, 50_000).astype(np.float32)
    req = (cap * rng.random(50_000).astype(np.float32)).astype(np.int64).astype(np.float32)
    c, r = torch.from_numpy(cap), torch.from_numpy(req)
    got = torch.floor(tk.ieee_div((c - r) * 10.0, c)).numpy()
    np.testing.assert_array_equal(got, np.floor((cap - req) * np.float32(10.0) / cap))
    assert (tk._least_dim(torch.zeros_like(c), c) == 10).all()


def _envelope_arrays(R, P):
    rng = random.Random(0)
    a = solver_arrays(jax_encode(jax_models.synthetic(20, 4)))
    T, N = a["task_req"].shape[0], a["node_idle"].shape[0]
    grow = R - a["eps"].shape[0]
    for k in ("task_req", "task_res", "node_idle", "node_rel", "node_used", "node_alloc",
              "job_alloc0", "q_alloc0", "q_deserved", "q_dims", "drf_total", "drf_dims", "eps"):
        x = a[k]
        pad = np.full(x.shape[:-1] + (grow,), 10 if k == "eps" else 0, x.dtype)
        a[k] = np.concatenate([x, pad], axis=-1)
    a["task_ports"] = np.zeros((T, P), bool)
    a["task_ports"][0, rng.randrange(P)] = True
    a["node_ports"] = np.zeros((N, P), bool)
    return carry.arrays_from_numpy(a)


@pytest.mark.parametrize(
    "R,P,limit",
    [(9, 1, "resource rank 9"), (2, 32, "32 host ports")],
)
def test_envelope_raises_naming_the_limit(R, P, limit):
    with pytest.raises(ValueError, match=limit):
        fs.pack(_envelope_arrays(R, P), True, True)


def test_envelope_edges_pack():
    """R = 8 and 31 host ports are inside the envelope."""
    p = fs.pack(_envelope_arrays(8, 31), True, True)
    assert (p.dims.R, p.dims.P) == (8, 31)


def test_wrapper_checks_its_buffers():
    a = carry.arrays_from_numpy(solver_arrays(jax_encode(jax_models.synthetic(20, 4))))
    p = fs.pack(a, True, True)
    st = fs.pack_state(p.dims, tk.init_state(a, True, True), a["job_queue"])
    with pytest.raises(TypeError):
        fs.fused_solve(p, fs.PackedState(p.dims, st.istate.long(), st.fstate))
    with pytest.raises(ValueError):
        fs.fused_solve(p, fs.PackedState(p.dims, st.istate[:-1], st.fstate))
    with pytest.raises(ValueError):
        fs.fused_solve(fs.Packed(p.dims, p.istatic, p.fstatic.to("meta")), st)
