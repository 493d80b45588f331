"""The port's node-class compressed solve (ops/class_solve.py, kernel B3's
plain version), case for case with tests/test_class_solve.py, then held
against the JAX package.

The port runs ``torch_allocate`` on ``device: cpu`` with the size floor
off, the JAX suite's ``xla_allocate``; the mesh cases use ``mesh: cpu:N``
(the sharded rung's class layer: the table replicated, the expansion per
shard) where the JAX suite shards over its virtual CPU devices. Every
parity is bind for bind, and the JAX side runs with jax x64 off (the
production float32 policy).

Mirrored: compressed = uncompressed = serial; every mesh size; the
pod-affinity pause and resume; the split, re-merge and segment dynamics
(the ``stats()`` dict equal to the JAX one); the ``solve.class_table``
fault; the native dedup against its fallback; the class explain path; the
streaming micro-cycle over an absorbed peer patch; warm churn sessions
(the JAX suite counts compiles, the port counts kernel builds: B3 takes
its slot count as an argument, so a warm session builds nothing). The
three ``bench_diff`` cases test the JAX package's bench tooling
(``hack/bench_diff.py``) and are not mirrored.

Added: ``class_step_plain`` against JAX ``_class_step`` field for field on
seeded states (overflow, pause, drf and proportion, ``blocks`` 1, 2 and 4);
``uniform_pool``'s objects; the smoke dict; the three series; two shard
threads sharing one action's table; the kernel's argument block against
its CUDA struct; the card-side degrade rules; and, on a card only, kernel
B3 against its plain version.
"""

from __future__ import annotations

import os
import sys
import threading

import numpy as np
import pytest

import kube_batch_tpu.actions  # noqa: F401
import kube_batch_tpu.plugins  # noqa: F401
import kube_batch_tpu_torch.actions  # noqa: F401
import kube_batch_tpu_torch.plugins  # noqa: F401
from kube_batch_tpu import faults as jax_faults
from kube_batch_tpu import metrics as jax_metrics
from kube_batch_tpu import models as jax_models
from kube_batch_tpu.conf import parse_scheduler_conf as jax_parse
from kube_batch_tpu.framework import close_session as jax_close
from kube_batch_tpu.framework import open_session as jax_open
from kube_batch_tpu.ops import class_solve as jax_cs
from kube_batch_tpu.testing import FakeCache as JaxFakeCache
from kube_batch_tpu.testing import x64_enabled
from kube_batch_tpu_torch import faults, metrics, models
from kube_batch_tpu_torch.actions import torch_allocate as TA
from kube_batch_tpu_torch.conf import parse_scheduler_conf
from kube_batch_tpu_torch.framework import close_session, open_session
from kube_batch_tpu_torch.ops import class_solve as cs
from kube_batch_tpu_torch.ops import nvcc
from kube_batch_tpu_torch.testing import FakeCache
from test_torch_class_step import (
    SEGMENT_CASES,
    TIERS_YAML,
    _affinity_world,
    _churn_world,
    _Env,
    _Pkg,
    _port_pkg,
    _segment_inputs,
    assert_state_equal,
    run_port,
)

ENV = cs.ENV

N_SMOKE_NODES = 4 * 18
# stats() keys that are timings or name the rung, not the class table
_NOT_COMPARED = ("group_s", "kernel_s", "rung", "launches", "kernel_ms", "segment_ms")


@pytest.fixture(autouse=True)
def _clean_faults():
    for f in (faults, jax_faults):
        f.registry.reset()
        f.solver_ladder.reset()
    yield
    for f in (faults, jax_faults):
        f.registry.reset()
        f.solver_ladder.reset()


def run_jax(cluster, compress, mesh=None, action=None, tiers=TIERS_YAML):
    from kube_batch_tpu.actions.xla_allocate import XlaAllocateAction

    with _Env(compress), x64_enabled(False):
        action = action or XlaAllocateAction()
        args = {"xla_allocate": {"mesh": mesh}} if mesh else {}
        cache = JaxFakeCache(cluster)
        ssn = jax_open(cache, jax_parse(tiers).tiers, args)
        try:
            action.execute(ssn)
        finally:
            jax_close(ssn)
        return dict(cache.binder.binds), action


def run_serial(cluster, tiers=TIERS_YAML):
    from kube_batch_tpu_torch.actions.allocate import AllocateAction

    cache = FakeCache(cluster)
    ssn = open_session(cache, parse_scheduler_conf(tiers).tiers)
    try:
        AllocateAction().execute(ssn)
    finally:
        close_session(ssn)
    return dict(cache.binder.binds)


def table_stats(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if k not in _NOT_COMPARED}


@pytest.fixture(scope="module")
def smoke_sides():
    """Serial / uncompressed / compressed over the heterogeneous-pool
    world, in the port and in the JAX package, computed once."""
    serial = run_serial(cs._smoke_world())
    plain, _ = run_port(cs._smoke_world(), compress=False)
    comp, action = run_port(cs._smoke_world(), compress=True)
    jax_comp, jax_action = run_jax(jax_cs._smoke_world(), compress=True)
    return {
        "serial": serial,
        "plain": plain,
        "comp": comp,
        "tier": action.last_solver_tier,
        "stats": dict(action.last_class_stats or {}),
        "jax_comp": jax_comp,
        "jax_stats": dict(jax_action.last_class_stats or {}),
    }


# -- parity ------------------------------------------------------------------


def test_compressed_parity_vs_uncompressed_and_serial(smoke_sides):
    assert smoke_sides["comp"] == smoke_sides["plain"] == smoke_sides["serial"] == smoke_sides["jax_comp"]
    assert len(smoke_sides["comp"]) > 0
    assert smoke_sides["tier"] == "class_fused"
    s = smoke_sides["stats"]
    assert 0 < s["class_count"] < N_SMOKE_NODES
    assert s["compression_ratio"] > 5
    assert s["launches"] >= s["segments"] >= 1
    assert table_stats(s) == table_stats(smoke_sides["jax_stats"])


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_mesh_parity(smoke_sides, n_devices):
    """The class layer over the sharded rung: the slot axis replicated,
    the member expansion per shard; every mesh size reproduces the
    single-device binds exactly."""
    comp, action = run_port(cs._smoke_world(), compress=True, mesh=f"cpu:{n_devices}")
    assert action.last_mesh_size == n_devices, "the sharded path did not engage"
    assert action.last_solver_tier == "class_sharded"
    assert action.last_class_stats["rung"] == "sharded"
    assert comp == smoke_sides["plain"] == smoke_sides["jax_comp"]


def _jax_pkg():
    import kube_batch_tpu.apis.types as types
    import kube_batch_tpu.testing as testing

    return _Pkg(testing, types)


def test_pod_affinity_pause_resume_hybrid_parity():
    """Host-only tasks pause the class segment too: the expanded state is
    stepped on the host and re-enters the compressed solve, on and off a
    mesh, with binds identical to the uncompressed rungs and to the JAX
    package's compressed solve."""
    plain, _ = run_port(_affinity_world(_port_pkg()), compress=False)
    comp, a1 = run_port(_affinity_world(_port_pkg()), compress=True)
    comp4, a4 = run_port(_affinity_world(_port_pkg()), compress=True, mesh="cpu:4")
    jax_comp, _ = run_jax(_affinity_world(_jax_pkg()), compress=True)
    assert a1.last_solver_tier == "class_fused" and a1.last_timings["host_steps"] == 2
    assert a4.last_mesh_size == 4 and a4.last_solver_tier == "class_sharded"
    assert comp == comp4 == plain == jax_comp and len(plain) == 12


# -- split / re-merge / segment-cap dynamics ---------------------------------


def test_split_remerge_segment_dynamics_across_cycles():
    # extra arrivals push the solve past one segment's iteration budget
    # (c_pad/2 = 64 here), forcing the in-solve re-pack
    comp, action = run_port(cs._smoke_world(arrivals=12), compress=True)
    s1 = dict(action.last_class_stats)
    comp2, _ = run_port(cs._smoke_world(bound=comp, arrivals=18), compress=True, action=action)
    s2 = dict(action.last_class_stats)
    plain2, _ = run_port(cs._smoke_world(bound=comp, arrivals=18), compress=False)
    assert comp2 == plain2

    # a bound node's occupancy diverges from its class mid-solve
    assert s1["splits"] > 0
    # the segment iteration cap forces >=1 in-solve re-pack, where
    # bound-alike singletons collapse back into shared classes
    assert s1["segments"] >= 2
    assert s1["remerges"] + s2["remerges"] > 0
    # power-of-two slot bucket, sticky across cycles (never shrinks)
    for s in (s1, s2):
        assert s["c_pad"] & (s["c_pad"] - 1) == 0 and s["c_pad"] > 0
    assert s2["c_pad"] >= s1["c_pad"]
    assert 0 < s2["class_count"] <= s2["c_pad"]

    # the JAX package's solver, cycle for cycle: the same binds and the
    # same table statistics, field for field
    jcomp, jaction = run_jax(jax_cs._smoke_world(arrivals=12), compress=True)
    j1 = dict(jaction.last_class_stats)
    jcomp2, _ = run_jax(jax_cs._smoke_world(bound=jcomp, arrivals=18), compress=True, action=jaction)
    j2 = dict(jaction.last_class_stats)
    assert (jcomp, jcomp2) == (comp, comp2)
    assert table_stats(s1) == table_stats(j1)
    assert table_stats(s2) == table_stats(j2)
    assert s1["rung"] == "fused" and j1["rung"] == "xla"


# -- chaos: degrade, never drop ----------------------------------------------


def test_class_table_fault_degrades_loudly_with_parity(smoke_sides):
    """solve.class_table: a poisoned class table drops the segment to the
    uncompressed rung: binds identical, degrade and injection metered."""
    labels = {"tier": "class_solve", "reason": "class_table"}
    before = metrics.degraded_cycles.value(labels)
    fired = metrics.fault_injections.value({"point": "solve.class_table"})
    faults.registry.arm("solve.class_table", count=1)
    binds, action = run_port(cs._smoke_world(), compress=True)
    assert binds == smoke_sides["plain"]
    assert action.last_solver_tier == "fused"  # fell to the wrapped rung
    assert action.last_class_stats is None
    assert metrics.degraded_cycles.value(labels) == before + 1
    assert metrics.fault_injections.value({"point": "solve.class_table"}) == fired + 1


def test_a_host_side_table_failure_degrades_and_is_metered(monkeypatch, smoke_sides):
    labels = {"tier": "class_solve", "reason": "class_table"}
    before = metrics.degraded_cycles.value(labels)

    def broken(self, arrays):
        raise ValueError("stale key slab")

    monkeypatch.setattr(cs.ClassTable, "refresh_static", broken)
    binds, action = run_port(cs._smoke_world(), compress=True)
    assert binds == smoke_sides["plain"]
    assert action.last_solver_tier == "fused" and action.last_class_stats is None
    assert metrics.degraded_cycles.value(labels) == before + 1


@pytest.mark.parametrize("error", ["kernel", "build"])
def test_a_kernel_failure_raises_and_is_not_degraded(monkeypatch, error):
    """Kernel B3 failing on a card raises DeviceSolveError; a kernel that
    cannot be built raises KernelBuildError. Neither degrades nor meters,
    since each would fail every cycle."""
    labels = {"tier": "class_solve", "reason": "class_table"}
    before = metrics.degraded_cycles.value(labels)

    def failing(self, ca, state, seg_budget):
        if error == "kernel":
            raise cs.ClassKernelError("class_step launch failed: too many resources requested for launch")
        raise nvcc.KernelBuildError("nvcc failed on class_step.cu (1)")

    monkeypatch.setattr(cs.ClassCompressedSolver, "_segment", failing)
    want = TA.DeviceSolveError if error == "kernel" else nvcc.KernelBuildError
    with pytest.raises(want):
        run_port(cs._smoke_world(), compress=True)
    assert metrics.degraded_cycles.value(labels) == before


def test_an_organic_class_step_error_raises_and_is_not_degraded(monkeypatch):
    """Only the class_table fault point and host-side table failures
    degrade: an error of the segment itself (here a ValueError from
    class_step) leaves the action, unmetered."""
    labels = {"tier": "class_solve", "reason": "class_table"}
    before = metrics.degraded_cycles.value(labels)

    def refusing(*args, **kwargs):
        raise ValueError("class_step: a torch.float64 tensor")

    monkeypatch.setattr(cs, "class_step", refusing)
    with pytest.raises(ValueError, match="float64"):
        run_port(cs._smoke_world(), compress=True)
    assert metrics.degraded_cycles.value(labels) == before


# -- wide-key dedup: native vs fallback --------------------------------------


def _partition(first, inv):
    groups: dict[int, list[int]] = {}
    for row, cls in enumerate(inv):
        groups.setdefault(int(cls), []).append(row)
    for cls, members in groups.items():
        # the representative is a member of its own class
        assert int(first[cls]) in members
    return sorted(tuple(m) for m in groups.values())


def test_dedup_rows_native_vs_fallback_partition_parity():
    """Multi-slab keys (f64 matrix + i32 + bool matrix + 1-D i64) through
    the native multi-buffer hash and the np.unique fallback (forced by the
    native.class_dedup fault): class ORDER differs by contract, the
    partition into classes does not, and it is the JAX package's."""
    from kube_batch_tpu_torch import native

    assert native.get() is not None and hasattr(native.get(), "class_dedup")
    rng = np.random.default_rng(0)
    n = 4096
    slabs = [
        (rng.integers(0, 3, (n, 5)) * 0.5).astype(np.float64),
        rng.integers(0, 4, n).astype(np.int32),
        rng.integers(0, 2, (n, 3)).astype(bool),
        rng.integers(0, 2, n).astype(np.int64),
    ]
    first_n, inv_n = cs.dedup_rows(slabs)
    faults.registry.arm("native.class_dedup")
    first_f, inv_f = cs.dedup_rows(slabs)
    _, _, fired = faults.registry.active()["native.class_dedup"]
    assert fired >= 1, "fallback path never engaged"
    assert _partition(first_n, inv_n) == _partition(first_f, inv_f)
    assert len(first_n) == len(first_f) < n
    assert first_n.dtype == np.int64 and inv_n.dtype == np.int32
    first_j, inv_j = jax_cs.dedup_rows(slabs)
    assert _partition(first_j, inv_j) == _partition(first_n, inv_n)


# -- class-granularity explain -----------------------------------------------


def test_explain_class_path_byte_identical():
    """explain_batch_classes reproduces explain_batch exactly (eliminations,
    feasible counts, would-fit bits and the top-k near-miss list) from one
    evaluated row per class, and the JAX package's class path on the same
    inputs."""
    from kube_batch_tpu.ops import explain as jax_explain
    from kube_batch_tpu_torch.ops import explain as ops_explain
    from kube_batch_tpu_torch.ops.carry import arrays_from_numpy
    from kube_batch_tpu_torch.ops.encode import encode_session
    from kube_batch_tpu_torch.ops.kernels import solve_allocate_step

    ssn = open_session(FakeCache(cs._smoke_world()), parse_scheduler_conf(TIERS_YAML).tiers)
    enc = encode_session(ssn.jobs, ssn.nodes, ssn.queues, dtype=np.float64)
    close_session(ssn, discard=True)
    arrays = dict(enc.arrays)
    arrays.pop("task_created", None)
    arrays.update(w_least=np.float64(1), w_balanced=np.float64(1), w_aff=np.float64(1), w_podaff=np.float64(1))
    state = solve_allocate_step(arrays_from_numpy(arrays))
    rep_rows = ops_explain.pad_rows(
        [int(arrays["job_start"][j]) for j in range(len(enc.jobs)) if arrays["job_valid"][j]]
    )
    st = tuple(getattr(state, f).numpy() for f in ("idle", "rel", "used", "ntasks", "nports"))
    base = ops_explain.explain_batch(arrays, *st, rep_rows)
    comp = ops_explain.explain_batch_classes(arrays, *st, rep_rows)
    with x64_enabled(True):
        jax_comp = jax_explain.explain_batch_classes(arrays, *st, rep_rows)
    real = np.asarray(rep_rows) >= 0
    assert real.sum() > 0
    for b, c, j in zip(base, comp, jax_comp):
        np.testing.assert_array_equal(np.asarray(b)[real], np.asarray(c)[real])
        np.testing.assert_array_equal(np.asarray(c)[real], np.asarray(j)[real])


def test_explain_records_under_compression_equal_those_without(monkeypatch):
    """With explain on, a compressed cycle routes the pass to the class
    path (on the solve's device, over uploaded inputs: B1 never packed)
    and publishes the same records as an uncompressed cycle."""
    import json

    from kube_batch_tpu_torch.obs import explain
    from kube_batch_tpu_torch.ops import explain as ops_explain

    calls = []
    real = ops_explain.explain_batch_classes

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(ops_explain, "explain_batch_classes", spy)
    monkeypatch.setenv(explain.ENV, "1")
    explain.configure()
    explain.records.clear()
    try:
        def records(compress):
            # explain's per-plane world: one forced-unschedulable gang per
            # feasibility plane and a bindable gang, on duplicated nodes
            explain.records.clear()
            binds, action = run_port(explain._smoke_world(), compress, tiers=explain._SMOKE_TIERS)
            recs = sorted(explain.records.snapshot(), key=lambda r: json.dumps(r, sort_keys=True))
            return binds, action, json.dumps(recs, sort_keys=True)

        plain_binds, _, plain_recs = records(False)
        assert calls == []
        comp_binds, action, comp_recs = records(True)
        assert action.last_solver_tier == "class_fused"
        assert calls, "the compressed cycle did not take the class explain path"
        assert comp_binds == plain_binds
        assert comp_recs == plain_recs
        assert '"unschedulable"' in comp_recs and '"bound"' in comp_recs
    finally:
        explain.configure("off")
        explain.records.clear()


# -- streaming micro-cycle over an absorbed peer patch -----------------------


def _arrival_jobs(P, open_fn, close_fn, parse, cache_cls):
    T = P.testing
    pods, pgs = [], []
    for g in range(2):
        name = f"arrival-{g}"
        pgs.append(T.build_pod_group(name, min_member=2))
        for m in range(2):
            pods.append(
                T.build_pod(name=f"{name}-t{m}", group_name=name, req=T.build_resource_list(cpu="1", memory="2Gi"))
            )
    scratch = T.build_cluster(
        pods, [T.build_node("scratch", T.build_resource_list(cpu=1))], pgs, [T.build_queue("default")]
    )
    ssn = open_fn(cache_cls(scratch), parse(TIERS_YAML).tiers)
    jobs, queues = dict(ssn.jobs), dict(ssn.queues)
    close_fn(ssn, discard=True)
    return jobs, queues


def _micro_side(compress, port: bool):
    """A full cycle adopts the resident node table, a peer shard's bind
    lands as an absorb-mode occupancy patch, and the next micro-cycle
    solves fresh arrivals over the patched residents."""
    if port:
        from kube_batch_tpu_torch.streaming import StreamState, open_micro_session

        P, open_fn, close_fn, parse, cache_cls = _port_pkg(), open_session, close_session, parse_scheduler_conf, FakeCache
        action = TA.TorchAllocateAction()
        world = cs._smoke_world
        args = {"torch_allocate": {"device": "cpu", "min_device_pairs": "0"}}
    else:
        from kube_batch_tpu.actions.xla_allocate import XlaAllocateAction
        from kube_batch_tpu.streaming import StreamState, open_micro_session

        P, open_fn, close_fn, parse, cache_cls = _jax_pkg(), jax_open, jax_close, jax_parse, JaxFakeCache
        action = XlaAllocateAction()
        world = jax_cs._smoke_world
        args = {}
    with _Env(compress), x64_enabled(False):
        tiers = parse(TIERS_YAML).tiers
        cache = cache_cls(world())
        ssn = open_fn(cache, tiers, args)
        action.execute(ssn)
        st = StreamState()
        st.adopt_full_cycle(ssn)
        close_fn(ssn)
        full = dict(cache.binder.binds)

        # the peer shard fills large-000 down to 500m/1Gi: absorbed as an
        # occupancy patch, and consequential (the 1cpu/2Gi arrivals no
        # longer fit there)
        idle = st.nodes["large-000"].idle
        peer = P.testing.build_pod(
            name="peer-0", node_name="large-000", phase=P.types.PodPhase.RUNNING,
            req=P.testing.build_resource_list(
                cpu=f"{int(idle.milli_cpu) - 500}m", memory=f"{int(idle.memory // 2**20) - 1024}Mi",
            ),
        )
        assert st.apply_bound_patches([("add", "default/peer-0", peer)])
        assert st.valid

        jobs, queues = _arrival_jobs(P, open_fn, close_fn, parse, cache_cls)
        mssn = open_micro_session(cache, tiers, args, jobs, st.nodes, queues)
        mssn.micro_cycle = True
        action.execute(mssn)
        close_fn(mssn)
        micro = {k: v for k, v in cache.binder.binds.items() if k not in full}
        return full, micro, action.last_solver_tier


def test_streaming_micro_cycle_absorb_patch_class_parity():
    full_c, micro_c, tier = _micro_side(True, port=True)
    full_p, micro_p, _ = _micro_side(False, port=True)
    full_j, micro_j, _ = _micro_side(True, port=False)
    assert tier == "class_fused", "the micro-cycle did not solve at class level"
    assert full_c == full_p == full_j
    assert micro_c == micro_p == micro_j and len(micro_c) == 4
    # the absorbed peer occupancy was consequential
    assert "large-000" not in micro_c.values()


# -- warm churn: the slot bucket holds, nothing is built ---------------------


def test_warm_churn_sessions_zero_rebuilds():
    """The bench churn row at test scale: 1%-class node churn re-keys
    classes without moving the power-of-two class bucket, every session
    binds as the uncompressed rung, and warm sessions build no kernel (B3
    takes the slot count as an argument; on the CPU nothing is built at
    all)."""
    action = TA.TorchAllocateAction()
    pads = []
    for salt in (0, 1):
        run_port(_churn_world(salt), compress=True, action=action)
        pads.append(action.last_class_stats["c_pad"])
    builds = nvcc.builds
    for salt in (2, 3):
        comp, action = run_port(_churn_world(salt), compress=True, action=action)
        plain, _ = run_port(_churn_world(salt), compress=False)
        assert comp == plain
        pads.append(action.last_class_stats["c_pad"])
    assert nvcc.builds == builds
    assert len(set(pads)) == 1, pads
    assert action.last_solver_tier == "class_fused"
    assert action.last_class_stats["compression_ratio"] > 10
    assert action.last_class_stats["rekeys"] >= 0
    assert action._class_table.rebuilds == 1  # one cold dedup, then warm refreshes


# -- the solver's in-place segments against the functional path --------------


def _functional_segment(self, ca, state, seg_budget):
    """The solver's segment through the functional ``class_step``: a new
    state a segment, the input left as it was."""
    self.launches += 1
    return cs.class_step(ca, state, self.enable_drf, self.enable_proportion, seg_budget, self._max_iter)


def _cut_pack(real):
    """``ClassCompressedSolver._pack`` with the slot axis cut to its live
    slots, so a segment's first split overflows and the solver re-buckets."""

    def pack(self, st):
        state = real(self, st)
        fp = int(state.free_ptr)
        cut = {f: getattr(state, f)[:fp].clone() for f in cs.SLOT_FIELDS if f != "cpod_sc"}
        cut["cpod_sc"] = state.cpod_sc[:, :fp].clone()
        return state._replace(**cut)

    return pack


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_in_place_solver_binds_and_stats_equal_the_functional_path(monkeypatch, case):
    """A compressed torch_allocate session over each segment case's world
    binds the same through the solver's in-place segments (one
    ``ClassLaunch`` a state, on the CPU the plain version copied in) as
    through the functional ``class_step``, with equal ``stats()`` and
    launch counts; ``smoke_overflow`` packs its slot axis cut to the live
    slots, so the in-place path re-buckets the state it updated."""
    world = SEGMENT_CASES[case][0]
    rebuckets = []
    real_rebucket = cs.ClassCompressedSolver._rebucket

    def counting(self, state):
        rebuckets.append(int(state.cmult.shape[0]))
        return real_rebucket(self, state)

    monkeypatch.setattr(cs.ClassCompressedSolver, "_rebucket", counting)
    if SEGMENT_CASES[case][7]:
        monkeypatch.setattr(cs.ClassCompressedSolver, "_pack", _cut_pack(cs.ClassCompressedSolver._pack))
    got, action = run_port(world(), compress=True)
    got_stats = dict(action.last_class_stats)
    got_rebuckets = list(rebuckets)
    rebuckets.clear()
    with monkeypatch.context() as m:
        m.setattr(cs.ClassCompressedSolver, "_segment", _functional_segment)
        want, ref = run_port(world(), compress=True)
    assert got == want
    assert action.last_solver_tier == ref.last_solver_tier == "class_fused"
    assert table_stats(got_stats) == table_stats(ref.last_class_stats)
    assert got_stats["launches"] == ref.last_class_stats["launches"]
    assert got_rebuckets == rebuckets
    if SEGMENT_CASES[case][7]:
        assert got_rebuckets


# -- class_step_plain against JAX _class_step --------------------------------


def _jax_segment(ca, state, drf, prop, blocks, budget):
    import jax.numpy as jnp

    with x64_enabled(False):
        jca = {k: (v if isinstance(v, float) else jnp.asarray(v.numpy())) for k, v in ca.items()}
        jstate = jax_cs.ClassSolveState(*(jnp.asarray(x.numpy()) for x in state))
        out = jax_cs._class_step(jca, jstate, enable_drf=drf, enable_proportion=prop, blocks=blocks, seg_budget=budget)
        return jax_cs.ClassSolveState(*(np.asarray(x) for x in out))


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_class_step_plain_equals_jax_class_step(case):
    world, drf, prop, seed, advance, blocks, budget, cpad_cut = SEGMENT_CASES[case]
    ca, state = _segment_inputs(world, drf, prop, seed, advance, cpad_cut)
    got = cs.class_step_plain(ca, state, drf, prop, budget)
    want = _jax_segment(ca, state, drf, prop, blocks, budget)
    assert_state_equal(want, got, case)
    assert int(got.it) > int(state.it) or bool(got.overflow) or int(got.paused_at) >= 0
    if cpad_cut:
        assert bool(got.overflow) and int(got.it) == int(state.it)
    if case.startswith("affinity"):
        assert int(got.paused_at) >= 0
    # the input is not modified
    again = cs.class_step_plain(ca, state, drf, prop, budget)
    assert_state_equal(got, again, case)


def test_class_step_plain_blocks_are_the_flat_form():
    """The port computes the blocked mesh form flat; the JAX package's
    flat and blocked forms agree with it on one input."""
    ca, state = _segment_inputs(lambda: cs._smoke_world(arrivals=12), True, True, 12, 7, False)
    flat = cs.class_step_plain(ca, state, True, True, 64)
    for blocks in (1, 2, 4):
        assert_state_equal(_jax_segment(ca, state, True, True, blocks, 64), flat, f"blocks={blocks}")


# -- models, smoke, series ---------------------------------------------------


def test_uniform_pool_draws_the_same_cluster():
    def digest(cluster):
        pods = sorted(
            (t.namespace, t.name, t.job, t.node_name, t.priority, t.status.name,
             t.resreq.milli_cpu, t.resreq.memory)
            for job in cluster.jobs.values()
            for t in job.tasks.values()
        )
        jobs = sorted((j.uid, j.min_available, j.queue) for j in cluster.jobs.values())
        nodes = sorted(
            (n.name, n.allocatable.milli_cpu, n.allocatable.memory, n.idle.milli_cpu, n.idle.memory)
            for n in cluster.nodes.values()
        )
        return pods, jobs, nodes

    for kwargs in ({}, {"churn": 0.02, "churn_salt": 3}):
        port = models.uniform_pool(1000, 100, tasks_per_job=50, **kwargs)
        ref = jax_models.uniform_pool(1000, 100, tasks_per_job=50, **kwargs)
        assert digest(port) == digest(ref)
        assert len(port.nodes) == 100 and sum(len(j.tasks) for j in port.jobs.values()) >= 1000


def test_smoke_equals_the_jax_smoke():
    port = cs.smoke(device="cpu")
    with x64_enabled(False):
        ref = jax_cs.smoke()
    assert port["ok"] and ref["ok"]
    assert port["tier"] == "class_fused" and ref["tier"] == "class_xla"
    drop = ("tier", "cycle2")
    assert {k: v for k, v in port.items() if k not in drop} == {k: v for k, v in ref.items() if k not in drop}
    assert table_stats(port["cycle2"]) == table_stats(ref["cycle2"])


def test_the_class_series_carry_the_jax_names_and_values():
    names = ("class_solve_classes", "class_solve_compression_ratio", "class_table_splits")
    for n in names:
        assert getattr(metrics, n).name == getattr(jax_metrics, n).name
        assert getattr(metrics, n).help == getattr(jax_metrics, n).help
    before = (metrics.class_table_splits.value(), jax_metrics.class_table_splits.value())
    run_port(cs._smoke_world(arrivals=12), compress=True)
    run_jax(jax_cs._smoke_world(arrivals=12), compress=True)
    assert metrics.class_solve_classes.value() == jax_metrics.class_solve_classes.value() > 0
    assert metrics.class_solve_compression_ratio.value() == jax_metrics.class_solve_compression_ratio.value() > 1
    port_d = metrics.class_table_splits.value() - before[0]
    jax_d = jax_metrics.class_table_splits.value() - before[1]
    assert port_d == jax_d > 0
    text = metrics.render_prometheus_text()
    for n in ("class_solve_classes", "class_solve_compression_ratio", "class_table_splits_total"):
        assert f"kube_batch_tpu_{n} " in text
    assert "solve.class_table" in faults.POINTS


# -- two shard threads share one action's table ------------------------------


def _shard_world(shape: int):
    """One of two shards' worlds: the same node names and count, with
    statics that differ between the shards (capacity and pod caps), so a
    table shared across the shards re-keys on every switch."""
    from kube_batch_tpu_torch.testing import (
        build_cluster,
        build_node,
        build_pod,
        build_pod_group,
        build_queue,
        build_resource_list,
    )

    nodes = []
    for i in range(24):
        cpu = (8, 16, 32)[(i + shape) % 3] if shape else 16
        nodes.append(build_node(f"n-{i:03d}", build_resource_list(cpu=cpu, memory="32Gi", pods=16 + shape)))
    pods, pgs = [], []
    for j in range(10):
        name = f"s{shape}-gang-{j:02d}"
        pgs.append(build_pod_group(name, min_member=3))
        for m in range(3):
            pods.append(build_pod(name=f"{name}-t{m}", group_name=name,
                                  req=build_resource_list(cpu=str(1 + (j + shape) % 3), memory="2Gi")))
    return build_cluster(pods, nodes, pgs, [build_queue("default")])


def test_two_shard_threads_with_one_table_bind_as_cold_tables():
    """In-process federation runs one action object from every shard
    thread, so one ClassTable serves them all. Two threads solving
    different worlds through the shared, warm table at once bind exactly
    as a fresh action (a cold table) binds each world."""
    cold = {shape: run_port(_shard_world(shape), compress=True)[0] for shape in (0, 1)}
    assert all(cold.values())
    shared = TA.TorchAllocateAction()
    got: dict[int, list] = {0: [], 1: []}
    errors: list[BaseException] = []
    barrier = threading.Barrier(2)

    def worker(shape):
        try:
            barrier.wait()
            for _ in range(8):
                got[shape].append(run_port(_shard_world(shape), compress=None, action=shared)[0])
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in (0, 1)]
    env = os.environ.get(ENV)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # hand the interpreter over as often as it will go
    try:
        with _Env(True):  # once for both threads: the environment is the process's
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
    finally:
        sys.setswitchinterval(switch)
    assert os.environ.get(ENV) == env
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    for shape in (0, 1):
        assert len(got[shape]) == 8 and all(b == cold[shape] for b in got[shape]), shape
    assert shared._class_table.rekeys_total > 0  # the shards' statics did re-key the shared table

