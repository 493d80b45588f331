"""The port's pipelined cycles (pipeline.py, ``KBT_PIPELINE``), case for
case with tests/test_pipelined_cycles.py, each world run through both
packages.

The JAX package schedules with ``enqueue, xla_allocate, backfill`` (jax
x64 off, the production float32 policy), the port with ``enqueue,
torch_allocate, backfill`` on ``device: cpu``, both with the size floor
off, so every cycle's post-solve phase is the one the pipeline defers.
Placements, bind counts and the write-intent journal's bytes are compared
exactly; only wall clock may differ. The JAX suite's
``test_arena_bank_pingpong_matches_hosts`` runs the port's
``TensorArena`` beside the JAX one on the same views. The port-only cases
at the end: the
deferred closure captures only host arrays and makes no CUDA call, and an
overrun under the pipeline leaves the cache and the store as they were.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import pytest

from kube_batch_tpu.testing import x64_enabled

from test_torch_store import norm
from test_torch_streaming import (
    BOTH,
    JAX,
    PORT,
    Loop,
    all_bound,
    arrive_gang,
    count_bind_events,
    dying_binder,
    placements,
    wait_until,
)

_ENV_KEYS = ("KBT_PIPELINE", "KBT_PIPELINE_FENCE_TIMEOUT_S", "KBT_EXCHANGE_BATCH")


@pytest.fixture(autouse=True)
def _clean_world():
    saved = {k: os.environ.get(k) for k in _ENV_KEYS}
    for P in BOTH:
        P.faults.registry.reset()
        P.faults.solver_ladder.reset()
        P.pipeline.reset()
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    for P in BOTH:
        P.pipeline.reset()
        P.faults.registry.reset()
        P.faults.solver_ladder.reset()


JAX_PIPE_CONF = """
actions: "enqueue, xla_allocate, backfill"
actionArguments:
  xla_allocate:
    min_device_pairs: "0"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: predicates
  - name: nodeorder
streaming: {streaming}
"""


def pipe_conf(P, streaming: bool) -> str:
    if P is JAX:
        return JAX_PIPE_CONF.format(streaming=str(streaming).lower())
    return PORT.streaming.smoke_conf(streaming, "cpu")


def seed_cluster(P, store, nodes: int = 4) -> None:
    t = P.t
    store.create_queue(t.build_queue("default"))
    for i in range(nodes):
        store.create_node(t.build_node(f"n{i}", t.build_resource_list(cpu=16, memory="16Gi", pods=64)))


def make_scheduler(P, store, tmp_path, streaming=False, period=5.0, journal=None, binder=None):
    conf = tmp_path / f"pipe-{P.name}-{streaming}.yaml"
    conf.write_text(pipe_conf(P, streaming))
    cache = P.cache.SchedulerCache(store, journal=journal, binder=binder)
    return cache, P.sched.Scheduler(cache, scheduler_conf=str(conf), schedule_period=period)


def _pipelined(on: bool) -> None:
    for P in BOTH:
        P.pipeline.reset()
    if on:
        os.environ["KBT_PIPELINE"] = "1"
    else:
        os.environ.pop("KBT_PIPELINE", None)


# -- fence units --------------------------------------------------------------


def test_fence_clean_wait_clears_and_records_overlap():
    os.environ["KBT_PIPELINE"] = "1"
    pl = PORT.pipeline
    assert pl.enabled()
    assert pl.fence.wait(), "nothing armed must be a clean wait"
    fut: Future = Future()
    fut.set_result(None)
    pl.fence.arm(fut)
    pl.fence.record_dispatch_seconds(0.25)
    assert not pl.fence.pending()  # armed but already landed
    assert pl.fence.wait()
    assert pl.fence.degraded_reason is None
    # the dispatch landed before the wait started: full overlap
    assert PORT.metrics.pipeline_overlap_fraction.value() == pytest.approx(1.0, abs=0.05)
    assert pl.fence.last_overlap_fraction == pytest.approx(1.0, abs=0.05)
    assert pl.fence.wait()  # a clean wait disarms


def test_fence_timeout_is_sticky_and_keeps_the_future_armed():
    os.environ["KBT_PIPELINE"] = "1"
    pl = PORT.pipeline
    pool = ThreadPoolExecutor(max_workers=1)
    release = threading.Event()
    try:
        fut = pool.submit(release.wait, 10.0)
        pl.fence.arm(fut)
        assert pl.enabled()
        assert not pl.fence.wait(timeout=0.05)
        assert "timeout" in pl.fence.degraded_reason
        assert not pl.enabled(), "degradation must be sticky"
        assert pl.fence.pending(), "a wedged future must stay armed"
        release.set()
        fut.result(timeout=5.0)
        assert pl.fence.wait()
        assert not pl.enabled()
        pl.reset()
        assert pl.enabled(), "reset is the only way back"
    finally:
        release.set()
        pool.shutdown(wait=True)


def test_fence_fault_point_degrades():
    os.environ["KBT_PIPELINE"] = "1"
    pl = PORT.pipeline
    fut: Future = Future()
    fut.set_result(None)
    pl.fence.arm(fut)
    PORT.faults.registry.arm("pipeline.fence", count=1)
    assert not pl.fence.wait()
    assert "pipeline.fence" in pl.fence.degraded_reason
    assert not pl.enabled()
    assert PORT.metrics.degraded_cycles.value({"tier": "pipeline", "reason": "fault injected"}) >= 1


def test_fence_dispatch_exception_degrades_and_disarms():
    os.environ["KBT_PIPELINE"] = "1"
    pl = PORT.pipeline
    fut: Future = Future()
    fut.set_exception(RuntimeError("replay exploded"))
    pl.fence.arm(fut)
    assert not pl.fence.wait()
    assert "RuntimeError" in pl.fence.degraded_reason
    assert not pl.fence.pending(), "a raised dispatch is finished"


def test_submit_uses_cache_pool_else_module_fallback():
    pl = PORT.pipeline
    ran = []
    # a cache without run(): submit_dispatch runs inline and hands back a
    # done future (the synchronous degenerate case)
    cache = PORT.cache.SchedulerCache(PORT.cache.ClusterStore())
    fut = pl.submit(cache, lambda: ran.append("inline"))
    assert fut.done() and ran == ["inline"]

    def boom():
        raise ValueError("carried")

    assert isinstance(pl.submit(cache, boom).exception(), ValueError)

    # a started cache's kb-write pool runs it on a pool thread
    cache.run()
    try:
        names = []
        pl.submit(cache, lambda: names.append(threading.current_thread().name)).result(timeout=5.0)
        assert names and names[0].startswith("kb-write")
    finally:
        cache.stop()

    class PoolLess:
        pass

    fut2 = pl.submit(PoolLess(), lambda: ran.append("fallback"))
    fut2.result(timeout=5.0)
    assert ran[-1] == "fallback"


def test_join_session_reraises_and_pops():
    class S:
        pass

    ssn = S()
    fut: Future = Future()
    fut.set_exception(ValueError("deferred death"))
    ssn.deferred_dispatch = fut
    with pytest.raises(ValueError):
        PORT.pipeline.join_session(ssn)
    assert ssn.deferred_dispatch is None
    PORT.pipeline.join_session(S())  # no deferred work: no-op


# -- chaos: a fault mid-overlap degrades to synchronous -------------------------


def _fence_fault_run(P, tmp_path) -> tuple[dict, dict]:
    _pipelined(True)
    store = P.cache.ClusterStore()
    seed_cluster(P, store)
    bind_counts = count_bind_events(P, store)
    _, sched = make_scheduler(P, store, tmp_path)
    arrive_gang(P, store, "g0", members=3)
    sched.run_once()
    assert P.pipeline.fence._dispatch_s > 0.0, "the first cycle never deferred its dispatch"
    assert all_bound(store)
    P.faults.registry.arm("pipeline.fence", count=1)
    arrive_gang(P, store, "g1", members=3)
    sched.run_once()  # the fence wait fires the fault: cycle skipped
    assert "pipeline.fence" in P.pipeline.fence.degraded_reason
    assert not P.pipeline.enabled()
    _, _, fired = P.faults.registry.active()["pipeline.fence"]
    assert fired == 1
    sched.run_once()  # the synchronous backstop serves the skipped arrivals
    arrive_gang(P, store, "g2", members=3)
    sched.run_once()
    assert all_bound(store)
    assert len(bind_counts) == 9
    assert all(n == 1 for n in bind_counts.values()), f"duplicate binds: {bind_counts}"
    return placements(store), bind_counts


def test_chaos_fence_fault_mid_overlap_degrades_cleanly(tmp_path):
    """Cycle N defers its dispatch; ``pipeline.fence`` ambushes cycle
    N+1's wait. The cycle is skipped, the pipeline degrades (sticky), and
    the synchronous cycles after keep binding: zero lost, zero duplicate,
    the same placements in both packages."""
    with x64_enabled(False):
        jax_out = _fence_fault_run(JAX, tmp_path)
    port_out = _fence_fault_run(PORT, tmp_path)
    assert port_out == jax_out


# -- parity: pipelined x streaming against the periodic synchronous loop ------


def _parity_run(P, tmp_path, gangs, pipelined: bool, streaming: bool):
    _pipelined(pipelined)
    store = P.cache.ClusterStore()
    seed_cluster(P, store, nodes=6)
    _, sched = make_scheduler(P, store, tmp_path, streaming=streaming, period=0.25 if streaming else 0.02)
    with Loop(sched):
        for name, members in gangs:
            arrive_gang(P, store, name, members)
            time.sleep(0.002)
        wait_until(lambda: all_bound(store), timeout=20.0, what=f"{P.name}: all gangs bound")
    assert P.pipeline.fence.degraded_reason is None
    return placements(store), sched


def test_pipelined_streaming_parity_vs_periodic_loop(tmp_path):
    """The same arrivals through (a) KBT_PIPELINE and streaming
    micro-cycles, (b) KBT_PIPELINE periodic full cycles and (c) the plain
    synchronous periodic loop place bind for bind identically, in the port
    and against the JAX package's synchronous loop."""
    gangs = [(f"g{i}", 2 + (i % 3)) for i in range(5)]
    pipe_stream, stream_sched = _parity_run(PORT, tmp_path, gangs, True, True)
    assert stream_sched.micro_cycles_run > 0, "the streaming run never took the micro path"
    pipe_full, _ = _parity_run(PORT, tmp_path, gangs, True, False)
    assert PORT.pipeline.fence._dispatch_s > 0.0, "the pipelined periodic run never deferred a dispatch"
    sync_full, _ = _parity_run(PORT, tmp_path, gangs, False, False)
    with x64_enabled(False):
        jax_full, _ = _parity_run(JAX, tmp_path, gangs, False, False)
    assert pipe_full == sync_full, "pipelined cycles changed placements"
    assert pipe_stream == sync_full, "pipelined streaming changed placements"
    assert sync_full == jax_full


# -- crash consistency: killed inside the deferred dispatch -------------------


def _killed_mid_deferred(P, tmp_path) -> dict:
    total = 12  # 2 gangs x 6
    _pipelined(False)
    twin = P.cache.ClusterStore()
    seed_cluster(P, twin)
    for g in range(2):
        arrive_gang(P, twin, f"g{g}", members=6)
    _, sched_t = make_scheduler(P, twin, tmp_path)
    sched_t.run_once()
    expected = placements(twin)
    assert all(expected.values()) and len(expected) == total

    # pipelined, the binder dies after 4 binds. The cache has no writer
    # pool, so the deferred closure runs at submission and carries the
    # death in its future; close_session's join re-raises it on the
    # scheduler thread, where a fence join would.
    _pipelined(True)
    store = P.cache.ClusterStore()
    seed_cluster(P, store)
    bind_counts = count_bind_events(P, store)
    wal = str(tmp_path / f"{P.name}-leader.wal")
    journal = P.recovery.WriteIntentJournal(wal)
    _, sched = make_scheduler(P, store, tmp_path, journal=journal, binder=dying_binder(P, store, die_after=4))
    for g in range(2):
        arrive_gang(P, store, f"g{g}", members=6)
    with pytest.raises(BaseException) as info:
        sched.run_once()
    assert type(info.value).__name__ == "_LeaderKilled"
    landed = {k: v for k, v in placements(store).items() if v}
    assert 0 < len(landed) < total, "the kill must land mid-dispatch"
    orphans = P.recovery.WriteIntentJournal.replay(journal.path).orphans
    assert orphans, "the journal must hold the in-flight suffix"
    with open(wal, "rb") as f:
        wal_bytes = f.read()

    _pipelined(False)
    standby_journal = P.recovery.WriteIntentJournal(wal)
    report = P.recovery.reconcile_journal(standby_journal, store)
    assert report.redispatched == len(orphans)
    assert report.rolled_back == 0
    _, sched_b = make_scheduler(P, store, tmp_path)
    sched_b.run_once()
    assert placements(store) == expected, "the standby must converge to the twin"
    assert all(n == 1 for n in bind_counts.values()), f"duplicate binds: {bind_counts}"
    assert set(bind_counts) == set(expected), "lost binds"
    standby_journal.close()
    return {"expected": expected, "landed": landed, "wal": wal_bytes}


def test_chaos_leader_killed_mid_deferred_dispatch_journal_reconciles(tmp_path):
    """The leader dies inside cycle N's deferred replay and dispatch; the
    journal holds the in-flight suffix, and a standby's reconciliation
    plus one synchronous cycle converge to the uninterrupted twin, zero
    lost and zero duplicate. Both packages journal the same bytes."""
    with x64_enabled(False):
        jax_out = _killed_mid_deferred(JAX, tmp_path)
    port_out = _killed_mid_deferred(PORT, tmp_path)
    assert port_out == jax_out


# -- port-only ----------------------------------------------------------------


def _cells(fn) -> list:
    """Every value a function's closure holds, through nested closures."""
    out, todo, seen = [], [fn], set()
    while todo:
        f = todo.pop()
        if id(f) in seen:
            continue
        seen.add(id(f))
        for cell in f.__closure__ or ():
            v = cell.cell_contents
            out.append(v)
            if callable(v) and getattr(v, "__closure__", None):
                todo.append(v)
    return out


def test_deferred_closure_runs_no_cuda_call_and_captures_only_host_arrays(tmp_path, monkeypatch):
    import numpy as np
    import torch

    os.environ["KBT_PIPELINE"] = "1"
    store = PORT.cache.ClusterStore()
    seed_cluster(PORT, store)
    _, sched = make_scheduler(PORT, store, tmp_path)
    arrive_gang(PORT, store, "g0", members=3)
    captured = []
    real_submit = PORT.pipeline.submit

    def submit(cache, fn):
        captured.append(fn)
        calls = []

        def no_cuda(name):
            def refuse(*a, **k):
                calls.append(name)
                raise AssertionError(f"the deferred dispatch called torch.cuda.{name}")
            return refuse

        with monkeypatch.context() as m:
            for name in ("synchronize", "set_device", "current_device", "current_stream", "is_available",
                         "device_count"):
                m.setattr(torch.cuda, name, no_cuda(name))
            m.setattr(torch.Tensor, "cuda", lambda *a, **k: no_cuda("Tensor.cuda")())
            fut = real_submit(cache, fn)
            fut.exception(timeout=10.0)
        assert not calls
        return fut

    monkeypatch.setattr(PORT.pipeline, "submit", submit)
    sched.run_once()
    assert len(captured) == 1
    assert all_bound(store)
    cells = _cells(captured[0])
    assert not [v for v in cells if isinstance(v, torch.Tensor)], "the closure holds a tensor"
    arrays = [v for v in cells if isinstance(v, np.ndarray)]
    assert len(arrays) == 4  # assign_pos, assigned_node, assigned_kind, ready_cnt


def _overrun_run(P, tmp_path) -> dict:
    from test_torch_store import store_contents

    _pipelined(True)
    store = P.cache.ClusterStore()
    seed_cluster(P, store)
    cache, sched = make_scheduler(P, store, tmp_path)
    arrive_gang(P, store, "g0", members=3)

    def mirror():
        with cache._mutex:
            return (sorted((uid, sorted((t.uid, t.status.value, t.node_name) for t in j.tasks.values()))
                           for uid, j in cache.jobs.items()),
                    sorted((n, float(ni.idle.milli_cpu), len(ni.tasks)) for n, ni in cache.nodes.items()))

    before = store_contents(P, store)
    mirror_before = mirror()
    P.faults.registry.arm("cycle.overrun", count=1)
    submitted = []
    real_submit = P.pipeline.submit
    P.pipeline.submit = lambda c, fn: submitted.append(fn) or real_submit(c, fn)
    try:
        sched.run_once()
        assert "aborted" in getattr(sched, "last_timings", {"aborted": True})
        assert not submitted, "an aborted cycle submitted its dispatch"
        assert not P.pipeline.fence.pending() and P.pipeline.fence.degraded_reason is None
        after = store_contents(P, store)
        # no bind, no task moved in the mirror, no node charged
        assert after["pods"] == before["pods"] and after["nodes"] == before["nodes"]
        assert mirror() == mirror_before
        sched.run_once()
        assert len(submitted) == 1
    finally:
        P.pipeline.submit = real_submit
        P.faults.registry.reset()
    assert all_bound(store)
    return after


def test_overrun_under_pipeline_leaves_the_cache_byte_identical(tmp_path):
    """``cycle.overrun`` under KBT_PIPELINE: the dispatch barrier runs on
    the scheduling thread before any submission, so the abort discards the
    session with no deferred dispatch: no bind reaches the store, no task
    or node of the cache's mirror moves, and the next cycle binds. The
    store ends byte for byte as the JAX package's pipelined abort leaves
    it: in both, the gang plugin's close hook writes the PodGroup's
    Unschedulable condition, since the replay had not run (ROADMAP C)."""
    with x64_enabled(False):
        want = _overrun_run(JAX, tmp_path)
    assert _overrun_run(PORT, tmp_path) == want


# -- arena double-buffering ---------------------------------------------------


def test_arena_bank_pingpong_matches_hosts(monkeypatch):
    """Synchronous cycles pin the bank at 0; under ``KBT_PIPELINE`` the
    banks ping-pong, cycle N+1's upload never touches the buffer cycle N
    reads, and the re-visited bank row-updates against its own memo. The
    port's arena and the JAX one agree view for view: bank, counters and
    contents."""
    import numpy as np

    from kube_batch_tpu import pipeline as jax_pipeline
    from kube_batch_tpu.ops.encode_cache import TensorArena as JaxArena

    from kube_batch_tpu_torch import pipeline
    from kube_batch_tpu_torch.ops.encode_cache import TensorArena

    def counters(a):
        return a.bank, a.reuses, a.row_updates, a.full_uploads, a.rows_uploaded

    base = np.arange(32, dtype=np.float32).reshape(8, 4)
    monkeypatch.delenv(pipeline.ENV, raising=False)
    # synchronous mode: the bank is pinned at 0
    arena, ref = TensorArena("cpu"), JaxArena()
    for a in (arena, ref):
        a.device_view({"node_idle": base})
        a.device_view({"node_idle": base})
    assert arena.bank == 0 and arena.reuses >= 1  # same object: outright reuse
    assert counters(arena) == counters(ref)

    monkeypatch.setenv(pipeline.ENV, "1")
    assert jax_pipeline.ENV == pipeline.ENV
    arena, ref = TensorArena("cpu"), JaxArena()
    def view(arrays):
        # compared at once: the JAX arena donates the buffer it scatters into
        v, r = arena.device_view(arrays), ref.device_view(arrays)
        np.testing.assert_array_equal(v["node_idle"].numpy(), np.asarray(r["node_idle"]))
        return v

    a1 = {"node_idle": base}
    v1 = view(a1)
    b1 = arena.bank
    a2 = {"node_idle": base.copy()}
    a2["node_idle"][3] += 1.0
    v2 = view(a2)
    assert arena.bank != b1, "pipelined uploads must ping-pong banks"
    # cycle N+1's upload never touched the bank cycle N still reads
    np.testing.assert_array_equal(v1["node_idle"].numpy(), a1["node_idle"])
    np.testing.assert_array_equal(v2["node_idle"].numpy(), a2["node_idle"])
    # the third cycle returns to the first bank: the row delta runs against
    # that bank's own (two-cycles-old) memo, in place, and stays exact
    a3 = {"node_idle": a2["node_idle"].copy()}
    a3["node_idle"][5] -= 2.0
    ptr = v1["node_idle"].data_ptr()
    v3 = view(a3)
    assert arena.bank == b1
    assert v3["node_idle"].data_ptr() == ptr
    np.testing.assert_array_equal(v3["node_idle"].numpy(), a3["node_idle"])
    assert arena.full_uploads == 2, "one cold upload per bank"
    assert arena.row_updates == 1, "the re-visit writes rows in place"
    assert arena.rows_uploaded == 2  # rows 3 and 5 against the bank's memo
    assert counters(arena) == counters(ref)
