"""The port's streaming scheduler (streaming.py, Scheduler.run_micro),
case for case with tests/test_streaming.py, each world run through both
packages.

The JAX package schedules its worlds with the serial ``enqueue, allocate,
backfill`` conf; the port with ``enqueue, torch_allocate, backfill`` on
``device: cpu`` with the size floor off (``streaming.smoke_conf``), so
every full cycle and every micro-cycle solves on the fused rung (kernel
B1's plain version). Placements (pod -> node) are compared exactly, and
the JAX package's invariants are held on the port: micro-cycle drain plus
backstop full cycles place bind for bind as full cycles alone, a fault or
external churn degrades to a full cycle with no pod dropped, and a leader
killed mid-micro-dispatch leaves a journal whose reconciliation converges
to the uninterrupted twin. The port-only cases at the end: a warm micro
encode equals a cold encode of the same patched resident table, and a
``streaming: true`` conf really takes micro-cycles through
``torch_allocate``.
"""

from __future__ import annotations

import dataclasses
import importlib
import random
import threading
import time

import numpy as np
import pytest

from test_torch_store import JAX, PORT

for _P in (JAX, PORT):
    _P.streaming = importlib.import_module(f"{_P.name}.streaming")
    _P.pipeline = importlib.import_module(f"{_P.name}.pipeline")
    _P.recovery = importlib.import_module(f"{_P.name}.recovery")
    _P.encode_cache = importlib.import_module(f"{_P.name}.ops.encode_cache")

BOTH = (JAX, PORT)


@pytest.fixture(autouse=True)
def _clean_faults():
    for P in BOTH:
        P.faults.registry.reset()
        P.faults.solver_ladder.reset()
    yield
    for P in BOTH:
        P.faults.registry.reset()
        P.faults.solver_ladder.reset()


def wait_until(pred, timeout=15.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


# The JAX suite's serial conf without drf/proportion (micro tiers drop
# those two, so exact streaming-vs-full parity is stated over this conf).
JAX_STREAM_CONF = """
actions: "enqueue, allocate, backfill"
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


def stream_conf(P, streaming: bool) -> str:
    if P is JAX:
        return JAX_STREAM_CONF.format(streaming=str(streaming).lower())
    return PORT.streaming.smoke_conf(streaming, "cpu")


def seed_cluster(P, store, nodes: int = 6) -> None:
    t = P.t
    store.create_queue(t.build_queue("default"))
    for i in range(nodes):
        store.create_node(t.build_node(f"n{i}", t.build_resource_list(cpu=16, memory="16Gi", pods=64)))


def arrive_gang(P, store, name: str, members: int) -> None:
    t = P.t
    store.create_pod_group(t.build_pod_group(name, min_member=members))
    for m in range(members):
        store.create_pod(
            t.build_pod(name=f"{name}-p{m}", group_name=name, req=t.build_resource_list(cpu=1, memory="512Mi"))
        )


def make_streaming_scheduler(P, store, tmp_path, streaming=True, period=5.0, journal=None, binder=None):
    conf = tmp_path / f"conf-{P.name}-{streaming}.yaml"
    conf.write_text(stream_conf(P, streaming))
    cache = P.cache.SchedulerCache(store, journal=journal, binder=binder)
    return cache, P.sched.Scheduler(cache, scheduler_conf=str(conf), schedule_period=period)


def placements(store) -> dict:
    return {f"{p.namespace}/{p.name}": p.node_name for p in store.list("pods")}


def all_bound(store) -> bool:
    pods = store.list("pods")
    return bool(pods) and all(p.node_name for p in pods)


class Loop:
    """A scheduler's ``run`` on a thread of its own, stopped and joined
    (its cache's pools too) on exit."""

    def __init__(self, sched) -> None:
        self.sched = sched
        self.stop = threading.Event()
        self.thread = threading.Thread(target=sched.run, args=(self.stop,), daemon=True)

    def __enter__(self):
        self.thread.start()
        return self.sched

    def __exit__(self, *exc) -> None:
        self.stop.set()
        self.thread.join(timeout=10.0)
        self.sched.cache.stop()


# -- units -------------------------------------------------------------------


def test_micro_tiers_drop_fairness_plugins_and_empty_tiers():
    out = {}
    for P in BOTH:
        PO, Tier = P.conf.PluginOption, P.conf.Tier
        tiers = [
            Tier(plugins=[PO(name="priority"), PO(name="gang")]),
            Tier(plugins=[PO(name="drf"), PO(name="proportion")]),
            Tier(plugins=[PO(name="predicates"), PO(name="drf")]),
        ]
        out[P.name] = [[p.name for p in t.plugins] for t in P.streaming.micro_tiers(tiers)]
        assert P.streaming.MICRO_EXCLUDED_PLUGINS == {"drf", "proportion"}
        # the conf's own tiers are untouched (they are reused every cycle)
        assert [p.name for p in tiers[1].plugins] == ["drf", "proportion"]
    assert out[PORT.name] == out[JAX.name] == [["priority", "gang"], ["predicates"]]


def test_gang_key_of_annotated_and_shadow_pods():
    for P in BOTH:
        annotated = P.t.build_pod(name="a", group_name="g7")
        assert P.streaming.gang_key_of(annotated) == "default/g7"
        bare = P.t.build_pod(name="b")
        # the shadow-job key: the cache's _resolve_shadow_job
        assert P.streaming.gang_key_of(bare) == f"default/{bare.metadata.owner_job or bare.metadata.uid}"


def test_conf_streaming_key_parses():
    for P in BOTH:
        assert P.conf.parse_scheduler_conf("streaming: true").streaming is True
        assert P.conf.parse_scheduler_conf("actions: allocate").streaming is False
    assert PORT.conf.parse_scheduler_conf(PORT.streaming.smoke_conf(True, "cpu")).streaming is True


def _trigger_script(P) -> list:
    """The JAX suite's event script on P's trigger; returns what each step
    observed, package-neutral."""
    t, S = P.t, P.streaming
    seen = []
    trig = S.StreamTrigger()
    pending = t.build_pod(name="p0", group_name="g0")
    uid = pending.metadata.uid

    # pending-pod add: gang dirty, arrival stamped, wake
    trig._on_event("pods", uid, pending, None)
    seen.append((trig.wait(0), trig.backlog_pods()))
    work = trig.drain()
    seen.append((work.gangs, work.stale))
    # pending->pending condition echo: no wake (self-trigger guard)
    trig._on_event("pods", uid, pending, pending)
    seen.append(trig.wait(0))
    # bind echo: arrival closed, still no wake, gang kept until pruned
    bound = dataclasses.replace(pending, node_name="n1")
    trig._on_event("pods", uid, bound, pending)
    seen.append((trig.backlog_pods(), trig.wait(0), trig.drain().gangs))
    trig.prune({"default/g0"})
    seen.append(trig.drain().gangs)
    # unbind echo: the pod is a fresh arrival again
    trig._on_event("pods", uid, pending, bound)
    seen.append((trig.wait(0), trig.backlog_pods(), trig.drain().gangs))
    # node churn: recorded as a patch (latest wins, None = delete)
    node = t.build_node("nx", t.build_resource_list(cpu=4))
    trig._on_event("nodes", "nx", node, None)
    trig._on_event("nodes", "ny", None, t.build_node("ny", t.build_resource_list(cpu=4)))
    seen.append(trig.wait(0))
    work = trig.drain()
    seen.append((work.node_patches["nx"] is node, work.node_patches["ny"], sorted(work.node_patches)))
    # podgroup add dirties the gang; queue churn just wakes
    trig._on_event("podgroups", "default/g9", t.build_pod_group("g9"), None)
    trig._on_event("queues", "default", t.build_queue("default"), None)
    seen.append((trig.wait(0), trig.drain().gangs))
    trig.prune({"default/g0", "default/g9"})
    # a status-only podgroup write-back must not re-dirty the gang
    pg = t.build_pod_group("g9")
    trig._on_event("podgroups", "default/g9", dataclasses.replace(pg), pg)
    seen.append((trig.wait(0), trig.drain().gangs))
    # a spec change (min_member edit) does dirty it
    pg3 = dataclasses.replace(pg, spec=dataclasses.replace(pg.spec, min_member=5))
    trig._on_event("podgroups", "default/g9", pg3, pg)
    seen.append((trig.wait(0), trig.drain().gangs))
    # bound-pod churn from outside any session: the resident table is stale
    trig._on_event("pods", uid, None, bound)
    work = trig.drain()
    seen.append((work.stale, "deleted outside a cycle" in work.stale_reason))
    return seen


def test_trigger_event_rules():
    seen = _trigger_script(PORT)
    assert seen == _trigger_script(JAX)
    assert seen == [
        (True, 1), ({"default/g0"}, False), False, (0, False, {"default/g0"}), set(),
        (True, 1, {"default/g0"}), True, (True, None, ["nx", "ny"]), (True, {"default/g0", "default/g9"}),
        (False, set()), (True, {"default/g9"}), (True, True),
    ]


def test_stream_state_adopt_patch_invalidate():
    for P in BOTH:
        st = P.streaming.StreamState()
        assert not st.valid

        class FakeSession:
            nodes = {"n0": None}

        st.adopt_full_cycle(FakeSession())
        assert st.valid and "n0" in st.nodes
        st.apply_node_patches({"n1": P.t.build_node("n1", P.t.build_resource_list(cpu=2))})
        assert set(st.nodes) == {"n0", "n1"}
        st.apply_node_patches({"n0": None})
        assert set(st.nodes) == {"n1"}
        st.adopt_full_cycle(FakeSession(), aborted=True)
        assert not st.valid and st.nodes is None


# -- end to end --------------------------------------------------------------


def test_stopped_streaming_loop_leaves_zero_listeners(tmp_path):
    """A stopped streaming loop returns the store-listener registry to its
    count before the start: a leaked listener keeps firing into the dead
    loop on every store event."""
    out = {}
    for P in BOTH:
        before = P.encode_cache.listener_count()
        store = P.cache.ClusterStore()
        seed_cluster(P, store)
        _, sched = make_streaming_scheduler(P, store, tmp_path, period=30.0)
        with Loop(sched):
            arrive_gang(P, store, "g0", members=4)
            wait_until(lambda: all_bound(store), what=f"{P.name}: gang g0 bound")
            assert P.encode_cache.listener_count() == before + 1
        assert P.encode_cache.listener_count() == before
        out[P.name] = placements(store)
    assert out[PORT.name] == out[JAX.name]


def test_streaming_binds_arrivals_between_full_cycles(tmp_path):
    """With the full-cycle period far longer than the test, everything
    after the first cycle binds through micro-cycles."""
    out = {}
    for P in BOTH:
        store = P.cache.ClusterStore()
        seed_cluster(P, store)
        _, sched = make_streaming_scheduler(P, store, tmp_path, period=30.0)
        with Loop(sched):
            for g in range(3):
                arrive_gang(P, store, f"g{g}", members=4)
                wait_until(
                    lambda g=g: all(p.node_name for p in store.list("pods") if p.name.startswith(f"g{g}-")),
                    what=f"{P.name}: gang g{g} bound via micro-cycle",
                )
        assert sched.micro_cycles_run > 0
        assert all_bound(store)
        out[P.name] = placements(store)
    assert out[PORT.name] == out[JAX.name]


def _poisson_run(P, tmp_path, gangs, delays, streaming: bool):
    store = P.cache.ClusterStore()
    seed_cluster(P, store)
    _, sched = make_streaming_scheduler(P, store, tmp_path, streaming=streaming, period=0.25 if streaming else 0.02)
    with Loop(sched):
        for (name, members), delay in zip(gangs, delays):
            time.sleep(delay if streaming else 0)
            arrive_gang(P, store, name, members)
        wait_until(lambda: all_bound(store), what=f"{P.name}: all gangs bound")
    return placements(store), sched


def test_streaming_vs_full_cycle_poisson_parity(tmp_path):
    """THE parity invariant: Poisson arrivals drained by micro-cycles and
    backstop full cycles place bind for bind as full cycles alone over
    the same arrivals, in each package and across them."""
    rng = random.Random(42)
    gangs = [(f"g{i}", rng.choice([2, 3, 4])) for i in range(8)]
    delays = [rng.expovariate(1 / 0.004) for _ in gangs]
    jax_stream, _ = _poisson_run(JAX, tmp_path, gangs, delays, True)
    port_stream, port_sched = _poisson_run(PORT, tmp_path, gangs, delays, True)
    port_full, _ = _poisson_run(PORT, tmp_path, gangs, delays, False)
    assert port_stream == port_full, "streaming must be bind-for-bind full-cycle"
    assert port_stream == jax_stream
    assert port_sched.micro_cycles_run > 0, "streaming run never took the micro path"


def test_micro_cycle_fault_degrades_to_full_cycle_no_pod_dropped(tmp_path):
    """``stream.micro_cycle`` fires on the first micro attempt; the loop
    degrades to a full cycle at once and every arrival still binds."""
    out = {}
    for P in BOTH:
        P.faults.registry.arm("stream.micro_cycle", count=1)
        store = P.cache.ClusterStore()
        seed_cluster(P, store)
        _, sched = make_streaming_scheduler(P, store, tmp_path, period=30.0)
        with Loop(sched):
            # wait out the first full cycle, so the armed fault ambushes
            # the micro-cycle this test scripts
            wait_until(lambda: sched._stream_state is not None and sched._stream_state.valid,
                       what=f"{P.name}: resident table adopted")
            arrive_gang(P, store, "g0", members=4)
            wait_until(lambda: all_bound(store), what=f"{P.name}: gang bound despite the micro fault")
            before = sched.micro_cycles_run
            arrive_gang(P, store, "g1", members=4)
            wait_until(lambda: all_bound(store), what=f"{P.name}: post-fault gang bound")
            wait_until(lambda: sched.micro_cycles_run > before, what=f"{P.name}: micro path resumed")
        _, _, fired = P.faults.registry.active()["stream.micro_cycle"]
        assert fired == 1
        out[P.name] = placements(store)
    assert out[PORT.name] == out[JAX.name]


def test_external_bound_churn_invalidates_resident(tmp_path):
    """A pod bound by someone else appears in the store: the resident
    table cannot absorb it, so streaming degrades to a full cycle and
    keeps serving."""
    out = {}
    for P in BOTH:
        store = P.cache.ClusterStore()
        seed_cluster(P, store)
        _, sched = make_streaming_scheduler(P, store, tmp_path, period=30.0)
        with Loop(sched):
            arrive_gang(P, store, "g0", members=3)
            wait_until(lambda: all_bound(store), what=f"{P.name}: first gang bound")
            store.create_pod(P.t.build_pod(name="alien", node_name="n0"))
            arrive_gang(P, store, "g1", members=3)
            wait_until(lambda: all_bound(store), what=f"{P.name}: gang bound after external churn")
        assert placements(store)["default/alien"] == "n0"
        out[P.name] = placements(store)
    assert out[PORT.name] == out[JAX.name]


# -- crash consistency (the write-intent journal) -----------------------------


class _LeaderKilled(BaseException):
    """SIGKILL stand-in: a BaseException, so no retry or resync ladder can
    survive it and the dispatch dies where a killed process would."""


def dying_binder(P, store, die_after: int):
    class DyingBinder(P.cache_mod.StoreBinder):
        def __init__(self) -> None:
            super().__init__(store)
            self.left = die_after

        def bind(self, pod, hostname: str) -> None:
            if self.left <= 0:
                raise _LeaderKilled()
            self.left -= 1
            super().bind(pod, hostname)

    return DyingBinder()


def count_bind_events(P, store) -> dict:
    counts: dict[str, int] = {}

    def on_update(old, new):
        if not old.node_name and new.node_name:
            key = f"{new.namespace}/{new.name}"
            counts[key] = counts.get(key, 0) + 1

    store.add_event_handler("pods", P.store.EventHandler(on_update=on_update))
    return counts


def _killed_mid_micro(P, tmp_path) -> dict:
    total = 12  # 2 gangs x 6
    twin = P.cache.ClusterStore()
    seed_cluster(P, twin, nodes=4)
    for g in range(2):
        arrive_gang(P, twin, f"g{g}", members=6)
    _, sched_t = make_streaming_scheduler(P, twin, tmp_path, streaming=False)
    sched_t.run_once()
    expected = placements(twin)
    assert all(expected.values()) and len(expected) == total

    # the real run: the streaming loop's pieces on this thread (no
    # cache.run(), so writes are inline and the binder's death is the
    # scheduler thread's)
    store = P.cache.ClusterStore()
    seed_cluster(P, store, nodes=4)
    bind_counts = count_bind_events(P, store)
    wal = str(tmp_path / f"{P.name}-leader.wal")
    journal = P.recovery.WriteIntentJournal(wal)
    _, sched = make_streaming_scheduler(P, store, tmp_path, journal=journal,
                                        binder=dying_binder(P, store, die_after=4))
    trigger, state = P.streaming.StreamTrigger(), P.streaming.StreamState()
    sched._stream_trigger, sched._stream_state = trigger, state
    trigger.attach()
    try:
        sched.run_once()  # empty world; adopts the resident node table
        assert state.valid
        for g in range(2):
            arrive_gang(P, store, f"g{g}", members=6)
        with pytest.raises(_LeaderKilled):
            sched.run_micro(trigger.drain())
    finally:
        trigger.detach()
    assert not state.valid, "a dead micro-cycle must invalidate the resident table"
    landed = {k: v for k, v in placements(store).items() if v}
    assert 0 < len(landed) < total, "the kill must land mid-dispatch"
    orphans = P.recovery.WriteIntentJournal.replay(journal.path).orphans
    assert orphans, "the journal must hold the in-flight suffix"

    standby_journal = P.recovery.WriteIntentJournal(wal)
    report = P.recovery.reconcile_journal(standby_journal, store)
    assert report.redispatched == len(orphans)
    assert report.rolled_back == 0
    _, sched_b = make_streaming_scheduler(P, store, tmp_path, streaming=False)
    sched_b.run_once()
    assert placements(store) == expected, "the standby must converge to the twin"
    assert all(n == 1 for n in bind_counts.values()), f"duplicate binds: {bind_counts}"
    assert set(bind_counts) == set(expected), "lost binds"
    standby_journal.close()
    return {"expected": expected, "landed": landed,
            "orphans": sorted((o.gang, o.pod, o.node) for o in orphans)}


def test_chaos_leader_killed_mid_micro_bind_standby_reconciles(tmp_path):
    """A streaming leader dies mid-micro-cycle dispatch (after journal
    appends, after some store writes landed); the standby's journal
    reconciliation plus one full cycle converge to the uninterrupted
    twin: zero lost, zero duplicate, in both packages and to the same
    placements."""
    jax_out, port_out = _killed_mid_micro(JAX, tmp_path), _killed_mid_micro(PORT, tmp_path)
    assert port_out["expected"] == jax_out["expected"]
    assert len(port_out["landed"]) == len(jax_out["landed"]) == 4


# -- metrics -----------------------------------------------------------------


def test_streaming_metrics_families_render():
    PORT.metrics.observe_time_to_bind(0.004)
    PORT.metrics.register_micro_cycle("ok")
    PORT.metrics.set_streaming_backlog(3)
    text = PORT.metrics.render_prometheus_text()
    assert "kube_batch_tpu_time_to_bind_seconds" in text
    assert "kube_batch_tpu_micro_cycles_total" in text
    assert "kube_batch_tpu_streaming_backlog_pods" in text
    assert 'kube_batch_tpu_micro_cycles_total{outcome="ok"}' in text


# -- port-only ----------------------------------------------------------------


def _encoded(enc) -> dict:
    return {k: np.asarray(v) for k, v in enc.arrays.items()}


def test_warm_micro_encode_equals_a_cold_encode_of_the_patched_resident_table():
    """A micro-cycle patches the resident NodeInfos in place (set_node,
    add_task, remove_task). The encode cache and the native node columns
    must see every patch: the warm micro encode equals a cold encode of
    the same table, array for array."""
    from kube_batch_tpu_torch.framework import open_session
    from kube_batch_tpu_torch.ops import encode_cache
    from kube_batch_tpu_torch.ops.encode import encode_session

    t = PORT.t
    store = PORT.cache.ClusterStore()
    seed_cluster(PORT, store, nodes=6)
    arrive_gang(PORT, store, "g0", members=4)
    cache = PORT.cache.SchedulerCache(store)
    conf = PORT.conf.parse_scheduler_conf(PORT.streaming.smoke_conf(True, "cpu"))
    tiers = conf.tiers
    st = PORT.streaming.StreamState()
    ssn = open_session(cache, tiers, {})
    encode_session(ssn.jobs, ssn.nodes, ssn.queues, session=ssn)  # warm the cache on the full world
    st.adopt_full_cycle(ssn)
    # the patches a micro-cycle applies: a relabelled node, a new node, a
    # peer's bind and a release
    n1 = st.nodes["n1"].node
    st.apply_node_patches({
        "n1": dataclasses.replace(n1, metadata=dataclasses.replace(n1.metadata, labels={"zone": "b"})),
        "n9": t.build_node("n9", t.build_resource_list(cpu=8, memory="8Gi", pods=16)),
    })
    peer = t.build_pod(name="peer", node_name="n2", req=t.build_resource_list(cpu=3, memory="1Gi"))
    assert st.apply_bound_patches([("add", peer.metadata.uid, peer)])
    gone = t.build_pod(name="gone", node_name="n3", req=t.build_resource_list(cpu=2, memory="1Gi"))
    assert st.apply_bound_patches([("add", gone.metadata.uid, gone), ("remove", gone.metadata.uid, gone)])
    arrive_gang(PORT, store, "g1", members=3)
    jobs, missing = cache.clone_jobs_for_stream({"default/g1"})
    assert not missing and set(jobs) == {"default/g1"}
    micro = PORT.streaming.open_micro_session(cache, tiers, {}, jobs, st.nodes, cache.clone_queues_for_stream())
    warm = encode_session(micro.jobs, micro.nodes, micro.queues, session=micro, resident_interpod=False)
    assert warm.warm_fraction > 0, "the micro encode never touched the warm cache"
    encode_cache.set_enabled(False)
    try:
        cold = encode_session(micro.jobs, micro.nodes, micro.queues)
    finally:
        encode_cache.set_enabled(True)
    assert warm.node_names == cold.node_names and "n9" in warm.node_names
    w, c = _encoded(warm), _encoded(cold)
    assert set(w) == set(c)
    for k in w:
        assert w[k].dtype == c[k].dtype and np.array_equal(w[k], c[k]), k
    # the peer's 3 cpu shows in n2's idle column
    row = warm.node_names.index("n2")
    assert w["node_idle"][row, 0] == c["node_idle"][row, 0] == 13_000


def test_streaming_conf_takes_micro_cycles_through_torch_allocate(tmp_path):
    """A conf with ``streaming: true`` runs the streaming loop (not the
    periodic loop in silence): arrivals after the first full cycle bind
    through micro-cycles, each a torch_allocate solve on the fused rung
    with the encode span's micro flag, metered as micro_cycles_total."""
    store = PORT.cache.ClusterStore()
    seed_cluster(PORT, store)
    _, sched = make_streaming_scheduler(PORT, store, tmp_path, period=60.0)
    action = next(a for a in sched.actions if a.name == "torch_allocate")
    seen = []
    real = action.execute

    def execute(ssn):
        real(ssn)
        seen.append((ssn.micro_cycle, action.last_solver_tier))

    action.execute = execute
    ok0 = PORT.metrics.micro_cycles.value({"outcome": "ok"})
    with Loop(sched):
        wait_until(lambda: sched._stream_state is not None and sched._stream_state.valid,
                   what="resident table adopted")
        for g in range(2):
            arrive_gang(PORT, store, f"g{g}", members=3)
            wait_until(lambda: all_bound(store), what=f"gang g{g} bound")
    assert sched.micro_cycles_run >= 2
    assert (True, "fused") in seen, seen
    assert all(tier == "fused" for micro, tier in seen if micro)
    assert PORT.metrics.micro_cycles.value({"outcome": "ok"}) - ok0 >= 2
    assert PORT.metrics.time_to_bind.snapshot()["count"] >= 6
