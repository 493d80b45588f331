"""The port's chaos suite: its fault registry and fault points driven through
real scheduling sessions, case for case with tests/test_faults.py, and the
one port test that arms ``bind.slow``.

The JAX cases and their counterparts:
- held here, each on both packages or the port against the JAX outcome:
  ``test_native_boundary_faults_fall_back_to_python_twins`` (through
  torch_allocate), ``test_bind_rejection_retries_with_jitter_then_lands``,
  ``test_bind_rejection_beyond_retries_requeues_and_recovers``,
  ``test_watch_drop_client_recovers_via_relist``,
  ``test_410_relist_storm_converges_and_staleness_gauge_recovers``,
  ``test_lease_partition_fires_on_lost_within_deadline_and_releases``,
  ``test_fault_and_ladder_metrics_visible_on_metrics_endpoint``, the three
  cache-mutation detector cases, and the registry's
  ``test_registry_probability_and_seed_are_deterministic`` and
  ``test_registry_count_and_spec_grammar``, each under its own name;
- the solver cases are tests/test_torch_solver_faults.py's:
  ``test_solver_fault_degrades_to_serial_with_identical_binds`` is
  ``test_device_floor_fault_degrades_to_serial_like_the_jax_action``,
  ``test_nan_poisoned_score_tensor_hits_finite_guard`` is
  ``test_nan_weights_route_serial_on_both_sides`` and
  ``test_breaker_open_probe_close_cycle_through_sessions`` is
  ``test_breaker_open_probe_close_through_sessions``;
  ``test_breaker_open_probe_close_cycle_unit`` is
  tests/test_torch_ladder.py's
  ``test_open_probe_close_history_and_backoff_doubling``.

``bind.slow``: tests/test_obs.py's
``test_flight_recorder_dump_survives_kill_mid_dispatch`` is mirrored at
the end, the port's leader killed mid-dispatch with the point armed.

The port's device rung runs on the CPU (``device: cpu``, the kernels'
plain versions); the JAX package with jax x64 off.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import types
import urllib.error
import urllib.request
from importlib import import_module

import pytest

from kube_batch_tpu.testing import x64_enabled

TIERS = """
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""


def _ns(root: str) -> types.SimpleNamespace:
    import_module(f"{root}.actions")
    import_module(f"{root}.plugins")
    cache = import_module(f"{root}.cache")
    server = import_module(f"{root}.server")
    md = import_module(f"{root}.faults.mutation_detector")
    fw = import_module(f"{root}.framework")
    return types.SimpleNamespace(
        name=root, faults=import_module(f"{root}.faults"), metrics=import_module(f"{root}.metrics"),
        ClusterStore=cache.ClusterStore, SchedulerCache=cache.SchedulerCache, Scheduler=import_module(
            f"{root}.scheduler").Scheduler, SchedulerServer=server.SchedulerServer,
        StoreLeaseElector=server.StoreLeaseElector, MutationDetector=md.MutationDetector,
        CacheMutationError=md.CacheMutationError, ResilientWatcher=import_module(f"{root}.recovery").ResilientWatcher,
        parse=import_module(f"{root}.conf").parse_scheduler_conf, open_session=fw.open_session,
        close_session=fw.close_session, get_action=fw.get_action, t=import_module(f"{root}.testing"),
    )


JAX, PORT = _ns("kube_batch_tpu"), _ns("kube_batch_tpu_torch")
BOTH = (JAX, PORT)


@pytest.fixture(autouse=True)
def _clean_faults():
    """No drill outlives its test: registries and breakers reset."""
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
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def make_cluster(P):
    """3 gangs x 4 pods on 4 nodes."""
    t = P.t
    pods = [t.build_pod(name=f"p{i}", group_name=f"g{i % 3}", req=t.build_resource_list(cpu=1, memory="512Mi"))
            for i in range(12)]
    nodes = [t.build_node(f"n{i}", t.build_resource_list(cpu=8, memory="8Gi", pods=16)) for i in range(4)]
    pgs = [t.build_pod_group(f"g{j}", min_member=4) for j in range(3)]
    return t.build_cluster(pods, nodes, pgs, [t.build_queue("default")])


def device_session(P):
    """One session of the package's device allocate (``xla_allocate``; the
    port's ``torch_allocate`` on the CPU with the size floor off): binds
    and the action."""
    name = "xla_allocate" if P is JAX else "torch_allocate"
    args = {} if P is JAX else {"torch_allocate": {"device": "cpu", "min_device_pairs": "0"}}
    cache = P.t.FakeCache(make_cluster(P))
    ssn = P.open_session(cache, P.parse(TIERS).tiers, args)
    action = P.get_action(name)
    action.execute(ssn)
    P.close_session(ssn)
    return dict(cache.binder.binds), action


# -- the native extension boundary ------------------------------------------------


def test_native_boundary_faults_fall_back_to_python_twins():
    """native.load / native.prepass / native.dispatch: with each native
    fast path failing, the Python twins give the same binds through the
    device solve, in the port as in the JAX package."""
    with x64_enabled(False):
        ref, _ = device_session(JAX)
    clean, _ = device_session(PORT)
    assert clean == ref and len(clean) == 12
    for point in ("native.load", "native.prepass", "native.dispatch"):
        PORT.faults.registry.reset()
        PORT.faults.registry.arm(point)
        faulted, a = device_session(PORT)
        assert "solve_s" in a.last_timings, (point, a.last_timings)
        assert faulted == clean, point


# -- the cache's write side ---------------------------------------------------------


def test_bind_rejection_retries_with_jitter_then_lands():
    """bind.write: the first two write attempts are rejected; the retry
    ladder lands the binds within the same cycle, and the retries are
    metered, in both packages."""
    def case(P):
        t = P.t
        store = P.ClusterStore()
        store.create_node(t.build_node("n0", t.build_resource_list(cpu=8, memory="8Gi", pods=16)))
        store.create_queue(t.build_queue("default"))
        for i in range(3):
            store.create_pod(t.build_pod(name=f"p{i}", req=t.build_resource_list(cpu=1, memory="1Gi")))
        sched = P.Scheduler(P.SchedulerCache(store), schedule_period=0.05)
        if P is PORT:  # the default conf's torch_allocate, on the CPU
            sched.action_arguments = {"torch_allocate": {"device": "cpu"}}
        before = P.metrics.write_retries.value({"op": "bind"})
        P.faults.registry.arm("bind.write", count=2)
        sched.run_once()
        nodes = sorted(p.node_name for p in store.list("pods"))
        assert nodes == ["n0"] * 3, nodes
        assert P.metrics.write_retries.value({"op": "bind"}) >= before + 2
        return nodes

    with x64_enabled(False):
        ref = case(JAX)
    assert case(PORT) == ref


def test_bind_rejection_beyond_retries_requeues_and_recovers(tmp_path):
    """bind.write past the retry budget: the binds fall to the errTasks
    resync queue, and once the fault clears the live loop lands them."""
    conf = tmp_path / "conf.yaml"
    conf.write_text('actions: "enqueue, torch_allocate, backfill"\n' + TIERS
                    + "actionArguments:\n  torch_allocate:\n    device: cpu\n")
    t = PORT.t
    srv = PORT.SchedulerServer(listen_address="127.0.0.1:0", schedule_period=0.05, scheduler_conf=str(conf))
    srv.store.create_node(t.build_node("n0", t.build_resource_list(cpu=8, memory="8Gi", pods=16)))
    PORT.faults.registry.arm("bind.write", count=8)  # past one cycle's retry budget
    try:
        srv.start()
        for i in range(2):
            srv.store.create_pod(t.build_pod(name=f"p{i}", req=t.build_resource_list(cpu=1, memory="1Gi")))
        wait_until(lambda: all(p.node_name for p in srv.store.list("pods")),
                   what="binds land after injected write rejections")
    finally:
        srv.stop()
    assert PORT.metrics.fault_injections.value({"point": "bind.write"}) >= 8


# -- the watch hub ------------------------------------------------------------------


def test_watch_drop_client_recovers_via_relist():
    """watch.drop: an injected stream drop answers 410 Gone; a client that
    re-lists and resumes from the listed resourceVersion converges on the
    store's state. The same HTTP exchange against both packages' servers."""
    def case(P):
        srv = P.SchedulerServer(listen_address="127.0.0.1:0", schedule_period=5.0)
        srv.start()
        base = f"http://127.0.0.1:{srv.listen_port}/apis/v1alpha1"
        try:
            def get(path):
                with urllib.request.urlopen(f"{base}/{path}", timeout=5) as r:
                    return r.getcode(), json.loads(r.read())

            _, listing = get("queues")
            rv = listing["resourceVersion"]
            P.faults.registry.arm("watch.drop", count=1)
            with pytest.raises(urllib.error.HTTPError) as e:
                get(f"watch/queues?since={rv}&timeout=0.2")
            assert e.value.code == 410
            srv.store.create_queue(P.t.build_queue("tenant-a", weight=3))
            code, listing = get("queues")
            names = {q["name"] for q in listing["items"]}
            assert code == 200 and names == {"default", "tenant-a"}
            rv = listing["resourceVersion"]
            srv.store.create_queue(P.t.build_queue("tenant-b", weight=2))
            code, watch = get(f"watch/queues?since={rv}&timeout=5")
            events = [e["object"]["name"] for e in watch["events"]]
            assert code == 200 and events == ["tenant-b"]
            return sorted(names), events
        finally:
            srv.stop()

    assert case(PORT) == case(JAX)


def test_410_relist_storm_converges_and_staleness_gauge_recovers():
    """Repeated watch.drop firings under churn: the port's
    ResilientWatcher rides the storm by re-listing; once the drops stop
    its mirror converges to the store and the snapshot age returns to
    about 0."""
    P = PORT
    srv = P.SchedulerServer(listen_address="127.0.0.1:0", schedule_period=5.0)
    srv.start()
    w = P.ResilientWatcher(f"http://127.0.0.1:{srv.listen_port}", ("queues",), poll_timeout=0.3,
                           min_backoff=0.01, relist_min_interval=0.05)
    try:
        w.start()
        wait_until(lambda: "default" in w.mirror["queues"], what="initial list lands")
        relists_before = P.metrics.watch_relists.value({"kind": "queues"})
        P.faults.registry.arm("watch.drop", probability=0.5, seed=11)
        for i in range(12):
            srv.store.create_queue(P.t.build_queue(f"storm{i}", weight=1 + i % 3))
            time.sleep(0.02)
        for i in range(0, 12, 2):
            srv.store.delete_queue(f"storm{i}")
        time.sleep(0.3)  # several drops fire mid-churn
        P.faults.registry.reset()
        truth = {q.name for q in srv.store.list("queues")}
        wait_until(lambda: set(w.mirror["queues"]) == truth, what="mirror converges after the storm")
        wait_until(lambda: w.snapshot_age() < 1.0, what="staleness gauge returns to ~0")
        assert P.metrics.fault_injections.value({"point": "watch.drop"}) >= 1
        assert P.metrics.watch_relists.value({"kind": "queues"}) >= relists_before + 1
        assert P.metrics.watch_snapshot_age.value() < 1.0
    finally:
        w.stop()
        srv.stop()


# -- the lease elector --------------------------------------------------------------


def test_lease_partition_fires_on_lost_within_deadline_and_releases():
    """lease.renew: every renewal fails; on_lost fires within the renew
    deadline and the loss path's release lets a standby take the lease at
    once, in both packages."""
    def case(P):
        store = P.ClusterStore()
        a = P.StoreLeaseElector(store, "kb-chaos", "a", lease_duration=30.0, renew_deadline=0.4, retry_period=0.1)
        assert a.acquire(blocking=False)
        P.faults.registry.arm("lease.renew")
        lost = threading.Event()
        t0 = time.monotonic()
        a.start_renewing(lost.set)
        assert lost.wait(2.0), "partitioned leader never noticed"
        assert time.monotonic() - t0 < 2.0
        assert not a.is_leader
        P.faults.registry.reset()
        b = P.StoreLeaseElector(store, "kb-chaos", "b", lease_duration=5.0, renew_deadline=4.0, retry_period=0.1)
        took = b.acquire(blocking=False)
        assert took, "lease not released on loss"
        b.release()
        return took

    assert case(PORT) == case(JAX)


# -- the metrics surface ---------------------------------------------------------


def test_fault_and_ladder_metrics_visible_on_metrics_endpoint():
    """The fault and ladder series on /metrics, under the JAX names; the
    port's device tiers are ``sharded`` and ``fused``."""
    P = PORT
    P.faults.registry.arm("watch.drop", count=1)
    srv = P.SchedulerServer(listen_address="127.0.0.1:0", schedule_period=5.0)
    srv.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{srv.listen_port}/apis/v1alpha1/watch/queues?since=0&timeout=0.1",
                                   timeout=5)
        assert e.value.code == 410
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.listen_port}/metrics", timeout=5) as r:
            text = r.read().decode()
    finally:
        srv.stop()
    assert 'kube_batch_tpu_fault_injections_total{point="watch.drop"}' in text
    assert "kube_batch_tpu_breaker_state" in text
    assert 'tier="fused"' in text
    for family in ("breaker_transitions_total", "degraded_cycles_total", "write_retries_total",
                   "cache_mutation_violations_total"):
        assert f"kube_batch_tpu_{family}" in text, family


# -- the cache-mutation detector ---------------------------------------------------


def test_mutation_detector_fires_on_seeded_violation():
    """An object mutated in place (identity kept, content changed) fires;
    a replaced one does not, in both packages."""
    def case(P):
        t = P.t
        store = P.ClusterStore()
        store.create_node(t.build_node("n0", t.build_resource_list(cpu=4, memory="4Gi")))
        pod = t.build_pod(name="victim", req=t.build_resource_list(cpu=1, memory="1Gi"))
        store.create_pod(pod)
        det = P.MutationDetector(store)
        det.snapshot()
        store.update_pod(dataclasses.replace(pod, node_name="n0"))
        assert det.violations() == []
        store.list("nodes")[0].metadata.labels["mutated"] = "yes"
        before = P.metrics.cache_mutation_violations.value({"kind": "nodes"})
        with pytest.raises(P.CacheMutationError, match="nodes/n0") as e:
            det.verify()
        assert P.metrics.cache_mutation_violations.value({"kind": "nodes"}) == before + 1
        return str(e.value)

    assert case(PORT) == case(JAX)


def _store_scheduler(P, tmp_path, gang: bool):
    t = P.t
    store = P.ClusterStore()
    store.create_node(t.build_node("n0", t.build_resource_list(cpu=8, memory="8Gi", pods=16)))
    store.create_queue(t.build_queue("default"))
    if gang:
        store.create_pod_group(t.build_pod_group("g", min_member=2))
    for i in range(2 if gang else 1):
        store.create_pod(t.build_pod(name=f"p{i}", group_name="g" if gang else None,
                                     req=t.build_resource_list(cpu=1, memory="1Gi")))
    conf = None
    if P is PORT:
        path = tmp_path / "port.yaml"
        path.write_text('actions: "enqueue, torch_allocate, backfill"\n' + TIERS
                        + "actionArguments:\n  torch_allocate:\n    device: cpu\n")
        conf = str(path)
    return store, P.Scheduler(P.SchedulerCache(store), scheduler_conf=conf, schedule_period=0.05)


def test_mutation_detector_catches_evil_action_through_run_once(monkeypatch, tmp_path):
    """An action that mutates a cached Node in place is caught by the
    detector around run_once, in both packages."""
    monkeypatch.setenv("KBT_CACHE_MUTATION_DETECTOR", "1")

    class EvilAction:
        name = "evil"

        def execute(self, ssn):
            for ni in ssn.nodes.values():
                ni.node.metadata.labels["evil"] = "1"

    for P in BOTH:
        _, sched = _store_scheduler(P, tmp_path, gang=False)
        sched.actions = list(sched.actions) + [EvilAction()]
        with pytest.raises(P.CacheMutationError, match="nodes/n0"):
            with x64_enabled(False):
                sched.run_once()


def test_mutation_detector_clean_cycle_passes(monkeypatch, tmp_path):
    """No false positive: two normal cycles (binds, status write-back) are
    clean under the detector and bind the same pods in both packages."""
    monkeypatch.setenv("KBT_CACHE_MUTATION_DETECTOR", "1")
    placed = []
    for P in BOTH:
        store, sched = _store_scheduler(P, tmp_path, gang=True)
        with x64_enabled(False):
            sched.run_once()
            sched.run_once()  # the second cycle sees the bound pods round-tripped
        pods = store.list("pods")
        assert all(p.node_name for p in pods)
        placed.append(sorted((p.metadata.name, p.node_name) for p in pods))
    assert placed[0] == placed[1]


# -- registry semantics ---------------------------------------------------------


def test_registry_probability_and_seed_are_deterministic():
    """Draws below probability 1 come from a per-point seeded generator:
    the same spec replays the same pattern, in both packages alike."""
    def pattern(P):
        reg = P.faults.FaultRegistry(spec="", seed=7)
        reg.arm("watch.drop", probability=0.5)
        return [reg.should_fire("watch.drop") for _ in range(32)]

    p1, p2 = pattern(PORT), pattern(PORT)
    assert p1 == p2
    assert any(p1) and not all(p1)
    assert p1 == pattern(JAX)


def test_registry_count_and_spec_grammar():
    def case(P):
        reg = P.faults.FaultRegistry(spec="bind.write:1:2,watch.drop:0.5,bogus:1")
        active = reg.active()
        assert set(active) == {"bind.write", "watch.drop"}  # bogus rejected
        assert active["bind.write"] == (1.0, 2, 0)
        fires = [reg.should_fire("bind.write") for _ in range(3)]
        assert fires == [True, True, False]  # the count is exhausted
        reg.configure("bind.write:off")
        assert "bind.write" not in reg.active()
        with pytest.raises(ValueError, match="unknown fault point") as e:
            reg.arm("no.such.point")
        return sorted(active.items()), fires, str(e.value).split(" (known")[0]  # each names its own points

    assert case(PORT) == case(JAX)


# -- bind.slow: the flight recorder survives a kill mid-dispatch ---------------------


class _LeaderKilled(BaseException):
    """A SIGKILL stand-in (a BaseException defeats the retry ladder)."""


def test_flight_recorder_dump_survives_kill_mid_dispatch(tmp_path, monkeypatch):
    """The port's leader dies mid-dispatch (after the journal append, after
    some store writes). ``bind.slow`` fires just before the kill and dumps
    the flight recorder, so the dump holds the interrupted cycle's spans;
    the dump and the journal stay readable, and the standby's
    reconciliation lands every bind."""
    from kube_batch_tpu_torch import obs
    from kube_batch_tpu_torch.cache.cache import StoreBinder
    from kube_batch_tpu_torch.recovery import WriteIntentJournal, reconcile_journal

    class DyingBinder(StoreBinder):
        def __init__(self, store, die_after: int) -> None:
            super().__init__(store)
            self.left = die_after

        def bind(self, pod, hostname: str) -> None:
            if self.left <= 0:
                raise _LeaderKilled()
            self.left -= 1
            super().bind(pod, hostname)

    monkeypatch.setenv(obs.ENV, "1")
    monkeypatch.setenv(obs.RECORDER_ENV, str(tmp_path / "flight"))
    obs.configure()
    obs.recorder.clear()
    obs.recorder._last_dump_mono = 0.0  # undo earlier tests' dump throttle
    try:
        PORT.faults.registry.arm("bind.slow", count=1)
        t = PORT.t
        store = PORT.ClusterStore()
        store.create_queue(t.build_queue("default"))
        for i in range(4):
            store.create_node(t.build_node(f"n{i}", t.build_resource_list(cpu=16, memory="16Gi", pods=32)))
        for g in range(2):
            store.create_pod_group(t.build_pod_group(f"g{g}", min_member=6))
            for m in range(6):
                store.create_pod(t.build_pod(name=f"g{g}-p{m}", group_name=f"g{g}",
                                             req=t.build_resource_list(cpu=1, memory="512Mi")))
        conf = tmp_path / "conf.yaml"
        conf.write_text('actions: "enqueue, torch_allocate"\ntiers:\n- plugins:\n  - name: priority\n'
                        "  - name: gang\n  - name: conformance\n- plugins:\n  - name: predicates\n"
                        "  - name: nodeorder\nactionArguments:\n  torch_allocate:\n    device: cpu\n"
                        "    min_device_pairs: 0\n")
        journal = WriteIntentJournal(str(tmp_path / "leader.wal"))
        cache = PORT.SchedulerCache(store, journal=journal, binder=DyingBinder(store, die_after=4))
        sched = PORT.Scheduler(cache, scheduler_conf=str(conf), schedule_period=0.05)
        with pytest.raises(_LeaderKilled):
            sched.run_once()
        landed = sum(1 for p in store.list("pods") if p.node_name)
        assert 0 < landed < 12, "the kill must land mid-batch"
        assert PORT.metrics.fault_injections.value({"point": "bind.slow"}) >= 1

        dump_dir = obs.recorder.dump_dir()
        dumps = [f for f in os.listdir(dump_dir) if f.endswith(".jsonl")]
        assert any("fault_bind.slow" in f for f in dumps), dumps
        with open(os.path.join(dump_dir, dumps[0]), encoding="utf-8") as fh:
            dumped = [json.loads(line) for line in fh]
        names = {s["name"] for s in dumped}
        assert {"snapshot", "encode", "solve", "journal.append"} <= names
        assert len({s["trace_id"] for s in dumped if s["name"] == "solve"}) == 1
        chrome = [f for f in os.listdir(dump_dir) if f.endswith(".trace.json")]
        with open(os.path.join(dump_dir, chrome[0]), encoding="utf-8") as fh:
            assert json.load(fh)["traceEvents"]

        standby = WriteIntentJournal(str(tmp_path / "leader.wal"))
        report = reconcile_journal(standby, store)
        assert report.redispatched == 12 - landed
        assert all(p.node_name for p in store.list("pods"))
    finally:
        obs.configure("off")
        obs.recorder.clear()
