"""The port's tracing (kube_batch_tpu_torch.obs) against the JAX package's
(kube_batch_tpu.obs).

- One traced ``run_once`` of each package over the same world (JAX
  ``xla_allocate, backfill`` under x64 off; the port's ``torch_allocate,
  backfill`` with ``device: cpu``) gives the same multiset of (span,
  parent span) name pairs and the same attribute keys per span name.
- ``check_tree`` is clean, and the Chrome export loads as JSON.
- A hard abort dumps the flight recorder's ring under the test's directory.
- ``QuantileSketch`` and ``SLOAccountant`` give the JAX package's
  quantiles on the same numpy samples.
- With tracing off every entry point returns the shared no-op span.

The cases of tests/test_obs.py have twins of the same name in the last
section of this file, each the JAX case's assertions on the port (its
scheduling cycles run ``torch_allocate`` with ``device: cpu``), except:
test_flight_recorder_dump_survives_kill_mid_dispatch, whose twin of that
name is in tests/test_torch_faults.py, and
test_conf_trace_key_hot_reloads_the_switch, whose twin is
test_the_conf_trace_key_and_the_environment above."""

import collections
import json

import numpy as np
import pytest

from kube_batch_tpu import obs as jax_obs
from kube_batch_tpu.scheduler import Scheduler as JaxScheduler
from kube_batch_tpu.testing import x64_enabled

import kube_batch_tpu_torch.testing as torch_testing
from kube_batch_tpu_torch import metrics as port_metrics
from kube_batch_tpu_torch import obs as torch_obs
from kube_batch_tpu_torch.cache import ClusterStore, SchedulerCache
from kube_batch_tpu_torch.cache.store import PODS
from kube_batch_tpu_torch.recovery import WriteIntentJournal
from kube_batch_tpu_torch.scheduler import Scheduler

from test_torch_actions import JAX, TORCH, make
from test_torch_scheduler import TORCH_CONF, port_conf


@pytest.fixture
def traced(monkeypatch, tmp_path):
    """KBT_TRACE on for both packages, empty rings, dumps under tmp_path;
    tracing off again afterwards."""
    monkeypatch.setenv("KBT_TRACE", "1")
    monkeypatch.setenv("KBT_FLIGHT_RECORDER", str(tmp_path / "flight"))
    for obs in (jax_obs, torch_obs):
        obs.configure()
        obs.recorder.clear()
    yield tmp_path
    monkeypatch.delenv("KBT_TRACE")
    for obs in (jax_obs, torch_obs):
        obs.recorder.clear()
        obs.configure()


def _jax_conf(tmp_path, **_):
    path = tmp_path / "jax-conf.yaml"
    path.write_text(TORCH_CONF.replace('"torch_allocate, backfill"', '"xla_allocate, backfill"'))
    return str(path)


def _port_conf(tmp_path, **args):
    path = tmp_path / "torch-conf.yaml"
    path.write_text(port_conf(device="cpu", min_device_pairs=0, **args))
    return str(path)


def _tree(spans):
    by_id = {s["span_id"]: s for s in spans}
    pairs = collections.Counter(
        (s["name"], by_id[s["parent_id"]]["name"] if s["parent_id"] else None) for s in spans
    )
    keys = collections.defaultdict(set)
    for s in spans:
        keys[s["name"]] |= set(s["attrs"])
    return pairs, dict(keys)


@pytest.mark.parametrize("key, args", [
    ("preempt_mix_2000_40_seed1", {}),
    ("pod_affinity_many", {}),
    ("multi_tenant_ml_8_8_3", {"mesh": "cpu:4"}),
])
def test_one_traced_cycle_gives_the_jax_span_tree(traced, key, args):
    with x64_enabled(False):
        JaxScheduler(JAX.t.FakeCache(make(key, JAX)), _jax_conf(traced)).run_once()
    Scheduler(torch_testing.FakeCache(make(key, TORCH)), _port_conf(traced, **args)).run_once()
    jax_spans, port_spans = jax_obs.recorder.spans(), torch_obs.recorder.spans()
    assert _tree(port_spans) == _tree(jax_spans)
    pairs, _ = _tree(port_spans)
    assert pairs[("cycle", None)] == 1
    for name in ("snapshot", "encode", "solve", "gang.assign", "commit"):
        assert pairs[(name, "cycle")] == 1, name
    assert torch_obs.check_tree(port_spans) == []
    solve = next(s for s in port_spans if s["name"] == "solve")
    assert solve["attrs"]["tier"] == ("sharded" if args else "fused")
    host_steps = [e for e in solve["events"] if e["name"] == "host_step"]
    jax_solve = next(s for s in jax_spans if s["name"] == "solve")
    assert len(host_steps) == len([e for e in jax_solve["events"] if e["name"] == "host_step"])


def test_check_tree_and_the_chrome_export(traced):
    sched = Scheduler(torch_testing.FakeCache(make("preempt_mix_2000_40_seed1", TORCH)), _port_conf(traced))
    sched.run_once()
    sched.run_once()
    spans = torch_obs.recorder.spans()
    assert torch_obs.check_tree(spans) == []
    assert len({s["trace_id"] for s in spans}) == 2  # one trace per cycle
    path = torch_obs.export_chrome(spans, str(traced / "cycle.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert {e["name"] for e in events if e["ph"] == "X"} == {
        "cycle", "snapshot", "encode", "solve", "gang.assign", "commit"}
    assert all(e["dur"] >= 1 for e in events if e["ph"] == "X")
    lines = open(torch_obs.export_jsonl(spans, str(traced / "cycle.jsonl"))).read().splitlines()
    assert [json.loads(line)["span_id"] for line in lines] == [s["span_id"] for s in spans]
    # a broken tree is reported: an undeclared name, a dangling parent
    bad = [dict(s) for s in spans]
    bad[0]["name"] = "nope"
    bad[1]["parent_id"] = "feedfacefeedface"
    assert len(torch_obs.check_tree(bad)) == 2


def test_span_durations_bracket_last_timings(traced):
    """Spans and last_timings are two views of one cycle: each span's
    duration is its phase's wall clock, give or take the clock reads
    between them (5 ms here)."""
    sched = Scheduler(torch_testing.FakeCache(make("preempt_mix_2000_40_seed1", TORCH)), _port_conf(traced))
    sched.run_once()
    spans = {s["name"]: s["dur_us"] / 1e6 for s in torch_obs.recorder.spans()}
    act = sched.actions[0].last_timings
    for span, timing in (("snapshot", sched.last_timings["snapshot_s"]), ("encode", act["encode_s"]),
                         ("gang.assign", act["replay_s"]),
                         ("cycle", sched.last_timings["run_once_s"] - sched.last_timings["conf_s"])):
        assert abs(spans[span] - timing) < 5e-3, span
    assert spans["solve"] <= act["solve_s"] + act["pack_s"] + 5e-3


def test_a_hard_abort_dumps_the_ring(traced):
    sched = Scheduler(torch_testing.FakeCache(make("gang_atomic", TORCH)), _port_conf(traced),
                      hard_deadline_s=1e-9)
    sched.run_once()
    assert "aborted" in sched.last_timings
    path = torch_obs.recorder.last_dump_path
    assert path is not None and path.startswith(str(traced / "flight")) and "hard_deadline" in path
    # the ring as it stood at the abort, inside the still-open cycle span:
    # the solve span carries the abort
    spans = [json.loads(line) for line in open(path)]
    assert {s["name"] for s in spans} == {"snapshot", "encode", "solve"}
    solve = next(s for s in spans if s["name"] == "solve")
    assert "CycleDeadlineExceeded" in solve["attrs"]["error"] and "solver entry" in solve["attrs"]["error"]
    cycle = next(s for s in torch_obs.recorder.spans() if s["name"] == "cycle")
    assert "solver entry" in cycle["attrs"]["aborted"]
    with open(path[: -len(".jsonl")] + ".trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_the_conf_trace_key_and_the_environment(monkeypatch, tmp_path):
    """``trace: on`` in the conf turns tracing on for the cycle; an empty
    key defers to KBT_TRACE, which still flips it between conf pushes."""
    monkeypatch.delenv("KBT_TRACE", raising=False)
    torch_obs.configure()
    try:
        path = tmp_path / "conf.yaml"
        path.write_text('trace: "on"\n' + port_conf(device="cpu", min_device_pairs=0))
        sched = Scheduler(torch_testing.FakeCache(make("gang_atomic", TORCH)), str(path))
        assert torch_obs.enabled()
        path.write_text(port_conf(device="cpu", min_device_pairs=0))
        sched.run_once()
        assert not torch_obs.enabled() and torch_obs.span("cycle") is torch_obs.NOOP_SPAN
        monkeypatch.setenv("KBT_TRACE", "1")
        sched.run_once()
        assert torch_obs.enabled()
    finally:
        monkeypatch.delenv("KBT_TRACE", raising=False)
        torch_obs.configure()
        torch_obs.recorder.clear()


def test_tracing_off_is_the_shared_noop_span():
    torch_obs.configure("off")
    try:
        assert torch_obs.span("cycle") is torch_obs.NOOP_SPAN
        assert torch_obs.annotate("kbt.solve") is torch_obs.NOOP_SPAN
        assert torch_obs.current() is None
        torch_obs.event("x")
        torch_obs.emit("cycle", 0.0, 1.0)
        assert torch_obs.recorder.spans() == []
    finally:
        torch_obs.configure()


def test_annotate_is_a_profiler_range_when_tracing():
    from torch.profiler import record_function

    torch_obs.configure("on")
    try:
        with torch_obs.annotate("kbt.solve") as r:
            assert isinstance(r, record_function)
    finally:
        torch_obs.configure()
        torch_obs.recorder.clear()


@pytest.mark.parametrize("seed", range(6))
def test_sketch_quantiles_equal_the_jax_sketch(seed):
    rng = np.random.default_rng(seed)
    values = np.concatenate([rng.lognormal(-4, 2, 300), np.zeros(int(rng.integers(0, 20)))])
    times = 1_700_000_000.0 + np.sort(rng.uniform(0, 600, values.size))
    alpha = float(rng.choice([0.01, 0.05]))
    js, ts = jax_obs.QuantileSketch(alpha=alpha), torch_obs.QuantileSketch(alpha=alpha)
    for v, t in zip(values.tolist(), times.tolist()):
        js.add(v, t)
        ts.add(v, t)
    for now in (times[-1], times[-1] + 150.0):
        js.trim(now)
        ts.trim(now)
        assert js.count() == ts.count() and js.total() == ts.total()
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert js.quantile(q) == ts.quantile(q)


@pytest.mark.parametrize("seed", range(3))
def test_slo_accountant_equals_the_jax_accountant(seed):
    """Per-queue windows, the LRU bound and the published gauges."""
    from kube_batch_tpu import metrics as jax_metrics
    from kube_batch_tpu_torch import metrics as torch_metrics

    rng = np.random.default_rng(seed)
    ja = jax_obs.SLOAccountant(window_s=300.0, max_queues=3)
    ta = torch_obs.SLOAccountant(window_s=300.0, max_queues=3)
    queues = [f"slo-parity-{seed}-{k}" for k in range(5)]
    for _ in range(400):
        q = queues[int(rng.integers(0, len(queues)))]
        v = float(rng.exponential(0.05))
        kind = "queue_wait" if rng.random() < 0.8 else "time_to_bind"
        ja.observe(kind, q, v)
        ta.observe(kind, q, v)
    ja.observe("no_such_kind", "q", 1.0)
    ta.observe("no_such_kind", "q", 1.0)
    snap = ta.publish()
    assert snap == ja.publish()
    for kind, per_queue in snap.items():
        assert len(per_queue) <= 3
        for q, stats in per_queue.items():
            labels = {"queue": q, "quantile": "p99"}
            gauge = {"queue_wait": "slo_queue_wait", "time_to_bind": "slo_time_to_bind"}[kind]
            assert getattr(torch_metrics, gauge).value(labels) == getattr(jax_metrics, gauge).value(labels)
            assert getattr(torch_metrics, gauge).value(labels) == stats["p99"]
    evicted = [q for q in queues if all(q not in snap[k] for k in snap)]
    for q in evicted:
        assert torch_metrics.slo_queue_wait.value({"queue": q, "quantile": "p50"}) == 0.0


def test_the_session_feeds_queue_wait_at_every_serial_dispatch(monkeypatch, tmp_path):
    seen = []
    monkeypatch.setattr(torch_obs.slo, "observe", lambda kind, q, v: seen.append((kind, q)))
    path = tmp_path / "conf.yaml"
    path.write_text(TORCH_CONF.replace('"torch_allocate, backfill"', '"allocate, backfill"'))
    cache = torch_testing.FakeCache(make("gang_atomic", TORCH))
    Scheduler(cache, str(path)).run_once()
    assert len(seen) == len(cache.binder.binds) == 3 and {k for k, _ in seen} == {"queue_wait"}


# -- twins of tests/test_obs.py ------------------------------------------------

STORE_CONF = """
actions: "enqueue, torch_allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: predicates
  - name: nodeorder
actionArguments:
  torch_allocate:
    device: cpu
    min_device_pairs: 0
"""

STREAM_CONF = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: predicates
  - name: nodeorder
streaming: true
"""


@pytest.fixture
def tracing(monkeypatch, tmp_path):
    """The JAX file's fixture on the port: tracing on through the
    environment, dumps under tmp_path, empty ring and SLO windows."""
    monkeypatch.setenv(torch_obs.ENV, "1")
    monkeypatch.setenv(torch_obs.RECORDER_ENV, str(tmp_path / "flight"))
    torch_obs.configure()
    torch_obs.recorder.clear()
    torch_obs.recorder._last_dump_mono = 0.0
    torch_obs.slo.reset()
    yield
    torch_obs.configure("off")
    torch_obs.recorder.clear()
    torch_obs.slo.reset()
    monkeypatch.delenv(torch_obs.ENV)
    torch_obs.configure()


@pytest.fixture
def tracing_off(monkeypatch):
    monkeypatch.delenv(torch_obs.ENV, raising=False)
    torch_obs.configure("off")
    torch_obs.recorder.clear()
    yield
    torch_obs.configure()


def wait_until(pred, timeout=15.0, what="condition"):
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


def seed_store(store, gangs: int = 2, members: int = 4, nodes: int = 4) -> None:
    t = torch_testing
    store.create_queue(t.build_queue("default"))
    for i in range(nodes):
        store.create_node(t.build_node(f"n{i}", t.build_resource_list(cpu=16, memory="16Gi", pods=32)))
    for g in range(gangs):
        store.create_pod_group(t.build_pod_group(f"g{g}", min_member=members))
        for m in range(members):
            store.create_pod(t.build_pod(
                name=f"g{g}-p{m}", group_name=f"g{g}", req=t.build_resource_list(cpu=1, memory="512Mi")))


def make_scheduler(store, tmp_path, conf=STORE_CONF, journal=None, binder=None, period=0.05):
    path = tmp_path / "conf.yaml"
    path.write_text(conf)
    cache = SchedulerCache(store, journal=journal, binder=binder)
    return cache, Scheduler(cache, scheduler_conf=str(path), schedule_period=period)


def test_off_every_entry_point_is_the_noop_singleton(tracing_off):
    obs = torch_obs
    assert not obs.enabled()
    assert obs.span("cycle") is obs.NOOP_SPAN
    assert obs.span("cycle", parent=("abc", "def"), attr=1) is obs.NOOP_SPAN
    assert obs.annotate("kbt.solve") is obs.NOOP_SPAN
    assert obs.current() is None
    assert obs.current_headers() == {}
    assert obs.from_headers({obs.HDR_TRACE: "t", obs.HDR_SPAN: "s"}) is None
    obs.event("ignored")
    obs.emit("time_to_bind", 0.0, 1.0, queue="q")
    assert obs.recorder.spans() == []
    assert (obs.HDR_TRACE, obs.HDR_SPAN) == (jax_obs.HDR_TRACE, jax_obs.HDR_SPAN)


def test_off_cycle_records_nothing(tmp_path, tracing_off):
    store = ClusterStore()
    seed_store(store)
    _, sched = make_scheduler(store, tmp_path)
    sched.run_once()
    assert torch_obs.recorder.spans() == []
    assert all(p.node_name for p in store.list(PODS))


def test_off_overhead_is_one_branch(tracing_off):
    import time

    n = 20_000
    t0 = time.perf_counter()
    for _ in range(n):
        torch_obs.span("cycle")
    assert (time.perf_counter() - t0) / n < 5e-5


def spans_by_name(spans):
    out: dict = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def test_full_cycle_span_tree(tmp_path, tracing):
    journal = WriteIntentJournal(str(tmp_path / "j.wal"))
    store = ClusterStore()
    seed_store(store)
    _, sched = make_scheduler(store, tmp_path, journal=journal)
    sched.run_once()
    wait_until(lambda: all(p.node_name for p in store.list(PODS)), what="all pods bound")
    sched.cache.stop()
    spans = torch_obs.recorder.spans()
    assert torch_obs.check_tree(spans) == []
    by = spans_by_name(spans)
    for name in ("cycle", "snapshot", "encode", "solve", "gang.assign", "dispatch", "journal.append", "commit"):
        assert name in by, f"missing {name} span; got {sorted(by)}"
    cycles = [s for s in by["cycle"] if s["attrs"].get("cycle") == 1]
    assert len(cycles) == 1
    root = cycles[0]
    assert root["parent_id"] == ""
    cycle_spans = [s for s in spans if s["trace_id"] == root["trace_id"]]
    for name in ("snapshot", "encode", "solve", "dispatch", "journal.append"):
        assert any(s["name"] == name for s in cycle_spans), name
    assert "tier" in next(s for s in cycle_spans if s["name"] == "solve")["attrs"]
    assert any(s["name"] == "gang.bind" and s["trace_id"] == root["trace_id"] for s in spans) or "gang.bind" not in by


def test_journal_records_carry_the_cycle_trace(tmp_path, tracing):
    journal = WriteIntentJournal(str(tmp_path / "j.wal"))
    store = ClusterStore()
    seed_store(store)
    _, sched = make_scheduler(store, tmp_path, journal=journal)
    sched.run_once()
    sched.cache.stop()
    root = next(s for s in torch_obs.recorder.spans() if s["name"] == "cycle")
    with open(journal.path, encoding="utf-8") as fh:
        intents = [json.loads(line) for line in fh if '"rec":"intent"' in line]
    assert intents
    assert all(rec.get("trace") == root["trace_id"] for rec in intents)
    replay = WriteIntentJournal.replay(journal.path)
    assert replay.corrupt == 0 and len(replay.intents) == len(intents)


def test_micro_cycle_emits_time_to_bind_spans(tmp_path, tracing):
    import threading

    t = torch_testing
    store = ClusterStore()
    store.create_queue(t.build_queue("default"))
    for i in range(4):
        store.create_node(t.build_node(f"n{i}", t.build_resource_list(cpu=16, memory="16Gi", pods=32)))
    cache, sched = make_scheduler(store, tmp_path, conf=STREAM_CONF, period=30.0)
    stop = threading.Event()
    loop = threading.Thread(target=sched.run, args=(stop,), daemon=True)
    loop.start()
    try:
        wait_until(lambda: sched._stream_state is not None, what="resident stream state")
        store.create_pod_group(t.build_pod_group("g0", min_member=3))
        for m in range(3):
            store.create_pod(t.build_pod(
                name=f"g0-p{m}", group_name="g0", req=t.build_resource_list(cpu=1, memory="512Mi")))
        wait_until(lambda: all(p.node_name for p in store.list(PODS))
                   and any(s["name"] == "time_to_bind" for s in torch_obs.recorder.spans()),
                   what="binds + time_to_bind spans")
    finally:
        stop.set()
        loop.join(timeout=10.0)
        cache.stop()
    spans = torch_obs.recorder.spans()
    assert torch_obs.check_tree(spans) == []
    ttb = [s for s in spans if s["name"] == "time_to_bind"]
    assert ttb and all(s["attrs"]["queue"] == "default" for s in ttb)
    assert all(s["dur_us"] >= 1 for s in ttb)
    if sched.micro_cycles_run:
        assert any(s["name"] == "micro_cycle" for s in spans)
    assert torch_obs.slo.snapshot()["time_to_bind"]["default"]["n"] >= len(ttb)


def test_header_roundtrip_joins_the_trace(tracing):
    with torch_obs.span("gang.bind") as parent:
        headers = torch_obs.current_headers()
        assert headers[torch_obs.HDR_TRACE] == parent.trace_id
        assert headers[torch_obs.HDR_SPAN] == parent.span_id
    child = torch_obs.span("store.bind", parent=torch_obs.from_headers(headers))
    with child:
        pass
    assert child.trace_id == parent.trace_id
    assert child.parent_id == parent.span_id


def test_federated_smoke_joins_conflicted_bind_across_processes(tmp_path):
    result = torch_obs.smoke(shards=2, gangs=4, members=3, nodes=6, out_dir=str(tmp_path / "smoke"), device="cpu")
    assert result["ok"], result
    assert result["tree_violations"] == []
    assert result["conflicted_gang_binds"] >= 1
    assert result["remote_spans_joined"] >= 1
    with open(result["chrome_trace"], encoding="utf-8") as fh:
        events = json.load(fh)["traceEvents"]
    assert any(ev["ph"] == "X" and ev["name"] == "store.bind" for ev in events)
    assert any(ev["ph"] == "s" for ev in events), "missing flow start arrows"
    assert any(ev["ph"] == "f" for ev in events), "missing flow finish arrows"
    with open(result["jsonl"], encoding="utf-8") as fh:
        assert len(fh.readlines()) == result["spans"]


def test_flight_recorder_ring_is_bounded(tracing):
    torch_obs.recorder.resize(4)
    try:
        for i in range(10):
            with torch_obs.span("cycle", i=i):
                pass
        assert torch_obs.recorder.trace_count() == 4
        assert {s["attrs"]["i"] for s in torch_obs.recorder.spans()} == {6, 7, 8, 9}
    finally:
        torch_obs.recorder.resize(256)


def test_dump_throttle_and_disable(tmp_path, tracing, monkeypatch):
    with torch_obs.span("cycle"):
        pass
    assert torch_obs.recorder.dump(reason="first") is not None
    assert torch_obs.recorder.dump(reason="second", min_interval_s=60.0) is None
    monkeypatch.setenv(torch_obs.RECORDER_ENV, "0")
    assert torch_obs.recorder.dump(reason="disabled") is None


REL = torch_obs.QuantileSketch.DEFAULT_ALPHA * 1.05


def test_slo_window_quantile_math():
    acc = torch_obs.SLOAccountant(window_s=300.0)
    for v in range(1, 101):
        acc.observe("time_to_bind", "tenant-a", float(v))
    acc.observe("queue_wait", "", 2.5)
    snap = acc.snapshot()
    a = snap["time_to_bind"]["tenant-a"]
    assert a["n"] == 100
    assert a["p50"] == pytest.approx(50.0, rel=REL)
    assert a["p90"] == pytest.approx(90.0, rel=REL)
    assert a["p99"] == pytest.approx(99.0, rel=REL)
    assert snap["queue_wait"]["default"]["n"] == 1
    assert a["window_s"] == 300.0


def test_slo_window_expires_old_observations():
    import time

    acc = torch_obs.SLOAccountant(window_s=0.05)
    acc.observe("time_to_bind", "q", 1.0)
    time.sleep(0.08)
    acc.observe("time_to_bind", "q", 9.0)
    snap = acc.snapshot()
    assert snap["time_to_bind"]["q"]["n"] == 1
    assert snap["time_to_bind"]["q"]["p99"] == pytest.approx(9.0, rel=REL)


def test_slo_publish_lands_on_metrics_gauges():
    torch_obs.slo.reset()
    try:
        torch_obs.slo.observe("queue_wait", "gold", 0.25)
        torch_obs.slo.publish()
        got = port_metrics.slo_queue_wait.value({"queue": "gold", "quantile": "p99"})
        assert got == pytest.approx(0.25, rel=REL)
        text = port_metrics.render_prometheus_text()
        assert 'kube_batch_tpu_slo_queue_wait_seconds{quantile="p50",queue="gold"}' in text
    finally:
        torch_obs.slo.reset()


def test_slo_always_on_even_with_tracing_off(tracing_off):
    torch_obs.slo.reset()
    try:
        torch_obs.slo.observe("time_to_bind", "q", 0.1)
        assert torch_obs.slo.snapshot()["time_to_bind"]["q"]["n"] == 1
    finally:
        torch_obs.slo.reset()


def _golden_families():
    m = port_metrics
    h = m.Histogram("t_hist_seconds", "a histogram", (0.1, 1.0))
    h.observe(0.05, {"queue": 'say "hi"\nback\\slash'})
    h.observe(5.0, {"queue": 'say "hi"\nback\\slash'})
    h.observe(0.5)
    c = m.Counter("t_total", "a counter")
    c.inc({"op": "bind"}, by=3)
    g = m.Gauge("t_gauge", "a gauge")
    g.set(1.5, {"queue": "a\\b", "quantile": "p50"})
    return [h, c, g]


def test_metrics_exposition_matches_golden_file():
    """The JAX package's golden exposition (tests/data/metrics_golden.txt),
    rendered by the port's metrics."""
    import os

    lines = []
    for fam in _golden_families():
        lines.extend(port_metrics._render_family(fam))
    with open(os.path.join(os.path.dirname(__file__), "data", "metrics_golden.txt"), encoding="utf-8") as fh:
        assert "\n".join(lines) + "\n" == fh.read()


def test_every_registered_family_exposes_help_and_type():
    port_metrics.register_unschedulable("ports")
    port_metrics.register_would_fit_if("ports")
    text = port_metrics.render_prometheus_text()
    helps = {line.split()[2] for line in text.splitlines() if line.startswith("# HELP ")}
    types = {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")}
    assert helps == types and helps
    for name in ("kube_batch_tpu_unschedulable_total", "kube_batch_tpu_would_fit_if_total"):
        assert name in helps, f"{name} missing from exposition"
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        bare = line.split("{")[0].split()[0]
        candidates = {bare} | {bare[: -len(s)] for s in ("_bucket", "_sum", "_count") if bare.endswith(s)}
        assert candidates & helps, f"sample {bare} has no # HELP"


def test_histogram_inf_bucket_equals_count_per_label_set():
    h, _, _ = _golden_families()
    rendered = "\n".join(port_metrics._render_family(h))
    for labels in ({"queue": 'say "hi"\nback\\slash'}, {}):
        assert h.snapshot(labels)["count"] == (2 if labels else 1)
    assert rendered.count('le="+Inf"') == 2
    assert rendered.count("t_hist_seconds_sum") == 2
    assert rendered.count("t_hist_seconds_count") == 2
    assert "\nback" not in rendered.replace("\\nback", "")


def test_debug_endpoints_serve_recorder_and_slo(tmp_path, tracing):
    import urllib.request

    from kube_batch_tpu_torch.server import SchedulerServer

    conf = tmp_path / "conf.yaml"
    conf.write_text(STORE_CONF)
    server = SchedulerServer(
        scheduler_name="obs-test", scheduler_conf=str(conf), listen_address="127.0.0.1:0", schedule_period=60.0,
        device="cpu",
    )
    server.start()

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{server.listen_port}{path}", timeout=5) as r:
            return r.status, r.read().decode()

    try:
        with torch_obs.span("cycle"):
            pass
        torch_obs.slo.observe("queue_wait", "default", 0.2)
        status, body = get("/debug/trace")
        payload = json.loads(body)
        assert status == 200 and payload["enabled"] is True and payload["traces"] >= 1
        assert any(s["name"] == "cycle" for s in payload["spans"])
        status, body = get("/debug/slo")
        assert status == 200 and json.loads(body)["queue_wait"]["default"]["n"] == 1
        status, body = get("/metrics")
        assert status == 200 and "kube_batch_tpu_slo_queue_wait_seconds" in body
    finally:
        server.stop()


def test_span_names_registry_matches_reality():
    assert len(torch_obs.SPAN_NAMES) == len(set(torch_obs.SPAN_NAMES))
    assert torch_obs.DEBUG_ENDPOINTS == (
        "/debug/trace", "/debug/slo", "/debug/explain", "/debug/fleet", "/debug/admission",
    )
    bad = torch_obs.check_tree([{"name": "not-a-span", "trace_id": "t", "span_id": "s", "parent_id": "missing"}])
    assert len(bad) == 2
