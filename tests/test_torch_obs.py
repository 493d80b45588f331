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
- With tracing off every entry point returns the shared no-op span."""

import collections
import json

import numpy as np
import pytest

from kube_batch_tpu import obs as jax_obs
from kube_batch_tpu.scheduler import Scheduler as JaxScheduler
from kube_batch_tpu.testing import x64_enabled

import kube_batch_tpu_torch.testing as torch_testing
from kube_batch_tpu_torch import obs as torch_obs
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
