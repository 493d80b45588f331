"""The port's admission control plane (admission.py), case for case with
tests/test_admission.py: per-tenant lanes, the hysteresis-banded brownout
controller, and the server's front-door 429 path. Each server runs a conf
whose ``torch_allocate`` is on ``device: cpu``.

Then held against the JAX package: ``admission.smoke(seed=42)`` (the
fake-clock overload plant, no device) gives the same dict in both
packages. The storm cases run the live storm drill (``storm``: streaming
federated shards on the CPU behind the server's gate) with admission on,
off, and with a shard killed, and check the storm's own invariants.

The invariants driven here:

- **bounded, never silent**: every shed carries a positive
  ``Retry-After`` hint and a typed reason; nothing is dropped quietly;
- **ladder discipline**: escalation halves then defers the lowest
  tier first and never touches the protected (top) tier; recovery
  retraces with a longer dwell so the loop cannot flap inside the
  hysteresis band;
- **conservative on partial data**: a dark shard
  (``fleet_shard_up=0``) holds the current brownout level instead of
  reading silence as health;
- **fail-static**: a dead controller tick (``admission.controller``
  fault) leaves the last good lane factors in force.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request

import pytest

from kube_batch_tpu_torch import admission, faults
from kube_batch_tpu_torch.admission import (
    AdmissionGate,
    BackpressureController,
    LaneSpec,
    TokenBucket,
    parse_lane_specs,
)
from kube_batch_tpu_torch.server import SchedulerServer
from kube_batch_tpu_torch.streaming import smoke_conf


def _cpu_conf(tmp_path) -> str:
    path = tmp_path / "conf.yaml"
    path.write_text(smoke_conf(False, "cpu"))
    return str(path)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.registry.reset()
    yield
    faults.registry.reset()


@pytest.fixture(autouse=True)
def _clean_gate(monkeypatch):
    """No test leaves the module-level gate armed."""
    monkeypatch.delenv(admission.ENV, raising=False)
    yield
    admission.configure("")


class FakeClock:
    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# -- token bucket -------------------------------------------------------------


def test_token_bucket_burst_then_rate():
    clock = FakeClock()
    bucket = TokenBucket(rate=2.0, burst=4.0, clock=clock)
    assert [bucket.take() for _ in range(4)] == [True] * 4
    assert not bucket.take()  # burst exhausted, no time passed
    assert bucket.retry_after() > 0
    clock.advance(0.5)  # one token accrues at 2/s
    assert bucket.take()
    assert not bucket.take()


def test_token_bucket_closed_lane():
    clock = FakeClock()
    bucket = TokenBucket(rate=0.0, burst=10.0, clock=clock)
    assert not bucket.take()
    assert bucket.retry_after() == 1.0  # fixed hint, no division by zero
    clock.advance(1000.0)
    assert not bucket.take()  # closed stays closed regardless of time


def test_token_bucket_set_rate_settles_accrual_first():
    clock = FakeClock()
    bucket = TokenBucket(rate=10.0, burst=10.0, clock=clock)
    for _ in range(10):
        assert bucket.take()
    clock.advance(0.5)  # 5 tokens accrued at the OLD rate
    bucket.set_rate(1.0)
    taken = sum(1 for _ in range(10) if bucket.take())
    assert taken == 5  # old-rate accrual honored, new rate applies after


# -- lane spec parsing --------------------------------------------------------


def test_parse_lane_specs_full_and_fallbacks():
    specs = parse_lane_specs("high:100:20:40:300,batch:10,junk:x:y,high:1")
    by_name = {s.name: s for s in specs}
    assert by_name["high"] == LaneSpec("high", 100, 20.0, 40.0, 300)
    assert by_name["batch"].priority == 10
    # malformed numeric fields fall back instead of disabling admission
    assert by_name["junk"].priority == 0
    # duplicate lane names keep the first definition
    assert by_name["high"].priority == 100
    # the catch-all lane is auto-added at the lowest declared priority
    assert by_name["default"].priority == 0


def test_parse_lane_specs_keeps_explicit_default():
    specs = parse_lane_specs("high:100,default:50")
    by_name = {s.name: s for s in specs}
    assert by_name["default"].priority == 50
    assert len(specs) == 2


# -- brownout ladder ----------------------------------------------------------


def _specs():
    return parse_lane_specs("high:100,batch:10,low:0")


def _payload(p99=0.0, backlog=0.0, shard_up=None, conflicts=None):
    return {
        "slo": {"time_to_bind": {"high": {"n": 10, "p99": p99}}},
        "backlog_pods": backlog,
        "shard_up": shard_up if shard_up is not None else {"s0": True},
        "node_conflict_topk": conflicts or {},
    }


def test_ladder_escalates_lowest_tier_first_and_protects_top():
    ctl = BackpressureController(_specs(), slo_s=1.0, band=0.2)
    assert ctl.max_level == 4  # two rungs each for priorities 0 and 10
    hot = _payload(p99=5.0)
    for _ in range(2 * ctl.UP_TICKS):
        ctl.tick(hot, watch_age=0.0)
    assert ctl.level == 2
    assert ctl.factor_for(0) == admission.min_rate_factor()  # low: deferred
    assert ctl.factor_for(10) == 1.0                         # batch: untouched yet
    assert ctl.factor_for(100) == 1.0                        # protected
    for _ in range(2 * ctl.UP_TICKS):
        ctl.tick(hot, watch_age=0.0)
    assert ctl.level == 4
    assert ctl.factor_for(10) == admission.min_rate_factor()
    assert ctl.factor_for(100) == 1.0  # the top tier is never deferred
    # saturation: more pressure cannot push past max_level
    for _ in range(4):
        ctl.tick(hot, watch_age=0.0)
    assert ctl.level == 4


def test_ladder_recovery_needs_long_dwell_and_no_flap_in_band():
    ctl = BackpressureController(_specs(), slo_s=1.0, band=0.2)
    for _ in range(ctl.UP_TICKS):
        ctl.tick(_payload(p99=5.0), watch_age=0.0)
    assert ctl.level == 1
    # inside the hysteresis band: neither direction moves
    for _ in range(20):
        assert ctl.tick(_payload(p99=1.0), watch_age=0.0) == "steady"
    assert ctl.level == 1
    # below band: recovery only after DOWN_TICKS consecutive calm ticks
    for i in range(ctl.DOWN_TICKS - 1):
        assert ctl.tick(_payload(p99=0.1), watch_age=0.0) == "steady"
    assert ctl.level == 1
    assert ctl.tick(_payload(p99=0.1), watch_age=0.0) == "recover"
    assert ctl.level == 0


def test_dark_shard_blocks_recovery():
    ctl = BackpressureController(_specs(), slo_s=1.0, band=0.2)
    for _ in range(ctl.UP_TICKS):
        ctl.tick(_payload(p99=5.0), watch_age=0.0)
    assert ctl.level == 1
    dark = _payload(p99=0.1, shard_up={"s0": True, "s1": False})
    for _ in range(5 * ctl.DOWN_TICKS):
        assert ctl.tick(dark, watch_age=0.0) == "dark"
    assert ctl.level == 1  # silence is not health
    # the shard comes back: recovery resumes normally
    for _ in range(ctl.DOWN_TICKS):
        ctl.tick(_payload(p99=0.1), watch_age=0.0)
    assert ctl.level == 0


def test_pressure_is_worst_of_all_signals():
    ctl = BackpressureController(_specs(), slo_s=10.0, band=0.2,
                                 backlog_budget=100.0)
    ctl.tick(_payload(p99=1.0), watch_age=50.0)  # stale watch alone
    assert ctl.pressure == pytest.approx(5.0)
    ctl.tick(_payload(p99=1.0, conflicts={"n0": 500}), watch_age=0.0)
    assert ctl.pressure == pytest.approx(10.0)
    ctl.tick(_payload(p99=1.0, backlog=250.0), watch_age=0.0)
    assert ctl.pressure == pytest.approx(2.5)


def test_controller_fault_is_fail_static():
    gate = AdmissionGate(_specs(), clock=FakeClock(),
                         fleet_fn=lambda: _payload(p99=50.0),
                         age_fn=lambda: 0.0, slo_s=1.0, interval_s=0.0)
    clock = gate._clock
    for _ in range(gate.controller.UP_TICKS):
        clock.advance(1.0)
        gate.maybe_tick()
    level = gate.controller.level
    assert level >= 1
    factors = {n: l.factor for n, l in gate.lanes.items()}
    faults.registry.arm("admission.controller", count=3)
    for _ in range(3):
        clock.advance(1.0)
        gate.maybe_tick()
    assert gate.controller.last_outcome == "fault"
    assert gate.controller.level == level  # ladder frozen
    assert {n: l.factor for n, l in gate.lanes.items()} == factors


# -- the gate -----------------------------------------------------------------


def _quiet_gate(spec="high:100:5:5:3,low:0:5:5:3", **kwargs):
    clock = FakeClock()
    gate = AdmissionGate(
        parse_lane_specs(spec), clock=clock,
        fleet_fn=lambda: _payload(p99=0.0), age_fn=lambda: 0.0,
        slo_s=30.0, interval_s=1.0, **kwargs,
    )
    return gate, clock


def test_gate_admits_charges_and_credits_backlog():
    gate, _clock = _quiet_gate()
    for i in range(3):
        d = gate.decide("high", key=f"default/p{i}")
        assert d.admitted and d.reason == "admitted" and d.lane == "high"
    d = gate.decide("high", key="default/p3")
    assert not d.admitted and d.reason == "shed_backlog"
    assert d.retry_after_s > 0
    gate.note_done("default/p0")  # a bind credits the lane
    assert gate.decide("high", key="default/p4").admitted
    # double-credit of the same key is a no-op
    gate.note_done("default/p0")
    gate.note_done("default/p0")
    assert gate.lanes["high"].inflight == 3


def test_gate_rate_shed_carries_retry_after():
    gate, clock = _quiet_gate(spec="high:100:2:2:100")
    assert gate.decide("high").admitted
    assert gate.decide("high").admitted
    d = gate.decide("high")
    assert not d.admitted and d.reason == "shed_rate" and d.retry_after_s > 0
    clock.advance(1.0)  # 2/s refills two tokens
    assert gate.decide("high").admitted


def test_gate_unknown_queue_lands_in_default_lane():
    gate, _clock = _quiet_gate()
    d = gate.decide("no-such-queue", key="default/x")
    assert d.admitted and d.lane == "default"


def test_gate_brownout_defers_low_lane_only():
    clock = FakeClock()
    gate = AdmissionGate(
        parse_lane_specs("high:100:50:50:100,low:0:50:50:100"),
        clock=clock, fleet_fn=lambda: _payload(p99=500.0),
        age_fn=lambda: 0.0, slo_s=1.0, interval_s=1.0,
    )
    for _ in range(2 * gate.controller.UP_TICKS):
        clock.advance(1.0)
        gate.maybe_tick()
    assert gate.controller.level >= 2
    d = gate.decide("low")
    assert not d.admitted and d.reason == "shed_brownout"
    assert d.retry_after_s >= 1.0
    assert gate.decide("high").admitted  # protected lane still open


def test_gate_shed_fault_point():
    gate, _clock = _quiet_gate()
    faults.registry.arm("admission.shed", count=1)
    d = gate.decide("high", key="default/f0")
    assert not d.admitted and d.reason == "shed_fault" and d.retry_after_s > 0
    # the fault fired AFTER the bucket take but the admit was not charged
    assert gate.lanes["high"].inflight == 0
    assert gate.decide("high", key="default/f1").admitted


def test_configure_on_words_and_off_words(monkeypatch):
    monkeypatch.setenv(admission.ENV, "on")
    assert admission.configure()
    gate = admission.active()
    assert set(gate.lanes) == {"high", "batch", "default"}
    monkeypatch.setenv(admission.ENV, "off")
    assert not admission.configure()
    assert admission.debug_payload() == admission.NOOP_PAYLOAD


# -- the server front door ----------------------------------------------------


def _post(port: str, path: str, body: dict):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=5) as resp:
            return resp.status, dict(resp.headers), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def test_server_front_door_429_and_debug_endpoint(monkeypatch, tmp_path):
    monkeypatch.setenv(admission.ENV, "high:100:2:2:100,default:0:2:2:100")
    srv = SchedulerServer(
        scheduler_name="adm-test", listen_address="127.0.0.1:0",
        schedule_period=60.0, scheduler_conf=_cpu_conf(tmp_path),
    )
    srv.start()
    try:
        port = srv.listen_port
        codes = []
        for i in range(4):
            code, headers, body = _post(
                port, "/apis/v1alpha1/pods",
                {"name": f"adm-{i}", "requests": {"cpu": "1"}},
            )
            codes.append(code)
            if code == 429:
                payload = json.loads(body)
                assert payload["reason"] in ("shed_rate", "shed_backlog")
                assert payload["retry_after_s"] > 0
                assert int(headers["Retry-After"]) >= 1
        assert codes.count(201) == 2  # burst of 2 on the default lane
        assert codes.count(429) == 2
        status, _h, body = _post_get(port, "/debug/admission")
        assert status == 200
        payload = json.loads(body)
        assert payload["enabled"] is True
        lanes = payload["lanes"]
        assert lanes["default"]["admitted"] == 2
        assert lanes["default"]["shed"].get("shed_rate", 0) == 2
        assert lanes["default"]["inflight"] == 2
        # a deleted pending pod credits the lane backlog (note_done)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/apis/v1alpha1/pods/default/adm-0",
            method="DELETE",
        )
        with urllib.request.urlopen(req, timeout=5) as resp:
            assert resp.status == 200
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            _s, _h, body = _post_get(port, "/debug/admission")
            if json.loads(body)["lanes"]["default"]["inflight"] == 1:
                break
            time.sleep(0.05)
        else:
            raise AssertionError("pod delete never credited the lane")
    finally:
        srv.stop()


def _post_get(port: str, path: str):
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=5
        ) as resp:
            return resp.status, dict(resp.headers), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def test_server_without_admission_is_a_noop(monkeypatch, tmp_path):
    monkeypatch.delenv(admission.ENV, raising=False)
    srv = SchedulerServer(
        scheduler_name="adm-off", listen_address="127.0.0.1:0",
        schedule_period=60.0, scheduler_conf=_cpu_conf(tmp_path),
    )
    srv.start()
    try:
        port = srv.listen_port
        for i in range(10):
            code, _h, _b = _post(
                port, "/apis/v1alpha1/pods",
                {"name": f"free-{i}", "requests": {"cpu": "1"}},
            )
            assert code == 201
        status, _h, body = _post_get(port, "/debug/admission")
        assert status == 200
        assert json.loads(body) == {"enabled": False}
    finally:
        srv.stop()


# -- held against the JAX package ---------------------------------------------


@pytest.mark.parametrize("seed", [42, 7])
def test_smoke_dict_equals_the_jax_package(seed):
    """The fake-clock overload plant: the port's result dict on a seed is
    the JAX package's, key for key and count for count, and it passes."""
    from kube_batch_tpu import admission as jax_admission

    want = jax_admission.smoke(seed=seed)
    got = admission.smoke(seed=seed)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    if seed == 42:
        assert got["ok"], got


def test_gate_decisions_equal_the_jax_gate_on_a_fake_clock():
    """The same lane spec, signal payloads and arrival sequence through
    both packages' gates: every decision (lane, reason, retry hint) and
    the final snapshots are equal."""
    from kube_batch_tpu import admission as jax_admission

    def drive(mod):
        clock = FakeClock()
        gate = mod.AdmissionGate(
            mod.parse_lane_specs("high:100:5:5:10,batch:10:5:5:10,low:0:5:5:10"),
            clock=clock, fleet_fn=lambda: _payload(p99=2.5 if clock.t < 6 else 0.1),
            age_fn=lambda: 0.0, slo_s=1.0, band=0.2, interval_s=0.5,
        )
        out = []
        for i in range(400):
            clock.advance(0.05)
            lane = ("high", "batch", "low", "low")[i % 4]
            d = gate.decide(lane, key=f"default/p{i}")
            out.append((d.admitted, d.lane, d.reason, round(d.retry_after_s, 9)))
            if i % 3 == 0:
                gate.note_done(f"default/p{i - 6}")
        return out, gate.snapshot()

    assert drive(admission) == drive(jax_admission)


# -- the live storm (streaming federated shards behind the gate) --------------


def test_storm_with_admission_on_holds_its_invariants():
    """Two streaming federated shards on the CPU, a Poisson storm at about
    5x capacity through the workload POST: exactly-once binds, fsck clean,
    drained, every 429 with Retry-After, micro-cycles ran, the protected
    lane never shed and its p99 within the storm's bound."""
    result = admission.storm(shards=2, duration_s=4.0, admission_on=True, device="cpu")
    assert result["ok"], result
    assert sum(result["shed"].values()) > 0, result
    assert result["shed"]["high"] == 0


def test_storm_with_a_killed_shard_adopts_without_orphans():
    """The storm with one shard killed halfway: its slot is adopted (a
    measured MTTR), every bind lands once, and no journal intent is left
    orphaned."""
    result = admission.storm(shards=2, duration_s=4.0, admission_on=True, kill=True, device="cpu")
    assert result["ok"], result
    assert result["mttr_s"] is not None and result["journal_orphans"] == 0


def test_storm_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        admission.storm(duration_s=0.1)
