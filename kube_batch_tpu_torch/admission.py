"""Per-tenant admission lanes with fleet-SLO backpressure.

The workload-API front door (``POST /apis/v1alpha1/pods``) is the one
place overload can still be refused cheaply: once a pod is in the store
it holds watch bandwidth, mirror memory and scheduler cycles on every
shard. This module puts an admission control plane there:

- **Lanes** — every tenant queue maps to a lane with a token-bucket
  rate limit, a priority tier and a bounded backlog (admitted but not
  yet bound). Overflow is *rejected loudly* — HTTP 429 with a
  ``Retry-After`` hint — never silently dropped or queued unbounded.
- **Backpressure controller** — a hysteresis-banded feedback loop over
  *measured* fleet state: the merged ``fleet_slo_*`` p99 sketches,
  ``fleet_backlog_pods``, the node-conflict heatmap and
  ``watch_snapshot_age_seconds``. Under sustained pressure it walks a
  **brownout ladder**: lowest-priority lanes are halved, then deferred
  outright, tier by tier, so the protected (highest-priority) lane's
  p99 stays bounded while lower tiers degrade predictably. Recovery
  retraces the ladder with a wider hysteresis band and a longer dwell,
  so the controller does not flap around the set point.
- **Dark shards** — when the fleet aggregator reports a shard down
  (``fleet_shard_up=0``) the fleet signals are *incomplete*, so the
  controller holds its current brownout level (the conservative read:
  no recovery on partial data) instead of treating silence as health.

Configuration is environment-first (``KBT_ADMISSION`` holds the lane
spec; everything defaults sanely) so the drill rigs and the server wire
through the same switch. The gate and the controller are host code; the
storm's shards solve on the card. The module is also its own proof:
``python -m kube_batch_tpu_torch.admission`` runs a deterministic overload
plant on a fake clock (5x offered load; admission ON must keep the
protected lane's p99 bounded where OFF collapses), and ``--storm [--device
cpu]`` runs the live storm drill over a real federated streaming topology
whose shards' ``torch_allocate`` solves on ``device``.

Fault points (``KBT_FAULTS``): ``admission.shed`` sheds an admit that
would have passed (429 path under test), ``admission.controller`` kills
a controller tick (fail-static: last good outputs stay in force).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from kube_batch_tpu_torch import faults, metrics
from kube_batch_tpu_torch.obs import _OFF_WORDS
from kube_batch_tpu_torch.obs import fleet as obs_fleet

__all__ = [
    "ENV",
    "DEFAULT_SPEC",
    "TokenBucket",
    "LaneSpec",
    "Decision",
    "BackpressureController",
    "AdmissionGate",
    "parse_lane_specs",
    "configure",
    "enabled",
    "active",
    "decide",
    "note_done",
    "release",
    "publish",
    "debug_payload",
    "smoke",
    "storm",
    "main",
]

log = logging.getLogger(__name__)

ENV = "KBT_ADMISSION"
RATE_ENV = "KBT_ADMISSION_RATE"
BURST_ENV = "KBT_ADMISSION_BURST"
BACKLOG_ENV = "KBT_ADMISSION_BACKLOG"
SLO_ENV = "KBT_ADMISSION_P99_SLO_S"
BAND_ENV = "KBT_ADMISSION_BAND"
INTERVAL_ENV = "KBT_ADMISSION_INTERVAL_S"
MIN_RATE_ENV = "KBT_ADMISSION_MIN_RATE"

# Bare on-words ("1", "on", ...) arm this default lane map: a protected
# high tier, a deferrable batch tier, and the catch-all "default" lane
# (every queue without its own lane lands there) as the first brownout
# victim.
DEFAULT_SPEC = "high:100,batch:10,default:0"


def _env_float(name: str, default: float, floor: Optional[float] = None) -> float:
    try:
        value = float(os.environ.get(name, "") or default)
    except ValueError:
        value = default
    if floor is not None:
        value = max(floor, value)
    return value


def default_rate() -> float:
    """Per-lane steady-state admit rate (pods/s) when the lane spec
    does not pin one."""
    return _env_float(RATE_ENV, 50.0, floor=0.1)


def default_burst() -> float:
    """Per-lane burst allowance (bucket depth); defaults to one
    second's worth of the lane rate."""
    return _env_float(BURST_ENV, 0.0, floor=0.0)


def default_backlog() -> int:
    """Per-lane cap on admitted-but-not-yet-bound pods."""
    return int(_env_float(BACKLOG_ENV, 200.0, floor=1.0))


def p99_slo_s() -> float:
    """The protected-lane time-to-bind p99 objective the controller
    steers to."""
    return _env_float(SLO_ENV, 30.0, floor=0.1)


def hysteresis_band() -> float:
    """Dead band around pressure 1.0: escalate above ``1 + band``,
    recover below ``1 - band``, hold in between."""
    return min(0.9, _env_float(BAND_ENV, 0.2, floor=0.01))


def controller_interval_s() -> float:
    """Seconds between controller ticks."""
    return _env_float(INTERVAL_ENV, 1.0, floor=0.05)


def min_rate_factor() -> float:
    """Rate factor of a fully deferred (browned-out) lane; 0 closes the
    lane entirely until recovery."""
    return max(0.0, min(1.0, _env_float(MIN_RATE_ENV, 0.0, floor=0.0)))


# -- token bucket -------------------------------------------------------------


class TokenBucket:
    """Classic token bucket with an injectable clock (the drills run on
    a fake clock). ``rate <= 0`` means closed: takes fail with a fixed
    retry hint instead of a division."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self._clock = clock
        self._tokens = self.burst
        self._stamp = clock()

    def _refill(self) -> None:
        now = self._clock()
        if self.rate > 0 and now > self._stamp:
            self._tokens = min(self.burst, self._tokens + (now - self._stamp) * self.rate)
        self._stamp = now

    def set_rate(self, rate: float) -> None:
        self._refill()  # settle accrual at the old rate first
        self.rate = float(rate)

    def take(self, n: float = 1.0) -> bool:
        self._refill()
        if self.rate <= 0:
            return False
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def retry_after(self) -> float:
        """Seconds until a take would plausibly succeed — the 429
        ``Retry-After`` hint. Always > 0 on the shed path."""
        if self.rate <= 0:
            return 1.0
        self._refill()
        return max(0.05, (1.0 - self._tokens) / self.rate)


# -- lanes --------------------------------------------------------------------


@dataclass(frozen=True)
class LaneSpec:
    name: str
    priority: int = 0
    rate: float = 0.0       # 0 -> default_rate()
    burst: float = 0.0      # 0 -> max(rate, default_burst())
    backlog: int = 0        # 0 -> default_backlog()


def parse_lane_specs(raw: str) -> list[LaneSpec]:
    """Parse the ``KBT_ADMISSION`` lane spec: comma-separated
    ``name:priority[:rate[:burst[:backlog]]]`` entries. Malformed
    fields fall back to defaults rather than disabling admission."""
    specs: list[LaneSpec] = []
    seen: set[str] = set()
    for chunk in raw.split(","):
        chunk = chunk.strip()
        if not chunk:
            continue
        parts = chunk.split(":")
        name = parts[0].strip()
        if not name or name in seen:
            continue
        seen.add(name)

        def _num(i: int, cast, default):
            try:
                return cast(parts[i])
            except (IndexError, ValueError):
                return default

        specs.append(LaneSpec(
            name=name,
            priority=_num(1, int, 0),
            rate=_num(2, float, 0.0),
            burst=_num(3, float, 0.0),
            backlog=_num(4, int, 0),
        ))
    if specs and not any(s.name == "default" for s in specs):
        lowest = min(s.priority for s in specs)
        specs.append(LaneSpec(name="default", priority=lowest))
    return specs


class _Lane:
    """Runtime state behind a LaneSpec: the bucket, the in-flight count
    (admitted, not yet bound) and the controller-assigned rate factor."""

    def __init__(self, spec: LaneSpec, clock: Callable[[], float]) -> None:
        self.spec = spec
        self.rate = spec.rate if spec.rate > 0 else default_rate()
        self.burst = spec.burst if spec.burst > 0 else max(self.rate, default_burst())
        self.backlog_limit = spec.backlog if spec.backlog > 0 else default_backlog()
        self.bucket = TokenBucket(self.rate, self.burst, clock)
        self.factor = 1.0
        self.inflight = 0
        self.admitted = 0
        self.shed: dict[str, int] = {}

    def apply_factor(self, factor: float) -> None:
        if factor != self.factor:
            self.factor = factor
            self.bucket.set_rate(self.rate * factor)

    def snapshot(self) -> dict:
        return {
            "priority": self.spec.priority,
            "rate": self.rate,
            "burst": self.burst,
            "backlog_limit": self.backlog_limit,
            "factor": self.factor,
            "inflight": self.inflight,
            "admitted": self.admitted,
            "shed": dict(self.shed),
        }


@dataclass(frozen=True)
class Decision:
    admitted: bool
    lane: str
    reason: str                 # admitted | shed_rate | shed_backlog | shed_brownout | shed_fault
    retry_after_s: float = 0.0  # > 0 on every shed


# -- backpressure controller --------------------------------------------------


class BackpressureController:
    """Hysteresis-banded brownout ladder over measured fleet state.

    Pressure is the worst of four normalized signals — protected-lane
    p99 / SLO, fleet backlog / aggregate lane backlog budget, watch
    snapshot age / 10s, and the node-conflict heatmap mass / 50 — so
    any one saturating subsystem is enough to start shedding load.

    The ladder has two rungs per deferrable priority tier, lowest tier
    first: *half* the tier's admit rate, then *defer* it outright
    (``min_rate_factor``). The top tier is never deferred — protecting
    its p99 is the controller's whole objective. Escalation needs
    ``UP_TICKS`` consecutive above-band ticks; recovery needs
    ``DOWN_TICKS`` below-band ticks (and no dark shard), so transient
    spikes move the ladder at most one rung and the loop cannot flap.
    """

    UP_TICKS = 2
    DOWN_TICKS = 6

    def __init__(self, specs: list[LaneSpec], slo_s: Optional[float] = None,
                 band: Optional[float] = None,
                 backlog_budget: Optional[float] = None) -> None:
        self.slo_s = slo_s if slo_s is not None else p99_slo_s()
        self.band = band if band is not None else hysteresis_band()
        tiers = sorted({s.priority for s in specs}) or [0]
        self._tiers = tiers
        self._deferrable = tiers[:-1]  # top tier is untouchable
        self.max_level = 2 * len(self._deferrable)
        by_priority = sorted(specs, key=lambda s: -s.priority)
        self.protected_queue = by_priority[0].name if by_priority else ""
        self.backlog_budget = backlog_budget or 1.0
        self.level = 0
        self.pressure = 0.0
        self.dark = False
        self.ticks = 0
        self.last_outcome = "steady"
        self._above = 0
        self._below = 0

    def factor_for(self, priority: int) -> float:
        if priority not in self._deferrable:
            return 1.0
        # rung math: each deferrable tier owns two rungs, lowest first
        steps = self.level - 2 * self._deferrable.index(priority)
        if steps >= 2:
            return min_rate_factor()
        if steps == 1:
            return 0.5
        return 1.0

    def _read_pressure(self, payload: dict, watch_age: float,
                       inflight_total: int) -> tuple[float, bool]:
        slo = payload.get("slo") or {}
        ttb = slo.get("time_to_bind") or {}
        stats = ttb.get(self.protected_queue)
        if stats is None and ttb:
            p99 = max(float(s.get("p99") or 0.0) for s in ttb.values())
        else:
            p99 = float((stats or {}).get("p99") or 0.0)
        backlog = max(float(payload.get("backlog_pods") or 0.0),
                      float(inflight_total))
        conflicts = sum((payload.get("node_conflict_topk") or {}).values())
        pressure = max(
            p99 / self.slo_s,
            backlog / max(1.0, self.backlog_budget),
            max(0.0, watch_age) / 10.0,
            float(conflicts) / 50.0,
        )
        shard_up = payload.get("shard_up") or {}
        dark = bool(shard_up) and not all(shard_up.values())
        return pressure, dark

    def tick(self, payload: dict, watch_age: float,
             inflight_total: int = 0) -> str:
        """One control step. Returns the tick outcome (also counted in
        ``admission_controller_ticks``)."""
        self.ticks += 1
        if faults.should_fire("admission.controller"):
            # fail-static: a dead controller must not move the ladder —
            # the last good per-lane factors stay in force
            self.last_outcome = "fault"
            return "fault"
        pressure, dark = self._read_pressure(payload, watch_age, inflight_total)
        self.pressure = pressure
        self.dark = dark
        outcome = "steady"
        if pressure > 1.0 + self.band:
            self._above += 1
            self._below = 0
            if self._above >= self.UP_TICKS and self.level < self.max_level:
                self.level += 1
                self._above = 0
                outcome = "escalate"
        elif pressure < 1.0 - self.band:
            self._above = 0
            if dark:
                # incomplete fleet data: hold the line, don't recover
                self._below = 0
                outcome = "dark"
            else:
                self._below += 1
                if self._below >= self.DOWN_TICKS and self.level > 0:
                    self.level -= 1
                    self._below = 0
                    outcome = "recover"
        else:
            self._above = 0
            self._below = 0
            if dark:
                outcome = "dark"
        self.last_outcome = outcome
        return outcome

    def snapshot(self) -> dict:
        return {
            "level": self.level,
            "max_level": self.max_level,
            "pressure": round(self.pressure, 4),
            "dark": self.dark,
            "ticks": self.ticks,
            "last_outcome": self.last_outcome,
            "protected_queue": self.protected_queue,
            "slo_s": self.slo_s,
            "band": self.band,
        }


# -- the gate -----------------------------------------------------------------


class AdmissionGate:
    """The front-door decision point. One lock guards lanes and the
    controller; ``decide`` is called on HTTP handler threads."""

    def __init__(self, specs: list[LaneSpec],
                 clock: Callable[[], float] = time.monotonic,
                 fleet_fn: Optional[Callable[[], dict]] = None,
                 age_fn: Optional[Callable[[], float]] = None,
                 slo_s: Optional[float] = None,
                 band: Optional[float] = None,
                 interval_s: Optional[float] = None) -> None:
        if not specs:
            raise ValueError("admission gate needs at least one lane")
        self._clock = clock
        self._lock = threading.RLock()
        self.lanes: dict[str, _Lane] = {
            s.name: _Lane(s, clock) for s in specs
        }
        if "default" not in self.lanes:
            self.lanes["default"] = _Lane(
                LaneSpec("default", min(s.priority for s in specs)), clock
            )
        self.controller = BackpressureController(
            [lane.spec for lane in self.lanes.values()],
            slo_s=slo_s, band=band,
            backlog_budget=sum(l.backlog_limit for l in self.lanes.values()),
        )
        self.interval_s = interval_s if interval_s is not None else controller_interval_s()
        self._fleet_fn = fleet_fn if fleet_fn is not None else obs_fleet.refresh
        self._age_fn = (
            age_fn if age_fn is not None
            else (lambda: metrics.watch_snapshot_age.value())
        )
        self._last_tick = clock()  #: guarded_by _lock
        self._inflight_keys: dict[str, str] = {}  #: guarded_by _lock

    # -- controller plumbing --------------------------------------------------

    def maybe_tick(self) -> None:
        with self._lock:
            now = self._clock()
            if now - self._last_tick < self.interval_s:
                return
            self._last_tick = now
            try:
                payload = self._fleet_fn() or {}
            except Exception as e:  # a broken signal source is not an outage
                log.error("admission: fleet signal source failed: %s", e)
                payload = {}
            try:
                age = float(self._age_fn())
            except Exception:
                age = 0.0
            inflight = sum(l.inflight for l in self.lanes.values())
            outcome = self.controller.tick(payload, age, inflight)
            if outcome != "fault":
                for lane in self.lanes.values():
                    lane.apply_factor(self.controller.factor_for(lane.spec.priority))
            metrics.register_admission_controller_tick(outcome)
            metrics.set_admission_brownout_level(self.controller.level)
            metrics.set_admission_pressure(self.controller.pressure)
            for name, lane in self.lanes.items():
                metrics.set_admission_lane_rate(name, lane.rate * lane.factor)
                metrics.set_admission_lane_backlog(name, lane.inflight)

    # -- the decision ---------------------------------------------------------

    def lane_for(self, queue: str) -> _Lane:
        return self.lanes.get(queue) or self.lanes["default"]

    def decide(self, queue: str, key: Optional[str] = None) -> Decision:
        self.maybe_tick()
        with self._lock:
            lane = self.lane_for(queue)
            name = lane.spec.name
            deferred = (
                lane.spec.priority in self.controller._deferrable
                and lane.factor <= min_rate_factor()
            )
            if deferred:
                decision = Decision(False, name, "shed_brownout",
                                    max(1.0, 2 * self.interval_s))
            elif lane.inflight >= lane.backlog_limit:
                decision = Decision(False, name, "shed_backlog",
                                    max(0.5, lane.bucket.retry_after()))
            elif not lane.bucket.take():
                decision = Decision(False, name, "shed_rate",
                                    lane.bucket.retry_after())
            elif faults.should_fire("admission.shed"):
                decision = Decision(False, name, "shed_fault", 1.0)
            else:
                lane.inflight += 1
                lane.admitted += 1
                if key:
                    self._inflight_keys[key] = name
                decision = Decision(True, name, "admitted")
            if not decision.admitted:
                lane.shed[decision.reason] = lane.shed.get(decision.reason, 0) + 1
        metrics.register_admission_decision(name, decision.reason)
        return decision

    def note_done(self, key: str) -> None:
        """Credit a lane when an admitted pod binds (or is deleted while
        pending) — the backlog bound tracks admitted-but-not-yet-bound."""
        with self._lock:
            name = self._inflight_keys.pop(key, None)
            if name is None:
                return
            lane = self.lanes.get(name)
            if lane is not None and lane.inflight > 0:
                lane.inflight -= 1

    def release(self, key: str) -> None:
        """Roll back an admit whose create failed downstream."""
        self.note_done(key)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "interval_s": self.interval_s,
                "lanes": {n: l.snapshot() for n, l in self.lanes.items()},
                "controller": self.controller.snapshot(),
            }


# -- module state (the server's switch) ---------------------------------------


_gate: Optional[AdmissionGate] = None
NOOP_PAYLOAD: dict = {"enabled": False}


def enabled() -> bool:
    return _gate is not None


def active() -> Optional[AdmissionGate]:
    return _gate


def configure(spec=None) -> bool:
    """(Re)resolve the admission switch from ``KBT_ADMISSION`` (or an
    explicit spec string). On-words arm ``DEFAULT_SPEC``; anything with
    a colon is a lane spec; off-words/empty disable. Mirrors
    obs_fleet.configure so the server arms both the same way."""
    global _gate
    raw = (os.environ.get(ENV, "") if spec is None else str(spec)).strip()
    if not raw or raw.lower() in _OFF_WORDS:
        if _gate is not None:
            log.info("admission control disabled")
        _gate = None
        return False
    if ":" not in raw:
        raw = DEFAULT_SPEC
    specs = parse_lane_specs(raw)
    if not specs:
        _gate = None
        return False
    _gate = AdmissionGate(specs)
    log.info(
        "admission control enabled: %d lanes (%s), brownout ladder %d rungs",
        len(_gate.lanes), ", ".join(sorted(_gate.lanes)),
        _gate.controller.max_level,
    )
    return True


def decide(queue: str, key: Optional[str] = None) -> Optional[Decision]:
    """Front-door hook: None when admission is off (admit everything)."""
    gate = _gate
    if gate is None:
        return None
    return gate.decide(queue, key)


def note_done(key: str) -> None:
    gate = _gate
    if gate is not None:
        gate.note_done(key)


def release(key: str) -> None:
    gate = _gate
    if gate is not None:
        gate.release(key)


def publish() -> None:
    """Refresh the admission gauges (the /metrics scrape path)."""
    gate = _gate
    if gate is not None:
        gate.maybe_tick()


def debug_payload() -> dict:
    """The ``/debug/admission`` body."""
    gate = _gate
    if gate is None:
        return NOOP_PAYLOAD
    return gate.snapshot()


# -- smoke: deterministic overload plant --------------------------------------


SMOKE_SPEC = (
    "high:100:40:40:200,batch:10:40:40:200,low:0:40:40:200"
)


def smoke(duration_s: float = 40.0, seed: int = 42) -> dict:
    """Deterministic admission proof (``python -m
    kube_batch_tpu_torch.admission``): no device, a fake clock.

    A fake-clock FIFO plant serves 40 pods/s; three tenants offer 200
    pods/s total (5x capacity): ``high`` 20/s, ``batch`` 60/s, ``low``
    120/s. The plant has *no* internal priority — whatever gets in
    queues FIFO — so any protection the high tenant enjoys must come
    from the admission plane. Run twice on the same seed:

    - **admission ON**: the controller walks the brownout ladder until
      inflow fits capacity. Asserts the high lane is never shed, the
      low lane is, the served p99 settles within a small multiple of
      the SLO, the ladder does not flap in the settled tail, every shed
      carried a positive Retry-After, and the controller actually
      ticked.
    - **admission OFF**: the same offered load admitted wholesale must
      measurably collapse (served p99 many times the SLO) — the
      controller has to be *why* the ON run stays bounded.
    """
    import random

    slo_s = 2.0
    capacity = 40.0
    dt = 0.02
    offered = (("high", 20.0), ("batch", 60.0), ("low", 120.0))

    def run(admission_on: bool) -> dict:
        rng = random.Random(seed)
        clock = [0.0]
        specs = parse_lane_specs(SMOKE_SPEC)
        fleet_state: dict = {"payload": {"enabled": False}}
        gate = AdmissionGate(
            specs,
            clock=lambda: clock[0],
            fleet_fn=lambda: fleet_state["payload"],
            age_fn=lambda: 0.0,
            slo_s=slo_s, band=0.2, interval_s=0.5,
        ) if admission_on else None
        # per-lane next-arrival times (independent Poisson processes)
        next_at = {name: rng.expovariate(rate) for name, rate in offered}
        queue: list[tuple[str, float, str]] = []  # (key, admit_time, lane)
        served: list[tuple[float, float, str]] = []  # (done_time, latency, lane)
        budget = 0.0
        counts = {name: {"offered": 0, "admitted": 0, "shed": 0}
                  for name, _ in offered}
        min_retry = None
        levels: list[tuple[float, int]] = []
        seq = 0
        steps = int(duration_s / dt)
        for _ in range(steps):
            clock[0] += dt
            now = clock[0]
            # arrivals
            for name, rate in offered:
                while next_at[name] <= now:
                    next_at[name] += rng.expovariate(rate)
                    seq += 1
                    key = f"{name}-{seq}"
                    counts[name]["offered"] += 1
                    if gate is None:
                        queue.append((key, now, name))
                        continue
                    decision = gate.decide(name, key)
                    if decision.admitted:
                        counts[name]["admitted"] += 1
                        queue.append((key, now, name))
                    else:
                        counts[name]["shed"] += 1
                        retry = decision.retry_after_s
                        min_retry = retry if min_retry is None else min(min_retry, retry)
            # FIFO service at fixed capacity
            budget += capacity * dt
            while budget >= 1.0 and queue:
                budget -= 1.0
                key, t0, name = queue.pop(0)
                served.append((now, now - t0, name))
                if gate is not None:
                    gate.note_done(key)
            if gate is not None:
                # the plant *is* the fleet: synthesize the merged payload
                window = [s for s in served if now - s[0] <= 5.0]
                lats = sorted(s[1] for s in window)
                p99 = lats[max(0, int(len(lats) * 0.99) - 1)] if lats else 0.0
                fleet_state["payload"] = {
                    "enabled": True,
                    "slo": {"time_to_bind": {"high": {"n": len(lats), "p99": p99}}},
                    "backlog_pods": 0.0,  # inflight feeds the backlog term
                    "shard_up": {"s0": True},
                    "node_conflict_topk": {},
                }
                gate.maybe_tick()
                if not levels or levels[-1][1] != gate.controller.level:
                    levels.append((now, gate.controller.level))
        tail_start = duration_s * 2.0 / 3.0
        tail = [lat for done, lat, _ in served if done >= tail_start]
        tail.sort()
        tail_p99 = tail[max(0, int(len(tail) * 0.99) - 1)] if tail else 0.0
        return {
            "counts": counts,
            "tail_p99_s": round(tail_p99, 3),
            "queue_final": len(queue),
            "min_retry_after_s": min_retry,
            "level_changes_tail": sum(1 for t, _ in levels if t >= tail_start),
            "level_final": levels[-1][1] if levels else 0,
            "ticks": gate.controller.ticks if gate else 0,
            "served": len(served),
        }

    on = run(True)
    off = run(False)
    ok = bool(
        on["ticks"] > 0
        and on["counts"]["high"]["shed"] == 0
        and on["counts"]["high"]["admitted"] == on["counts"]["high"]["offered"]
        and on["counts"]["low"]["shed"] > 0
        and (on["min_retry_after_s"] or 0) > 0
        and on["tail_p99_s"] <= slo_s * 3.0
        and on["level_changes_tail"] <= 4
        and off["tail_p99_s"] >= slo_s * 5.0
        and off["tail_p99_s"] > 3.0 * max(on["tail_p99_s"], 0.001)
    )
    return {
        "ok": ok,
        "slo_s": slo_s,
        "offered_pods_per_s": sum(rate for _, rate in offered),
        "capacity_pods_per_s": capacity,
        "on": on,
        "off": off,
    }


# -- storm: live overload drill over a federated streaming topology ----------


STORM_SPEC = "high:100:12:12:120,batch:10:10:10:120,low:0:10:10:120"


def storm(
    shards: int = 2,
    nodes: int = 4,
    duration_s: float = 8.0,
    kill: bool = False,
    admission_on: bool = True,
    seed: int = 7,
    device: str = "cuda",
) -> dict:
    """Live storm cell: N streaming federated shards over one store
    server, an open-loop Poisson arrival storm at ~5x service capacity
    POSTing through the real workload API (admission gate in the door),
    a reaper recycling bound pods (sustained throughput), node churn,
    and optionally a SIGKILL'd shard mid-storm (leased slots + survivor
    adoption + MTTR, exactly-once, fsck-clean, zero journal orphans).

    Invariant-gated: throughput/latency numbers are measured output;
    ``ok`` only checks correctness invariants plus the
    protected lane's p99 bound when admission is ON. The shards'
    ``torch_allocate`` solves on ``device`` (streaming.smoke_conf), each
    shard a scheduling thread of this process.
    """
    import json as _json
    import random
    import tempfile
    import urllib.request

    from kube_batch_tpu_torch.apis.types import GROUP_NAME_ANNOTATION_KEY
    from kube_batch_tpu_torch.cache import EventHandler, LoopbackBackend
    from kube_batch_tpu_torch.cache.store import PODS, POD_GROUPS
    from kube_batch_tpu_torch.federation import (
        FederatedCache, ShardSlotManager, fsck, shard_index,
        shard_journal_path, shard_key_of,
    )
    from kube_batch_tpu_torch.recovery import WriteIntentJournal
    from kube_batch_tpu_torch.obs import QuantileSketch
    from kube_batch_tpu_torch.ops import encode_cache
    from kube_batch_tpu_torch.scheduler import Scheduler
    from kube_batch_tpu_torch.server import SchedulerServer
    from kube_batch_tpu_torch.streaming import _check_device, _loop_device, smoke_conf
    from kube_batch_tpu_torch.testing import build_node, build_queue, build_resource_list

    _check_device(device)
    loop_device = _loop_device(device)

    lane_rates = (("high", 6.0), ("batch", 14.0), ("low", 20.0))
    run_s = 0.8           # bound-pod dwell before the reaper recycles it
    saved_env = {k: os.environ.get(k) for k in
                 (ENV, SLO_ENV, INTERVAL_ENV, BAND_ENV)}
    os.environ[SLO_ENV] = "2.0"
    os.environ[INTERVAL_ENV] = "0.5"
    os.environ[BAND_ENV] = "0.2"
    if admission_on:
        os.environ[ENV] = STORM_SPEC
    else:
        os.environ.pop(ENV, None)
    tmpdir = tempfile.mkdtemp(prefix="kbt-storm-")
    with tempfile.NamedTemporaryFile(
        "w", suffix=".yaml", prefix="kbt-storm-", delete=False
    ) as fh:
        fh.write(smoke_conf(True, device))
        conf_path = fh.name
    with tempfile.NamedTemporaryFile(
        "w", suffix=".yaml", prefix="kbt-storm-store-", delete=False
    ) as fh:
        # the store process's own loop is idle (unmatched scheduler name)
        # and periodic, so it holds no store listener of its own
        fh.write(smoke_conf(False, device))
        store_conf_path = fh.name

    server = SchedulerServer(
        scheduler_name="store-arbiter", listen_address="127.0.0.1:0",
        scheduler_conf=store_conf_path, schedule_period=60.0,
    )
    server.start()
    store = server.store
    for lane, _ in lane_rates:
        store.create_queue(build_queue(lane))
    for i in range(nodes):
        store.create_node(
            build_node(f"n{i}", build_resource_list(cpu=4, memory="8Gi", pods=16))
        )
    base = f"http://127.0.0.1:{server.listen_port}"

    bind_counts: dict[str, int] = {}
    latencies: dict[str, list[float]] = {lane: [] for lane, _ in lane_rates}
    bind_times: dict[str, float] = {}
    create_times: dict[str, float] = {}
    pod_lane: dict[str, str] = {}
    sketches = [QuantileSketch() for _ in range(shards)]
    state_lock = threading.Lock()
    t_kill = [None]
    first_victim_bind = [None]
    victim_slot = [0]
    binds_total = [0]

    def _on_bind(old, new) -> None:
        if old.node_name or not new.node_name:
            return
        key = f"{new.namespace}/{new.name}"
        now = time.monotonic()
        with state_lock:
            bind_counts[key] = bind_counts.get(key, 0) + 1
            binds_total[0] += 1
            bind_times[key] = now
            t0 = create_times.get(key)
            lane = pod_lane.get(key)
            if t0 is not None and lane is not None:
                latencies[lane].append(now - t0)
                slot = shard_index(shard_key_of(new, store, "gang"), shards)
                sketches[slot].add(now - t0)
                if (t_kill[0] is not None and slot == victim_slot[0]
                        and first_victim_bind[0] is None):
                    first_victim_bind[0] = now

    store.add_event_handler(PODS, EventHandler(on_update=_on_bind))
    listeners_before = encode_cache.listener_count()

    backends: list[LoopbackBackend] = []
    scheds: list[Scheduler] = []
    threads: list[threading.Thread] = []
    stops: list[threading.Event] = []
    mgrs: list = []
    stop_all = threading.Event()
    stop_reap = threading.Event()  # reaper outlives the load: it frees
    # capacity during the drain, so bound pods don't pin the cluster full
    counts = {lane: {"offered": 0, "admitted": 0, "shed": 0}
              for lane, _ in lane_rates}
    retry_ok = [True]
    seq = [0]

    def _post(path: str, body: dict) -> tuple[int, dict]:
        req = urllib.request.Request(
            base + path, data=_json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=5.0) as resp:
                return resp.status, dict(resp.headers)
        except urllib.error.HTTPError as e:
            headers = dict(e.headers)
            e.close()
            return e.code, headers

    def _arrivals() -> None:
        rng = random.Random(seed)
        total = sum(r for _, r in lane_rates)
        weights = [r / total for _, r in lane_rates]
        names = [lane for lane, _ in lane_rates]
        next_at = time.monotonic() + rng.expovariate(total)
        deadline = time.monotonic() + duration_s
        while not stop_all.is_set() and time.monotonic() < deadline:
            now = time.monotonic()
            if now < next_at:
                time.sleep(min(0.005, next_at - now))
                continue
            next_at += rng.expovariate(total)
            lane = rng.choices(names, weights=weights)[0]
            seq[0] += 1
            name = f"st-{lane}-{seq[0]}"
            counts[lane]["offered"] += 1
            code, _ = _post(
                "/apis/v1alpha1/podgroups",
                {"name": name, "queue": lane, "min_member": 1},
            )
            if code != 201:
                continue
            key = f"default/{name}-0"
            with state_lock:
                create_times[key] = time.monotonic()
                pod_lane[key] = lane
            code, headers = _post(
                "/apis/v1alpha1/pods",
                {"name": f"{name}-0", "group": name,
                 "scheduler_name": "kube-batch-tpu",
                 "requests": {"cpu": "1", "memory": "512Mi"}},
            )
            if code == 201:
                counts[lane]["admitted"] += 1
            else:
                counts[lane]["shed"] += 1
                with state_lock:
                    create_times.pop(key, None)
                    pod_lane.pop(key, None)
                try:
                    if float(headers.get("Retry-After", "0")) <= 0:
                        retry_ok[0] = False
                except ValueError:
                    retry_ok[0] = False

    def _reaper() -> None:
        while not stop_reap.is_set():
            now = time.monotonic()
            with state_lock:
                ripe = [k for k, t in bind_times.items() if now - t >= run_s]
                for k in ripe:
                    bind_times.pop(k, None)
            for k in ripe:
                ns, name = k.split("/", 1)
                group = name.rsplit("-", 1)[0]
                try:
                    # Pods only: deleting the group races the shard
                    # schedulers' podgroup phase writes (update-of-deleted
                    # maps to HTTP 400 and aborts the whole cycle), and an
                    # empty min_member=1 group is inert for the drill.
                    store.delete(PODS, k)
                except Exception:
                    pass
            stop_reap.wait(0.1)

    def _churn() -> None:
        present = [False]
        while not stop_all.is_set():
            stop_all.wait(1.0)
            try:
                if present[0]:
                    if not any(p.node_name == "churn-n"
                               for p in store.list(PODS)):
                        store.delete_node("churn-n")
                        present[0] = False
                else:
                    store.create_node(build_node(
                        "churn-n", build_resource_list(cpu=4, memory="8Gi", pods=16)
                    ))
                    present[0] = True
            except Exception:
                pass

    result: dict = {}
    journals: list = []
    sched_threads: list[threading.Thread] = []
    victim = 0 if kill else None
    try:
        for i in range(shards):
            backend = LoopbackBackend(base)
            journal = None
            if kill:
                journal = WriteIntentJournal(shard_journal_path(tmpdir, i))
                journals.append(journal)
            cache = FederatedCache(
                backend, shard=i, shards=shards, shard_key="gang",
                staleness_fn=backend.snapshot_age, journal=journal,
            )
            cache.run()
            backend.start(period=0.02)
            backends.append(backend)
            sched = Scheduler(
                cache, scheduler_conf=conf_path, schedule_period=1.0,
            )
            scheds.append(sched)
            stop_i = threading.Event()
            stops.append(stop_i)
            if kill:
                mgr = ShardSlotManager(
                    backend, cache, identity=f"storm-{i}", lease_s=1.0,
                    renew_s=0.25, adopt=True, journal_dir=tmpdir,
                    grace_s=5.0, rebalance=0,
                    on_owned_change=(
                        lambda a, r, s=sched: s.on_owned_slots_changed(a, r)
                    ),
                )
                if not mgr.start(deadline_s=10.0):
                    raise RuntimeError(f"shard {i} never acquired its slot")
                mgrs.append(mgr)
            t = threading.Thread(
                target=sched.run, args=(stop_i, loop_device), name=f"kb-storm-{i}",
                daemon=True,
            )
            t.start()
            sched_threads.append(t)

        for fn, name in ((_arrivals, "kb-storm-arrivals"),
                         (_reaper, "kb-storm-reaper"),
                         (_churn, "kb-storm-churn")):
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            threads.append(t)

        if kill:
            time.sleep(duration_s / 2.0)
            victim_slot[0] = victim
            # the "SIGKILL": stop the victim's scheduler and stop
            # renewing WITHOUT releasing — the lease must expire
            stops[victim].set()
            sched_threads[victim].join(timeout=10.0)
            with state_lock:
                t_kill[0] = time.monotonic()
            mgrs[victim].kill()
        deadline = time.monotonic() + duration_s + 1.0
        while time.monotonic() < deadline and not stop_all.is_set():
            time.sleep(0.1)
        stop_all.set()
        # drain: let admitted work finish binding before teardown
        drain_deadline = time.monotonic() + 25.0
        while time.monotonic() < drain_deadline:
            pending = [
                p for p in store.list(PODS)
                if not p.node_name and f"{p.namespace}/{p.name}" in pod_lane
            ]
            if not pending:
                break
            time.sleep(0.1)
        stuck = []
        for p in store.list(PODS):
            key = f"{p.namespace}/{p.name}"
            if p.node_name or key not in pod_lane:
                continue
            group = p.metadata.annotations.get(GROUP_NAME_ANNOTATION_KEY, "")
            pg = store.get(POD_GROUPS, f"{p.namespace}/{group}") if group else None
            stuck.append(
                f"{key} group={group or '-'} "
                f"pg={'missing' if pg is None else pg.status.phase}"
            )
        drained = not stuck
    finally:
        stop_all.set()
        stop_reap.set()
        for stop_i in stops:
            stop_i.set()
        for i, mgr in enumerate(mgrs):
            if victim is not None and i == victim:
                continue  # already killed; its lease expired
            try:
                mgr.stop(release=True)
            except Exception:
                pass
        for t in threads + sched_threads:
            t.join(timeout=10.0)
        for backend in backends:
            backend.stop()
        for sched in scheds:
            sched.cache.stop()
        for journal in journals:
            try:
                journal.close()
            except Exception:
                pass

    violations = fsck(store)
    with state_lock:
        dup_binds = {k: c for k, c in bind_counts.items() if c != 1}
        lane_p99 = {}
        for lane, lat in latencies.items():
            lat = sorted(lat)
            lane_p99[lane] = (
                round(lat[max(0, int(len(lat) * 0.99) - 1)], 3) if lat else None
            )
        bound = binds_total[0]
    merged = QuantileSketch()
    for sk in sketches:
        merged.merge(sk)
    cluster_p99 = round(merged.quantile(0.99), 3) if merged.count() else None
    mttr = None
    if kill and t_kill[0] is not None and first_victim_bind[0] is not None:
        mttr = round(first_victim_bind[0] - t_kill[0], 3)
    orphans = 0
    if kill:
        for i in range(shards):
            path = shard_journal_path(tmpdir, i)
            if os.path.exists(path):
                orphans += len(WriteIntentJournal.replay(path).orphans)
    gate_snapshot = debug_payload()
    server.stop()
    for key, value in saved_env.items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value
    configure()
    import shutil
    for path in (conf_path, store_conf_path):
        try:
            os.unlink(path)
        except OSError:
            pass
    shutil.rmtree(tmpdir, ignore_errors=True)

    micro_cycles = sum(s.micro_cycles_run for s in scheds)
    result = {
        "device": device,
        "admission": admission_on,
        "kill": kill,
        "shards": shards,
        "offered": {lane: c["offered"] for lane, c in counts.items()},
        "admitted": {lane: c["admitted"] for lane, c in counts.items()},
        "shed": {lane: c["shed"] for lane, c in counts.items()},
        "bound": bound,
        "pods_per_s": round(bound / duration_s, 2),
        "lane_p99_s": lane_p99,
        "cluster_p99_s": cluster_p99,
        "micro_cycles": micro_cycles,
        "mttr_s": mttr,
        "drained": drained,
        "stuck_pods": stuck[:10],
        "exactly_once": not dup_binds,
        "fsck_violations": violations,
        "journal_orphans": orphans if kill else None,
        "retry_after_present": retry_ok[0],
        "listeners_clean": encode_cache.listener_count() == listeners_before,
        "brownout_level_final": (
            (gate_snapshot.get("controller") or {}).get("level")
            if admission_on else None
        ),
    }
    ok = bool(
        result["exactly_once"]
        and not violations
        and result["drained"]
        and result["listeners_clean"]
        and result["retry_after_present"]
        and bound > 0
        and micro_cycles > 0
    )
    if admission_on and not kill:
        high = lane_p99.get("high")
        ok = ok and high is not None and high <= 5.0
        ok = ok and counts["high"]["shed"] == 0
    if kill:
        ok = ok and mttr is not None and orphans == 0
    result["ok"] = ok
    return result


def storm_row(shards: int = 2, duration_s: float = 8.0, device: str = "cuda") -> dict:
    """The headline row: the same storm with admission ON, admission OFF
    (measured collapse), and ON + SIGKILL'd shard (adoption + MTTR)."""
    on = storm(shards=shards, duration_s=duration_s, admission_on=True, device=device)
    off = storm(shards=shards, duration_s=duration_s, admission_on=False, device=device)
    killed = storm(shards=shards, duration_s=duration_s, admission_on=True,
                   kill=True, device=device)
    return {
        "ok": bool(on["ok"] and killed["ok"] and off["exactly_once"]
                   and not off["fsck_violations"]),
        "on": on,
        "off": off,
        "kill": killed,
    }


def main(argv: Optional[list[str]] = None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(
        description="admission control plane: deterministic 5x-overload "
        "plant (default) or the live federated storm drill (--storm)"
    )
    parser.add_argument(
        "--storm", action="store_true",
        help="run the live storm drill (on/off/kill cells) instead of "
        "the deterministic plant",
    )
    parser.add_argument("--shards", type=int, default=2)
    parser.add_argument("--duration", type=float, default=None)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the storm's shards solve (default: the card)",
    )
    parser.add_argument(
        "--json", action="store_true", help="print the result dict as JSON"
    )
    args = parser.parse_args(argv)
    if args.storm:
        result = storm_row(
            shards=args.shards, duration_s=args.duration or 8.0,
            device=args.device,
        )
    else:
        result = smoke(duration_s=args.duration or 40.0, seed=args.seed)
    if args.json:
        print(json.dumps(result, sort_keys=True))
    elif args.storm:
        status = "ok" if result["ok"] else "FAILED"
        on, off, killed = result["on"], result["off"], result["kill"]
        print(
            f"admission storm: {status} (on: {on['pods_per_s']} pods/s, "
            f"high p99 {on['lane_p99_s'].get('high')}s, shed "
            f"{sum(on['shed'].values())}; off: high p99 "
            f"{off['lane_p99_s'].get('high')}s; kill: mttr "
            f"{killed['mttr_s']}s, orphans {killed['journal_orphans']})"
        )
    else:
        status = "ok" if result["ok"] else "FAILED"
        on, off = result["on"], result["off"]
        print(
            f"admission smoke: {status} (5x overload; on: tail p99 "
            f"{on['tail_p99_s']}s <= {result['slo_s'] * 3.0}s, high shed "
            f"{on['counts']['high']['shed']}, low shed "
            f"{on['counts']['low']['shed']}; off: tail p99 "
            f"{off['tail_p99_s']}s — collapse)"
        )
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    # re-enter through the canonical module: `python -m` runs this file as
    # __main__, whose module state would otherwise differ from the one
    # other modules import
    from kube_batch_tpu_torch.admission import main as _canonical_main

    raise SystemExit(_canonical_main())
