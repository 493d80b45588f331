"""Fault injection and the solver's degradation ladder.

- a deterministic **fault registry** (``registry``): named injection
  points with probability / count / seed semantics, armed through the
  API (``arm`` or ``configure``), the ``KBT_FAULTS`` environment variable
  (read once, at import; ``KBT_FAULTS_SEED`` seeds it) or the scheduler
  conf's ``faults:`` key, and checked where failures happen;
- a **degradation ladder** (``solver_ladder``, ``ladder.DegradationLadder``):
  a circuit breaker per solver tier (sharded -> fused -> serial) with
  exponential-backoff recovery probes, shared by every torch_allocate
  execution so breaker state persists across cycles and conf reloads.
  ``KBT_BREAKER_THRESHOLD`` (3) and ``KBT_BREAKER_RESET_S`` (30) size it.

The solver and cycle points (actions/torch_allocate.py, recovery/budget.py):

- ``solve.sharded``: the sharded rung's segment fails after it ran (its
  result is discarded, as when an asynchronous CUDA error surfaces at the
  state fetch); the failure feeds the ``sharded`` breaker and the fused
  rung resumes from the same ``SolveState`` in the same cycle;
- ``solve.fused``: the fused rung's segment fails the same way; the
  failure feeds the ``fused`` breaker and the cycle finishes on the serial
  allocate;
- ``solve.nan``: a NaN poisons ``w_least``; the finite guard routes the
  cycle to serial;
- ``cycle.overrun``: the dispatch barrier's budget check reports a hard
  overrun; the cycle aborts before any bind and its session is discarded.

The process's points (cache/cache.py, cache/store.py, server.py):

- ``bind.write`` / ``evict.write``: a store write of the cache's kb-write
  pool is rejected; it is retried in place with jitter
  (``KBT_WRITE_RETRIES``, default 2, each retry counted in
  ``write_retries_total{op}``), then the task goes through the errTasks
  resync and schedules again on a later cycle;
- ``bind.slow``: each bind attempt stalls 50 ms;
- ``watch.drop``: a long-poll watch returns 410 Gone, and the client
  re-lists;
- ``store.conflict``: a conditional (versioned) store transaction is
  rejected with ``StaleWrite(reason="injected")``.

Federation's points (cache/cache.py, cache/backend.py, federation.py):

- ``store.txn_batch``: a coalesced ``/backend/v1/txn`` round trip fails,
  and every gang of the batch falls back, loudly, to its own conditional
  write;
- ``federation.partition``: the loopback backend's transport drops a
  request; the client backs off and the watch heals by relisting;
- ``federation.stale_assign``: a dispatch carries store version 0 on
  purpose, so the conflict path (retry with a fresh version) runs;
- ``stream.pump``: one round of the backend's watch pump is dropped, and
  the mirror catches up on the next round;
- ``shard.adopt``: an adoption of an orphaned shard slot fails after the
  lease was taken; the slot is released and retried on a later probe;
- ``shard.handoff``: a graceful handoff aborts mid-drain and the slot is
  kept, loudly;
- ``shard.lease_flap``: one renewal round of the owned slots is dropped;
  the owner reacquires without a double adoption.

Streaming and pipelined cycles (scheduler.py, pipeline.py):

- ``stream.micro_cycle``: a micro-cycle fails before it solves; the
  resident node table is invalidated and the loop runs a full cycle at
  once, with every arrival kept in the backlog;
- ``pipeline.fence``: the next cycle's wait on the deferred dispatch
  times out; the pipeline degrades to synchronous cycles for the
  process (sticky until ``pipeline.reset()``) and that cycle is skipped.

The HA pair's points (server.py, recovery/):

- ``lease.renew``: a lease round-trip to the arbiter fails; past the
  renew deadline the leader releases the lease and fires ``on_lost``;
- ``journal.append``: the write-intent journal's append fails, and the
  batch is dispatched unjournaled (``journal_records_total{state=
  "append_failed"}``);
- ``journal.replay``: the journal is unreadable at takeover;
  reconciliation reports ``aborted`` and the standby's loop heals;
- ``reconcile.scan``: the takeover scan dies part-way; reconciliation
  reports ``aborted`` and the loop heals.

The host fast paths' points, each of whose degraded paths gives the same
bytes as the fast path it replaces:

- ``encode.cache``: the cache is dropped and the encode runs cold
  (ops/encode_cache.active);
- ``native.load``: the native module is unavailable for one replay, and
  every fast path of that replay runs its Python twin
  (actions/torch_allocate._Replayer);
- ``native.prepass``: ``bulk_assign`` raises before any mutation, and the
  segment replays in Python;
- ``native.dispatch``: ``bulk_dispatch`` raises before any bucket moves,
  and the dispatch barrier runs in Python;
- ``native.class_dedup``: B1's class dedup takes ``np.unique``
  (ops/fused_solve._class_inverse).

Every fire is metered (``metrics.fault_injections``, by point), logged,
and snapshots the flight recorder (obs.recorder, throttled), and every
breaker transition writes ``breaker_transitions`` and ``breaker_state``.

Spec grammar (``configure``, ``KBT_FAULTS``, the conf's ``faults:``)::

    point[:probability[:count[:seed]]][,point2...]

    "solve.fused:1:3"          # the first three fused solves fail
    "native.prepass:1:2"       # the first two bulk_assign calls fail
    "encode.cache:0.5"         # half of the encodes run cold
    "native.dispatch:1:3:42"   # three fires, RNG seed 42

``probability`` defaults to 1, ``count`` (max fires) to unlimited, and
``off`` as the probability disarms the point. Probability draws come from
a per-point RNG seeded from (registry seed, point name): a drill replays
identically given the same spec and call sequence.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import zlib
from dataclasses import dataclass
from typing import Optional

from kube_batch_tpu_torch import metrics
from kube_batch_tpu_torch.faults.ladder import CircuitBreaker, DegradationLadder

__all__ = [
    "POINTS",
    "FaultInjected",
    "FaultRegistry",
    "registry",
    "should_fire",
    "CircuitBreaker",
    "DegradationLadder",
    "solver_ladder",
    "set_solver_ladder",
]

log = logging.getLogger(__name__)


class FaultInjected(RuntimeError):
    """Raised by call sites when their injection point fires — typed so
    a drill can tell an injected failure from an organic one."""


# The named injection points. arm()/configure() reject unknown names, so
# a typo in a drill spec is loud instead of silently never firing.
POINTS = (
    # solver entry (actions/torch_allocate.py)
    "solve.sharded",       # sharded rung (B2) segment fails -> fused rung resumes, same cycle
    "solve.fused",         # fused rung (B1) segment fails -> serial for the cycle
    "solve.nan",           # NaN poisons a score weight -> finite guard -> serial
    # cache write side (cache/cache.py)
    "bind.write",          # binder write rejected -> retry w/ jitter -> errTasks
    "bind.slow",           # slow binder (50ms stall per attempt)
    "evict.write",         # evictor write rejected -> retry -> errTasks
    # watch stream (server.py WatchHub)
    "watch.drop",          # stream drop: poll returns 410-Gone, client re-lists
    # lease elector (server.py)
    "lease.renew",         # renewal round-trip fails (arbiter partition/timeout)
    # crash-consistent failover (recovery/)
    "journal.append",      # WAL append fails -> write dispatches unjournaled, loudly
    "journal.replay",      # journal unreadable at takeover -> resync self-heal
    "reconcile.scan",      # takeover scan dies mid-way -> partial, rescheduling heals
    # cycle budget (recovery/budget.py)
    "cycle.overrun",       # injected wedged solve -> hard-deadline abort pre-dispatch
    # store conditional transactions (cache/store.py)
    "store.conflict",      # conditional write rejected with StaleWrite
    # sharded federation (cache/cache.py, cache/backend.py, federation.py)
    "store.txn_batch",     # coalesced txn round trip fails -> per-gang v1 writes, loudly
    "federation.partition",  # loopback backend transport drops -> backoff + relist heal
    "federation.stale_assign",  # dispatch carries a stale snapshot version on purpose
    "stream.pump",         # backend watch-pump round dropped -> next round catches up
    # leased shard slots (federation.py ShardSlotManager)
    "shard.adopt",         # adoption takeover fails -> retry on a later probe
    "shard.handoff",       # graceful handoff aborts mid-drain -> slot kept, loudly
    "shard.lease_flap",    # own slot renewal dropped once -> reacquire, no double-adopt
    # incremental encode cache (ops/encode_cache.py)
    "encode.cache",        # cache poisoned -> state dropped, encode runs cold
    # streaming micro-cycles (scheduler.py run_micro)
    "stream.micro_cycle",  # micro-cycle solve fails -> degrade to full cycle, no pod dropped
    # pipelined cycles (pipeline.py DispatchFence)
    "pipeline.fence",      # deferred dispatch wedged -> fence timeout -> sync degrade
    # native extension boundary (ops/, the bulk replay)
    "native.load",         # extension unavailable for the replay -> Python twins
    "native.prepass",      # bulk_assign prepass raises -> Python replay
    "native.dispatch",     # bulk_dispatch raises -> Python dispatch barrier
    "native.class_dedup",  # class_dedup unavailable -> np.unique
)


@dataclass
class _Rule:
    point: str
    probability: float = 1.0
    count: Optional[int] = None  # max fires; None = unlimited
    fired: int = 0
    rng: Optional[random.Random] = None


class FaultRegistry:
    """Thread-safe registry of armed injection points."""

    def __init__(self, spec: Optional[str] = None, seed: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._rules: dict[str, _Rule] = {}
        self._seed = seed if seed is not None else _env_int("KBT_FAULTS_SEED", 0)
        if spec is None:
            spec = os.environ.get("KBT_FAULTS", "")
        if spec:
            self.configure(spec)

    # -- arming --------------------------------------------------------------

    def _point_rng(self, point: str, seed: Optional[int]) -> random.Random:
        if seed is None:
            seed = self._seed ^ zlib.crc32(point.encode())
        return random.Random(seed)

    def arm(
        self,
        point: str,
        probability: float = 1.0,
        count: Optional[int] = None,
        seed: Optional[int] = None,
    ) -> None:
        if point not in POINTS:
            raise ValueError(f"unknown fault point {point!r} (known: {', '.join(POINTS)})")
        with self._lock:
            self._rules[point] = _Rule(
                point=point,
                probability=float(probability),
                count=count,
                rng=self._point_rng(point, seed),
            )
        log.info(
            "fault point %s armed (p=%g count=%s)",
            point, probability, "inf" if count is None else count,
        )

    def disarm(self, point: Optional[str] = None) -> None:
        with self._lock:
            if point is None:
                self._rules.clear()
            else:
                self._rules.pop(point, None)

    def reset(self) -> None:
        """Drop every rule (test hygiene between drills)."""
        self.disarm()

    def configure(self, spec: str) -> None:
        """Parse and arm a drill spec (see module docstring). Invalid
        entries are logged and skipped."""
        for entry in (spec or "").split(","):
            entry = entry.strip()
            if not entry:
                continue
            parts = entry.split(":")
            point = parts[0].strip()
            try:
                if len(parts) > 1 and parts[1].strip().lower() == "off":
                    if point not in POINTS:
                        raise ValueError(f"unknown fault point {point!r}")
                    self.disarm(point)
                    continue
                prob = float(parts[1]) if len(parts) > 1 and parts[1].strip() else 1.0
                count = int(parts[2]) if len(parts) > 2 and parts[2].strip() else None
                seed = int(parts[3]) if len(parts) > 3 and parts[3].strip() else None
                self.arm(point, probability=prob, count=count, seed=seed)
            except ValueError as e:
                log.error("ignoring invalid fault spec entry %r: %s", entry, e)

    def active(self) -> dict[str, tuple[float, Optional[int], int]]:
        """point -> (probability, count, fired) for introspection."""
        with self._lock:
            return {
                p: (r.probability, r.count, r.fired) for p, r in self._rules.items()
            }

    # -- firing --------------------------------------------------------------

    def should_fire(self, point: str) -> bool:
        """True when the named point is armed and its probability/count
        say this call fails. A True return is already metered and logged;
        the call site only has to take its degraded branch (or raise
        ``FaultInjected`` where an exception is the failure mode)."""
        with self._lock:
            rule = self._rules.get(point)
            if rule is None:
                return False
            if rule.count is not None and rule.fired >= rule.count:
                return False
            if rule.probability < 1.0 and rule.rng.random() >= rule.probability:
                return False
            rule.fired += 1
            fired = rule.fired
        metrics.register_fault_injection(point)
        log.warning("fault injected: %s (fire #%d)", point, fired)
        # Snapshot the flight recorder at the moment of injection: the spans
        # leading up to the fault are what a drill reads afterwards.
        # Throttled, so a point firing every cycle cannot flood the dump
        # directory; a no-op while tracing is off (the ring is empty).
        from kube_batch_tpu_torch import obs

        obs.recorder.dump(reason=f"fault:{point}", min_interval_s=5.0)
        return True


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        log.error("%s=%r is not an integer; using %d", name, os.environ.get(name), default)
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        log.error("%s=%r is not a number; using %g", name, os.environ.get(name), default)
        return default


registry = FaultRegistry()


def should_fire(point: str) -> bool:
    return registry.should_fire(point)


# The process-wide solver ladder (sharded -> fused -> serial), shared by
# every torch_allocate execution so breaker state persists across cycles
# and conf reloads. sharded is the top rung when a mesh is resolved;
# without one the ladder starts at fused. Tests and drills swap in a
# short-timeout instance.
solver_ladder = DegradationLadder(
    ("sharded", "fused", "serial"),
    failure_threshold=_env_int("KBT_BREAKER_THRESHOLD", 3),
    reset_timeout=_env_float("KBT_BREAKER_RESET_S", 30.0),
)


def set_solver_ladder(ladder: DegradationLadder) -> DegradationLadder:
    """Install ``ladder`` as the process ladder and return the previous
    one (a drill swaps in a fresh, short-timeout ladder and restores the
    process ladder after). The ``breaker_state`` gauge is per tier name,
    so the installed ladder's states are published again."""
    global solver_ladder
    previous, solver_ladder = solver_ladder, ladder
    for b in ladder.breakers.values():
        b.publish()
    return previous
