"""Degradation ladder: a circuit breaker per solver tier.

A tier that fails is not retried blindly every cycle, and a tier that sat
out comes back on its own. Each tier's breaker is the standard automaton:

- CLOSED: healthy; every cycle may use the tier.
- OPEN: after ``failure_threshold`` consecutive failures the tier sits
  out ``reset_timeout`` seconds (the backoff), during which ``allow()``
  is False and callers route to the next rung down.
- HALF_OPEN: once the backoff elapses, exactly one probe is allowed
  through. Probe success -> CLOSED (backoff resets); probe failure ->
  OPEN again with the backoff doubled (``backoff_factor``), capped at
  ``max_backoff``.

The port's solver ladder (``faults.solver_ladder``) runs sharded (the
node-sharded blocked solve, kernel B2, when a mesh is resolved) -> fused
(kernel B1) -> serial.

Every transition writes a metric (the ``breaker_transitions`` counter and
the ``breaker_state`` gauge) and a warning log line, so a drill, or a real
outage, shows on the exposition as open -> half_open -> closed history.

The bottom rung of a ``DegradationLadder`` has no breaker: serial is the
correctness oracle and must always be available.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable

from kube_batch_tpu_torch import metrics

log = logging.getLogger(__name__)

CLOSED = "closed"
HALF_OPEN = "half_open"
OPEN = "open"

_GAUGE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}


class CircuitBreaker:
    """One tier's health automaton (see module docstring)."""

    def __init__(
        self,
        name: str,
        failure_threshold: int = 3,
        reset_timeout: float = 30.0,
        backoff_factor: float = 2.0,
        max_backoff: float = 600.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.name = name
        self.failure_threshold = max(1, int(failure_threshold))
        self.reset_timeout = float(reset_timeout)
        self.backoff_factor = float(backoff_factor)
        self.max_backoff = float(max_backoff)
        self._clock = clock
        self._lock = threading.Lock()
        self.state = CLOSED
        self.failures = 0
        self._backoff = self.reset_timeout
        self._opened_at = 0.0
        self.publish()

    def publish(self) -> None:
        """Set the ``breaker_state`` gauge to this breaker's state."""
        metrics.set_breaker_state(self.name, _GAUGE[self.state])

    def _transition(self, to: str) -> None:
        # lock held by caller
        frm, self.state = self.state, to
        metrics.register_breaker_transition(self.name, frm, to)
        self.publish()
        extra = f" (recovery probe in {self._backoff:.1f}s)" if to == OPEN else ""
        log.warning("breaker %s: %s -> %s%s", self.name, frm, to, extra)

    def allow(self) -> bool:
        """May the tier be used right now? An OPEN breaker whose backoff
        has elapsed transitions to HALF_OPEN and admits the caller as the
        recovery probe."""
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN:
                if self._clock() - self._opened_at >= self._backoff:
                    self._transition(HALF_OPEN)
                    return True
                return False
            # HALF_OPEN: a probe is in flight; one scheduling loop drives
            # the solve, so admitting the caller is the probe continuing.
            return True

    def record_success(self) -> None:
        with self._lock:
            self.failures = 0
            self._backoff = self.reset_timeout
            if self.state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1
            if self.state == HALF_OPEN:
                # failed probe: back off harder before the next one
                self._backoff = min(self._backoff * self.backoff_factor, self.max_backoff)
                self._opened_at = self._clock()
                self._transition(OPEN)
            elif self.state == CLOSED and self.failures >= self.failure_threshold:
                self._opened_at = self._clock()
                self._transition(OPEN)

    def trip(self) -> None:
        """Force-open regardless of the failure count, for evidence the
        automaton's own counters cannot see: the scheduler's consecutive
        soft-deadline overruns (a slow but successful solve records a
        success each cycle, so per-call failures never accumulate).
        Recovery is the normal half-open probe path."""
        with self._lock:
            self.failures = self.failure_threshold
            if self.state != OPEN:
                self._opened_at = self._clock()
                self._transition(OPEN)

    def reset(self) -> None:
        with self._lock:
            self.failures = 0
            self._backoff = self.reset_timeout
            if self.state != CLOSED:
                self._transition(CLOSED)


class DegradationLadder:
    """Ordered tiers, best first; a breaker per tier except the last (the
    always-available floor: serial, the correctness oracle)."""

    def __init__(self, tiers=("sharded", "fused", "serial"), **breaker_kw) -> None:
        self.tiers = tuple(tiers)
        self.breakers: dict[str, CircuitBreaker] = {
            t: CircuitBreaker(t, **breaker_kw) for t in self.tiers[:-1]
        }

    def allow(self, tier: str) -> bool:
        b = self.breakers.get(tier)
        return True if b is None else b.allow()

    def record_success(self, tier: str) -> None:
        b = self.breakers.get(tier)
        if b is not None:
            b.record_success()

    def record_failure(self, tier: str) -> None:
        b = self.breakers.get(tier)
        if b is not None:
            b.record_failure()

    def trip(self, tier: str) -> None:
        b = self.breakers.get(tier)
        if b is not None:
            b.trip()

    def state(self, tier: str) -> str:
        b = self.breakers.get(tier)
        return CLOSED if b is None else b.state

    def reset(self) -> None:
        for b in self.breakers.values():
            b.reset()
