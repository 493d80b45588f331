"""Cycle deadline budget: one wedged solve must not stall the scheduler.

Two deadlines, both measured from cycle start:

- **soft** (``KBT_CYCLE_SOFT_DEADLINE_S`` or the scheduler's
  ``soft_deadline_s``): the cycle finishing late is evidence against the
  solver tier that ran it. The scheduler counts consecutive soft
  overruns and, at the tier's breaker threshold, trips that tier's
  circuit breaker (faults/ladder.py), so the next cycles run one rung
  down until the breaker's recovery probe closes it again;
- **hard** (``KBT_CYCLE_HARD_DEADLINE_S`` or ``hard_deadline_s``): the
  cycle aborts. The abort point is always *pre-dispatch* (at solver
  entry, between solve segments, at the dispatch barrier before any
  ``cache.bind``, and between actions), so aborting rolls back to a
  byte-identical cache: the session snapshot is simply discarded, the
  Statement discipline's ``discard`` at cycle granularity, and the next
  cycle reschedules the aborted gangs from Pending.

The ``cycle.overrun`` fault point makes a hard overrun injectable. It is
consulted only at the dispatch-barrier check (``inject=True``, the last
pre-dispatch gate, after encode, solve and replay have done the most
discardable work), so a drill exercises the worst-case abort without a
real stall.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from kube_batch_tpu_torch import faults


class CycleDeadlineExceeded(RuntimeError):
    """Raised at a pre-dispatch check when the hard budget is gone; the
    scheduler catches it, meters ``cycle_overruns{kind="hard"}`` and
    discards the cycle."""


class CycleBudget:
    """Deadline state for one scheduling cycle."""

    def __init__(
        self,
        soft_s: Optional[float] = None,
        hard_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.soft_s = soft_s if soft_s and soft_s > 0 else None
        self.hard_s = hard_s if hard_s and hard_s > 0 else None
        self._clock = clock
        self._start = clock()

    def elapsed(self) -> float:
        return self._clock() - self._start

    def remaining(self) -> float:
        """Seconds left in the hard budget (inf when there is no hard
        deadline)."""
        if self.hard_s is None:
            return float("inf")
        return self.hard_s - self.elapsed()

    def soft_exceeded(self) -> bool:
        return self.soft_s is not None and self.elapsed() > self.soft_s

    def hard_exceeded(self, inject: bool = False) -> bool:
        """True when the hard deadline passed, or, at the dispatch barrier
        (``inject=True``), when the ``cycle.overrun`` fault point fires."""
        if inject and faults.should_fire("cycle.overrun"):
            return True
        return self.hard_s is not None and self.elapsed() > self.hard_s

    def check(self, where: str, inject: bool = False) -> None:
        """Raise CycleDeadlineExceeded when the hard budget is gone. Call
        sites are all pre-dispatch (see module docstring)."""
        if self.hard_exceeded(inject=inject):
            raise CycleDeadlineExceeded(
                f"cycle hard deadline exceeded at {where} "
                f"({self.elapsed():.3f}s elapsed, budget "
                f"{self.hard_s if self.hard_s is not None else 'injected'})"
            )
