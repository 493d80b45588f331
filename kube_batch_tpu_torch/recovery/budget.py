"""Cycle deadline budget: one wedged solve must not stall the scheduler.

The hard deadline, measured from cycle start, aborts the cycle. The abort
point is always *pre-dispatch* (at solver entry, between solve segments,
at the dispatch barrier before any ``cache.bind``, and between actions),
so aborting rolls back to a byte-identical cache — the session snapshot
is simply discarded, the Statement discipline's ``discard`` at cycle
granularity — and the next cycle reschedules the aborted gangs from
Pending.

The JAX package's budget also has a soft deadline, from which its
scheduler arms a solver-tier downgrade, and a fault point that fires a
hard overrun on demand; this port has no tier ladder and no fault
injection yet, so it keeps the hard deadline alone.
"""

from __future__ import annotations

import time
from typing import Callable, Optional


class CycleDeadlineExceeded(RuntimeError):
    """Raised at a pre-dispatch check when the hard budget is gone; the
    scheduler catches it and discards the cycle."""


class CycleBudget:
    """Deadline state for one scheduling cycle."""

    def __init__(
        self,
        hard_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.hard_s = hard_s if hard_s and hard_s > 0 else None
        self._clock = clock
        self._start = clock()

    def elapsed(self) -> float:
        return self._clock() - self._start

    def hard_exceeded(self) -> bool:
        return self.hard_s is not None and self.elapsed() > self.hard_s

    def check(self, where: str) -> None:
        """Raise CycleDeadlineExceeded when the hard budget is gone. Call
        sites are all pre-dispatch (see module docstring)."""
        if self.hard_exceeded():
            raise CycleDeadlineExceeded(
                f"cycle hard deadline exceeded at {where} "
                f"({self.elapsed():.3f}s elapsed, budget {self.hard_s})"
            )
