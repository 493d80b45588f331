"""Fault injection for the host fast paths: named injection points with
probability / count / seed semantics, armed through the API (``arm`` or
``configure`` on ``registry``) and checked where the encode cache and the
native loops can fail. Each point's degraded path gives the same bytes as
the fast path it replaces:

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

Every fire is metered (``metrics.fault_injections``, by point) and
logged.

Spec grammar (``configure``)::

    point[:probability[:count[:seed]]][,point2...]

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
import random
import threading
import zlib
from dataclasses import dataclass
from typing import Optional

from kube_batch_tpu_torch import metrics

__all__ = ["POINTS", "FaultInjected", "FaultRegistry", "registry", "should_fire"]

log = logging.getLogger(__name__)


class FaultInjected(RuntimeError):
    """Raised by call sites when their injection point fires — typed so
    a drill can tell an injected failure from an organic one."""


# The named injection points. arm()/configure() reject unknown names, so
# a typo in a drill spec is loud instead of silently never firing.
POINTS = (
    # incremental encode cache (ops/encode_cache.py)
    "encode.cache",        # cache poisoned -> state dropped, encode runs cold
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

    def __init__(self, spec: Optional[str] = None, seed: int = 0) -> None:
        self._lock = threading.Lock()
        self._rules: dict[str, _Rule] = {}
        self._seed = seed
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
        return True


registry = FaultRegistry()


def should_fire(point: str) -> bool:
    return registry.should_fire(point)
