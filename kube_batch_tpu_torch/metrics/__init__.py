"""In-process scheduling metrics (reference pkg/scheduler/metrics/metrics.go:38-121),
the part the host fast paths write.

The primitives (``Histogram`` with its batched ``observe_many``,
``Counter``, ``Gauge``) keep the JAX package's semantics; the series are
the ones this port writes so far, under the JAX package's names:

- ``task_scheduling_latency``: per dispatched task, its solve segment's
  completion minus its pod's creation (the replay's gang dispatch,
  ``update_task_schedule_durations``);
- ``encode_cache_hits_total``, ``encode_cache_invalidations_total{reason}``
  and ``encode_warm_fraction`` (ops/encode_cache.py);
- ``fault_injections_total{point}`` (faults/).
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Iterable, Optional

import numpy as np

# Buckets: 5us * 2^k (metrics.go:49-72). Values recorded in seconds.
FINE_BUCKETS = tuple(5e-6 * 2**k for k in range(18))


def _key(labels: Optional[dict[str, str]]) -> tuple:
    return tuple(sorted((labels or {}).items()))


class Histogram:
    """Labeled histogram vector (one bucket series per label set, like the
    reference's prometheus HistogramVec)."""

    def __init__(self, name: str, help_text: str, buckets: Iterable[float]) -> None:
        self.name = name
        self.help = help_text
        self.buckets = tuple(sorted(buckets))
        # label tuple -> [counts per bucket + overflow, sum, total]
        self._series: dict[tuple, list] = {}
        self._lock = threading.Lock()

    def _series_for(self, key: tuple) -> list:
        series = self._series.get(key)
        if series is None:
            series = self._series[key] = [[0] * (len(self.buckets) + 1), 0.0, 0]
        return series

    def observe(self, value: float, labels: Optional[dict[str, str]] = None) -> None:
        i = bisect_left(self.buckets, value)  # first bucket with value <= bound
        with self._lock:
            series = self._series_for(_key(labels))
            series[0][i] += 1
            series[1] += value
            series[2] += 1

    def observe_many(self, values, labels: Optional[dict[str, str]] = None) -> None:
        """Batch observe: one lock acquisition for a whole list of values —
        identical bucket counts/sum/total to calling observe per value.
        ndarray input takes a vectorized path (searchsorted + bincount);
        a 100k-bind gang dispatch feeds its whole latency vector here."""
        if isinstance(values, np.ndarray):
            if values.size == 0:
                return
            nb = len(self.buckets)
            # side='left' == bisect_left: bucket bounds are inclusive upper edges
            idx = np.searchsorted(np.asarray(self.buckets), values, side="left")
            add = np.bincount(np.minimum(idx, nb), minlength=nb + 1).tolist()
            total, n = float(values.sum()), int(values.size)
        else:
            values = list(values)
            if not values:
                return
            add = [0] * (len(self.buckets) + 1)
            for v in values:
                add[bisect_left(self.buckets, v)] += 1
            total, n = sum(values), len(values)
        with self._lock:
            series = self._series_for(_key(labels))
            for i, c in enumerate(add):
                series[0][i] += c
            series[1] += total
            series[2] += n

    def snapshot(self, labels: Optional[dict[str, str]] = None) -> dict:
        """Cumulative bucket counts for one label set (default: the sum
        over all label sets)."""
        with self._lock:
            if labels is None:
                merged = [0] * (len(self.buckets) + 1)
                total_sum, total = 0.0, 0
                for counts, s, n in self._series.values():
                    for i, c in enumerate(counts):
                        merged[i] += c
                    total_sum += s
                    total += n
            else:
                counts, total_sum, total = self._series.get(
                    _key(labels), [[0] * (len(self.buckets) + 1), 0.0, 0]
                )
                merged = list(counts)
        cumulative = []
        running = 0
        for c in merged[:-1]:
            running += c
            cumulative.append(running)
        return {"buckets": dict(zip(self.buckets, cumulative)), "sum": total_sum, "count": total}


class Counter:
    def __init__(self, name: str, help_text: str) -> None:
        self.name = name
        self.help = help_text
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, labels: Optional[dict[str, str]] = None, by: float = 1.0) -> None:
        key = _key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + by

    def value(self, labels: Optional[dict[str, str]] = None) -> float:
        with self._lock:
            return self._values.get(_key(labels), 0.0)

    def samples(self) -> dict[tuple, float]:
        """All label sets with their values."""
        with self._lock:
            return dict(self._values)


class Gauge:
    def __init__(self, name: str, help_text: str) -> None:
        self.name = name
        self.help = help_text
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, labels: Optional[dict[str, str]] = None) -> None:
        with self._lock:
            self._values[_key(labels)] = value

    def value(self, labels: Optional[dict[str, str]] = None) -> float:
        with self._lock:
            return self._values.get(_key(labels), 0.0)


_SUBSYSTEM = "kube_batch_tpu"

task_scheduling_latency = Histogram(
    f"{_SUBSYSTEM}_task_scheduling_latency", "Task scheduling latency in seconds", FINE_BUCKETS
)
fault_injections = Counter(
    f"{_SUBSYSTEM}_fault_injections_total", "Injected faults fired, by point"
)

# -- incremental encode cache (ops/encode_cache.py) --------------------------
encode_cache_hits = Counter(
    f"{_SUBSYSTEM}_encode_cache_hits_total",
    "Encode-cache units (signatures, group pairs, blocks) reused verbatim",
)
encode_cache_invalidations = Counter(
    f"{_SUBSYSTEM}_encode_cache_invalidations_total",
    "Encode-cache invalidations, by reason (store kind / fault / capacity)",
)
encode_warm_fraction = Gauge(
    f"{_SUBSYSTEM}_encode_warm_fraction",
    "Fraction of the last encode's units served from the cross-cycle cache "
    "(0 = fully cold)",
)


def update_task_schedule_durations(seconds_list) -> None:
    """One observation per dispatched task (the bulk gang dispatch)."""
    task_scheduling_latency.observe_many(seconds_list)


def register_fault_injection(point: str) -> None:
    fault_injections.inc({"point": point})


def register_encode_cache_hits(n: int) -> None:
    encode_cache_hits.inc(by=n)


def register_encode_cache_invalidation(reason: str, n: int = 1) -> None:
    encode_cache_invalidations.inc({"reason": reason}, by=n)


def set_encode_warm_fraction(fraction: float) -> None:
    encode_warm_fraction.set(fraction)
