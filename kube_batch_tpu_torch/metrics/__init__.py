"""In-process scheduling metrics (reference pkg/scheduler/metrics/metrics.go:38-121)
and their Prometheus text exposition (``render_prometheus_text``).

The primitives (``Histogram`` with its batched ``observe_many``,
``Counter``, ``Gauge``) keep the JAX package's semantics; the series are
the ones the port's main path writes, under the JAX package's names and
label sets:

- the reference's set: ``e2e_scheduling_latency``, ``action_scheduling_latency{action}``
  and ``schedule_attempts_total`` (scheduler.py), ``plugin_scheduling_latency{plugin,OnSession}``
  and ``task_scheduling_latency`` (framework/session.py and the replay's
  gang dispatch), ``total_preemption_victims`` and
  ``total_preemption_attempts`` (actions/preempt.py),
  ``unschedule_task_count{job_id}``, ``unschedule_job_count`` and
  ``job_retry_counts{job_id}`` (plugins/gang.py);
- the ladder's: ``fault_injections_total{point}``,
  ``breaker_transitions_total{tier,from,to}``, ``breaker_state{tier}``,
  ``degraded_cycles_total{tier,reason}`` (faults/, actions/torch_allocate.py);
- the cycle's: ``cycle_overruns_total{kind}`` (scheduler.py);
- ``exchange_batched_iters_total`` (the sharded rung's K-deep exchange);
- ``encode_cache_hits_total``, ``encode_cache_invalidations_total{reason}``
  and ``encode_warm_fraction`` (ops/encode_cache.py);
- ``slo_time_to_bind_seconds`` and ``slo_queue_wait_seconds``
  ``{queue,quantile}`` and ``slo_evicted_queues_total``, set by
  ``obs.slo.publish()``.

The JAX package's series of layers the port does not have yet (the
store, watch, journal, federation, admission, shards, fleet, streaming,
the tensor arena, the class-compressed solve and explain) come with those
layers; so do exemplars, and ``stale_cycles_skipped_total`` with the real
cache and its staleness guard.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Iterable, Optional

import numpy as np

# Buckets: 5ms * 2^k for e2e (metrics.go:41-44), 5us * 2^k for the rest
# (metrics.go:49-72). Values recorded in seconds.
E2E_BUCKETS = tuple(0.005 * 2**k for k in range(12))
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

    def label_sets(self) -> list[tuple]:
        with self._lock:
            return list(self._series)

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

    def samples(self) -> dict[tuple, float]:
        with self._lock:
            return dict(self._values)

    def drop_labels(self, **match: str) -> int:
        """Remove every label set matching all given label=value pairs (an
        evicted SLO queue drops its gauge series too, or the cardinality
        bound would leak through the exposition)."""
        with self._lock:
            dead = [k for k in self._values if all(dict(k).get(a) == b for a, b in match.items())]
            for k in dead:
                del self._values[k]
            return len(dead)


_SUBSYSTEM = "kube_batch_tpu"

e2e_scheduling_latency = Histogram(
    f"{_SUBSYSTEM}_e2e_scheduling_latency", "E2E scheduling latency in seconds", E2E_BUCKETS
)
plugin_scheduling_latency = Histogram(
    f"{_SUBSYSTEM}_plugin_scheduling_latency", "Plugin scheduling latency in seconds", FINE_BUCKETS
)
action_scheduling_latency = Histogram(
    f"{_SUBSYSTEM}_action_scheduling_latency", "Action scheduling latency in seconds", FINE_BUCKETS
)
task_scheduling_latency = Histogram(
    f"{_SUBSYSTEM}_task_scheduling_latency", "Task scheduling latency in seconds", FINE_BUCKETS
)
schedule_attempts = Counter(
    f"{_SUBSYSTEM}_schedule_attempts_total",
    "Number of attempts to schedule pods, by result",
)
preemption_victims = Counter(
    f"{_SUBSYSTEM}_total_preemption_victims", "Number of selected preemption victims"
)
preemption_attempts = Counter(
    f"{_SUBSYSTEM}_total_preemption_attempts", "Total preemption attempts in the cluster"
)
unschedule_task_count = Gauge(
    f"{_SUBSYSTEM}_unschedule_task_count", "Number of tasks could not be scheduled"
)
unschedule_job_count = Gauge(
    f"{_SUBSYSTEM}_unschedule_job_count", "Number of jobs could not be scheduled"
)
job_retry_counts = Counter(f"{_SUBSYSTEM}_job_retry_counts", "Number of retry counts for one job")

# -- fault injection + degradation ladder (faults/) ---------------------------
fault_injections = Counter(
    f"{_SUBSYSTEM}_fault_injections_total", "Injected faults fired, by point"
)
breaker_transitions = Counter(
    f"{_SUBSYSTEM}_breaker_transitions_total",
    "Degradation-ladder circuit-breaker transitions, by tier and edge",
)
breaker_state = Gauge(
    f"{_SUBSYSTEM}_breaker_state",
    "Circuit-breaker state per solver tier (0=closed, 1=half_open, 2=open)",
)
degraded_cycles = Counter(
    f"{_SUBSYSTEM}_degraded_cycles_total",
    "Scheduling cycles that ran below their preferred solver tier, by reason",
)

# -- the cycle's deadline budget (scheduler.py) -------------------------------
cycle_overruns = Counter(
    f"{_SUBSYSTEM}_cycle_overruns_total",
    "Scheduling cycles past their deadline budget, by kind (soft/hard)",
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

# -- the sharded rung's K-deep batched exchange (parallel/sharded_block.py) ---
exchange_batched_iters_total = Counter(
    f"{_SUBSYSTEM}_exchange_batched_iters_total",
    "Gang iterations committed straight from a K-deep batched mesh "
    "exchange instead of a per-iteration all-gather",
)

# -- per-queue SLO windows (obs.SLOAccountant) ---------------------------------
# Sliding-window quantiles, refreshed by obs.slo.publish(): unlike the
# cumulative histograms above, these answer "is queue Q meeting its SLO now".
slo_time_to_bind = Gauge(
    f"{_SUBSYSTEM}_slo_time_to_bind_seconds",
    "Sliding-window time-to-bind quantiles per queue "
    "(labels: queue, quantile=p50/p90/p99)",
)
slo_queue_wait = Gauge(
    f"{_SUBSYSTEM}_slo_queue_wait_seconds",
    "Sliding-window pod-creation-to-dispatch wait quantiles per queue "
    "(labels: queue, quantile=p50/p90/p99)",
)
_SLO_GAUGES = {"time_to_bind": slo_time_to_bind, "queue_wait": slo_queue_wait}
slo_evicted_queues = Counter(
    f"{_SUBSYSTEM}_slo_evicted_queues_total",
    "Queues evicted from the SLO accountant's LRU cardinality bound "
    "(a tenant-name churn storm shows up here, not as unbounded labels)",
)


def update_e2e_duration(seconds: float) -> None:
    e2e_scheduling_latency.observe(seconds)


def update_plugin_duration(plugin: str, phase: str, seconds: float) -> None:
    plugin_scheduling_latency.observe(seconds, {"plugin": plugin, "OnSession": phase})


def update_action_duration(action: str, seconds: float) -> None:
    action_scheduling_latency.observe(seconds, {"action": action})


def update_task_schedule_duration(seconds: float) -> None:
    task_scheduling_latency.observe(seconds)


def update_task_schedule_durations(seconds_list) -> None:
    """One observation per dispatched task (the bulk gang dispatch)."""
    task_scheduling_latency.observe_many(seconds_list)


def update_preemption_victims_count(count: int) -> None:
    preemption_victims.inc(by=count)


def register_preemption_attempts() -> None:
    preemption_attempts.inc()


def update_unschedule_task_count(job_name: str, count: int) -> None:
    unschedule_task_count.set(count, {"job_id": job_name})


def update_unschedule_job_count(count: int) -> None:
    unschedule_job_count.set(count)


def register_job_retries(job_name: str) -> None:
    job_retry_counts.inc({"job_id": job_name})


def register_fault_injection(point: str) -> None:
    fault_injections.inc({"point": point})


def register_breaker_transition(tier: str, frm: str, to: str) -> None:
    breaker_transitions.inc({"tier": tier, "from": frm, "to": to})


def set_breaker_state(tier: str, value: float) -> None:
    breaker_state.set(value, {"tier": tier})


def register_degraded_cycle(tier: str, reason: str) -> None:
    degraded_cycles.inc({"tier": tier, "reason": reason})


def register_cycle_overrun(kind: str) -> None:
    cycle_overruns.inc({"kind": kind})


def register_exchange_batched_iters(n: int) -> None:
    exchange_batched_iters_total.inc(by=n)


def set_slo_quantile(kind: str, queue: str, quantile: str, value: float) -> None:
    """One SLO window quantile (kind in obs.SLOAccountant.KINDS)."""
    gauge = _SLO_GAUGES.get(kind)
    if gauge is not None:
        gauge.set(value, {"queue": queue, "quantile": quantile})


def register_slo_evicted_queue() -> None:
    slo_evicted_queues.inc()


def drop_slo_queue(queue: str) -> None:
    """Remove an evicted queue's label sets from both slo gauges."""
    for gauge in _SLO_GAUGES.values():
        gauge.drop_labels(queue=queue)


def register_encode_cache_hits(n: int) -> None:
    encode_cache_hits.inc(by=n)


def register_encode_cache_invalidation(reason: str, n: int = 1) -> None:
    encode_cache_invalidations.inc({"reason": reason}, by=n)


def set_encode_warm_fraction(fraction: float) -> None:
    encode_warm_fraction.set(fraction)


def _escape_label_value(value) -> str:
    """Prometheus text-format label escaping: backslash, double quote and
    newline are escaped inside the quoted value, so a queue named ``a"b``
    or a fault reason with a newline cannot corrupt the scrape."""
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _render_family(metric) -> list[str]:
    lines = [f"# HELP {metric.name} {metric.help}"]
    if isinstance(metric, Histogram):
        lines.append(f"# TYPE {metric.name} histogram")
        for key in metric.label_sets() or [()]:
            snap = metric.snapshot(dict(key) if key else None)
            prefix = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key)
            sep = "," if prefix else ""
            for boundary, cum in snap["buckets"].items():
                lines.append(f'{metric.name}_bucket{{{prefix}{sep}le="{boundary}"}} {cum}')
            lines.append(f'{metric.name}_bucket{{{prefix}{sep}le="+Inf"}} {snap["count"]}')
            suffix = f"{{{prefix}}}" if prefix else ""
            lines.append(f"{metric.name}_sum{suffix} {snap['sum']}")
            lines.append(f"{metric.name}_count{suffix} {snap['count']}")
    else:
        kind = "counter" if isinstance(metric, Counter) else "gauge"
        lines.append(f"# TYPE {metric.name} {kind}")
        items = metric.samples()
        if not items:
            lines.append(f"{metric.name} 0")
        for key, value in items.items():
            if key:
                label_str = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key)
                lines.append(f"{metric.name}{{{label_str}}} {value}")
            else:
                lines.append(f"{metric.name} {value}")
    return lines


# The families in the JAX package's exposition order (a subset of it).
FAMILIES = (
    e2e_scheduling_latency,
    plugin_scheduling_latency,
    action_scheduling_latency,
    task_scheduling_latency,
    schedule_attempts,
    preemption_victims,
    preemption_attempts,
    unschedule_task_count,
    unschedule_job_count,
    job_retry_counts,
    fault_injections,
    breaker_transitions,
    breaker_state,
    degraded_cycles,
    cycle_overruns,
    encode_cache_hits,
    encode_cache_invalidations,
    encode_warm_fraction,
    exchange_batched_iters_total,
    slo_time_to_bind,
    slo_queue_wait,
    slo_evicted_queues,
)


def render_prometheus_text() -> str:
    """Prometheus text exposition for every registered series."""
    lines: list[str] = []
    for metric in FAMILIES:
        lines.extend(_render_family(metric))
    return "\n".join(lines) + "\n"
