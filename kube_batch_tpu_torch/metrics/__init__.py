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
- the cycle's: ``cycle_overruns_total{kind}`` and
  ``stale_cycles_skipped_total`` (scheduler.py);
- the cache's write side: ``write_retries_total{op}`` and
  ``resync_dropped_total`` (cache/cache.py), and
  ``cache_mutation_violations_total{kind}`` (faults/mutation_detector.py);
- crash-consistent failover: ``journal_records_total{state}``
  (recovery/journal.py and the cache's journal hooks),
  ``reconcile_ops_total{op}`` (recovery/reconcile.py), and the watch
  client's ``watch_snapshot_age_seconds`` and ``watch_relists_total{kind}``
  (recovery/watch_client.py);
- federation (federation.py and the cache's conditional binds):
  ``federation_conflicts_total{outcome}``,
  ``federation_node_conflicts_total{node}`` and ``bind_retries_total``;
  the store-backend wire (cache/backend.py): ``store_backend_rtt_seconds{op}``,
  ``store_backend_bytes_total{dir,codec}``, ``store_backend_txn_batch_size``
  and ``backend_pool_in_use``, and ``watch_longpoll_wakeups_total{cause}``
  (server.py's combined ``/backend/v1/watchall`` long-poll; the per-kind
  watch does not write it, as in the JAX package); the leased shard slots
  (``federation.ShardSlotManager``): ``shard_slots_owned``,
  ``shard_slot_owned{slot}``, ``shard_adoptions_total{outcome}``,
  ``shard_handoffs_total{outcome}`` and ``shard_takeover_seconds``;
- ``exchange_batched_iters_total`` (the sharded rung's K-deep exchange);
- the streaming scheduler (streaming.py, scheduler.py's micro-cycles):
  ``time_to_bind_seconds`` (arrival event to bind echo, per pod),
  ``micro_cycles_total{outcome}`` and ``streaming_backlog_pods``;
- pipelined cycles (pipeline.py): ``pipeline_overlap_fraction`` (the
  measured share of the last deferred dispatch that did not block the
  next cycle) and ``pipeline_fence_wait_seconds``;
- ``encode_cache_hits_total``, ``encode_cache_invalidations_total{reason}``
  and ``encode_warm_fraction`` (ops/encode_cache.py);
- ``slo_time_to_bind_seconds`` and ``slo_queue_wait_seconds``
  ``{queue,quantile}`` and ``slo_evicted_queues_total``, set by
  ``obs.slo.publish()``;
- unschedulability forensics (obs/explain.py): ``unschedulable_total{reason}``
  and ``would_fit_if_total{plane}``;
- the fleet rollup (obs/fleet.py): ``fleet_slo_time_to_bind_seconds`` and
  ``fleet_slo_queue_wait_seconds`` ``{queue,quantile}``,
  ``fleet_node_conflicts{node}``, ``fleet_backlog_pods``,
  ``fleet_pods_per_second``, ``fleet_shards_scraped``,
  ``fleet_shard_up{shard}`` and ``fleet_shard_last_scrape_age_seconds{shard}``;
- admission control (admission.py): ``admission_decisions_total{lane,outcome}``,
  ``admission_lane_backlog_pods{lane}``, ``admission_lane_admit_rate{lane}``,
  ``admission_brownout_level``, ``admission_pressure`` and
  ``admission_controller_ticks_total{outcome}``.

OpenMetrics exemplars: with ``KBT_METRICS_EXEMPLARS`` on, an observation
that passes ``exemplar=`` (a trace id: ``observe_time_to_bind``,
``register_federation_conflict``) keeps the latest one per label set, and
the exposition appends ``# {trace_id="..."} value`` to the matching sample
or lowest containing bucket. Storage is gated like rendering.

The tensor arena's ``arena_hbm_bytes{slab}`` and
``arena_hbm_watermark_bytes`` (ops/encode_cache ``TensorArena``) complete
the JAX package's 69 series.
"""

from __future__ import annotations

import os
import threading
from bisect import bisect_left
from typing import Iterable, Optional

import numpy as np

# Buckets: 5ms * 2^k for e2e (metrics.go:41-44), 5us * 2^k for the rest
# (metrics.go:49-72). Values recorded in seconds.
E2E_BUCKETS = tuple(0.005 * 2**k for k in range(12))
FINE_BUCKETS = tuple(5e-6 * 2**k for k in range(18))

EXEMPLARS_ENV = "KBT_METRICS_EXEMPLARS"
_EXEMPLAR_OFF = ("", "0", "false", "off", "no")


def exemplars_enabled() -> bool:
    return os.environ.get(EXEMPLARS_ENV, "").strip().lower() not in _EXEMPLAR_OFF


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
        # label tuple -> (trace_id, value): the latest exemplar per series
        self._exemplars: dict[tuple, tuple[str, float]] = {}
        self._lock = threading.Lock()

    def _series_for(self, key: tuple) -> list:
        series = self._series.get(key)
        if series is None:
            series = self._series[key] = [[0] * (len(self.buckets) + 1), 0.0, 0]
        return series

    def observe(
        self, value: float, labels: Optional[dict[str, str]] = None, exemplar: str | None = None
    ) -> None:
        i = bisect_left(self.buckets, value)  # first bucket with value <= bound
        key = _key(labels)
        with self._lock:
            series = self._series_for(key)
            series[0][i] += 1
            series[1] += value
            series[2] += 1
            if exemplar and exemplars_enabled():
                self._exemplars[key] = (exemplar, value)

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
        self._exemplars: dict[tuple, tuple[str, float]] = {}
        self._lock = threading.Lock()

    def inc(
        self, labels: Optional[dict[str, str]] = None, by: float = 1.0, exemplar: str | None = None
    ) -> None:
        key = _key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + by
            if exemplar and exemplars_enabled():
                self._exemplars[key] = (exemplar, by)

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

    def clear(self) -> None:
        with self._lock:
            self._values.clear()


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

# -- the cache's write side and the mutation detector (cache/, faults/) -------
write_retries = Counter(
    f"{_SUBSYSTEM}_write_retries_total",
    "Write-side retries (with jitter) before the errTasks resync path, by op",
)
cache_mutation_violations = Counter(
    f"{_SUBSYSTEM}_cache_mutation_violations_total",
    "In-place mutations of shared cached cluster objects detected, by kind",
)

# -- crash-consistent failover (recovery/) -------------------------------------
journal_records = Counter(
    f"{_SUBSYSTEM}_journal_records_total",
    "Write-intent journal records appended, by state (intent/confirm/append_failed)",
)
reconcile_ops = Counter(
    f"{_SUBSYSTEM}_reconcile_ops_total",
    "Takeover reconciliation outcomes, by op "
    "(confirmed/redispatched/conflict/rolled_back/aborted)",
)

# -- the cycle's deadline budget and staleness guard (scheduler.py) -----------
cycle_overruns = Counter(
    f"{_SUBSYSTEM}_cycle_overruns_total",
    "Scheduling cycles past their deadline budget, by kind (soft/hard)",
)
resync_dropped = Counter(
    f"{_SUBSYSTEM}_resync_dropped_total",
    "errTasks resync entries dropped terminally after exhausting their retry budget",
)
stale_cycles_skipped = Counter(
    f"{_SUBSYSTEM}_stale_cycles_skipped_total",
    "Scheduling cycles refused because the snapshot exceeded the staleness threshold",
)

# -- the watch client (recovery/watch_client.py) ------------------------------
watch_snapshot_age = Gauge(
    f"{_SUBSYSTEM}_watch_snapshot_age_seconds",
    "Seconds since the watch-fed mirror was last known current (oldest kind)",
)
watch_relists = Counter(
    f"{_SUBSYSTEM}_watch_relists_total",
    "Full re-lists performed by watch clients after 410-Gone, by kind",
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

# -- streaming scheduler (streaming.py) ----------------------------------------
time_to_bind = Histogram(
    f"{_SUBSYSTEM}_time_to_bind_seconds",
    "Arrival-event to bind-ack latency per pod in seconds",
    E2E_BUCKETS,
)
micro_cycles = Counter(
    f"{_SUBSYSTEM}_micro_cycles_total",
    "Streaming micro-cycles run, by outcome "
    "(ok/empty/aborted/fault/stale/degraded)",
)
streaming_backlog = Gauge(
    f"{_SUBSYSTEM}_streaming_backlog_pods",
    "Pods arrived but not yet bound that streaming mode is tracking",
)

# -- sharded federation (federation.py, the cache's conditional writes) --------
federation_conflicts = Counter(
    f"{_SUBSYSTEM}_federation_conflicts_total",
    "Optimistic-concurrency dispatch outcomes, by outcome "
    "(clean/won/retried/lost)",
)
federation_node_conflicts = Counter(
    f"{_SUBSYSTEM}_federation_node_conflicts_total",
    "Optimistic-concurrency bind conflicts attributed to the contended "
    "node, by node (the fleet heatmap's delta source)",
)
bind_retries = Counter(
    f"{_SUBSYSTEM}_bind_retries_total",
    "Gang bind transactions re-sent with a refreshed snapshot version "
    "after a store conflict",
)
store_backend_rtt = Histogram(
    f"{_SUBSYSTEM}_store_backend_rtt_seconds",
    "Store-backend round-trip latency per request in seconds, by op",
    FINE_BUCKETS,
)

# -- wire protocol v2 (cache/backend.py pooled transport) -----------------------
# Power-of-two batch-size buckets: txn batches are small integers, not
# latencies, so the 5us-anchored FINE_BUCKETS would collapse them all
# into +Inf.
BATCH_BUCKETS = tuple(2.0**k for k in range(12))
store_backend_bytes = Counter(
    f"{_SUBSYSTEM}_store_backend_bytes_total",
    "Store-backend protocol bytes moved, by direction (tx/rx) and "
    "negotiated codec (json/binary)",
)
store_backend_txn_batch = Histogram(
    f"{_SUBSYSTEM}_store_backend_txn_batch_size",
    "Conditional-write transactions coalesced per /backend/v1/txn "
    "round trip",
    BATCH_BUCKETS,
)
backend_pool_in_use = Gauge(
    f"{_SUBSYSTEM}_backend_pool_in_use",
    "Persistent store-backend connections currently checked out of the "
    "keep-alive pool (KBT_BACKEND_POOL bounds the pool)",
)
watch_longpoll_wakeups = Counter(
    f"{_SUBSYSTEM}_watch_longpoll_wakeups_total",
    "Long-poll watch returns on the v2 combined endpoint, by cause "
    "(events/timeout)",
)

# -- leased shard slots (federation.ShardSlotManager) ---------------------------
# Dynamic shard ownership: each of the N shard slots is a store lease;
# a scheduler holds its primary slot, adopts orphaned ones, and hands
# slots off for planned moves/rebalancing.
shard_slots_owned = Gauge(
    f"{_SUBSYSTEM}_shard_slots_owned",
    "Shard slots this scheduler currently holds the lease for "
    "(1 = just the primary; more = adopted orphans)",
)
shard_slot_owned = Gauge(
    f"{_SUBSYSTEM}_shard_slot_owned",
    "Per-slot ownership flag for this scheduler (labels: slot; 1 = this "
    "process holds the slot's lease, 0 = it does not)",
)
shard_adoptions = Counter(
    f"{_SUBSYSTEM}_shard_adoptions_total",
    "Orphaned shard-slot adoption attempts, by outcome "
    "(adopted/failed/lost_race/flap_suppressed)",
)
shard_handoffs = Counter(
    f"{_SUBSYSTEM}_shard_handoffs_total",
    "Graceful shard-slot handoffs (planned moves / conflict rebalance), "
    "by outcome (completed/aborted)",
)
shard_takeover_seconds = Histogram(
    f"{_SUBSYSTEM}_shard_takeover_seconds",
    "Measured takeover time per adopted slot: lease acquire through "
    "journal reconciliation and backlog re-ingest, in seconds",
    E2E_BUCKETS,
)

# -- unschedulability forensics (obs/explain.py) -------------------------------
unschedulable_total = Counter(
    f"{_SUBSYSTEM}_unschedulable_total",
    "Gangs left unschedulable by an allocate cycle, by dominant reason "
    "(static/room/ports/resources/starved)",
)
would_fit_if_total = Counter(
    f"{_SUBSYSTEM}_would_fit_if_total",
    "Single-plane relaxations that would make an unschedulable gang "
    "feasible, by plane",
)

# -- pipelined cycles (pipeline.py, KBT_PIPELINE) ------------------------------
pipeline_overlap_fraction = Gauge(
    f"{_SUBSYSTEM}_pipeline_overlap_fraction",
    "Fraction of the last deferred dispatch that overlapped the next "
    "cycle's work (1.0 = fence never waited on, 0.0 = fully serialized)",
)
# -- the sharded rung's K-deep batched exchange (parallel/sharded_block.py) ---
exchange_batched_iters_total = Counter(
    f"{_SUBSYSTEM}_exchange_batched_iters_total",
    "Gang iterations committed straight from a K-deep batched mesh "
    "exchange instead of a per-iteration all-gather",
)
pipeline_fence_wait_seconds = Histogram(
    f"{_SUBSYSTEM}_pipeline_fence_wait_seconds",
    "Time a cycle waited on the previous cycle's dispatch fence before "
    "taking its snapshot",
    FINE_BUCKETS,
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

# -- the fleet rollup (obs/fleet.py, KBT_FLEET) --------------------------------
# Cluster-wide rollups an aggregator computes by scraping peer shards'
# /debug/slo?raw=1 sketches and key counters and merging them: percentiles
# do not average, so merged sketches are the composable path.
fleet_slo_time_to_bind = Gauge(
    f"{_SUBSYSTEM}_fleet_slo_time_to_bind_seconds",
    "Cluster-wide sliding-window time-to-bind quantiles merged from all "
    "scraped shards' sketches (labels: queue, quantile=p50/p90/p99)",
)
fleet_slo_queue_wait = Gauge(
    f"{_SUBSYSTEM}_fleet_slo_queue_wait_seconds",
    "Cluster-wide sliding-window queue-wait quantiles merged from all "
    "scraped shards' sketches (labels: queue, quantile=p50/p90/p99)",
)
_FLEET_SLO_GAUGES = {
    "time_to_bind": fleet_slo_time_to_bind,
    "queue_wait": fleet_slo_queue_wait,
}
fleet_node_conflicts = Gauge(
    f"{_SUBSYSTEM}_fleet_node_conflicts",
    "Per-node bind-conflict heatmap: top-K contended nodes by conflict "
    "delta since the previous fleet scrape, summed across shards (by node)",
)
fleet_backlog = Gauge(
    f"{_SUBSYSTEM}_fleet_backlog_pods",
    "Aggregate arrived-but-unbound backlog summed across scraped shards",
)
fleet_pods_per_second = Gauge(
    f"{_SUBSYSTEM}_fleet_pods_per_second",
    "Aggregate bind throughput across scraped shards, from bind-count "
    "deltas between fleet scrapes",
)
fleet_shards_scraped = Gauge(
    f"{_SUBSYSTEM}_fleet_shards_scraped",
    "Peer shards the fleet aggregator reached on its last scrape "
    "(a drop below the configured peer count means a dark shard)",
)
fleet_shard_up = Gauge(
    f"{_SUBSYSTEM}_fleet_shard_up",
    "Per-peer reachability on the last fleet scrape (labels: shard = "
    "peer URL; 1 = scraped, 0 = dark) — attributes a dark shard before "
    "its slot lease even expires",
)
fleet_shard_scrape_age = Gauge(
    f"{_SUBSYSTEM}_fleet_shard_last_scrape_age_seconds",
    "Seconds since the fleet aggregator last successfully scraped each "
    "peer (labels: shard = peer URL; grows without bound on a dark "
    "shard, -1 = never scraped)",
)

# -- admission control (admission.py, KBT_ADMISSION) ---------------------------
# Per-tenant lanes at the workload API's front door and the backpressure
# controller that retunes them from measured fleet state. Every shed is
# counted here and carried a 429 with Retry-After on the wire.
admission_decisions = Counter(
    f"{_SUBSYSTEM}_admission_decisions_total",
    "Front-door admission decisions, by lane and outcome "
    "(admitted/shed_rate/shed_backlog/shed_brownout/shed_fault)",
)
admission_lane_backlog = Gauge(
    f"{_SUBSYSTEM}_admission_lane_backlog_pods",
    "Admitted-but-unbound pods the gate currently charges to each lane "
    "(labels: lane) — the bounded backlog that 429s when full",
)
admission_lane_rate = Gauge(
    f"{_SUBSYSTEM}_admission_lane_admit_rate",
    "Token-bucket refill rate in pods/s the controller currently grants "
    "each lane (labels: lane)",
)
admission_brownout_level = Gauge(
    f"{_SUBSYSTEM}_admission_brownout_level",
    "Current rung on the brownout ladder (0 = all lanes at configured "
    "rate; higher rungs defer lower-priority tiers first)",
)
admission_pressure = Gauge(
    f"{_SUBSYSTEM}_admission_pressure",
    "Composite overload signal the backpressure controller computed from "
    "merged fleet state (1.0 = at the configured SLO band ceiling)",
)
admission_controller_ticks = Counter(
    f"{_SUBSYSTEM}_admission_controller_ticks_total",
    "Backpressure controller evaluations, by outcome "
    "(steady/escalate/recover/fault/dark)",
)

# -- device-phase telemetry (arena HBM accounting, ops/encode_cache) ---------
arena_hbm_bytes = Gauge(
    f"{_SUBSYSTEM}_arena_hbm_bytes",
    "Device bytes currently held by the tensor arena, by slab",
)
arena_hbm_watermark = Gauge(
    f"{_SUBSYSTEM}_arena_hbm_watermark_bytes",
    "High watermark of total device bytes held by the tensor arena "
    "since process start (the bench's HBM column)",
)

# -- node-class compressed solve (ops/class_solve, KBT_CLASS_COMPRESS) -------
class_solve_classes = Gauge(
    f"{_SUBSYSTEM}_class_solve_classes",
    "Node equivalence classes at the last compressed solve's entry "
    "(the axis the solver actually scanned, padding excluded)",
)
class_solve_compression_ratio = Gauge(
    f"{_SUBSYSTEM}_class_solve_compression_ratio",
    "Valid nodes per valid node class at the last compressed solve's "
    "entry — the node-axis shrink factor; a sustained fall toward 1.0 "
    "means the fleet's shapes have diverged and compression is buying "
    "nothing",
)
class_table_splits = Counter(
    f"{_SUBSYSTEM}_class_table_splits_total",
    "Class-table member movements: in-solve bind splits (a chosen node "
    "leaves its class as a singleton) plus static re-keys from node "
    "churn (encode-cache dirty nodes re-hashed into new classes)",
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


def register_write_retry(op: str) -> None:
    write_retries.inc({"op": op})


def register_cache_mutation(kind: str) -> None:
    cache_mutation_violations.inc({"kind": kind})


def register_journal_records(state: str, n: int = 1) -> None:
    journal_records.inc({"state": state}, by=n)


def register_reconcile_op(op: str, n: int = 1) -> None:
    reconcile_ops.inc({"op": op}, by=n)


def set_watch_snapshot_age(age: float) -> None:
    # +inf (never synced) renders as 'inf' in exposition, which
    # Prometheus accepts; clamp anyway to keep dashboards sane
    watch_snapshot_age.set(min(age, 1e9))


def register_watch_relist(kind: str) -> None:
    watch_relists.inc({"kind": kind})


def register_resync_drop() -> None:
    resync_dropped.inc()


def register_stale_cycle_skip() -> None:
    stale_cycles_skipped.inc()


def register_longpoll_wakeup(cause: str) -> None:
    watch_longpoll_wakeups.inc({"cause": cause})


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


def observe_time_to_bind(seconds: float, exemplar: str | None = None) -> None:
    time_to_bind.observe(seconds, exemplar=exemplar)


def register_micro_cycle(outcome: str) -> None:
    micro_cycles.inc({"outcome": outcome})


def set_streaming_backlog(n: int) -> None:
    streaming_backlog.set(n)


def set_pipeline_overlap_fraction(fraction: float) -> None:
    pipeline_overlap_fraction.set(fraction)


def observe_pipeline_fence_wait(seconds: float) -> None:
    pipeline_fence_wait_seconds.observe(seconds)


def register_federation_conflict(outcome: str, exemplar: str | None = None) -> None:
    federation_conflicts.inc({"outcome": outcome}, exemplar=exemplar)


def register_federation_node_conflict(node: str, n: int = 1) -> None:
    federation_node_conflicts.inc({"node": node}, by=n)


def register_bind_retry() -> None:
    bind_retries.inc()


def observe_store_backend_rtt(op: str, seconds: float) -> None:
    store_backend_rtt.observe(seconds, {"op": op})


def register_store_backend_bytes(direction: str, codec: str, n: int) -> None:
    store_backend_bytes.inc({"dir": direction, "codec": codec}, by=n)


def observe_txn_batch_size(n: int) -> None:
    store_backend_txn_batch.observe(float(n))


def set_backend_pool_in_use(n: int) -> None:
    backend_pool_in_use.set(n)


def set_shard_slots_owned(n: int) -> None:
    shard_slots_owned.set(n)


def set_shard_slot_owned(slot: int, owned: bool) -> None:
    shard_slot_owned.set(1 if owned else 0, {"slot": str(slot)})


def register_shard_adoption(outcome: str) -> None:
    shard_adoptions.inc({"outcome": outcome})


def register_shard_handoff(outcome: str) -> None:
    shard_handoffs.inc({"outcome": outcome})


def observe_shard_takeover(seconds: float) -> None:
    shard_takeover_seconds.observe(seconds)


def register_unschedulable(reason: str) -> None:
    unschedulable_total.inc({"reason": reason})


def register_would_fit_if(plane: str) -> None:
    would_fit_if_total.inc({"plane": plane})


def set_fleet_slo_quantile(kind: str, queue: str, quantile: str, value: float) -> None:
    gauge = _FLEET_SLO_GAUGES.get(kind)
    if gauge is not None:
        gauge.set(value, {"queue": queue, "quantile": quantile})


def set_fleet_node_heatmap(deltas: dict[str, float]) -> None:
    """Replace the per-node conflict heatmap wholesale (top-K only: stale
    nodes drop out rather than linger at their old value)."""
    fleet_node_conflicts.clear()
    for node, value in deltas.items():
        fleet_node_conflicts.set(value, {"node": node})


def set_fleet_backlog(n: float) -> None:
    fleet_backlog.set(n)


def set_fleet_pods_per_second(value: float) -> None:
    fleet_pods_per_second.set(value)


def set_fleet_shards_scraped(n: int) -> None:
    fleet_shards_scraped.set(n)


def set_fleet_shard_up(shard: str, up: bool) -> None:
    fleet_shard_up.set(1 if up else 0, {"shard": shard})


def set_fleet_shard_scrape_age(shard: str, age_s: float) -> None:
    fleet_shard_scrape_age.set(age_s, {"shard": shard})


def register_admission_decision(lane: str, outcome: str) -> None:
    admission_decisions.inc({"lane": lane, "outcome": outcome})


def set_admission_lane_backlog(lane: str, n: int) -> None:
    admission_lane_backlog.set(n, {"lane": lane})


def set_admission_lane_rate(lane: str, rate: float) -> None:
    admission_lane_rate.set(rate, {"lane": lane})


def set_admission_brownout_level(level: int) -> None:
    admission_brownout_level.set(level)


def set_admission_pressure(value: float) -> None:
    admission_pressure.set(value)


def register_admission_controller_tick(outcome: str) -> None:
    admission_controller_ticks.inc({"outcome": outcome})


def set_arena_hbm_bytes(slab: str, nbytes: float) -> None:
    arena_hbm_bytes.set(nbytes, {"slab": slab})


def set_arena_hbm_watermark(nbytes: float) -> None:
    arena_hbm_watermark.set(nbytes)


def set_class_solve_classes(n: int) -> None:
    class_solve_classes.set(n)


def set_class_solve_compression_ratio(ratio: float) -> None:
    class_solve_compression_ratio.set(ratio)


def register_class_table_splits(n: int) -> None:
    class_table_splits.inc(by=n)


def _escape_label_value(value) -> str:
    """Prometheus text-format label escaping: backslash, double quote and
    newline are escaped inside the quoted value, so a queue named ``a"b``
    or a fault reason with a newline cannot corrupt the scrape."""
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _exemplar_of(metric, key) -> tuple[str, float] | None:
    """The OpenMetrics exemplar annotation of one series as ``(suffix,
    value)``, or None; rendered only while KBT_METRICS_EXEMPLARS is on."""
    if not exemplars_enabled():
        return None
    with metric._lock:
        ex = metric._exemplars.get(key)
    if ex is None:
        return None
    trace_id, value = ex
    return (f' # {{trace_id="{_escape_label_value(trace_id)}"}} {value}', value)


def _render_family(metric) -> list[str]:
    lines = [f"# HELP {metric.name} {metric.help}"]
    if isinstance(metric, Histogram):
        lines.append(f"# TYPE {metric.name} histogram")
        for key in metric.label_sets() or [()]:
            snap = metric.snapshot(dict(key) if key else None)
            prefix = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key)
            sep = "," if prefix else ""
            ex = _exemplar_of(metric, key)
            ex_suffix, ex_value = ex if ex else ("", None)
            for boundary, cum in snap["buckets"].items():
                mark = ex_suffix if ex_value is not None and ex_value <= boundary else ""
                if mark:
                    ex_value = None  # the exemplar rides its lowest containing bucket
                lines.append(f'{metric.name}_bucket{{{prefix}{sep}le="{boundary}"}} {cum}{mark}')
            mark = ex_suffix if ex_value is not None else ""
            lines.append(f'{metric.name}_bucket{{{prefix}{sep}le="+Inf"}} {snap["count"]}{mark}')
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
            ex = ""
            if kind == "counter":
                found = _exemplar_of(metric, key)
                ex = found[0] if found else ""
            if key:
                label_str = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key)
                lines.append(f"{metric.name}{{{label_str}}} {value}{ex}")
            else:
                lines.append(f"{metric.name} {value}{ex}")
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
    write_retries,
    cache_mutation_violations,
    journal_records,
    reconcile_ops,
    cycle_overruns,
    resync_dropped,
    stale_cycles_skipped,
    watch_snapshot_age,
    watch_relists,
    encode_cache_hits,
    encode_cache_invalidations,
    encode_warm_fraction,
    time_to_bind,
    micro_cycles,
    streaming_backlog,
    federation_conflicts,
    federation_node_conflicts,
    bind_retries,
    store_backend_rtt,
    store_backend_bytes,
    store_backend_txn_batch,
    backend_pool_in_use,
    watch_longpoll_wakeups,
    shard_slots_owned,
    shard_slot_owned,
    shard_adoptions,
    shard_handoffs,
    shard_takeover_seconds,
    unschedulable_total,
    would_fit_if_total,
    pipeline_overlap_fraction,
    exchange_batched_iters_total,
    pipeline_fence_wait_seconds,
    slo_time_to_bind,
    slo_queue_wait,
    slo_evicted_queues,
    fleet_slo_time_to_bind,
    fleet_slo_queue_wait,
    fleet_node_conflicts,
    fleet_backlog,
    fleet_pods_per_second,
    fleet_shards_scraped,
    fleet_shard_up,
    fleet_shard_scrape_age,
    admission_decisions,
    admission_lane_backlog,
    admission_lane_rate,
    admission_brownout_level,
    admission_pressure,
    admission_controller_ticks,
    arena_hbm_bytes,
    arena_hbm_watermark,
    class_solve_classes,
    class_solve_compression_ratio,
    class_table_splits,
)


def render_prometheus_text() -> str:
    """Prometheus text exposition for every registered series."""
    lines: list[str] = []
    for metric in FAMILIES:
        lines.extend(_render_family(metric))
    return "\n".join(lines) + "\n"
