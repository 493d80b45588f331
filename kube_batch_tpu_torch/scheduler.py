"""The scheduling loop (reference pkg/scheduler/scheduler.go:35-102).

``Scheduler`` owns a cache and drives the session pipeline: ``run(stop)``
starts the cache and runs a cycle every ``schedule_period`` seconds until
``stop`` is set; each cycle (``run_once``) (re-)loads the scheduler
configuration, opens a session over a fresh ``cache.snapshot()``, runs
the configured actions in order under the cycle's deadline budget, and
closes the session — discarding its write-back when the hard budget
aborted the cycle. The cache is a ``cache.SchedulerCache`` over a
``cache.ClusterStore`` in a process (server.py), or ``testing.FakeCache``
for a single cycle:

    from kube_batch_tpu_torch.models import preempt_mix
    from kube_batch_tpu_torch.scheduler import Scheduler
    from kube_batch_tpu_torch.testing import FakeCache

    cache = FakeCache(preempt_mix(2000, 40, seed=1))
    Scheduler(cache, "examples/scheduler-conf-torch.yaml").run_once()
    cache.binder.binds  # "namespace/name" -> node

Divergences from the reference, by design (as in the JAX package):

- the conf file is re-read **every cycle** (the reference loads it once
  at startup, scheduler.go:63-85); a conf push takes effect on the next
  cycle without a restart, and a broken conf keeps the previous good one
  rather than killing the loop;
- the default conf is the JAX package's with the allocate loop solved on
  the card: ``enqueue, torch_allocate, backfill`` over the reference's
  default tiers plus conformance, so a cycle with no conf solves on the
  card (and raises when no card is visible; ``device: cpu`` in a conf
  runs the kernels' plain versions). It leads with ``enqueue``, as the
  JAX package's does: a PodGroup reaches a store ``Pending``, and
  allocate skips a ``Pending`` job, so only the enqueue action lets it
  bind. examples/scheduler-conf-torch.yaml is the same pipeline without
  the enqueue action (for worlds whose PodGroups are already Inqueue, as
  the port's ``testing.build_cluster`` makes them), and
  examples/scheduler-conf-torch-pipeline.yaml runs the whole pipeline
  (enqueue, reclaim, allocate, backfill, preempt).
- ``run`` logs a cycle that raises and goes on with the next, as the
  JAX loop does. It never turns a failed cycle into a CPU cycle: the
  conf's ``device`` decides, and a card-side failure fails the cycle.

Faults, deadlines and telemetry, as in the JAX package:

- each cycle opens a root ``cycle`` span (obs; the ``cycle``,
  ``aborted`` and ``skipped`` attributes) and writes
  ``action_scheduling_latency`` per
  action, ``e2e_scheduling_latency`` and ``schedule_attempts``;
- the conf's ``trace:``, ``explain:`` and ``fleet:`` keys go to
  ``obs.configure``, ``obs.explain.configure`` and ``obs.fleet.configure``
  every cycle (an empty key defers to ``KBT_TRACE``, ``KBT_EXPLAIN`` or
  ``KBT_FLEET``, so the environment still flips each);
  its ``faults:`` key arms ``faults.registry`` when the conf changed;
- the deadline budget (recovery/budget.py): the hard deadline
  (``hard_deadline_s`` or ``KBT_CYCLE_HARD_DEADLINE_S``) aborts a cycle
  before any bind, discards its session, counts
  ``cycle_overruns{kind="hard"}`` and dumps the flight recorder; the soft
  deadline (``soft_deadline_s`` or ``KBT_CYCLE_SOFT_DEADLINE_S``) counts
  ``cycle_overruns{kind="soft"}``, and ``failure_threshold`` consecutive
  soft overruns trip the breaker of the tier the cycle ran on
  (``_arm_tier_downgrade``) when the rung below it is on the same
  device: ``sharded`` always, ``fused`` only on ``device: cpu``. A slow
  fused cycle on a card is counted and logged, and stays on the card;
- the bounded-staleness guard: with ``KBT_MAX_SNAPSHOT_AGE_S`` above 0, a
  cycle whose cache reports a ``snapshot_age()`` past it is refused
  before the session opens (``stale_cycles_skipped_total``, the cycle
  span's ``skipped="stale_snapshot"``, ``last_timings["skipped"]``);
- a cache with a ``cycle`` counter has it advanced every cycle that is
  not refused;
- with ``KBT_CACHE_MUTATION_DETECTOR`` on, a cache with a ``store`` has
  the store's objects digested before the actions and verified after
  (faults/mutation_detector.py): an in-place mutation of a stored object
  raises ``CacheMutationError`` out of ``run_once``.

Streaming and pipelined cycles, as in the JAX package:

- **streaming** (streaming.py; the conf's ``streaming: true`` or
  ``KBT_STREAMING=1``): ``run`` hands over to ``_run_streaming``, which
  runs a full cycle every ``schedule_period`` as the fairness and
  preemption backstop and, in between, wakes on store churn
  (``StreamTrigger`` on the encode cache's dirty feed) and runs
  ``run_micro``: a micro-cycle over the dirty gangs only, against the
  resident node table the last full cycle left (``StreamState``, taken
  from the session before ``close_session`` rebinds it), under a
  ``micro_cycle`` root span. A micro-cycle that cannot finish (stale
  table, the ``stream.micro_cycle`` point, an abort, an error)
  invalidates the table and degrades to a full cycle at once; no arrival
  is dropped. ``micro_cycles_run`` counts them and
  ``micro_cycles_total{outcome}`` meters each outcome; the trigger
  observes ``time_to_bind_seconds`` at each bind echo. On a federated
  cache the trigger absorbs peer shards' binds as occupancy patches, and
  ``on_owned_slots_changed`` seeds adopted gang keys into it;
- **pipelined cycles** (pipeline.py, ``KBT_PIPELINE=1``): each cycle
  first waits on the dispatch fence (a timeout or the ``pipeline.fence``
  point degrades the pipeline, stickily, and skips the cycle); a
  deferred dispatch of one action is joined before the next action runs;
  and when the last action deferred its dispatch, the cycle's tail (the
  streaming harvest, ``close_session``, the e2e metrics, the detector's
  verify) is chained behind the dispatch's Future (``_finish_deferred``)
  so ``run_once`` returns while the binds land.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import kube_batch_tpu_torch.actions  # noqa: F401  (registers the action pipeline)
import kube_batch_tpu_torch.plugins  # noqa: F401  (registers the plugin builders)
from kube_batch_tpu_torch import faults, metrics, obs, pipeline
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.conf import load_scheduler_conf, parse_scheduler_conf, read_scheduler_conf
from kube_batch_tpu_torch.faults import _env_float, mutation_detector
from kube_batch_tpu_torch.framework import close_session, open_session
from kube_batch_tpu_torch.obs import explain as _obs_explain
from kube_batch_tpu_torch.obs import fleet as _obs_fleet
from kube_batch_tpu_torch.recovery.budget import CycleBudget, CycleDeadlineExceeded

log = logging.getLogger(__name__)


DEFAULT_SCHEDULER_CONF = """
actions: "enqueue, torch_allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""


class Scheduler:
    """reference scheduler.go:35-61. ``scheduler_conf`` is a conf file's
    path (None: the default conf); ``hard_deadline_s`` and
    ``soft_deadline_s`` are the cycle's budget (recovery/budget.py; None:
    ``KBT_CYCLE_HARD_DEADLINE_S`` / ``KBT_CYCLE_SOFT_DEADLINE_S``, unset
    or 0: no deadline); ``schedule_period`` is the seconds between the
    starts of ``run``'s cycles."""

    def __init__(
        self,
        cache,
        scheduler_conf: Optional[str] = None,
        hard_deadline_s: Optional[float] = None,
        soft_deadline_s: Optional[float] = None,
        schedule_period: float = 1.0,
    ) -> None:
        self.cache = cache
        self.scheduler_conf = scheduler_conf
        self.schedule_period = schedule_period
        self.actions = []
        self.plugins = []
        self.action_arguments: dict[str, dict[str, str]] = {}
        self._conf_cache: Optional[str] = None
        self._conf_trace = ""
        self._conf_explain = ""
        self._conf_fleet = ""
        if hard_deadline_s is None:
            hard_deadline_s = _env_float("KBT_CYCLE_HARD_DEADLINE_S", 0.0) or None
        if soft_deadline_s is None:
            soft_deadline_s = _env_float("KBT_CYCLE_SOFT_DEADLINE_S", 0.0) or None
        self._hard_deadline = hard_deadline_s
        self._soft_deadline = soft_deadline_s
        # Bounded-staleness guard: refuse to schedule over a snapshot
        # older than this (a watch-fed cache reports its real age; the
        # in-process store reports 0). 0 = guard off.
        self._max_snapshot_age = _env_float("KBT_MAX_SNAPSHOT_AGE_S", 0.0)
        # Consecutive soft overruns, tracked here and not through breaker
        # failures: a slow but successful solve records a breaker success
        # every cycle, which would reset the failures and make the
        # downgrade unreachable.
        self._soft_overruns = 0
        # Wall clock of the last run_once: conf_s, snapshot_s, plugins_s,
        # job_valid_s, one "<action>_s" per action, close_s, run_once_s;
        # "aborted" (the reason) when the hard budget aborted it, and
        # "skipped" when the staleness guard refused it.
        self.last_timings: dict[str, float | str] = {}
        # Streaming mode (streaming.py): event-driven micro-cycles between
        # periodic full cycles, armed by the conf's streaming: key or
        # KBT_STREAMING. _stream_state is set only while _run_streaming is
        # live, and run_once harvests its resident node table through it.
        self._conf_streaming = False
        self._stream_state = None
        self._stream_trigger = None
        self.micro_cycles_run = 0
        # Wall clock of the last run_micro that opened a session: open_s
        # (the job and queue clones and open_session), one "<action>_s"
        # per action, close_s, micro_s.
        self.last_micro_timings: dict[str, float] = {}
        self._load_conf()

    def _load_conf(self) -> None:
        """Load (or re-load) the conf; on failure keep the last good one
        (reference scheduler.go:69-85 falls back to the default)."""
        conf_str = DEFAULT_SCHEDULER_CONF
        if self.scheduler_conf:
            try:
                conf_str = read_scheduler_conf(self.scheduler_conf)
            except OSError as e:
                log.error(
                    "Failed to read scheduler configuration %r, using %s: %s",
                    self.scheduler_conf,
                    "previous" if self._conf_cache else "default",
                    e,
                )
                conf_str = self._conf_cache or DEFAULT_SCHEDULER_CONF
        if conf_str == self._conf_cache:
            # KBT_TRACE / KBT_EXPLAIN / KBT_FLEET flips still apply between
            # conf pushes; the conf value, when set, wins
            obs.configure(self._conf_trace)
            _obs_explain.configure(self._conf_explain)
            _obs_fleet.configure(self._conf_fleet)
            return
        try:
            self.actions, self.plugins, self.action_arguments = load_scheduler_conf(conf_str)
            self._conf_cache = conf_str
            parsed = parse_scheduler_conf(conf_str)
            self._conf_streaming = parsed.streaming
            self._conf_trace = parsed.trace
            obs.configure(parsed.trace)
            self._conf_explain = parsed.explain
            _obs_explain.configure(parsed.explain)
            self._conf_fleet = parsed.fleet
            _obs_fleet.configure(parsed.fleet)
            # Conf-driven fault drills (the faults: key, KBT_FAULTS'
            # grammar): armed only when the conf changed, so a drill's fire
            # counts are not re-armed every cycle.
            if parsed.faults:
                faults.registry.configure(parsed.faults)
        except Exception as e:  # noqa: BLE001 - bad conf must not kill the loop
            if self._conf_cache is None:
                raise
            log.error("Failed to load scheduler configuration, keeping previous: %s", e)

    def run(self, stop: threading.Event, device=None) -> None:
        """Start the cache and loop run_once until ``stop`` is set
        (reference scheduler.go:63-86). A cycle that raises is logged and
        the loop goes on. ``device``: a CUDA device this thread makes
        current before its first cycle, so a conf's bare ``device: cuda``
        names it and not whichever device the thread would default to.
        When streaming mode is armed (the conf's ``streaming:`` key or
        KBT_STREAMING), the fixed-period sleep gives way to the
        event-driven micro-cycle loop; turning the key off returns here
        on that loop's next iteration."""
        if device is not None:
            import torch

            device = torch.device(device)
            if device.type == "cuda":
                torch.cuda.set_device(device)
        self.cache.run()
        self.cache.wait_for_cache_sync()
        while not stop.is_set():
            if self._streaming_on():
                self._run_streaming(stop)
                continue
            start = time.perf_counter()
            try:
                self.run_once()
            except Exception as e:  # noqa: BLE001 - a bad cycle must not kill the loop
                log.error("scheduling cycle failed: %s", e, exc_info=True)
            elapsed = time.perf_counter() - start
            stop.wait(max(0.0, self.schedule_period - elapsed))

    def _streaming_on(self) -> bool:
        from kube_batch_tpu_torch import streaming

        return streaming.enabled() or self._conf_streaming

    def _run_streaming(self, stop: threading.Event) -> None:
        """The streaming loop (streaming.py): full cycles keep running
        every schedule_period as the fairness/preemption backstop; in
        between, the trigger wakes on store churn and micro-cycles drain
        the dirty-gang backlog against the resident node table. Any
        micro-cycle that cannot complete degrades to an immediate full
        cycle: arrivals are never dropped, only served slower."""
        from kube_batch_tpu_torch import streaming

        # Federated cache (duck-typed by its slot-ownership surface):
        # peer shards' binds cross the pod filter as bound-pod
        # adds/deletes; absorb them as occupancy patches instead of
        # degrading to a full cycle per peer bind. Safe because a
        # federated cache forces conditional binds: if the absorbed view
        # ever lags, the store rejects and the retry ladder resyncs.
        absorb = hasattr(self.cache, "set_owned_slots")
        trigger = streaming.StreamTrigger(absorb_external=absorb)
        state = streaming.StreamState()
        self._stream_trigger = trigger
        self._stream_state = state
        log.info("streaming mode on: micro-cycles between full cycles every %.2fs", self.schedule_period)
        # attach immediately before the try: anything between the
        # registration and the protecting finally is one exception away
        # from a leaked listener firing into a dead loop
        trigger.attach()
        try:
            next_full = time.monotonic()  # first full cycle immediately
            while not stop.is_set() and self._streaming_on():
                now = time.monotonic()
                if now >= next_full:
                    try:
                        self.run_once()  # harvests the resident table
                    except Exception as e:  # noqa: BLE001
                        log.error("scheduling cycle failed: %s", e, exc_info=True)
                        state.invalidate("full cycle failed")
                    next_full = time.monotonic() + self.schedule_period
                    continue
                if not trigger.wait(min(next_full - now, 0.5)):
                    continue
                work = trigger.drain()
                handled = False
                try:
                    handled = self.run_micro(work)
                except Exception as e:  # noqa: BLE001
                    log.error("micro-cycle failed: %s; degrading to a full cycle", e, exc_info=True)
                    state.invalidate("micro-cycle failed")
                    metrics.register_micro_cycle("degraded")
                if not handled:
                    next_full = time.monotonic()  # backstop now, not in a period
        finally:
            trigger.detach()
            self._stream_trigger = None
            self._stream_state = None
            log.info("streaming mode off: back to the fixed-period loop")

    def on_owned_slots_changed(self, adopted_keys, removed_keys=()) -> None:
        """Shard-slot ownership changed mid-run (federation.py
        ShardSlotManager adoption/handoff). In streaming mode, seed the
        adopted gang keys into the trigger and prune the handed-off ones:
        the resident node table stays valid (node state did not change),
        so only the adopted keys' gangs need solving and the next
        micro-cycle serves exactly them. In periodic mode the next full
        cycle re-snapshots the widened mirror; nothing to do."""
        trigger = self._stream_trigger
        if trigger is None:
            return
        if removed_keys:
            trigger.prune(set(removed_keys))
        if adopted_keys:
            trigger.seed(set(adopted_keys))

    def run_micro(self, work) -> bool:
        """One micro-cycle over the drained churn. Returns True when the
        backlog was served (or there was nothing to solve); False means
        the caller must run a full cycle now: the resident table was
        stale or invalid, a fault fired, or the cycle aborted on its
        deadline. Either way no arrival is lost: the trigger keeps every
        gang until ``prune`` sees it bound or gone."""
        from kube_batch_tpu_torch.streaming import open_micro_session

        st = self._stream_state
        trigger = self._stream_trigger
        if st is None or trigger is None:
            return False
        # A previous full cycle's deferred dispatch must land before the
        # micro-cycle clones jobs (micro-cycles themselves never defer:
        # their outcome accounting reads the session synchronously).
        if not pipeline.fence.wait():
            metrics.register_micro_cycle("fence")
            log.error(
                "dispatch fence did not clear before micro-cycle; degrading to a full cycle "
                "(pipeline degraded: %s)", pipeline.fence.degraded_reason,
            )
            return False
        if not st.valid:
            metrics.register_micro_cycle("stale")
            log.debug("micro-cycle skipped: resident table invalid (%s)", st.reason)
            return False
        if work.stale:
            st.invalidate(work.stale_reason)
            metrics.register_micro_cycle("stale")
            log.info("resident table stale (%s); degrading to a full cycle", work.stale_reason)
            return False
        micro_start = time.perf_counter()
        with obs.span("micro_cycle", gangs=len(work.gangs)) as mspan:
            if faults.should_fire("stream.micro_cycle"):
                # injected micro-solve failure: invalidate and degrade to
                # the backstop full cycle; the backlog is untouched
                st.invalidate("stream.micro_cycle fault")
                metrics.register_micro_cycle("fault")
                return False
            # no _load_conf() here: a conf reload (a file read and parse)
            # stays a full-cycle affair; the backstop cycle picks up pushes
            # within one schedule_period
            detector = None
            if mutation_detector.enabled():
                store = getattr(self.cache, "store", None)
                if store is not None:
                    detector = mutation_detector.MutationDetector(store)
                    detector.snapshot()
            if hasattr(self.cache, "cycle"):
                self.cache.cycle += 1
                mspan.set_attr("cycle", self.cache.cycle)
            st.apply_node_patches(work.node_patches)
            if work.bound_patches and not st.apply_bound_patches(work.bound_patches):
                # peer-shard occupancy churn the resident table could not
                # absorb: degrade to the backstop full cycle, backlog kept
                metrics.register_micro_cycle("stale")
                log.info(
                    "resident table could not absorb bound-pod churn (%s); degrading to a full cycle",
                    st.reason,
                )
                return False
            cloned, missing = self.cache.clone_jobs_for_stream(work.gangs)
            # A gang is solvable only once enough of it exists: the
            # podgroup's add event lands before its member pods, and a
            # mid-burst drain sees a partial gang; opening a session for
            # either wastes a micro-cycle (the gang gate would discard it).
            # A deferred gang stays in the backlog; its remaining arrivals
            # wake the trigger again, and the backstop full cycle catches
            # any gang that never completes.
            jobs = {}
            settled = set(missing)
            for uid, job in cloned.items():
                pending = job.task_status_index.get(TaskStatus.PENDING)
                if not pending:
                    settled.add(uid)  # fully placed (or empty): nothing to solve
                elif len(job.tasks) >= job.min_available:
                    jobs[uid] = job
            if settled:
                trigger.prune(settled)
            if not jobs:
                metrics.register_micro_cycle("empty")
                return True
            timings: dict[str, float] = {}
            budget = CycleBudget(self._soft_deadline, self._hard_deadline)
            t0 = time.perf_counter()
            ssn = open_micro_session(
                self.cache, self.plugins, self.action_arguments,
                jobs, st.nodes, self.cache.clone_queues_for_stream(),
            )
            timings["open_s"] = time.perf_counter() - t0
            ssn.cycle_budget = budget
            ssn.micro_cycle = True  # torch_allocate reads it for the resident-interpod hint
            aborted: Optional[CycleDeadlineExceeded] = None
            failed = True
            try:
                for action in self.actions:
                    t0 = time.perf_counter()
                    try:
                        action.execute(ssn)
                        metrics.update_action_duration(action.name, time.perf_counter() - t0)
                        budget.check(f"after action {action.name}")
                    except CycleDeadlineExceeded as e:
                        aborted = e
                        break
                    finally:
                        timings[f"{action.name}_s"] = time.perf_counter() - t0
                failed = False
            finally:
                if failed or aborted is not None:
                    # the session may have mutated the resident table before
                    # dying: rebuild it from the next full snapshot
                    st.invalidate("micro-cycle aborted" if aborted else "micro-cycle failed")
                else:
                    done = {
                        uid
                        for uid, job in ssn.jobs.items()
                        if not job.task_status_index.get(TaskStatus.PENDING)
                    }
                    trigger.prune(done)
                t0 = time.perf_counter()
                close_session(ssn, discard=failed or aborted is not None)
                timings["close_s"] = time.perf_counter() - t0
                timings["micro_s"] = time.perf_counter() - micro_start
                self.last_micro_timings = timings
                self.micro_cycles_run += 1
            if aborted is not None:
                metrics.register_micro_cycle("aborted")
                metrics.register_cycle_overrun("hard")
                mspan.set_attr("aborted", str(aborted))
                obs.recorder.dump(reason="hard_deadline", min_interval_s=1.0)
                log.error(
                    "micro-cycle aborted: %s (session discarded; degrading to a full cycle)", aborted,
                )
                return False
            if detector is not None:
                detector.verify()  # raises CacheMutationError on violation
            metrics.register_micro_cycle("ok")
            return True

    def run_once(self) -> None:
        """One scheduling cycle (reference scheduler.go:88-102)."""
        cycle_start = time.perf_counter()
        self._load_conf()  # before the span: a conf push may flip tracing
        timings: dict[str, float | str] = {"conf_s": time.perf_counter() - cycle_start}
        self.last_timings = timings

        with obs.span("cycle") as cspan:
            # Dispatch fence (pipeline.py, KBT_PIPELINE): the previous
            # cycle's deferred dispatch must land before this cycle
            # snapshots, the ordering the synchronous path gets for free.
            # A timeout degrades the pipeline to synchronous cycles
            # (sticky, loud) and skips this cycle; the wedged dispatch
            # stays armed, so the next cycle joins it again.
            if not pipeline.fence.wait():
                cspan.set_attr("skipped", "pipeline_fence")
                timings["skipped"] = "pipeline_fence"
                log.error(
                    "dispatch fence did not clear; skipping this cycle (pipeline degraded: %s)",
                    pipeline.fence.degraded_reason,
                )
                return

            # Bounded-staleness guard: scheduling over a stale mirror binds
            # pods onto nodes that may no longer exist — refuse the cycle
            # and let the mirror catch up (the k8s contract is the same: a
            # scheduler partitioned from the apiserver stops).
            if self._max_snapshot_age > 0:
                age_fn = getattr(self.cache, "snapshot_age", None)
                age = age_fn() if age_fn is not None else 0.0
                if age > self._max_snapshot_age:
                    metrics.register_stale_cycle_skip()
                    cspan.set_attr("skipped", "stale_snapshot")
                    timings["skipped"] = "stale_snapshot"
                    log.error(
                        "snapshot is %.1fs stale (threshold %.1fs); refusing to "
                        "schedule this cycle", age, self._max_snapshot_age,
                    )
                    return

            if hasattr(self.cache, "cycle"):
                self.cache.cycle += 1
                cspan.set_attr("cycle", self.cache.cycle)

            # Cache-mutation detector: digest the store's objects before
            # the plugins and actions run and verify after — any of them
            # mutating shared cluster state in place fires.
            detector = None
            if mutation_detector.enabled():
                store = getattr(self.cache, "store", None)
                if store is not None:
                    detector = mutation_detector.MutationDetector(store)
                    detector.snapshot()

            budget = CycleBudget(self._soft_deadline, self._hard_deadline)
            ssn = open_session(self.cache, self.plugins, self.action_arguments)
            timings.update(ssn.open_timings)
            # Actions read the budget off the session (torch_allocate checks
            # it at solver entry, between segments and at the dispatch
            # barrier).
            ssn.cycle_budget = budget
            aborted: Optional[CycleDeadlineExceeded] = None
            deferred_finish = False
            try:
                for action in self.actions:
                    t0 = time.perf_counter()
                    try:
                        # a previous action's deferred dispatch must land
                        # before the next action reads the session
                        if ssn.deferred_dispatch is not None:
                            pipeline.join_session(ssn)
                        action.execute(ssn)
                        metrics.update_action_duration(action.name, time.perf_counter() - t0)
                        # post-action gate: a cycle already past its hard
                        # budget must not start the next action
                        budget.check(f"after action {action.name}")
                    except CycleDeadlineExceeded as e:
                        aborted = e
                        break
                    finally:
                        timings[f"{action.name}_s"] = time.perf_counter() - t0
            finally:
                if ssn.deferred_dispatch is not None and aborted is None:
                    # Pipelined cycle: the last action's dispatch is in
                    # flight on the kb-write pool. Chain the cycle's tail
                    # (streaming harvest, close, e2e metrics, detector
                    # verify) behind its Future so run_once returns and the
                    # next cycle's encode and solve overlap the dispatch;
                    # the fence keeps the cycles ordered.
                    deferred_finish = True
                    self._finish_deferred(ssn, cycle_start, detector, timings)
                    timings["run_once_s"] = time.perf_counter() - cycle_start
                else:
                    # streaming harvest: take the session's node table
                    # BEFORE close_session rebinds it; micro-cycles solve
                    # against this resident state until the next full cycle
                    if self._stream_state is not None:
                        self._stream_state.adopt_full_cycle(ssn, aborted=aborted is not None)
                    t0 = time.perf_counter()
                    # discard on abort: skip the status write-back so the
                    # cache stays byte-identical to the cycle's start (every
                    # abort point is pre-dispatch)
                    close_session(ssn, discard=aborted is not None)
                    timings["close_s"] = time.perf_counter() - t0
                    metrics.update_e2e_duration(time.perf_counter() - cycle_start)
                    metrics.schedule_attempts.inc()
                    timings["run_once_s"] = time.perf_counter() - cycle_start
            if aborted is not None:
                timings["aborted"] = str(aborted)
                metrics.register_cycle_overrun("hard")
                cspan.set_attr("aborted", str(aborted))
                # the interrupted cycle's spans are what a post-mortem
                # needs: dump the ring (throttled)
                obs.recorder.dump(reason="hard_deadline", min_interval_s=1.0)
                log.error(
                    "scheduling cycle aborted: %s (session discarded; pending gangs "
                    "reschedule next cycle)", aborted,
                )
            elif budget.soft_exceeded():
                self._arm_tier_downgrade(budget)
            else:
                self._soft_overruns = 0  # a cycle within budget clears the streak
            if detector is not None and not deferred_finish:
                detector.verify()  # raises CacheMutationError on violation

    def _finish_deferred(self, ssn, cycle_start: float, detector, timings: dict) -> None:
        """Chain a pipelined cycle's tail behind its deferred dispatch.
        Runs on the kb-write pool thread when the dispatch lands (at once,
        on this thread, when it already has); any failure is logged and
        degrades the pipeline (the synchronous path would have surfaced
        it through run()'s log)."""
        stream_state = self._stream_state

        def _finish(_fut) -> None:
            try:
                if stream_state is not None:
                    stream_state.adopt_full_cycle(ssn, aborted=False)
                t0 = time.perf_counter()
                close_session(ssn)  # joins the (now done) deferred future
                timings["close_s"] = time.perf_counter() - t0
                metrics.update_e2e_duration(time.perf_counter() - cycle_start)
                metrics.schedule_attempts.inc()
                if detector is not None:
                    detector.verify()  # raises CacheMutationError on violation
            except Exception as e:  # noqa: BLE001 - must not kill the pool thread
                log.error("pipelined cycle tail failed: %s", e, exc_info=True)
                pipeline.fence.degrade(f"cycle tail raised {type(e).__name__}: {e}")

        ssn.deferred_dispatch.add_done_callback(_finish)

    def _arm_tier_downgrade(self, budget: CycleBudget) -> None:
        """Soft overrun: consecutive slow cycles trip the breaker of the
        tier that ran them (faults/ladder.py), routing the next cycles one
        rung down. The streak is counted here (see __init__) and the trip
        reuses the breaker automaton: open -> backoff -> half-open probe ->
        close. ``serial`` has no breaker and only logs; so does ``fused`` on
        a card, whose rung below is the CPU: a slow card must not move its
        cycles there."""
        metrics.register_cycle_overrun("soft")
        self._soft_overruns += 1
        solver = next(
            (a for a in self.actions if getattr(a, "last_solver_tier", None) not in (None, "none")),
            None,
        )
        tier = getattr(solver, "last_solver_tier", None)
        device = getattr(solver, "last_device", None)
        ladder = faults.solver_ladder
        breaker = ladder.breakers.get(tier)
        if breaker is None:
            log.warning(
                "cycle exceeded soft deadline (%.2fs > %.2fs) on tier %s (no breaker to arm)",
                budget.elapsed(), budget.soft_s, tier,
            )
            return
        if tier == "fused" and device is not None and device.type == "cuda":
            log.warning(
                "cycle exceeded soft deadline (%.2fs > %.2fs) on the fused rung on %s "
                "(not tripped: the rung below is the CPU)",
                budget.elapsed(), budget.soft_s, device,
            )
            return
        if self._soft_overruns >= breaker.failure_threshold:
            ladder.trip(tier)
            self._soft_overruns = 0
            log.warning(
                "cycle exceeded soft deadline (%.2fs > %.2fs) repeatedly; tripped solver tier %s "
                "(the ladder downgrades until the recovery probe closes it)",
                budget.elapsed(), budget.soft_s, tier,
            )
        else:
            log.warning(
                "cycle exceeded soft deadline (%.2fs > %.2fs) on tier %s "
                "(downgrade trips after %d consecutive overruns)",
                budget.elapsed(), budget.soft_s, tier, breaker.failure_threshold,
            )
