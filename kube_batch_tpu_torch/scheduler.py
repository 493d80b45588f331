"""The scheduling cycle (reference pkg/scheduler/scheduler.go:35-102).

``Scheduler`` owns a cache and drives the session pipeline: each cycle
(``run_once``) it (re-)loads the scheduler configuration, opens a session
over a fresh ``cache.snapshot()``, runs the configured actions in order
under the cycle's deadline budget, and closes the session — discarding
its write-back when the hard budget aborted the cycle.

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
- the default conf is ``examples/scheduler-conf-torch.yaml``'s:
  ``torch_allocate, backfill`` over the reference's default tiers plus
  conformance, so a cycle with no conf solves on the card (and raises
  when no card is visible; ``device: cpu`` in a conf runs the kernels'
  plain versions). The JAX package's default leads with ``enqueue``; the
  port's builders give PodGroups the Inqueue phase the enqueue action
  would, and examples/scheduler-conf-torch-pipeline.yaml runs the whole
  pipeline (enqueue, reclaim, allocate, backfill, preempt).

Faults, deadlines and telemetry, as in the JAX package:

- each cycle opens a root ``cycle`` span (obs; the ``aborted``
  attribute) and writes ``action_scheduling_latency`` per
  action, ``e2e_scheduling_latency`` and ``schedule_attempts``;
- the conf's ``trace:`` key goes to ``obs.configure`` every cycle (an
  empty key defers to ``KBT_TRACE``, so the environment still flips it);
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
  fused cycle on a card is counted and logged, and stays on the card.

The JAX package's scheduler also loops on a period, streams
micro-cycles, fences pipelined dispatch, checks the cache for mutation
and refuses a cycle over a stale snapshot (``KBT_MAX_SNAPSHOT_AGE_S``,
read off a cache that reports its age); those come with the port's
later items (ROADMAP A9-A10).
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import kube_batch_tpu_torch.actions  # noqa: F401  (registers the action pipeline)
import kube_batch_tpu_torch.plugins  # noqa: F401  (registers the plugin builders)
from kube_batch_tpu_torch import faults, metrics, obs
from kube_batch_tpu_torch.conf import load_scheduler_conf, parse_scheduler_conf, read_scheduler_conf
from kube_batch_tpu_torch.faults import _env_float
from kube_batch_tpu_torch.framework import close_session, open_session
from kube_batch_tpu_torch.recovery.budget import CycleBudget, CycleDeadlineExceeded

log = logging.getLogger(__name__)


DEFAULT_SCHEDULER_CONF = """
actions: "torch_allocate, backfill"
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
    or 0: no deadline)."""

    def __init__(
        self,
        cache,
        scheduler_conf: Optional[str] = None,
        hard_deadline_s: Optional[float] = None,
        soft_deadline_s: Optional[float] = None,
    ) -> None:
        self.cache = cache
        self.scheduler_conf = scheduler_conf
        self.actions = []
        self.plugins = []
        self.action_arguments: dict[str, dict[str, str]] = {}
        self._conf_cache: Optional[str] = None
        self._conf_trace = ""
        if hard_deadline_s is None:
            hard_deadline_s = _env_float("KBT_CYCLE_HARD_DEADLINE_S", 0.0) or None
        if soft_deadline_s is None:
            soft_deadline_s = _env_float("KBT_CYCLE_SOFT_DEADLINE_S", 0.0) or None
        self._hard_deadline = hard_deadline_s
        self._soft_deadline = soft_deadline_s
        # Consecutive soft overruns, tracked here and not through breaker
        # failures: a slow but successful solve records a breaker success
        # every cycle, which would reset the failures and make the
        # downgrade unreachable.
        self._soft_overruns = 0
        # Wall clock of the last run_once: conf_s, snapshot_s, plugins_s,
        # job_valid_s, one "<action>_s" per action, close_s, run_once_s;
        # and "aborted" (the reason) when the hard budget aborted it.
        self.last_timings: dict[str, float | str] = {}
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
            # KBT_TRACE flips still apply between conf pushes; the conf
            # value, when set, wins
            obs.configure(self._conf_trace)
            return
        try:
            self.actions, self.plugins, self.action_arguments = load_scheduler_conf(conf_str)
            self._conf_cache = conf_str
            parsed = parse_scheduler_conf(conf_str)
            self._conf_trace = parsed.trace
            obs.configure(parsed.trace)
            # Conf-driven fault drills (the faults: key, KBT_FAULTS'
            # grammar): armed only when the conf changed, so a drill's fire
            # counts are not re-armed every cycle.
            if parsed.faults:
                faults.registry.configure(parsed.faults)
        except Exception as e:  # noqa: BLE001 - bad conf must not kill the loop
            if self._conf_cache is None:
                raise
            log.error("Failed to load scheduler configuration, keeping previous: %s", e)

    def run_once(self) -> None:
        """One scheduling cycle (reference scheduler.go:88-102)."""
        cycle_start = time.perf_counter()
        self._load_conf()  # before the span: a conf push may flip tracing
        timings: dict[str, float | str] = {"conf_s": time.perf_counter() - cycle_start}
        self.last_timings = timings

        with obs.span("cycle") as cspan:
            budget = CycleBudget(self._soft_deadline, self._hard_deadline)
            ssn = open_session(self.cache, self.plugins, self.action_arguments)
            timings.update(ssn.open_timings)
            # Actions read the budget off the session (torch_allocate checks
            # it at solver entry, between segments and at the dispatch
            # barrier).
            ssn.cycle_budget = budget
            aborted: Optional[CycleDeadlineExceeded] = None
            try:
                for action in self.actions:
                    t0 = time.perf_counter()
                    try:
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
                t0 = time.perf_counter()
                # discard on abort: skip the status write-back so the cache
                # stays byte-identical to the cycle's start (every abort
                # point is pre-dispatch)
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
