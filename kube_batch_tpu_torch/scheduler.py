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

The JAX package's scheduler also loops on a period, streams
micro-cycles, fences pipelined dispatch, arms a solver-tier downgrade on
soft overruns, checks the cache for mutation, and meters and traces each
cycle; those belong to later slices of this port.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import kube_batch_tpu_torch.actions  # noqa: F401  (registers the action pipeline)
import kube_batch_tpu_torch.plugins  # noqa: F401  (registers the plugin builders)
from kube_batch_tpu_torch.conf import load_scheduler_conf, read_scheduler_conf
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
    path (None: the default conf); ``hard_deadline_s`` is the cycle's hard
    budget (recovery/budget.py; None: no deadline)."""

    def __init__(
        self,
        cache,
        scheduler_conf: Optional[str] = None,
        hard_deadline_s: Optional[float] = None,
    ) -> None:
        self.cache = cache
        self.scheduler_conf = scheduler_conf
        self.actions = []
        self.plugins = []
        self.action_arguments: dict[str, dict[str, str]] = {}
        self._conf_cache: Optional[str] = None
        self._hard_deadline = hard_deadline_s
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
            return
        try:
            self.actions, self.plugins, self.action_arguments = load_scheduler_conf(conf_str)
            self._conf_cache = conf_str
        except Exception as e:  # noqa: BLE001 - bad conf must not kill the loop
            if self._conf_cache is None:
                raise
            log.error("Failed to load scheduler configuration, keeping previous: %s", e)

    def run_once(self) -> None:
        """One scheduling cycle (reference scheduler.go:88-102)."""
        cycle_start = time.perf_counter()
        self._load_conf()
        timings: dict[str, float | str] = {"conf_s": time.perf_counter() - cycle_start}
        self.last_timings = timings

        budget = CycleBudget(hard_s=self._hard_deadline)
        ssn = open_session(self.cache, self.plugins, self.action_arguments)
        timings.update(ssn.open_timings)
        # Actions read the budget off the session (torch_allocate checks it
        # at solver entry, between segments and at the dispatch barrier).
        ssn.cycle_budget = budget
        aborted: Optional[CycleDeadlineExceeded] = None
        try:
            for action in self.actions:
                t0 = time.perf_counter()
                try:
                    action.execute(ssn)
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
            # stays byte-identical to the cycle's start (every abort point
            # is pre-dispatch)
            close_session(ssn, discard=aborted is not None)
            timings["close_s"] = time.perf_counter() - t0
            timings["run_once_s"] = time.perf_counter() - cycle_start
        if aborted is not None:
            timings["aborted"] = str(aborted)
            log.error(
                "scheduling cycle aborted: %s (session discarded; pending gangs "
                "reschedule next cycle)", aborted,
            )
