"""Session: the per-cycle scheduling world + tiered plugin-fn dispatch
(reference pkg/scheduler/framework/session.go:37-423,
session_plugins.go:25-440, framework.go:30-63).

Dispatch semantics (the heart of the policy engine, pinned by unit tests):

- job/queue/task order: chain tiers in order, first non-zero comparison
  wins; fallback = creation-time then UID (session_plugins.go:253-341).
- predicates: AND across every enabled plugin; first failure raises
  (session_plugins.go:344-361).
- node order: sum of scores across enabled plugins (:364-384).
- preemptable/reclaimable: within a tier victims are the intersection of
  every enabled plugin's candidate set; the first tier returning a
  non-None set decides (:90-172).
- overused: OR (:175-189). job ready/pipelined: AND (:192-231).
- job valid: first failure wins (:234-250).

Deviation (documented): the reference runs its JobValid gate inside
openSession *before* tiers are assigned and plugins are registered
(session.go:90-112 vs framework.go:30-51), so the gate can never fire —
dead code upstream. Here the gate runs after plugin registration, making
gang's minMember validation actually reject invalid jobs at session open,
which is the documented intent (SURVEY.md section 2.4).

Telemetry, as in the JAX package: ``open_session`` takes the snapshot
under a ``snapshot`` span and ``close_session`` writes PodGroup statuses
back under a ``commit`` span (obs); every plugin's open and close hooks
feed ``plugin_scheduling_latency``, and each serial dispatch feeds
``task_scheduling_latency`` and the SLO accountant's ``queue_wait``.
``open_session`` also records its phases' wall clock in
``Session.open_timings``. Under pipelined cycles (``KBT_PIPELINE``,
pipeline.py) ``close_session`` first joins the session's deferred
post-solve dispatch (``Session.deferred_dispatch``); a dispatch that
raised is logged and degrades the pipeline, and the session closes as the
synchronous path would.
"""

from __future__ import annotations

import logging
import time
import uuid as _uuid
from typing import TYPE_CHECKING, Callable, Optional

if TYPE_CHECKING:
    # runtime import stays inside Session.statement() — statement.py
    # imports this module's Session for ITS annotations (same cycle)
    from kube_batch_tpu_torch.framework.statement import Statement

from kube_batch_tpu_torch import metrics, obs
from kube_batch_tpu_torch.api.job_info import JobInfo, TaskInfo
from kube_batch_tpu_torch.api.node_info import NodeInfo
from kube_batch_tpu_torch.api.queue_info import QueueInfo
from kube_batch_tpu_torch.api.types import TaskStatus, ValidateResult, allocated_status
from kube_batch_tpu_torch.apis.types import (
    POD_GROUP_UNSCHEDULABLE_TYPE,
    PodGroupCondition,
    PodGroupPhase,
    PodGroupStatus,
)
from kube_batch_tpu_torch.conf import Tier
from kube_batch_tpu_torch.framework.arguments import Arguments
from kube_batch_tpu_torch.framework.event import Event, EventHandler
from kube_batch_tpu_torch.framework.interface import Cache, Plugin
from kube_batch_tpu_torch.framework.registry import get_plugin_builder

_log = logging.getLogger(__name__)


class Session:
    """reference session.go:37-63."""

    def __init__(self, cache: Cache) -> None:
        self.uid: str = str(_uuid.uuid4())
        self.cache = cache
        # Monotonic counter bumped by every session-state mutation
        # (allocate/pipeline/evict and Statement do/undo ops); plugins use
        # it to invalidate per-task caches (nodeorder's InterPodAffinity
        # memo) without recomputing per (task, node) call.
        self.state_seq: int = 0

        self.jobs: dict[str, JobInfo] = {}
        self.nodes: dict[str, NodeInfo] = {}
        self.queues: dict[str, QueueInfo] = {}
        self.tiers: list[Tier] = []
        # Per-action arguments from the conf's optional `actionArguments`
        # map (an extension over the reference schema — the reference has
        # no action-level knobs; ours carries e.g. torch_allocate's device
        # and mesh selection). Keyed by action name.
        self.action_arguments: dict[str, dict[str, str]] = {}

        # The cycle's deadline budget (recovery/budget.py), set by the
        # scheduler; actions check it at their pre-dispatch boundaries.
        self.cycle_budget = None
        # Wall clock of open_session's phases: snapshot_s, plugins_s
        # (every plugin's on_session_open), job_valid_s (the gate).
        self.open_timings: dict[str, float] = {}
        # Pipelined cycles (KBT_PIPELINE): the Future of this session's
        # in-flight post-solve dispatch, set by torch_allocate when it
        # defers the phase onto the kb-write pool. close_session joins it
        # before the commit write-back; the scheduler's actions loop joins
        # it before running a later action over the same session.
        self.deferred_dispatch = None
        # A streaming micro-cycle's session (scheduler.run_micro):
        # torch_allocate reads it for the resident-interpod hint and never
        # defers a micro-cycle's dispatch.
        self.micro_cycle = False

        self.plugins: dict[str, Plugin] = {}
        self.event_handlers: list[EventHandler] = []
        self.job_order_fns: dict[str, Callable] = {}
        self.queue_order_fns: dict[str, Callable] = {}
        self.task_order_fns: dict[str, Callable] = {}
        self.predicate_fns: dict[str, Callable] = {}
        self.node_order_fns: dict[str, Callable] = {}
        self.node_map_fns: dict[str, Callable] = {}
        self.node_reduce_fns: dict[str, Callable] = {}
        self.preemptable_fns: dict[str, Callable] = {}
        self.reclaimable_fns: dict[str, Callable] = {}
        self.overused_fns: dict[str, Callable] = {}
        self.job_ready_fns: dict[str, Callable] = {}
        self.job_pipelined_fns: dict[str, Callable] = {}
        self.job_valid_fns: dict[str, Callable] = {}

    def bump_state(self) -> None:
        """THE session-state mutation hook: every allocate/pipeline/evict,
        Statement do/undo op, and the bulk replay advances ``state_seq``
        through here (never by touching the counter directly). One site
        means one place to observe mutation: plugin score memos key off
        the counter."""
        self.state_seq += 1

    # -- fn registration (session_plugins.go:25-88) -------------------------

    def add_job_order_fn(self, name: str, fn: Callable) -> None:
        self.job_order_fns[name] = fn

    def add_queue_order_fn(self, name: str, fn: Callable) -> None:
        self.queue_order_fns[name] = fn

    def add_task_order_fn(self, name: str, fn: Callable) -> None:
        self.task_order_fns[name] = fn

    def add_predicate_fn(self, name: str, fn: Callable) -> None:
        self.predicate_fns[name] = fn

    def add_node_order_fn(self, name: str, fn: Callable) -> None:
        self.node_order_fns[name] = fn

    def add_node_map_fn(self, name: str, fn: Callable) -> None:
        self.node_map_fns[name] = fn

    def add_node_reduce_fn(self, name: str, fn: Callable) -> None:
        self.node_reduce_fns[name] = fn

    def add_preemptable_fn(self, name: str, fn: Callable) -> None:
        self.preemptable_fns[name] = fn

    def add_reclaimable_fn(self, name: str, fn: Callable) -> None:
        self.reclaimable_fns[name] = fn

    def add_overused_fn(self, name: str, fn: Callable) -> None:
        self.overused_fns[name] = fn

    def add_job_ready_fn(self, name: str, fn: Callable) -> None:
        self.job_ready_fns[name] = fn

    def add_job_pipelined_fn(self, name: str, fn: Callable) -> None:
        self.job_pipelined_fns[name] = fn

    def add_job_valid_fn(self, name: str, fn: Callable) -> None:
        self.job_valid_fns[name] = fn

    def add_event_handler(self, eh: EventHandler) -> None:
        self.event_handlers.append(eh)

    # -- tiered dispatch ----------------------------------------------------

    def _victims(
        self,
        fns: dict[str, Callable],
        flag: str,
        evictor: TaskInfo,
        evictees: list[TaskInfo],
    ) -> list[TaskInfo]:
        """Tiered victim-set intersection (session_plugins.go:90-172):
        within a tier, victims = intersection across enabled plugins; the
        first tier whose intersection is non-empty wins. Go parity note:
        the reference's early return checks ``victims != nil``, but Go
        slices are nil whenever empty here — plugins build victim lists
        with append (nil when none) and so does the intersection — so an
        empty result always falls through to the next tier."""
        for tier in self.tiers:
            victims: Optional[list[TaskInfo]] = None
            for plugin in tier.plugins:
                if not getattr(plugin, flag, None):
                    continue
                fn = fns.get(plugin.name)
                if fn is None:
                    continue
                candidates = fn(evictor, evictees) or []
                if victims is None:
                    victims = list(candidates)
                else:
                    candidate_uids = {c.uid for c in candidates}
                    victims = [v for v in victims if v.uid in candidate_uids]
            if victims:
                return victims
        return []

    def preemptable(self, preemptor: TaskInfo, preemptees: list[TaskInfo]) -> list[TaskInfo]:
        return self._victims(self.preemptable_fns, "enabled_preemptable", preemptor, preemptees)

    def reclaimable(self, reclaimer: TaskInfo, reclaimees: list[TaskInfo]) -> list[TaskInfo]:
        return self._victims(self.reclaimable_fns, "enabled_reclaimable", reclaimer, reclaimees)

    def overused(self, queue: QueueInfo) -> bool:
        """OR across plugins (session_plugins.go:175-189; note the
        reference does not gate this on an enable flag)."""
        for tier in self.tiers:
            for plugin in tier.plugins:
                fn = self.overused_fns.get(plugin.name)
                if fn is not None and fn(queue):
                    return True
        return False

    def job_ready(self, job: JobInfo) -> bool:
        """AND (session_plugins.go:192-210)."""
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.enabled_job_ready:
                    continue
                fn = self.job_ready_fns.get(plugin.name)
                if fn is not None and not fn(job):
                    return False
        return True

    def job_pipelined(self, job: JobInfo) -> bool:
        """AND (session_plugins.go:213-231)."""
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.enabled_job_pipelined:
                    continue
                fn = self.job_pipelined_fns.get(plugin.name)
                if fn is not None and not fn(job):
                    return False
        return True

    def job_valid(self, job: JobInfo) -> Optional[ValidateResult]:
        """First failure wins (session_plugins.go:234-250; note the
        reference does not gate this on an enable flag)."""
        for tier in self.tiers:
            for plugin in tier.plugins:
                fn = self.job_valid_fns.get(plugin.name)
                if fn is None:
                    continue
                vr = fn(job)
                if vr is not None and not vr.passed:
                    return vr
        return None

    def job_order_fn(self, l: JobInfo, r: JobInfo) -> bool:
        """First non-zero across tiers; fallback creation-time then UID
        (session_plugins.go:253-277)."""
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.enabled_job_order:
                    continue
                fn = self.job_order_fns.get(plugin.name)
                if fn is None:
                    continue
                j = fn(l, r)
                if j != 0:
                    return j < 0
        if l.creation_timestamp == r.creation_timestamp:
            return l.uid < r.uid
        return l.creation_timestamp < r.creation_timestamp

    def queue_order_fn(self, l: QueueInfo, r: QueueInfo) -> bool:
        """session_plugins.go:280-305."""
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.enabled_queue_order:
                    continue
                fn = self.queue_order_fns.get(plugin.name)
                if fn is None:
                    continue
                j = fn(l, r)
                if j != 0:
                    return j < 0
        lt = l.queue.metadata.creation_timestamp
        rt = r.queue.metadata.creation_timestamp
        if lt == rt:
            return l.uid < r.uid
        return lt < rt

    def task_compare_fns(self, l: TaskInfo, r: TaskInfo) -> int:
        """session_plugins.go:308-326."""
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.enabled_task_order:
                    continue
                fn = self.task_order_fns.get(plugin.name)
                if fn is None:
                    continue
                j = fn(l, r)
                if j != 0:
                    return j
        return 0

    def task_order_fn(self, l: TaskInfo, r: TaskInfo) -> bool:
        """session_plugins.go:329-341."""
        res = self.task_compare_fns(l, r)
        if res != 0:
            return res < 0
        lt = l.pod.metadata.creation_timestamp
        rt = r.pod.metadata.creation_timestamp
        if lt == rt:
            return l.uid < r.uid
        return lt < rt

    def predicate_fn(self, task: TaskInfo, node: NodeInfo) -> None:
        """AND across enabled plugins; raises on first failure
        (session_plugins.go:344-361)."""
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.enabled_predicate:
                    continue
                fn = self.predicate_fns.get(plugin.name)
                if fn is not None:
                    fn(task, node)  # raises PredicateError on failure

    def node_order_fn(self, task: TaskInfo, node: NodeInfo) -> float:
        """Sum of scores (session_plugins.go:364-384)."""
        total = 0.0
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.enabled_node_order:
                    continue
                fn = self.node_order_fns.get(plugin.name)
                if fn is not None:
                    total += fn(task, node)
        return total

    def node_order_map_fn(self, task: TaskInfo, node: NodeInfo) -> tuple[dict[str, float], float]:
        """Map phase: per-plugin map scores + summed order score
        (session_plugins.go:391-417)."""
        node_score_map: dict[str, float] = {}
        order_score = 0.0
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.enabled_node_order:
                    continue
                fn = self.node_order_fns.get(plugin.name)
                if fn is not None:
                    order_score += fn(task, node)
                mfn = self.node_map_fns.get(plugin.name)
                if mfn is not None:
                    node_score_map[plugin.name] = mfn(task, node)
        return node_score_map, order_score

    def node_order_reduce_fn(
        self, task: TaskInfo, plugin_node_scores: dict[str, list[tuple[str, int]]]
    ) -> dict[str, float]:
        """Reduce phase: per-node sum after optional plugin normalization
        (session_plugins.go:420-440)."""
        node_scores: dict[str, float] = {}
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.enabled_node_order:
                    continue
                rfn = self.node_reduce_fns.get(plugin.name)
                if rfn is None:
                    continue
                scores = plugin_node_scores.get(plugin.name, [])
                rfn(task, scores)
                for host, score in scores:
                    node_scores[host] = node_scores.get(host, 0.0) + score
        return node_scores

    # -- session mutations (session.go:191-362) -----------------------------

    def statement(self) -> "Statement":
        from kube_batch_tpu_torch.framework.statement import Statement

        return Statement(self)

    def pipeline(self, task: TaskInfo, hostname: str) -> None:
        """Assign onto releasing resources; session-only, no bind
        (session.go:198-238)."""
        self.bump_state()
        job = self.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job} when pipelining")
        job.update_task_status(task, TaskStatus.PIPELINED)
        task.node_name = hostname
        node = self.nodes.get(hostname)
        if node is None:
            raise KeyError(f"failed to find node {hostname}")
        node.add_task(task)
        for eh in self.event_handlers:
            if eh.allocate_func is not None:
                eh.allocate_func(Event(task))

    def allocate(self, task: TaskInfo, hostname: str) -> None:
        """Allocate idle resources; dispatch the whole gang once JobReady
        (the gang barrier, session.go:241-296)."""
        self.bump_state()
        self.cache.allocate_volumes(task, hostname)
        job = self.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job}")
        job.update_task_status(task, TaskStatus.ALLOCATED)
        task.node_name = hostname
        node = self.nodes.get(hostname)
        if node is None:
            raise KeyError(f"failed to find node {hostname}")
        node.add_task(task)
        for eh in self.event_handlers:
            if eh.allocate_func is not None:
                eh.allocate_func(Event(task))
        if self.job_ready(job):
            for t in list(job.task_status_index.get(TaskStatus.ALLOCATED, {}).values()):
                self._dispatch(t)

    def _dispatch(self, task: TaskInfo) -> None:
        """session.go:298-322. A failed volume bind routes the task
        through the cache's errTasks resync queue (self-heal: the task
        re-syncs to its store state and is rescheduled next cycle) and
        propagates, leaving later gang members undispatched exactly like
        the reference's early return."""
        try:
            self.cache.bind_volumes(task)
        except Exception:
            resync = getattr(self.cache, "resync_task", None)
            if resync is not None:
                resync(task)
            raise
        self.cache.bind(task, task.node_name)
        job = self.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job}")
        job.update_task_status(task, TaskStatus.BINDING)
        wait = max(0.0, time.time() - task.pod.metadata.creation_timestamp)
        metrics.update_task_schedule_duration(wait)
        obs.slo.observe("queue_wait", job.queue, wait)

    def evict(self, reclaimee: TaskInfo, reason: str) -> None:
        """session.go:325-362."""
        self.bump_state()
        self.cache.evict(reclaimee, reason)
        job = self.jobs.get(reclaimee.job)
        if job is None:
            raise KeyError(f"failed to find job {reclaimee.job}")
        job.update_task_status(reclaimee, TaskStatus.RELEASING)
        node = self.nodes.get(reclaimee.node_name)
        if node is not None:
            node.update_task(reclaimee)
        for eh in self.event_handlers:
            if eh.deallocate_func is not None:
                eh.deallocate_func(Event(reclaimee))

    def update_job_condition(self, job_info: JobInfo, cond: PodGroupCondition) -> None:
        """Replace-or-append by condition type (session.go:365-387)."""
        job = self.jobs.get(job_info.uid)
        if job is None:
            raise KeyError(f"failed to find job {job_info.namespace}/{job_info.name}")
        conditions = job.pod_group.status.conditions
        for i, c in enumerate(conditions):
            if c.type == cond.type:
                conditions[i] = cond
                return
        conditions.append(cond)

    def __repr__(self) -> str:
        return (
            f"Session {self.uid}: jobs {len(self.jobs)}, nodes {len(self.nodes)}, "
            f"queues {len(self.queues)}"
        )


def _job_status(ssn: Session, job: JobInfo) -> PodGroupStatus:
    """Recompute PodGroup status at session close (session.go:150-188).
    Parity note: the reference phases to Running only when allocated is
    *strictly greater* than MinMember (session.go:176) — kept as-is."""
    status = job.pod_group.status
    unschedulable = any(
        c.type == POD_GROUP_UNSCHEDULABLE_TYPE
        and c.status == "True"
        and c.transition_id == ssn.uid
        for c in status.conditions
    )
    if job.task_status_index.get(TaskStatus.RUNNING) and unschedulable:
        status.phase = PodGroupPhase.UNKNOWN
    else:
        allocated = sum(
            len(tasks)
            for st, tasks in job.task_status_index.items()
            if allocated_status(st)
        )
        if allocated > job.pod_group.spec.min_member:
            status.phase = PodGroupPhase.RUNNING
        elif job.pod_group.status.phase != PodGroupPhase.INQUEUE:
            status.phase = PodGroupPhase.PENDING
    status.running = len(job.task_status_index.get(TaskStatus.RUNNING, {}))
    status.failed = len(job.task_status_index.get(TaskStatus.FAILED, {}))
    status.succeeded = len(job.task_status_index.get(TaskStatus.SUCCEEDED, {}))
    return status


def open_session(
    cache: Cache,
    tiers: list[Tier],
    action_arguments: Optional[dict[str, dict[str, str]]] = None,
    world: Optional[tuple[dict, dict, dict]] = None,
) -> Session:
    """Snapshot + plugin instantiation + JobValid gate
    (framework.go:30-51 + session.go:66-119; gate ordering fixed, see
    module docstring).

    ``world`` — an explicit ``(jobs, nodes, queues)`` triple instead of a
    fresh ``cache.snapshot()``; everything downstream (plugin
    registration, JobValid gate, actions, close_session) is identical to
    a full cycle."""
    ssn = Session(cache)
    ssn.tiers = tiers
    ssn.action_arguments = action_arguments or {}

    t0 = time.perf_counter()
    if world is None:
        with obs.span("snapshot") as sspan:
            snapshot = cache.snapshot()
            ssn.jobs = snapshot.jobs
            ssn.nodes = snapshot.nodes
            ssn.queues = snapshot.queues
            sspan.set_attr("jobs", len(ssn.jobs))
            sspan.set_attr("nodes", len(ssn.nodes))
    else:
        ssn.jobs, ssn.nodes, ssn.queues = world
    t1 = time.perf_counter()

    for tier in tiers:
        for option in tier.plugins:
            builder = get_plugin_builder(option.name)
            if builder is None:
                continue
            plugin = builder(Arguments(option.arguments))
            ssn.plugins[plugin.name] = plugin

    for plugin in ssn.plugins.values():
        start = time.perf_counter()
        plugin.on_session_open(ssn)
        metrics.update_plugin_duration(plugin.name, "OnSessionOpen", time.perf_counter() - start)
    t2 = time.perf_counter()

    # JobValid gate: reject invalid jobs (gang minMember) and mark them
    # Unschedulable (session.go:90-112).
    for job in list(ssn.jobs.values()):
        if gate_exempt(job):
            continue
        vr = ssn.job_valid(job)
        if vr is not None and not vr.passed:
            if job.pod_group is not None:
                ssn.update_job_condition(
                    job,
                    PodGroupCondition(
                        type=POD_GROUP_UNSCHEDULABLE_TYPE,
                        status="True",
                        transition_id=ssn.uid,
                        last_transition_time=time.time(),
                        reason=vr.reason,
                        message=vr.message,
                    ),
                )
            del ssn.jobs[job.uid]
    ssn.open_timings = {
        "snapshot_s": t1 - t0,
        "plugins_s": t2 - t1,
        "job_valid_s": time.perf_counter() - t2,
    }
    return ssn


def gate_exempt(job: JobInfo) -> bool:
    """Whether the JobValid gate skips ``job``: a Pending-phase PodGroup's
    pods may not exist yet ("delay pod creation"); such a job is the
    enqueue action's input, and every other action skips it anyway
    (allocate.go:53-55 etc.)."""
    return job.pod_group is not None and job.pod_group.status.phase == PodGroupPhase.PENDING


def close_session(ssn: Session, discard: bool = False) -> None:
    """Plugin close hooks + PodGroup status write-back
    (framework.go:55-63 + session.go:123-148). With ``discard`` (a
    hard-deadline cycle abort, recovery/budget.py) the write-back is
    skipped: the aborted cycle's session state is rolled back wholesale
    — Statement.discard at cycle granularity — leaving the cache/store
    byte-identical to the cycle's start."""
    # Pipelined cycles (KBT_PIPELINE): a deferred post-solve dispatch
    # must land before anything below — the plugin close hooks and the
    # commit write-back read the session state the deferred replay
    # mutates, and job status must describe binds that actually
    # happened. A dispatch failure closes the session like the
    # synchronous path would (logged, no binds beyond what landed) and
    # degrades the pipeline loudly.
    if getattr(ssn, "deferred_dispatch", None) is not None:
        from kube_batch_tpu_torch import pipeline

        try:
            pipeline.join_session(ssn)
        except Exception as e:  # noqa: BLE001 - parity with sync-path logging
            _log.error("deferred dispatch failed while closing session %s: %s", ssn.uid, e)
            pipeline.fence.degrade(f"deferred dispatch raised {type(e).__name__}: {e}")

    for plugin in ssn.plugins.values():
        start = time.perf_counter()
        plugin.on_session_close(ssn)
        metrics.update_plugin_duration(plugin.name, "OnSessionClose", time.perf_counter() - start)

    if not discard:
        with obs.span("commit", jobs=len(ssn.jobs)):
            for job in ssn.jobs.values():
                if job.pod_group is None:
                    ssn.cache.record_job_status_event(job)
                    continue
                job.pod_group.status = _job_status(ssn, job)
                ssn.cache.update_job_status(job)

    ssn.jobs = {}
    ssn.nodes = {}
    ssn.queues = {}
    ssn.plugins = {}
    ssn.event_handlers = []
