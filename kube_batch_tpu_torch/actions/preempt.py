"""preempt action: Statement-wrapped speculative preemption for starved
jobs (reference pkg/scheduler/actions/preempt/preempt.go:45-273).

`run_preempt` is the whole control flow — queue-by-queue preemptor heaps,
Statement speculation with commit/discard, the intra-job pass —
parameterized over how Statements are built and how candidate nodes are
scanned, so the serial action here and the vectorized torch_preempt
action share one control flow instead of diverging copies.

Each candidate node's victim count feeds ``total_preemption_victims`` and
each eviction pass ``total_preemption_attempts``, as in the JAX package.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

from kube_batch_tpu_torch import log as pkg_log, metrics
from kube_batch_tpu_torch.api.job_info import JobInfo, TaskInfo
from kube_batch_tpu_torch.api.node_info import NodeInfo
from kube_batch_tpu_torch.api.resource_info import Resource
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.apis.types import PodGroupPhase
from kube_batch_tpu_torch.framework.interface import Action
from kube_batch_tpu_torch.framework.session import Session
from kube_batch_tpu_torch.framework.statement import Statement
from kube_batch_tpu_torch.utils import (
    PriorityQueue,
    get_node_list,
    predicate_nodes,
    prioritize_nodes,
    sort_nodes,
)

log = logging.getLogger(__name__)

# candidates(ssn, preemptor) -> nodes to try, best-scored first
CandidatesFn = Callable[[Session, TaskInfo], list[NodeInfo]]
StatementFactory = Callable[[Session], Statement]


def serial_candidates(ssn: Session, preemptor: TaskInfo) -> list[NodeInfo]:
    """The reference scan: PredicateNodes + PrioritizeNodes + SortNodes
    (preempt.go:185-191) over every node."""
    all_nodes = get_node_list(ssn.nodes)
    cands = predicate_nodes(preemptor, all_nodes, lambda t, n: ssn.predicate_fn(t, n))
    return sort_nodes(
        prioritize_nodes(
            preemptor, cands, ssn.node_order_map_fn, ssn.node_order_reduce_fn
        )
    )


def _validate_victims(victims: list[TaskInfo], resreq: Resource) -> Optional[str]:
    """preempt.go:258-273."""
    if not victims:
        return "no victims"
    all_res = Resource.empty()
    for v in victims:
        all_res.add(v.resreq)
    if all_res.less(resreq):
        return "not enough resources"
    return None


def _preempt(
    ssn: Session,
    stmt: Statement,
    preemptor: TaskInfo,
    filter_fn: Callable[[TaskInfo], bool],
    candidates_fn: CandidatesFn,
) -> bool:
    """One preemptor against candidate nodes (preempt.go:176-256)."""
    for node in candidates_fn(ssn, preemptor):
        preemptees = [task.clone() for task in node.tasks.values() if filter_fn(task)]
        victims = ssn.preemptable(preemptor, preemptees)
        metrics.update_preemption_victims_count(len(victims))

        resreq = preemptor.init_resreq.clone()
        if _validate_victims(victims, resreq) is not None:
            continue

        # Evict lowest-priority victims first until covered (preempt.go:215-236).
        victims_queue = PriorityQueue(lambda l, r: not ssn.task_order_fn(l, r))
        for victim in victims:
            victims_queue.push(victim)
        preempted = Resource.empty()
        while not victims_queue.empty():
            preemptee = victims_queue.pop()
            pkg_log.V(3).infof(
                "evicting task <%s/%s> for preemptor <%s/%s>",
                preemptee.namespace, preemptee.name,
                preemptor.namespace, preemptor.name,
            )
            stmt.evict(preemptee, "preempt")
            preempted.add(preemptee.resreq)
            if resreq.less_equal(preempted):
                break

        metrics.register_preemption_attempts()

        if preemptor.init_resreq.less_equal(preempted):
            pkg_log.V(3).infof(
                "preempted <%s> on node <%s> for task <%s/%s>",
                preempted, node.name, preemptor.namespace, preemptor.name,
            )
            stmt.pipeline(preemptor, node.name)
            return True

    return False


def run_preempt(
    ssn: Session,
    statement_factory: StatementFactory = Statement,
    candidates_fn: CandidatesFn = serial_candidates,
) -> None:
    """The full preempt pass (preempt.go:58-170)."""
    preemptors_map: dict[str, PriorityQueue] = {}
    preemptor_tasks: dict[str, PriorityQueue] = {}
    under_request: list[JobInfo] = []
    queues: dict[str, object] = {}

    for job in ssn.jobs.values():
        if job.pod_group is not None and job.pod_group.status.phase == PodGroupPhase.PENDING:
            continue
        queue = ssn.queues.get(job.queue)
        if queue is None:
            continue
        queues.setdefault(queue.name, queue)
        if job.task_status_index.get(TaskStatus.PENDING):
            if job.queue not in preemptors_map:
                preemptors_map[job.queue] = PriorityQueue(ssn.job_order_fn)
            preemptors_map[job.queue].push(job)
            under_request.append(job)
            preemptor_tasks[job.uid] = PriorityQueue(ssn.task_order_fn)
            for task in job.task_status_index[TaskStatus.PENDING].values():
                preemptor_tasks[job.uid].push(task)

    for queue in queues.values():
        # Preemption between jobs within the queue (preempt.go:81-135).
        while True:
            preemptors = preemptors_map.get(queue.name)
            if preemptors is None or preemptors.empty():
                break
            preemptor_job = preemptors.pop()

            stmt = statement_factory(ssn)
            assigned = False
            while True:
                if preemptor_tasks[preemptor_job.uid].empty():
                    break
                preemptor = preemptor_tasks[preemptor_job.uid].pop()

                def job_filter(task: TaskInfo) -> bool:
                    # Running victims of *other* jobs in the same queue
                    # (preempt.go:106-118).
                    if task.status != TaskStatus.RUNNING:
                        return False
                    victim_job = ssn.jobs.get(task.job)
                    if victim_job is None:
                        return False
                    return (
                        victim_job.queue == preemptor_job.queue
                        and preemptor.job != task.job
                    )

                if _preempt(ssn, stmt, preemptor, job_filter, candidates_fn):
                    assigned = True

                if ssn.job_pipelined(preemptor_job):
                    break

            # Settle the statement on every way out of the task loop:
            # the empty-queue break could previously leak it open when
            # the job was already pipelined (its evictions then never
            # replayed to the cache).
            if ssn.job_pipelined(preemptor_job):
                stmt.commit()
            else:
                stmt.discard()
                continue

            if assigned:
                preemptors.push(preemptor_job)

        # Preemption between tasks within one job (preempt.go:138-170).
        for job in under_request:
            while True:
                tasks = preemptor_tasks.get(job.uid)
                if tasks is None or tasks.empty():
                    break
                preemptor = tasks.pop()

                def intra_job_filter(task: TaskInfo) -> bool:
                    if task.status != TaskStatus.RUNNING:
                        return False
                    return preemptor.job == task.job

                stmt = statement_factory(ssn)
                assigned = _preempt(ssn, stmt, preemptor, intra_job_filter, candidates_fn)
                stmt.commit()
                if not assigned:
                    break


class PreemptAction(Action):
    @property
    def name(self) -> str:
        return "preempt"

    def execute(self, ssn: Session) -> None:
        run_preempt(ssn)


def new() -> Action:
    return PreemptAction()
