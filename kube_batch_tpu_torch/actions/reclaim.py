"""reclaim action: cross-queue reclaim for underserved queues — victims
are Running tasks of *other* queues, vetted by Reclaimable (proportion's
deserved share), evicted directly (no statement)
(reference pkg/scheduler/actions/reclaim/reclaim.go:42-198).

`run_reclaim` is the full control flow, parameterized over the node walk
(predicate-passing nodes in name order, reclaim.go:113-128) and an
optional post-pipeline hook so the vectorized torch_reclaim action can
share it (same pattern as actions/preempt.run_preempt)."""

from __future__ import annotations

from typing import Callable, Optional

from kube_batch_tpu_torch.api.job_info import TaskInfo
from kube_batch_tpu_torch.api.node_info import NodeInfo
from kube_batch_tpu_torch.api.resource_info import Resource
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.apis.types import PodGroupPhase
from kube_batch_tpu_torch.framework.interface import Action
from kube_batch_tpu_torch.framework.session import Session
from kube_batch_tpu_torch.utils import PriorityQueue, get_node_list

FeasibleFn = Callable[[Session, TaskInfo], list[NodeInfo]]


def serial_feasible(ssn: Session, task: TaskInfo) -> list[NodeInfo]:
    """Predicate-passing nodes, name order (reclaim.go:113-118)."""
    out = []
    for node in get_node_list(ssn.nodes):
        try:
            ssn.predicate_fn(task, node)
        except Exception:
            continue
        out.append(node)
    return out


def run_reclaim(
    ssn: Session,
    feasible_fn: FeasibleFn = serial_feasible,
    on_pipeline: Optional[Callable[[TaskInfo, str], None]] = None,
) -> None:
    """The full reclaim pass (reclaim.go:54-186)."""
    queues = PriorityQueue(ssn.queue_order_fn)
    seen_queues: set[str] = set()
    preemptors_map: dict[str, PriorityQueue] = {}
    preemptor_tasks: dict[str, PriorityQueue] = {}

    for job in ssn.jobs.values():
        if job.pod_group is not None and job.pod_group.status.phase == PodGroupPhase.PENDING:
            continue
        queue = ssn.queues.get(job.queue)
        if queue is None:
            continue
        if queue.name not in seen_queues:
            seen_queues.add(queue.name)
            queues.push(queue)
        if job.task_status_index.get(TaskStatus.PENDING):
            if job.queue not in preemptors_map:
                preemptors_map[job.queue] = PriorityQueue(ssn.job_order_fn)
            preemptors_map[job.queue].push(job)
            preemptor_tasks[job.uid] = PriorityQueue(ssn.task_order_fn)
            for task in job.task_status_index[TaskStatus.PENDING].values():
                preemptor_tasks[job.uid].push(task)

    while not queues.empty():
        queue = queues.pop()
        if ssn.overused(queue):
            continue

        jobs = preemptors_map.get(queue.name)
        if jobs is None or jobs.empty():
            continue
        job = jobs.pop()

        tasks = preemptor_tasks.get(job.uid)
        if tasks is None or tasks.empty():
            continue
        task = tasks.pop()

        assigned = False
        for node in feasible_fn(ssn, task):
            resreq = task.init_resreq.clone()
            reclaimed = Resource.empty()

            # Running tasks of other queues (reclaim.go:130-143).
            reclaimees = []
            for resident in node.tasks.values():
                if resident.status != TaskStatus.RUNNING:
                    continue
                resident_job = ssn.jobs.get(resident.job)
                if resident_job is None:
                    continue
                if resident_job.queue != job.queue:
                    reclaimees.append(resident.clone())
            victims = ssn.reclaimable(task, reclaimees)
            if not victims:
                continue

            all_res = Resource.empty()
            for v in victims:
                all_res.add(v.resreq)
            if all_res.less(resreq):
                continue

            for reclaimee in victims:
                try:
                    ssn.evict(reclaimee, "reclaim")
                except Exception:
                    continue
                reclaimed.add(reclaimee.resreq)
                if resreq.less_equal(reclaimed):
                    break

            if task.init_resreq.less_equal(reclaimed):
                ssn.pipeline(task, node.name)
                if on_pipeline is not None:
                    on_pipeline(task, node.name)
                assigned = True
                break

        if assigned:
            queues.push(queue)


class ReclaimAction(Action):
    @property
    def name(self) -> str:
        return "reclaim"

    def execute(self, ssn: Session) -> None:
        run_reclaim(ssn)


def new() -> Action:
    return ReclaimAction()
