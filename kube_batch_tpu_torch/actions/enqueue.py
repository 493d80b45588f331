"""enqueue action: gate Pending PodGroups into Inqueue when the cluster's
(1.2x overcommitted) idle headroom covers their MinResources
(reference pkg/scheduler/actions/enqueue/enqueue.go:42-128; design doc
doc/design/delay-pod-creation.md)."""

from __future__ import annotations

from kube_batch_tpu_torch.api.resource_info import Resource
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.apis.types import PodGroupPhase
from kube_batch_tpu_torch.framework.interface import Action
from kube_batch_tpu_torch.framework.session import Session
from kube_batch_tpu_torch.utils import PriorityQueue

OVERCOMMIT_FACTOR = 1.2  # enqueue.go:80


class EnqueueAction(Action):
    @property
    def name(self) -> str:
        return "enqueue"

    def execute(self, ssn: Session) -> None:
        queues = PriorityQueue(ssn.queue_order_fn)
        seen_queues: set[str] = set()
        jobs_map: dict[str, PriorityQueue] = {}

        for job in ssn.jobs.values():
            queue = ssn.queues.get(job.queue)
            if queue is None:
                continue
            if queue.name not in seen_queues:
                seen_queues.add(queue.name)
                queues.push(queue)
            if job.pod_group is not None and job.pod_group.status.phase == PodGroupPhase.PENDING:
                if job.queue not in jobs_map:
                    jobs_map[job.queue] = PriorityQueue(ssn.job_order_fn)
                jobs_map[job.queue].push(job)

        # Idle headroom with 1.2x overcommit (enqueue.go:78-82) —
        # computed lazily: it is only consumed by the MinResources
        # admission branch (jobs whose pods don't exist yet), and the
        # per-node Resource churn is the action's whole cost on big
        # clusters, where every gang has pods and the sweep would be dead
        # work.
        empty = Resource.empty()
        nodes_idle: Resource = None  # type: ignore[assignment]

        def idle() -> Resource:
            nonlocal nodes_idle
            if nodes_idle is None:
                nodes_idle = Resource.empty()
                for node in ssn.nodes.values():
                    nodes_idle.add(
                        node.allocatable.clone().multi(OVERCOMMIT_FACTOR).sub(node.used)
                    )
            return nodes_idle

        while not queues.empty():
            # per-node overcommitted idle is never negative, so the sum
            # only goes negative after a MinResources subtraction — no
            # need to force the sweep just for this check
            if nodes_idle is not None and nodes_idle.less(empty):
                break
            queue = queues.pop()
            jobs = jobs_map.get(queue.name)
            if jobs is None or jobs.empty():
                continue
            job = jobs.pop()

            inqueue = False
            if job.task_status_index.get(TaskStatus.PENDING):
                # Pods already exist: always admit (enqueue.go:106-108).
                inqueue = True
            elif job.pod_group.spec.min_resources is None:
                inqueue = True
            else:
                pg_resource = Resource.from_resource_list(job.pod_group.spec.min_resources)
                if pg_resource.less_equal(idle()):
                    idle().sub(pg_resource)
                    inqueue = True

            if inqueue:
                job.pod_group.status.phase = PodGroupPhase.INQUEUE

            queues.push(queue)


def new() -> Action:
    return EnqueueAction()
