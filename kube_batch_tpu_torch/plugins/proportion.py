"""proportion plugin: queue-level weighted fair share via iterative
water-filling (reference pkg/scheduler/plugins/proportion/proportion.go:51-223).

The session-open state (per-queue allocated and request, the water-filled
deserved share, proportion.go:66-144) is computed in one place,
``ProportionPlugin.open_state``: ``on_session_open`` runs it over the
session's snapshot, and ``proportion_state`` over any snapshot for
callers without a session (``solve.allocate``). The encoder reads
``queue_attrs`` from either.
"""

from __future__ import annotations

from kube_batch_tpu_torch.api.helpers import min_resource, share
from kube_batch_tpu_torch.api.job_info import JobInfo, TaskInfo
from kube_batch_tpu_torch.api.node_info import NodeInfo
from kube_batch_tpu_torch.api.numerics import comparison_dtype, quantize
from kube_batch_tpu_torch.api.queue_info import QueueInfo
from kube_batch_tpu_torch.api.resource_info import Resource
from kube_batch_tpu_torch.api.types import TaskStatus, allocated_status
from kube_batch_tpu_torch.framework.arguments import Arguments
from kube_batch_tpu_torch.framework.event import Event, EventHandler
from kube_batch_tpu_torch.framework.interface import Plugin
from kube_batch_tpu_torch.framework.session import Session


class QueueAttr:
    __slots__ = ("queue_id", "name", "weight", "share", "deserved", "allocated", "request")

    def __init__(self, queue_id: str, name: str, weight: int) -> None:
        self.queue_id = queue_id
        self.name = name
        self.weight = weight
        self.share = 0.0
        self.deserved = Resource.empty()
        self.allocated = Resource.empty()
        self.request = Resource.empty()


class ProportionPlugin(Plugin):
    def __init__(self, arguments: Arguments) -> None:
        self.arguments = arguments
        self.total_resource = Resource.empty()
        self.queue_attrs: dict[str, QueueAttr] = {}

    @property
    def name(self) -> str:
        return "proportion"

    def _update_share(self, attr: QueueAttr) -> None:
        """share = max over deserved dimensions of allocated/deserved
        (proportion.go:211-223)."""
        res = 0.0
        for rn in attr.deserved.resource_names():
            s = share(attr.allocated.get(rn), attr.deserved.get(rn))
            if s > res:
                res = s
        attr.share = res

    def open_state(
        self,
        jobs: dict[str, JobInfo],
        nodes: dict[str, NodeInfo],
        queues: dict[str, QueueInfo],
    ) -> None:
        """Queue attributes from jobs (proportion.go:66-99), then iterative
        water-filling of deserved by weight until the remaining capacity is
        exhausted or every queue's request is met (proportion.go:101-144).
        Dict iteration order is the float summation order, so callers pass
        the same job order the reference session sees."""
        for node in nodes.values():
            self.total_resource.add(node.allocatable)

        for job in jobs.values():
            if job.queue not in self.queue_attrs:
                queue = queues.get(job.queue)
                if queue is None:
                    continue
                self.queue_attrs[job.queue] = QueueAttr(
                    queue_id=queue.name, name=queue.name, weight=queue.weight
                )
            attr = self.queue_attrs[job.queue]
            for status, tasks in job.task_status_index.items():
                if allocated_status(status):
                    for t in tasks.values():
                        attr.allocated.add(t.resreq)
                        attr.request.add(t.resreq)
                elif status == TaskStatus.PENDING:
                    for t in tasks.values():
                        attr.request.add(t.resreq)

        remaining = self.total_resource.clone()
        met: set[str] = set()
        while True:
            total_weight = sum(
                attr.weight
                for attr in self.queue_attrs.values()
                if attr.queue_id not in met
            )
            if total_weight == 0:
                break
            deserved_this_round = Resource.empty()
            for attr in self.queue_attrs.values():
                if attr.queue_id in met:
                    continue
                old_deserved = attr.deserved.clone()
                attr.deserved.add(remaining.clone().multi(attr.weight / total_weight))
                if not attr.deserved.less_equal(attr.request):
                    attr.deserved = min_resource(attr.deserved, attr.request)
                    met.add(attr.queue_id)
                self._update_share(attr)
                deserved_this_round.add(attr.deserved.clone().sub(old_deserved))
            remaining.sub(deserved_this_round)
            if remaining.is_empty():
                break

        # Deserved lands on the solve's float type, so the overused gate and
        # the share denominators see exactly the values the solve sees.
        dt = comparison_dtype()
        for attr in self.queue_attrs.values():
            d = attr.deserved
            d.milli_cpu = quantize(d.milli_cpu, dt)
            d.memory = quantize(d.memory, dt)
            for rn in d.scalars:
                d.scalars[rn] = quantize(d.scalars[rn], dt)
            self._update_share(attr)

    def on_session_open(self, ssn: Session) -> None:
        self.open_state(ssn.jobs, ssn.nodes, ssn.queues)

        def queue_order_fn(l: QueueInfo, r: QueueInfo) -> int:
            """Lower share first (proportion.go:146-159)."""
            la = self.queue_attrs.get(l.name)
            ra = self.queue_attrs.get(r.name)
            ls = la.share if la else 0.0
            rs = ra.share if ra else 0.0
            if ls == rs:
                return 0
            return -1 if ls < rs else 1

        ssn.add_queue_order_fn(self.name, queue_order_fn)

        def reclaimable_fn(reclaimer: TaskInfo, reclaimees: list[TaskInfo]) -> list[TaskInfo]:
            """Victim OK while its queue stays at or above deserved
            (proportion.go:161-186)."""
            victims: list[TaskInfo] = []
            allocations: dict[str, Resource] = {}
            for reclaimee in reclaimees:
                job = ssn.jobs[reclaimee.job]
                attr = self.queue_attrs[job.queue]
                if job.queue not in allocations:
                    allocations[job.queue] = attr.allocated.clone()
                allocated = allocations[job.queue]
                if allocated.less(reclaimee.resreq):
                    continue
                allocated.sub(reclaimee.resreq)
                # both sides in the comparison dtype: the serial gate
                # must round exactly as the float32 device gate does
                if attr.deserved.less_equal(allocated, dtype=comparison_dtype()):
                    victims.append(reclaimee)
            return victims

        ssn.add_reclaimable_fn(self.name, reclaimable_fn)

        def overused_fn(queue: QueueInfo) -> bool:
            """deserved <= allocated (proportion.go:188-199)."""
            attr = self.queue_attrs.get(queue.name)
            if attr is None:
                return False
            return attr.deserved.less_equal(
                attr.allocated, dtype=comparison_dtype()
            )

        ssn.add_overused_fn(self.name, overused_fn)

        def on_allocate(event: Event) -> None:
            job = ssn.jobs[event.task.job]
            attr = self.queue_attrs[job.queue]
            attr.allocated.add(event.task.resreq)
            self._update_share(attr)

        def on_deallocate(event: Event) -> None:
            job = ssn.jobs[event.task.job]
            attr = self.queue_attrs[job.queue]
            attr.allocated.sub(event.task.resreq)
            self._update_share(attr)

        ssn.add_event_handler(
            EventHandler(allocate_func=on_allocate, deallocate_func=on_deallocate)
        )

    def on_session_close(self, ssn: Session) -> None:
        self.total_resource = Resource.empty()
        self.queue_attrs = {}


def proportion_state(
    jobs: dict[str, JobInfo],
    nodes: dict[str, NodeInfo],
    queues: dict[str, QueueInfo],
) -> ProportionPlugin:
    """The plugin's session-open state over the snapshot, without a
    session: a plugin instance after ``open_state``."""
    plugin = ProportionPlugin(Arguments())
    plugin.open_state(jobs, nodes, queues)
    return plugin


def new(arguments: Arguments) -> Plugin:
    return ProportionPlugin(arguments)
