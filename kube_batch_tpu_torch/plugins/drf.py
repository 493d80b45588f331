"""drf plugin: dominant-resource fairness across jobs
(reference pkg/scheduler/plugins/drf/drf.go:29-171).

The session-open state (cluster totals, per-job allocated vectors and
shares, drf.go:60-83) is computed in one place, ``DrfPlugin.open_state``:
``on_session_open`` runs it over the session's snapshot, and ``drf_state``
over any snapshot for callers without a session (``solve.allocate``).
The encoder reads ``total_resource`` and ``job_attrs`` from either.
"""

from __future__ import annotations

from kube_batch_tpu_torch.api.helpers import share
from kube_batch_tpu_torch.api.job_info import JobInfo, TaskInfo
from kube_batch_tpu_torch.api.node_info import NodeInfo
from kube_batch_tpu_torch.api.resource_info import Resource
from kube_batch_tpu_torch.api.types import allocated_status
from kube_batch_tpu_torch.framework.arguments import Arguments
from kube_batch_tpu_torch.framework.event import Event, EventHandler
from kube_batch_tpu_torch.framework.interface import Plugin
from kube_batch_tpu_torch.framework.session import Session

SHARE_DELTA = 1e-6  # drf.go:29


class DrfAttr:
    __slots__ = ("share", "allocated")

    def __init__(self) -> None:
        self.share = 0.0
        self.allocated = Resource.empty()


class DrfPlugin(Plugin):
    def __init__(self, arguments: Arguments) -> None:
        self.arguments = arguments
        self.total_resource = Resource.empty()
        self.job_attrs: dict[str, DrfAttr] = {}

    @property
    def name(self) -> str:
        return "drf"

    def _calculate_share(self, allocated: Resource) -> float:
        """share = max over resources of allocated/total (drf.go:161-171)."""
        res = 0.0
        for rn in self.total_resource.resource_names():
            s = share(allocated.get(rn), self.total_resource.get(rn))
            if s > res:
                res = s
        return res

    def _update_share(self, attr: DrfAttr) -> None:
        attr.share = self._calculate_share(attr.allocated)

    def open_state(self, jobs: dict[str, JobInfo], nodes: dict[str, NodeInfo]) -> None:
        """Totals over every node's allocatable, and each job's
        allocated-status requests summed in task-status-index order, with
        its share (drf.go:60-83)."""
        for node in nodes.values():
            self.total_resource.add(node.allocatable)
        for job in jobs.values():
            attr = DrfAttr()
            for status, tasks in job.task_status_index.items():
                if allocated_status(status):
                    for t in tasks.values():
                        attr.allocated.add(t.resreq)
            self._update_share(attr)
            self.job_attrs[job.uid] = attr

    def on_session_open(self, ssn: Session) -> None:
        self.open_state(ssn.jobs, ssn.nodes)

        def preemptable_fn(preemptor: TaskInfo, preemptees: list[TaskInfo]) -> list[TaskInfo]:
            """Victim is evictable only if the preemptor's post-allocation
            share stays below (or within epsilon of) the victim's
            post-eviction share (drf.go:85-112)."""
            victims: list[TaskInfo] = []
            latt = self.job_attrs[preemptor.job]
            lalloc = latt.allocated.clone().add(preemptor.resreq)
            ls = self._calculate_share(lalloc)
            allocations: dict[str, Resource] = {}
            for preemptee in preemptees:
                if preemptee.job not in allocations:
                    allocations[preemptee.job] = self.job_attrs[preemptee.job].allocated.clone()
                ralloc = allocations[preemptee.job].sub(preemptee.resreq)
                rs = self._calculate_share(ralloc)
                if ls < rs or abs(ls - rs) <= SHARE_DELTA:
                    victims.append(preemptee)
            return victims

        ssn.add_preemptable_fn(self.name, preemptable_fn)

        def job_order_fn(l: JobInfo, r: JobInfo) -> int:
            """Lower share schedules first (drf.go:114-132)."""
            ls = self.job_attrs[l.uid].share
            rs = self.job_attrs[r.uid].share
            if ls == rs:
                return 0
            return -1 if ls < rs else 1

        ssn.add_job_order_fn(self.name, job_order_fn)

        def on_allocate(event: Event) -> None:
            attr = self.job_attrs[event.task.job]
            attr.allocated.add(event.task.resreq)
            self._update_share(attr)

        def on_deallocate(event: Event) -> None:
            attr = self.job_attrs[event.task.job]
            attr.allocated.sub(event.task.resreq)
            self._update_share(attr)

        ssn.add_event_handler(
            EventHandler(allocate_func=on_allocate, deallocate_func=on_deallocate)
        )

    def on_session_close(self, ssn: Session) -> None:
        self.total_resource = Resource.empty()
        self.job_attrs = {}


def drf_state(jobs: dict[str, JobInfo], nodes: dict[str, NodeInfo]) -> DrfPlugin:
    """The plugin's session-open state over ``jobs`` and ``nodes``, without
    a session: a plugin instance after ``open_state``."""
    plugin = DrfPlugin(Arguments())
    plugin.open_state(jobs, nodes)
    return plugin


def new(arguments: Arguments) -> Plugin:
    return DrfPlugin(arguments)
