"""proportion plugin's session-open state: per-queue allocated and the
weighted water-filled deserved share
(reference pkg/scheduler/plugins/proportion/proportion.go:51-144).

The solve carries the per-queue allocated vectors forward and applies the
overused gate itself, so only the open-session state is needed here.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from kube_batch_tpu_torch.api.helpers import min_resource
from kube_batch_tpu_torch.api.job_info import JobInfo
from kube_batch_tpu_torch.api.node_info import NodeInfo
from kube_batch_tpu_torch.api.numerics import comparison_dtype, quantize
from kube_batch_tpu_torch.api.queue_info import QueueInfo
from kube_batch_tpu_torch.api.resource_info import Resource
from kube_batch_tpu_torch.api.types import TaskStatus, allocated_status


@dataclass
class QueueAttr:
    name: str
    weight: int
    deserved: Resource = field(default_factory=Resource.empty)
    allocated: Resource = field(default_factory=Resource.empty)
    request: Resource = field(default_factory=Resource.empty)


@dataclass
class ProportionState:
    total_resource: Resource = field(default_factory=Resource.empty)
    queue_attrs: dict[str, QueueAttr] = field(default_factory=dict)


def proportion_state(
    jobs: dict[str, JobInfo],
    nodes: dict[str, NodeInfo],
    queues: dict[str, QueueInfo],
) -> ProportionState:
    """Queue attributes from jobs (proportion.go:66-99), then iterative
    water-filling of deserved by weight until the remaining capacity is
    exhausted or every queue's request is met (proportion.go:101-144).
    Dict iteration order is the float summation order, so callers pass
    the same job order the reference session sees."""
    state = ProportionState()
    for node in nodes.values():
        state.total_resource.add(node.allocatable)

    attrs = state.queue_attrs
    for job in jobs.values():
        if job.queue not in attrs:
            queue = queues.get(job.queue)
            if queue is None:
                continue
            attrs[job.queue] = QueueAttr(name=queue.name, weight=queue.weight)
        attr = attrs[job.queue]
        for status, tasks in job.task_status_index.items():
            if allocated_status(status):
                for t in tasks.values():
                    attr.allocated.add(t.resreq)
                    attr.request.add(t.resreq)
            elif status == TaskStatus.PENDING:
                for t in tasks.values():
                    attr.request.add(t.resreq)

    remaining = state.total_resource.clone()
    met: set[str] = set()
    while True:
        total_weight = sum(a.weight for a in attrs.values() if a.name not in met)
        if total_weight == 0:
            break
        deserved_this_round = Resource.empty()
        for attr in attrs.values():
            if attr.name in met:
                continue
            old_deserved = attr.deserved.clone()
            attr.deserved.add(remaining.clone().multi(attr.weight / total_weight))
            if not attr.deserved.less_equal(attr.request):
                attr.deserved = min_resource(attr.deserved, attr.request)
                met.add(attr.name)
            deserved_this_round.add(attr.deserved.clone().sub(old_deserved))
        remaining.sub(deserved_this_round)
        if remaining.is_empty():
            break

    # Deserved lands on the solve's float type, so the overused gate and
    # the share denominators see exactly the values the solve sees.
    dt = comparison_dtype()
    for attr in attrs.values():
        d = attr.deserved
        d.milli_cpu = quantize(d.milli_cpu, dt)
        d.memory = quantize(d.memory, dt)
        for rn in d.scalars:
            d.scalars[rn] = quantize(d.scalars[rn], dt)
    return state
