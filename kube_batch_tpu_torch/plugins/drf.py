"""drf plugin's session-open state: cluster totals and per-job allocated
vectors (reference pkg/scheduler/plugins/drf/drf.go:60-83).

The solve carries the per-job allocated vectors forward and recomputes
dominant shares itself, so only the open-session state is needed here.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from kube_batch_tpu_torch.api.job_info import JobInfo
from kube_batch_tpu_torch.api.node_info import NodeInfo
from kube_batch_tpu_torch.api.resource_info import Resource
from kube_batch_tpu_torch.api.types import allocated_status


@dataclass
class DrfAttr:
    allocated: Resource = field(default_factory=Resource.empty)


@dataclass
class DrfState:
    total_resource: Resource = field(default_factory=Resource.empty)
    job_attrs: dict[str, DrfAttr] = field(default_factory=dict)


def drf_state(jobs: dict[str, JobInfo], nodes: dict[str, NodeInfo]) -> DrfState:
    """Totals over every node's allocatable, and each job's allocated-status
    requests summed in task-status-index order (drf.go:60-83)."""
    state = DrfState()
    for node in nodes.values():
        state.total_resource.add(node.allocatable)
    for job in jobs.values():
        attr = DrfAttr()
        for status, tasks in job.task_status_index.items():
            if allocated_status(status):
                for t in tasks.values():
                    attr.allocated.add(t.resreq)
        state.job_attrs[job.uid] = attr
    return state
