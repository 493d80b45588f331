"""Model helpers (reference pkg/scheduler/api/helpers.go and
pkg/scheduler/api/helpers/helpers.go)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from kube_batch_tpu_torch.apis.types import Pod, PodPhase
from kube_batch_tpu_torch.api.resource_info import Resource
from kube_batch_tpu_torch.api.types import TaskStatus


def get_task_status(pod: Pod) -> TaskStatus:
    """Pod phase -> task status (reference helpers.go:35-61)."""
    deleting = getattr(pod.metadata, "deletion_timestamp", None) is not None
    if pod.phase == PodPhase.RUNNING:
        return TaskStatus.RELEASING if deleting else TaskStatus.RUNNING
    if pod.phase == PodPhase.PENDING:
        if deleting:
            return TaskStatus.RELEASING
        return TaskStatus.PENDING if not pod.node_name else TaskStatus.BOUND
    if pod.phase == PodPhase.SUCCEEDED:
        return TaskStatus.SUCCEEDED
    if pod.phase == PodPhase.FAILED:
        return TaskStatus.FAILED
    return TaskStatus.UNKNOWN


def merge_errors(*errs: Optional[Exception]) -> Optional[Exception]:
    """Collapse many errors into one (reference helpers.go:74-95)."""
    msgs = [str(e) for e in errs if e is not None]
    if not msgs:
        return None
    return RuntimeError("errors: " + "; ".join(msgs))


def min_resource(l: Resource, r: Resource) -> Resource:
    """Elementwise min (reference api/helpers/helpers.go:28-44). Go nil-map
    parity ({} == nil, see resource_info module docstring): when either
    side has no scalars the result has none — zero-filled entries would
    flip later nil-sensitive less/less_equal policy checks (e.g.
    proportion's overused gate)."""
    out = Resource(
        milli_cpu=min(l.milli_cpu, r.milli_cpu),
        memory=min(l.memory, r.memory),
    )
    if not l.scalars or not r.scalars:
        return out
    for name, q in l.scalars.items():
        out.scalars[name] = min(q, r.scalars.get(name, 0.0))
    return out


def share(l: float, r: float) -> float:
    """DRF share division: 0/0 -> 0, x/0 -> 1
    (reference api/helpers/helpers.go:43-60).

    The quotient is computed in the comparison dtype (api/numerics.py):
    f32 when the kernels solve f32, so share ties break identically in
    the serial oracle and on device."""
    if r == 0:
        return 0.0 if l == 0 else 1.0
    from kube_batch_tpu_torch.api.numerics import comparison_dtype

    if comparison_dtype() is np.float64:
        return l / r  # python floats ARE f64: no boxing on the fast path
    return float(np.float32(l) / np.float32(r))


def get_pod_resource_without_init_containers(pod: Pod) -> Resource:
    """Sum of container requests (reference pod_info.go:66-73)."""
    result = Resource.empty()
    for c in pod.containers:
        result.add(Resource.from_resource_list(c.requests))
    return result


def get_pod_resource_request(pod: Pod) -> Resource:
    """max(sum of containers, each init container) (reference pod_info.go:53-62)."""
    result = get_pod_resource_without_init_containers(pod)
    for c in pod.init_containers:
        result.set_max_resource(Resource.from_resource_list(c.requests))
    return result
