"""L3 in-memory scheduling model (reference pkg/scheduler/api/).

Pure data layer: no dependency on the cache or framework. ``Resource`` is
both the serial-path arithmetic type and the row type of the dense tensors
built by kube_batch_tpu_torch.ops.encode.
"""

from kube_batch_tpu_torch.api.resource_info import (
    GPU_RESOURCE_NAME,
    MIN_MEMORY,
    MIN_MILLI_CPU,
    MIN_MILLI_SCALAR,
    Resource,
)
from kube_batch_tpu_torch.api.types import (
    ALLOCATED_STATUSES,
    TaskStatus,
)
from kube_batch_tpu_torch.api.helpers import (
    get_task_status,
    merge_errors,
    min_resource,
    share,
)
from kube_batch_tpu_torch.api.job_info import FitError, JobInfo, TaskInfo, job_key, pod_key, task_key
from kube_batch_tpu_torch.api.node_info import NodeInfo
from kube_batch_tpu_torch.api.queue_info import QueueInfo
from kube_batch_tpu_torch.api.cluster_info import ClusterInfo

__all__ = [
    "ALLOCATED_STATUSES",
    "ClusterInfo",
    "FitError",
    "GPU_RESOURCE_NAME",
    "JobInfo",
    "MIN_MEMORY",
    "MIN_MILLI_CPU",
    "MIN_MILLI_SCALAR",
    "NodeInfo",
    "QueueInfo",
    "Resource",
    "TaskInfo",
    "TaskStatus",
    "get_task_status",
    "job_key",
    "merge_errors",
    "min_resource",
    "pod_key",
    "share",
    "task_key",
]
