"""The event-driven cluster cache (reference pkg/scheduler/cache): the
in-process ``ClusterStore`` (store.py) and the ``SchedulerCache`` its
event handlers feed, with the store-backed write side (cache.py), and the
store-backend surface with its HTTP client (backend.py)."""

from kube_batch_tpu_torch.cache.backend import (
    BackendPartitioned,
    InProcessBackend,
    LoopbackBackend,
    StoreBackend,
)
from kube_batch_tpu_torch.cache.cache import (
    NoopVolumeBinder,
    SchedulerCache,
    StoreBinder,
    StoreEvictor,
    StoreStatusUpdater,
    StoreVolumeBinder,
    VolumeBindingError,
    create_shadow_pod_group,
    job_terminated,
    shadow_pod_group,
)
from kube_batch_tpu_torch.cache.store import (
    KINDS,
    NODES,
    PDBS,
    POD_GROUPS,
    PODS,
    PRIORITY_CLASSES,
    QUEUES,
    AlreadyExists,
    ClusterStore,
    EventHandler,
    StaleWrite,
)

__all__ = [
    "AlreadyExists",
    "BackendPartitioned",
    "ClusterStore",
    "EventHandler",
    "InProcessBackend",
    "LoopbackBackend",
    "StaleWrite",
    "KINDS",
    "NODES",
    "NoopVolumeBinder",
    "PDBS",
    "POD_GROUPS",
    "PODS",
    "PRIORITY_CLASSES",
    "QUEUES",
    "SchedulerCache",
    "StoreBackend",
    "StoreBinder",
    "StoreEvictor",
    "StoreStatusUpdater",
    "StoreVolumeBinder",
    "VolumeBindingError",
    "create_shadow_pod_group",
    "job_terminated",
    "shadow_pod_group",
]
