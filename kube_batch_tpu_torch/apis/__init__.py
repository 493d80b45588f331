"""L0 object model: the framework's "CRD" layer.

Python equivalents of the reference's API objects — PodGroup and Queue
(reference pkg/apis/scheduling/v1alpha1/types.go:93-209) plus lightweight
stand-ins for the core-v1 objects the scheduler consumes (Pod, Node,
PriorityClass, PodDisruptionBudget). There is no real Kubernetes here;
these are the wire objects of the in-process cluster state store
(kube_batch_tpu_torch.cache) and of the synthetic workload generators
(kube_batch_tpu_torch.models).
"""

from kube_batch_tpu_torch.apis.types import (
    Affinity,
    Container,
    GROUP_NAME_ANNOTATION_KEY,
    Node,
    NodeCondition,
    NodeSelectorTerm,
    ObjectMeta,
    Pod,
    PodAffinityTerm,
    PodCondition,
    PodDisruptionBudget,
    PodGroup,
    PodGroupCondition,
    PodGroupPhase,
    PodGroupSpec,
    PodGroupStatus,
    PodPhase,
    PriorityClass,
    Queue,
    QueueSpec,
    QueueStatus,
    Toleration,
    Taint,
)

__all__ = [
    "Affinity",
    "Container",
    "GROUP_NAME_ANNOTATION_KEY",
    "Node",
    "NodeCondition",
    "NodeSelectorTerm",
    "ObjectMeta",
    "Pod",
    "PodAffinityTerm",
    "PodCondition",
    "PodDisruptionBudget",
    "PodGroup",
    "PodGroupCondition",
    "PodGroupPhase",
    "PodGroupSpec",
    "PodGroupStatus",
    "PodPhase",
    "PriorityClass",
    "Queue",
    "QueueSpec",
    "QueueStatus",
    "Toleration",
    "Taint",
]
