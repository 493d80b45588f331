"""Object model for the in-process cluster.

PodGroup/Queue mirror the reference CRDs
(reference pkg/apis/scheduling/v1alpha1/types.go:93-209, labels.go:20);
Pod/Node/PriorityClass/PodDisruptionBudget are minimal stand-ins for the
core-v1 objects, carrying exactly the fields the scheduler reads
(resources, selectors, taints/tolerations, host ports, affinity,
priority, phase/conditions).

Resource quantities are plain ``dict[str, float]`` resource lists keyed by
resource name ("cpu" in milli-units is NOT used here: "cpu" is in cores and
converted to milli-CPU by kube_batch_tpu_torch.api.resource_info, matching the
reference's Quantity.MilliValue semantics).
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

# Annotation key marking a pod's gang membership
# (reference pkg/apis/scheduling/v1alpha1/labels.go:20).
GROUP_NAME_ANNOTATION_KEY = "scheduling.k8s.io/group-name"

_uid_counter = itertools.count(1)


def new_uid(prefix: str = "obj") -> str:
    return f"{prefix}-{next(_uid_counter):08d}"


@dataclass
class ObjectMeta:
    """Standard object metadata (name/namespace/uid/labels/annotations)."""

    name: str = ""
    namespace: str = "default"
    uid: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    creation_timestamp: float = 0.0
    deletion_timestamp: Optional[float] = None  # non-None => object is terminating
    owner_job: Optional[str] = None  # stand-in for ownerReferences -> controller

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = new_uid(self.name or "obj")
        if not self.creation_timestamp:
            self.creation_timestamp = time.time()


# ---------------------------------------------------------------------------
# Pod
# ---------------------------------------------------------------------------


class PodPhase(str, Enum):
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    UNKNOWN = "Unknown"


@dataclass
class Container:
    """One container: resource requests drive scheduling (limits ignored,
    matching the reference's use of requests in pod_info.go:53-73)."""

    name: str = "main"
    requests: dict[str, float] = field(default_factory=dict)
    ports: list[int] = field(default_factory=list)  # hostPorts


@dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # "" tolerates all effects

    def tolerates(self, taint: "Taint") -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.operator == "Exists":
            return (not self.key) or self.key == taint.key
        return self.key == taint.key and self.value == taint.value


@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | PreferNoSchedule | NoExecute


@dataclass
class NodeSelectorTerm:
    """matchExpressions subset: key In values / Exists / NotIn / DoesNotExist."""

    key: str = ""
    operator: str = "In"
    values: list[str] = field(default_factory=list)

    def matches(self, labels: dict[str, str]) -> bool:
        present = self.key in labels
        if self.operator == "Exists":
            return present
        if self.operator == "DoesNotExist":
            return not present
        if self.operator == "In":
            return present and labels[self.key] in self.values
        if self.operator == "NotIn":
            return not present or labels[self.key] not in self.values
        raise ValueError(f"unknown node selector operator {self.operator!r}")


@dataclass
class PodAffinityTerm:
    """Pod (anti-)affinity: match pods by label selector within a topology
    domain (topology_key over node labels)."""

    label_selector: dict[str, str] = field(default_factory=dict)
    topology_key: str = "kubernetes.io/hostname"


@dataclass
class Affinity:
    # requiredDuringSchedulingIgnoredDuringExecution node affinity: OR of terms
    node_affinity_required: list[NodeSelectorTerm] = field(default_factory=list)
    # preferred node affinity: (weight, term) pairs, summed when matching
    node_affinity_preferred: list[tuple[int, NodeSelectorTerm]] = field(default_factory=list)
    pod_affinity_required: list[PodAffinityTerm] = field(default_factory=list)
    pod_anti_affinity_required: list[PodAffinityTerm] = field(default_factory=list)
    # preferredDuringSchedulingIgnoredDuringExecution pod (anti-)affinity:
    # (weight, term) pairs — scored by nodeorder's InterPodAffinity
    # priority, never gating feasibility
    pod_affinity_preferred: list[tuple[int, PodAffinityTerm]] = field(default_factory=list)
    pod_anti_affinity_preferred: list[tuple[int, PodAffinityTerm]] = field(default_factory=list)

    def has_pod_affinity_terms(self) -> bool:
        return bool(
            self.pod_affinity_required
            or self.pod_anti_affinity_required
            or self.pod_affinity_preferred
            or self.pod_anti_affinity_preferred
        )


@dataclass
class PodCondition:
    type: str = ""
    status: str = ""
    reason: str = ""
    message: str = ""


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    phase: PodPhase = PodPhase.PENDING
    containers: list[Container] = field(default_factory=list)
    init_containers: list[Container] = field(default_factory=list)
    node_name: str = ""
    scheduler_name: str = "kube-batch-tpu"
    node_selector: dict[str, str] = field(default_factory=dict)
    tolerations: list[Toleration] = field(default_factory=list)
    affinity: Optional[Affinity] = None
    priority: Optional[int] = None
    priority_class_name: str = ""
    conditions: list[PodCondition] = field(default_factory=list)
    # Names of PersistentVolumeClaims this pod mounts (same namespace) —
    # the slice of pod.spec.volumes the volume binder consults.
    volumes: list[str] = field(default_factory=list)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace


# ---------------------------------------------------------------------------
# Node
# ---------------------------------------------------------------------------


@dataclass
class NodeCondition:
    type: str = "Ready"  # Ready | OutOfDisk | MemoryPressure | DiskPressure | PIDPressure
    status: str = "True"


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    capacity: dict[str, float] = field(default_factory=dict)
    allocatable: dict[str, float] = field(default_factory=dict)
    taints: list[Taint] = field(default_factory=list)
    conditions: list[NodeCondition] = field(default_factory=lambda: [NodeCondition()])
    unschedulable: bool = False  # spec.unschedulable (cordon)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def labels(self) -> dict[str, str]:
        return self.metadata.labels

    def ready(self) -> bool:
        return any(c.type == "Ready" and c.status == "True" for c in self.conditions)


# ---------------------------------------------------------------------------
# PodGroup / Queue CRDs (reference types.go:93-209)
# ---------------------------------------------------------------------------


class PodGroupPhase(str, Enum):
    """reference types.go:24-44."""

    PENDING = "Pending"
    RUNNING = "Running"
    UNKNOWN = "Unknown"
    INQUEUE = "Inqueue"


POD_GROUP_UNSCHEDULABLE_TYPE = "Unschedulable"

# Condition reasons (reference types.go:77-90).
POD_FAILED_REASON = "PodFailed"
POD_DELETED_REASON = "PodDeleted"
NOT_ENOUGH_RESOURCES_REASON = "NotEnoughResources"
NOT_ENOUGH_PODS_REASON = "NotEnoughTasks"


@dataclass
class PodGroupCondition:
    type: str = POD_GROUP_UNSCHEDULABLE_TYPE
    status: str = "True"
    transition_id: str = ""
    last_transition_time: float = 0.0
    reason: str = ""
    message: str = ""


@dataclass
class PodGroupSpec:
    """reference types.go:113-136."""

    min_member: int = 0
    queue: str = ""
    priority_class_name: str = ""
    min_resources: Optional[dict[str, float]] = None


@dataclass
class PodGroupStatus:
    phase: PodGroupPhase = PodGroupPhase.PENDING
    conditions: list[PodGroupCondition] = field(default_factory=list)
    running: int = 0
    succeeded: int = 0
    failed: int = 0


@dataclass
class PodGroup:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodGroupSpec = field(default_factory=PodGroupSpec)
    status: PodGroupStatus = field(default_factory=PodGroupStatus)

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class QueueSpec:
    weight: int = 1
    capability: dict[str, float] = field(default_factory=dict)


@dataclass
class QueueStatus:
    unknown: int = 0
    pending: int = 0
    running: int = 0


@dataclass
class Queue:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: QueueSpec = field(default_factory=QueueSpec)
    status: QueueStatus = field(default_factory=QueueStatus)

    @property
    def name(self) -> str:
        return self.metadata.name


# ---------------------------------------------------------------------------
# PriorityClass / PodDisruptionBudget (minimal)
# ---------------------------------------------------------------------------


@dataclass
class PriorityClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    value: int = 0
    global_default: bool = False

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class PodDisruptionBudget:
    """Legacy gang-scheduling source (reference cache/event_handlers.go:494-604):
    a PDB with min_available N over a label selector acts as a shadow gang."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    min_available: int = 0
    selector: dict[str, str] = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.metadata.name


# ---------------------------------------------------------------------------
# Volumes (reference wires PV/PVC/StorageClass informers into the k8s
# volumebinder at cache.go:268-297; interface contract interface.go:46-56).
# Minimal models: what assume-at-allocate / bind-at-dispatch needs.
# ---------------------------------------------------------------------------


class VolumeBindingMode(str, Enum):
    IMMEDIATE = "Immediate"
    WAIT_FOR_FIRST_CONSUMER = "WaitForFirstConsumer"


class VolumePhase(str, Enum):
    """PV status.phase (subset) / PVC status.phase."""

    PENDING = "Pending"
    AVAILABLE = "Available"
    BOUND = "Bound"
    RELEASED = "Released"
    LOST = "Lost"


@dataclass
class StorageClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)  # cluster-scoped
    provisioner: str = ""
    volume_binding_mode: VolumeBindingMode = VolumeBindingMode.IMMEDIATE

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class PersistentVolume:
    """Cluster-scoped. `node_affinity` carries the volume's topology
    (required node-selector terms, OR-of-terms like pod node affinity);
    empty means accessible from every node."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    capacity_storage: float = 0.0  # bytes
    storage_class_name: str = ""
    node_affinity: list[NodeSelectorTerm] = field(default_factory=list)
    claim_ref: str = ""  # "namespace/name" of the bound PVC
    phase: VolumePhase = VolumePhase.AVAILABLE

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    storage_class_name: str = ""
    request_storage: float = 0.0  # bytes (spec.resources.requests[storage])
    volume_name: str = ""  # spec.volumeName, set when bound
    phase: VolumePhase = VolumePhase.PENDING

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace


# ---------------------------------------------------------------------------
# Lease (coordination.k8s.io/v1 shape, minimal)
# ---------------------------------------------------------------------------


@dataclass
class Lease:
    """Leader-election lease — the role the reference fills with a
    ConfigMap resource lock (cmd/kube-batch/app/server.go:115-139,
    resourcelock.ConfigMapsResourceLock). Arbitration happens inside the
    store that holds the lease (ClusterStore.try_acquire_lease), so all
    timestamps are the arbiter's clock — candidates never compare their
    own clocks."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    holder_identity: str = ""
    lease_duration_seconds: float = 15.0
    acquire_time: float = 0.0  # arbiter clock, time.time()
    renew_time: float = 0.0  # arbiter clock, time.time()
    lease_transitions: int = 0  # leadership changes, k8s leaseTransitions

    @property
    def name(self) -> str:
        return self.metadata.name
