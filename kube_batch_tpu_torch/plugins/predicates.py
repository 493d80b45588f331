"""predicates plugin's pure node checks
(reference pkg/scheduler/plugins/predicates/predicates.go:57-203).

The encoder evaluates the task-static x node-static subset of the
predicate chain once per (task-group, node-group) pair with these
functions:

- node condition                    predicates.go:75-86
- node unschedulable (cordon)       predicates.go:89-100
- node selector + node affinity     predicates.go:103-114
- taints/tolerations                predicates.go:131-142
- memory/disk/pid pressure          predicates.go:145-184

Pod count and host ports are dynamic and live in the solve; pairwise pod
(anti-)affinity routes a task host-side (ops/encode.py ``host_only``).
"""

from __future__ import annotations

from kube_batch_tpu_torch.apis.types import Node, Pod


def check_node_condition(node: Node) -> bool:
    """CheckNodeConditionPredicate: Ready and no OutOfDisk /
    NetworkUnavailable (predicates.go:75-86)."""
    ready = False
    for c in node.conditions:
        if c.type == "Ready":
            ready = c.status == "True"
        elif c.type == "OutOfDisk" and c.status == "True":
            return False
        elif c.type == "NetworkUnavailable" and c.status == "True":
            return False
    return ready


def check_node_unschedulable(pod: Pod, node: Node) -> bool:
    """CheckNodeUnschedulablePredicate (predicates.go:89-100): cordoned
    nodes accept only pods tolerating the unschedulable taint."""
    if not node.unschedulable:
        return True
    for tol in pod.tolerations:
        if tol.key == "node.kubernetes.io/unschedulable" or (
            tol.operator == "Exists" and not tol.key
        ):
            return True
    return False


def check_node_selector(pod: Pod, node: Node) -> bool:
    """PodMatchNodeSelector (predicates.go:103-114): plain nodeSelector
    labels AND required node-affinity terms (OR across terms)."""
    for key, value in pod.node_selector.items():
        if node.labels.get(key) != value:
            return False
    if pod.affinity is not None and pod.affinity.node_affinity_required:
        if not any(
            term.matches(node.labels) for term in pod.affinity.node_affinity_required
        ):
            return False
    return True


def check_taints(pod: Pod, node: Node) -> bool:
    """PodToleratesNodeTaints (predicates.go:131-142): every NoSchedule /
    NoExecute taint must be tolerated (PreferNoSchedule is soft)."""
    for taint in node.taints:
        if taint.effect not in ("NoSchedule", "NoExecute"):
            continue
        if not any(tol.tolerates(taint) for tol in pod.tolerations):
            return False
    return True


def check_pressure(node: Node) -> bool:
    """Memory/Disk/PID pressure conditions (predicates.go:145-184)."""
    for c in node.conditions:
        if c.type in ("MemoryPressure", "DiskPressure", "PIDPressure") and c.status == "True":
            return False
    return True
