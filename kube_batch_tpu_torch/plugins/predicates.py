"""predicates plugin: node feasibility checks
(reference pkg/scheduler/plugins/predicates/predicates.go:57-203).

The reference chains eight upstream k8s predicate libs; here each check is
implemented directly against the in-process object model, in the same
order, failing fast with PredicateError:

1. max task num (pod count)          predicates.go:70-72
2. node condition                    predicates.go:75-86
3. node unschedulable (cordon)       predicates.go:89-100
4. node selector + node affinity     predicates.go:103-114
5. host ports                        predicates.go:117-128
6. taints/tolerations                predicates.go:131-142
7. memory/disk/pid pressure          predicates.go:145-184
8. pod (anti-)affinity               predicates.go:187-199

Every check is a pure function of (pod spec, node spec, resident pods).
The encoder (ops/encode.py) evaluates the task-static x node-static subset
(2, 3, 4, 6, 7) once per (task-group, node-group) pair with these
functions; pod count (1) and host ports (5) are dynamic and live in the
solve; pod (anti-)affinity (8) is pairwise-dynamic and routes its task to
the host step (ops/encode.py ``host_only``), where this plugin's
predicate_fn runs it.
"""

from __future__ import annotations

from kube_batch_tpu_torch.api.job_info import TaskInfo
from kube_batch_tpu_torch.api.node_info import NodeInfo
from kube_batch_tpu_torch.apis.types import Node, Pod
from kube_batch_tpu_torch.framework.arguments import Arguments
from kube_batch_tpu_torch.framework.interface import Plugin
from kube_batch_tpu_torch.framework.session import Session


class PredicateError(Exception):
    """A predicate rejected (task, node); the message mirrors the
    reference's error strings."""


# -- pure checks (shared with ops.encode) -----------------------------------


def check_max_task_num(node: NodeInfo, current_tasks: int) -> bool:
    """predicates.go:70-72: room for one more pod."""
    return node.allocatable.max_task_num > current_tasks


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


def check_host_ports(pod: Pod, node: NodeInfo) -> bool:
    """PodFitsHostPorts (predicates.go:117-128)."""
    wanted = {p for c in pod.containers for p in c.ports}
    if not wanted:
        return True
    used = {
        p
        for task in node.tasks.values()
        for c in task.pod.containers
        for p in c.ports
    }
    return not (wanted & used)


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


def _selector_matches(selector: dict[str, str], labels: dict[str, str]) -> bool:
    return all(labels.get(k) == v for k, v in selector.items())


def check_pod_affinity(pod: Pod, node: NodeInfo, all_nodes: dict[str, NodeInfo]) -> bool:
    """Required pod (anti-)affinity over topology domains
    (predicates.go:187-199). Topology domain = set of nodes sharing the
    term's topology_key label value with the candidate node."""
    if pod.affinity is None:
        return True
    aff = pod.affinity
    if not aff.pod_affinity_required and not aff.pod_anti_affinity_required:
        return True

    def domain_pods(topology_key: str):
        node_labels = node.node.labels if node.node else {}
        domain_value = node_labels.get(topology_key)
        for other in all_nodes.values():
            other_labels = other.node.labels if other.node else {}
            if topology_key == "kubernetes.io/hostname":
                in_domain = other.name == node.name
            else:
                in_domain = (
                    domain_value is not None
                    and other_labels.get(topology_key) == domain_value
                )
            if in_domain:
                for task in other.tasks.values():
                    yield task.pod

    for term in aff.pod_affinity_required:
        if not any(
            _selector_matches(term.label_selector, p.metadata.labels)
            for p in domain_pods(term.topology_key)
        ):
            return False
    for term in aff.pod_anti_affinity_required:
        if any(
            _selector_matches(term.label_selector, p.metadata.labels)
            for p in domain_pods(term.topology_key)
            if p is not pod
        ):
            return False
    return True


class PredicatesPlugin(Plugin):
    def __init__(self, arguments: Arguments) -> None:
        self.arguments = arguments

    @property
    def name(self) -> str:
        return "predicates"

    def on_session_open(self, ssn: Session) -> None:
        def predicate_fn(task: TaskInfo, node: NodeInfo) -> None:
            if node.node is None:
                raise PredicateError(f"node <{node.name}> has no node object")
            if not check_max_task_num(node, len(node.tasks)):
                raise PredicateError(
                    f"node <{node.name}> can not allow more task running on it"
                )
            if not check_node_condition(node.node):
                raise PredicateError(
                    f"node <{node.name}> are not available to schedule task "
                    f"<{task.namespace}/{task.name}>"
                )
            if not check_node_unschedulable(task.pod, node.node):
                raise PredicateError(
                    f"task <{task.namespace}/{task.name}> node <{node.name}> "
                    f"set to unschedulable"
                )
            if not check_node_selector(task.pod, node.node):
                raise PredicateError(
                    f"node <{node.name}> didn't match task "
                    f"<{task.namespace}/{task.name}> node selector"
                )
            if not check_host_ports(task.pod, node):
                raise PredicateError(
                    f"node <{node.name}> didn't have available host ports for "
                    f"task <{task.namespace}/{task.name}>"
                )
            if not check_taints(task.pod, node.node):
                raise PredicateError(
                    f"task <{task.namespace}/{task.name}> does not tolerate "
                    f"node <{node.name}> taints"
                )
            if not check_pressure(node.node):
                raise PredicateError(
                    f"node <{node.name}> under pressure, can not schedule task "
                    f"<{task.namespace}/{task.name}>"
                )
            if not check_pod_affinity(task.pod, node, ssn.nodes):
                raise PredicateError(
                    f"task <{task.namespace}/{task.name}> affinity/anti-affinity "
                    f"failed on node <{node.name}>"
                )

        ssn.add_predicate_fn(self.name, predicate_fn)


def new(arguments: Arguments) -> Plugin:
    return PredicatesPlugin(arguments)
