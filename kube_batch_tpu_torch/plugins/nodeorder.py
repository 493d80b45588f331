"""nodeorder plugin: weighted sum of upstream k8s priorities
(reference pkg/scheduler/plugins/nodeorder/nodeorder.go:109-222).

Implements the same four priorities with the k8s 1.13 formulas:

- LeastRequested:  ((cap - req) * 10 // cap) per cpu/mem, averaged with
  integer division (k8s least_requested.go).
- BalancedResourceAllocation: 10 - |cpuFraction - memFraction| * 10,
  floored; 0 when either fraction >= 1 (k8s balanced_resource_allocation.go).
- NodeAffinity (preferred): raw sum of matching preferred-term weights —
  the reference calls CalculateNodeAffinityPriorityMap without the
  normalizing reduce (nodeorder.go:199-205), so the raw sum is parity.
- InterPodAffinity: the full k8s-1.13 symmetric-weight algorithm
  (nodeorder.go:210-216 -> CalculateInterPodAffinityPriority): incoming
  pod's preferred terms, existing pods' preferred terms toward the
  incoming pod, and existing pods' *required* terms at the hard symmetric
  weight, summed over topology domains and normalized to 0..10. The
  reference rebuilds its node map per scored node (a known perf sink,
  SURVEY.md section 2.6); here the all-nodes score map is computed once
  per (task, session-state) and memoized via ssn.state_seq.

All four are pure functions of (task request, node used/allocatable,
labels), so the solve computes the first two itself (ops/kernels.py,
csrc/fused_solve.cu, csrc/block_step.cu) and the encoder precomputes the
label terms as matrices (ops/encode.py).
"""

from __future__ import annotations


from kube_batch_tpu_torch.api.job_info import TaskInfo
from kube_batch_tpu_torch.api.node_info import NodeInfo
from kube_batch_tpu_torch.framework.arguments import Arguments
from kube_batch_tpu_torch.framework.interface import Plugin
from kube_batch_tpu_torch.framework.session import Session

MAX_PRIORITY = 10  # schedulerapi.MaxPriority

NODE_AFFINITY_WEIGHT = "nodeaffinity.weight"
POD_AFFINITY_WEIGHT = "podaffinity.weight"
LEAST_REQUESTED_WEIGHT = "leastrequested.weight"
BALANCED_RESOURCE_WEIGHT = "balancedresource.weight"


def least_requested_score(requested_cpu: float, requested_mem: float,
                          cap_cpu: float, cap_mem: float) -> int:
    """k8s LeastRequestedPriorityMap: per-dimension integer score
    ((cap-req)*10)//cap, clamped at 0, averaged with integer division.

    Computed in the comparison dtype (api/numerics.py) like
    balanced_resource_score: byte-denominated memory caps exceed the f32
    integer range, so the floor boundary must land where the f32 device
    kernels put it, not where exact float64 would."""
    from kube_batch_tpu_torch.api.numerics import comparison_dtype

    dt = comparison_dtype()

    def dim(req: float, cap: float) -> int:
        if cap == 0:
            return 0
        if req > cap:
            return 0
        return int(((dt(cap) - dt(req)) * dt(MAX_PRIORITY)) // dt(cap))

    return (dim(requested_cpu, cap_cpu) + dim(requested_mem, cap_mem)) // 2


def balanced_resource_score(requested_cpu: float, requested_mem: float,
                            cap_cpu: float, cap_mem: float) -> int:
    """k8s BalancedResourceAllocationMap: 10 - |cpuF - memF| * 10 floored;
    0 when either fraction >= 1.

    Fractions are off the integer grid, so every operation runs in the
    comparison dtype (api/numerics.py): in f32 mode the truncation
    boundary lands exactly where the device kernels put it, keeping node
    choice bit-identical to the solve."""
    from kube_batch_tpu_torch.api.numerics import comparison_dtype

    dt = comparison_dtype()

    def fraction(req: float, cap: float):
        return dt(req) / dt(cap) if cap != 0 else dt(1.0)

    cpu_f = fraction(requested_cpu, cap_cpu)
    mem_f = fraction(requested_mem, cap_mem)
    if cpu_f >= 1.0 or mem_f >= 1.0:
        return 0
    return int(dt(MAX_PRIORITY) - abs(cpu_f - mem_f) * dt(MAX_PRIORITY))


def node_affinity_score(task: TaskInfo, node: NodeInfo) -> int:
    """Sum of preferred node-affinity term weights matching node labels."""
    affinity = task.pod.affinity
    if affinity is None or not affinity.node_affinity_preferred:
        return 0
    labels = node.node.labels if node.node else {}
    return sum(w for w, term in affinity.node_affinity_preferred if term.matches(labels))


# v1.DefaultHardPodAffinitySymmetricWeight (k8s 1.13): each *required*
# affinity term an existing pod holds toward the incoming pod scores this
# much over the existing pod's topology domain.
HARD_POD_AFFINITY_SYMMETRIC_WEIGHT = 1


def _sel_matches(selector: dict[str, str], labels: dict[str, str]) -> bool:
    return all(labels.get(k) == v for k, v in selector.items())


def vectorized_least_balanced(req_cpu, req_mem, cap_cpu, cap_mem):
    """Whole-node-axis twins of least_requested_score /
    balanced_resource_score (identical floor/trunc semantics to the
    scalar formulas above), used by the plugin's node_order_fn. Computed
    in the comparison dtype (api/numerics.py) so truncation boundaries
    match the solve's float32."""
    import numpy as np

    from kube_batch_tpu_torch.api.numerics import comparison_dtype

    dt = comparison_dtype()
    req_cpu = np.asarray(req_cpu, dt)
    req_mem = np.asarray(req_mem, dt)
    cap_cpu = np.asarray(cap_cpu, dt)
    cap_mem = np.asarray(cap_mem, dt)

    def least_dim(rq, cp):
        safe = np.where(cp == 0.0, 1.0, cp)
        sc = np.floor_divide((cp - rq) * MAX_PRIORITY, safe)
        return np.where((cp == 0.0) | (rq > cp), 0.0, sc)

    least = np.floor_divide(
        least_dim(req_cpu, cap_cpu) + least_dim(req_mem, cap_mem), 2.0
    )
    cpu_f = np.where(
        cap_cpu != 0.0, req_cpu / np.where(cap_cpu == 0.0, 1.0, cap_cpu), 1.0
    )
    mem_f = np.where(
        cap_mem != 0.0, req_mem / np.where(cap_mem == 0.0, 1.0, cap_mem), 1.0
    )
    balanced = np.where(
        (cpu_f >= 1.0) | (mem_f >= 1.0),
        0.0,
        np.trunc(MAX_PRIORITY - np.abs(cpu_f - mem_f) * MAX_PRIORITY),
    )
    return least, balanced


def any_pod_affinity_terms(nodes: dict[str, NodeInfo], tasks) -> bool:
    """True when any resident or given pod carries pod-affinity terms."""
    for t in tasks:
        aff = t.pod.affinity
        if aff is not None and aff.has_pod_affinity_terms():
            return True
    for node in nodes.values():
        for resident in node.tasks.values():
            aff = resident.pod.affinity
            if aff is not None and aff.has_pod_affinity_terms():
                return True
    return False


def interpod_affinity_scores(task: TaskInfo, nodes: dict[str, NodeInfo]) -> dict[str, int]:
    """k8s 1.13 CalculateInterPodAffinityPriority over every node (the
    algorithm behind the reference's NewInterPodAffinityPriority map fn,
    nodeorder.go:210-216):

    for each existing pod E on each node (anchored at E's node's topology
    domain):
    - incoming pod's *preferred* (anti-)affinity terms matching E:
      +/- term weight;
    - E's *preferred* (anti-)affinity terms matching the incoming pod:
      +/- term weight (the symmetric half);
    - E's *required* affinity terms matching the incoming pod:
      + hardPodAffinitySymmetricWeight each;
    then normalize to 0..10 ints: 10 * (count - min) / (max - min).

    Model notes (same deviations as predicates.check_pod_affinity): the
    ``kubernetes.io/hostname`` topology domain is the anchor node itself
    (nodes carry no implicit hostname label here), and terms match
    cluster-wide (PodAffinityTerm has no namespaces field).
    """
    counts: dict[str, float] = {name: 0.0 for name in nodes}
    p_aff = task.pod.affinity
    p_labels = task.pod.metadata.labels

    def add_domain(anchor: NodeInfo, topology_key: str, weight: float) -> None:
        if topology_key == "kubernetes.io/hostname":
            counts[anchor.name] += weight
            return
        labels = anchor.node.labels if anchor.node else {}
        value = labels.get(topology_key)
        if value is None:
            return
        for other in nodes.values():
            other_labels = other.node.labels if other.node else {}
            if other_labels.get(topology_key) == value:
                counts[other.name] += weight

    for node in nodes.values():
        for resident in node.tasks.values():
            epod = resident.pod
            if epod is task.pod:
                continue
            e_labels = epod.metadata.labels
            if p_aff is not None:
                for w, term in p_aff.pod_affinity_preferred:
                    if _sel_matches(term.label_selector, e_labels):
                        add_domain(node, term.topology_key, w)
                for w, term in p_aff.pod_anti_affinity_preferred:
                    if _sel_matches(term.label_selector, e_labels):
                        add_domain(node, term.topology_key, -w)
            e_aff = epod.affinity
            if e_aff is not None:
                for w, term in e_aff.pod_affinity_preferred:
                    if _sel_matches(term.label_selector, p_labels):
                        add_domain(node, term.topology_key, w)
                for w, term in e_aff.pod_anti_affinity_preferred:
                    if _sel_matches(term.label_selector, p_labels):
                        add_domain(node, term.topology_key, -w)
                if HARD_POD_AFFINITY_SYMMETRIC_WEIGHT > 0:
                    for term in e_aff.pod_affinity_required:
                        if _sel_matches(term.label_selector, p_labels):
                            add_domain(
                                node,
                                term.topology_key,
                                HARD_POD_AFFINITY_SYMMETRIC_WEIGHT,
                            )

    mx = max(counts.values(), default=0.0)
    mn = min(counts.values(), default=0.0)
    diff = mx - mn
    if diff <= 0:
        return {name: 0 for name in counts}
    return {name: int(MAX_PRIORITY * ((c - mn) / diff)) for name, c in counts.items()}


class NodeOrderPlugin(Plugin):
    def __init__(self, arguments: Arguments) -> None:
        self.arguments = arguments

    @property
    def name(self) -> str:
        return "nodeorder"

    def on_session_open(self, ssn: Session) -> None:
        import numpy as np

        # Weights default to 1 (nodeorder.go:139-153).
        least_req_w = self.arguments.get_int(LEAST_REQUESTED_WEIGHT, 1)
        balanced_w = self.arguments.get_int(BALANCED_RESOURCE_WEIGHT, 1)
        node_aff_w = self.arguments.get_int(NODE_AFFINITY_WEIGHT, 1)
        pod_aff_w = self.arguments.get_int(POD_AFFINITY_WEIGHT, 1)

        # least/balanced memo: one comparison-dtype vectorized pass over
        # the whole node axis per (task, session-state) — the serial
        # scan then pays a dict lookup per node instead of 5+ boxed f32
        # scalar ops per (task, node) pair. Values are identical:
        # vectorized_least_balanced is the twin of the scalar formulas,
        # in the same dtype. Session node membership is immutable, so
        # caps/index build once and the used sweep keys on state_seq
        # alone.
        n_nodes = len(ssn.nodes)
        lb_idx = {name: i for i, name in enumerate(ssn.nodes)}
        cap_c = np.fromiter(
            (n.allocatable.milli_cpu for n in ssn.nodes.values()), np.float64,
            count=n_nodes,
        )
        cap_m = np.fromiter(
            (n.allocatable.memory for n in ssn.nodes.values()), np.float64,
            count=n_nodes,
        )
        used_memo: dict = {"seq": -1, "c": None, "m": None}
        lb_memo: dict = {"uid": None, "seq": -1, "least": None, "balanced": None}

        def lb_scores(task: TaskInfo):
            if lb_memo["uid"] != task.uid or lb_memo["seq"] != ssn.state_seq:
                if used_memo["seq"] != ssn.state_seq:
                    used_memo["c"] = np.fromiter(
                        (n.used.milli_cpu for n in ssn.nodes.values()),
                        np.float64, count=n_nodes,
                    )
                    used_memo["m"] = np.fromiter(
                        (n.used.memory for n in ssn.nodes.values()),
                        np.float64, count=n_nodes,
                    )
                    used_memo["seq"] = ssn.state_seq
                least, balanced = vectorized_least_balanced(
                    used_memo["c"] + task.resreq.milli_cpu,
                    used_memo["m"] + task.resreq.memory,
                    cap_c,
                    cap_m,
                )
                lb_memo["uid"] = task.uid
                lb_memo["seq"] = ssn.state_seq
                lb_memo["least"] = least
                lb_memo["balanced"] = balanced
            return lb_memo
        # InterPodAffinity memo: the all-nodes score map for one task,
        # invalidated by any session mutation (ssn.state_seq); the serial
        # node scan calls node_order_fn once per node for the same task.
        # Fast path: if no pod anywhere in the snapshot carries terms,
        # every score is 0 forever — the common cluster pays O(1), not a
        # per-task O(nodes x residents) walk. (Pods cannot be *added*
        # mid-session, so a False verdict holds for the whole session.)
        memo: dict = {"uid": None, "seq": -1, "scores": {}, "active": None}

        def interpod_score(task: TaskInfo, node: NodeInfo) -> int:
            if memo["active"] is None:
                all_tasks = (t for j in ssn.jobs.values() for t in j.tasks.values())
                memo["active"] = any_pod_affinity_terms(ssn.nodes, all_tasks)
            if not memo["active"]:
                return 0
            if memo["uid"] != task.uid or memo["seq"] != ssn.state_seq:
                memo["uid"] = task.uid
                memo["seq"] = ssn.state_seq
                memo["scores"] = interpod_affinity_scores(task, ssn.nodes)
            return memo["scores"].get(node.name, 0)

        def node_order_fn(task: TaskInfo, node: NodeInfo) -> float:
            lb = lb_scores(task)
            i = lb_idx[node.name]
            score = float(lb["least"][i]) * least_req_w
            score += float(lb["balanced"][i]) * balanced_w
            score += node_affinity_score(task, node) * node_aff_w
            score += interpod_score(task, node) * pod_aff_w
            return score

        ssn.add_node_order_fn(self.name, node_order_fn)


def new(arguments: Arguments) -> Plugin:
    return NodeOrderPlugin(arguments)
