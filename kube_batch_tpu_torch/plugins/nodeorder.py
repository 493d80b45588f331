"""nodeorder plugin's label-world scores and weight names
(reference pkg/scheduler/plugins/nodeorder/nodeorder.go:109-222).

LeastRequested and BalancedResourceAllocation are computed inside the
solve (ops/kernels.py, csrc/fused_solve.cu). The two label terms are
pure functions of pod specs, node labels and residents, precomputed by
the encoder:

- NodeAffinity (preferred): raw sum of matching preferred-term weights —
  the reference calls CalculateNodeAffinityPriorityMap without the
  normalizing reduce (nodeorder.go:199-205), so the raw sum is parity.
- InterPodAffinity: the full k8s-1.13 symmetric-weight algorithm
  (nodeorder.go:210-216 -> CalculateInterPodAffinityPriority), normalized
  to 0..10.
"""

from __future__ import annotations

from kube_batch_tpu_torch.api.job_info import TaskInfo
from kube_batch_tpu_torch.api.node_info import NodeInfo

MAX_PRIORITY = 10  # schedulerapi.MaxPriority

NODE_AFFINITY_WEIGHT = "nodeaffinity.weight"
POD_AFFINITY_WEIGHT = "podaffinity.weight"
LEAST_REQUESTED_WEIGHT = "leastrequested.weight"
BALANCED_RESOURCE_WEIGHT = "balancedresource.weight"


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
