"""Node filtering/scoring helpers (reference pkg/scheduler/util/scheduler_helper.go).

The reference fans these loops out over 16 goroutines
(scheduler_helper.go:34-109). Here the serial implementations stay simple
and deterministic — they are the correctness oracle, and the host step of
the device action; the device replacement for the same loops is the solve
(ops/kernels.py and its CUDA kernels: the feasibility test, the score and
the arg-max over the whole node axis).

Documented deviation: the reference's SelectBestNode picks randomly among
equal-score nodes (scheduler_helper.go:127-138). Both paths here break
ties deterministically by position in the node list so that the serial
path and the device path are comparable assignment-for-assignment in the
property tests.
"""

from __future__ import annotations

from typing import Callable, Optional

from kube_batch_tpu_torch.api.job_info import TaskInfo
from kube_batch_tpu_torch.api.node_info import NodeInfo

PredicateFn = Callable[[TaskInfo, NodeInfo], None]  # raises on failure
NodeOrderMapFn = Callable[[TaskInfo, NodeInfo], tuple[dict[str, float], float]]
NodeOrderReduceFn = Callable[[TaskInfo, dict[str, list[tuple[str, int]]]], dict[str, float]]


def get_node_list(nodes: dict[str, NodeInfo]) -> list[NodeInfo]:
    """Deterministic node list: sorted by name (reference GetNodeList
    iterates a Go map — random order; sorting keeps the serial path
    reproducible)."""
    return [nodes[name] for name in sorted(nodes)]


def predicate_nodes(
    task: TaskInfo, nodes: list[NodeInfo], fn: PredicateFn
) -> list[NodeInfo]:
    """Filter nodes that pass the predicate (reference
    scheduler_helper.go:34-57). Predicates signal failure by raising."""
    out: list[NodeInfo] = []
    for node in nodes:
        try:
            fn(task, node)
        except Exception:
            continue
        out.append(node)
    return out


def prioritize_nodes(
    task: TaskInfo,
    nodes: list[NodeInfo],
    map_fn: NodeOrderMapFn,
    reduce_fn: Optional[NodeOrderReduceFn] = None,
) -> dict[float, list[NodeInfo]]:
    """Score nodes and bucket them by score (reference
    scheduler_helper.go:60-109): per-node map phase collects per-plugin
    map-scores (floored to int, matching HostPriority.Score) plus the
    plain order score; the reduce phase may normalize map-scores; final
    score = reduced map total + order score."""
    plugin_node_scores: dict[str, list[tuple[str, int]]] = {}
    order_scores: dict[str, float] = {}
    for node in nodes:
        map_scores, order_score = map_fn(task, node)
        for plugin, score in map_scores.items():
            plugin_node_scores.setdefault(plugin, []).append((node.name, int(score // 1)))
        order_scores[node.name] = order_score

    reduced: dict[str, float] = {}
    if reduce_fn is not None:
        reduced = reduce_fn(task, plugin_node_scores)

    node_scores: dict[float, list[NodeInfo]] = {}
    for node in nodes:
        score = reduced.get(node.name, 0.0) + order_scores.get(node.name, 0.0)
        node_scores.setdefault(score, []).append(node)
    return node_scores


def sort_nodes(node_scores: dict[float, list[NodeInfo]]) -> list[NodeInfo]:
    """Nodes in descending score order (reference scheduler_helper.go:112-124)."""
    out: list[NodeInfo] = []
    for score in sorted(node_scores, reverse=True):
        out.extend(node_scores[score])
    return out


def select_best_node(node_scores: dict[float, list[NodeInfo]]) -> Optional[NodeInfo]:
    """Highest-scoring node; deterministic first-of-bucket tie-break
    (deviation from the reference's random pick, see module docstring)."""
    best: Optional[list[NodeInfo]] = None
    max_score = float("-inf")
    for score, bucket in node_scores.items():
        if score > max_score and bucket:
            max_score = score
            best = bucket
    return best[0] if best else None
