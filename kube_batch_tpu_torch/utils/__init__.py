"""Scheduler utilities: priority queue + node predicate/score helpers
(reference pkg/scheduler/util/)."""

from kube_batch_tpu_torch.utils.priority_queue import PriorityQueue
from kube_batch_tpu_torch.utils.scheduler_helper import (
    get_node_list,
    predicate_nodes,
    prioritize_nodes,
    select_best_node,
    sort_nodes,
)

__all__ = [
    "PriorityQueue",
    "get_node_list",
    "predicate_nodes",
    "prioritize_nodes",
    "select_best_node",
    "sort_nodes",
]
