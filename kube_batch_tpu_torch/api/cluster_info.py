"""ClusterInfo: the per-cycle snapshot triple
(reference pkg/scheduler/api/cluster_info.go:22-26)."""

from __future__ import annotations

from kube_batch_tpu_torch.api.job_info import JobInfo
from kube_batch_tpu_torch.api.node_info import NodeInfo
from kube_batch_tpu_torch.api.queue_info import QueueInfo


class ClusterInfo:
    __slots__ = ("jobs", "nodes", "queues")

    def __init__(
        self,
        jobs: dict[str, JobInfo] | None = None,
        nodes: dict[str, NodeInfo] | None = None,
        queues: dict[str, QueueInfo] | None = None,
    ) -> None:
        self.jobs: dict[str, JobInfo] = jobs or {}
        self.nodes: dict[str, NodeInfo] = nodes or {}
        self.queues: dict[str, QueueInfo] = queues or {}

    def __repr__(self) -> str:
        return (
            f"Cluster: jobs {len(self.jobs)}, nodes {len(self.nodes)}, "
            f"queues {len(self.queues)}"
        )
