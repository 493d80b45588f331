"""QueueInfo (reference pkg/scheduler/api/queue_info.go:29-58)."""

from __future__ import annotations

from kube_batch_tpu_torch.apis.types import Queue


class QueueInfo:
    __slots__ = ("uid", "name", "weight", "queue")

    def __init__(self, queue: Queue) -> None:
        self.uid: str = queue.metadata.uid
        self.name: str = queue.name
        self.weight: int = queue.spec.weight
        self.queue: Queue = queue

    def clone(self) -> "QueueInfo":
        return QueueInfo(self.queue)

    def __repr__(self) -> str:
        return f"Queue ({self.name}): weight {self.weight}"
