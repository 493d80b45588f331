"""Session events: callbacks that keep plugin-internal state (DRF shares,
proportion allocations) in sync per assignment
(reference pkg/scheduler/framework/event.go:24-32)."""

from __future__ import annotations

from typing import Callable, Optional

from kube_batch_tpu_torch.api.job_info import TaskInfo


class Event:
    __slots__ = ("task",)

    def __init__(self, task: TaskInfo) -> None:
        self.task = task


class EventHandler:
    __slots__ = ("allocate_func", "deallocate_func")

    def __init__(
        self,
        allocate_func: Optional[Callable[[Event], None]] = None,
        deallocate_func: Optional[Callable[[Event], None]] = None,
    ) -> None:
        self.allocate_func = allocate_func
        self.deallocate_func = deallocate_func
