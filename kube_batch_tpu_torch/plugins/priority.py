"""priority plugin: higher pod/PriorityClass value schedules first
(reference pkg/scheduler/plugins/priority/priority.go:39-80)."""

from __future__ import annotations

from kube_batch_tpu_torch.api.job_info import JobInfo, TaskInfo
from kube_batch_tpu_torch.framework.arguments import Arguments
from kube_batch_tpu_torch.framework.interface import Plugin
from kube_batch_tpu_torch.framework.session import Session


class PriorityPlugin(Plugin):
    def __init__(self, arguments: Arguments) -> None:
        self.arguments = arguments

    @property
    def name(self) -> str:
        return "priority"

    def on_session_open(self, ssn: Session) -> None:
        def task_order_fn(l: TaskInfo, r: TaskInfo) -> int:
            # Higher priority pops first (priority.go:39-57).
            if l.priority == r.priority:
                return 0
            return -1 if l.priority > r.priority else 1

        ssn.add_task_order_fn(self.name, task_order_fn)

        def job_order_fn(l: JobInfo, r: JobInfo) -> int:
            # priority.go:61-77.
            if l.priority > r.priority:
                return -1
            if l.priority < r.priority:
                return 1
            return 0

        ssn.add_job_order_fn(self.name, job_order_fn)


def new(arguments: Arguments) -> Plugin:
    return PriorityPlugin(arguments)
