"""Statement: operation log for speculative preemption
(reference pkg/scheduler/framework/statement.go:26-222).

``evict``/``pipeline`` apply session-state changes immediately and append
ops; ``commit`` replays evictions against the real cache (pipelines need
no cache action); ``discard`` undoes everything in reverse order.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from kube_batch_tpu_torch.api.job_info import TaskInfo
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.framework.event import Event

if TYPE_CHECKING:
    from kube_batch_tpu_torch.framework.session import Session


class Statement:
    def __init__(self, ssn: "Session") -> None:
        self._ssn = ssn
        self._operations: list[tuple[str, tuple]] = []

    # -- speculative ops (session state only) -------------------------------

    def evict(self, reclaimee: TaskInfo, reason: str) -> None:
        """statement.go:37-69: mark Releasing in session, log the op."""
        ssn = self._ssn
        ssn.bump_state()
        job = ssn.jobs.get(reclaimee.job)
        if job is not None:
            job.update_task_status(reclaimee, TaskStatus.RELEASING)
        node = ssn.nodes.get(reclaimee.node_name)
        if node is not None:
            node.update_task(reclaimee)
        for eh in ssn.event_handlers:
            if eh.deallocate_func is not None:
                eh.deallocate_func(Event(reclaimee))
        self._operations.append(("evict", (reclaimee, reason)))

    def pipeline(self, task: TaskInfo, hostname: str) -> None:
        """statement.go:113-154."""
        ssn = self._ssn
        ssn.bump_state()
        job = ssn.jobs.get(task.job)
        if job is not None:
            job.update_task_status(task, TaskStatus.PIPELINED)
        task.node_name = hostname
        node = ssn.nodes.get(hostname)
        if node is not None:
            node.add_task(task)
        for eh in ssn.event_handlers:
            if eh.allocate_func is not None:
                eh.allocate_func(Event(task))
        self._operations.append(("pipeline", (task, hostname)))

    # -- undo helpers -------------------------------------------------------

    def _unevict(self, reclaimee: TaskInfo) -> None:
        """statement.go:83-110: restore the victim to Running."""
        ssn = self._ssn
        ssn.bump_state()
        job = ssn.jobs.get(reclaimee.job)
        if job is not None:
            job.update_task_status(reclaimee, TaskStatus.RUNNING)
        node = ssn.nodes.get(reclaimee.node_name)
        if node is not None:
            node.update_task(reclaimee)
        for eh in ssn.event_handlers:
            if eh.allocate_func is not None:
                eh.allocate_func(Event(reclaimee))

    def _unpipeline(self, task: TaskInfo) -> None:
        """statement.go:159-195: back to Pending, off the node."""
        ssn = self._ssn
        ssn.bump_state()
        job = ssn.jobs.get(task.job)
        if job is not None:
            job.update_task_status(task, TaskStatus.PENDING)
        node = ssn.nodes.get(task.node_name)
        if node is not None:
            node.remove_task(task)
        task.node_name = ""
        for eh in ssn.event_handlers:
            if eh.deallocate_func is not None:
                eh.deallocate_func(Event(task))

    # -- terminal -----------------------------------------------------------

    def commit(self) -> None:
        """Replay evictions against the real cache (statement.go:212-222);
        a failed cache evict is rolled back in session state (:71-81)."""
        for name, args in self._operations:
            if name == "evict":
                reclaimee, reason = args
                try:
                    self._ssn.cache.evict(reclaimee, reason)
                except Exception:
                    self._unevict(reclaimee)

    def discard(self) -> None:
        """Undo in reverse order (statement.go:198-209)."""
        for name, args in reversed(self._operations):
            if name == "evict":
                self._unevict(args[0])
            elif name == "pipeline":
                self._unpipeline(args[0])
