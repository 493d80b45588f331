"""Task status state machine (reference pkg/scheduler/api/types.go:26-84)."""

from __future__ import annotations

from enum import IntEnum


class TaskStatus(IntEnum):
    """10-state task lifecycle (reference types.go:26-58). IntEnum so the
    status doubles as the tensor encoding on the solve path."""

    PENDING = 0      # waiting in queue
    ALLOCATED = 1    # resources assigned, not dispatched (gang barrier holds it)
    PIPELINED = 2    # assigned onto releasing resources; dispatch when freed
    BINDING = 3      # bind RPC in flight
    BOUND = 4        # bound to host, kubelet not started it yet
    RUNNING = 5
    RELEASING = 6    # being deleted / preempted
    SUCCEEDED = 7
    FAILED = 8
    UNKNOWN = 9

    def __str__(self) -> str:  # "Pending" etc., matching reference labels
        return self.name.capitalize()


# Statuses that count as "holding resources" (reference helpers.go:64-71).
ALLOCATED_STATUSES = frozenset(
    {TaskStatus.BOUND, TaskStatus.BINDING, TaskStatus.RUNNING, TaskStatus.ALLOCATED}
)


def allocated_status(status: TaskStatus) -> bool:
    return status in ALLOCATED_STATUSES


_DISALLOWED_TRANSITIONS: frozenset[tuple[TaskStatus, TaskStatus]] = frozenset(
    {
        # Terminal states never transition back to active scheduling states.
        (TaskStatus.SUCCEEDED, TaskStatus.PENDING),
        (TaskStatus.SUCCEEDED, TaskStatus.ALLOCATED),
        (TaskStatus.SUCCEEDED, TaskStatus.PIPELINED),
        (TaskStatus.SUCCEEDED, TaskStatus.BINDING),
        (TaskStatus.FAILED, TaskStatus.ALLOCATED),
        (TaskStatus.FAILED, TaskStatus.PIPELINED),
        (TaskStatus.FAILED, TaskStatus.BINDING),
    }
)


def validate_status_update(old: TaskStatus, new: TaskStatus) -> None:
    """Guard task status transitions. The reference stub allows everything
    (types.go:82-84); this rebuild rejects the transitions that would
    corrupt the gang barrier's ready-count accounting (a terminal task
    re-entering the allocated set). Raises ValueError on a disallowed
    transition."""
    if (old, new) in _DISALLOWED_TRANSITIONS:
        raise ValueError(f"invalid task status transition {old!s} -> {new!s}")


class ValidateResult:
    """Result of a JobValid check (reference api/types.go:69-80)."""

    __slots__ = ("passed", "reason", "message")

    def __init__(self, passed: bool, reason: str = "", message: str = "") -> None:
        self.passed = passed
        self.reason = reason
        self.message = message

    def __repr__(self) -> str:
        return f"ValidateResult(passed={self.passed}, reason={self.reason!r})"
