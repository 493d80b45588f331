"""Action / Plugin / Cache interfaces
(reference pkg/scheduler/framework/interface.go:20-41,
pkg/scheduler/cache/interface.go:27-78)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import TYPE_CHECKING, Optional, Protocol

from kube_batch_tpu_torch.api.cluster_info import ClusterInfo
from kube_batch_tpu_torch.api.job_info import JobInfo, TaskInfo

if TYPE_CHECKING:
    from kube_batch_tpu_torch.framework.session import Session


class Action(ABC):
    """A pipeline stage (reference interface.go:20-33)."""

    @property
    @abstractmethod
    def name(self) -> str: ...

    def initialize(self) -> None:
        return None

    @abstractmethod
    def execute(self, ssn: "Session") -> None: ...

    def uninitialize(self) -> None:
        return None


class Plugin(ABC):
    """A policy hook provider (reference interface.go:35-41). Plugins are
    re-instantiated from their builder every session."""

    @property
    @abstractmethod
    def name(self) -> str: ...

    @abstractmethod
    def on_session_open(self, ssn: "Session") -> None: ...

    def on_session_close(self, ssn: "Session") -> None:
        return None


class Cache(Protocol):
    """What a Session needs from the cluster cache
    (reference cache/interface.go:27-56)."""

    def snapshot(self) -> ClusterInfo: ...

    def bind(self, task: TaskInfo, hostname: str) -> None: ...

    def evict(self, task: TaskInfo, reason: str) -> None: ...

    def update_job_status(self, job: JobInfo) -> Optional[JobInfo]: ...

    def record_job_status_event(self, job: JobInfo) -> None: ...

    def allocate_volumes(self, task: TaskInfo, hostname: str) -> None: ...

    def bind_volumes(self, task: TaskInfo) -> None: ...
