"""TaskInfo + JobInfo: the gang unit and its members
(reference pkg/scheduler/api/job_info.go)."""

from __future__ import annotations

from typing import Optional

from kube_batch_tpu_torch.apis.types import (
    GROUP_NAME_ANNOTATION_KEY,
    Pod,
    PodDisruptionBudget,
    PodGroup,
)
from kube_batch_tpu_torch.api.helpers import (
    get_pod_resource_request,
    get_pod_resource_without_init_containers,
    get_task_status,
)
from kube_batch_tpu_torch.api.resource_info import Resource
from kube_batch_tpu_torch.api.types import (
    TaskStatus,
    allocated_status,
    validate_status_update,
)


def pod_key(pod: Pod) -> str:
    """namespace/name key (reference helpers.go:27-33)."""
    return f"{pod.namespace}/{pod.name}"


def task_key(task: "TaskInfo") -> str:
    return task.uid


def job_key(namespace: str, group_name: str) -> str:
    return f"{namespace}/{group_name}"


def get_job_id(pod: Pod) -> str:
    """Gang membership from the group-name annotation
    (reference job_info.go:57-67)."""
    gn = pod.metadata.annotations.get(GROUP_NAME_ANNOTATION_KEY, "")
    if gn:
        return job_key(pod.namespace, gn)
    return ""


class TaskInfo:
    """One pod as seen by the scheduler (reference job_info.go:36-124)."""

    __slots__ = (
        "uid",
        "job",
        "name",
        "namespace",
        "resreq",
        "init_resreq",
        "node_name",
        "status",
        "priority",
        "volume_ready",
        "pod",
    )

    def __init__(self, pod: Pod) -> None:
        self.uid: str = pod.metadata.uid
        self.job: str = get_job_id(pod)
        self.name: str = pod.name
        self.namespace: str = pod.namespace
        # Resreq: what the task consumes while running (no init containers);
        # InitResreq: what it takes to launch it — used for admission checks
        # (reference job_info.go:44-48, allocate.go:86,157).
        self.resreq: Resource = get_pod_resource_without_init_containers(pod)
        self.init_resreq: Resource = get_pod_resource_request(pod)
        self.node_name: str = pod.node_name
        self.status: TaskStatus = get_task_status(pod)
        self.priority: int = pod.priority if pod.priority is not None else 1
        self.volume_ready: bool = False
        self.pod: Pod = pod

    def clone(self) -> "TaskInfo":
        ti = TaskInfo.__new__(TaskInfo)
        ti.uid = self.uid
        ti.job = self.job
        ti.name = self.name
        ti.namespace = self.namespace
        ti.resreq = self.resreq.clone()
        ti.init_resreq = self.init_resreq.clone()
        ti.node_name = self.node_name
        ti.status = self.status
        ti.priority = self.priority
        ti.volume_ready = self.volume_ready
        ti.pod = self.pod
        return ti

    def clone_for_residency(self) -> "TaskInfo":
        """Clone that shares the Resource objects. The node task-map copy
        (reference node_info.go:117) needs an independent *status* so later
        caller-side status flips cannot corrupt accounting; resource values
        are never mutated on a TaskInfo after construction (no call site
        does — the accounting arithmetic mutates node/job aggregates only),
        so sharing them is exact and saves two Resource copies per
        assignment on the bulk replay path."""
        ti = TaskInfo.__new__(TaskInfo)
        ti.uid = self.uid
        ti.job = self.job
        ti.name = self.name
        ti.namespace = self.namespace
        ti.resreq = self.resreq
        ti.init_resreq = self.init_resreq
        ti.node_name = self.node_name
        ti.status = self.status
        ti.priority = self.priority
        ti.volume_ready = self.volume_ready
        ti.pod = self.pod
        return ti

    def __repr__(self) -> str:
        return (
            f"Task ({self.uid}:{self.namespace}/{self.name}): job {self.job}, "
            f"status {self.status}, pri {self.priority}, resreq {self.resreq}"
        )


class FitError:
    """Human-readable histogram of why a job did not fit
    (reference job_info.go:340-372)."""

    def __init__(self, nodes_fit_delta: dict[str, Resource]) -> None:
        self.nodes_fit_delta = nodes_fit_delta

    def __str__(self) -> str:
        if not self.nodes_fit_delta:
            return "0 nodes are available"
        reasons: dict[str, int] = {}
        for delta in self.nodes_fit_delta.values():
            if delta.get("cpu") < 0:
                reasons["cpu"] = reasons.get("cpu", 0) + 1
            if delta.get("memory") < 0:
                reasons["memory"] = reasons.get("memory", 0) + 1
            for name, q in delta.scalars.items():
                if q < 0:
                    reasons[name] = reasons.get(name, 0) + 1
        parts = sorted(f"{v} insufficient {k}" for k, v in reasons.items())
        return f"0/{len(self.nodes_fit_delta)} nodes are available, {', '.join(parts)}."


class JobInfo:
    """The gang unit — one PodGroup (or legacy PDB) worth of tasks
    (reference job_info.go:127-426). Maintains the TaskStatusIndex and the
    Allocated/TotalRequest aggregates through every mutation."""

    def __init__(self, uid: str, *tasks: TaskInfo) -> None:
        self.uid = uid
        self.name = ""
        self.namespace = ""
        self.queue = ""
        self.priority = 0
        self.node_selector: dict[str, str] = {}
        self.min_available = 0
        self.nodes_fit_delta: dict[str, Resource] = {}
        self.task_status_index: dict[TaskStatus, dict[str, TaskInfo]] = {}
        self.tasks: dict[str, TaskInfo] = {}
        self.allocated = Resource.empty()
        self.total_request = Resource.empty()
        self.creation_timestamp = 0.0
        self.pod_group: Optional[PodGroup] = None
        self.pdb: Optional[PodDisruptionBudget] = None
        for t in tasks:
            self.add_task_info(t)

    # -- pod group / pdb binding -------------------------------------------

    def set_pod_group(self, pg: PodGroup) -> None:
        """reference job_info.go:183-192."""
        self.name = pg.name
        self.namespace = pg.metadata.namespace
        self.min_available = pg.spec.min_member
        self.queue = pg.spec.queue
        self.creation_timestamp = pg.metadata.creation_timestamp
        self.pod_group = pg

    def unset_pod_group(self) -> None:
        self.pod_group = None

    def set_pdb(self, pdb: PodDisruptionBudget) -> None:
        """Legacy gang source (reference job_info.go:195-203)."""
        self.name = pdb.name
        self.namespace = pdb.metadata.namespace
        self.min_available = pdb.min_available
        self.creation_timestamp = pdb.metadata.creation_timestamp
        self.pdb = pdb

    def unset_pdb(self) -> None:
        self.pdb = None

    # -- task bookkeeping ---------------------------------------------------

    def get_tasks(self, *statuses: TaskStatus) -> list[TaskInfo]:
        """Clones of all tasks in the given statuses (reference job_info.go:210-222)."""
        out: list[TaskInfo] = []
        for status in statuses:
            for task in self.task_status_index.get(status, {}).values():
                out.append(task.clone())
        return out

    def _add_task_index(self, ti: TaskInfo) -> None:
        self.task_status_index.setdefault(ti.status, {})[ti.uid] = ti

    def _delete_task_index(self, ti: TaskInfo) -> None:
        tasks = self.task_status_index.get(ti.status)
        if tasks is not None:
            tasks.pop(ti.uid, None)
            if not tasks:
                del self.task_status_index[ti.status]

    def add_task_info(self, ti: TaskInfo) -> None:
        """reference job_info.go:233-242."""
        self.tasks[ti.uid] = ti
        self._add_task_index(ti)
        self.total_request.add(ti.resreq)
        if allocated_status(ti.status):
            self.allocated.add(ti.resreq)

    def update_task_status(self, task: TaskInfo, status: TaskStatus) -> None:
        """Delete + re-add under the new status so every index stays
        consistent (reference job_info.go:245-259)."""
        validate_status_update(task.status, status)
        self.delete_task_info(task)
        task.status = status
        self.add_task_info(task)

    def delete_task_info(self, ti: TaskInfo) -> None:
        """reference job_info.go:272-287."""
        task = self.tasks.get(ti.uid)
        if task is None:
            raise KeyError(
                f"failed to find task <{ti.namespace}/{ti.name}> "
                f"in job <{self.namespace}/{self.name}>"
            )
        self.total_request.sub(task.resreq)
        if allocated_status(task.status):
            self.allocated.sub(task.resreq)
        del self.tasks[task.uid]
        self._delete_task_index(task)

    def clone(self) -> "JobInfo":
        """reference job_info.go:290-322."""
        info = JobInfo(self.uid)
        info.name = self.name
        info.namespace = self.namespace
        info.queue = self.queue
        info.priority = self.priority
        info.min_available = self.min_available
        info.node_selector = dict(self.node_selector)
        info.creation_timestamp = self.creation_timestamp
        info.pod_group = self.pod_group
        info.pdb = self.pdb
        for task in self.tasks.values():
            info.add_task_info(task.clone())
        return info

    # -- gang predicates ----------------------------------------------------

    def ready_task_num(self) -> int:
        """Tasks holding resources or finished OK (reference job_info.go:375-386)."""
        n = 0
        for status, tasks in self.task_status_index.items():
            if allocated_status(status) or status == TaskStatus.SUCCEEDED:
                n += len(tasks)
        return n

    def waiting_task_num(self) -> int:
        """Pipelined tasks (reference job_info.go:389-398)."""
        return len(self.task_status_index.get(TaskStatus.PIPELINED, {}))

    def valid_task_num(self) -> int:
        """Tasks that could ever satisfy the gang (reference job_info.go:401-413)."""
        n = 0
        for status, tasks in self.task_status_index.items():
            if (
                allocated_status(status)
                or status == TaskStatus.SUCCEEDED
                or status == TaskStatus.PIPELINED
                or status == TaskStatus.PENDING
            ):
                n += len(tasks)
        return n

    def ready(self) -> bool:
        """Gang barrier: enough tasks hold resources (reference job_info.go:416-420)."""
        return self.ready_task_num() >= self.min_available

    def pipelined(self) -> bool:
        """reference job_info.go:423-426."""
        return self.waiting_task_num() + self.ready_task_num() >= self.min_available

    def fit_error(self) -> str:
        return str(FitError(self.nodes_fit_delta))

    def __repr__(self) -> str:
        return (
            f"Job ({self.uid}): namespace {self.namespace} ({self.queue}), "
            f"name {self.name}, minAvailable {self.min_available}, "
            f"tasks {len(self.tasks)}"
        )
