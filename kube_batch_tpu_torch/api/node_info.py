"""NodeInfo: per-node resource accounting
(reference pkg/scheduler/api/node_info.go:26-198)."""

from __future__ import annotations

from typing import Optional

from kube_batch_tpu_torch.apis.types import Node
from kube_batch_tpu_torch.api.job_info import TaskInfo, pod_key
from kube_batch_tpu_torch.api.resource_info import Resource
from kube_batch_tpu_torch.api.types import TaskStatus


class NodeInfo:
    """Idle/Used/Releasing/Allocatable/Capability accounting plus the task
    map. Tasks are stored as clones so later status changes on the caller's
    TaskInfo cannot corrupt node accounting (reference node_info.go:117)."""

    def __init__(self, node: Optional[Node] = None) -> None:
        self.name = ""
        self.node: Optional[Node] = None
        self.releasing = Resource.empty()
        self.idle = Resource.empty()
        self.used = Resource.empty()
        self.allocatable = Resource.empty()
        self.capability = Resource.empty()
        self.tasks: dict[str, TaskInfo] = {}
        self.other = None
        if node is not None:
            self.name = node.name
            self.node = node
            self.idle = Resource.from_resource_list(node.allocatable)
            self.allocatable = Resource.from_resource_list(node.allocatable)
            self.capability = Resource.from_resource_list(node.capacity)

    def clone(self) -> "NodeInfo":
        """reference node_info.go:77-86.

        Resident tasks are committed facts; replay them with overcommit
        tolerance so cloning (the per-cycle snapshot) of a node two
        shards raced binds onto reproduces the negative idle instead of
        aborting the whole scheduling cycle."""
        res = NodeInfo(self.node)
        for task in self.tasks.values():
            res.add_task(task, overcommit=True)
        res.other = self.other
        return res

    def set_node(self, node: Node) -> None:
        """Reset accounting from a fresh node object, replaying resident
        tasks (reference node_info.go:89-105). Overcommit-tolerant for
        the same reason as clone(): the replay records facts."""
        self.name = node.name
        self.node = node
        self.allocatable = Resource.from_resource_list(node.allocatable)
        self.capability = Resource.from_resource_list(node.capacity)
        self.idle = Resource.from_resource_list(node.allocatable)
        self.used = Resource.empty()
        self.releasing = Resource.empty()
        for task in self.tasks.values():
            if task.status == TaskStatus.RELEASING:
                self.releasing.add(task.resreq)
            self.idle.sub_overcommit(task.resreq)
            self.used.add(task.resreq)

    def add_task(self, task: TaskInfo, overcommit: bool = False) -> None:
        """Status-dependent accounting (reference node_info.go:108-136):
        Releasing consumes Idle but is also tracked as Releasing; Pipelined
        rides on resources still being released (subtracts Releasing, not
        Idle); everything else consumes Idle. Used grows in all cases.

        ``overcommit=True`` records the task even when idle cannot cover
        it (idle goes negative). The cache's watch-event path uses this:
        a bound pod delivered by the store is a committed fact — two
        federated shards racing binds onto one node must not kill the
        pump with an accounting assertion. Allocation paths keep the
        strict raise."""
        key = pod_key(task.pod)
        if key in self.tasks:
            raise KeyError(
                f"task <{task.namespace}/{task.name}> already on node <{self.name}>"
            )
        ti = task.clone()
        if self.node is not None:
            sub = Resource.sub_overcommit if overcommit else Resource.sub
            if ti.status == TaskStatus.RELEASING:
                self.releasing.add(ti.resreq)
                sub(self.idle, ti.resreq)
            elif ti.status == TaskStatus.PIPELINED:
                sub(self.releasing, ti.resreq)
            else:
                sub(self.idle, ti.resreq)
            self.used.add(ti.resreq)
        self.tasks[key] = ti

    def remove_task(self, ti: TaskInfo) -> None:
        """Inverse of add_task (reference node_info.go:139-165)."""
        key = pod_key(ti.pod)
        task = self.tasks.get(key)
        if task is None:
            raise KeyError(
                f"failed to find task <{ti.namespace}/{ti.name}> on host <{self.name}>"
            )
        if self.node is not None:
            if task.status == TaskStatus.RELEASING:
                self.releasing.sub(task.resreq)
                self.idle.add(task.resreq)
            elif task.status == TaskStatus.PIPELINED:
                self.releasing.add(task.resreq)
            else:
                self.idle.add(task.resreq)
            self.used.sub(task.resreq)
        del self.tasks[key]

    def update_task(self, ti: TaskInfo) -> None:
        """reference node_info.go:168-174."""
        self.remove_task(ti)
        self.add_task(ti)

    def pods(self) -> list:
        return [t.pod for t in self.tasks.values()]

    def __repr__(self) -> str:
        return (
            f"Node ({self.name}): idle <{self.idle}>, used <{self.used}>, "
            f"releasing <{self.releasing}>, tasks {len(self.tasks)}"
        )
