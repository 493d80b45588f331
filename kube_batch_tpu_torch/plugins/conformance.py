"""conformance plugin: never evict critical pods
(reference pkg/scheduler/plugins/conformance/conformance.go:41-63)."""

from __future__ import annotations

from kube_batch_tpu_torch.api.job_info import TaskInfo
from kube_batch_tpu_torch.framework.arguments import Arguments
from kube_batch_tpu_torch.framework.interface import Plugin
from kube_batch_tpu_torch.framework.session import Session

SYSTEM_CLUSTER_CRITICAL = "system-cluster-critical"
SYSTEM_NODE_CRITICAL = "system-node-critical"
NAMESPACE_SYSTEM = "kube-system"


class ConformancePlugin(Plugin):
    def __init__(self, arguments: Arguments) -> None:
        self.arguments = arguments

    @property
    def name(self) -> str:
        return "conformance"

    def on_session_open(self, ssn: Session) -> None:
        def evictable_fn(evictor: TaskInfo, evictees: list[TaskInfo]) -> list[TaskInfo]:
            victims: list[TaskInfo] = []
            for evictee in evictees:
                class_name = evictee.pod.priority_class_name
                if (
                    class_name == SYSTEM_CLUSTER_CRITICAL
                    or class_name == SYSTEM_NODE_CRITICAL
                    or evictee.namespace == NAMESPACE_SYSTEM
                ):
                    continue
                victims.append(evictee)
            return victims

        ssn.add_preemptable_fn(self.name, evictable_fn)
        ssn.add_reclaimable_fn(self.name, evictable_fn)


def new(arguments: Arguments) -> Plugin:
    return ConformancePlugin(arguments)
