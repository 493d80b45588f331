"""backfill action: place BestEffort (zero-request) pending tasks on the
first node passing predicates (reference
pkg/scheduler/actions/backfill/backfill.go:41-76)."""

from __future__ import annotations

from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.apis.types import PodGroupPhase
from kube_batch_tpu_torch.framework.interface import Action
from kube_batch_tpu_torch.framework.session import Session
from kube_batch_tpu_torch.utils import get_node_list


class BackfillAction(Action):
    @property
    def name(self) -> str:
        return "backfill"

    def execute(self, ssn: Session) -> None:
        for job in ssn.jobs.values():
            if job.pod_group is not None and job.pod_group.status.phase == PodGroupPhase.PENDING:
                continue
            for task in list(job.task_status_index.get(TaskStatus.PENDING, {}).values()):
                if not task.init_resreq.is_empty():
                    continue
                for node in get_node_list(ssn.nodes):
                    try:
                        ssn.predicate_fn(task, node)
                    except Exception:
                        continue
                    try:
                        ssn.allocate(task, node.name)
                    except Exception:
                        continue
                    break


def new() -> Action:
    return BackfillAction()
