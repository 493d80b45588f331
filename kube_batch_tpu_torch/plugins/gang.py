"""gang plugin: minMember semantics end-to-end
(reference pkg/scheduler/plugins/gang/gang.go:48-162).

At session close each non-ready job gets an Unschedulable condition and
is metered (``unschedule_task_count`` per job, ``job_retry_counts``, and
the cycle's ``unschedule_job_count``), as in the JAX package. When the
allocate action published a forensics record for the job
(obs/explain.py, ``KBT_EXPLAIN``), the condition carries the record's
dominant plane as its reason and the elimination / would-fit-if
breakdown as its message."""

from __future__ import annotations

import time
from typing import Optional

from kube_batch_tpu_torch import metrics
from kube_batch_tpu_torch.api.job_info import JobInfo, TaskInfo
from kube_batch_tpu_torch.api.types import ValidateResult
from kube_batch_tpu_torch.apis.types import (
    NOT_ENOUGH_PODS_REASON,
    NOT_ENOUGH_RESOURCES_REASON,
    POD_GROUP_UNSCHEDULABLE_TYPE,
    PodGroupCondition,
)
from kube_batch_tpu_torch.framework.arguments import Arguments
from kube_batch_tpu_torch.framework.interface import Plugin
from kube_batch_tpu_torch.framework.session import Session


def job_valid(job: JobInfo) -> Optional[ValidateResult]:
    """Enough potentially-schedulable tasks? (gang.go:48-69). The plugin's
    JobValid fn, and the gate ``solve.valid_jobs`` applies with no
    session."""
    vtn = job.valid_task_num()
    if vtn < job.min_available:
        return ValidateResult(
            passed=False,
            reason=NOT_ENOUGH_PODS_REASON,
            message=(
                f"Not enough valid tasks for gang-scheduling, "
                f"valid: {vtn}, min: {job.min_available}"
            ),
        )
    return None


class GangPlugin(Plugin):
    def __init__(self, arguments: Arguments) -> None:
        self.arguments = arguments

    @property
    def name(self) -> str:
        return "gang"

    def on_session_open(self, ssn: Session) -> None:
        ssn.add_job_valid_fn(self.name, job_valid)

        def preemptable_fn(
            preemptor: TaskInfo, preemptees: list[TaskInfo]
        ) -> list[TaskInfo]:
            """Protect victims whose job would drop below minAvailable
            (gang.go:71-93)."""
            victims: list[TaskInfo] = []
            for preemptee in preemptees:
                job = ssn.jobs[preemptee.job]
                occupied = job.ready_task_num()
                preemptable = job.min_available <= occupied - 1 or job.min_available == 1
                if preemptable:
                    victims.append(preemptee)
            return victims

        ssn.add_reclaimable_fn(self.name, preemptable_fn)
        ssn.add_preemptable_fn(self.name, preemptable_fn)

        def job_order_fn(l: JobInfo, r: JobInfo) -> int:
            """Non-ready jobs first (gang.go:96-118)."""
            l_ready = l.ready()
            r_ready = r.ready()
            if l_ready and r_ready:
                return 0
            if l_ready:
                return 1
            if r_ready:
                return -1
            return 0

        ssn.add_job_order_fn(self.name, job_order_fn)
        ssn.add_job_ready_fn(self.name, lambda job: job.ready())
        ssn.add_job_pipelined_fn(self.name, lambda job: job.pipelined())

    def on_session_close(self, ssn: Session) -> None:
        """Emit Unschedulable conditions + metrics for non-ready jobs
        (gang.go:132-162)."""
        explain_records = getattr(ssn, "explain_records", {}) or {}
        unschedulable_jobs = 0
        for job in ssn.jobs.values():
            if not job.ready():
                unready = job.min_available - job.ready_task_num()
                msg = (
                    f"{unready}/{len(job.tasks)} tasks in gang unschedulable: "
                    f"{job.fit_error()}"
                )
                reason = NOT_ENOUGH_RESOURCES_REASON
                # Forensics (obs/explain): the record's dominant plane is
                # the reason and its breakdown the message. Conditions ride
                # /backend/v1/ commits into the store, so this is also the
                # cross-shard channel (explain.aggregate_conditions).
                rec = explain_records.get(job.uid)
                if rec is not None and rec.get("verdict") != "bound":
                    from kube_batch_tpu_torch.obs import explain as _explain

                    reason = rec["reason"]
                    msg = _explain.condition_message(rec)
                unschedulable_jobs += 1
                metrics.update_unschedule_task_count(job.name, unready)
                metrics.register_job_retries(job.name)
                if job.pod_group is not None:
                    ssn.update_job_condition(
                        job,
                        PodGroupCondition(
                            type=POD_GROUP_UNSCHEDULABLE_TYPE,
                            status="True",
                            transition_id=ssn.uid,
                            last_transition_time=time.time(),
                            reason=reason,
                            message=msg,
                        ),
                    )
        metrics.update_unschedule_job_count(unschedulable_jobs)


def new(arguments: Arguments) -> Plugin:
    return GangPlugin(arguments)
