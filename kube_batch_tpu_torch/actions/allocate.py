"""allocate action: the two-level fair scheduling loop
(reference pkg/scheduler/actions/allocate/allocate.go:44-191).

Queue heap by QueueOrderFn, per-queue job heap by JobOrderFn, per-job task
heap by TaskOrderFn; per task: resource-fit + plugin predicates over all
nodes, score, best node; fits Idle -> allocate, else record NodesFitDelta
and, if it fits Releasing, pipeline. Jobs are re-pushed when JobReady
(gang barrier), queues round-robin until drained.

This serial loop is the correctness oracle for the device action
``torch_allocate`` (actions/torch_allocate.py), which replaces the whole
loop with one device solve, and the action that one routes a cycle to
when the conf or the snapshot is outside the solve's envelope. With
``KBT_EXPLAIN`` on it publishes the cycle's forensics records
(obs/explain.py ``explain_session``) under an ``explain`` span.
"""

from __future__ import annotations

import logging

from kube_batch_tpu_torch import log as pkg_log, obs
from kube_batch_tpu_torch.api.job_info import TaskInfo
from kube_batch_tpu_torch.api.node_info import NodeInfo
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.apis.types import PodGroupPhase
from kube_batch_tpu_torch.framework.interface import Action
from kube_batch_tpu_torch.framework.session import Session
from kube_batch_tpu_torch.plugins.predicates import PredicateError
from kube_batch_tpu_torch.utils import (
    PriorityQueue,
    get_node_list,
    predicate_nodes,
    prioritize_nodes,
    select_best_node,
)

log = logging.getLogger(__name__)


class AllocateAction(Action):
    @property
    def name(self) -> str:
        return "allocate"

    def execute(self, ssn: Session) -> None:
        queues = PriorityQueue(ssn.queue_order_fn)
        jobs_map: dict[str, PriorityQueue] = {}

        for job in ssn.jobs.values():
            # Pending PodGroups wait for the enqueue action (allocate.go:53-55).
            if job.pod_group is not None and job.pod_group.status.phase == PodGroupPhase.PENDING:
                continue
            if job.queue not in ssn.queues:
                continue
            queues.push(ssn.queues[job.queue])
            if job.queue not in jobs_map:
                jobs_map[job.queue] = PriorityQueue(ssn.job_order_fn)
            jobs_map[job.queue].push(job)

        pending_tasks: dict[str, PriorityQueue] = {}
        all_nodes = get_node_list(ssn.nodes)

        def predicate_fn(task: TaskInfo, node: NodeInfo) -> None:
            # Resource fit on Idle OR Releasing, then plugin predicates
            # (allocate.go:78-92).
            if not task.init_resreq.less_equal(node.idle) and not task.init_resreq.less_equal(
                node.releasing
            ):
                raise PredicateError(
                    f"task <{task.namespace}/{task.name}> ResourceFit failed "
                    f"on node <{node.name}>"
                )
            ssn.predicate_fn(task, node)

        while not queues.empty():
            queue = queues.pop()
            if ssn.overused(queue):
                continue

            jobs = jobs_map.get(queue.name)
            if jobs is None or jobs.empty():
                continue

            job = jobs.pop()
            if job.uid not in pending_tasks:
                tasks = PriorityQueue(ssn.task_order_fn)
                for task in job.task_status_index.get(TaskStatus.PENDING, {}).values():
                    # BestEffort tasks are backfill's business (allocate.go:120-125).
                    if task.resreq.is_empty():
                        continue
                    tasks.push(task)
                pending_tasks[job.uid] = tasks
            tasks = pending_tasks[job.uid]

            while not tasks.empty():
                task = tasks.pop()

                # Only the last non-fitting task's deltas survive the loop
                # (allocate.go:139-145).
                if job.nodes_fit_delta:
                    job.nodes_fit_delta = {}

                candidates = predicate_nodes(task, all_nodes, predicate_fn)
                if not candidates:
                    pkg_log.V(3).infof(
                        "no node fits task <%s/%s>; job <%s> leaves the cycle",
                        task.namespace, task.name, job.name,
                    )
                    break

                node_scores = prioritize_nodes(
                    task, candidates, ssn.node_order_map_fn, ssn.node_order_reduce_fn
                )
                node = select_best_node(node_scores)

                if task.init_resreq.less_equal(node.idle):
                    pkg_log.V(3).infof(
                        "binding task <%s/%s> to node <%s>",
                        task.namespace, task.name, node.name,
                    )
                    try:
                        ssn.allocate(task, node.name)
                    except Exception as e:  # noqa: BLE001
                        # reference allocate.go:158-161: log and move on —
                        # a volume-assume or dispatch failure must not
                        # kill the cycle; the task stays unallocated.
                        log.error(
                            "Failed to allocate task %s on %s: %s",
                            task.uid, node.name, e,
                        )
                else:
                    # Record the miss, try the releasing pool (allocate.go:162-180).
                    delta = node.idle.clone()
                    delta.fit_delta(task.init_resreq)
                    job.nodes_fit_delta[node.name] = delta
                    if task.init_resreq.less_equal(node.releasing):
                        pkg_log.V(3).infof(
                            "pipelining task <%s/%s> onto releasing node <%s>",
                            task.namespace, task.name, node.name,
                        )
                        ssn.pipeline(task, node.name)

                if ssn.job_ready(job):
                    jobs.push(job)
                    break

            # Round-robin the queue until it has no jobs left (allocate.go:189).
            queues.push(queue)

        # Post-solve forensics (obs/explain): the serial action is the
        # oracle side of explain parity, re-encoding the post-action world
        # and walking the planes task by task. Covers direct serial confs
        # and every torch_allocate routing or degradation to serial.
        from kube_batch_tpu_torch.obs import explain as _explain

        if _explain.enabled():
            with obs.span("explain") as sp:
                recs = _explain.explain_session(ssn)
                _explain.publish(ssn, recs)
                for k, v in _explain.summary(recs).items():
                    sp.set_attr(k, v)


def new() -> Action:
    return AllocateAction()
