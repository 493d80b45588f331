"""torch_backfill action: BestEffort placement with a vectorized scan.

The serial backfill walks every node per zero-request pending task,
running the full predicate chain inline until the first feasible node
(reference pkg/scheduler/actions/backfill/backfill.go:41-76 — no
scoring, first hit in node order wins). That is O(tasks x nodes)
Python predicate calls for work whose per-node verdict depends only on
the task's (selector, affinity, tolerations, ports) signature and the
node's (labels, taints, cordon) signature plus two dynamic counters
(pod count, host-port occupancy).

This action computes the verdicts once per (task-group x node-group)
pair — the encoder's dedup idea (ops/encode.py) applied to the
backfill predicate subset — and walks tasks in the serial order,
picking the first node whose group verdict + dynamic counters pass,
then calling ``ssn.allocate`` exactly as the serial loop does (same
session machinery, same events, same metrics). Session state therefore
stays live: tasks with required pod (anti-)affinity terms — whose
verdict is pairwise over residents (predicates.go:187-199) — walk the
serial predicate chain per task against that live state, and >63
distinct host ports disable the bitmask (the VectorScan convention).
Out-of-envelope confs (plugins whose predicate fns the scan does not
model) fall back to the serial action wholesale.

Like the JAX package's ``xla_backfill``, this is host numpy: BestEffort
tasks request nothing, so there is no arithmetic to move to the card,
only per-group verdicts and two counters per node.

``last_timings`` holds the last execute's wall clock (``scan_s``, the
verdicts and the walk; ``placed``) or, when the action ran the serial
backfill, ``serial_routed_s`` and ``serial_reason`` (``envelope`` or
``ports>63``).
"""

from __future__ import annotations

import logging
import time

import numpy as np

from kube_batch_tpu_torch import log as pkg_log
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.apis.types import PodGroupPhase
from kube_batch_tpu_torch.framework.interface import Action
from kube_batch_tpu_torch.framework.session import Session

log = logging.getLogger(__name__)


class TorchBackfillAction(Action):
    def __init__(self) -> None:
        self.last_timings: dict[str, float | int | str] = {}

    @property
    def name(self) -> str:
        return "torch_backfill"

    def _route_serial(self, ssn: Session, reason: str) -> None:
        from kube_batch_tpu_torch.actions.backfill import BackfillAction

        t0 = time.perf_counter()
        BackfillAction().execute(ssn)
        self.last_timings = {"serial_routed_s": time.perf_counter() - t0, "serial_reason": reason}

    def execute(self, ssn: Session) -> None:
        from kube_batch_tpu_torch.actions.envelope import scan_supported

        self.last_timings = {}
        if not scan_supported(ssn):
            pkg_log.V(3).infof("conf outside scan envelope; running serial backfill")
            self._route_serial(ssn, "envelope")
            return
        t0 = time.perf_counter()

        from kube_batch_tpu_torch.ops.encode import (
            _node_signature,
            _task_ports,
            _task_signature,
            build_static_compat,
            group_by_signature,
        )
        from kube_batch_tpu_torch.plugins.predicates import (
            check_node_condition,
            check_pressure,
        )
        from kube_batch_tpu_torch.utils import get_node_list

        # -- candidate tasks in the serial iteration order ----------------
        work: list = []  # TaskInfo, serial (job, task) order
        for job in ssn.jobs.values():
            if (
                job.pod_group is not None
                and job.pod_group.status.phase == PodGroupPhase.PENDING
            ):
                continue
            for task in list(
                job.task_status_index.get(TaskStatus.PENDING, {}).values()
            ):
                if task.init_resreq.is_empty():
                    work.append(task)
        if not work:
            return

        nodes = get_node_list(ssn.nodes)
        n = len(nodes)
        if n == 0:
            return

        # -- distinct host ports the candidates use (bitmask domain) ------
        all_ports = sorted({p for t in work for p in _task_ports(t)})
        if len(all_ports) > 63:
            # int64 bitmask exhausted — same convention as VectorScan:
            # correctness first, scan another day
            pkg_log.V(3).infof(">63 distinct host ports; running serial backfill")
            self._route_serial(ssn, "ports>63")
            return
        port_bit = {p: np.int64(1) << i for i, p in enumerate(all_ports)}

        def ports_mask(task) -> np.int64:
            m = np.int64(0)
            for p in _task_ports(task):
                m |= port_bit[p]
            return m

        # -- static node facts + dynamic counters -------------------------
        label_keys: set[str] = set()
        for t in work:
            label_keys.update(t.pod.node_selector)
            aff = t.pod.affinity
            if aff is not None:
                for term in aff.node_affinity_required:
                    label_keys.add(term.key)
                for _, term in aff.node_affinity_preferred:
                    label_keys.add(term.key)
        frozen_keys = frozenset(label_keys)
        node_ok = np.zeros(n, bool)
        max_tasks = np.zeros(n, np.int64)
        ntasks = np.zeros(n, np.int64)
        node_ports = np.zeros(n, np.int64)
        for i, node in enumerate(nodes):
            node_ok[i] = (
                node.node is not None
                and check_node_condition(node.node)
                and check_pressure(node.node)
            )
            max_tasks[i] = node.allocatable.max_task_num
            ntasks[i] = len(node.tasks)
            if all_ports:
                for rt in node.tasks.values():
                    for p in _task_ports(rt):
                        bit = port_bit.get(p)
                        if bit is not None:
                            node_ports[i] |= bit

        # -- dedup groups + (group x node-group) verdicts (shared with
        #    the encoder: ops/encode.py group_by_signature/build_static_compat)
        node_gid, n_reps = group_by_signature(
            nodes, lambda nd: _node_signature(nd, frozen_keys)
        )
        task_gid, t_reps = group_by_signature(work, _task_signature)
        compat = build_static_compat(t_reps, n_reps)

        # -- the walk, serial order, live session mutations ---------------
        placed = 0
        for t, gid in zip(work, task_gid):
            aff = t.pod.affinity
            if aff is not None and (
                aff.pod_affinity_required or aff.pod_anti_affinity_required
            ):
                # pairwise-over-residents verdict: serial chain against the
                # live session (exactly backfill.go's inner loop)
                hit = self._serial_step(ssn, t, nodes)
            else:
                tp = ports_mask(t)
                mask = (
                    compat[gid, node_gid]
                    & node_ok
                    & (ntasks < max_tasks)
                    & ((tp & node_ports) == 0)
                )
                hit = None
                for i in np.nonzero(mask)[0].tolist():
                    try:
                        ssn.allocate(t, nodes[i].name)
                    except Exception:  # noqa: BLE001 -- serial `continue`
                        continue
                    hit = i
                    break
            if hit is not None:
                ntasks[hit] += 1
                node_ports[hit] |= ports_mask(t)
                placed += 1
        self.last_timings = {"scan_s": time.perf_counter() - t0, "placed": placed}
        if placed:
            pkg_log.V(3).infof("backfilled %d BestEffort tasks", placed)

    @staticmethod
    def _serial_step(ssn: Session, task, nodes):
        """backfill.go:52-71 for one task: first predicate-passing node,
        allocate, break; returns the node row or None."""
        for i, node in enumerate(nodes):
            try:
                ssn.predicate_fn(task, node)
            except Exception:  # noqa: BLE001
                continue
            try:
                ssn.allocate(task, node.name)
            except Exception:  # noqa: BLE001
                continue
            return i
        return None


def new() -> Action:
    return TorchBackfillAction()
