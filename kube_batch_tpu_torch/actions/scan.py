"""Vectorized candidate-node scan shared by the torch_preempt and
torch_reclaim actions.

The serial preempt/reclaim hot loop is the same per-task node walk as
allocate's (predicate -> [score ->] select, reference
scheduler_helper.go:34-109 / reclaim.go:113-128). `VectorScan` replaces
it with one float64 numpy pass over the encoder's dedup'd matrices —
bit-identical to the serial float64 oracle including score tie-breaks —
plus incremental mirrors of the scan-visible dynamic node state (pod
count, host ports, Used cpu/mem). Only `pipeline`/`unpipeline` move those
quantities (an evict flips a resident Running->Releasing, which changes
none of them — node_info.go:168-174), so `ScanStatement` keeps the
mirrors in sync through Statement rollbacks and direct-evict actions need
no hooks at all.

Host-only tasks (required pod affinity), ports beyond the 63-bit mask,
and snapshots with live InterPodAffinity scores fall back to the serial
walk per task.

The scan is host numpy on purpose, as in the JAX package: one O(N x R)
pass per preemptor with Statement mutations between scans, exact in
float64. The card's work in a pipeline is torch_allocate's solve.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from kube_batch_tpu_torch.api.job_info import TaskInfo
from kube_batch_tpu_torch.api.node_info import NodeInfo
from kube_batch_tpu_torch.framework.session import Session
from kube_batch_tpu_torch.framework.statement import Statement


class VectorScan:
    """Vectorized predicate + score scan over the node axis.

    Wraps the encoder's dedup'd matrices with float64 mirrors of the
    scan-visible dynamic node state (pod count, host ports, Used cpu/mem).
    `candidates(task)` reproduces predicate_nodes + prioritize_nodes +
    sort_nodes for one task; returns None for host-only tasks (required
    pod affinity) so the caller can scan serially.
    """

    def __init__(self, ssn: Session) -> None:
        from kube_batch_tpu_torch.actions.torch_allocate import _nodeorder_weights
        from kube_batch_tpu_torch.ops.encode import encode_session

        t0 = time.perf_counter()
        # session=ssn: the cross-cycle encode cache shares signatures,
        # group pairs and node statics with the cycle's other encodes
        enc = encode_session(ssn.jobs, ssn.nodes, ssn.queues, dtype=np.float64, session=ssn)
        self.enc = enc
        a = enc.arrays
        N = enc.n_nodes
        self.node_list = [ssn.nodes[name] for name in enc.node_names]
        self.node_row = {name: i for i, name in enumerate(enc.node_names)}
        self.task_row = {t.uid: i for i, t in enumerate(enc.tasks)}
        self.task_gid = np.asarray(a["task_gid"])
        self.host_only = np.asarray(a["task_host_only"])
        self.compat = np.asarray(a["compat"])
        self.aff_sc = np.asarray(a["aff_sc"], np.float64)
        self.node_gid = np.asarray(a["node_gid"])[:N]
        self.node_ok = np.asarray(a["node_ok"])[:N]
        self.max_tasks = np.asarray(a["node_max_tasks"])[:N]
        self.cap_cpu = np.asarray(a["node_alloc"], np.float64)[:N, 0]
        self.cap_mem = np.asarray(a["node_alloc"], np.float64)[:N, 1]
        # dynamic mirrors (see module docstring)
        self.ntasks = np.asarray(a["node_ntasks"])[:N].copy()
        P = a["task_ports"].shape[1]
        # int64 bitmask: shifting by >= 64 silently yields 0 in numpy, so
        # beyond 63 distinct host ports every task scans serially instead;
        # live InterPodAffinity scores (pod-affinity terms anywhere) are
        # resident-dependent and recomputable only against the live
        # session, so those snapshots scan serially too
        self.disabled = P > 63 or enc.interpod_active
        bits = 1 << np.arange(min(P, 63), dtype=np.int64)
        ports = np.asarray(a["task_ports"])[:, : min(P, 63)]
        self.task_ports = (ports * bits).sum(axis=1)
        self.node_ports = (
            np.asarray(a["node_ports"])[:N, : min(P, 63)] * bits
        ).sum(axis=1)
        self.used_cpu = np.asarray(a["node_used"], np.float64)[:N, 0].copy()
        self.used_mem = np.asarray(a["node_used"], np.float64)[:N, 1].copy()
        self.rowidx = np.arange(N)
        self.w_least, self.w_balanced, self.w_aff, _ = _nodeorder_weights(ssn)
        # wall clock of the float64 encode and mirror set-up
        self.encode_s = time.perf_counter() - t0
        self.warm_fraction = enc.warm_fraction
        # tasks scanned serially (host-only, or the whole scan disabled)
        self.serial_scans = 0

    def _mask(self, task: TaskInfo):
        """Predicate verdict over all nodes, or None for serial fallback."""
        if self.disabled:
            self.serial_scans += 1
            return None
        row = self.task_row.get(task.uid)
        if row is None or self.host_only[row]:
            self.serial_scans += 1
            return None
        g = int(self.task_gid[row])
        return (
            self.compat[g, self.node_gid]
            & self.node_ok
            & (self.ntasks < self.max_tasks)
            & ((self.task_ports[row] & self.node_ports) == 0)
        )

    def feasible(self, task: TaskInfo) -> Optional[list[NodeInfo]]:
        """Predicate-passing nodes in name order — the reclaim walk
        (reclaim.go:113-128 iterates nodes without scoring)."""
        cand = self._mask(task)
        if cand is None:
            return None
        return [self.node_list[r] for r in np.nonzero(cand)[0]]

    def candidates(self, task: TaskInfo) -> Optional[list[NodeInfo]]:
        cand = self._mask(task)
        if cand is None:
            return None
        row = self.task_row[task.uid]
        g = int(self.task_gid[row])
        if not cand.any():
            return []

        # nodeorder score, float64-identical to plugins/nodeorder.py
        from kube_batch_tpu_torch.plugins.nodeorder import vectorized_least_balanced

        least, balanced = vectorized_least_balanced(
            self.used_cpu + task.resreq.milli_cpu,
            self.used_mem + task.resreq.memory,
            self.cap_cpu,
            self.cap_mem,
        )
        score = (
            least * self.w_least
            + balanced * self.w_balanced
            + self.aff_sc[g, self.node_gid] * self.w_aff
        )
        # sort_nodes order: score desc, ties by node row (= name order)
        order = np.lexsort((self.rowidx, -score))
        order = order[cand[order]]
        return [self.node_list[r] for r in order]

    # -- Statement-visible mutations --------------------------------------

    def on_pipeline(self, task: TaskInfo, hostname: str) -> None:
        n = self.node_row[hostname]
        self.ntasks[n] += 1
        self.used_cpu[n] += task.resreq.milli_cpu
        self.used_mem[n] += task.resreq.memory
        row = self.task_row.get(task.uid)
        if row is not None:
            self.node_ports[n] |= self.task_ports[row]

    def on_unpipeline(self, task: TaskInfo, hostname: str) -> None:
        n = self.node_row[hostname]
        self.ntasks[n] -= 1
        self.used_cpu[n] -= task.resreq.milli_cpu
        self.used_mem[n] -= task.resreq.memory
        row = self.task_row.get(task.uid)
        if row is not None:
            # exclusive holder: two tasks with the same host port can never
            # co-reside (the predicate forbids it), so clearing is exact
            self.node_ports[n] &= ~self.task_ports[row]


class ScanStatement(Statement):
    """Statement that keeps the vector scan's node mirrors in sync."""

    def __init__(self, ssn: Session, scan: VectorScan) -> None:
        super().__init__(ssn)
        self._scan = scan

    def pipeline(self, task: TaskInfo, hostname: str) -> None:
        super().pipeline(task, hostname)
        self._scan.on_pipeline(task, hostname)

    def _unpipeline(self, task: TaskInfo) -> None:
        hostname = task.node_name
        super()._unpipeline(task)
        self._scan.on_unpipeline(task, hostname)


