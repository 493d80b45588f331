"""torch_reclaim action: reclaim with the vectorized predicate scan.

The serial reclaim walks every node per starved task, running the full
predicate chain inline (reference reclaim.go:113-128 — the same hot loop
shape as preempt's, minus scoring: first feasible node with enough
cross-queue victims wins, in node order). This action reuses the shared
`run_reclaim` control flow (actions/reclaim.py) with `VectorScan.feasible` —
one float64 numpy pass over the encoder's dedup'd predicate matrices per
task — and keeps victim vetting (Reclaimable), direct evicts, and the
pipeline exactly serial.

Evicts flip residents Running->Releasing (no scan-visible change);
pipelines update the scan mirrors through the on_pipeline hook. Host-only
tasks and out-of-envelope snapshots walk serially per task.

``last_timings`` holds the last execute's wall clock: ``encode_s`` (the
scan's float64 encode), ``warm_fraction`` (its share of encode-cache
units served warm), ``reclaim_s`` (`run_reclaim`), ``serial_scans``
(tasks that walked serially); or, when the conf is outside the scan's
envelope, ``serial_routed_s`` and ``serial_reason``.
"""

from __future__ import annotations

import time

from kube_batch_tpu_torch.actions.scan import VectorScan
from kube_batch_tpu_torch.framework.interface import Action
from kube_batch_tpu_torch.framework.session import Session


class TorchReclaimAction(Action):
    def __init__(self) -> None:
        self.last_timings: dict[str, float | int | str] = {}

    @property
    def name(self) -> str:
        return "torch_reclaim"

    def execute(self, ssn: Session) -> None:
        from kube_batch_tpu_torch.actions.envelope import scan_supported
        from kube_batch_tpu_torch.actions.reclaim import ReclaimAction, run_reclaim, serial_feasible

        if not scan_supported(ssn):
            # Same envelope rule as torch_preempt: unmodeled predicate or
            # node-order plugins fall back to the serial action.
            t0 = time.perf_counter()
            ReclaimAction().execute(ssn)
            self.last_timings = {"serial_routed_s": time.perf_counter() - t0, "serial_reason": "envelope"}
            return

        scan = VectorScan(ssn)

        def feasible(s: Session, task):
            nodes = scan.feasible(task)
            if nodes is None:
                return serial_feasible(s, task)
            return nodes

        t0 = time.perf_counter()
        run_reclaim(ssn, feasible_fn=feasible, on_pipeline=scan.on_pipeline)
        self.last_timings = {
            "encode_s": scan.encode_s, "warm_fraction": scan.warm_fraction,
            "reclaim_s": time.perf_counter() - t0, "serial_scans": scan.serial_scans,
        }


def new() -> Action:
    return TorchReclaimAction()
