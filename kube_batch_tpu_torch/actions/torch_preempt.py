"""torch_preempt action: preempt with a vectorized candidate-node scan.

The serial preempt action's hot loop is the same per-task node scan as
allocate's (reference pkg/scheduler/actions/preempt/preempt.go:176-256:
`util.PredicateNodes` + `util.PrioritizeNodes` over every node for every
starved preemptor task, 16-goroutine fan-out in Go). This action keeps
the reference's control flow — queue-by-queue preemptor heaps, Statement
speculation with commit/discard, victim selection by task order
(preempt.go:81-170) — entirely on the host, and replaces only the
per-preemptor node scan with one vectorized pass over the encoder's
(task-group x node-group) predicate matrices and the nodeorder score
formulas.

Design note, as in the JAX package's ``xla_preempt``: unlike the
allocate solve — a >50k-iteration sequential loop that lives on the card
as one kernel launch (torch_allocate, kernel B1) — the preempt scan is
one O(N x R) data-parallel pass per preemptor with Statement mutations
between scans. It runs as float64 numpy: bit-identical to the serial
float64 oracle (including score tie-breaks), which keeps
`torch_preempt ≡ preempt` exact. The matrices it reads are the ones the
device path's encoder builds (ops/encode.py), at float64.

Scan-visible dynamic state: a Statement changes node residency only
through `pipeline` (evict flips a resident Running->Releasing, which
changes neither pod count, ports, nor Used — node_info.go:168-174), so
the mirror updates on pipeline/unpipeline alone; `ScanStatement` keeps
it in sync through discard rollbacks.

Tasks whose pod spec carries required pod (anti-)affinity are pairwise-
dynamic (predicates.go:187-199) and scan serially, exactly like the
allocate action steps them on the host.

``last_timings`` holds the last execute's wall clock: ``encode_s`` (the
scan's float64 encode), ``warm_fraction`` (its share of encode-cache
units served warm), ``preempt_s`` (`run_preempt`), ``serial_scans``
(preemptor scans that walked serially); or, when the conf is outside the
scan's envelope, ``serial_routed_s`` and ``serial_reason``.
"""

from __future__ import annotations

import time

from kube_batch_tpu_torch.actions.scan import ScanStatement, VectorScan
from kube_batch_tpu_torch.api.job_info import TaskInfo
from kube_batch_tpu_torch.framework.interface import Action
from kube_batch_tpu_torch.framework.session import Session


class TorchPreemptAction(Action):
    """Drop-in replacement for the serial preempt action (conf
    ``actions: "...,torch_preempt"``): the shared run_preempt control flow
    (actions/preempt.py) with the vectorized node scan and the
    mirror-syncing Statement."""

    def __init__(self) -> None:
        self.last_timings: dict[str, float | int | str] = {}

    @property
    def name(self) -> str:
        return "torch_preempt"

    def execute(self, ssn: Session) -> None:
        from kube_batch_tpu_torch.actions.envelope import scan_supported
        from kube_batch_tpu_torch.actions.preempt import PreemptAction, run_preempt, serial_candidates

        if not scan_supported(ssn):
            # VectorScan hardcodes the built-in predicate set and the
            # nodeorder/tensorscore score model; an unmodeled plugin in
            # the conf would silently diverge from the serial oracle.
            t0 = time.perf_counter()
            PreemptAction().execute(ssn)
            self.last_timings = {"serial_routed_s": time.perf_counter() - t0, "serial_reason": "envelope"}
            return

        scan = VectorScan(ssn)

        def candidates(s: Session, preemptor: TaskInfo):
            selected = scan.candidates(preemptor)
            if selected is None:
                # host-only task (required pod affinity / scan disabled):
                # the serial predicate walk
                return serial_candidates(s, preemptor)
            return selected

        t0 = time.perf_counter()
        run_preempt(
            ssn,
            statement_factory=lambda s: ScanStatement(s, scan),
            candidates_fn=candidates,
        )
        self.last_timings = {
            "encode_s": scan.encode_s, "warm_fraction": scan.warm_fraction,
            "preempt_s": time.perf_counter() - t0, "serial_scans": scan.serial_scans,
        }


def new() -> Action:
    return TorchPreemptAction()
