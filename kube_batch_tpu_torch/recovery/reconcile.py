"""Takeover reconciliation: journal vs ClusterStore truth.

Run on lease acquire and on process restart (server.py wires both
through ``SchedulerServer.start``), before the scheduling loop touches
the world. For every orphaned intent (appended, never confirmed — the
in-flight set when the previous leader died):

- **landed** — the store already shows the write (bind: pod bound to
  the intended node; evict: pod gone): confirm it in the journal;
- **orphaned** — the write never reached the store: re-dispatch it
  idempotently through the store (a bind writes ``node_name``, an evict
  deletes the pod), exactly what the dead leader's write pool would
  have done;
- **conflicted** — the store moved on (pod bound elsewhere, or already
  Running under another binder's authority): leave it alone and count
  it; store truth wins, the Omega rule.

Gang atomicity: intents are grouped by (cycle, gang). If any member of
a gang cannot be completed (its pod or target node vanished while the
leader was down), the whole gang rolls back — every member bind this
takeover re-dispatched is undone in reverse order, and every
already-landed member bind of the same gang statement is unbound (only
while the pod is still Pending: a pod the kubelet-equivalent already
started running is past the point of cheap rollback and is left to the
eviction machinery). This is the Statement discipline
(framework/statement.py: op log, commit forward, reverse-order
discard) applied at the store level, so a leader crash mid-bulk-bind
can never strand a half-bound gang below its min_member barrier.

The ``reconcile.scan`` fault point aborts the scan mid-way (takeover
under a corrupted journal / injected failure): reconciliation logs and
returns partial — the standby's normal scheduling loop then self-heals
the still-pending pods, slower but never wrong.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

from kube_batch_tpu_torch import faults, metrics
from kube_batch_tpu_torch.apis.types import PodPhase
from kube_batch_tpu_torch.recovery.journal import Intent, WriteIntentJournal

if TYPE_CHECKING:
    from kube_batch_tpu_torch.apis.types import Pod
    from kube_batch_tpu_torch.cache.store import ClusterStore

log = logging.getLogger(__name__)


@dataclass
class ReconcileReport:
    """What a takeover scan found and did (the glog summary's data)."""

    scanned: int = 0
    confirmed: int = 0  # landed writes, confirmed in the journal
    redispatched: int = 0  # orphaned writes re-driven through the store
    conflicts: int = 0  # store truth diverged; left alone
    rolled_back: int = 0  # binds undone for gang atomicity
    gangs_rolled_back: list[str] = field(default_factory=list)
    aborted: bool = False  # scan died mid-way (journal.replay / reconcile.scan)

    def as_dict(self) -> dict:
        return {
            "scanned": self.scanned,
            "confirmed": self.confirmed,
            "redispatched": self.redispatched,
            "conflicts": self.conflicts,
            "rolled_back": self.rolled_back,
            "gangs_rolled_back": list(self.gangs_rolled_back),
            "aborted": self.aborted,
        }


class _GangStatement:
    """Store-level statement for one gang's reconciliation: forward ops
    append to the log; ``discard`` undoes them in reverse order
    (framework/statement.py's contract against the store instead of a
    session)."""

    def __init__(self, store: "ClusterStore") -> None:
        self._store = store
        self._ops: list[tuple[str, str]] = []  # (op, pod_key)

    def bind(self, pod: "Pod", node: str) -> None:
        self._store.update_pod(dataclasses.replace(pod, node_name=node))
        self._ops.append(("bind", f"{pod.namespace}/{pod.name}"))

    def evict(self, pod: "Pod") -> None:
        self._store.delete_pod(pod.namespace, pod.name)
        self._ops.append(("evict", f"{pod.namespace}/{pod.name}"))

    def __len__(self) -> int:
        return len(self._ops)

    def discard(self) -> int:
        """Undo in reverse order; returns ops undone. Evicts are not
        recreated (the pod object is gone — an evict that should not
        have happened is re-ingested by the owner, as in the reference);
        binds are unbound while the pod is still Pending."""
        undone = 0
        for op, pod_key in reversed(self._ops):
            if op != "bind":
                continue
            ns, _, name = pod_key.partition("/")
            pod = self._store.get_pod(ns, name)
            if pod is not None and pod.phase == PodPhase.PENDING and pod.node_name:
                self._store.update_pod(dataclasses.replace(pod, node_name=""))
                undone += 1
        self._ops.clear()
        return undone


def _unbind_landed(store: "ClusterStore", intents: list[Intent]) -> int:
    """Roll back the already-landed binds of a gang statement (the ones
    the dead leader's write pool completed before the crash)."""
    undone = 0
    for intent in intents:
        if intent.op != "bind":
            continue
        ns, _, name = intent.pod.partition("/")
        pod = store.get_pod(ns, name)
        if (
            pod is not None
            and pod.phase == PodPhase.PENDING
            and pod.node_name == intent.node
        ):
            store.update_pod(dataclasses.replace(pod, node_name=""))
            undone += 1
    return undone


def reconcile_journal(
    journal: WriteIntentJournal, store: "ClusterStore"
) -> ReconcileReport:
    """Scan the journal against store truth; see module docstring.
    Never raises: a takeover must proceed (degraded, loudly) even when
    reconciliation cannot."""
    report = ReconcileReport()
    try:
        replay = WriteIntentJournal.replay(journal.path)
    except Exception as e:  # noqa: BLE001 - unreadable journal degrades
        log.error(
            "journal %s unreadable at takeover (%s); relying on resync self-heal",
            journal.path, e,
        )
        metrics.register_reconcile_op("aborted")
        report.aborted = True
        return report
    orphans = replay.orphans
    if replay.corrupt:
        log.warning(
            "journal %s: %d corrupt line(s) (torn tail?) skipped",
            journal.path, replay.corrupt,
        )
    if not orphans:
        return report

    # Group the in-flight set by gang statement; members of one
    # statement commit or roll back together.
    by_gang: dict[tuple[int, str], list[Intent]] = {}
    for intent in orphans:
        by_gang.setdefault((intent.cycle, intent.gang), []).append(intent)

    try:
        for (cycle, gang), members in sorted(by_gang.items()):
            stmt = _GangStatement(store)
            landed: list[Intent] = []
            confirm_seqs: list[int] = []
            failed_member = None
            for intent in members:
                if faults.should_fire("reconcile.scan"):
                    raise faults.FaultInjected("reconcile.scan: injected scan failure")
                report.scanned += 1
                ns, _, name = intent.pod.partition("/")
                pod = store.get_pod(ns, name)
                if intent.op == "evict":
                    if pod is None:
                        confirm_seqs.append(intent.seq)  # landed
                        report.confirmed += 1
                    else:
                        stmt.evict(pod)
                        confirm_seqs.append(intent.seq)
                        report.redispatched += 1
                    continue
                # bind intent
                if pod is None or store.get("nodes", intent.node) is None:
                    failed_member = intent  # gang cannot complete
                    break
                if pod.node_name == intent.node:
                    landed.append(intent)
                    confirm_seqs.append(intent.seq)
                    report.confirmed += 1
                elif pod.node_name:
                    # bound elsewhere meanwhile: store truth wins
                    confirm_seqs.append(intent.seq)
                    report.conflicts += 1
                else:
                    stmt.bind(pod, intent.node)
                    confirm_seqs.append(intent.seq)
                    report.redispatched += 1
            if failed_member is not None:
                undone = stmt.discard() + _unbind_landed(store, landed)
                report.rolled_back += undone
                report.gangs_rolled_back.append(gang)
                metrics.register_reconcile_op("rolled_back", max(1, undone))
                log.error(
                    "reconcile: gang %s (cycle %d) cannot complete "
                    "(%s unfixable: pod or node vanished); rolled back %d "
                    "bind(s) to preserve gang atomicity",
                    gang or "<none>", cycle, failed_member.pod, undone,
                )
                # The gang's intents are resolved either way: confirm
                # them so the next takeover does not re-litigate a
                # statement this one already rolled back.
                for intent in members:
                    journal.confirm(intent.seq)
                continue
            for seq in confirm_seqs:
                journal.confirm(seq)
    except Exception as e:  # noqa: BLE001 - takeover proceeds degraded
        log.error(
            "reconciliation aborted mid-scan (%s); remaining orphans left "
            "to the resync/rescheduling self-heal", e,
        )
        metrics.register_reconcile_op("aborted")
        report.aborted = True
        return report
    journal.compact()
    for op, n in (
        ("confirmed", report.confirmed),
        ("redispatched", report.redispatched),
        ("conflict", report.conflicts),
    ):
        if n:
            metrics.register_reconcile_op(op, n)
    log.info(
        "reconcile: scanned %d in-flight intent(s): %d landed, %d "
        "re-dispatched, %d conflict(s), %d bind(s) rolled back",
        report.scanned, report.confirmed, report.redispatched,
        report.conflicts, report.rolled_back,
    )
    return report
