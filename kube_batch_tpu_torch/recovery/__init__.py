"""Crash-consistent failover for the bind/evict write side.

The reference scheduler gets recovery for free: the Kubernetes
apiserver is the durable source of truth and informers resync the world
after a restart (cache.go:187-300). The in-process ClusterStore and the
lease elector (server.py) reproduce *election*; this package adds
*recovery*: without it a leader killed mid-``bind_many`` leaves
assumed-but-unconfirmed binds that the standby neither replays nor
reconciles. Omega/Borg-class schedulers treat optimistic transactions
plus conflict reconciliation as the core robustness mechanism — election
alone is not an HA story.

The pieces:

- ``journal.WriteIntentJournal`` — an append-before-dispatch,
  confirm-after-ack write-ahead log wrapped around the cache's async
  write pool: every bind/evict statement lands in the journal (cycle
  id, gang id, task→node intent, statement kind) *before* the store
  write is dispatched, and is confirmed *after* the write acks.
- ``reconcile.reconcile_journal`` — takeover reconciliation: on lease
  acquire and on process restart, scan the journal against ClusterStore
  truth — confirm writes that landed, re-dispatch orphaned intents
  idempotently, and roll back half-bound gangs (statement-style op log
  with reverse-order undo) so gang atomicity survives a leader crash
  mid-bulk-bind.
- ``budget.CycleBudget`` — the scheduling cycle's deadline budget: a
  soft deadline arms a solver-ladder tier downgrade, a hard deadline
  aborts the cycle pre-dispatch (cache byte-identical; the next cycle
  reschedules) and meters ``cycle.overrun``.
- ``watch_client.ResilientWatcher`` — bounded-staleness list+watch
  client: reconnect with jittered exponential backoff, 410-Gone
  relist-storm coalescing, and a snapshot-age gauge feeding the
  scheduler's refuse-to-schedule staleness guard.
- ``fsck`` — offline journal checker
  (``python -m kube_batch_tpu_torch.recovery.fsck``).

Fault points ``journal.append``, ``journal.replay``, ``reconcile.scan``
and ``cycle.overrun`` plug into the fault registry (faults/), so every
recovery path is drillable in production. Each module is the JAX
package's, and the journal's record format is the same byte for byte:
a standby of either package reconciles the other's journal.
"""

from __future__ import annotations

from kube_batch_tpu_torch.recovery.budget import CycleBudget, CycleDeadlineExceeded
from kube_batch_tpu_torch.recovery.journal import WriteIntentJournal
from kube_batch_tpu_torch.recovery.reconcile import reconcile_journal
from kube_batch_tpu_torch.recovery.watch_client import ResilientWatcher

__all__ = [
    "CycleBudget",
    "CycleDeadlineExceeded",
    "WriteIntentJournal",
    "reconcile_journal",
    "ResilientWatcher",
]
