"""Write-intent journal: the bind/evict write-ahead log.

Protocol (the Omega-style optimistic-transaction discipline applied to
our async write pool, cache/cache.py):

1. **append-before-dispatch** — the cache appends one ``intent`` record
   per bind/evict (cycle id, gang id, pod key, target node, statement
   kind) and flushes it to disk *before* submitting the store write to
   the pool;
2. **confirm-after-ack** — once the store write acks, the cache appends
   a ``confirm`` record for that intent's sequence number.

A leader killed between (1) and (2) leaves *orphaned* intents: the
journal knows exactly which writes were in flight, so a standby (or the
restarted process) can reconcile them against store truth instead of
guessing (recovery/reconcile.py). An intent whose write failed and fell
to the errTasks resync queue also stays orphaned — reconciliation at
the next takeover confirms or re-dispatches it, which is idempotent
with the resync path.

Format: JSON lines, append-only. ``{"rec": "intent", "seq": N,
"cycle": C, "op": "bind"|"evict", "gang": job_uid, "pod": "ns/name",
"node": host}`` and ``{"rec": "confirm", "seq": N}``. Torn tails (a
crash mid-append) are tolerated: replay stops parsing a malformed last
line and reports it, matching WAL practice.

Durability: records are flushed (``flush`` + optional ``fsync``) before
dispatch. The default is flush-only — the failure model is process
death (SIGKILL, OOM), where OS-buffered data survives; ``fsync=True``
extends coverage to host power loss at a per-batch fsync cost.

Availability over protection: a journal append failure (disk full,
injected ``journal.append`` fault) must not brick the scheduler — the
cache logs, meters, and dispatches the write *unjournaled* for that
batch. Degraded crash-consistency is loud, never a wedged write side.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from dataclasses import dataclass
from typing import Optional

from kube_batch_tpu_torch import faults, metrics
from kube_batch_tpu_torch.utils.locking import assume_locked

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class Intent:
    """One journaled write intent (the parsed ``intent`` record)."""

    seq: int
    cycle: int
    op: str  # statement kind: "bind" | "evict"
    gang: str  # job uid the task belongs to ("" for gang-less writes)
    pod: str  # "ns/name"
    node: str  # target host for binds; "" for evicts


@dataclass
class ReplayResult:
    """What a journal file says happened (fsck + reconciliation input)."""

    intents: dict[int, Intent]  # every intent record, by seq
    confirmed: set[int]  # seqs with a confirm record
    corrupt: int  # unparseable lines (torn tail, bit rot)

    @property
    def orphans(self) -> list[Intent]:
        """Intents with no confirm — the in-flight set at crash time."""
        return [i for s, i in sorted(self.intents.items()) if s not in self.confirmed]


class WriteIntentJournal:
    """Append-only WAL over one file; thread-safe (the cache's write
    pool confirms from multiple threads)."""

    # Confirmed records are dead weight; once this many have
    # accumulated, the next append rewrites the file with only the
    # outstanding intents (atomic tmp+rename), bounding journal growth
    # on a long-lived leader.
    COMPACT_THRESHOLD = 4096

    def __init__(self, path: str, fsync: bool = False) -> None:
        self.path = path
        self.fsync = fsync
        self._lock = threading.Lock()
        self._outstanding: dict[int, Intent] = {}
        self._confirmed_since_compact = 0
        self._next_seq = 1
        # Resume from an existing journal (restart without takeover —
        # the owner is expected to reconcile, but seq numbering must be
        # monotonic regardless).
        if os.path.exists(path):
            replay = self.replay(path)
            self._outstanding = {i.seq: i for i in replay.orphans}
            if replay.intents:
                self._next_seq = max(replay.intents) + 1
        self._fh = open(path, "a", encoding="utf-8")  # noqa: SIM115 - journal lifetime

    # -- write side ---------------------------------------------------------

    def append_intents(
        self,
        op: str,
        entries: list[tuple[str, str, str]],
        cycle: int = 0,
        trace: str = "",
        explain: dict | None = None,
    ) -> list[int]:
        """Append one ``intent`` record per (gang, pod_key, node) entry
        as a single flushed write; returns the assigned seqs (parallel
        to ``entries``). Raises on I/O failure or the ``journal.append``
        fault — the caller decides whether to dispatch unprotected.

        ``trace`` is the dispatching cycle's trace id (obs);
        when set it rides each intent record so a takeover post-mortem
        can join the journal against a flight-recorder dump. ``explain``
        maps gang uid -> compact forensics payload (obs/explain.py
        ``intent_payload``; the cache passes it with ``KBT_EXPLAIN`` on);
        when the dispatching gang has one it rides
        the intent record, giving the journal labeled (state, decision,
        reason) tuples. The record format is the JAX package's byte for
        byte, so a journal either package wrote replays in the other.
        ``replay`` ignores unknown keys, so old journals and
        traceless/explainless writers stay fully compatible."""
        if not entries:
            return []
        if faults.should_fire("journal.append"):
            raise faults.FaultInjected("journal.append: injected journal I/O failure")
        with self._lock:
            seqs = list(range(self._next_seq, self._next_seq + len(entries)))
            self._next_seq += len(entries)
            lines = []
            for seq, (gang, pod, node) in zip(seqs, entries):
                intent = Intent(
                    seq=seq, cycle=cycle, op=op, gang=gang, pod=pod, node=node
                )
                self._outstanding[seq] = intent
                rec = {
                    "rec": "intent",
                    "seq": seq,
                    "cycle": cycle,
                    "op": op,
                    "gang": gang,
                    "pod": pod,
                    "node": node,
                }
                if trace:
                    rec["trace"] = trace
                if explain and gang in explain:
                    rec["explain"] = explain[gang]
                lines.append(json.dumps(rec, separators=(",", ":")))
            self._write("\n".join(lines) + "\n")
        metrics.register_journal_records("intent", len(entries))
        return seqs

    def confirm(self, seq: int) -> None:
        """The store write for ``seq`` acked; the intent is no longer in
        flight. Unknown/already-confirmed seqs are no-ops (idempotent —
        reconciliation and the write pool may both confirm)."""
        with self._lock:
            if self._outstanding.pop(seq, None) is None:
                return
            self._write(
                json.dumps({"rec": "confirm", "seq": seq}, separators=(",", ":"))
                + "\n"
            )
            self._confirmed_since_compact += 1
            compact = self._confirmed_since_compact >= self.COMPACT_THRESHOLD
        metrics.register_journal_records("confirm", 1)
        if compact:
            self.compact()

    @assume_locked
    def _write(self, data: str) -> None:
        self._fh.write(data)
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())

    # -- maintenance --------------------------------------------------------

    def outstanding(self) -> list[Intent]:
        with self._lock:
            return [self._outstanding[s] for s in sorted(self._outstanding)]

    def compact(self) -> None:
        """Rewrite the file with only the outstanding intents (atomic
        tmp+rename); confirmed history is dropped."""
        with self._lock:
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as out:
                for seq in sorted(self._outstanding):
                    i = self._outstanding[seq]
                    out.write(
                        json.dumps(
                            {
                                "rec": "intent",
                                "seq": i.seq,
                                "cycle": i.cycle,
                                "op": i.op,
                                "gang": i.gang,
                                "pod": i.pod,
                                "node": i.node,
                            },
                            separators=(",", ":"),
                        )
                        + "\n"
                    )
                out.flush()
                os.fsync(out.fileno())
            self._fh.close()
            os.replace(tmp, self.path)
            self._fh = open(self.path, "a", encoding="utf-8")  # noqa: SIM115
            self._confirmed_since_compact = 0
            outstanding = len(self._outstanding)
        log.debug("journal %s compacted (%d outstanding)", self.path, outstanding)

    def close(self) -> None:
        with self._lock:
            self._fh.close()

    # -- read side ----------------------------------------------------------

    @staticmethod
    def replay(path: str) -> ReplayResult:
        """Parse a journal file into intents + confirms. Malformed lines
        (torn tail) are counted, not fatal. The ``journal.replay`` fault
        point simulates an unreadable journal at takeover."""
        if faults.should_fire("journal.replay"):
            raise faults.FaultInjected("journal.replay: injected replay failure")
        intents: dict[int, Intent] = {}
        confirmed: set[int] = set()
        corrupt = 0
        if not os.path.exists(path):
            return ReplayResult(intents, confirmed, 0)
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    kind = rec["rec"]
                    if kind == "intent":
                        intent = Intent(
                            seq=int(rec["seq"]),
                            cycle=int(rec.get("cycle", 0)),
                            op=str(rec["op"]),
                            gang=str(rec.get("gang", "")),
                            pod=str(rec["pod"]),
                            node=str(rec.get("node", "")),
                        )
                        intents[intent.seq] = intent
                    elif kind == "confirm":
                        confirmed.add(int(rec["seq"]))
                    else:
                        corrupt += 1
                except (ValueError, KeyError, TypeError):
                    corrupt += 1
        return ReplayResult(intents, confirmed, corrupt)


def journal_from_env() -> Optional[WriteIntentJournal]:
    """The ``KBT_JOURNAL`` env path, or None (journaling off)."""
    path = os.environ.get("KBT_JOURNAL", "").strip()
    return WriteIntentJournal(path) if path else None
