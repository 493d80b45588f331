"""Offline journal checker: ``python -m kube_batch_tpu_torch.recovery.fsck``.

Reads a write-intent journal (no store needed, no locks taken) and
reports what a takeover would find: total intents, confirmed, orphaned
(in flight at crash time), the gang statements those orphans belong to,
and corrupt lines (torn tail). The operator's first move after an
unclean leader death — before deciding whether to let reconciliation
run or to intervene.

The JAX package's checker reads the same files and gives the same
output and exit codes.

Exit codes: 0 = journal readable (orphans are *normal* after a crash
and reported, not fatal); 1 = unreadable/corrupt beyond the tolerated
torn tail, or orphans present under ``--strict``.

Usage::

    python -m kube_batch_tpu_torch.recovery.fsck /var/lib/kbt/journal.wal
    python -m kube_batch_tpu_torch.recovery.fsck --json journal.wal   # machine-readable
    python -m kube_batch_tpu_torch.recovery.fsck --strict journal.wal # orphans -> rc 1
"""

from __future__ import annotations

import argparse
import json
import sys

from kube_batch_tpu_torch.recovery.journal import WriteIntentJournal


def fsck(path: str) -> dict:
    """Journal health summary (the --json payload)."""
    replay = WriteIntentJournal.replay(path)
    orphans = replay.orphans
    gangs: dict[str, int] = {}
    for intent in orphans:
        key = f"cycle={intent.cycle} gang={intent.gang or '<none>'}"
        gangs[key] = gangs.get(key, 0) + 1
    return {
        "path": path,
        "intents": len(replay.intents),
        "confirmed": len(replay.confirmed),
        "orphaned": len(orphans),
        "corrupt_lines": replay.corrupt,
        "orphaned_gangs": gangs,
        "orphans": [
            {
                "seq": i.seq,
                "cycle": i.cycle,
                "op": i.op,
                "gang": i.gang,
                "pod": i.pod,
                "node": i.node,
            }
            for i in orphans
        ],
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="kube_batch_tpu_torch.recovery.fsck",
        description="check a bind-intent journal for in-flight writes",
    )
    p.add_argument("journal", help="journal file path (KBT_JOURNAL of the dead leader)")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument(
        "--strict", action="store_true",
        help="exit 1 when orphaned intents exist (CI gates on a clean journal)",
    )
    opt = p.parse_args(argv)
    try:
        summary = fsck(opt.journal)
    except Exception as e:  # noqa: BLE001 - CLI boundary
        print(f"fsck: {opt.journal}: unreadable: {e}", file=sys.stderr)
        return 1
    if opt.json:
        print(json.dumps(summary))
    else:
        print(
            f"fsck: {summary['path']}: {summary['intents']} intent(s), "
            f"{summary['confirmed']} confirmed, {summary['orphaned']} orphaned, "
            f"{summary['corrupt_lines']} corrupt line(s)"
        )
        for gang, n in sorted(summary["orphaned_gangs"].items()):
            print(f"fsck:   in-flight statement: {gang} ({n} intent(s))")
        for o in summary["orphans"]:
            print(
                f"fsck:   seq={o['seq']} {o['op']} {o['pod']}"
                + (f" -> {o['node']}" if o["node"] else "")
            )
    if opt.strict and summary["orphaned"]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
