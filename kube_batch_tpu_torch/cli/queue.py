"""queue create / list / delete against the scheduler's HTTP API
(reference pkg/cli/queue/create.go:46-67, list.go:54-87), ``version``,
and the ``explain`` subcommand over /debug/explain (unschedulability
forensics, obs/explain.py)."""

from __future__ import annotations

import argparse
import json
import sys
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional, TextIO

from kube_batch_tpu_torch.version import info as version_info

DEFAULT_SERVER = "http://127.0.0.1:8080"


def _request(
    method: str, url: str, body: Optional[dict] = None, timeout: float = 10
) -> dict:
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        payload = resp.read()
    return json.loads(payload) if payload else {}


def print_queues(items: list[dict], out: TextIO) -> None:
    """PrintQueues parity: %-25s%-8s columns (list.go:72-87)."""
    out.write(f"{'Name':<25}{'Weight':<8}\n")
    for q in items:
        out.write(f"{q.get('name', ''):<25}{q.get('weight', 0):<8}\n")


def cmd_create(args, out: TextIO) -> int:
    _request(
        "POST",
        f"{args.server}/apis/v1alpha1/queues",
        {"name": args.name, "weight": args.weight},
    )
    return 0


def cmd_list(args, out: TextIO) -> int:
    payload = _request("GET", f"{args.server}/apis/v1alpha1/queues")
    items = payload.get("items", [])
    if not items and not getattr(args, "watch", False):
        out.write("No resources found\n")  # list.go:63-65
        return 0
    print_queues(items, out)
    if getattr(args, "watch", False):
        _watch_queues(args, payload.get("resourceVersion", 0), out)
    return 0


def _watch_queues(args, since: int, out: TextIO) -> None:
    """Long-poll /watch/queues from the list's resourceVersion, printing
    one line per event until interrupted (kubectl get -w shape)."""
    while True:
        try:
            payload = _request(
                "GET",
                f"{args.server}/apis/v1alpha1/watch/queues"
                f"?since={since}&timeout={args.watch_timeout}",
                timeout=args.watch_timeout + 10,
            )
        except urllib.error.HTTPError as err:
            if err.code == 410:  # fell behind the ring: re-list and resume
                listing = _request("GET", f"{args.server}/apis/v1alpha1/queues")
                print_queues(listing.get("items", []), out)
                since = listing.get("resourceVersion", 0)
                continue
            raise
        for ev in payload.get("events", []):
            q = ev.get("object", {})
            out.write(
                f"{ev.get('type', ''):<10}{q.get('name', ''):<25}"
                f"{q.get('weight', 0):<8}\n"
            )
            out.flush()
        since = payload.get("resourceVersion", since)
        if getattr(args, "watch_once", False) and payload.get("events"):
            return


def cmd_delete(args, out: TextIO) -> int:
    _request("DELETE", f"{args.server}/apis/v1alpha1/queues/{args.name}")
    return 0


def cmd_explain(args, out: TextIO) -> int:
    """Fetch unschedulability forensics from /debug/explain: per gang the
    dominant reason, per-plane elimination counts, would-fit-if planes and
    near-miss nodes from the last allocate cycle."""
    url = f"{args.server}/debug/explain"
    if args.gang:
        url += "?gang=" + urllib.parse.quote(args.gang)
    payload = _request("GET", url)
    if args.as_json:
        out.write(json.dumps(payload, sort_keys=True) + "\n")
        return 0
    if not payload.get("enabled", False):
        out.write("explain is disabled (set KBT_EXPLAIN=1 or conf "
                  "'explain: \"1\"')\n")
        return 0
    recs = payload.get("records", [])
    if args.gang:
        if not recs:
            out.write(f"no explain record for gang {args.gang!r} "
                      "(bound earlier, or not seen by the last cycle)\n")
            return 1
        for rec in recs:
            out.write(json.dumps(rec, sort_keys=True, indent=2) + "\n")
        return 0
    out.write(f"{'Gang':<32}{'Verdict':<15}{'Reason':<12}"
              f"{'Ready':<7}{'Min':<5}\n")
    for rec in sorted(recs, key=lambda r: r.get("name", "")):
        out.write(
            f"{rec.get('name', ''):<32}{rec.get('verdict', ''):<15}"
            f"{rec.get('reason', ''):<12}{rec.get('ready', 0):<7}"
            f"{rec.get('min', 0):<5}\n"
        )
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="kbt-ctl", description="kube-batch-tpu admin CLI"
    )
    parser.add_argument(
        "--server",
        default=DEFAULT_SERVER,
        help="scheduler server address (default %(default)s)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("version", help="print client version")

    queue = sub.add_parser("queue", help="queue operations")
    qsub = queue.add_subparsers(dest="queue_command", required=True)

    create = qsub.add_parser("create", help="create a queue (create.go:46-67)")
    create.add_argument("--name", required=True, help="queue name")
    create.add_argument(
        "--weight", type=int, default=1, help="proportion weight (default 1)"
    )
    create.set_defaults(fn=cmd_create)

    lst = qsub.add_parser("list", help="list queues (list.go:54-70)")
    lst.add_argument(
        "--watch", action="store_true",
        help="after listing, stream queue add/update/delete events",
    )
    lst.add_argument(
        "--watch-timeout", type=float, default=30.0, help=argparse.SUPPRESS
    )
    lst.add_argument(
        "--watch-once", action="store_true", help=argparse.SUPPRESS
    )  # exit after the first event batch (tests)
    lst.set_defaults(fn=cmd_list)

    delete = qsub.add_parser("delete", help="delete a queue")
    delete.add_argument("--name", required=True, help="queue name")
    delete.set_defaults(fn=cmd_delete)

    explain = sub.add_parser(
        "explain",
        help="why gangs are unschedulable (/debug/explain forensics)",
    )
    explain.add_argument(
        "--gang", default=None,
        help="filter to one gang (uid, PodGroup name, or namespace/name)",
    )
    explain.add_argument(
        "--json", action="store_true", dest="as_json",
        help="print the raw /debug/explain payload",
    )
    explain.set_defaults(fn=cmd_explain)

    return parser


def main(argv: Optional[list[str]] = None, out: TextIO = sys.stdout) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "version":
        out.write("\n".join(version_info()) + "\n")
        return 0
    try:
        return args.fn(args, out)
    except urllib.error.HTTPError as err:
        detail = err.read().decode(errors="replace").strip()
        print(f"Error: {err.code} {err.reason}: {detail}", file=sys.stderr)
        return 1
    except urllib.error.URLError as err:
        print(f"Error: cannot reach {args.server}: {err.reason}", file=sys.stderr)
        return 1


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
