"""CLI for the warm-cycle audit of the card's solver rungs (KBT-P0xx).

Usage::

    python -m kube_batch_tpu_torch.analysis.trace [--device cpu] [--json]
        [--strict] [--baseline PATH] [--no-baseline] [--explain CODE]
        [--mesh 1,2,4]

Same exit-code contract and baseline machinery as the AST suite
(``python -m kube_batch_tpu_torch.analysis``), but a separate baseline
file (default ``kube_batch_tpu_torch/analysis/trace-baseline.toml``) —
the two gates run independently, so sharing one file would mark each
other's suppressions stale. It runs on the card by default and raises
without one; ``--device cpu`` runs the rungs' plain versions and skips
the sync audit (KBT-P001), whose baseline entries then count as neither
used nor stale.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import textwrap

from kube_batch_tpu_torch.analysis import (
    CODES,
    baseline_path,
    load_baseline,
    repo_root,
)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m kube_batch_tpu_torch.analysis.trace",
        description="warm-cycle audit of the solver rungs (host syncs on the "
        "card, float64 leaks, cross-rung SolveState drift)",
    )
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the rungs run (default: the card)")
    p.add_argument("--json", action="store_true", help="machine-readable summary")
    p.add_argument("--strict", action="store_true",
                   help="also fail on stale baseline entries")
    p.add_argument("--baseline", default=None,
                   help="suppression file (default: kube_batch_tpu_torch/analysis/trace-baseline.toml)")
    p.add_argument("--no-baseline", action="store_true",
                   help="report raw findings, apply no suppressions")
    p.add_argument("--repo", default=None,
                   help="repo root for the baseline path (default: auto)")
    p.add_argument("--explain", metavar="CODE", default=None,
                   help="describe a finding code and exit")
    p.add_argument("--mesh", default="1,2,4",
                   help="comma-separated mesh sizes of the sharded rung (default: 1,2,4)")
    try:
        args = p.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code not in (0, None) else 0

    if args.explain:
        code = args.explain.upper()
        if code not in CODES:
            print(f"unknown code {code!r}; known: {', '.join(sorted(CODES))}")
            return 2
        title, body = CODES[code]
        print(f"{code}: {title}\n")
        print(textwrap.fill(body, width=78))
        return 0

    try:
        mesh_sizes = tuple(int(x) for x in args.mesh.split(",") if x.strip())
    except ValueError:
        print(f"bad --mesh {args.mesh!r}")
        return 2

    from kube_batch_tpu_torch.analysis.trace import apply_trace_baseline, run_trace_audit

    findings, info = run_trace_audit(args.device, mesh_sizes)
    p001_ran = isinstance(info["p001"], dict)

    repo = os.path.abspath(args.repo) if args.repo else repo_root()
    if args.no_baseline:
        kept, suppressed, stale, baseline_errors = findings, [], [], []
    else:
        bl = load_baseline(args.baseline or baseline_path(repo, "trace"), repo)
        kept, suppressed, stale = apply_trace_baseline(findings, bl, info["sync_sites"])
        if not p001_ran:
            stale = [f for f in stale if not f.symbol.startswith("KBT-P001:")]
        baseline_errors = bl.errors

    failing = list(kept) + list(baseline_errors)
    if args.strict:
        failing += stale

    if args.json:
        print(json.dumps({
            "ok": not failing,
            "repo": repo,
            "device": args.device,
            "findings": [f.__dict__ for f in kept],
            "baseline_errors": [f.__dict__ for f in baseline_errors],
            "stale": [f.__dict__ for f in stale],
            "suppressed": len(suppressed),
            "counts": _counts(kept),
            "entries": sorted(info["entries"]),
            "mesh_sizes": info["mesh_sizes"],
            "p001": info["p001"],
        }, sort_keys=True))
    else:
        for f in sorted(failing, key=lambda f: (f.path, f.line, f.code)):
            print(f.render())
        if stale and not args.strict:
            for f in stale:
                print(f"note: {f.render()}")
        if p001_ran:
            for site, n in info["p001"]["sites"].items():
                print(f"sync: {n:6d}  {site}")
        print(
            f"trace audit on {args.device}: {len(info['entries'])} rung(s) run "
            f"(mesh {info['mesh_sizes']}), {len(kept)} finding(s), "
            f"{len(baseline_errors)} baseline error(s), "
            f"{len(stale)} stale suppression(s), {len(suppressed)} suppressed"
            + (f", {info['p001']['total']} host sync(s) in the warm cycle and "
               f"{info['p001']['sharded_total']} in the sharded solve" if p001_ran else
               ", sync audit not run (no card)")
        )
    return 1 if failing else 0


def _counts(findings) -> dict[str, int]:
    out: dict[str, int] = {}
    for f in findings:
        out[f.code] = out.get(f.code, 0) + 1
    return out


if __name__ == "__main__":
    sys.exit(main())
