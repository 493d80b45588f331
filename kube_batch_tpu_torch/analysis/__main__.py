"""CLI for the domain-aware static analysis suite.

Usage::

    python -m kube_batch_tpu_torch.analysis [--json] [--strict]
                                      [--baseline PATH] [--no-baseline]
                                      [--repo PATH] [--explain CODE]
                                      [--prune]

Exit codes: 0 clean (every finding suppressed with a reason), 1 findings
or baseline problems, 2 usage error. ``--strict`` additionally fails on
stale baseline entries (KBT-B002), so the committed baseline can only
shrink. ``--explain CODE`` prints what a code protects and how to fix
it, then exits. ``--prune`` rewrites the baseline in place with the
stale entries removed (verbatim preamble/reasons/order preserved), the
mechanical half of the only-shrinks policy.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import textwrap

from kube_batch_tpu_torch.analysis import (
    CODES,
    apply_baseline,
    baseline_path,
    load_baseline,
    render_baseline,
    repo_root,
    run_suite,
)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m kube_batch_tpu_torch.analysis",
        description="lock-discipline / torch-hazard / registry-consistency / "
        "snapshot-escape / lock-order / protocol / thread analyzers "
        "over the PyTorch/CUDA package (stdlib-only)",
    )
    p.add_argument("--json", action="store_true", help="machine-readable summary")
    p.add_argument("--strict", action="store_true",
                   help="also fail on stale baseline entries")
    p.add_argument("--baseline", default=None,
                   help="suppression file (default: <repo>/kube_batch_tpu_torch/analysis/lint-baseline.toml)")
    p.add_argument("--no-baseline", action="store_true",
                   help="report raw findings, apply no suppressions")
    p.add_argument("--repo", default=None, help="tree to analyze (default: auto)")
    p.add_argument("--explain", metavar="CODE", default=None,
                   help="describe a finding code and exit")
    p.add_argument("--prune", action="store_true",
                   help="rewrite the baseline dropping stale (KBT-B002) "
                   "entries; reasons, ordering and the preamble comment "
                   "block are preserved verbatim")
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

    repo = os.path.abspath(args.repo) if args.repo else repo_root()
    findings = run_suite(repo)

    if args.no_baseline:
        kept, suppressed, stale, baseline_errors = findings, [], [], []
        bl_path = None
    else:
        bl_path = args.baseline or baseline_path(repo)
        bl = load_baseline(bl_path, repo)
        kept, suppressed, stale = apply_baseline(findings, bl)
        baseline_errors = bl.errors

    if args.prune:
        if args.no_baseline:
            print("--prune is meaningless with --no-baseline")
            return 2
        # Keep every entry that matched a finding this run, plus
        # incomplete entries (they fail as KBT-B001 — deleting them would
        # hide the error instead of fixing it). Drop exactly the stale set.
        keep = [s for s in bl.suppressions
                if s.hits > 0 or not (s.code and s.path)]
        dropped = [s for s in bl.suppressions if s not in keep]
        if dropped:
            with open(bl_path, "w", encoding="utf-8") as fh:
                fh.write(render_baseline(bl, keep))
        for s in dropped:
            print(f"pruned: {s.code} at {s.path}"
                  + (f" ({s.symbol})" if s.symbol else ""))
        print(f"prune: {len(dropped)} stale entr{'y' if len(dropped) == 1 else 'ies'} "
              f"dropped, {len(keep)} kept")
        stale = []  # just removed; don't also fail on them

    failing = list(kept) + list(baseline_errors)
    if args.strict:
        failing += stale

    if args.json:
        print(json.dumps({
            "ok": not failing,
            "repo": repo,
            "findings": [f.__dict__ for f in kept],
            "baseline_errors": [f.__dict__ for f in baseline_errors],
            "stale": [f.__dict__ for f in stale],
            "suppressed": len(suppressed),
            "counts": _counts(kept),
        }, sort_keys=True))
    else:
        for f in sorted(failing, key=lambda f: (f.path, f.line, f.code)):
            print(f.render())
        if stale and not args.strict:
            for f in stale:
                print(f"note: {f.render()}")
        tail = (
            f"analysis: {len(kept)} finding(s), "
            f"{len(baseline_errors)} baseline error(s), "
            f"{len(stale)} stale suppression(s), "
            f"{len(suppressed)} suppressed"
        )
        print(tail)
    return 1 if failing else 0


def _counts(findings) -> dict[str, int]:
    out: dict[str, int] = {}
    for f in findings:
        out[f.code] = out.get(f.code, 0) + 1
    return out


if __name__ == "__main__":
    sys.exit(main())
