"""Warm-cycle audit of the card's solver rungs (KBT-P001..P005).

The source-AST suite (``kube_batch_tpu_torch.analysis``) sees what the
code says; this audit runs the rungs and checks what they do. Torch
builds no program to walk, so each check reads a run:

- **P001 host syncs in a warm cycle**: one warm scheduling cycle runs
  under ``torch.cuda.set_sync_debug_mode("warn")``; every synchronizing
  CUDA call torch makes is recorded (``warnings.catch_warnings(record=
  True)`` with the ``"always"`` filter, since the default filter shows a
  repeated site once and would undercount), attributed to a package
  ``file:line`` and counted. A site with no entry in the trace baseline is
  a finding, and so is an entry's sites counting more syncs, summed,
  than the entry's ``max_count`` (:func:`apply_trace_baseline`): a new
  sync line inside a baselined function, or a per-solve sync turned
  per-iteration. The sharded rung's solve on the warm world runs under
  the same audit (its per-iteration record read is deliberate, and
  bounded). The kernels' launches alone run under ``"error"``
  (:func:`no_sync`): B1, B2 and B3 launch without a torch-side sync. A
  sync inside a kernel's C++ launcher is invisible to torch (it does not
  go through torch's CUDA wrappers). P001 needs a card.
- **P002 float64 leaks**: every ``SolveState`` field a rung returns from
  float32 inputs is float32 or an integer type. The rungs are fused (B1),
  sharded (B2) at each mesh size and class (B3, expanded back to node
  space), each also as its plain version, and the twin
  (``ops/kernels.py``). Deliberate float64 inputs (the scans' float64
  encode, ``VectorScan``) are exempt.
- **P003/P004** keep their codes and ``--explain`` texts; nothing fires
  them until the device-resident tensor arena is ported (its statics'
  uploads and its in-place row update are what they will check).
- **P005 signature drift**: the ``SolveState`` field names, shapes and
  dtypes are equal, field for field, across the rungs and the twin.

Own CLI: ``python -m kube_batch_tpu_torch.analysis.trace``; own baseline
``kube_batch_tpu_torch/analysis/trace-baseline.toml``. torch is imported
inside the functions, so importing this module costs nothing.
"""

from __future__ import annotations

import ast
import contextlib
import os
import warnings
from typing import Iterable

import numpy as np

from kube_batch_tpu_torch.analysis import Baseline, Finding, apply_baseline

__all__ = [
    "MESH_SIZES_DEFAULT",
    "SYNC_WARNING",
    "SyncAudit",
    "WARM_WORLD",
    "apply_trace_baseline",
    "attribute_syncs",
    "audit_card_path",
    "build_snapshot",
    "check_f64",
    "check_signature_drift",
    "check_sync_bounds",
    "check_syncs",
    "guard_calls",
    "no_sync",
    "rung_path",
    "rung_states",
    "run_trace_audit",
    "state_signature",
    "warm_cycle_audit",
]

MESH_SIZES_DEFAULT = (1, 2, 4)
# preempt_mix(pods, nodes, seed=1): the world whose sharded solve P001
# audits; the trace baseline's max_counts are this world's counts
WARM_WORLD = (2000, 40)
# the audited sharded solve's mesh: this many shards on the current card
MESH_AUDIT = 4
# torch's warning text for a synchronizing call under sync debug mode "warn"
SYNC_WARNING = "called a synchronizing CUDA operation"

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_REPO_DIR = os.path.dirname(_PACKAGE_DIR)

# Rung anchor paths (repo-relative) for findings.
_PATHS = {
    "twin": "kube_batch_tpu_torch/ops/kernels.py",
    "fused": "kube_batch_tpu_torch/ops/fused_solve.py",
    "sharded": "kube_batch_tpu_torch/parallel/sharded_block.py",
    "class": "kube_batch_tpu_torch/ops/class_solve.py",
}


# -- P001: host syncs ---------------------------------------------------------


_QUALNAMES: dict[str, list[tuple[int, int, str]]] = {}


def _enclosing(path: str, lineno: int) -> str:
    """The qualified name of the innermost def around ``lineno`` in the
    file at ``path`` ("<module>" outside any def)."""
    spans = _QUALNAMES.get(path)
    if spans is None:
        spans = []
        try:
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), path)
        except (OSError, SyntaxError):
            tree = None

        def walk(node, prefix):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                    q = f"{prefix}{child.name}"
                    if not isinstance(child, ast.ClassDef):
                        spans.append((child.lineno, child.end_lineno or child.lineno, q))
                    walk(child, q + ".")
                else:
                    walk(child, prefix)

        if tree is not None:
            walk(tree, "")
        _QUALNAMES[path] = spans
    best = "<module>"
    width = None
    for lo, hi, q in spans:
        if lo <= lineno <= hi and (width is None or hi - lo <= width):
            best, width = q, hi - lo
    return best


def sync_site(filename: str, lineno: int) -> tuple[str, int, str]:
    """(repo-relative path, line, enclosing qualified name) of one sync.
    A site outside the package keeps its file's last two path parts
    under ``<outside>/`` (a sync torch's own Python code made for a
    caller the warning does not name)."""
    full = os.path.abspath(filename)
    if full.startswith(_PACKAGE_DIR + os.sep):
        rel = os.path.relpath(full, _REPO_DIR).replace(os.sep, "/")
        return rel, lineno, _enclosing(full, lineno)
    parts = full.replace(os.sep, "/").split("/")
    return "<outside>/" + "/".join(parts[-2:]), lineno, "<outside>"


def attribute_syncs(records: Iterable) -> dict[tuple[str, int, str], int]:
    """Count recorded sync warnings per site. ``records`` are
    ``warnings.WarningMessage``s (as ``catch_warnings(record=True)``
    gives them); warnings that are not sync warnings are ignored."""
    sites: dict[tuple[str, int, str], int] = {}
    for w in records:
        if SYNC_WARNING not in str(w.message):
            continue
        key = sync_site(w.filename, w.lineno)
        sites[key] = sites.get(key, 0) + 1
    return sites


def check_syncs(sites: dict[tuple[str, int, str], int], label: str) -> list[Finding]:
    """KBT-P001: one finding per sync site. The trace baseline keeps the
    deliberate ones (matched on path and the enclosing function's name);
    a site it does not name is a new sync on the card's path."""
    return [
        Finding(
            path=path,
            line=line,
            code="KBT-P001",
            message=(
                f"{n} host sync(s) at {path}:{line} in {qual} during {label} — "
                "each one drains the card's queue; keep the value on the card, "
                "fetch it once, or baseline the site with its role"
            ),
            symbol=qual,
        )
        for (path, line, qual), n in sorted(sites.items())
    ]


def check_sync_bounds(sites: dict[tuple[str, int, str], int], bl: Baseline) -> list[Finding]:
    """KBT-P001 past a bound: each KBT-P001 entry of ``bl`` bounds the
    syncs that one audit counts at the sites it matches, summed, by its
    ``max_count``. An entry with no ``max_count`` is a KBT-B001 finding:
    without one a per-iteration sync could hide behind a per-solve
    entry."""
    out: list[Finding] = []
    for s in bl.suppressions:
        if s.code != "KBT-P001":
            continue
        if not s.max_count:
            out.append(Finding(
                bl.path, s.line, "KBT-B001",
                f"KBT-P001 entry for {s.path} ({s.symbol or 'any function'}) has no max_count — "
                "every sync entry bounds the syncs it excuses",
                symbol=f"max_count:{s.path}:{s.symbol}",
            ))
            continue
        hit = [(k, n) for k, n in sorted(sites.items())
               if s.matches(Finding(k[0], k[1], "KBT-P001", "", symbol=k[2]))]
        total = sum(n for _, n in hit)
        if total > s.max_count:
            (path, line, qual), _ = hit[0]
            out.append(Finding(
                path, line, "KBT-P001",
                f"{total} host sync(s) at {len(hit)} site(s) of {s.path} ({s.symbol or 'any function'}), "
                f"past the trace baseline's max_count {s.max_count}: "
                + ", ".join(f"line {ln}: {n}" for (_, ln, _), n in hit),
                symbol=f"{qual}>max_count",
            ))
    return out


def apply_trace_baseline(
    findings: list[Finding], bl: Baseline, sites: dict[tuple[str, int, str], int]
) -> tuple[list[Finding], list[Finding], list[Finding]]:
    """``apply_baseline`` for the trace audit -> (kept, suppressed, stale);
    ``kept`` also holds :func:`check_sync_bounds`' findings over
    ``sites`` (the audits' sync counts; empty where P001 did not run)."""
    kept, suppressed, stale = apply_baseline(findings, bl)
    return kept + check_sync_bounds(sites, bl), suppressed, stale


class SyncAudit:
    """Record every synchronizing CUDA call torch makes in the region,
    under ``torch.cuda.set_sync_debug_mode("warn")``. The mode is reset
    in ``__exit__`` whatever happens in the region (it is process-wide).
    After exit: ``sites`` ({(path, line, qualname): count}) and
    ``total``. Warnings that are not sync warnings are shown
    again after the region."""

    def __init__(self) -> None:
        self.sites: dict[tuple[str, int, str], int] = {}
        self.total = 0
        self._records: list = []
        self._catch = None
        self._prev = 0

    def __enter__(self) -> "SyncAudit":
        import torch

        self._catch = warnings.catch_warnings(record=True)
        self._records = self._catch.__enter__()
        warnings.simplefilter("always")
        self._prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        import torch

        try:
            torch.cuda.set_sync_debug_mode(self._prev)
        finally:
            self._catch.__exit__(exc_type, exc, tb)
        self.sites = attribute_syncs(self._records)
        self.total = sum(self.sites.values())
        for w in self._records:
            if SYNC_WARNING not in str(w.message):
                warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
        return False


@contextlib.contextmanager
def no_sync():
    """Run the region under ``torch.cuda.set_sync_debug_mode("error")``:
    any synchronizing CUDA call torch makes raises. The previous mode is
    restored in a ``finally``, so a failing check cannot leave later code
    under ``"error"``."""
    import torch

    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def guard_calls(owner, attr: str):
    """Within the region, every call of ``owner.<attr>`` (a method of a
    class, or a function of a module) runs under :func:`no_sync`, and
    ``guarded.calls`` counts them. The original is put back on exit."""
    original = getattr(owner, attr)
    state = {"calls": 0}

    def guarded(*args, **kwargs):
        state["calls"] += 1
        with no_sync():
            return original(*args, **kwargs)

    setattr(owner, attr, guarded)
    try:
        yield state
    finally:
        setattr(owner, attr, original)


def warm_cycle_audit(run_cycle) -> SyncAudit:
    """Run ``run_cycle()`` once under a :class:`SyncAudit`, the card idle
    before and after (outside the audit). Returns the audit."""
    import torch

    torch.cuda.synchronize()
    with SyncAudit() as audit:
        run_cycle()
    torch.cuda.synchronize()
    return audit


# -- P002 / P005 ---------------------------------------------------------------


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def state_signature(state) -> dict:
    """SolveState (of tensors or arrays) -> {field: (shape, dtype)} for the
    cross-rung drift check."""
    return {f: (tuple(getattr(state, f).shape), _dtype_name(getattr(state, f))) for f in state._fields}


def check_f64(state, entry: str, path: str, inputs_f64: bool = False) -> list[Finding]:
    """KBT-P002: float64 fields in a rung's returned SolveState when its
    inputs are float32. ``inputs_f64`` marks deliberate float64 inputs
    (the scans' encode), which are exempt."""
    if inputs_f64:
        return []
    hits = [f for f, (_, dt) in state_signature(state).items() if dt == "float64"]
    if not hits:
        return []
    return [
        Finding(
            path=path,
            line=1,
            code="KBT-P002",
            message=(
                f"rung {entry!r} returns float64 SolveState fields "
                f"({', '.join(hits)}) from float32 inputs — pin the dtype at "
                "the leak site (a Python float promoted, a dtype-less "
                "torch.tensor, an np.float64 constant)"
            ),
            symbol=f"{entry}.f64",
        )
    ]


def check_signature_drift(ref_sig: dict, sig: dict, ref_entry: str, entry: str, path: str) -> list[Finding]:
    """KBT-P005: field-for-field shape+dtype equality of two rungs'
    SolveState outputs."""
    findings = []
    for field in sorted(set(ref_sig) | set(sig)):
        a, b = ref_sig.get(field), sig.get(field)
        if a != b:
            findings.append(
                Finding(
                    path=path,
                    line=1,
                    code="KBT-P005",
                    message=(
                        f"SolveState.{field} drifts between {ref_entry!r} "
                        f"{a} and {entry!r} {b} — the rungs no longer "
                        "speak the same resume protocol"
                    ),
                    symbol=f"{entry}.drift.{field}",
                )
            )
    return findings


# -- the audited rungs ----------------------------------------------------------


def build_snapshot(n_tasks: int = 64, n_nodes: int = 24, dtype=np.float32) -> dict:
    """The solver input dict of a small seeded world, as torch_allocate
    builds it: the encoder's arrays (``dtype``), nodeorder's weights folded
    in as float32, host-only metadata dropped. The node bucket pads to a
    multiple of 128, so every mesh size in ``MESH_SIZES_DEFAULT``
    divides it."""
    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch.ops.encode import encode_session
    from kube_batch_tpu_torch.plugins.drf import drf_state
    from kube_batch_tpu_torch.plugins.proportion import proportion_state
    from kube_batch_tpu_torch.solve import solver_inputs, valid_jobs

    cluster = models.multi_queue(n_tasks, n_nodes)
    enc = encode_session(
        valid_jobs(cluster), cluster.nodes, cluster.queues, dtype=dtype,
        drf=drf_state(cluster.jobs, cluster.nodes),
        proportion=proportion_state(cluster.jobs, cluster.nodes, cluster.queues),
    )
    return {k: np.asarray(v) for k, v in solver_inputs(enc, (1, 1, 1, 1)).items()}


def _require_card(what: str, device: str) -> None:
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}(device={device!r}): no CUDA device (pass device='cpu')")


def rung_states(arrays: dict, device: str = "cuda", mesh_sizes: tuple = MESH_SIZES_DEFAULT) -> dict:
    """entry -> the SolveState each rung returns on ``arrays`` from the
    entry state: the twin, ``fused``, ``sharded@m`` for each mesh size and
    ``class``, on ``device`` (the card by default; raises without one); on
    a card also each rung's plain version on the CPU (``<entry>.plain``)."""
    import torch

    _require_card("rung_states", device)

    from kube_batch_tpu_torch.ops import class_solve as cs
    from kube_batch_tpu_torch.ops.carry import arrays_from_numpy
    from kube_batch_tpu_torch.ops.fused_solve import FusedSolver
    from kube_batch_tpu_torch.ops.kernels import solve_allocate_state
    from kube_batch_tpu_torch.parallel.sharded_block import ShardedBlockSolver

    def rungs(dev: str, suffix: str) -> dict:
        a = arrays_from_numpy(arrays)
        d = torch.device(dev)
        out = {f"fused{suffix}": FusedSolver(a, True, True, device=d).solve()}
        for m in mesh_sizes:
            out[f"sharded@{m}{suffix}"] = ShardedBlockSolver(a, [d] * m, True, True).solve()
        out[f"class{suffix}"] = cs.ClassCompressedSolver(cs.ClassTable(), arrays, True, True, device=d).solve()
        return out

    states = {"twin": solve_allocate_state(arrays_from_numpy(arrays), None, True, True)}
    states.update(rungs(device, ""))
    if torch.device(device).type == "cuda":
        states.update(rungs("cpu", ".plain"))
    return states


def rung_path(entry: str) -> str:
    """The anchor path of a rung's findings (``sharded@4.plain`` ->
    ``parallel/sharded_block.py``)."""
    return _PATHS.get(entry.split("@")[0].split(".")[0], _PATHS["twin"])


def check_states(states: dict, ref: str = "twin", inputs_f64: bool = False) -> list[Finding]:
    """P002 on every state, P005 of every state against ``states[ref]``."""
    findings: list[Finding] = []
    for entry, st in states.items():
        findings += check_f64(st, entry, rung_path(entry), inputs_f64=inputs_f64)
    ref_sig = state_signature(states[ref])
    for entry, st in states.items():
        if entry != ref:
            findings += check_signature_drift(ref_sig, state_signature(st), ref, entry, rung_path(entry))
    return findings


_WARM_CONF = (
    'actions: "enqueue, torch_reclaim, torch_allocate, torch_backfill, torch_preempt"\n'
    "tiers:\n"
    "- plugins:\n  - name: priority\n  - name: gang\n  - name: conformance\n"
    "- plugins:\n  - name: drf\n  - name: predicates\n  - name: proportion\n  - name: tensorscore\n"
    "actionArguments:\n  torch_allocate:\n    device: cuda\n    min_device_pairs: 0\n"
)


def audit_card_path(run_cycle, arrays: dict) -> tuple[dict[tuple[str, int, str], int], dict]:
    """KBT-P001 on the card, in three steps:

    1. ``run_cycle()`` (a warm scheduling cycle) once under a
       :class:`SyncAudit`;
    2. the sharded rung's solve on ``arrays`` (``MESH_AUDIT`` shards on
       the current card) under another, each B2 launch under ``"error"``;
    3. B1 alone on ``arrays`` under ``"error"``: upload done, the launch,
       then the fetch.

    Returns both audits' sync counts per site, summed (``{(path, line,
    qualname): count}``, what :func:`check_syncs` and
    :func:`apply_trace_baseline` take), and a record with ``sites``,
    ``total`` (the cycle's), ``sharded_total``, ``cycle_b1`` and
    ``cycle_b2`` (the cycle's launches) and ``b2_launches_without_sync``.
    The checks' own launches are not counted: the kernels' launch counters
    are put back to their values after the cycle."""
    import torch

    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.ops.carry import arrays_from_numpy
    from kube_batch_tpu_torch.ops.kernels import init_state
    from kube_batch_tpu_torch.parallel.sharded_block import ShardedBlockSolver

    b1, b2 = fs.fused_solve.launches, bs.block_step.launches
    cycle = warm_cycle_audit(run_cycle)
    counts = fs.fused_solve.launches, bs.block_step.launches
    a = arrays_from_numpy(arrays)
    card = torch.device("cuda", torch.cuda.current_device())
    with guard_calls(bs.BlockStep, "__call__") as guarded:  # each B2 launch under "error"
        sharded = warm_cycle_audit(ShardedBlockSolver(a, [card] * MESH_AUDIT, True, True).solve)
    packed = fs.pack(a, True, True).to(card)
    host = fs.pack_state(packed.dims, init_state(a, True, True), a["job_queue"])
    state = fs.PackedState(packed.dims, host.istate.to(card), host.fstate.to(card))
    torch.cuda.synchronize()
    with no_sync():
        fs.fused_solve(packed, state)
    torch.cuda.synchronize()
    fs.fused_solve.launches, bs.block_step.launches = counts
    sites = dict(cycle.sites)
    for k, n in sharded.sites.items():
        sites[k] = sites.get(k, 0) + n
    record = {
        "sites": {f"{p}:{ln} {q}": n for (p, ln, q), n in sorted(sites.items())},
        "total": cycle.total, "sharded_total": sharded.total,
        "cycle_b1": counts[0] - b1, "cycle_b2": counts[1] - b2,
        "b1_launch_without_sync": True, "b2_launches_without_sync": guarded["calls"],
    }
    return sites, record


def _warm_cycle_p001() -> tuple[dict[tuple[str, int, str], int], dict]:
    """The twin pipeline's Scheduler over ``preempt_mix(*WARM_WORLD,
    seed=1)`` on the card: two cycles, then :func:`audit_card_path` on a
    third and on the world's solver arrays, all with zero kernel builds."""
    import tempfile

    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch.analysis.trace.sentinel import CompileSentinel
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.scheduler import Scheduler
    from kube_batch_tpu_torch.solve import solver_arrays
    from kube_batch_tpu_torch.testing import FakeCache

    cluster = models.preempt_mix(*WARM_WORLD, seed=1)
    arrays = solver_arrays(cluster)[1]
    fs._library.load()  # the builds, before the sentinel's region
    bs._library.load()
    with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as fh:
        fh.write(_WARM_CONF)
    try:
        sched = Scheduler(FakeCache(cluster), fh.name)
        with CompileSentinel("warm cycles", budget=0) as sentinel:
            sched.run_once()
            sched.run_once()
            sites, record = audit_card_path(sched.run_once, arrays)
    finally:
        os.unlink(fh.name)
    return sites, {**record, "builds": sentinel.builds, "loads": sentinel.loads}


def run_trace_audit(
    device: str = "cuda",
    mesh_sizes: tuple = MESH_SIZES_DEFAULT,
) -> tuple[list[Finding], dict]:
    """Run the rungs and the P001/P002/P005 checks, on the card by default
    (raises without one).

    With ``device="cpu"`` the rungs run their plain versions and P001 does
    not run (it needs a card). On a card the rungs launch their kernels,
    their plain versions run on the CPU beside them, and P001 audits a
    warm cycle of the twin pipeline and the sharded solve over
    ``preempt_mix(*WARM_WORLD)``. Returns ``(findings, info)``; ``info``
    carries the audited entries' signatures, P001's record (``"p001"``)
    and its sync counts per site (``"sync_sites"``, empty where it did not
    run), which :func:`apply_trace_baseline` takes.
    """
    import torch

    _require_card("run_trace_audit", device)
    arrays = build_snapshot()
    states = rung_states(arrays, device, mesh_sizes)
    findings = check_states(states)
    # the scans' deliberate float64 encode: exempt, not silent
    from kube_batch_tpu_torch.ops.carry import arrays_from_numpy
    from kube_batch_tpu_torch.ops.kernels import solve_allocate_state

    twin64 = solve_allocate_state(arrays_from_numpy(build_snapshot(dtype=np.float64)), None, True, True)
    findings += check_f64(twin64, "twin.f64", _PATHS["twin"], inputs_f64=True)
    info: dict = {
        "device": device,
        "mesh_sizes": list(mesh_sizes),
        "entries": {e: {f: [list(s), d] for f, (s, d) in state_signature(st).items()} for e, st in states.items()},
        "snapshot": {k: [list(v.shape), str(v.dtype)] for k, v in sorted(arrays.items())},
    }
    if torch.device(device).type == "cuda":
        info["sync_sites"], info["p001"] = _warm_cycle_p001()
        findings += check_syncs(info["sync_sites"], f"a warm cycle of preempt_mix{WARM_WORLD} and its sharded solve")
    else:
        info["sync_sites"], info["p001"] = {}, "not run: the sync audit needs a card"
    findings.sort(key=lambda f: (f.path, f.line, f.code, f.symbol))
    return findings, info
