"""Domain-aware static analysis suite of the PyTorch/CUDA package.

The analyzers check the invariants this package lives or dies by, over
its own tree (``kube_batch_tpu_torch/``), each stdlib-only (ast-based):

- **A1 lock-discipline** (:mod:`.lock_discipline`, KBT-L0xx):
  attributes declared guarded (the seed map for the threaded cache,
  store, journal, watch hub, class table and kernel-build layers, or a
  ``#: guarded_by <lock>`` annotation) must only be touched lexically
  inside ``with self.<lock>`` or in a method marked lock-held
  (``_locked`` suffix / ``@assume_locked``); module state declared
  guarded by a module lock only inside ``with <lock>``.
- **A2 torch hazards** (:mod:`.torch_hazards`, KBT-J0xx): inside the
  functions a card solve entry point reaches in its own module, flag
  host syncs in loop bodies (``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``int()/float()/bool()`` on a tensor,
  ``torch.cuda.synchronize()``), Python truth tests on tensors, and bare
  ``print``; plus raw ``float32/float64`` dtype literals in
  ``plugins/``/``api/`` that bypass the ``api/numerics.py``
  comparison-dtype policy.
- **A3 registry consistency** (:mod:`.registry_consistency`, KBT-R0xx):
  every fault point fired exists in ``faults.POINTS`` and vice versa;
  every ``metrics.<name>`` touched is declared in
  ``metrics/__init__.py``; every ``KBT_*`` variable read appears in the
  package runbook's environment table (``kube_batch_tpu_torch/RUNBOOK.md``),
  and no documented knob is dead.
- **A4 snapshot escape** (:mod:`.snapshot_escape`, KBT-S0xx):
  plugins/actions that mutate objects reached from a session snapshot
  without going through the Statement / session APIs.
- **A5 lock order** (:mod:`.lock_order`, KBT-D0xx): the interprocedural
  lock-acquisition graph over the threaded layers: ABBA cycles and
  blocking calls (fsync, sleep, subprocess, device sync) inside
  lock-held regions.
- **A6 protocol lifecycles** (:mod:`.protocol`, KBT-C0xx): the declared
  lifecycle state machines (Session, Statement, journal append ->
  dispatch -> confirm, circuit-breaker transitions, StreamState
  harvest -> patch -> invalidate -> re-harvest) and listener pairing.
- **A7 concurrency sanitizer** (:mod:`.threads`, KBT-T0xx, its own CLI
  ``python -m kube_batch_tpu_torch.analysis.threads``): thread/pool
  lifecycles, shared-state escape across inferred thread roots, and
  split read-modify-write; its runtime sibling is
  :class:`~kube_batch_tpu_torch.utils.race.RaceWitness`.

Two siblings touch torch and a device: the **warm-cycle audit**
(:mod:`kube_batch_tpu_torch.analysis.trace`, KBT-P0xx, CLI ``python -m
kube_batch_tpu_torch.analysis.trace``) runs the solver rungs and checks
host syncs in a warm cycle, float64 leaks and ``SolveState`` drift
across rungs; the **interleaving model checker**
(:mod:`kube_batch_tpu_torch.analysis.interleave`, KBT-I0xx, CLI
``python -m kube_batch_tpu_torch.analysis.interleave``) drives fixed
streaming/takeover scenarios through every distinguishable thread
schedule. Both share this package's Finding/CODES/baseline machinery;
this module stays stdlib-only.

Findings print as ``file:line: CODE message``. Intentional deviations
live in committed suppression files beside this module
(``lint-baseline.toml``, ``trace-baseline.toml``,
``interleave-baseline.toml``); every entry requires a ``reason``: a
reason-less entry is itself a finding (KBT-B001), and under
``--strict`` so is a stale one (KBT-B002). CLI: ``python -m
kube_batch_tpu_torch.analysis``.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Optional

__all__ = [
    "Finding",
    "SourceFile",
    "Suppression",
    "Baseline",
    "CODES",
    "PACKAGE",
    "load_tree",
    "load_baseline",
    "apply_baseline",
    "render_baseline",
    "baseline_path",
    "run_suite",
    "repo_root",
]

PACKAGE = "kube_batch_tpu_torch"


@dataclass(frozen=True)
class Finding:
    """One analyzer hit: ``{path}:{line}: {code} {message}``.

    ``symbol`` is the stable suppression key (qualified name + detail)
    — baseline entries match on it instead of line numbers, which
    drift."""

    path: str  # repo-relative, forward slashes
    line: int
    code: str
    message: str
    symbol: str = ""

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"


@dataclass
class SourceFile:
    path: str  # repo-relative, forward slashes
    source: str
    tree: ast.AST

    @property
    def lines(self) -> list[str]:
        return self.source.splitlines()


# code -> (one-line title, what it protects / how to fix) — the
# ``--explain`` text and the runbook table's source of truth.
CODES: dict[str, tuple[str, str]] = {
    "KBT-L001": (
        "guarded attribute touched without its lock",
        "The attribute is declared guarded (seed map or `#: guarded_by "
        "<lock>` annotation) but is read/written outside a lexical `with "
        "self.<lock>` block, in a method not marked lock-held (`_locked` "
        "suffix or @assume_locked); or module state declared guarded by a "
        "module lock is touched outside `with <lock>`. The resync workers, "
        "write pool, watch hub, HTTP handlers, federation shard threads "
        "and the kernel build all share these structures, and the runtime "
        "mutation detector only catches a race a test happens to "
        "interleave. Fix: take the lock, move the access inside an "
        "existing critical section, or mark the helper @assume_locked if "
        "every caller already holds it.",
    ),
    "KBT-L002": (
        "guarded_by annotation names no known lock",
        "A `#: guarded_by <lock>` annotation (or a seed-map entry) refers "
        "to an attribute that is never assigned a threading.Lock/RLock/"
        "Condition in this class or module. The guard would never be "
        "enforceable. Fix the annotation or add the lock.",
    ),
    "KBT-J001": (
        "host sync in a loop of a card solve path",
        "`.item()`, `.tolist()`, `.cpu()`, `.numpy()`, `int()/float()/"
        "bool()` on a tensor, or `torch.cuda.synchronize()` inside a loop "
        "body of a function that a card solve entry point reaches "
        "(FusedSolver.solve, ShardedBlockSolver.solve, class_step, "
        "ClassCompressedSolver, block_step, explain_batch). Each one waits "
        "for the card's queue to drain and copies to the host, once per "
        "iteration: the launch pipeline stalls for a full round trip every "
        "time. Fix: keep the value on the card (torch ops, one fetch after "
        "the loop), read it into pinned memory once per batch, or baseline "
        "the sync with the role it plays.",
    ),
    "KBT-J002": (
        "Python truth test on a tensor in a card solve path",
        "`if`/`while`/`assert`/a conditional expression on a tensor calls "
        "`Tensor.__bool__`, which copies the value to the host and waits "
        "for the card. Use `torch.where`, fold the test into the kernel, "
        "or test a host value you already hold.",
    ),
    "KBT-J003": (
        "bare print in a card solve path",
        "`print` on a card solve path formats tensors, which syncs with the "
        "card, and writes to stdout from the scheduling thread. Use the "
        "package logger outside the solve, or the obs spans.",
    ),
    "KBT-J004": (
        "raw dtype literal bypasses the comparison-dtype policy",
        "Comparison-feeding derived quantities (shares, fractions, "
        "scores) must be computed in api/numerics.comparison_dtype() — "
        "f32 when the kernels solve f32 — or the serial oracle disagrees "
        "with the card's kernels on sub-ulp ties. A hard-coded "
        "np.float64/np.float32 in plugins/ or api/ pins one side. "
        "Identity checks (`x is np.float64`) are exempt — they consult the "
        "policy, they don't bypass it. Fix: use comparison_dtype(); "
        "on-grid integral quantities that are exact in every dtype may "
        "keep a literal with a baseline reason.",
    ),
    "KBT-R001": (
        "fault point fired but not registered",
        "faults.should_fire()/arm(), or a call's `fault=` keyword, names a "
        "point missing from faults.POINTS — the drill spec parser would "
        "reject it, so the injection can never be armed and the degraded "
        "branch is dead code. Add the point to POINTS or fix the typo.",
    ),
    "KBT-R002": (
        "registered fault point never fired",
        "A faults.POINTS entry has no should_fire()/arm() call site and no "
        "call passes it as `fault=` — drills arming it silently inject "
        "nothing, which is exactly the false-confidence failure chaos "
        "tooling exists to prevent. Wire the point at the boundary it "
        "names or remove it.",
    ),
    "KBT-R003": (
        "metric not declared in metrics/__init__.py",
        "Code touches metrics.<name> but the metrics module defines no "
        "such collector/helper — an AttributeError on a path that only "
        "fires under failure (most metering sits in except blocks). "
        "Declare the metric (with HELP text, and add it to "
        "render_prometheus_text) or fix the name.",
    ),
    "KBT-R004": (
        "KBT_* env var read but not documented in the runbook",
        "An os.environ read of a KBT_* knob has no row in the package "
        "runbook's environment table (kube_batch_tpu_torch/RUNBOOK.md) — "
        "operators cannot discover it. Add the row (name, default, "
        "one-line semantics).",
    ),
    "KBT-R005": (
        "documented KBT_* env knob is dead",
        "The package runbook documents a KBT_* variable no code of this "
        "package reads — operators will set it and observe nothing. Remove "
        "the row, restore the read, or, for a knob this package takes as "
        "an argument, name it in the runbook's prose instead of its table.",
    ),
    "KBT-S001": (
        "snapshot object mutated outside Statement/session APIs",
        "A plugin/action assigns attributes on an object reached from "
        "the session snapshot (ssn.jobs/nodes/queues) directly. Session "
        "state must change through ssn.allocate/evict or a Statement so "
        "the operation log can undo it on discard and the event handlers "
        "(DRF/proportion shares) observe it; a silent direct write "
        "desyncs shares and survives gang rollback. Route through the "
        "session API, or baseline with the parity evidence if the "
        "mutation is a vetted bulk-replay equivalent.",
    ),
    "KBT-S002": (
        "snapshot object mutator called outside Statement/session APIs",
        "A plugin/action calls a mutating method (add_task, remove_task, "
        "update_task_status, ...) on a snapshot-derived job/node/task "
        "directly instead of through ssn.allocate/evict or a Statement. "
        "Same failure class as KBT-S001: no undo log, no events, shares "
        "desync.",
    ),
    "KBT-D001": (
        "lock-order cycle (ABBA) in the static acquisition graph",
        "Two locks are acquired in opposite orders on different code "
        "paths (A then B here, B then A elsewhere) in the threaded "
        "cache/store/workqueue/journal/watch-hub layers. Under load the "
        "two paths interleave and deadlock — the failover takeover path "
        "is exactly where both orders tend to meet. Fix: pick one global "
        "order (document it where the locks are declared) and re-nest the "
        "inner acquisition, or split the critical section so the second "
        "lock is taken after the first is released.",
    ),
    "KBT-D002": (
        "blocking call while holding a lock",
        "A lock-held region calls into a blocking API (journal fsync, "
        "time.sleep, subprocess, future .result(), a card sync such as "
        "torch.cuda.synchronize, network send/recv). Every other thread "
        "needing that lock — watch emitters, resync workers, the HTTP "
        "handlers, other federation shards — stalls for the full blocking "
        "latency, and a hung fsync or RPC turns into a scheduler-wide "
        "freeze. Fix: move the blocking work outside the critical section "
        "(snapshot under the lock, block after), or baseline with the "
        "ordering argument when the blocking is the point (e.g. WAL fsync "
        "ordered with seq assignment). `Condition.wait` on the held "
        "condition is exempt — it releases the lock while blocking.",
    ),
    "KBT-P001": (
        "host sync in a warm cycle on the card",
        "A warm scheduling cycle, run under torch.cuda.set_sync_debug_mode,"
        " made a synchronizing CUDA call (a D2H copy, .item(), a "
        "synchronize) at a package file:line that has no entry in the "
        "trace baseline; or a kernel launch (B1, B2, B3, from upload to "
        "fetch) synchronized at all. Each sync drains the card's queue and "
        "costs a round trip per call. Fix: keep the value on the card or "
        "fetch it once; a sync that is the point gets a trace-baseline "
        "entry naming its role.",
    ),
    "KBT-P002": (
        "float64 leaked into a solver rung's state",
        "A SolveState field that a rung (fused, sharded, class, or a plain "
        "version) returns from float32 inputs is float64: a silent upcast "
        "(a Python float promoted, an np.float64 constant, a dtype-less "
        "torch.tensor) that doubles the state's bytes and splits numerics "
        "from the float32 kernels the parity suites pin. KBT-J004 only "
        "sees literal spellings; this check sees the returned truth. The "
        "scans' deliberate float64 (VectorScan) is exempt. Fix: pin the "
        "constant or the cast to the input's dtype.",
    ),
    "KBT-P003": (
        "large host constant re-uploaded every warm cycle",
        "Kept for the code's meaning; nothing fires it yet. Torch captures "
        "no constants into a traced program; the nearest hazard is "
        "unchanged statics uploaded again on every warm cycle, which "
        "belongs to the device-resident tensor arena (not yet ported) and "
        "will be checked with it. Fix, once it fires: keep the table "
        "resident and upload only changed rows.",
    ),
    "KBT-P004": (
        "the arena's row update is not in place",
        "Kept for the code's meaning; nothing fires it yet. The "
        "device-resident tensor arena (not yet ported) updates changed "
        "rows with index_copy_ into its resident buffers; an update that "
        "allocates a new buffer instead doubles device memory at the "
        "biggest buffer. It will be checked with the arena.",
    ),
    "KBT-P005": (
        "cross-rung SolveState signature drift",
        "The solver rungs (fused B1, sharded B2 at some mesh size, class B3 "
        "expanded back to node space, and their plain versions) disagree "
        "on a SolveState field's name, shape or dtype. The degradation "
        "ladder hands state between rungs mid-session — a drifted field "
        "means a resume after a failover reinterprets the state, and the "
        "rungs' numerics diverge. Fix: restore the drifted field's shape "
        "or dtype in the offending rung.",
    ),
    "KBT-C001": (
        "session/Statement left open on an exit path",
        "A session (open_session/open_micro_session) or Statement "
        "(statement_factory/ssn.statement()/Statement(ssn)) created in "
        "this function can reach a function exit, a loop-iteration end, "
        "or a rebinding without close_session() / commit() / discard() "
        "on that path. An open statement's operations neither replay to "
        "the cache nor roll back — the gang-atomicity hole the "
        "Statement exists to close; a dropped session loses the cycle's "
        "status write-back. The check is path-structural: a branch your "
        "invariants make impossible still needs the close, because the "
        "next refactor makes it possible. Escaping the resource "
        "(return/alias/store on an object) transfers ownership and "
        "ends the check; passing it as a call argument does not.",
    ),
    "KBT-C002": (
        "protocol operation outside its owning scope",
        "Either a raw cache dispatch (cache.bind/bind_many/evict) "
        "outside the Statement/session layer (framework/session.py, "
        "framework/statement.py, cache/cache.py) — the write skips the "
        "operation log and the share event handlers — or a circuit-"
        "breaker _transition() outside faults/ladder.py / outside the "
        "declared closed/open/half_open alphabet. Route the bind "
        "through ssn/Statement (or baseline with parity evidence for a "
        "vetted bulk-replay), and keep rung transitions inside the "
        "ladder where the lock/backoff discipline lives.",
    ),
    "KBT-C003": (
        "journal append/dispatch/confirm pairing broken",
        "A write-intent append (append_intents/_journal_intents) can "
        "exit its function on a path with no dispatch (_submit_write/"
        "_do_*) or confirm — an orphan intent every takeover will "
        "re-litigate — or a module appends but never confirms/"
        "dispatches (or confirms what it never appends, outside "
        "recovery/ where takeover confirms a dead leader's intents). "
        "Dispatch or confirm on every path, or return the seqs to the "
        "caller who does.",
    ),
    "KBT-C004": (
        "resident-table read after invalidate without re-harvest",
        "On the same path, a StreamState-like object is invalidate()d "
        "and then its resident node table is read (.nodes / "
        "apply_node_patches) with no adopt_full_cycle re-harvest in "
        "between — a micro-cycle solving against capacity that no "
        "longer exists. Degrade to the full cycle first (it re-adopts "
        "the table), or reorder the read before the invalidation.",
    ),
    "KBT-C005": (
        "listener registered without a remove on the teardown path",
        "add_store_listener()/attach() has no matching remove reachable "
        "from the registration: neither a finally whose try starts at "
        "or immediately after the registration, nor a paired teardown "
        "method (detach/stop/close/...) on the class. The leaked "
        "listener keeps firing into a stopped loop — every store event "
        "pays for a consumer that no longer exists, and a re-started "
        "loop double-registers. Even one statement between the "
        "registration and the protecting try is one exception away "
        "from the leak.",
    ),
    "KBT-T001": (
        "thread/pool without a reachable bounded shutdown path",
        "A threading.Thread or executor pool is constructed with no "
        "reachable bounded join(timeout=...)/shutdown() on its binding "
        "and no daemon=True annotation — or is only ever joined without "
        "a timeout. A wedged worker then outlives its owner and hangs "
        "process teardown (the watch pump, lease renewer, shard threads "
        "and scrape loops all shut down under deadline budgets). Fix: add "
        "a stop()+join(timeout=...) path (idempotent on double-stop), use "
        "`with ThreadPoolExecutor(...)`, or mark daemon=True where a "
        "supervisor polls liveness. Ownership transfers (returning the "
        "thread, passing it to a call) end the obligation at the "
        "construction site.",
    ),
    "KBT-T002": (
        "unguarded field escapes to multiple thread roots",
        "A self.<field> with no declared guard (KBT-L seed map or "
        "`#: guarded_by` annotation) is written in one inferred thread "
        "root's call closure and touched in another's — or written from "
        "a multi-instance root (a pool callable, a thread started in a "
        "loop). Thread roots are inferred from Thread(target=...)/"
        "submit(...) sites plus the seed-root map for dynamic dispatch "
        "(HTTP handler threads, write-pool callbacks); everything else "
        "is the owning `(callers)` root. Unordered cross-root access is "
        "a data race: torn reads, lost updates, stale decisions. Fix: "
        "annotate `#: guarded_by <lock>` on the field's __init__ line "
        "(KBT-L then enforces every touch) and take the lock, or "
        "confine the field to one thread and baseline with the "
        "confinement argument.",
    ),
    "KBT-T003": (
        "read-modify-write split across two lock regions",
        "A guarded field is read under its lock in one `with` region "
        "and written back under a *different* region of the same lock "
        "in the same function, with no re-read before the write. Both "
        "accesses hold the lock, so KBT-L is satisfied — but the "
        "modify step between the regions runs unlocked, and another "
        "thread's update in the window is silently overwritten "
        "(check-then-act on stale state). Fix: merge the two regions "
        "into one critical section, or re-read/validate the field "
        "under the writing lock before storing.",
    ),
    "KBT-I001": (
        "interleaving counterexample",
        "The interleaving model checker "
        "(kube_batch_tpu_torch.analysis.interleave) found a thread "
        "schedule under which a scenario invariant breaks: an arrival lost "
        "or never bound, a bind landing twice, the journal left with "
        "orphan intents, a lock-order reversal, or placements diverging "
        "from what every other schedule of the same scenario produced. "
        "The finding names the trace id — replay it step by step with "
        "`python -m kube_batch_tpu_torch.analysis.interleave --replay "
        "<scenario>:<digits>`, fix the race, and re-explore.",
    ),
    "KBT-I002": (
        "interleaving model error",
        "The scenario model itself is unsound, not the code under test: "
        "a step acquired a lock outside its declared footprint (so the "
        "partial-order pruning could have skipped a distinguishable "
        "schedule), or a scenario build precondition failed. Fix the "
        "step's declared footprint or the scenario's build before "
        "trusting any clean result from that scenario.",
    ),
    "KBT-B001": (
        "baseline entry missing a reason",
        "Every entry of the package's baselines "
        "(kube_batch_tpu_torch/analysis/*-baseline.toml) must say WHY the "
        "finding is intentionally kept — a reason-less suppression is "
        "indistinguishable from a silent skip and fails the gate.",
    ),
    "KBT-B002": (
        "stale baseline entry",
        "A suppression matches no current finding — the code it excused "
        "changed. Delete the entry (strict mode fails on it so the "
        "baseline can only shrink, never rot).",
    ),
}


def repo_root() -> str:
    """The tree to analyze: cwd when it holds the package (the normal
    checkout / image layout), else the checkout containing this file."""
    cwd = os.getcwd()
    if os.path.isdir(os.path.join(cwd, PACKAGE)):
        return cwd
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def baseline_path(repo: str, name: str = "lint") -> str:
    """The package's committed ``<name>-baseline.toml`` in ``repo``."""
    return os.path.join(repo, PACKAGE, "analysis", f"{name}-baseline.toml")


def load_tree(repo: str, package: str = PACKAGE) -> list[SourceFile]:
    """Parse every package .py (tests and this meta-layer excluded —
    the generic lint of the repo covers both)."""
    out: list[SourceFile] = []
    pkg_dir = os.path.join(repo, package)
    for root, dirs, files in os.walk(pkg_dir):
        dirs[:] = sorted(d for d in dirs if d not in ("__pycache__", "analysis"))
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            abspath = os.path.join(root, f)
            rel = os.path.relpath(abspath, repo).replace(os.sep, "/")
            with open(abspath, encoding="utf-8") as fh:
                source = fh.read()
            try:
                tree = ast.parse(source, rel)
            except SyntaxError:
                continue  # compileall's problem, not ours
            out.append(SourceFile(rel, source, tree))
    return out


# -- baselines (analysis/*-baseline.toml) -------------------------------------
#
# Parsed with a deliberately tiny TOML-subset reader, kept from the JAX
# package so both read one dialect. Grammar accepted: comments,
# [[suppress]] table headers, and `key = "string"` pairs. Anything else
# is a parse error (loud, so the file cannot quietly rot into a dialect
# tomllib would later reject).

_HEADER_RE = re.compile(r"^\[\[suppress\]\]\s*$")
_PAIR_RE = re.compile(r'^(?P<key>[A-Za-z_][A-Za-z0-9_]*)\s*=\s*"(?P<val>(?:[^"\\]|\\.)*)"\s*$')
_KEYS = {"code", "path", "symbol", "reason", "max_count"}


@dataclass
class Suppression:
    code: str = ""
    path: str = ""
    symbol: str = ""  # empty = any symbol at (code, path)
    reason: str = ""
    # the most syncs one trace audit may count at the sites a KBT-P001
    # entry matches, summed (0: no bound; the trace audit requires one)
    max_count: int = 0
    line: int = 0  # line of the [[suppress]] header in the baseline
    hits: int = 0  # findings matched this run
    # the entry's verbatim lines (header + pairs + trailing comments), so
    # --prune can rewrite the file preserving formatting and reasons
    raw: list[str] = field(default_factory=list)

    def matches(self, f: Finding) -> bool:
        return (
            self.code == f.code
            and self.path == f.path
            and (not self.symbol or self.symbol == f.symbol)
        )


@dataclass
class Baseline:
    path: str
    suppressions: list[Suppression] = field(default_factory=list)
    errors: list[Finding] = field(default_factory=list)  # KBT-B001 + parse errors
    preamble: list[str] = field(default_factory=list)  # verbatim lines before the first entry


def _strip_comment(line: str) -> str:
    out = []
    in_str = False
    i = 0
    while i < len(line):
        c = line[i]
        if c == '"' and (i == 0 or line[i - 1] != "\\"):
            in_str = not in_str
        if c == "#" and not in_str:
            break
        out.append(c)
        i += 1
    return "".join(out).strip()


def load_baseline(path: str, repo: str) -> Baseline:
    rel = os.path.relpath(path, repo).replace(os.sep, "/")
    bl = Baseline(path=rel)
    if not os.path.exists(path):
        return bl
    cur: Optional[Suppression] = None
    with open(path, encoding="utf-8") as fh:
        for lineno, raw in enumerate(fh, 1):
            line = _strip_comment(raw)
            if not line:
                if cur is None:
                    bl.preamble.append(raw.rstrip("\n"))
                continue
            if _HEADER_RE.match(line):
                cur = Suppression(line=lineno)
                cur.raw.append(raw.rstrip("\n"))
                bl.suppressions.append(cur)
                continue
            m = _PAIR_RE.match(line)
            if m and cur is not None and m.group("key") in _KEYS:
                val = m.group("val").replace('\\"', '"').replace("\\\\", "\\")
                if m.group("key") == "max_count":
                    if not val.isdigit():
                        bl.errors.append(
                            Finding(
                                rel, lineno, "KBT-B001",
                                f"max_count {val!r} is not a count (a string of digits)",
                                symbol=f"parse:{lineno}",
                            )
                        )
                        continue
                    val = int(val)
                setattr(cur, m.group("key"), val)
                cur.raw.append(raw.rstrip("\n"))
                continue
            bl.errors.append(
                Finding(
                    rel, lineno, "KBT-B001",
                    f"unparseable baseline line {raw.strip()!r} (grammar: "
                    '[[suppress]] tables of key = "value" pairs)',
                    symbol=f"parse:{lineno}",
                )
            )
    for s in bl.suppressions:
        if not s.reason.strip():
            bl.errors.append(
                Finding(
                    rel, s.line, "KBT-B001",
                    f"suppression of {s.code or '<no code>'} at "
                    f"{s.path or '<no path>'} has no reason — every entry "
                    "must say why the finding is intentionally kept",
                    symbol=f"{s.code}:{s.path}:{s.symbol}",
                )
            )
        if not s.code or not s.path:
            bl.errors.append(
                Finding(
                    rel, s.line, "KBT-B001",
                    "suppression must name both `code` and `path`",
                    symbol=f"incomplete:{s.line}",
                )
            )
    return bl


def apply_baseline(
    findings: list[Finding], bl: Baseline
) -> tuple[list[Finding], list[Finding], list[Finding]]:
    """-> (kept, suppressed, stale) where stale are KBT-B002 findings
    for suppressions that matched nothing."""
    kept: list[Finding] = []
    suppressed: list[Finding] = []
    for f in findings:
        hit = None
        for s in bl.suppressions:
            if s.matches(f):
                hit = s
                break
        if hit is not None:
            hit.hits += 1
            suppressed.append(f)
        else:
            kept.append(f)
    stale = [
        Finding(
            bl.path, s.line, "KBT-B002",
            f"suppression of {s.code} at {s.path}"
            + (f" ({s.symbol})" if s.symbol else "")
            + " matches no current finding — delete it",
            symbol=f"{s.code}:{s.path}:{s.symbol}",
        )
        for s in bl.suppressions
        if s.hits == 0 and s.code and s.path
    ]
    return kept, suppressed, stale


def render_baseline(bl: Baseline, keep: list[Suppression]) -> str:
    """The baseline file's text with only ``keep`` entries, preserving
    the preamble comment block and each entry's verbatim lines/order
    (the --prune rewrite)."""
    parts: list[str] = []
    preamble = list(bl.preamble)
    while preamble and not preamble[-1].strip():
        preamble.pop()
    if preamble:
        parts.append("\n".join(preamble))
    for s in keep:
        parts.append("\n".join(s.raw))
    return "\n\n".join(parts) + "\n" if parts else ""


# -- suite -------------------------------------------------------------------


def run_suite(
    repo: Optional[str] = None,
    files: Optional[list[SourceFile]] = None,
    runbook: Optional[str] = None,
) -> list[Finding]:
    """Run every AST analyzer over the tree; findings sorted by
    (path, line, code). Baseline application is the caller's business
    (the CLI goes through it)."""
    from kube_batch_tpu_torch.analysis import (
        lock_discipline,
        lock_order,
        protocol,
        registry_consistency,
        snapshot_escape,
        threads,
        torch_hazards,
    )

    repo = repo or repo_root()
    if files is None:
        files = load_tree(repo)
    findings: list[Finding] = []
    analyzers: list[Callable[..., list[Finding]]] = [
        lock_discipline.analyze,
        lock_order.analyze,
        protocol.analyze,
        torch_hazards.analyze,
        snapshot_escape.analyze,
        threads.analyze,
    ]
    for analyze in analyzers:
        findings.extend(analyze(files))
    findings.extend(registry_consistency.analyze(files, repo=repo, runbook=runbook))
    findings.sort(key=lambda f: (f.path, f.line, f.code, f.symbol))
    return findings
