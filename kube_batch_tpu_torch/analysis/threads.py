"""A7 — concurrency sanitizer: thread lifecycle & shared-state escape
(KBT-T001/T002/T003, its own CLI:
``python -m kube_batch_tpu_torch.analysis.threads``).

PRs 15-18 multiplied the live threads per process — the backend watch
pump, the shard-lease renewer/prober, the backpressure tick path, the
fleet scrape loop, the kb-write pool, the pipeline dispatch fence — and
the existing analyzers only prove *lock ordering* (KBT-D) and declared
*lock discipline* (KBT-L). This module closes the remaining gap three
ways, all stdlib-AST so the bare container runs it:

- **KBT-T001 thread lifecycle**: every ``threading.Thread`` /
  ``ThreadPoolExecutor`` construction must have a reachable *bounded*
  ``join(timeout=...)``/``shutdown()`` path or an explicit
  ``daemon=True`` annotation — tracked interprocedurally across the
  binding (self attribute: class-wide; local: function-wide; module
  global: module-wide; collection appends and loop/alias joins
  resolve), the way KBT-C tracks Statement lifecycles. A ``with``
  executor and an ownership transfer (returning the thread, passing it
  to a call) end the obligation.
- **KBT-T002 shared-state escape**: two-phase. Phase one infers each
  class's *thread roots* — methods reached from ``Thread(target=...)``
  / ``*.submit(...)`` call sites (plus the seed-root map below for
  dynamic dispatch the AST cannot see, e.g. the admission gate's HTTP
  handler threads), plus a synthetic ``(callers)`` root for everything
  invoked from the owning thread. Phase two walks each root's
  self-call closure charging ``self.<field>`` reads/writes (subscript
  stores and mutating container calls count as writes), and flags any
  field written from ≥2 roots — or written in one root and read in
  another, or written from a *multi* root (a pool callable / a thread
  started in a loop) — that carries no guard under the KBT-L
  declaration surface (the seed map or ``#: guarded_by``). Declared
  fields are KBT-L's domain and stay silent here: the two analyzers
  share one declaration surface.
- **KBT-T003 atomicity**: a guarded field read under its lock in one
  ``with`` region and written back under a *different* region of the
  same lock in the same function, with no re-read before the write —
  the split read-modify-write another thread can interleave.

Findings triage like every other family: fix, or reason-baseline in
``kube_batch_tpu_torch/analysis/lint-baseline.toml`` (this CLI applies/prunes only the KBT-T
slice of the shared file). The seeded fixtures at the bottom are the
self-check: the CLI fails unless every code fires on its positive
fixture and stays silent on the negative twin, and unless the runtime
:class:`~kube_batch_tpu_torch.utils.race.RaceWitness` drills pass
(ordered-by-lock clean, ordered-by-join clean, true race caught with a
deterministic trace id). ``--witness-drive`` additionally drives the
witness over the live streaming-federation bind path (the absorb-mode
``StreamTrigger`` under concurrent peer churn + drain).
"""

from __future__ import annotations

import ast
from typing import Optional

from kube_batch_tpu_torch.analysis import Finding, SourceFile
from kube_batch_tpu_torch.analysis.lock_discipline import (
    SEED_GUARDED,
    _annotated_guards,
    _class_locks,
    _is_assume_locked,
)

__all__ = [
    "SEED_ROOTS",
    "analyze",
    "selfcheck",
    "witness_selfcheck",
    "witness_drive",
    "main",
]

_THREAD_CTORS = {"Thread"}
_POOL_CTORS = {"ThreadPoolExecutor", "ProcessPoolExecutor"}
_CTORS = _THREAD_CTORS | _POOL_CTORS

# Method names whose call mutates the receiver in place — a
# ``self.F.append(...)`` is a write to F for escape purposes even
# though the AST only shows a Load of F.
_MUTATORS = {
    "append", "add", "update", "pop", "popitem", "clear", "remove",
    "discard", "extend", "insert", "setdefault", "appendleft",
    "popleft", "difference_update", "intersection_update",
    "symmetric_difference_update",
}

# Pool-submission entry points that make their callable argument a
# thread root (the kb-write pool wrappers on top of plain submit).
_SUBMITTERS = {"submit", "_submit_write", "submit_dispatch"}

# Field types that are themselves synchronization/thread-safe objects:
# calls on them are their own discipline, not shared-state escape.
_ATOMIC_TYPES = {
    "Lock", "RLock", "Condition", "Event", "Semaphore",
    "BoundedSemaphore", "Barrier", "Queue", "SimpleQueue", "LifoQueue",
    "PriorityQueue", "deque", "local", "ThreadPoolExecutor",
    "RateLimitingQueue",
}

# (path, class) -> {root name: (entry methods, multi)} for thread roots
# the AST cannot infer because the dispatch is dynamic: the admission
# gate's methods run on the lease server's HTTP handler threads (many
# at once), and the dispatch fence's record_join callback runs on
# kb-write pool threads while arm/wait run on the cycle thread.
SEED_ROOTS: dict[tuple[str, str], dict[str, tuple[tuple[str, ...], bool]]] = {
    ("kube_batch_tpu_torch/admission.py", "AdmissionGate"): {
        "http-handlers": (("decide", "note_done"), True),
    },
    ("kube_batch_tpu_torch/pipeline.py", "DispatchFence"): {
        "kb-write-pool": (("record_join",), True),
        "cycle": (("arm", "wait", "reset", "degrade"), False),
    },
    ("kube_batch_tpu_torch/obs/fleet.py", "FleetAggregator"): {
        # the scrape threads' target is a lambda over scrape() (the JAX
        # map names a `_scrape_one` that neither package has)
        "kb-fleet-scrape": (("scrape",), True),
    },
}


def _last_name(fn: ast.expr) -> str:
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


def _is_ctor(call: ast.Call) -> Optional[str]:
    """'thread' | 'pool' | None for a Call node."""
    name = _last_name(call.func)
    if name in _THREAD_CTORS:
        return "thread"
    if name in _POOL_CTORS:
        return "pool"
    return None


def _noqa(sf: SourceFile, lineno: int) -> bool:
    lines = sf.lines
    return 0 < lineno <= len(lines) and "noqa" in lines[lineno - 1]


# -- shared context plumbing --------------------------------------------------


def _contexts(tree: ast.AST):
    """id(node) -> (class name | None, function node | None,
    frozenset of names the function declared ``global``)."""
    ctx_of: dict[int, tuple] = {}

    def assign(node, ctx):
        ctx_of[id(node)] = ctx
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                assign(child, (child.name, ctx[1], ctx[2]))
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                gl = frozenset(
                    n
                    for s in ast.walk(child)
                    if isinstance(s, ast.Global)
                    for n in s.names
                )
                assign(child, (ctx[0], child, gl))
            else:
                assign(child, ctx)

    assign(tree, (None, None, frozenset()))
    return ctx_of


def _parents(tree: ast.AST) -> dict[int, ast.AST]:
    out: dict[int, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            out[id(child)] = node
    return out


# -- KBT-T001: thread lifecycle ----------------------------------------------
#
# Binding keys: ("self", cls, attr) | ("local", id(fn), name) |
# ("global", name). Evidence kinds: "daemon", "join_b" (bounded),
# "join_u" (no timeout), "shutdown".


def _unwrap_iter(e: ast.expr) -> ast.expr:
    """list(xs)/sorted(xs)/tuple(xs)/reversed(xs) -> xs."""
    if (
        isinstance(e, ast.Call)
        and isinstance(e.func, ast.Name)
        and e.func.id in ("list", "sorted", "tuple", "reversed")
        and e.args
    ):
        return e.args[0]
    return e


def _expr_key(e: ast.expr, cls, fn, gl) -> Optional[tuple]:
    if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name):
        if e.value.id == "self" and cls is not None:
            return ("self", cls, e.attr)
        return None
    if isinstance(e, ast.Name):
        if fn is None or e.id in gl:
            return ("global", e.id)
        return ("local", id(fn), e.id)
    return None


def _aliases(fn: Optional[ast.AST], tree: ast.AST, cls, gl) -> dict:
    """name -> binding key, from ``x = self.attr`` and ``for t in xs``
    (including comprehension generators) within one function scope."""
    scope = fn if fn is not None else tree
    out: dict[str, tuple] = {}
    for node in ast.walk(scope):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Name):
                key = _expr_key(node.value, cls, fn, gl)
                if key is not None and key != ("local", id(fn), t.id):
                    out[t.id] = key
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            if isinstance(node.target, ast.Name):
                key = _expr_key(_unwrap_iter(node.iter), cls, fn, gl)
                if key is not None:
                    out[node.target.id] = key
        elif isinstance(node, ast.comprehension):
            if isinstance(node.target, ast.Name):
                key = _expr_key(_unwrap_iter(node.iter), cls, fn, gl)
                if key is not None:
                    out[node.target.id] = key
    return out


def _resolve(e: ast.expr, cls, fn, gl, alias: dict) -> Optional[tuple]:
    key = _expr_key(e, cls, fn, gl)
    for _ in range(2):  # x = self._threads; for t in x: ...
        if key is not None and key[0] == "local" and key[2] in alias:
            nxt = alias[key[2]]
            if nxt == key:
                break
            key = nxt
        else:
            break
    return key


def _has_daemon_kwarg(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "daemon":
            return isinstance(kw.value, ast.Constant) and bool(kw.value.value)
    return False


def _t001(sf: SourceFile, ctx_of, parents, findings: list[Finding]) -> None:
    alias_cache: dict[int, dict] = {}

    def alias_for(fn, cls, gl) -> dict:
        k = id(fn) if fn is not None else 0
        if k not in alias_cache:
            alias_cache[k] = _aliases(fn, sf.tree, cls, gl)
        return alias_cache[k]

    # evidence maps
    self_ev: dict[tuple, set] = {}
    local_ev: dict[tuple, set] = {}
    global_ev: dict[str, set] = {}

    def record(key: Optional[tuple], kind: str) -> None:
        if key is None:
            return
        if key[0] == "self":
            self_ev.setdefault((key[1], key[2]), set()).add(kind)
        elif key[0] == "local":
            local_ev.setdefault((key[1], key[2]), set()).add(kind)
        else:
            global_ev.setdefault(key[1], set()).add(kind)

    for node in ast.walk(sf.tree):
        cls, fn, gl = ctx_of.get(id(node), (None, None, frozenset()))
        alias = alias_for(fn, cls, gl)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr == "join":
                key = _resolve(node.func.value, cls, fn, gl, alias)
                bounded = bool(node.args or node.keywords)
                record(key, "join_b" if bounded else "join_u")
            elif node.func.attr == "shutdown":
                record(_resolve(node.func.value, cls, fn, gl, alias), "shutdown")
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Attribute) and t.attr == "daemon":
                    if (
                        isinstance(node.value, ast.Constant)
                        and bool(node.value.value)
                    ):
                        record(_resolve(t.value, cls, fn, gl, alias), "daemon")

    # ctor sites
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        kind = _is_ctor(node)
        if kind is None:
            continue
        cls, fn, gl = ctx_of.get(id(node), (None, None, frozenset()))
        alias = alias_for(fn, cls, gl)
        if _noqa(sf, node.lineno):
            continue
        if kind == "thread" and _has_daemon_kwarg(node):
            continue
        parent = parents.get(id(node))
        key: Optional[tuple] = None
        anonymous_start = False
        if isinstance(parent, ast.withitem):
            continue  # `with ThreadPoolExecutor() as x:` shuts down
        if isinstance(parent, ast.Assign):
            key = _resolve(parent.targets[0], cls, fn, gl, alias)
        elif (
            isinstance(parent, ast.Call)
            and isinstance(parent.func, ast.Attribute)
            and parent.func.attr == "append"
        ):
            key = _resolve(parent.func.value, cls, fn, gl, alias)
        elif isinstance(parent, ast.Attribute) and parent.attr == "start":
            anonymous_start = True
        elif isinstance(parent, (ast.Return, ast.Call, ast.Dict, ast.Tuple,
                                 ast.List, ast.Set)):
            continue  # ownership transferred to the caller / a collection
        elif isinstance(parent, ast.Expr):
            pass  # bare discarded ctor: key stays None -> finding
        else:
            continue  # unrecognized binding shape: stay quiet

        if key is not None:
            if key[0] == "self":
                ev = self_ev.get((key[1], key[2]), set())
                desc = f"self.{key[2]}"
                sym = f"{key[1]}.{key[2]}"
            elif key[0] == "local":
                ev = local_ev.get((key[1], key[2]), set())
                desc = f"local {key[2]!r}"
                sym = f"{cls + '.' if cls else ''}{fn.name if fn else '<module>'}.{key[2]}"
            else:
                ev = global_ev.get(key[1], set())
                desc = f"module global {key[1]!r}"
                sym = f"<module>.{key[1]}"
        else:
            ev = set()
            desc = "an anonymous handle" if anonymous_start else "no handle"
            scope = f"{cls + '.' if cls else ''}{fn.name if fn else '<module>'}"
            sym = f"{scope}.<anonymous>"

        what = "Thread" if kind == "thread" else "executor pool"
        if "daemon" in ev or "join_b" in ev or "shutdown" in ev:
            continue
        if "join_u" in ev:
            findings.append(
                Finding(
                    sf.path, node.lineno, "KBT-T001",
                    f"{what} bound to {desc} is only ever joined without a "
                    "timeout — a wedged worker hangs shutdown forever; pass "
                    "join(timeout=...) and escalate on leak",
                    symbol=sym,
                )
            )
        else:
            findings.append(
                Finding(
                    sf.path, node.lineno, "KBT-T001",
                    f"{what} bound to {desc} has no reachable bounded "
                    "join/shutdown path and no daemon annotation — the "
                    "worker outlives its owner and hangs process teardown "
                    "(add stop()+join(timeout=...)/shutdown(), or mark "
                    "daemon=True where a supervisor polls it)",
                    symbol=sym,
                )
            )


# -- KBT-T002: shared-state escape -------------------------------------------


def _methods_of(cls: ast.ClassDef) -> dict[str, ast.AST]:
    return {
        m.name: m
        for m in cls.body
        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
    }


def _atomic_fields(cls: ast.ClassDef) -> set[str]:
    out: set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            if _last_name(node.value.func) in _ATOMIC_TYPES:
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        out.add(t.attr)
    return out


def _field_accesses(fn_node: ast.AST, skip_nested: bool = True):
    """[(field, 'r'|'w', lineno, attr node)] for every ``self.<F>``
    touch in one function body. Subscript stores/deletes and mutating
    container calls on ``self.F`` count as writes; nested function
    bodies are skipped (they run on whichever thread invokes the
    callback, so they are charged as their own root or not at all)."""
    consumed: set[int] = set()
    out = []

    def is_self_attr(e) -> bool:
        return (
            isinstance(e, ast.Attribute)
            and isinstance(e.value, ast.Name)
            and e.value.id == "self"
        )

    def walk(node, top: bool) -> None:
        if not top and skip_nested and isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            return
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            recv = node.func.value
            if node.func.attr in _MUTATORS and is_self_attr(recv):
                out.append((recv.attr, "w", recv.lineno, recv))
                consumed.add(id(recv))
        elif isinstance(node, (ast.Subscript,)) and isinstance(
            node.ctx, (ast.Store, ast.Del)
        ):
            if is_self_attr(node.value):
                out.append((node.value.attr, "w", node.value.lineno, node.value))
                consumed.add(id(node.value))
        elif isinstance(node, ast.AugAssign) and is_self_attr(node.target):
            out.append((node.target.attr, "w", node.target.lineno, node.target))
            consumed.add(id(node.target))
        elif isinstance(node, ast.Attribute) and is_self_attr(node):
            if id(node) not in consumed:
                kind = "r" if isinstance(node.ctx, ast.Load) else "w"
                out.append((node.attr, kind, node.lineno, node))
                consumed.add(id(node))
        for child in ast.iter_child_nodes(node):
            walk(child, False)

    walk(fn_node, True)
    # a Store target's inner Attribute is visited before we know the
    # ctx on some shapes; dedupe identical (node) entries keeping 'w'
    best: dict[int, tuple] = {}
    for field, kind, line, node in out:
        cur = best.get(id(node))
        if cur is None or (cur[1] == "r" and kind == "w"):
            best[id(node)] = (field, kind, line, node)
    return sorted(best.values(), key=lambda a: (a[2], a[0]))


def _self_calls(fn_node: ast.AST, methods: dict) -> set[str]:
    out: set[str] = set()

    def walk(node, top: bool) -> None:
        if not top and isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            return
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            f = node.func
            if (
                isinstance(f.value, ast.Name)
                and f.value.id == "self"
                and f.attr in methods
            ):
                out.add(f.attr)
        for child in ast.iter_child_nodes(node):
            walk(child, False)

    walk(fn_node, True)
    return out


def _infer_roots(sf: SourceFile, cls: ast.ClassDef, methods: dict):
    """root name -> (entries, multi). An entry is a method name or a
    nested FunctionDef node (a closure passed as Thread target)."""
    roots: dict[str, tuple[list, bool]] = {}

    def add(name: str, entry, multi: bool) -> None:
        entries, m = roots.get(name, ([], False))
        if entry not in entries:
            entries.append(entry)
        roots[name] = (entries, m or multi)

    for mname, mnode in methods.items():
        nested = {
            n.name: n
            for n in ast.walk(mnode)
            if isinstance(n, ast.FunctionDef) and n is not mnode
        }
        loop_depth_of = {}

        def tag(node, depth, loop_depth_of=loop_depth_of):
            loop_depth_of[id(node)] = depth
            for child in ast.iter_child_nodes(node):
                tag(
                    child,
                    depth
                    + int(isinstance(node, (ast.For, ast.While, ast.AsyncFor))),
                )

        tag(mnode, 0)
        for node in ast.walk(mnode):
            if not isinstance(node, ast.Call):
                continue
            in_loop = loop_depth_of.get(id(node), 0) > 0
            if _is_ctor(node) == "thread":
                for kw in node.keywords:
                    if kw.arg != "target":
                        continue
                    v = kw.value
                    if (
                        isinstance(v, ast.Attribute)
                        and isinstance(v.value, ast.Name)
                        and v.value.id == "self"
                        and v.attr in methods
                    ):
                        add(v.attr, v.attr, in_loop)
                    elif isinstance(v, ast.Name) and v.id in nested:
                        add(f"{mname}:{v.id}", nested[v.id], in_loop)
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _SUBMITTERS
            ) or (
                isinstance(node.func, ast.Name)
                and node.func.id in _SUBMITTERS
            ):
                for a in node.args:
                    if (
                        isinstance(a, ast.Attribute)
                        and isinstance(a.value, ast.Name)
                        and a.value.id == "self"
                        and a.attr in methods
                    ):
                        add(a.attr, a.attr, True)

    for root, (entries, multi) in SEED_ROOTS.get((sf.path, cls.name), {}).items():
        for e in entries:
            if e in methods:
                add(root, e, multi)
    return roots


def _closure(entries: list, methods: dict, blocked: set) -> list:
    """Transitive self-call closure from ``entries`` (method names or
    nested function nodes), never descending into ``blocked`` methods
    (another root's entry runs on that root's thread)."""
    seen: set[str] = set()
    out: list = []
    frontier = list(entries)
    while frontier:
        e = frontier.pop()
        if isinstance(e, str):
            if e in seen or e in ("__init__", "__del__"):
                continue
            seen.add(e)
            node = methods.get(e)
            if node is None:
                continue
        else:
            node = e  # nested def root entry
        out.append(node)
        for callee in sorted(_self_calls(node, methods)):
            if callee not in blocked and callee not in seen:
                frontier.append(callee)
    return out


def _t002(
    sf: SourceFile,
    cls: ast.ClassDef,
    guards: dict[str, str],
    findings: list[Finding],
) -> None:
    methods = _methods_of(cls)
    roots = _infer_roots(sf, cls, methods)
    if not roots:
        return
    root_entry_methods = {
        e for entries, _ in roots.values() for e in entries if isinstance(e, str)
    }
    caller_entries = [
        m
        for m in methods
        if m not in root_entry_methods and m not in ("__init__", "__del__")
    ]
    if caller_entries:
        roots["(callers)"] = (caller_entries, False)

    skip = set(guards) | _class_locks(cls) | _atomic_fields(cls) | set(methods)
    # field -> root -> {'r','w'}; field -> first write (line) for anchor
    touched: dict[str, dict[str, set]] = {}
    first_write: dict[str, tuple[int, str]] = {}
    for root, (entries, _multi) in sorted(roots.items()):
        blocked = root_entry_methods - {
            e for e in entries if isinstance(e, str)
        }
        for node in _closure(entries, methods, blocked):
            for field, kind, line, _n in _field_accesses(node):
                if field in skip:
                    continue
                touched.setdefault(field, {}).setdefault(root, set()).add(kind)
                if kind == "w":
                    cur = first_write.get(field)
                    if cur is None or line < cur[0]:
                        first_write[field] = (line, root)

    for field, by_root in sorted(touched.items()):
        writers = [r for r, kinds in by_root.items() if "w" in kinds]
        if not writers:
            continue
        multi_writer = any(roots[r][1] for r in writers)
        if len(by_root) < 2 and not multi_writer:
            continue
        line, _ = first_write[field]
        if _noqa(sf, line):
            continue
        readers = sorted(r for r in by_root if r not in writers)
        detail = "written from " + ", ".join(
            f"{r}{' (xN)' if roots.get(r, (None, False))[1] else ''}"
            for r in sorted(writers)
        )
        if readers:
            detail += "; read from " + ", ".join(readers)
        findings.append(
            Finding(
                sf.path, line, "KBT-T002",
                f"self.{field} escapes to multiple thread roots with no "
                f"declared guard ({detail}) — annotate `#: guarded_by "
                "<lock>` on its __init__ line (KBT-L then enforces the "
                "discipline) or confine it to one thread",
                symbol=f"{cls.name}.{field}",
            )
        )


# -- KBT-T003: split read-modify-write ---------------------------------------


def _t003(
    sf: SourceFile,
    cls: ast.ClassDef,
    guards: dict[str, str],
    findings: list[Finding],
) -> None:
    lock_names = set(guards.values())

    for meth in cls.body:
        if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if meth.name in ("__init__", "__del__") or meth.name.endswith("_locked"):
            continue
        if _is_assume_locked(meth):
            continue
        region_of: dict[int, dict] = {}
        # region id -> {if-node id: branch index} — two regions in
        # sibling branches of one If are mutually exclusive paths and
        # never pair up
        branch_of: dict[int, dict] = {}
        counter = [0]

        def tag(node, current, branches, region_of=region_of, counter=counter):
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ) and region_of:
                return  # nested defs run elsewhere
            region_of[id(node)] = current
            if isinstance(node, ast.With):
                acquired = []
                for item in node.items:
                    e = item.context_expr
                    for sub in ast.walk(e):
                        region_of[id(sub)] = current
                    if (
                        isinstance(e, ast.Attribute)
                        and isinstance(e.value, ast.Name)
                        and e.value.id == "self"
                        and e.attr in lock_names
                    ):
                        acquired.append(e.attr)
                inner = dict(current)
                for a in acquired:
                    counter[0] += 1
                    inner[a] = counter[0]
                    branch_of[counter[0]] = dict(branches)
                for stmt in node.body:
                    tag(stmt, inner, branches)
                return
            if isinstance(node, ast.If):
                for sub in ast.walk(node.test):
                    region_of[id(sub)] = current
                for stmt in node.body:
                    tag(stmt, current, {**branches, id(node): 0})
                for stmt in node.orelse:
                    tag(stmt, current, {**branches, id(node): 1})
                return
            for child in ast.iter_child_nodes(node):
                tag(child, current, branches)

        tag(meth, {}, {})

        def same_path(ra: int, rb: int) -> bool:
            ba, bb = branch_of.get(ra, {}), branch_of.get(rb, {})
            return all(bb[k] == v for k, v in ba.items() if k in bb)
        # (field) -> [(region, kind, line)] in source order
        per_field: dict[str, list] = {}
        for field, kind, line, node in _field_accesses(meth):
            lock = guards.get(field)
            if lock is None:
                continue
            region = region_of.get(id(node), {}).get(lock)
            if region is None:
                continue  # unlocked access: KBT-L001's finding, not ours
            per_field.setdefault(field, []).append((region, kind, line))

        for field, accesses in sorted(per_field.items()):
            regions: dict[int, list] = {}
            for region, kind, line in accesses:
                regions.setdefault(region, []).append((kind, line))
            read_regions = [
                r for r, acc in regions.items() if any(k == "r" for k, _ in acc)
            ]
            if not read_regions:
                continue
            for r in sorted(regions):
                earlier = [x for x in read_regions if x < r and same_path(x, r)]
                if not earlier:
                    continue
                acc = regions[r]
                # a region that also READS the field under the writing
                # lock (validate/merge/max()) is a re-read region, even
                # when the read sits on the RHS of the writing statement
                if any(k == "w" for k, _ in acc) and not any(
                    k == "r" for k, _ in acc
                ):
                    line = min(ln for k, ln in acc if k == "w")
                    if _noqa(sf, line):
                        continue
                    read_line = min(
                        ln
                        for k, ln in regions[min(earlier)]
                        if k == "r"
                    )
                    findings.append(
                        Finding(
                            sf.path, line, "KBT-T003",
                            f"self.{field} is read under self.{guards[field]} "
                            f"(line {read_line}) and written back under a "
                            f"separate self.{guards[field]} region in "
                            f"{cls.name}.{meth.name} — the read-modify-write "
                            "is not atomic (another thread interleaves "
                            "between the regions); merge the regions or "
                            "re-read/validate under the writing lock",
                            symbol=f"{cls.name}.{meth.name}.{field}",
                        )
                    )
                    break  # one finding per field per method


# -- entry point --------------------------------------------------------------


def analyze(files: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for sf in files:
        ctx_of = _contexts(sf.tree)
        parents = _parents(sf.tree)
        _t001(sf, ctx_of, parents, findings)
        seed = SEED_GUARDED.get(sf.path, {})
        annotated = _annotated_guards(sf)
        for cls in sf.tree.body if isinstance(sf.tree, ast.Module) else []:
            if not isinstance(cls, ast.ClassDef):
                continue
            guards = dict(seed.get(cls.name, {}))
            guards.update(annotated.get(cls.name, {}))
            _t002(sf, cls, guards, findings)
            if guards:
                _t003(sf, cls, guards, findings)
    findings.sort(key=lambda f: (f.path, f.line, f.code, f.symbol))
    return findings


# -- seeded fixtures + self-check --------------------------------------------
#
# Each positive fixture marks its expected finding lines with a
# `# VIOLATION: <code>` comment; the negative twin must stay silent.
# selfcheck() fails the CLI if a code ever stops firing (or starts
# over-firing) — the analyzer cannot silently rot.

_FIX_T001_POS = '''
import threading
from concurrent.futures import ThreadPoolExecutor

class Leaky:
    def start(self):
        self._worker = threading.Thread(target=self._run)  # VIOLATION: KBT-T001
        self._worker.start()

    def launch_pool(self):
        self._pool = ThreadPoolExecutor(max_workers=2)  # VIOLATION: KBT-T001
        self._pool.submit(self._run)

    def wait_forever(self):
        t = threading.Thread(target=self._run)  # VIOLATION: KBT-T001
        t.start()
        t.join()

    def _run(self):
        pass
'''

_FIX_T001_NEG = '''
import threading
from concurrent.futures import ThreadPoolExecutor

class Clean:
    def start(self):
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def stop(self):
        self._worker.join(timeout=5.0)

    def pooled(self):
        with ThreadPoolExecutor(max_workers=2) as pool:
            pool.submit(self._run)

    def fan_out(self):
        ts = []
        for _ in range(4):
            ts.append(threading.Thread(target=self._run))
        for t in ts:
            t.daemon = True
            t.start()
        for t in ts:
            t.join(timeout=1.0)

    def factory(self):
        return threading.Thread(target=self._run)

    def _run(self):
        pass
'''

_FIX_T002_POS = '''
import threading

class Pump:
    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0
        self._status = ""

    def start(self):
        self._t = threading.Thread(target=self._pump, daemon=True)
        self._t.start()

    def _pump(self):
        while True:
            self._count += 1  # VIOLATION: KBT-T002
            self._status = "live"  # VIOLATION: KBT-T002

    def snapshot(self):
        return self._count, self._status
'''

_FIX_T002_NEG = '''
import threading

class Pump:
    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0  #: guarded_by _lock
        self._status = ""  #: guarded_by _lock

    def start(self):
        self._t = threading.Thread(target=self._pump, daemon=True)
        self._t.start()

    def _pump(self):
        while True:
            with self._lock:
                self._count += 1
                self._status = "live"

    def snapshot(self):
        with self._lock:
            return self._count, self._status
'''

_FIX_T003_POS = '''
import threading

class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0  #: guarded_by _lock

    def bump(self):
        with self._lock:
            n = self._n
        n += 1
        with self._lock:
            self._n = n  # VIOLATION: KBT-T003
'''

_FIX_T003_NEG = '''
import threading

class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0  #: guarded_by _lock

    def bump_atomic(self):
        with self._lock:
            self._n += 1

    def bump_revalidated(self):
        with self._lock:
            n = self._n
        with self._lock:
            if self._n == n:
                self._n = n + 1
'''

FIXTURES: dict[str, str] = {
    "t001_pos": _FIX_T001_POS,
    "t001_neg": _FIX_T001_NEG,
    "t002_pos": _FIX_T002_POS,
    "t002_neg": _FIX_T002_NEG,
    "t003_pos": _FIX_T003_POS,
    "t003_neg": _FIX_T003_NEG,
}


def _expected(source: str) -> set[tuple[str, int]]:
    out = set()
    for i, line in enumerate(source.splitlines(), 1):
        if "# VIOLATION:" in line:
            out.add((line.split("# VIOLATION:")[1].strip(), i))
    return out


def selfcheck() -> list[str]:
    """Prove every KBT-T code fires on its seeded fixture and stays
    silent on the negative twin. Returns problem strings (empty=ok)."""
    problems: list[str] = []
    for name, source in sorted(FIXTURES.items()):
        sf = SourceFile(f"fixture:{name}", source, ast.parse(source))
        got = {(f.code, f.line) for f in analyze([sf])}
        want = _expected(source)
        if got != want:
            problems.append(
                f"fixture {name}: expected {sorted(want)} got {sorted(got)}"
            )
    return problems


# -- runtime RaceWitness self-check ------------------------------------------


def witness_selfcheck() -> list[str]:
    """Deterministic drills of utils.race.RaceWitness: a true race is
    caught with a stable trace id; lock- and join-ordered accesses stay
    clean. Returns problem strings (empty=ok)."""
    import threading

    from kube_batch_tpu_torch.utils.race import RaceWitness

    problems: list[str] = []

    class Box:
        def __init__(self) -> None:
            self.field = 0

    def race_once() -> list[str]:
        w = RaceWitness()
        box = w.watch(Box(), ["field"])
        first_done = threading.Event()

        def writer_a() -> None:
            box.field = 1
            first_done.set()

        def writer_b() -> None:
            first_done.wait(5.0)  # Event is not a happens-before edge
            box.field = 2

        ta = w.spawn(writer_a, name="drill-a")
        tb = w.spawn(writer_b, name="drill-b")
        ta.start()
        tb.start()
        ta.join(5.0)
        tb.join(5.0)
        return list(w.reports)

    r1, r2 = race_once(), race_once()
    if not r1:
        problems.append("true-race drill: witness reported nothing")
    elif "[trace Box.field:0-1]" not in r1[0]:
        problems.append(f"true-race drill: unexpected trace id in {r1[0]!r}")
    if r1 != r2:
        problems.append(
            f"true-race drill not deterministic: {r1!r} vs {r2!r}"
        )

    # ordered by lock: the release->acquire edge orders the writes
    w = RaceWitness()
    box = w.watch(Box(), ["field"])
    mu = w.wrap("box.mu", threading.Lock())
    first_done = threading.Event()

    def locked_a() -> None:
        with mu:
            box.field = 1
        first_done.set()

    def locked_b() -> None:
        first_done.wait(5.0)
        with mu:
            box.field = 2

    ta, tb = w.spawn(locked_a), w.spawn(locked_b)
    ta.start(), tb.start()
    ta.join(5.0), tb.join(5.0)
    if w.reports:
        problems.append(f"lock-ordered drill flagged: {w.reports!r}")

    # ordered by join: parent writes after joining the child
    w = RaceWitness()
    box = w.watch(Box(), ["field"])

    def child() -> None:
        box.field = 1

    t = w.spawn(child)
    t.start()
    t.join(5.0)
    box.field = 2  # happens-after via the join edge
    if w.reports:
        problems.append(f"join-ordered drill flagged: {w.reports!r}")
    return problems


# -- live witness drive: streaming-federation bind path -----------------------


def witness_drive(writers: int = 2, events_per_writer: int = 40) -> dict:
    """Drive the RaceWitness over the live absorb-mode StreamTrigger +
    StreamState — the federated streaming bind path: concurrent peer
    bind/release churn and pending arrivals against one trigger, a
    drain loop absorbing occupancy patches into the resident table.
    Expect clean: every hot-field access is ordered by trigger._lock
    or confined to the drain thread."""
    import threading

    from kube_batch_tpu_torch.cache.store import PODS
    from kube_batch_tpu_torch.streaming import StreamState, StreamTrigger
    from kube_batch_tpu_torch.testing import build_node, build_pod, build_resource_list
    from kube_batch_tpu_torch.utils.race import RaceWitness

    w = RaceWitness()
    trigger = StreamTrigger(absorb_external=True)
    trigger._lock = w.wrap("trigger._lock", trigger._lock)
    w.watch(
        trigger,
        {
            "_gangs": "touch",
            "_bound_patches": "touch",
            "_node_patches": "touch",
            "_arrivals": "touch",
            "_queues": "touch",
            "_stale": "rw",
            "_stale_reason": "rw",
        },
    )
    state = StreamState()
    from kube_batch_tpu_torch.api.node_info import NodeInfo

    state.nodes = {
        f"n{i}": NodeInfo(
            build_node(f"n{i}", build_resource_list(cpu=64, memory="64Gi", pods=256))
        )
        for i in range(4)
    }
    state.valid = True
    state.reason = ""
    w.watch(state, {"nodes": "touch", "valid": "rw", "reason": "rw"})

    stop = threading.Event()
    accesses = {"n": 0}
    w.on_access = lambda _name: accesses.__setitem__("n", accesses["n"] + 1)

    def peer(idx: int) -> None:
        for i in range(events_per_writer):
            name = f"peer{idx}-p{i}"
            bound = build_pod(
                name=name, group_name=f"g{idx}",
                req=build_resource_list(cpu=1, memory="256Mi"),
                node_name=f"n{i % 4}",
            )
            trigger._on_event(PODS, f"default/{name}", bound, None)  # peer bind
            if i % 3 == 0:
                trigger._on_event(PODS, f"default/{name}", None, bound)  # release
            pending = build_pod(
                name=f"own{idx}-p{i}", group_name=f"own{idx}",
                req=build_resource_list(cpu=1, memory="256Mi"),
            )
            trigger._on_event(PODS, f"default/own{idx}-p{i}", pending, None)

    def drain_loop() -> None:
        while not stop.is_set():
            trigger.wait(0.01)
            work = trigger.drain()
            if work.bound_patches:
                state.apply_bound_patches(work.bound_patches)
            trigger.prune(set(list(work.gangs)[:2]))

    threads = [w.spawn(peer, args=(i,), name=f"kbt-drive-peer{i}") for i in range(writers)]
    drainer = w.spawn(drain_loop, name="kbt-drive-drain")
    for t in threads:
        t.start()
    drainer.start()
    for t in threads:
        t.join(timeout=30.0)
    stop.set()
    drainer.join(timeout=30.0)
    # final absorb on the main thread — ordered by the join edges
    work = trigger.drain()
    if work.bound_patches:
        state.apply_bound_patches(work.bound_patches)
    leaked = [t.name for t in [*threads, drainer] if t.is_alive()]
    return {
        "ok": not w.reports and not leaked,
        "accesses": accesses["n"],
        "backlog": trigger.backlog_pods(),
        "reports": list(w.reports),
        "leaked": leaked,
    }


# -- CLI ----------------------------------------------------------------------


def main(argv: Optional[list[str]] = None) -> int:
    import argparse
    import json
    import os
    import textwrap

    from kube_batch_tpu_torch.analysis import (
        CODES,
        Baseline,
        apply_baseline,
        baseline_path,
        load_baseline,
        load_tree,
        render_baseline,
        repo_root,
    )

    p = argparse.ArgumentParser(
        prog="python -m kube_batch_tpu_torch.analysis.threads",
        description="thread-lifecycle / shared-state-escape / atomicity "
        "analyzer (KBT-T) + RaceWitness self-check (stdlib-only)",
    )
    p.add_argument("--json", action="store_true", help="machine-readable summary")
    p.add_argument("--strict", action="store_true",
                   help="also fail on stale KBT-T baseline entries")
    p.add_argument("--baseline", default=None,
                   help="suppression file (default: <repo>/kube_batch_tpu_torch/analysis/lint-baseline.toml)")
    p.add_argument("--no-baseline", action="store_true",
                   help="report raw findings, apply no suppressions")
    p.add_argument("--repo", default=None, help="tree to analyze (default: auto)")
    p.add_argument("--explain", metavar="CODE", default=None,
                   help="describe a finding code and exit")
    p.add_argument("--prune", action="store_true",
                   help="rewrite the shared baseline dropping stale KBT-T "
                   "entries (other code families untouched)")
    p.add_argument("--witness-drive", action="store_true",
                   help="also drive the RaceWitness over the live "
                   "streaming-federation bind path (imports the package)")
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
    findings = analyze(load_tree(repo))

    if args.no_baseline:
        bl = None
        kept, suppressed, stale, baseline_errors = findings, [], [], []
        bl_path = None
    else:
        bl_path = args.baseline or baseline_path(repo)
        bl = load_baseline(bl_path, repo)
        # this CLI owns only the KBT-T slice of the shared baseline:
        # other families neither suppress here nor read as stale
        sub = Baseline(
            path=bl.path,
            suppressions=[
                s for s in bl.suppressions if s.code.startswith("KBT-T")
            ],
            errors=[f for f in bl.errors if f.symbol.startswith("KBT-T")],
            preamble=bl.preamble,
        )
        kept, suppressed, stale = apply_baseline(findings, sub)
        baseline_errors = sub.errors

    if args.prune:
        if bl is None:
            print("--prune is meaningless with --no-baseline")
            return 2
        keep = [
            s for s in bl.suppressions
            if not s.code.startswith("KBT-T")
            or s.hits > 0
            or not (s.code and s.path)
        ]
        dropped = [s for s in bl.suppressions if s not in keep]
        if dropped:
            with open(bl_path, "w", encoding="utf-8") as fh:
                fh.write(render_baseline(bl, keep))
        for s in dropped:
            print(f"pruned: {s.code} at {s.path}"
                  + (f" ({s.symbol})" if s.symbol else ""))
        print(f"prune: {len(dropped)} stale KBT-T entr"
              f"{'y' if len(dropped) == 1 else 'ies'} dropped")
        stale = []

    static_problems = selfcheck()
    witness_problems = witness_selfcheck()
    drive = witness_drive() if args.witness_drive else None

    failing = list(kept) + list(baseline_errors)
    if args.strict:
        failing += stale
    ok = (
        not failing
        and not static_problems
        and not witness_problems
        and (drive is None or drive["ok"])
    )

    if args.json:
        print(json.dumps({
            "ok": ok,
            "repo": repo,
            "findings": [f.__dict__ for f in kept],
            "baseline_errors": [f.__dict__ for f in baseline_errors],
            "stale": [f.__dict__ for f in stale],
            "suppressed": len(suppressed),
            "counts": _counts(kept),
            "selfcheck": {
                "static": static_problems,
                "witness": witness_problems,
            },
            "witness_drive": drive,
        }, sort_keys=True))
    else:
        for f in sorted(failing, key=lambda f: (f.path, f.line, f.code)):
            print(f.render())
        if stale and not args.strict:
            for f in stale:
                print(f"note: {f.render()}")
        for prob in static_problems:
            print(f"selfcheck: {prob}")
        for prob in witness_problems:
            print(f"witness: {prob}")
        if drive is not None and not drive["ok"]:
            for r in drive["reports"]:
                print(f"drive: {r}")
            for name in drive["leaked"]:
                print(f"drive: leaked thread {name}")
        print(
            f"threads: {len(kept)} finding(s), {len(stale)} stale, "
            f"{len(suppressed)} suppressed, selfcheck "
            f"{'ok' if not (static_problems or witness_problems) else 'FAILED'}"
            + (
                f", witness drive {'ok' if drive['ok'] else 'FAILED'} "
                f"({drive['accesses']} accesses)"
                if drive is not None
                else ""
            )
        )
    if ok:
        return 0
    return 1


def _counts(findings) -> dict[str, int]:
    out: dict[str, int] = {}
    for f in findings:
        out[f.code] = out.get(f.code, 0) + 1
    return out


if __name__ == "__main__":
    import sys

    # re-enter through the canonical module so module-level state is
    # shared with normal imports
    from kube_batch_tpu_torch.analysis.threads import main as _canonical_main

    sys.exit(_canonical_main())
