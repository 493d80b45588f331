"""A5 — interprocedural lock-order analyzer (KBT-D001/D002).

Built on A1's lock universe (the guarded-by seed map, ``#: guarded_by``
annotations, and any ``threading.Lock/RLock/Condition`` assigned in a
class): every lock gets a node ``Class._attr`` in a static
**acquisition graph**, with an edge ``A -> B`` wherever code acquires
``B`` while lexically (or, through the call summaries below,
transitively) holding ``A``.

Interprocedural model, deliberately shallow but cross-file:

- per-method **summaries** — the set of lock nodes a method acquires
  and the blocking calls it makes — computed to fixpoint over
  ``self.method()`` calls within a class;
- **collaborator edges** across classes: ``self.<attr>.method()``
  follows the attribute to its class when the attribute is either
  assigned a known class's constructor in this file
  (``self.journal = WriteIntentJournal(...)``) or listed in the
  injected-dependency seed map below (``SchedulerCache._store`` is a
  ``ClusterStore``). The callee's summary locks/blocking calls are
  charged to the held region at the call site.

Checks:

- **KBT-D001**: a cycle in the acquisition graph (ABBA and longer) —
  two code paths that interleave under load and deadlock. One finding
  per cycle, anchored at one participating acquisition site, with
  every edge's site in the message.
- **KBT-D002**: a blocking API reached while a lock is held —
  ``os.fsync``, ``time.sleep``, ``subprocess.*``, future
  ``.result()``, card syncs (``torch.cuda.synchronize``, an event's
  ``synchronize``), socket ``sendall``/``recv``.
  ``Condition.wait``/``wait_for`` on the *held* condition is exempt
  (it releases the lock while blocking); callbacks stashed for later
  execution are invisible, same as A1.

Dynamic dispatch (event handlers, plugin callbacks) is out of reach by
design — the runtime :class:`kube_batch_tpu_torch.utils.locking.LockOrderWitness`
covers that half in the chaos suite.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Optional, Union

from kube_batch_tpu_torch.analysis import Finding, SourceFile
from kube_batch_tpu_torch.analysis.lock_discipline import (
    SEED_GUARDED,
    _annotated_guards,
    _class_locks,
)

_FuncDef = Union[ast.FunctionDef, ast.AsyncFunctionDef]

# Injected dependencies the constructor-call inference cannot see:
# (path, class, attr) -> collaborator class name (resolved globally —
# class names in the lock universe are unique).
SEED_COLLABORATORS: dict[tuple[str, str, str], str] = {
    ("kube_batch_tpu_torch/cache/cache.py", "SchedulerCache", "_store"): "ClusterStore",
    ("kube_batch_tpu_torch/cache/cache.py", "SchedulerCache", "journal"): "WriteIntentJournal",
    ("kube_batch_tpu_torch/cache/cache.py", "StoreVolumeBinder", "_store"): "ClusterStore",
    ("kube_batch_tpu_torch/server.py", "WatchHub", "journal"): "WriteIntentJournal",
}

# blocking call signatures: attribute-call names and (root, attr) pairs
_BLOCKING_METHODS = {
    "fsync": "os.fsync",
    "sleep": "time.sleep / blocking sleep",
    "result": "future .result() (blocks on the pool)",
    "synchronize": "card sync",
    "sendall": "socket send",
    "recv": "socket recv",
    "urlopen": "network fetch",
}
_SUBPROCESS_CALLS = {"run", "check_call", "check_output", "Popen", "call"}


@dataclass
class _Acq:
    """One acquisition site: lock node + where."""

    node: str
    path: str
    line: int
    where: str  # Class.method


@dataclass
class _Summary:
    acquires: dict[str, _Acq] = field(default_factory=dict)  # node -> first site
    blocking: dict[str, tuple[str, int, str]] = field(default_factory=dict)
    # blocking: api -> (path, line, where) of the first site


@dataclass
class _Class:
    path: str
    name: str
    node: ast.ClassDef
    locks: set[str]  # lock attr names owned by this class
    conds: set[str]  # the subset assigned threading.Condition
    collaborators: dict[str, str]  # attr -> class name
    methods: dict[str, _FuncDef] = field(default_factory=dict)
    summaries: dict[str, _Summary] = field(default_factory=dict)


def _lock_attrs_of(sf: SourceFile, cls: ast.ClassDef) -> tuple[set[str], set[str]]:
    """(all lock attrs, condition attrs) for a class: ctor-assigned locks
    plus locks named by the seed map / annotations (guard values)."""
    locks: set[str] = set(_class_locks(cls))
    conds: set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            fn = node.value.func
            name = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else ""
            )
            if name == "Condition":
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        conds.add(t.attr)
    seed = SEED_GUARDED.get(sf.path, {}).get(cls.name, {})
    locks.update(seed.values())
    locks.update(_annotated_guards(sf).get(cls.name, {}).values())
    return locks, conds


def _collaborators_of(sf: SourceFile, cls: ast.ClassDef, known: set[str]) -> dict[str, str]:
    """attr -> collaborator class: `self.attr = KnownClass(...)`
    assignments plus the injected-dependency seed map."""
    out: dict[str, str] = {}
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            fn = node.value.func
            name = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else ""
            )
            if name in known:
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        out[t.attr] = name
    for (path, cname, attr), target in SEED_COLLABORATORS.items():
        if path == sf.path and cname == cls.name and target in known:
            out[attr] = target
    return out


def _self_attr(node: ast.expr) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


class _MethodWalker(ast.NodeVisitor):
    """One pass over a method body: records acquisitions, edges under
    the current held set, blocking calls, and self/collaborator calls
    (charged from the callee's current summary — the caller loops to
    fixpoint)."""

    def __init__(
        self,
        sf: SourceFile,
        cls: _Class,
        method: str,
        classes_by_name: dict[str, _Class],
        edges: dict[tuple[str, str], _Acq],
        blocking_sites: list[Finding],
        summary: _Summary,
    ) -> None:
        self.sf = sf
        self.cls = cls
        self.method = method
        self.by_name = classes_by_name
        self.edges = edges
        self.blocking_sites = blocking_sites
        self.summary = summary
        self.held: list[str] = []  # lock nodes, outermost first
        self.held_attrs: list[str] = []  # the self.<attr> spelling of each
        self._root = True
        self._reported: set[tuple] = set()

    # -- helpers -------------------------------------------------------------

    def _noqa(self, lineno: int) -> bool:
        lines = self.sf.lines
        return 0 < lineno <= len(lines) and "noqa" in lines[lineno - 1]

    def _where(self) -> str:
        return f"{self.cls.name}.{self.method}"

    def _record_acquire(self, node_name: str, lineno: int) -> None:
        acq = _Acq(node_name, self.sf.path, lineno, self._where())
        self.summary.acquires.setdefault(node_name, acq)
        for held in self.held:
            if held != node_name:
                self.edges.setdefault((held, node_name), acq)

    def _record_blocking(self, api: str, desc: str, lineno: int) -> None:
        self.summary.blocking.setdefault(api, (self.sf.path, lineno, self._where()))
        if self.held and not self._noqa(lineno):
            key = ("D002", lineno, api)
            if key in self._reported:
                return
            self._reported.add(key)
            self.blocking_sites.append(
                Finding(
                    self.sf.path,
                    lineno,
                    "KBT-D002",
                    f"{desc} while holding {self.held[-1]} in "
                    f"{self._where()} — every thread needing the lock "
                    "stalls for the blocking latency (move it outside "
                    "the critical section, or baseline with the "
                    "ordering argument)",
                    symbol=f"{self._where()}.{api}",
                )
            )

    def _charge_summary(self, callee: _Summary, lineno: int) -> None:
        """A call whose callee acquires locks / blocks: edges from every
        held lock, and blocking propagated to this summary (reported
        here if held)."""
        for node_name, acq in callee.acquires.items():
            self.summary.acquires.setdefault(node_name, acq)
            for held in self.held:
                if held != node_name:
                    self.edges.setdefault(
                        (held, node_name),
                        _Acq(node_name, self.sf.path, lineno, self._where()),
                    )
        for api, (bpath, bline, bwhere) in callee.blocking.items():
            self.summary.blocking.setdefault(api, (bpath, bline, bwhere))
            if self.held and not self._noqa(lineno):
                key = ("D002", lineno, api)
                if key not in self._reported:
                    self._reported.add(key)
                    self.blocking_sites.append(
                        Finding(
                            self.sf.path,
                            lineno,
                            "KBT-D002",
                            f"call into {bwhere} ({api}: see "
                            f"{bpath}:{bline}) while holding "
                            f"{self.held[-1]} in {self._where()} — the "
                            "blocking call runs inside this critical "
                            "section",
                            symbol=f"{self._where()}.{api}",
                        )
                    )

    # -- traversal -----------------------------------------------------------

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        if self._root:
            self._root = False
            self.generic_visit(node)
        # nested defs: skip — stashed callbacks run on other threads

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_With(self, node: ast.With) -> None:
        for item in node.items:
            self.visit(item.context_expr)
        acquired: list[tuple[str, str]] = []
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr is not None and attr in self.cls.locks:
                node_name = f"{self.cls.name}.{attr}"
                self._record_acquire(node_name, item.context_expr.lineno)
                acquired.append((node_name, attr))
        for node_name, attr in acquired:
            self.held.append(node_name)
            self.held_attrs.append(attr)
        for item in node.items:
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self.held.pop()
            self.held_attrs.pop()

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute):
            # self.method(...)
            recv_attr = _self_attr(fn.value)
            if isinstance(fn.value, ast.Name) and fn.value.id == "self":
                callee = self.cls.summaries.get(fn.attr)
                if callee is not None:
                    self._charge_summary(callee, node.lineno)
            elif recv_attr is not None:
                # self.<attr>.method(...)
                if recv_attr in self.cls.locks and fn.attr in ("wait", "wait_for"):
                    # Condition.wait on the HELD condition releases it —
                    # exempt; on a lock not held it is just odd, and on a
                    # different held lock's condition it blocks for real.
                    if recv_attr not in self.held_attrs:
                        self._record_blocking(
                            f"{recv_attr}.wait",
                            f"Condition wait on self.{recv_attr} (not the "
                            "held lock — does not release it)",
                            node.lineno,
                        )
                else:
                    target = self.cls.collaborators.get(recv_attr)
                    if target is not None:
                        tcls = self.by_name.get(target)
                        callee = tcls.summaries.get(fn.attr) if tcls else None
                        if callee is not None:
                            self._charge_summary(callee, node.lineno)
                    self._check_blocking_attr(fn, node.lineno)
            else:
                self._check_blocking_attr(fn, node.lineno)
        self.generic_visit(node)

    def _check_blocking_attr(self, fn: ast.Attribute, lineno: int) -> None:
        root = fn.value
        while isinstance(root, ast.Attribute):
            root = root.value
        root_name = root.id if isinstance(root, ast.Name) else ""
        if fn.attr in _BLOCKING_METHODS:
            # jnp/np .sleep etc. don't exist; cheap root filter for recv
            # (queue.recv would still be blocking — keep it)
            self._record_blocking(
                f"{root_name + '.' if root_name else ''}{fn.attr}",
                f"blocking call {root_name + '.' if root_name else ''}"
                f"{fn.attr}() ({_BLOCKING_METHODS[fn.attr]})",
                lineno,
            )
        elif root_name == "subprocess" and fn.attr in _SUBPROCESS_CALLS:
            self._record_blocking(
                f"subprocess.{fn.attr}",
                f"subprocess.{fn.attr}() (blocks on the child)",
                lineno,
            )


def _collect_classes(files: list[SourceFile]) -> dict[str, _Class]:
    """The lock universe: every class owning at least one known lock."""
    out: dict[str, _Class] = {}
    for sf in files:
        for node in sf.tree.body if isinstance(sf.tree, ast.Module) else []:
            if not isinstance(node, ast.ClassDef):
                continue
            locks, conds = _lock_attrs_of(sf, node)
            if not locks:
                continue
            c = _Class(sf.path, node.name, node, locks, conds, {})
            for meth in node.body:
                if isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    c.methods[meth.name] = meth
                    c.summaries[meth.name] = _Summary()
            out[node.name] = c
    for sf in files:
        for name, c in out.items():
            if c.path == sf.path:
                c.collaborators = _collaborators_of(sf, c.node, set(out))
    return out


def _cycles(edges: dict[tuple[str, str], _Acq]) -> list[list[str]]:
    """Elementary cycles via SCC + per-SCC DFS; small graphs only.
    Returns each cycle once as a node list rotated to its minimum."""
    graph: dict[str, set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    # Tarjan SCC
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    stack: list[str] = []
    on: set[str] = set()
    sccs: list[set[str]] = []
    counter = [0]

    def strongconnect(v: str) -> None:
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        for w in sorted(graph[v]):
            if w not in index:
                strongconnect(w)
                low[v] = min(low[v], low[w])
            elif w in on:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            scc = set()
            while True:
                w = stack.pop()
                on.discard(w)
                scc.add(w)
                if w == v:
                    break
            sccs.append(scc)

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)

    cycles: list[list[str]] = []
    seen: set[tuple[str, ...]] = set()
    for scc in sccs:
        if len(scc) < 2:
            continue
        # enumerate simple cycles within the SCC (tiny in practice)
        nodes = sorted(scc)

        def dfs(start: str, v: str, path: list[str]) -> None:
            for w in sorted(graph[v]):
                if w == start and len(path) >= 2:
                    i = path.index(min(path))
                    key = tuple(path[i:] + path[:i])
                    if key not in seen:
                        seen.add(key)
                        cycles.append(list(key))
                elif w in scc and w not in path and w > start:
                    dfs(start, w, path + [w])

        for n in nodes:
            dfs(n, n, [n])
    return cycles


def analyze(files: list[SourceFile]) -> list[Finding]:
    classes = _collect_classes(files)
    by_path = {sf.path: sf for sf in files}
    edges: dict[tuple[str, str], _Acq] = {}
    blocking: list[Finding] = []

    # fixpoint over summaries: edges/blocking are recomputed fresh each
    # round so call charging sees the latest callee summaries
    for _round in range(6):
        before = {
            (c.name, m): (frozenset(s.acquires), frozenset(s.blocking))
            for c in classes.values()
            for m, s in c.summaries.items()
        }
        edges = {}
        blocking = []
        for c in classes.values():
            sf = by_path.get(c.path)
            if sf is None:
                continue
            for mname, meth in c.methods.items():
                walker = _MethodWalker(
                    sf, c, mname, classes, edges, blocking, c.summaries[mname]
                )
                walker.visit(meth)
        after = {
            (c.name, m): (frozenset(s.acquires), frozenset(s.blocking))
            for c in classes.values()
            for m, s in c.summaries.items()
        }
        if before == after:
            break

    findings: list[Finding] = list(blocking)
    for cycle in _cycles(edges):
        pairs = list(zip(cycle, cycle[1:] + cycle[:1]))
        sites = []
        for a, b in pairs:
            acq = edges.get((a, b))
            if acq is not None:
                sites.append(f"{a} -> {b} at {acq.path}:{acq.line} ({acq.where})")
        anchor = edges.get(pairs[0])
        findings.append(
            Finding(
                anchor.path if anchor else "kube_batch_tpu_torch",
                anchor.line if anchor else 0,
                "KBT-D001",
                "lock-order cycle: " + "; ".join(sites)
                + " — pick one global order and re-nest the inner "
                "acquisition",
                symbol="cycle:" + "<->".join(cycle),
            )
        )
    # stable order
    findings.sort(key=lambda f: (f.path, f.line, f.code, f.symbol))
    return findings
