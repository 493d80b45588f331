"""A1 — lock-discipline analyzer (KBT-L001/L002), over the PyTorch/CUDA
package.

Model: a class owns locks (``threading.Lock/RLock/Condition`` attributes)
and *guarded* attributes. An access to ``self.<guarded>`` is legal when

- it is lexically inside a ``with self.<lock>:`` block for the guarding
  lock (aliases of the same lock are not tracked — one lock, one name);
- or the enclosing method is marked lock-held: name ends in ``_locked``
  or it carries an ``@assume_locked`` decorator
  (kube_batch_tpu_torch.utils.locking);
- or the enclosing method is ``__init__`` / ``__del__`` (construction
  and teardown happen before/after the object is shared).

Guarded attributes come from two sources, merged:

- the committed **seed map** below for the threaded layers that predate
  the annotation convention (cache/cache.py, cache/store.py, server.py,
  recovery/journal.py, utils/workqueue.py), and for the state only this
  package has (the class table, the encode cache's version);
- a ``#: guarded_by <lock>`` trailing comment anywhere a
  ``self.<attr>`` is assigned (conventionally the ``__init__``
  declaration line) — new code self-documents its discipline and the
  analyzer picks it up with zero configuration.

The check is lexical, not interprocedural: a helper that is only ever
called under the lock must *say so* (``_locked`` suffix or decorator) —
that promise is exactly the documentation the next reader needs, so the
analyzer treating silence as a violation is a feature.

Functions nested inside a ``with`` block inherit its lock context;
callbacks stashed for later execution on another thread are therefore
invisible to this analyzer (keep handlers out of critical sections).

Module state follows the same rules with a module lock: a module-level
name declared guarded (``SEED_MODULE_GUARDED`` or a ``#: guarded_by
<lock>`` comment on its module-level assignment) may only be touched in
a function lexically inside ``with <lock>:``, or in a function named
``*_locked`` / decorated ``@assume_locked`` (the kernel build's
``ops/nvcc.py`` counts its compiler processes that way). Reads from
other modules (``nvcc.builds``) are not checked: they read a counter,
they do not update it.
"""

from __future__ import annotations

import ast
import re

from kube_batch_tpu_torch.analysis import Finding, SourceFile

# file -> class -> {guarded attr -> lock attr}. Keep entries for
# attributes whose every post-construction touch must hold the lock;
# attributes that are write-once-at-init (executor handles, config
# ints) stay out.
SEED_GUARDED: dict[str, dict[str, dict[str, str]]] = {
    "kube_batch_tpu_torch/cache/cache.py": {
        "SchedulerCache": {
            "jobs": "_mutex",
            "nodes": "_mutex",
            "queues": "_mutex",
            "priority_classes": "_mutex",
            "_default_priority_class": "_mutex",
            "_default_priority": "_mutex",
        },
        "StoreVolumeBinder": {
            "_pvs": "_lock",
            "_pvcs": "_lock",
            "_classes": "_lock",
            "_assumed": "_lock",
            "_reserved": "_lock",
        },
    },
    "kube_batch_tpu_torch/cache/store.py": {
        "ClusterStore": {
            "_kinds": "_lock",
            "_events": "_lock",
        },
    },
    "kube_batch_tpu_torch/server.py": {
        "WatchHub": {
            "_events": "_cond",
            "_seq": "_cond",
            "_dropped": "_cond",
            "_closed": "_cond",
            "_active": "_cond",
            "_journal_start": "_cond",
        },
    },
    "kube_batch_tpu_torch/recovery/journal.py": {
        "WriteIntentJournal": {
            "_outstanding": "_lock",
            "_next_seq": "_lock",
            "_confirmed_since_compact": "_lock",
            "_fh": "_lock",
        },
    },
    "kube_batch_tpu_torch/streaming.py": {
        # StreamTrigger also self-documents via `#: guarded_by`
        # annotations on its __init__ lines; the seed entry keeps the
        # streaming layer covered even if an annotation is dropped in a
        # refactor. _attached and StreamState stay out: both are
        # streaming-loop-thread-confined by design.
        "StreamTrigger": {
            "_gangs": "_lock",
            "_bound_patches": "_lock",
            "_node_patches": "_lock",
            "_arrivals": "_lock",
            "_queues": "_lock",
            "_stale": "_lock",
            "_stale_reason": "_lock",
        },
    },
    # The later threaded modules: each also self-documents via
    # `#: guarded_by` annotations on its __init__ lines — the seed
    # entries below keep KBT-L and KBT-T anchored to one declaration
    # surface even if an annotation is dropped in a refactor.
    "kube_batch_tpu_torch/admission.py": {
        "AdmissionGate": {
            "_last_tick": "_lock",
            "_inflight_keys": "_lock",
        },
    },
    "kube_batch_tpu_torch/obs/fleet.py": {
        "FleetAggregator": {
            "_last_mono": "_lock",
            "_prev_nodes": "_lock",
            "_prev_binds": "_lock",
            "_prev_binds_mono": "_lock",
            "_last_seen": "_lock",
            "_payload_cache": "_lock",
            "last": "_lock",
        },
    },
    "kube_batch_tpu_torch/pipeline.py": {
        "DispatchFence": {
            "_future": "_lock",
            "_dispatch_s": "_lock",
            "_dispatch_t0": "_lock",
            "_dispatch_t1": "_lock",
            "_overlap_fresh": "_lock",
            "last_overlap_fraction": "_lock",
            "degraded_reason": "_lock",
        },
    },
    "kube_batch_tpu_torch/federation.py": {
        "ShardSlotManager": {
            "_owned": "_lock",
            "_adoption_order": "_lock",
            "_reclaiming": "_lock",
            "_last_conflicts": "_lock",
        },
    },
    "kube_batch_tpu_torch/cache/backend.py": {
        "LoopbackBackend": {
            "_mirror": "_lock",
            "_cursor": "_lock",
            "_synced": "_lock",
            "_store_version": "_lock",
            "_last_pump_ok": "_lock",
        },
    },
    "kube_batch_tpu_torch/recovery/watch_client.py": {
        "ResilientWatcher": {
            "mirror": "_lock",
            "_rv": "_lock",
            "_last_sync": "_lock",
            "_last_relist": "_lock",
        },
    },
    # State only this package has. The class table lives on the action,
    # which in-process federation shards share, so one lock covers each
    # method; its fields also carry `#: guarded_by` annotations.
    "kube_batch_tpu_torch/ops/class_solve.py": {
        "ClassTable": {
            "key_bytes": "_lock",
            "class0_of": "_lock",
            "key_to_id": "_lock",
            "sticky_cpad": "_lock",
            "rekeys_total": "_lock",
            "splits_total": "_lock",
            "remerges_total": "_lock",
            "rebuilds": "_lock",
            "_prev_singleton": "_lock",
        },
    },
    # The encode cache's store version is bumped by informer threads under
    # the lock. Its per-thread state needs no lock: the hit/miss counts
    # live in a threading.local (`_stats`), and a node slot is replaced
    # whole, never updated, so the memo dicts stay out of this map.
    "kube_batch_tpu_torch/ops/encode_cache.py": {
        "EncodeCache": {
            "version": "_lock",
        },
    },
    "kube_batch_tpu_torch/utils/workqueue.py": {
        "RateLimitingQueue": {
            "_heap": "_cond",
            "_items": "_cond",
            "_pending": "_cond",
            "_processing": "_cond",
            "_dirty": "_cond",
            "_failures": "_cond",
            "_seq": "_cond",
            "_shutdown": "_cond",
        },
    },
}

# file -> {module-level name -> module lock}: module state whose every
# touch inside a function of that module must hold the lock.
SEED_MODULE_GUARDED: dict[str, dict[str, str]] = {
    # the kernel build: one lock, and a count of compiler processes that
    # a smoke reads around its warm phases (zero builds when warm)
    "kube_batch_tpu_torch/ops/nvcc.py": {
        "builds": "_LOCK",
    },
}

_ANNOT_RE = re.compile(r"#:\s*guarded_by\s+(?P<lock>[A-Za-z_][A-Za-z0-9_]*)")
_SELF_ATTR_RE = re.compile(r"self\.(?P<attr>[A-Za-z_][A-Za-z0-9_]*)")

_EXEMPT_METHODS = ("__init__", "__del__")


def _annotated_guards(sf: SourceFile) -> dict[str, dict[str, str]]:
    """class -> {attr -> lock} from `#: guarded_by <lock>` comments."""
    line_guard: dict[int, str] = {}
    for i, line in enumerate(sf.lines, 1):
        m = _ANNOT_RE.search(line)
        if m:
            line_guard[i] = m.group("lock")
    if not line_guard:
        return {}
    out: dict[str, dict[str, str]] = {}
    for cls in ast.walk(sf.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        for node in ast.walk(cls):
            if not isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                continue
            lock = line_guard.get(node.lineno)
            if lock is None:
                continue
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    out.setdefault(cls.name, {})[t.attr] = lock
    return out


def _module_annotated_guards(sf: SourceFile) -> dict[str, str]:
    """{module-level name -> lock} from `#: guarded_by <lock>` comments on
    module-level assignments."""
    out: dict[str, str] = {}
    if not isinstance(sf.tree, ast.Module):
        return out
    lines = sf.lines
    for node in sf.tree.body:
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        if not 0 < node.lineno <= len(lines):
            continue
        m = _ANNOT_RE.search(lines[node.lineno - 1])
        if m is None:
            continue
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for t in targets:
            if isinstance(t, ast.Name):
                out[t.id] = m.group("lock")
    return out


def _module_locks(tree: ast.AST) -> set[str]:
    """Module-level names assigned a threading lock/condition."""
    locks: set[str] = set()
    for node in tree.body if isinstance(tree, ast.Module) else []:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            fn = node.value.func
            name = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else ""
            )
            if name in ("Lock", "RLock", "Condition"):
                locks.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return locks


def _local_names(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> set[str]:
    """Names a function binds locally (its parameters and assignments,
    minus those it declares ``global``); nested defs are not entered."""
    declared_global: set[str] = set()
    bound: set[str] = set()
    a = fn.args
    for p in a.posonlyargs + a.args + a.kwonlyargs + [a.vararg, a.kwarg]:
        if p is not None:
            bound.add(p.arg)
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Global):
            declared_global.update(node.names)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, (ast.Store, ast.Del)):
            bound.add(node.id)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))
    return bound - declared_global


class _ModuleFunctionChecker(ast.NodeVisitor):
    """Walk one function tracking the module locks lexically held; flag
    touches of guarded module names outside them."""

    def __init__(self, sf: SourceFile, qual: str, fn, guards: dict[str, str],
                 findings: list[Finding], held: list[str]) -> None:
        self.sf = sf
        self.qual = qual
        self.guards = {k: v for k, v in guards.items() if k not in _local_names(fn)}
        self.findings = findings
        self.held = list(held)
        self.reported: set[tuple[int, str]] = set()

    def visit_With(self, node: ast.With) -> None:
        for item in node.items:
            self.visit(item.context_expr)
        acquired = [
            item.context_expr.id for item in node.items
            if isinstance(item.context_expr, ast.Name)
            and item.context_expr.id in self.guards.values()
        ]
        self.held.extend(acquired)
        for item in node.items:
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self.held.pop()

    def visit_FunctionDef(self, node) -> None:
        _check_module_function(self.sf, f"{self.qual}.{node.name}", node,
                               self.guards, self.findings, self.held)

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_Name(self, node: ast.Name) -> None:
        lock = self.guards.get(node.id)
        if lock is None or lock in self.held:
            return
        key = (node.lineno, node.id)
        lines = self.sf.lines
        if key in self.reported or (0 < node.lineno <= len(lines) and "noqa" in lines[node.lineno - 1]):
            return
        self.reported.add(key)
        self.findings.append(
            Finding(
                self.sf.path, node.lineno, "KBT-L001",
                f"module state {node.id} is guarded by {lock} but touched in "
                f"{self.qual} without it (wrap in `with {lock}:`, or name the "
                "function *_locked / mark it @assume_locked if every caller "
                "holds it)",
                symbol=f"{self.qual}.{node.id}",
            )
        )


def _check_module_function(sf, qual, fn, guards, findings, held) -> None:
    if fn.name.endswith("_locked") or _is_assume_locked(fn):
        return
    checker = _ModuleFunctionChecker(sf, qual, fn, guards, findings, held)
    for stmt in fn.body:
        checker.visit(stmt)


def _analyze_module_state(sf: SourceFile, findings: list[Finding]) -> None:
    guards = dict(SEED_MODULE_GUARDED.get(sf.path, {}))
    guards.update(_module_annotated_guards(sf))
    if not guards or not isinstance(sf.tree, ast.Module):
        return
    locks = _module_locks(sf.tree)
    for name, lock in sorted(guards.items()):
        if lock not in locks:
            findings.append(
                Finding(
                    sf.path, 1, "KBT-L002",
                    f"module state {name} declared guarded by {lock}, but no "
                    f"threading.Lock/RLock/Condition is assigned to {lock} at "
                    "module level",
                    symbol=f"<module>.{name}",
                )
            )
    for node in sf.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _check_module_function(sf, node.name, node, guards, findings, [])
        elif isinstance(node, ast.ClassDef):
            for meth in node.body:
                if isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    _check_module_function(sf, f"{node.name}.{meth.name}", meth,
                                           guards, findings, [])


def _class_locks(cls: ast.ClassDef) -> set[str]:
    """Attrs assigned a threading lock/condition anywhere in the class."""
    locks: set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            fn = node.value.func
            name = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else ""
            )
            if name in ("Lock", "RLock", "Condition"):
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        locks.add(t.attr)
    return locks


def _is_assume_locked(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> bool:
    for dec in fn.decorator_list:
        d = dec.func if isinstance(dec, ast.Call) else dec
        name = d.attr if isinstance(d, ast.Attribute) else (
            d.id if isinstance(d, ast.Name) else ""
        )
        if name == "assume_locked":
            return True
    return False


class _MethodChecker(ast.NodeVisitor):
    """Walk one method body tracking the set of locks lexically held."""

    def __init__(
        self,
        sf: SourceFile,
        cls: str,
        method: str,
        guards: dict[str, str],
        findings: list[Finding],
    ) -> None:
        self.sf = sf
        self.cls = cls
        self.method = method
        self.guards = guards
        self.findings = findings
        self.held: list[str] = []
        self.reported: set[tuple[int, str]] = set()

    def _with_locks(self, node: ast.With) -> list[str]:
        acquired = []
        for item in node.items:
            e = item.context_expr
            if (
                isinstance(e, ast.Attribute)
                and isinstance(e.value, ast.Name)
                and e.value.id == "self"
                and e.attr in self.guards.values()
            ):
                acquired.append(e.attr)
        return acquired

    def visit_With(self, node: ast.With) -> None:
        # context expressions evaluate before the locks are held
        for item in node.items:
            self.visit(item.context_expr)
        acquired = self._with_locks(node)
        self.held.extend(acquired)
        for item in node.items:
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self.held.pop()

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            lock = self.guards.get(node.attr)
            if lock is not None and lock not in self.held:
                key = (node.lineno, node.attr)
                if key not in self.reported and not self._noqa(node.lineno):
                    self.reported.add(key)
                    self.findings.append(
                        Finding(
                            self.sf.path,
                            node.lineno,
                            "KBT-L001",
                            f"self.{node.attr} is guarded by self.{lock} but "
                            f"accessed in {self.cls}.{self.method} without it "
                            "(wrap in `with`, or mark the method _locked/"
                            "@assume_locked if every caller holds it)",
                            symbol=f"{self.cls}.{self.method}.{node.attr}",
                        )
                    )
        self.generic_visit(node)

    def _noqa(self, lineno: int) -> bool:
        lines = self.sf.lines
        return 0 < lineno <= len(lines) and "noqa" in lines[lineno - 1]


def analyze(files: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for sf in files:
        _analyze_module_state(sf, findings)
        seed = SEED_GUARDED.get(sf.path, {})
        annotated = _annotated_guards(sf)
        if not seed and not annotated:
            continue
        for cls in sf.tree.body if isinstance(sf.tree, ast.Module) else []:
            if not isinstance(cls, ast.ClassDef):
                continue
            guards = dict(seed.get(cls.name, {}))
            guards.update(annotated.get(cls.name, {}))
            if not guards:
                continue
            locks = _class_locks(cls)
            for attr, lock in sorted(guards.items()):
                if lock not in locks:
                    findings.append(
                        Finding(
                            sf.path,
                            cls.lineno,
                            "KBT-L002",
                            f"{cls.name}.{attr} declared guarded by "
                            f"self.{lock}, but no threading.Lock/RLock/"
                            f"Condition is ever assigned to self.{lock} "
                            "in this class",
                            symbol=f"{cls.name}.{attr}",
                        )
                    )
            for meth in cls.body:
                if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if meth.name in _EXEMPT_METHODS or meth.name.endswith("_locked"):
                    continue
                if _is_assume_locked(meth):
                    continue
                checker = _MethodChecker(sf, cls.name, meth.name, guards, findings)
                for stmt in meth.body:
                    checker.visit(stmt)
    return findings


def explain_convention() -> str:
    """One paragraph for docs/--explain surfaces."""
    return (
        "Declare guards with `#: guarded_by <lock>` on the attribute's "
        "__init__ assignment line, or on a module-level assignment for "
        "module state (or the seed maps for pre-existing layers). Access "
        "them only inside `with self.<lock>` / `with <lock>`; helpers "
        "called with the lock held are named *_locked or decorated "
        "@assume_locked (kube_batch_tpu_torch.utils.locking)."
    )
