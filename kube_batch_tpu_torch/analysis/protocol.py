"""A6 — protocol-lifecycle analyzer (KBT-C001..C005).

The suite's other analyzers check *where* state is touched (locks,
snapshots, registries); this one checks *in what order*. Five core
protocols run through this codebase, each a small lifecycle state
machine declared in :data:`MACHINES` below (the runbook table renders
from the same structure):

- **Session**: ``open_session``/``open_micro_session`` must reach
  ``close_session`` — close is where status write-back and the
  mutation-detector hand-off happen, so a dropped session silently
  swallows a whole cycle's decisions.
- **Statement**: ``statement_factory(ssn)`` / ``ssn.statement()`` /
  ``Statement(ssn)`` must reach ``commit()`` or ``discard()`` on every
  exit path — an open statement's operations neither replay to the
  cache nor roll back, which is exactly the gang-atomicity hole the
  Statement exists to close.
- **Journal**: an ``append_intents``/``_journal_intents`` call must be
  followed by a dispatch (``_submit_write``/``_do_*``) or a confirm on
  every path, and a module that appends must also confirm somewhere
  (``recovery/`` is exempt in the confirm-only direction: takeover
  confirms orphans it did not append).
- **Circuit breaker**: tier transitions happen only through
  ``CircuitBreaker._transition`` inside ``faults/ladder.py``, and only
  between the declared states (closed/half_open/open).
- **StreamState**: after ``invalidate()`` the resident node table must
  not be read (``.nodes`` / ``apply_node_patches``) until
  ``adopt_full_cycle`` re-harvests it — a stale read is a solve
  against capacity that no longer exists.

The path engine is branch-sensitive and structural, not symbolic: it
walks every structurally distinguishable path through a function
(``if`` both ways, loop bodies once with an explicit iteration-end
check, ``try``/``finally`` threaded through every exit, ``return``/
``raise``/``break``/``continue`` as path exits). Conditions are not
evaluated — a path that your invariants make impossible still needs
the commit/discard on it, because the next refactor will make it
possible. Resources that *escape* (returned, aliased, stored on an
object) transfer ownership and stop being checked; passing a resource
as a call argument does **not** escape it (helpers operate on a
statement, the creator still owns the close).

Listener hygiene (KBT-C005) is lexical: a registration call
(``add_store_listener`` / ``.attach()``) is safe only when the paired
remove sits in a ``finally`` whose ``try`` starts at or immediately
after the registration, or when the enclosing class pairs it in a
teardown method (``detach``/``stop``/``close``/...). "Immediately"
is the point: one statement between register and ``try`` is one
exception away from a leaked listener that keeps waking a dead loop.
"""

from __future__ import annotations

import ast
from typing import Optional

from kube_batch_tpu_torch.analysis import Finding, SourceFile

__all__ = ["MACHINES", "analyze"]

# The five declared lifecycle machines. ``states``/``edges`` document
# the protocol (and feed the runbook table); the remaining keys are the
# call-name alphabets the checker drives off, so the declaration *is*
# the configuration.
MACHINES: dict[str, dict] = {
    "session": {
        "title": "Session: open -> ... -> close_session",
        "states": ("open", "closed"),
        "edges": (("open", "close_session", "closed"),),
        "create": ("open_session", "open_micro_session"),
        "close_fn": ("close_session",),
        "code": "KBT-C001",
    },
    "statement": {
        "title": "Statement: operate -> commit | discard",
        "states": ("open", "committed", "discarded"),
        "edges": (("open", "commit", "committed"), ("open", "discard", "discarded")),
        "create": ("statement_factory",),
        "create_method": ("statement",),
        "create_class_suffix": "Statement",
        "close": ("commit", "discard"),
        "code": "KBT-C001",
    },
    "journal": {
        "title": "Write-intent journal: append -> dispatch -> confirm",
        "states": ("appended", "dispatched", "confirmed"),
        "edges": (
            ("appended", "dispatch", "dispatched"),
            ("dispatched", "confirm", "confirmed"),
            ("appended", "confirm", "confirmed"),  # landed-before-takeover
        ),
        "append": ("append_intents", "_journal_intents"),
        "dispatch": ("_submit_write", "_do_bind", "_do_bind_many", "_do_evict"),
        "confirm": ("confirm", "_journal_confirm"),
        "code": "KBT-C003",
    },
    "breaker": {
        "title": "Circuit breaker: closed -> open -> half_open -> closed",
        "states": ("closed", "open", "half_open"),
        "edges": (
            ("closed", "trip", "open"),
            ("open", "probe", "half_open"),
            ("half_open", "success", "closed"),
            ("half_open", "failure", "open"),
            ("open", "reset", "closed"),
            ("half_open", "reset", "closed"),
        ),
        "state_names": ("CLOSED", "OPEN", "HALF_OPEN"),
        "owner": "kube_batch_tpu_torch/faults/ladder.py",
        "transition": "_transition",
        "code": "KBT-C002",
    },
    "stream_state": {
        "title": "StreamState: harvest -> patch -> invalidate -> re-harvest",
        "states": ("valid", "invalid"),
        "edges": (
            ("valid", "apply_node_patches", "valid"),
            ("valid", "invalidate", "invalid"),
            ("invalid", "adopt_full_cycle", "valid"),
        ),
        "invalidate": ("invalidate",),
        "reharvest": ("adopt_full_cycle",),
        "read_attrs": ("nodes",),
        "read_methods": ("apply_node_patches",),
        "code": "KBT-C004",
    },
}

# Cache dispatch (KBT-C002, Statement side): .bind/.bind_many/.evict on
# a receiver spelled `cache`/`_cache` is the raw mirror write the
# Statement/session layer exists to mediate. Only these files own it.
_DISPATCH_METHODS = ("bind", "bind_many", "evict")
_DISPATCH_RECEIVERS = ("cache", "_cache")
_DISPATCH_OWNERS = frozenset(
    {
        "kube_batch_tpu_torch/framework/session.py",
        "kube_batch_tpu_torch/framework/statement.py",
        "kube_batch_tpu_torch/cache/cache.py",
    }
)

# Listener hygiene (KBT-C005).
_LISTENER_PAIRS = {"add_store_listener": "remove_store_listener", "attach": "detach"}
_TEARDOWN_METHODS = ("detach", "stop", "close", "shutdown", "unsubscribe", "__exit__")

# Modules exempt from the confirm-without-append direction of KBT-C003:
# takeover reconciliation confirms intents a dead leader appended.
_CONFIRM_EXEMPT_PREFIX = "kube_batch_tpu_torch/recovery/"


def _terminal_name(fn: ast.expr) -> str:
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


# -- path engine --------------------------------------------------------------

_FALL, _RETURN, _RAISE, _BREAK, _CONTINUE = "fall", "return", "raise", "break", "continue"
_FN_EXITS = (_FALL, _RETURN, _RAISE)


class _PathEngine:
    """Walk one function body over every structurally distinguishable
    path. Semantics objects supply the transfer functions; the engine
    owns branching, loops (body once + iteration-end hook), try/finally
    threading, and path dedup (capped, so pathological functions
    degrade to fewer paths instead of exploding)."""

    MAX_PATHS = 256

    def __init__(self, sem: "_Semantics") -> None:
        self.sem = sem
        sem.engine = self
        self.loop_stack: list[int] = []

    def run(self, fn: ast.FunctionDef | ast.AsyncFunctionDef) -> None:
        for kind, st in self._block(fn.body, self.sem.initial()):
            if kind in _FN_EXITS:
                self.sem.at_exit(kind, st)

    def _block(self, stmts: list[ast.stmt], state: dict) -> list[tuple[str, dict]]:
        paths = [(_FALL, state)]
        for stmt in stmts:
            nxt: list[tuple[str, dict]] = []
            for kind, st in paths:
                if kind != _FALL:
                    nxt.append((kind, st))
                else:
                    nxt.extend(self._stmt(stmt, st))
            paths = self._dedupe(nxt)
        return paths

    def _dedupe(self, paths: list[tuple[str, dict]]) -> list[tuple[str, dict]]:
        seen: set = set()
        out: list[tuple[str, dict]] = []
        for kind, st in paths:
            key = (kind, tuple(sorted(st.items())))
            if key not in seen:
                seen.add(key)
                out.append((kind, st))
        return out[: self.MAX_PATHS]

    def _stmt(self, stmt: ast.stmt, st: dict) -> list[tuple[str, dict]]:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return [(_FALL, st)]  # nested defs run later, elsewhere
        if isinstance(stmt, ast.If):
            s2 = self.sem.visit_expr(stmt.test, st)
            return self._dedupe(
                self._block(stmt.body, dict(s2)) + self._block(stmt.orelse, dict(s2))
            )
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            return self._loop(stmt, st)
        if isinstance(stmt, ast.Try):
            return self._try(stmt, st)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                st = self.sem.visit_expr(item.context_expr, st)
            return self._block(stmt.body, st)
        if isinstance(stmt, ast.Return):
            return [(_RETURN, self.sem.on_return(stmt.value, st))]
        if isinstance(stmt, ast.Raise):
            if stmt.exc is not None:
                st = self.sem.visit_expr(stmt.exc, st)
            return [(_RAISE, st)]
        if isinstance(stmt, ast.Break):
            return [(_BREAK, st)]
        if isinstance(stmt, ast.Continue):
            return [(_CONTINUE, st)]
        return [(_FALL, self.sem.visit_stmt(stmt, st))]

    def _loop(self, stmt, st: dict) -> list[tuple[str, dict]]:
        head = stmt.test if isinstance(stmt, ast.While) else stmt.iter
        st = self.sem.visit_expr(head, st)
        out: list[tuple[str, dict]] = [(_FALL, dict(st))]  # zero iterations
        self.loop_stack.append(id(stmt))
        body = self._block(stmt.body, dict(st))
        self.loop_stack.pop()
        for kind, s in body:
            if kind in (_FALL, _CONTINUE):
                # the next iteration (or loop end) is about to rebind /
                # drop everything created in this body
                out.append((_FALL, self.sem.iteration_end(stmt, s)))
            elif kind == _BREAK:
                out.append((_FALL, s))
            else:
                out.append((kind, s))
        if stmt.orelse:
            nxt: list[tuple[str, dict]] = []
            for kind, s in out:
                if kind == _FALL:
                    nxt.extend(self._block(stmt.orelse, dict(s)))
                else:
                    nxt.append((kind, s))
            out = nxt
        return self._dedupe(out)

    def _try(self, stmt: ast.Try, st: dict) -> list[tuple[str, dict]]:
        entry = dict(st)
        body = self._block(stmt.body, dict(st))
        outs: list[tuple[str, dict]] = []
        if stmt.handlers:
            # a RAISE inside the body lands in a handler instead of
            # escaping; the handler may fire before any body effect, so
            # it runs from the entry state (conservative)
            outs.extend(e for e in body if e[0] != _RAISE)
            for h in stmt.handlers:
                outs.extend(self._block(h.body, dict(entry)))
        else:
            outs.extend(body)
        if stmt.orelse:
            nxt: list[tuple[str, dict]] = []
            for kind, s in outs:
                if kind == _FALL:
                    nxt.extend(self._block(stmt.orelse, dict(s)))
                else:
                    nxt.append((kind, s))
            outs = nxt
        if stmt.finalbody:
            nxt = []
            for kind, s in outs:
                for fk, fs in self._block(stmt.finalbody, dict(s)):
                    nxt.append((fk if fk != _FALL else kind, fs))
            # an exception part-way through the body still runs finally:
            # model it as one raising path from the entry state
            for fk, fs in self._block(stmt.finalbody, dict(entry)):
                nxt.append((fk if fk != _FALL else _RAISE, fs))
            outs = nxt
        return self._dedupe(outs)


# -- semantics ----------------------------------------------------------------

_OPEN, _CLOSED, _ESCAPED = "open", "closed", "escaped"


class _Semantics:
    def __init__(self, sf: SourceFile, qual: str, findings: list[Finding]) -> None:
        self.sf = sf
        self.qual = qual
        self.findings = findings
        self.engine: Optional[_PathEngine] = None
        self.reported: set = set()

    def emit(self, line: int, code: str, message: str, symbol: str) -> None:
        key = (line, code, symbol)
        if key not in self.reported:
            self.reported.add(key)
            self.findings.append(Finding(self.sf.path, line, code, message, symbol))

    def initial(self) -> dict:
        return {}

    def visit_stmt(self, stmt: ast.stmt, st: dict) -> dict:
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                st = self.visit_expr(child, st)
        return st

    def visit_expr(self, expr: Optional[ast.expr], st: dict) -> dict:
        return st

    def on_return(self, value: Optional[ast.expr], st: dict) -> dict:
        return self.visit_expr(value, st) if value is not None else st

    def iteration_end(self, loop: ast.stmt, st: dict) -> dict:
        return st

    def at_exit(self, kind: str, st: dict) -> None:
        pass


class _ResourceSem(_Semantics):
    """C001 (sessions + statements): track locals bound to a created
    resource until every path closes, escapes, or leaks it."""

    _SESSION_CREATE = MACHINES["session"]["create"]
    _SESSION_CLOSE_FN = MACHINES["session"]["close_fn"]
    _STMT_CREATE = MACHINES["statement"]["create"]
    _STMT_CREATE_METHOD = MACHINES["statement"]["create_method"]
    _STMT_SUFFIX = MACHINES["statement"]["create_class_suffix"]
    _STMT_CLOSE = MACHINES["statement"]["close"]

    def _creation_kind(self, call: ast.Call) -> Optional[str]:
        name = _terminal_name(call.func)
        if name in self._SESSION_CREATE:
            return "session"
        if name in self._STMT_CREATE:
            return "statement"
        if isinstance(call.func, ast.Attribute) and name in self._STMT_CREATE_METHOD:
            return "statement"
        if name.endswith(self._STMT_SUFFIX) and not name.startswith("_"):
            # public Statement classes (Statement, ScanStatement, ...);
            # underscore variants (e.g. recovery's _GangStatement) follow
            # the journal machine's eager-idempotent protocol instead
            return "statement"
        return None

    def visit_stmt(self, stmt: ast.stmt, st: dict) -> dict:
        if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
            kind = self._creation_kind(stmt.value)
            if kind is not None and len(stmt.targets) == 1 and isinstance(
                stmt.targets[0], ast.Name
            ):
                st = dict(st)
                for a in stmt.value.args:
                    st = self.visit_expr(a, st)
                for k in stmt.value.keywords:
                    st = self.visit_expr(k.value, st)
                var = stmt.targets[0].id
                prev = st.get(var)
                if prev is not None and prev[0] == _OPEN:
                    self._leak(var, prev, "re-assigned")
                loop = self.engine.loop_stack[-1] if self.engine.loop_stack else 0
                st[var] = (_OPEN, kind, stmt.lineno, loop)
                return st
        if isinstance(stmt, ast.Assign):
            st = self.visit_expr(stmt.value, st)
            st = dict(st)
            for t in stmt.targets:
                if isinstance(t, ast.Name) and t.id in st:
                    prev = st.pop(t.id)
                    if prev[0] == _OPEN:
                        self._leak(t.id, prev, "overwritten")
                else:
                    st = self.visit_expr(t, st)
            return st
        return super().visit_stmt(stmt, st)

    def visit_expr(self, expr: Optional[ast.expr], st: dict) -> dict:
        if expr is None:
            return st
        st = dict(st)
        self._walk(expr, st, escape_args=False)
        return st

    def on_return(self, value: Optional[ast.expr], st: dict) -> dict:
        if value is None:
            return st
        st = dict(st)
        # returning hands the resource (or anything holding it) out:
        # ownership transfers, the caller closes
        self._walk(value, st, escape_args=True)
        return st

    def _walk(self, node: ast.expr, st: dict, escape_args: bool) -> None:
        if isinstance(node, ast.Lambda):
            return  # deferred body, not this path
        if isinstance(node, ast.Call):
            name = _terminal_name(node.func)
            # close_session(var, ...) closes its first argument
            if (
                name in self._SESSION_CLOSE_FN
                and node.args
                and isinstance(node.args[0], ast.Name)
                and node.args[0].id in st
            ):
                v = node.args[0].id
                if st[v][0] == _OPEN:
                    st[v] = (_CLOSED,) + st[v][1:]
                rest = node.args[1:]
            else:
                rest = node.args
                fn = node.func
                if (
                    isinstance(fn, ast.Attribute)
                    and isinstance(fn.value, ast.Name)
                    and fn.value.id in st
                ):
                    # a method call on the resource: commit/discard close
                    # it, anything else (operate/pipeline/evict) is the
                    # protocol's operate phase — receiver stays owned
                    if fn.attr in self._STMT_CLOSE and st[fn.value.id][0] == _OPEN:
                        st[fn.value.id] = (_CLOSED,) + st[fn.value.id][1:]
                else:
                    self._walk(node.func, st, escape_args)
            for a in rest:
                if isinstance(a, ast.Name) and a.id in st and not escape_args:
                    continue  # pass-by-arg: the helper borrows, caller owns
                self._walk(a, st, escape_args)
            for k in node.keywords:
                if (
                    isinstance(k.value, ast.Name)
                    and k.value.id in st
                    and not escape_args
                ):
                    continue
                self._walk(k.value, st, escape_args)
            return
        if isinstance(node, ast.Name):
            if node.id in st and isinstance(node.ctx, ast.Load):
                st[node.id] = (_ESCAPED,) + st[node.id][1:]
            return
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) and node.value.id in st:
                return  # plain attribute read on the resource: neutral
            self._walk(node.value, st, escape_args)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._walk(child, st, escape_args)
            elif isinstance(child, ast.keyword):
                self._walk(child.value, st, escape_args)
            elif isinstance(child, ast.comprehension):
                self._walk(child.iter, st, escape_args)
                for c in child.ifs:
                    self._walk(c, st, escape_args)

    def _leak(self, var: str, rec: tuple, how: str) -> None:
        _, kind, line, _ = rec
        if kind == "session":
            msg = (
                f"session opened into `{var}` here is {how} before "
                "close_session() — status write-back and resident-table "
                "hand-off are silently dropped"
            )
        else:
            msg = (
                f"Statement created into `{var}` here is {how} before "
                "commit()/discard() — its operations neither replay to "
                "the cache nor roll back"
            )
        self.emit(line, "KBT-C001", msg, f"{self.qual}.{var}")

    def iteration_end(self, loop: ast.stmt, st: dict) -> dict:
        st = dict(st)
        lid = id(loop)
        for var, rec in list(st.items()):
            if rec[0] == _OPEN and rec[3] == lid:
                self._leak(var, rec, "dropped at the end of the loop iteration")
                st[var] = (_CLOSED,) + rec[1:]  # report once
        return st

    def at_exit(self, kind: str, st: dict) -> None:
        how = {
            _FALL: "can reach the end of the function",
            _RETURN: "can reach a return",
            _RAISE: "can reach a raise",
        }[kind]
        for var, rec in sorted(st.items()):
            if rec[0] != _OPEN:
                continue
            _, rkind, line, _ = rec
            if rkind == "session":
                msg = (
                    f"session opened into `{var}` here {how} without "
                    "close_session() on that path"
                )
            else:
                msg = (
                    f"Statement created into `{var}` here {how} without "
                    "commit()/discard() on that path"
                )
            self.emit(line, "KBT-C001", msg, f"{self.qual}.{var}")


class _JournalSem(_Semantics):
    """C003 path direction: an append must reach a dispatch or confirm
    on every path out of the appending function (returning the seqs
    hands them to the caller and transfers the obligation)."""

    _APPEND = MACHINES["journal"]["append"]
    _CLOSERS = MACHINES["journal"]["dispatch"] + MACHINES["journal"]["confirm"]

    def visit_stmt(self, stmt: ast.stmt, st: dict) -> dict:
        call = None
        var = None
        if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
            call = stmt.value
            if len(stmt.targets) == 1 and isinstance(stmt.targets[0], ast.Name):
                var = stmt.targets[0].id
        elif isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            call = stmt.value
        if call is not None and _terminal_name(call.func) in self._APPEND:
            st = dict(st)
            key = var if var is not None else f"@{stmt.lineno}"
            st[key] = (_OPEN, stmt.lineno)
            return st
        return super().visit_stmt(stmt, st)

    def visit_expr(self, expr: Optional[ast.expr], st: dict) -> dict:
        if expr is None:
            return st
        st = dict(st)
        for node in ast.walk(expr):
            if isinstance(node, ast.Call) and _terminal_name(node.func) in self._CLOSERS:
                for k, rec in list(st.items()):
                    if rec[0] == _OPEN:
                        st[k] = (_CLOSED, rec[1])
        return st

    def on_return(self, value: Optional[ast.expr], st: dict) -> dict:
        st = self.visit_expr(value, st) if value is not None else dict(st)
        if value is not None:
            names = {
                n.id for n in ast.walk(value) if isinstance(n, ast.Name)
            }
            for k, rec in list(st.items()):
                if k in names and rec[0] == _OPEN:
                    st[k] = (_ESCAPED, rec[1])
        return st

    def at_exit(self, kind: str, st: dict) -> None:
        for k, rec in sorted(st.items()):
            if rec[0] != _OPEN:
                continue
            self.emit(
                rec[1],
                "KBT-C003",
                "journal intent appended here can exit the function "
                "without a dispatch (_submit_write/_do_*) or confirm on "
                "that path — an orphan the next takeover re-litigates",
                f"{self.qual}.append",
            )


class _StreamStateSem(_Semantics):
    """C004: a receiver that was invalidate()d on this path must not
    serve .nodes / apply_node_patches until adopt_full_cycle."""

    _INVALIDATE = MACHINES["stream_state"]["invalidate"]
    _REHARVEST = MACHINES["stream_state"]["reharvest"]
    _READ_ATTRS = MACHINES["stream_state"]["read_attrs"]
    _READ_METHODS = MACHINES["stream_state"]["read_methods"]

    @staticmethod
    def _receiver_key(obj: ast.expr) -> Optional[str]:
        # Names and self-attributes only: deeper chains churn too much
        # to track soundly and never appear in the streaming layer.
        if isinstance(obj, ast.Name):
            return obj.id
        if (
            isinstance(obj, ast.Attribute)
            and isinstance(obj.value, ast.Name)
            and obj.value.id == "self"
        ):
            return f"self.{obj.attr}"
        return None

    def visit_expr(self, expr: Optional[ast.expr], st: dict) -> dict:
        if expr is None:
            return st
        st = dict(st)
        for node in ast.walk(expr):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                key = self._receiver_key(node.func.value)
                if key is None:
                    continue
                if node.func.attr in self._INVALIDATE:
                    st[key] = ("stale", node.lineno)
                elif node.func.attr in self._REHARVEST:
                    st.pop(key, None)
                elif node.func.attr in self._READ_METHODS and key in st:
                    self._stale_read(node, key, st[key], node.func.attr + "()")
            elif (
                isinstance(node, ast.Attribute)
                and node.attr in self._READ_ATTRS
                and isinstance(node.ctx, ast.Load)
            ):
                key = self._receiver_key(node.value)
                if key is not None and key in st:
                    self._stale_read(node, key, st[key], "." + node.attr)
        return st

    def _stale_read(self, node: ast.expr, key: str, rec: tuple, what: str) -> None:
        self.emit(
            node.lineno,
            "KBT-C004",
            f"resident table of `{key}` read via {what} after "
            f"invalidate() on line {rec[1]} with no adopt_full_cycle "
            "re-harvest in between — a solve against capacity that no "
            "longer exists",
            f"{self.qual}.{key}",
        )


# -- non-path checks ----------------------------------------------------------


def _check_dispatch_scope(sf: SourceFile, findings: list[Finding]) -> None:
    """C002, cache side: raw mirror writes outside the owning layer."""
    if sf.path in _DISPATCH_OWNERS:
        return
    for node in ast.walk(sf.tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        if node.func.attr not in _DISPATCH_METHODS:
            continue
        recv = node.func.value
        recv_name = (
            recv.id if isinstance(recv, ast.Name)
            else recv.attr if isinstance(recv, ast.Attribute)
            else ""
        )
        if recv_name in _DISPATCH_RECEIVERS:
            findings.append(
                Finding(
                    sf.path,
                    node.lineno,
                    "KBT-C002",
                    f"cache.{node.func.attr}() called outside the "
                    "Statement/session layer — the write skips the "
                    "operation log (no gang rollback) and the share "
                    "event handlers",
                    symbol=f"cache.{node.func.attr}",
                )
            )


def _check_breaker_scope(sf: SourceFile, findings: list[Finding]) -> None:
    """C002, breaker side: transitions only inside the owner module and
    only between declared states."""
    m = MACHINES["breaker"]
    for node in ast.walk(sf.tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        if node.func.attr != m["transition"]:
            continue
        if sf.path != m["owner"]:
            findings.append(
                Finding(
                    sf.path,
                    node.lineno,
                    "KBT-C002",
                    f"breaker {m['transition']}() called outside "
                    f"{m['owner']} — tier state changes bypass the "
                    "ladder's lock/backoff discipline",
                    symbol=f"breaker.{m['transition']}",
                )
            )
            continue
        arg = node.args[0] if node.args else None
        bad = None
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            if arg.value not in m["states"]:
                bad = f"state literal {arg.value!r}"
        elif isinstance(arg, ast.Name) and arg.id not in m["state_names"]:
            bad = f"state name `{arg.id}`"
        if bad is not None:
            findings.append(
                Finding(
                    sf.path,
                    node.lineno,
                    "KBT-C002",
                    f"breaker transition to {bad} is outside the "
                    f"declared alphabet {m['states']}",
                    symbol="breaker.alphabet",
                )
            )


def _calls_in(node: ast.AST) -> set[str]:
    return {
        _terminal_name(c.func)
        for c in ast.walk(node)
        if isinstance(c, ast.Call)
    }


def _check_listeners(sf: SourceFile, findings: list[Finding]) -> None:
    """C005: every registration needs its remove on the teardown path —
    a finally whose try starts at or immediately after the
    registration, or a paired class teardown method."""
    for holder, cls in _functions(sf.tree):
        for fn in holder:
            regs: list[tuple[ast.Call, str]] = []
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    name = _terminal_name(node.func)
                    if name in _LISTENER_PAIRS:
                        regs.append((node, _LISTENER_PAIRS[name]))
            if not regs:
                continue
            protected: dict[str, set[int]] = {}
            _protected_lines(fn.body, protected)
            teardown_removes: set[str] = set()
            if cls is not None:
                for meth in cls.body:
                    if (
                        isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and meth.name in _TEARDOWN_METHODS
                    ):
                        teardown_removes |= _calls_in(meth)
            for call, remove in regs:
                if call.lineno in protected.get(remove, set()):
                    continue
                if remove in teardown_removes:
                    continue
                reg = _terminal_name(call.func)
                findings.append(
                    Finding(
                        sf.path,
                        call.lineno,
                        "KBT-C005",
                        f"{reg}() registered with no {remove}() on the "
                        "teardown path (needs a finally starting at or "
                        "immediately after the registration, or a paired "
                        f"{'/'.join(_TEARDOWN_METHODS[:3])} method on the "
                        "class) — the dead listener keeps firing into a "
                        "stopped loop",
                        symbol=f"{_qual(cls, fn)}.{reg}",
                    )
                )


def _protected_lines(stmts: list[ast.stmt], out: dict[str, set[int]]) -> None:
    """remove-name -> line numbers whose registration is covered by a
    finally containing that remove: the try body plus the single
    statement immediately preceding the try."""
    for i, s in enumerate(stmts):
        if isinstance(s, ast.Try) and s.finalbody:
            removes = set()
            for fb in s.finalbody:
                removes |= _calls_in(fb)
            region: set[int] = set()
            for b in s.body:
                region.update(range(b.lineno, (b.end_lineno or b.lineno) + 1))
            if i > 0:
                prev = stmts[i - 1]
                region.update(range(prev.lineno, (prev.end_lineno or prev.lineno) + 1))
            for r in removes:
                out.setdefault(r, set()).update(region)
        for attr in ("body", "orelse", "finalbody"):
            sub = getattr(s, attr, None)
            if isinstance(sub, list) and sub and isinstance(sub[0], ast.stmt):
                _protected_lines(sub, out)
        for h in getattr(s, "handlers", []) or []:
            _protected_lines(h.body, out)


def _check_journal_module(sf: SourceFile, findings: list[Finding]) -> None:
    """C003 module direction: appends and confirms must co-exist."""
    m = MACHINES["journal"]
    appends: list[ast.Call] = []
    confirms: list[ast.Call] = []
    dispatches = 0
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _terminal_name(node.func)
        if name in m["append"]:
            appends.append(node)
        elif name in m["confirm"]:
            confirms.append(node)
        elif name in m["dispatch"]:
            dispatches += 1
    exempt = sf.path.startswith(_CONFIRM_EXEMPT_PREFIX)
    if appends and not confirms and not dispatches and not exempt:
        findings.append(
            Finding(
                sf.path,
                appends[0].lineno,
                "KBT-C003",
                "module appends journal intents but never dispatches or "
                "confirms — every intent it writes is an orphan",
                symbol="journal.append_only",
            )
        )
    if confirms and not appends and not exempt:
        findings.append(
            Finding(
                sf.path,
                confirms[0].lineno,
                "KBT-C003",
                "module confirms journal intents it never appends — "
                "outside recovery/ (takeover confirms a dead leader's "
                "intents) that is a sequencing inversion",
                symbol="journal.confirm_only",
            )
        )


# -- the analyzer's entry ------------------------------------------------------


def _functions(tree: ast.AST):
    """Yield (functions, owning class-or-None) at module level and one
    class level deep — the whole codebase's shape."""
    mod_fns = [
        n for n in getattr(tree, "body", [])
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]
    if mod_fns:
        yield mod_fns, None
    for n in getattr(tree, "body", []):
        if isinstance(n, ast.ClassDef):
            meths = [
                m for m in n.body
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
            ]
            if meths:
                yield meths, n


def _qual(cls: Optional[ast.ClassDef], fn) -> str:
    return f"{cls.name}.{fn.name}" if cls is not None else fn.name


def analyze(files: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for sf in files:
        _check_dispatch_scope(sf, findings)
        _check_breaker_scope(sf, findings)
        _check_listeners(sf, findings)
        _check_journal_module(sf, findings)
        for holder, cls in _functions(sf.tree):
            for fn in holder:
                qual = _qual(cls, fn)
                for sem_cls in (_ResourceSem, _JournalSem, _StreamStateSem):
                    sem = sem_cls(sf, qual, findings)
                    _PathEngine(sem).run(fn)
    return findings
