"""A2 — torch hazard analyzer (KBT-J001..J004).

Torch has no jit scope: the card's solve runs as host Python around
hand-written kernels. The scope of J001-J003 is therefore the functions
that a card solve entry point reaches *in its own module*, found the way
the JAX package's analyzer finds jit roots and their call closure:

- the entry points are ``ENTRY_POINTS`` below (a dotted name: a
  module-level function, ``Class.method``, or a class, meaning all of its
  methods), plus any def whose line carries a ``#: card_entry`` comment;
- a function is reached when an entry calls it by name (``helper()``) or
  through ``self`` (``self._step()``), transitively, in the same module;
- nested defs of a reached function are part of it;
- plain versions are out of scope: any ``*_plain`` function, and all of
  ``ops/kernels.py``. Nothing on the card's path runs them.

Checks, by code:

- **J001** a host sync inside a loop body (or a ``while`` test) of a
  reached function: ``.item()`` / ``.tolist()`` on a tensor, ``.cpu()``,
  ``.numpy()``, ``int()/float()/bool()`` on a tensor, or
  ``torch.cuda.synchronize()``. Once per solve is a fetch; once per
  iteration is a round trip per decision.
- **J002** a Python truth test (``if``/``while``/``assert``/conditional
  expression) of a tensor in a reached function: ``Tensor.__bool__``
  syncs with the card.
- **J003** a bare ``print`` in a reached function.
- **J004** runs on ``plugins/`` and ``api/`` (minus ``numerics.py``):
  raw ``np/numpy.float32|float64`` dtype literals there bypass the
  comparison-dtype policy that keeps the serial oracle bit-identical to
  the float32 kernels. Identity/equality comparisons against a dtype
  literal are exempt (``if comparison_dtype() is np.float64``).

"A tensor" is decided by a small per-function inference: parameters
annotated ``torch.Tensor``, results of ``torch.*`` calls (not
``torch.cuda.*``), names bound from such expressions, and subscripts,
arithmetic, comparisons and tensor-returning methods of them. A numpy
value is not a tensor: its ``.item()`` is no card sync. Blind spots,
deliberate: reachability does not cross modules, and a sync hidden in a
``copy_`` to a host buffer or inside a kernel's C++ launcher is not seen
statically. The card audit (``analysis.trace``, KBT-P001) counts the
first kind at run time (the sharded solve's per-iteration record read
among them, bounded by its trace-baseline entry); syncs inside a C++
launcher are invisible to torch and listed by reading ``csrc/``.
"""

from __future__ import annotations

import ast
import re
from typing import Optional, Union

from kube_batch_tpu_torch.analysis import Finding, SourceFile

_FuncDef = Union[ast.FunctionDef, ast.AsyncFunctionDef]

# path -> the card's solve entry points in it
ENTRY_POINTS: dict[str, tuple[str, ...]] = {
    "kube_batch_tpu_torch/ops/fused_solve.py": ("FusedSolver.solve", "fused_solve"),
    "kube_batch_tpu_torch/parallel/sharded_block.py": ("ShardedBlockSolver.solve",),
    "kube_batch_tpu_torch/ops/mesh_solve.py": ("MeshSolve.solve", "mesh_solve"),
    "kube_batch_tpu_torch/ops/class_solve.py": ("class_step", "ClassCompressedSolver"),
    "kube_batch_tpu_torch/ops/block_step.py": ("block_step",),
    "kube_batch_tpu_torch/ops/explain.py": ("explain_batch",),
}
# files whose functions are all plain versions
PLAIN_MODULES = ("kube_batch_tpu_torch/ops/kernels.py",)
SCAN_PREFIXES = ("kube_batch_tpu_torch/ops/", "kube_batch_tpu_torch/parallel/")
POLICY_PREFIXES = ("kube_batch_tpu_torch/plugins/", "kube_batch_tpu_torch/api/")

_ENTRY_RE = re.compile(r"#:\s*card_entry\b")
_SYNC_METHODS = {"item", "tolist"}  # syncs when the receiver is a tensor
_ALWAYS_SYNC_METHODS = {"cpu", "numpy"}  # torch-only methods
_SCALAR_CASTS = {"float", "int", "bool"}
# tensor methods whose result is a host value, not a tensor
_HOST_RESULT_METHODS = {
    "item", "tolist", "numpy", "size", "dim", "numel", "data_ptr",
    "element_size", "is_contiguous", "stride", "get_device", "nelement",
}
_HOST_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout"}
_TORCH_HOST_CALLS = {
    "device", "is_tensor", "finfo", "iinfo", "get_default_dtype", "Size",
    "no_grad", "inference_mode", "manual_seed", "Generator",
}
# named tuples whose every public field is a tensor
_STATE_TUPLES = {"SolveState", "ClassSolveState"}
_DTYPE_LITERALS = {"float32", "float64"}
_DTYPE_ROOTS = {"np", "numpy"}


def _callable_name(fn: ast.expr) -> str:
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return ""


def _attr_chain(node: ast.expr) -> list[str]:
    out: list[str] = []
    while isinstance(node, ast.Attribute):
        out.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        out.append(node.id)
    return out[::-1]


def _attr_root(node: ast.expr) -> str:
    chain = _attr_chain(node)
    return chain[0] if chain else ""


# -- scope --------------------------------------------------------------------


def _index(tree: ast.AST) -> dict[str, _FuncDef]:
    """Qualified name -> def for module-level functions and methods
    (``Class.method``) of module-level classes."""
    out: dict[str, _FuncDef] = {}
    for node in tree.body if isinstance(tree, ast.Module) else []:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{m.name}"] = m
    return out


def _annotated_entries(sf: SourceFile, index: dict[str, _FuncDef]) -> set[str]:
    lines = sf.lines
    return {
        q for q, fn in index.items()
        if 0 < fn.lineno <= len(lines) and _ENTRY_RE.search(lines[fn.lineno - 1])
    }


def _callees(qual: str, fn: _FuncDef, index: dict[str, _FuncDef]) -> set[str]:
    cls = qual.rsplit(".", 1)[0] if "." in qual else None
    out: set[str] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name) and f.id in index:
            out.add(f.id)
        elif (
            cls is not None
            and isinstance(f, ast.Attribute)
            and isinstance(f.value, ast.Name)
            and f.value.id in ("self", "cls")
            and f"{cls}.{f.attr}" in index
        ):
            out.add(f"{cls}.{f.attr}")
    return out


def card_scope(sf: SourceFile) -> list[tuple[str, _FuncDef]]:
    """(qualified name, def) of every function a card entry point in
    ``sf`` reaches in its own module, plain versions excluded."""
    if sf.path in PLAIN_MODULES:
        return []
    index = _index(sf.tree)
    roots: set[str] = set()
    for entry in ENTRY_POINTS.get(sf.path, ()) + tuple(sorted(_annotated_entries(sf, index))):
        if entry in index:
            roots.add(entry)
        else:  # a class: all of its methods
            roots.update(q for q in index if q.startswith(entry + "."))
    work = sorted(roots)
    seen: set[str] = set()
    while work:
        q = work.pop()
        if q in seen or q.rsplit(".", 1)[-1].endswith("_plain"):
            continue
        seen.add(q)
        work.extend(sorted(_callees(q, index[q], index) - seen))
    return [(q, index[q]) for q in sorted(seen)]


# -- tensor inference ---------------------------------------------------------


def _annotation_kind(ann: Optional[ast.expr]) -> str:
    """"tensor" for ``torch.Tensor``, "state" for a named tuple of
    tensors (``SolveState``, ``ClassSolveState``), else ""."""
    if ann is None:
        return ""
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        name = ann.value.rsplit(".", 1)[-1]
    else:
        name = _callable_name(ann)
    if name == "Tensor":
        return "tensor"
    return "state" if name in _STATE_TUPLES else ""


def _return_kinds(index: dict[str, _FuncDef]) -> dict[str, str]:
    return {q: k for q, fn in index.items() if (k := _annotation_kind(fn.returns))}


def _bound_names(target: ast.expr) -> list[str]:
    """Names a target binds (not the names inside a subscript or an
    attribute it stores into)."""
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for e in target.elts for n in _bound_names(e)]
    if isinstance(target, ast.Starred):
        return _bound_names(target.value)
    return []


class _Tensors:
    """Which expressions of one function are tensors (see the module
    docstring for the rules). A name bound to a state tuple (by its
    annotation, or from a same-module call annotated to return one) holds
    tensors in its fields."""

    def __init__(self, fn: _FuncDef, cls: Optional[str] = None,
                 kinds: Optional[dict[str, str]] = None) -> None:
        self.cls = cls
        self.kinds = kinds or {}
        self.names: set[str] = set()
        self.states: set[str] = set()
        a = fn.args
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            kind = _annotation_kind(p.annotation)
            (self.names if kind == "tensor" else self.states if kind == "state" else set()).add(p.arg)
        assigns = [n for n in ast.walk(fn) if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign))]
        for _ in range(4):  # to a fixpoint over chains of assignments
            before = len(self.names) + len(self.states)
            for n in assigns:
                value = n.value
                if value is None:
                    continue
                kind = "tensor" if self.is_tensor(value) else self._call_kind(value)
                if kind not in ("tensor", "state"):
                    continue
                targets = n.targets if isinstance(n, ast.Assign) else [n.target]
                for t in targets:
                    (self.names if kind == "tensor" else self.states).update(_bound_names(t))
            if len(self.names) + len(self.states) == before:
                break

    def _call_kind(self, e: ast.expr) -> str:
        if not isinstance(e, ast.Call):
            return ""
        f = e.func
        if isinstance(f, ast.Name):
            return self.kinds.get(f.id, "")
        if (
            self.cls is not None
            and isinstance(f, ast.Attribute)
            and isinstance(f.value, ast.Name)
            and f.value.id in ("self", "cls")
        ):
            return self.kinds.get(f"{self.cls}.{f.attr}", "")
        return ""

    def is_tensor(self, e: ast.expr) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.names
        if isinstance(e, ast.Call):
            chain = _attr_chain(e.func)
            if chain[:1] == ["torch"]:
                return chain[1:2] != ["cuda"] and chain[-1] not in _TORCH_HOST_CALLS
            if self._call_kind(e) == "tensor":
                return True
            if isinstance(e.func, ast.Attribute):
                return e.func.attr not in _HOST_RESULT_METHODS and self.is_tensor(e.func.value)
            return False
        if isinstance(e, ast.Attribute):
            if isinstance(e.value, ast.Name) and e.value.id in self.states:
                return not e.attr.startswith("_")
            return e.attr not in _HOST_ATTRS and self.is_tensor(e.value)
        if isinstance(e, ast.Subscript):
            return self.is_tensor(e.value)
        if isinstance(e, ast.BinOp):
            return self.is_tensor(e.left) or self.is_tensor(e.right)
        if isinstance(e, ast.UnaryOp):
            return not isinstance(e.op, ast.Not) and self.is_tensor(e.operand)
        if isinstance(e, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in e.ops):
                return False
            return any(self.is_tensor(x) for x in [e.left] + e.comparators)
        if isinstance(e, ast.IfExp):
            return self.is_tensor(e.body) or self.is_tensor(e.orelse)
        return False

    def truth_tested(self, e: ast.expr) -> bool:
        """Whether Python's truth test of ``e`` calls Tensor.__bool__."""
        if isinstance(e, ast.BoolOp):
            return any(self.truth_tested(v) for v in e.values)
        if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Not):
            return self.truth_tested(e.operand)
        return self.is_tensor(e)


# -- J001-J003 ----------------------------------------------------------------


class _ScopeChecker(ast.NodeVisitor):
    def __init__(self, sf: SourceFile, qual: str, fn: _FuncDef, findings: list[Finding],
                 kinds: dict[str, str]) -> None:
        self.sf = sf
        self.qual = qual
        self.fn = fn
        self.findings = findings
        self.tensors = _Tensors(fn, qual.rsplit(".", 1)[0] if "." in qual else None, kinds)
        self.loops = 0

    def run(self) -> None:
        for stmt in self.fn.body:
            self.visit(stmt)

    def _flag(self, node: ast.AST, code: str, msg: str, sym: str) -> None:
        lines = self.sf.lines
        if 0 < node.lineno <= len(lines) and "noqa" in lines[node.lineno - 1]:
            return
        self.findings.append(
            Finding(self.sf.path, node.lineno, code, msg, symbol=f"{self.qual}.{sym}")
        )

    def _loop(self, node, test: Optional[ast.expr]) -> None:
        self.loops += 1
        if test is not None:
            self._check_test(node, test, "while")
            self.visit(test)
        for stmt in node.body:
            self.visit(stmt)
        self.loops -= 1
        for stmt in node.orelse:
            self.visit(stmt)

    def visit_For(self, node: ast.For) -> None:
        self.visit(node.iter)
        self.visit(node.target)
        self._loop(node, None)

    visit_AsyncFor = visit_For  # type: ignore[assignment]

    def visit_While(self, node: ast.While) -> None:
        self._loop(node, node.test)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # a nested def runs when called, not per iteration of the loop
        # it is defined in; its body is part of this scope all the same
        saved, self.loops = self.loops, 0
        for stmt in node.body:
            self.visit(stmt)
        self.loops = saved

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_Return(self, node: ast.Return) -> None:
        # a return inside a loop runs once: its fetch is the solve's last
        saved, self.loops = self.loops, 0
        self.generic_visit(node)
        self.loops = saved

    visit_Raise = visit_Return  # type: ignore[assignment]

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        name = _callable_name(fn)
        if isinstance(fn, ast.Name) and name == "print":
            self._flag(node, "KBT-J003",
                       f"bare print() in `{self.qual}`, on a card solve path "
                       "(formats tensors with a sync; use the logger outside the solve)",
                       "print")
        elif self.loops:
            why = None
            if isinstance(fn, ast.Name) and name in _SCALAR_CASTS and node.args:
                if self.tensors.is_tensor(node.args[0]):
                    why = f"{name}() of a tensor"
            elif isinstance(fn, ast.Attribute):
                if _attr_chain(fn) == ["torch", "cuda", "synchronize"]:
                    why, name = "torch.cuda.synchronize()", "synchronize"
                elif fn.attr in _ALWAYS_SYNC_METHODS:
                    why = f".{fn.attr}()"
                elif fn.attr in _SYNC_METHODS and self.tensors.is_tensor(fn.value):
                    why = f".{fn.attr}() of a tensor"
            if why is not None:
                self._flag(node, "KBT-J001",
                           f"{why} inside a loop of `{self.qual}`, on a card solve "
                           "path: a device->host sync per iteration",
                           name)
        self.generic_visit(node)

    def _check_test(self, node: ast.AST, test: ast.expr, kind: str) -> None:
        if self.tensors.truth_tested(test):
            self._flag(node, "KBT-J002",
                       f"Python {kind} on a tensor in `{self.qual}`, on a card solve "
                       "path: Tensor.__bool__ syncs with the card",
                       f"{kind}")

    def visit_If(self, node: ast.If) -> None:
        self._check_test(node, node.test, "if")
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._check_test(node, node.test, "conditional expression")
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._check_test(node, node.test, "assert")
        self.generic_visit(node)


# -- J004 ---------------------------------------------------------------------


class _DtypeChecker(ast.NodeVisitor):
    def __init__(self, sf: SourceFile, findings: list[Finding]) -> None:
        self.sf = sf
        self.findings = findings
        self.scope: list[str] = []
        self.exempt: set[int] = set()  # ids of literals inside identity checks

    def visit_Compare(self, node: ast.Compare) -> None:
        # `x is np.float64` / `x == np.float32` consult the policy
        if all(isinstance(op, (ast.Is, ast.IsNot, ast.Eq, ast.NotEq)) for op in node.ops):
            for operand in [node.left] + node.comparators:
                if self._is_dtype_literal(operand):
                    self.exempt.add(id(operand))
        self.generic_visit(node)

    @staticmethod
    def _is_dtype_literal(node: ast.expr) -> bool:
        return (
            isinstance(node, ast.Attribute)
            and node.attr in _DTYPE_LITERALS
            and _attr_root(node) in _DTYPE_ROOTS
        )

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if self._is_dtype_literal(node) and id(node) not in self.exempt:
            lines = self.sf.lines
            if not (0 < node.lineno <= len(lines) and "noqa" in lines[node.lineno - 1]):
                root = _attr_root(node)
                where = ".".join(self.scope) or "<module>"
                self.findings.append(
                    Finding(
                        self.sf.path, node.lineno, "KBT-J004",
                        f"raw {root}.{node.attr} in `{where}` bypasses the "
                        "comparison-dtype policy (api/numerics."
                        "comparison_dtype) — derived quantities computed "
                        "here can disagree with the f32 device kernels on "
                        "sub-ulp ties",
                        symbol=f"{where}.{root}.{node.attr}",
                    )
                )
        self.generic_visit(node)


def analyze(files: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for sf in files:
        if sf.path.startswith(SCAN_PREFIXES):
            kinds = _return_kinds(_index(sf.tree))
            for qual, fn in card_scope(sf):
                _ScopeChecker(sf, qual, fn, findings, kinds).run()
        in_policy = sf.path.startswith(POLICY_PREFIXES) and not sf.path.endswith("numerics.py")
        if in_policy:
            _DtypeChecker(sf, findings).visit(sf.tree)
    # one finding per (path, line, code, symbol): two literals on a line
    seen: set[tuple] = set()
    out = []
    for f in findings:
        key = (f.path, f.line, f.code, f.symbol)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out
