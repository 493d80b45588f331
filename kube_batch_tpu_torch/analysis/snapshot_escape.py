"""A4 — snapshot-escape analyzer (KBT-S001/S002).

Session snapshots (``ssn.jobs`` / ``ssn.nodes`` / ``ssn.queues``) are
clones the actions and plugins reason over for one cycle. Mutating them
is legal only through the session/Statement APIs (``ssn.allocate``,
``ssn.evict``, ``stmt.evict/pipeline``): those maintain the operation
log (so a gang that misses quorum rolls back), bump ``state_seq`` (so
memoized scorers invalidate), and fire the allocate/deallocate event
handlers (so DRF/proportion shares track reality). A direct write —
``task.node_name = n`` or ``node.add_task(task)`` from an action —
skips all three: shares desync silently and the mutation survives
``Statement.discard``.

The analyzer runs over ``plugins/`` and ``actions/`` and performs a
per-function lexical taint walk:

- roots: any expression reaching through ``ssn.jobs`` / ``ssn.nodes``
  / ``ssn.queues`` (also ``session.``); taint propagates through
  subscripts, ``.get()`` / ``.values()`` / ``.items()`` / ``.pop()``,
  iteration (``for job in ssn.jobs.values():``), simple assignment,
  and snapshot-graph attributes (``job.tasks``,
  ``job.task_status_index``, ``node.tasks``);
- violations: an attribute store whose base is tainted (S001), or a
  call of a known mutator method (``add_task``, ``remove_task``,
  ``update_task``, ``update_task_status``, ``add_task_info``,
  ``delete_task_info``, ``set_pod_group``, ``set_pdb``, ``set_node``)
  on a tainted receiver (S002).

Calls on ``ssn``/``stmt``/``statement`` objects themselves are the
sanctioned API and never flagged. The walk is intra-procedural and
under-approximate by design (taint does not flow through ``self.*`` or
collections built elsewhere); vetted bulk-replay equivalents that fire
anyway belong in the baseline with their parity evidence as the reason.
"""

from __future__ import annotations

import ast

from kube_batch_tpu_torch.analysis import Finding, SourceFile

SESSION_NAMES = {"ssn", "session"}
SNAPSHOT_COLLECTIONS = {"jobs", "nodes", "queues"}
# attributes that stay inside the snapshot object graph
GRAPH_ATTRS = {"tasks", "task_status_index", "pod_group", "pdb", "nodes", "jobs"}
DERIVING_METHODS = {"get", "values", "items", "pop", "clone_shallow"}
MUTATORS = {
    "add_task", "remove_task", "update_task", "update_task_status",
    "add_task_info", "delete_task_info", "set_pod_group",
    "unset_pod_group", "set_pdb", "unset_pdb", "set_node",
}
SCOPES = ("kube_batch_tpu_torch/plugins/", "kube_batch_tpu_torch/actions/")


class _FunctionTaint(ast.NodeVisitor):
    def __init__(self, sf: SourceFile, qualname: str, findings: list[Finding]) -> None:
        self.sf = sf
        self.qualname = qualname
        self.findings = findings
        self.tainted: set[str] = set()

    # -- taint predicates ----------------------------------------------------

    def _is_tainted(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            base = node.value
            # ssn.jobs / ssn.nodes / ssn.queues roots
            if (
                isinstance(base, ast.Name)
                and base.id in SESSION_NAMES
                and node.attr in SNAPSHOT_COLLECTIONS
            ):
                return True
            # job.tasks etc: stay in the graph
            if node.attr in GRAPH_ATTRS and self._is_tainted(base):
                return True
            return False
        if isinstance(node, ast.Subscript):
            return self._is_tainted(node.value)
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in DERIVING_METHODS:
                return self._is_tainted(fn.value)
            return False
        if isinstance(node, (ast.IfExp,)):
            return self._is_tainted(node.body) or self._is_tainted(node.orelse)
        if isinstance(node, ast.BoolOp):
            return any(self._is_tainted(v) for v in node.values)
        return False

    def _taint_target(self, target: ast.expr) -> None:
        if isinstance(target, ast.Name):
            self.tainted.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._taint_target(e)

    # -- propagation ---------------------------------------------------------

    def visit_Assign(self, node: ast.Assign) -> None:
        self._check_store_targets(node.targets, node)
        if self._is_tainted(node.value):
            for t in node.targets:
                self._taint_target(t)
        else:
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.tainted.discard(t.id)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_store_targets([node.target], node)
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        if self._is_tainted(node.iter):
            self._taint_target(node.target)
        self.generic_visit(node)

    def visit_comprehension_gens(self, gens) -> None:
        for g in gens:
            if self._is_tainted(g.iter):
                self._taint_target(g.target)

    def visit_ListComp(self, node: ast.ListComp) -> None:
        self.visit_comprehension_gens(node.generators)
        self.generic_visit(node)

    def visit_SetComp(self, node: ast.SetComp) -> None:
        self.visit_comprehension_gens(node.generators)
        self.generic_visit(node)

    def visit_GeneratorExp(self, node: ast.GeneratorExp) -> None:
        self.visit_comprehension_gens(node.generators)
        self.generic_visit(node)

    def visit_DictComp(self, node: ast.DictComp) -> None:
        self.visit_comprehension_gens(node.generators)
        self.generic_visit(node)

    # -- violations ----------------------------------------------------------

    def _noqa(self, lineno: int) -> bool:
        lines = self.sf.lines
        return 0 < lineno <= len(lines) and "noqa" in lines[lineno - 1]

    def _check_store_targets(self, targets, node: ast.AST) -> None:
        for t in targets:
            if isinstance(t, ast.Attribute) and self._is_tainted(t.value):
                if not self._noqa(node.lineno):
                    base = ast.unparse(t.value) if hasattr(ast, "unparse") else "?"
                    self.findings.append(
                        Finding(
                            self.sf.path, node.lineno, "KBT-S001",
                            f"direct write to snapshot object attribute "
                            f"`{base}.{t.attr}` in {self.qualname} — go "
                            "through ssn.allocate/evict or a Statement so "
                            "the op log, state_seq and event handlers see it",
                            symbol=f"{self.qualname}.{t.attr}",
                        )
                    )
            elif isinstance(t, ast.Subscript) and self._is_tainted(t.value):
                if not self._noqa(node.lineno):
                    self.findings.append(
                        Finding(
                            self.sf.path, node.lineno, "KBT-S001",
                            f"direct item write into a snapshot collection "
                            f"in {self.qualname} — snapshot membership "
                            "changes must go through the session APIs",
                            symbol=f"{self.qualname}.[]",
                        )
                    )

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if (
            isinstance(fn, ast.Attribute)
            and fn.attr in MUTATORS
            and self._is_tainted(fn.value)
        ):
            if not self._noqa(node.lineno):
                self.findings.append(
                    Finding(
                        self.sf.path, node.lineno, "KBT-S002",
                        f"snapshot mutator .{fn.attr}() called directly in "
                        f"{self.qualname} — use ssn.allocate/evict or a "
                        "Statement (undo log + events + state_seq)",
                        symbol=f"{self.qualname}.{fn.attr}",
                    )
                )
        self.generic_visit(node)


def _outer_functions(tree: ast.AST):
    """Module-level functions and class methods; nested defs are walked
    inside their parent's checker so closures share its taint."""
    stack = [(tree, "")]
    while stack:
        node, prefix = stack.pop()
        body = getattr(node, "body", [])
        for child in body:
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield child, f"{prefix}{child.name}"
            elif isinstance(child, ast.ClassDef):
                stack.append((child, f"{prefix}{child.name}."))


def analyze(files: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for sf in files:
        if not sf.path.startswith(SCOPES):
            continue
        for fn, qualname in _outer_functions(sf.tree):
            _FunctionTaint(sf, qualname, findings).generic_visit(fn)
    return findings
