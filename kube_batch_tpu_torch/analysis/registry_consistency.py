"""A3 — registry-consistency analyzer (KBT-R001..R012).

Three registries grew to dozens of names, each previously
checked only by grep and luck:

- **fault points**: the literal first argument of every
  ``faults.should_fire(...)`` / ``registry.arm(...)`` call, and the
  ``fault="<point>"`` keyword of any call, must exist in
  ``faults.POINTS`` (R001), and every ``POINTS`` entry must have a call
  site (R002) — an unfired point is a drill that silently injects
  nothing. Dynamic names built from f-strings with constant fragments
  (``f"{op}.write"``) are matched as wildcards: the pattern must match
  at least one registered point, and any point it matches counts as
  fired.
- **metrics**: every ``metrics.<name>`` attribute touched in package
  code must be defined at module level of ``metrics/__init__.py``
  (R003) — most metering sits in ``except`` blocks, so a typo is an
  AttributeError on exactly the path that only runs during an outage.
- **env knobs**: every ``KBT_*`` variable the package reads must have a
  row in the deployment runbook's environment table (R004), and every
  documented row must still be read somewhere (R005). Reads are
  collected from ``os.environ`` get/subscript/setdefault/pop calls,
  from ``*env*``-named helper calls with a literal ``KBT_*`` first
  argument (``_env_int("KBT_...", d)``), and from module-level
  ALL-CAPS constants bound to a ``KBT_*`` string (the
  ``ENV = "KBT_..."`` indirection in mutation_detector).
- **state_seq bumps**: every session mutation must advance the counter
  through ``Session.bump_state()`` (R006) — a raw ``state_seq += 1``
  (or assignment) outside that one hook is a mutation the streaming
  dirty tracker and state_seq-keyed score memos cannot observe.
- **span names**: the literal first argument of every ``obs.span(...)``
  / ``obs.emit(...)`` call must be declared in ``obs.SPAN_NAMES``
  (R007) — a typo'd name silently forks the trace tree — and every
  declared name must have a call site (R008).
- **debug endpoints**: every ``/debug/*`` route literal in server.py
  must be declared in ``obs.DEBUG_ENDPOINTS`` and vice versa (R009 —
  an undeclared route escapes the contract, a declared-but-unserved
  one 404s), and every declared endpoint needs a row in the deployment
  runbook's endpoint table, with no dead documented rows (R010).
- **metric help text**: every module-level Counter/Histogram/Gauge in
  ``metrics/__init__.py`` must carry non-empty help text and appear in
  ``render_prometheus_text``'s families list, and every families entry
  must be a declared metric (R011) — a helpless or unlisted metric is
  a series Prometheus scrapes without ``# HELP``/``# TYPE`` or never
  sees at all.
- **SLO kind registry**: every kind in ``obs.SLOAccountant.KINDS`` must
  have a gauge entry in BOTH ``metrics._SLO_GAUGES`` (per-shard publish)
  and ``metrics._FLEET_SLO_GAUGES`` (fleet aggregation), and every key
  of those dicts must be a declared kind (R012) — a kind without a
  gauge entry silently never publishes its quantiles, and a gauge keyed
  to no kind is a family the exposition carries but nothing ever sets.
"""

from __future__ import annotations

import ast
import os
import re
from fnmatch import fnmatchcase
from typing import Optional

from kube_batch_tpu_torch.analysis import Finding, SourceFile

FAULTS_MODULE = "kube_batch_tpu_torch/faults/__init__.py"
METRICS_MODULE = "kube_batch_tpu_torch/metrics/__init__.py"
OBS_MODULE = "kube_batch_tpu_torch/obs/__init__.py"
SERVER_MODULE = "kube_batch_tpu_torch/server.py"
RUNBOOK = "kube_batch_tpu_torch/RUNBOOK.md"

_ENV_RE = re.compile(r"^KBT_[A-Z0-9_]+$")
_DOC_ENV_RE = re.compile(r"`(KBT_[A-Z0-9_]+)`")
_DEBUG_PATH_RE = re.compile(r"^/debug/[a-z0-9_/-]+$")
_DOC_DEBUG_RE = re.compile(r"`(/debug/[a-z0-9_/-]+)`")


def _attr_root(node: ast.expr) -> str:
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else ""


# -- fault points ------------------------------------------------------------


def _declared_points(files: list[SourceFile]) -> dict[str, int]:
    """point -> lineno of its POINTS element."""
    for sf in files:
        if sf.path != FAULTS_MODULE:
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id == "POINTS":
                        v = node.value
                        if isinstance(v, (ast.Tuple, ast.List)):
                            return {
                                e.value: e.lineno
                                for e in v.elts
                                if isinstance(e, ast.Constant)
                                and isinstance(e.value, str)
                            }
    return {}


def _fault_keyword(call: ast.Call) -> Optional[ast.expr]:
    """The value of a ``fault="<point>"`` keyword, the form in which a
    wrapper fires a point on its caller's behalf (``native.call(...,
    fault="native.prepass")``)."""
    for kw in call.keywords:
        if kw.arg == "fault":
            return kw.value
    return None


def _point_arg(call: ast.Call) -> Optional[tuple[str, bool]]:
    """(name-or-pattern, is_pattern) for the call's first argument, or
    for its ``fault=`` keyword."""
    a = _fault_keyword(call)
    if a is None:
        if not call.args:
            return None
        a = call.args[0]
    if isinstance(a, ast.Constant) and isinstance(a.value, str):
        return a.value, False
    if isinstance(a, ast.JoinedStr):
        parts = []
        for v in a.values:
            if isinstance(v, ast.Constant):
                parts.append(str(v.value))
            else:
                parts.append("*")
        pattern = "".join(parts)
        return pattern, True
    return None  # a variable — not statically checkable


def _check_fault_points(files: list[SourceFile], findings: list[Finding]) -> None:
    declared = _declared_points(files)
    if not declared:
        return
    fired: set[str] = set()
    for sf in files:
        if sf.path == FAULTS_MODULE:
            continue  # the registry's own wrapper/arm plumbing
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else ""
            )
            if name not in ("should_fire", "arm") and _fault_keyword(node) is None:
                continue
            got = _point_arg(node)
            if got is None:
                continue
            point, is_pattern = got
            if is_pattern:
                hits = [p for p in declared if fnmatchcase(p, point)]
                if hits:
                    fired.update(hits)
                else:
                    findings.append(
                        Finding(
                            sf.path, node.lineno, "KBT-R001",
                            f"dynamic fault point pattern {point!r} matches "
                            "no entry in faults.POINTS",
                            symbol=f"point:{point}",
                        )
                    )
            elif point in declared:
                fired.add(point)
            else:
                findings.append(
                    Finding(
                        sf.path, node.lineno, "KBT-R001",
                        f"fault point {point!r} is not registered in "
                        "faults.POINTS — arm() would reject it, the drill "
                        "can never fire",
                        symbol=f"point:{point}",
                    )
                )
    for point, lineno in sorted(declared.items()):
        if point not in fired:
            findings.append(
                Finding(
                    FAULTS_MODULE, lineno, "KBT-R002",
                    f"fault point {point!r} is registered but no "
                    "should_fire()/arm() call site fires it — drills "
                    "arming it inject nothing",
                    symbol=f"point:{point}",
                )
            )


# -- metrics -----------------------------------------------------------------


def _metrics_exports(files: list[SourceFile]) -> set[str]:
    names: set[str] = set()
    for sf in files:
        if sf.path != METRICS_MODULE:
            continue
        mod = sf.tree
        assert isinstance(mod, ast.Module)
        for node in mod.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                names.add(node.target.id)
    return names


def _metrics_aliases(tree: ast.AST) -> set[str]:
    """Local names bound to the metrics module in this file."""
    aliases: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.module == "kube_batch_tpu_torch":
                for a in node.names:
                    if a.name == "metrics":
                        aliases.add(a.asname or a.name)
            elif node.module == "kube_batch_tpu_torch.metrics":
                continue  # direct symbol imports resolve at import time
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "kube_batch_tpu_torch.metrics" and a.asname:
                    aliases.add(a.asname)
    return aliases


def _check_metrics(files: list[SourceFile], findings: list[Finding]) -> None:
    exported = _metrics_exports(files)
    if not exported:
        return
    for sf in files:
        if sf.path == METRICS_MODULE:
            continue
        aliases = _metrics_aliases(sf.tree)
        if not aliases:
            continue
        for node in ast.walk(sf.tree):
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id in aliases
                and node.attr not in exported
            ):
                findings.append(
                    Finding(
                        sf.path, node.lineno, "KBT-R003",
                        f"metrics.{node.attr} is not declared in "
                        "metrics/__init__.py — AttributeError on the "
                        "(likely failure-only) path that reaches it",
                        symbol=f"metric:{node.attr}",
                    )
                )


# -- state_seq bump discipline -----------------------------------------------

SESSION_MODULE = "kube_batch_tpu_torch/framework/session.py"
_BUMP_OWNERS = ("bump_state", "__init__")


def _check_state_seq(files: list[SourceFile], findings: list[Finding]) -> None:
    """KBT-R006: no raw ``<obj>.state_seq += 1`` / ``= n`` bump sites
    outside Session.bump_state (and the counter's __init__)."""
    for sf in files:
        owners: dict[int, str] = {}  # lineno -> enclosing function name
        if sf.path == SESSION_MODULE:
            for node in ast.walk(sf.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    for sub in ast.walk(node):
                        if hasattr(sub, "lineno"):
                            owners.setdefault(sub.lineno, node.name)
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.AugAssign):
                targets = [node.target]
            elif isinstance(node, ast.Assign):
                # `x.state_seq = y.state_seq` is a memo of the observed
                # counter (encode_cache task blocks), not a bump.
                if (
                    isinstance(node.value, ast.Attribute)
                    and node.value.attr == "state_seq"
                ):
                    continue
                targets = node.targets
            else:
                continue
            for t in targets:
                if not (isinstance(t, ast.Attribute) and t.attr == "state_seq"):
                    continue
                if owners.get(node.lineno) in _BUMP_OWNERS:
                    continue
                findings.append(
                    Finding(
                        sf.path, node.lineno, "KBT-R006",
                        "raw state_seq bump outside Session.bump_state() — "
                        "the streaming dirty tracker and state_seq-keyed "
                        "score memos cannot observe this mutation; call "
                        "bump_state() instead",
                        symbol="state_seq",
                    )
                )


# -- span names + debug endpoints (kube_batch_tpu_torch.obs, R007-R010) ------------


def _declared_str_tuple(
    files: list[SourceFile], module: str, name: str
) -> dict[str, int]:
    """entry -> lineno of ``name = ("...", ...)`` at ``module`` top level."""
    for sf in files:
        if sf.path != module:
            continue
        mod = sf.tree
        if not isinstance(mod, ast.Module):
            continue
        for node in mod.body:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id == name:
                        v = node.value
                        if isinstance(v, (ast.Tuple, ast.List)):
                            return {
                                e.value: e.lineno
                                for e in v.elts
                                if isinstance(e, ast.Constant)
                                and isinstance(e.value, str)
                            }
    return {}


def _check_span_names(files: list[SourceFile], findings: list[Finding]) -> None:
    declared = _declared_str_tuple(files, OBS_MODULE, "SPAN_NAMES")
    if not declared:
        return
    used: set[str] = set()
    for sf in files:
        if sf.path == OBS_MODULE:
            continue  # the registry's own span/emit plumbing
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else ""
            )
            if name not in ("span", "emit"):
                continue
            if not node.args:
                continue
            a = node.args[0]
            if not (isinstance(a, ast.Constant) and isinstance(a.value, str)):
                continue  # a variable (or m.span(1)) — not checkable
            span_name = a.value
            if name == "span" and isinstance(fn, ast.Attribute) and _attr_root(
                fn
            ) not in ("obs", ""):
                continue  # e.g. some_match.span("x") on a non-obs object
            if span_name in declared:
                used.add(span_name)
            else:
                findings.append(
                    Finding(
                        sf.path, node.lineno, "KBT-R007",
                        f"span name {span_name!r} is not declared in "
                        "obs.SPAN_NAMES — an undeclared name silently "
                        "forks the trace tree past every tree check",
                        symbol=f"span:{span_name}",
                    )
                )
    for span_name, lineno in sorted(declared.items()):
        if span_name not in used:
            findings.append(
                Finding(
                    OBS_MODULE, lineno, "KBT-R008",
                    f"span name {span_name!r} is declared in SPAN_NAMES but "
                    "no obs.span()/obs.emit() call site opens it — the "
                    "declared trace shape and the real one have diverged",
                    symbol=f"span:{span_name}",
                )
            )


def _server_debug_routes(files: list[SourceFile]) -> dict[str, int]:
    """route -> lineno of every exact ``/debug/...`` literal in server.py."""
    out: dict[str, int] = {}
    for sf in files:
        if sf.path != SERVER_MODULE:
            continue
        for node in ast.walk(sf.tree):
            if (
                isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and _DEBUG_PATH_RE.match(node.value)
            ):
                out.setdefault(node.value, node.lineno)
    return out


def _documented_debug(repo: str, runbook: str) -> Optional[dict[str, int]]:
    path = os.path.join(repo, runbook)
    if not os.path.exists(path):
        return None
    out: dict[str, int] = {}
    with open(path, encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, 1):
            if not line.lstrip().startswith("|"):
                continue
            m = _DOC_DEBUG_RE.search(line)
            if m:
                out.setdefault(m.group(1), lineno)
    return out


def _check_debug_endpoints(
    files: list[SourceFile], repo: str, runbook: str, findings: list[Finding]
) -> None:
    declared = _declared_str_tuple(files, OBS_MODULE, "DEBUG_ENDPOINTS")
    if not declared:
        return
    served = _server_debug_routes(files)
    for route, lineno in sorted(served.items()):
        if route not in declared:
            findings.append(
                Finding(
                    SERVER_MODULE, lineno, "KBT-R009",
                    f"route {route!r} is served but not declared in "
                    "obs.DEBUG_ENDPOINTS — the debug surface contract and "
                    "the server have diverged",
                    symbol=f"endpoint:{route}",
                )
            )
    for route, lineno in sorted(declared.items()):
        if route not in served:
            findings.append(
                Finding(
                    OBS_MODULE, lineno, "KBT-R009",
                    f"endpoint {route!r} is declared in DEBUG_ENDPOINTS but "
                    "server.py serves no such route — it would 404",
                    symbol=f"endpoint:{route}",
                )
            )
    documented = _documented_debug(repo, runbook)
    if documented is None:
        return
    for route, lineno in sorted(declared.items()):
        if route not in documented:
            findings.append(
                Finding(
                    OBS_MODULE, lineno, "KBT-R010",
                    f"endpoint {route!r} has no row in the deployment "
                    f"runbook's endpoint table ({runbook})",
                    symbol=f"endpoint:{route}",
                )
            )
    for route, lineno in sorted(documented.items()):
        if route not in declared:
            findings.append(
                Finding(
                    runbook, lineno, "KBT-R010",
                    f"endpoint {route!r} is documented but not declared in "
                    "obs.DEBUG_ENDPOINTS — the runbook row is dead",
                    symbol=f"endpoint:{route}",
                )
            )


# -- metric help text + exposition families (R011) ---------------------------

_METRIC_CLASSES = ("Counter", "Histogram", "Gauge")


def _metric_decls(files: list[SourceFile]) -> dict[str, tuple[int, bool]]:
    """name -> (lineno, has_help) for every module-level metric object
    assignment in metrics/__init__.py."""
    out: dict[str, tuple[int, bool]] = {}
    for sf in files:
        if sf.path != METRICS_MODULE:
            continue
        mod = sf.tree
        if not isinstance(mod, ast.Module):
            continue
        for node in mod.body:
            if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)):
                continue
            fn = node.value.func
            cls = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else ""
            )
            if cls not in _METRIC_CLASSES:
                continue
            args = node.value.args
            help_arg = args[1] if len(args) > 1 else None
            for kw in node.value.keywords:
                if kw.arg == "help_text":
                    help_arg = kw.value
            has_help = (
                isinstance(help_arg, ast.Constant)
                and isinstance(help_arg.value, str)
                and bool(help_arg.value.strip())
            ) or isinstance(help_arg, ast.JoinedStr)
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = (node.lineno, has_help)
    return out


def _exposition_families(files: list[SourceFile]) -> dict[str, int]:
    """name -> lineno for every entry of the ``families = [...]`` list
    inside render_prometheus_text."""
    out: dict[str, int] = {}
    for sf in files:
        if sf.path != METRICS_MODULE:
            continue
        for node in ast.walk(sf.tree):
            if not (
                isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name == "render_prometheus_text"
            ):
                continue
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign):
                    for t in sub.targets:
                        if (
                            isinstance(t, ast.Name)
                            and t.id == "families"
                            and isinstance(sub.value, (ast.List, ast.Tuple))
                        ):
                            for e in sub.value.elts:
                                if isinstance(e, ast.Name):
                                    out.setdefault(e.id, e.lineno)
    return out


def _check_metric_help(files: list[SourceFile], findings: list[Finding]) -> None:
    declared = _metric_decls(files)
    if not declared:
        return
    families = _exposition_families(files)
    for name, (lineno, has_help) in sorted(declared.items()):
        if not has_help:
            findings.append(
                Finding(
                    METRICS_MODULE, lineno, "KBT-R011",
                    f"metric {name!r} is declared without help text — its "
                    "exposition would carry an empty # HELP line",
                    symbol=f"metric:{name}",
                )
            )
        if families and name not in families:
            findings.append(
                Finding(
                    METRICS_MODULE, lineno, "KBT-R011",
                    f"metric {name!r} is declared but missing from "
                    "render_prometheus_text's families list — Prometheus "
                    "never sees the series",
                    symbol=f"metric:{name}",
                )
            )
    for name, lineno in sorted(families.items()):
        if name not in declared:
            findings.append(
                Finding(
                    METRICS_MODULE, lineno, "KBT-R011",
                    f"families entry {name!r} is not a module-level metric "
                    "declaration — the exposition renders an unregistered "
                    "object",
                    symbol=f"metric:{name}",
                )
            )


# -- SLO kind registry (R012) ------------------------------------------------

_SLO_GAUGE_MAPS = ("_SLO_GAUGES", "_FLEET_SLO_GAUGES")


def _slo_kinds(files: list[SourceFile]) -> dict[str, int]:
    """kind -> lineno of the ``KINDS = (...)`` tuple inside the
    SLOAccountant class body in obs/__init__.py."""
    for sf in files:
        if sf.path != OBS_MODULE:
            continue
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.ClassDef) and node.name == "SLOAccountant"):
                continue
            for stmt in node.body:
                if isinstance(stmt, ast.Assign):
                    for t in stmt.targets:
                        if isinstance(t, ast.Name) and t.id == "KINDS":
                            v = stmt.value
                            if isinstance(v, (ast.Tuple, ast.List)):
                                return {
                                    e.value: e.lineno
                                    for e in v.elts
                                    if isinstance(e, ast.Constant)
                                    and isinstance(e.value, str)
                                }
    return {}


def _slo_gauge_keys(files: list[SourceFile], map_name: str) -> dict[str, int]:
    """key -> lineno for the ``map_name = {...}`` dict literal at module
    top level of metrics/__init__.py."""
    for sf in files:
        if sf.path != METRICS_MODULE:
            continue
        mod = sf.tree
        if not isinstance(mod, ast.Module):
            continue
        for node in mod.body:
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id == map_name:
                        return {
                            k.value: k.lineno
                            for k in node.value.keys
                            if isinstance(k, ast.Constant)
                            and isinstance(k.value, str)
                        }
    return {}


def _check_slo_kind_registry(
    files: list[SourceFile], findings: list[Finding]
) -> None:
    kinds = _slo_kinds(files)
    if not kinds:
        return
    for map_name in _SLO_GAUGE_MAPS:
        keys = _slo_gauge_keys(files, map_name)
        if not keys:
            continue
        for kind, lineno in sorted(kinds.items()):
            if kind not in keys:
                findings.append(
                    Finding(
                        OBS_MODULE, lineno, "KBT-R012",
                        f"SLO kind {kind!r} has no gauge entry in "
                        f"metrics.{map_name} — its quantiles are tracked "
                        "but never published to the exposition",
                        symbol=f"slo_kind:{kind}",
                    )
                )
        for key, lineno in sorted(keys.items()):
            if key not in kinds:
                findings.append(
                    Finding(
                        METRICS_MODULE, lineno, "KBT-R012",
                        f"metrics.{map_name} key {key!r} is not a kind in "
                        "obs.SLOAccountant.KINDS — the gauge family is "
                        "registered but nothing ever sets it",
                        symbol=f"slo_kind:{key}",
                    )
                )


# -- env knobs ---------------------------------------------------------------


def _env_reads(files: list[SourceFile]) -> dict[str, tuple[str, int]]:
    """var -> (path, line) of one read site."""
    reads: dict[str, tuple[str, int]] = {}

    def note(var: str, sf: SourceFile, lineno: int) -> None:
        reads.setdefault(var, (sf.path, lineno))

    for sf in files:
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call):
                fn = node.func
                fname = fn.attr if isinstance(fn, ast.Attribute) else (
                    fn.id if isinstance(fn, ast.Name) else ""
                )
                env_call = False
                if isinstance(fn, ast.Attribute):
                    chain = ast.dump(fn.value) if fn.value else ""
                    env_call = "environ" in chain and fname in (
                        "get", "pop", "setdefault", "__getitem__"
                    )
                env_call = env_call or "env" in fname.lower() or fname == "getenv"
                if env_call and node.args:
                    a = node.args[0]
                    if isinstance(a, ast.Constant) and isinstance(a.value, str):
                        if _ENV_RE.match(a.value):
                            note(a.value, sf, node.lineno)
            elif isinstance(node, ast.Subscript):
                v = node.value
                if isinstance(v, ast.Attribute) and v.attr == "environ":
                    s = node.slice
                    if isinstance(s, ast.Constant) and isinstance(s.value, str):
                        if _ENV_RE.match(s.value):
                            note(s.value, sf, node.lineno)
        # ALL-CAPS module constants bound to a KBT_* string (indirection)
        mod = sf.tree
        if isinstance(mod, ast.Module):
            for node in mod.body:
                if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant):
                    val = node.value.value
                    if isinstance(val, str) and _ENV_RE.match(val):
                        for t in node.targets:
                            if isinstance(t, ast.Name) and t.id.isupper():
                                note(val, sf, node.lineno)
    return reads


def _documented_env(repo: str, runbook: str) -> Optional[dict[str, int]]:
    """var -> line in the runbook env table; None when the runbook is
    absent (partial checkouts skip the doc cross-check, loudly at the
    CLI layer)."""
    path = os.path.join(repo, runbook)
    if not os.path.exists(path):
        return None
    out: dict[str, int] = {}
    with open(path, encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, 1):
            if not line.lstrip().startswith("|"):
                continue
            m = _DOC_ENV_RE.search(line.split("|")[1] if line.count("|") > 1 else line)
            if m:
                out.setdefault(m.group(1), lineno)
    return out


def _check_env(
    files: list[SourceFile], repo: str, runbook: str, findings: list[Finding]
) -> None:
    documented = _documented_env(repo, runbook)
    if documented is None:
        return
    reads = _env_reads(files)
    for var, (path, lineno) in sorted(reads.items()):
        if var not in documented:
            findings.append(
                Finding(
                    path, lineno, "KBT-R004",
                    f"{var} is read here but has no row in the deployment "
                    f"runbook's environment table ({runbook})",
                    symbol=f"env:{var}",
                )
            )
    for var, lineno in sorted(documented.items()):
        if var not in reads:
            findings.append(
                Finding(
                    runbook, lineno, "KBT-R005",
                    f"{var} is documented in the environment table but no "
                    "package code reads it — the knob is dead",
                    symbol=f"env:{var}",
                )
            )


def analyze(
    files: list[SourceFile],
    repo: Optional[str] = None,
    runbook: Optional[str] = None,
) -> list[Finding]:
    from kube_batch_tpu_torch.analysis import repo_root

    repo = repo or repo_root()
    runbook = runbook or RUNBOOK
    findings: list[Finding] = []
    _check_fault_points(files, findings)
    _check_metrics(files, findings)
    _check_state_seq(files, findings)
    _check_span_names(files, findings)
    _check_debug_endpoints(files, repo, runbook, findings)
    _check_metric_help(files, findings)
    _check_env(files, repo, runbook, findings)
    _check_slo_kind_registry(files, findings)
    return findings
