"""Scheduler configuration schema + loader
(reference pkg/scheduler/conf/scheduler_conf.go:20-56, pkg/scheduler/util.go:31-81,
pkg/scheduler/plugins/defaults.go:22-52).

The YAML shape matches the reference exactly::

    actions: "torch_allocate, backfill"
    actionArguments:
      torch_allocate:
        device: cuda
    tiers:
    - plugins:
      - name: priority
      - name: gang
    - plugins:
      - name: drf
      - name: predicates
      - name: proportion
      - name: nodeorder
        arguments:
          leastrequested.weight: 2

Every per-plugin enable flag defaults to True when unset
(ApplyPluginConfDefaults).

The text is read by a parser of the block-YAML subset this schema uses,
not by a YAML library: mappings and sequences in block style, plain,
single- or double-quoted scalars, and comments. Plain scalars resolve as
YAML 1.1 does (null, booleans, integers, floats, else strings), so a conf
gives the same values a full YAML loader would. Anything outside the
subset (flow collections, anchors and aliases, tags, block scalars,
several documents, tabs in indentation) raises ValueError naming the
line.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Optional

if TYPE_CHECKING:
    from kube_batch_tpu_torch.framework.interface import Action

_ENABLE_FLAGS = (
    "enabled_job_order",
    "enabled_job_ready",
    "enabled_job_pipelined",
    "enabled_task_order",
    "enabled_preemptable",
    "enabled_reclaimable",
    "enabled_queue_order",
    "enabled_predicate",
    "enabled_node_order",
)

_YAML_FLAG_KEYS = {
    "enableJobOrder": "enabled_job_order",
    "enableJobReady": "enabled_job_ready",
    "enableJobPipelined": "enabled_job_pipelined",
    "enableTaskOrder": "enabled_task_order",
    "enablePreemptable": "enabled_preemptable",
    "enableReclaimable": "enabled_reclaimable",
    "enableQueueOrder": "enabled_queue_order",
    "enablePredicate": "enabled_predicate",
    "enableNodeOrder": "enabled_node_order",
}


@dataclass
class PluginOption:
    """reference scheduler_conf.go:32-56."""

    name: str = ""
    enabled_job_order: Optional[bool] = None
    enabled_job_ready: Optional[bool] = None
    enabled_job_pipelined: Optional[bool] = None
    enabled_task_order: Optional[bool] = None
    enabled_preemptable: Optional[bool] = None
    enabled_reclaimable: Optional[bool] = None
    enabled_queue_order: Optional[bool] = None
    enabled_predicate: Optional[bool] = None
    enabled_node_order: Optional[bool] = None
    arguments: dict[str, str] = field(default_factory=dict)


@dataclass
class Tier:
    """reference scheduler_conf.go:27-30."""

    plugins: list[PluginOption] = field(default_factory=list)


@dataclass
class SchedulerConfiguration:
    """reference scheduler_conf.go:20-25, plus ``action_arguments``: an
    extension the reference schema does not have (its actions take no
    conf arguments) carrying per-action knobs, e.g. torch_allocate's
    device and mesh::

        actions: "torch_allocate, backfill"
        actionArguments:
          torch_allocate:
            mesh: cuda:4

    ``faults``, ``streaming``, ``trace``, ``explain`` and ``fleet`` are the
    same optional keys the JAX package's schema reads, parsed to the same
    values. The scheduler arms ``faults`` (the fault registry's grammar)
    when the conf changes, passes ``trace``, ``explain`` and ``fleet`` to
    ``obs.configure``, ``obs.explain.configure`` and
    ``obs.fleet.configure`` every cycle, and runs its streaming loop while
    ``streaming`` is true.
    """

    actions: str = ""
    tiers: list[Tier] = field(default_factory=list)
    action_arguments: dict[str, dict[str, str]] = field(default_factory=dict)
    faults: str = ""
    streaming: bool = False
    trace: str = ""
    explain: str = ""
    fleet: str = ""


# Default conf (reference util.go:31-42).
DEFAULT_SCHEDULER_CONF = """
actions: "allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""


# -- the block-YAML subset ----------------------------------------------------


class _Map(dict):
    """A parsed mapping, with the line of each key."""

    def __init__(self, line: int) -> None:
        super().__init__()
        self.line = line
        self.key_lines: dict = {}


class _Seq(list):
    """A parsed sequence, with the line of each item."""

    def __init__(self, line: int) -> None:
        super().__init__()
        self.line = line
        self.item_lines: list[int] = []


# YAML 1.1 implicit types of plain scalars (the resolver PyYAML's safe
# loader uses), so `enableNodeOrder: off` is False and `weight: 0x10` is 16.
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_INT = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$"
)
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9_]+(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$"
)


def _sexagesimal(text: str, cast) -> Any:
    sign = -1 if text[0] == "-" else 1
    value = cast(0)
    for part in text.lstrip("+-").split(":"):
        value = value * 60 + cast(part)
    return sign * value


def _resolve_int(text: str) -> int:
    t = text.replace("_", "")
    sign = -1 if t[0] == "-" else 1
    body = t.lstrip("+-")
    if ":" in body:
        return sign * _sexagesimal(body, int)
    if body.startswith("0b"):
        return sign * int(body[2:], 2)
    if body.startswith("0x"):
        return sign * int(body[2:], 16)
    if body != "0" and body.startswith("0"):
        return sign * int(body, 8)
    return sign * int(body)


def _resolve_float(text: str) -> float:
    t = text.replace("_", "").lower()
    if t.endswith(".inf"):
        return float("-inf") if t.startswith("-") else float("inf")
    if t.endswith(".nan"):
        return float("nan")
    if ":" in t:
        return _sexagesimal(t, float)
    return float(t)


def _plain(text: str) -> Any:
    """The value of a plain scalar under YAML 1.1's implicit types."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        return _resolve_int(text)
    if _FLOAT.match(text):
        return _resolve_float(text)
    return text


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\"}


def _quoted_end(text: str, start: int, lineno: int) -> int:
    """Index just past the quoted scalar opening at ``start``."""
    q = text[start]
    i = start + 1
    while i < len(text):
        c = text[i]
        if q == '"' and c == "\\":
            i += 2
            continue
        if c == q:
            if q == "'" and i + 1 < len(text) and text[i + 1] == "'":
                i += 2
                continue
            return i + 1
        i += 1
    raise ValueError(f"line {lineno}: unterminated quoted scalar")


def _unquote(text: str, lineno: int) -> str:
    body = text[1:-1]
    if text[0] == "'":
        return body.replace("''", "'")
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        nxt = body[i + 1] if i + 1 < len(body) else ""
        if nxt in _ESCAPES:
            out.append(_ESCAPES[nxt])
            i += 2
        elif nxt in ("x", "u", "U"):
            width = {"x": 2, "u": 4, "U": 8}[nxt]
            digits = body[i + 2: i + 2 + width]
            if len(digits) != width or not all(d in "0123456789abcdefABCDEF" for d in digits):
                raise ValueError(f"line {lineno}: bad escape in a double-quoted scalar")
            out.append(chr(int(digits, 16)))
            i += 2 + width
        else:
            raise ValueError(f"line {lineno}: bad escape in a double-quoted scalar")
    return "".join(out)


def _scalar(text: str, lineno: int) -> Any:
    """One scalar token (already stripped of its comment)."""
    if not text:
        return None
    if text[0] in "'\"":
        end = _quoted_end(text, 0, lineno)
        if text[end:].strip():
            raise ValueError(f"line {lineno}: text after a quoted scalar")
        return _unquote(text, lineno)
    if text[0] in "[{":
        raise ValueError(f"line {lineno}: flow collections are outside the conf's YAML subset")
    if text[0] in "&*!|>%@`":
        raise ValueError(f"line {lineno}: {text[0]!r} (anchor, alias, tag, block scalar or reserved) "
                         "is outside the conf's YAML subset")
    if text.startswith("? ") or text == "?":
        raise ValueError(f"line {lineno}: complex keys are outside the conf's YAML subset")
    if ": " in text or text.endswith(":"):
        raise ValueError(f"line {lineno}: a mapping inside a plain scalar")
    return _plain(text)


def _strip_comment(text: str, lineno: int) -> str:
    """The line without a trailing comment (a ``#`` at the start or after
    a space, outside quotes)."""
    i = 0
    while i < len(text):
        c = text[i]
        if c in "'\"" and (i == 0 or text[i - 1] in " :-[{,"):
            i = _quoted_end(text, i, lineno)
            continue
        if c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _split_key(text: str, lineno: int) -> Optional[tuple[str, str]]:
    """``key: value`` -> (key token, value text), or None when the line is
    not a mapping entry."""
    i = 0
    if text and text[0] in "'\"":
        i = _quoted_end(text, 0, lineno)
    while i < len(text):
        if text[i] == ":" and (i + 1 == len(text) or text[i + 1] == " "):
            return text[:i].rstrip(), text[i + 1:].strip()
        i += 1
    return None


class _Lines:
    """The conf's meaningful lines as (line number, indent, text)."""

    def __init__(self, conf_str: str) -> None:
        self.items: list[list] = []
        for lineno, raw in enumerate(conf_str.splitlines(), start=1):
            body = raw.lstrip(" ")
            if body.startswith("\t"):
                raise ValueError(f"line {lineno}: tabs in indentation are outside the conf's YAML subset")
            text = _strip_comment(body, lineno)
            if not text:
                continue
            if text in ("---", "...") or text.startswith(("--- ", "%")):
                raise ValueError(f"line {lineno}: documents and directives are outside the conf's YAML subset")
            self.items.append([lineno, len(raw) - len(body), text])

    def __len__(self) -> int:
        return len(self.items)


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _parse_node(lines: _Lines, i: int, indent: int) -> tuple[Any, int]:
    lineno, ind, text = lines.items[i]
    if _is_item(text):
        return _parse_seq(lines, i, indent)
    if _split_key(text, lineno) is not None:
        return _parse_map(lines, i, indent)
    if i + 1 < len(lines) and lines.items[i + 1][1] > indent:
        raise ValueError(f"line {lines.items[i + 1][0]}: unexpected indentation after a scalar")
    return _scalar(text, lineno), i + 1


def _parse_seq(lines: _Lines, i: int, indent: int) -> tuple[_Seq, int]:
    seq = _Seq(lines.items[i][0])
    while i < len(lines):
        lineno, ind, text = lines.items[i]
        if ind < indent:
            break
        if ind > indent:
            raise ValueError(f"line {lineno}: bad indentation")
        if not _is_item(text):
            break
        rest = text[1:]
        stripped = rest.lstrip(" ")
        seq.item_lines.append(lineno)
        if not stripped:
            if i + 1 < len(lines) and lines.items[i + 1][1] > indent:
                value, i = _parse_node(lines, i + 1, lines.items[i + 1][1])
            else:
                value, i = None, i + 1
        else:
            # the item's content starts where its text does
            lines.items[i] = [lineno, indent + 1 + len(rest) - len(stripped), stripped]
            value, i = _parse_node(lines, i, lines.items[i][1])
        seq.append(value)
    return seq, i


def _parse_map(lines: _Lines, i: int, indent: int) -> tuple[_Map, int]:
    mapping = _Map(lines.items[i][0])
    while i < len(lines):
        lineno, ind, text = lines.items[i]
        if ind < indent:
            break
        if ind > indent:
            raise ValueError(f"line {lineno}: bad indentation")
        if _is_item(text):
            break
        kv = _split_key(text, lineno)
        if kv is None:
            raise ValueError(f"line {lineno}: expected 'key: value'")
        key_text, value_text = kv
        key = _scalar(key_text, lineno)
        if isinstance(key, float) and key != key:
            raise ValueError(f"line {lineno}: a NaN key")
        i += 1
        if value_text:
            value = _scalar(value_text, lineno)
            if i < len(lines) and lines.items[i][1] > indent:
                raise ValueError(f"line {lines.items[i][0]}: unexpected indentation after a scalar")
        elif i < len(lines) and lines.items[i][1] > indent:
            value, i = _parse_node(lines, i, lines.items[i][1])
        elif i < len(lines) and lines.items[i][1] == indent and _is_item(lines.items[i][2]):
            value, i = _parse_seq(lines, i, indent)  # a sequence may sit at its key's indent
        else:
            value = None
        mapping[key] = value  # a repeated key keeps its last value, as in YAML loaders
        mapping.key_lines[key] = lineno
    return mapping, i


def _load(conf_str: str) -> Any:
    """The conf text as Python values (what a YAML 1.1 safe loader gives
    for the subset); None for an empty document."""
    lines = _Lines(conf_str)
    if not lines.items:
        return None
    value, i = _parse_node(lines, 0, lines.items[0][1])
    if i < len(lines):
        raise ValueError(f"line {lines.items[i][0]}: bad indentation")
    return value


def _line_of(container, key, default: int) -> int:
    if isinstance(container, _Map):
        return container.key_lines.get(key, container.line)
    return default


def _mapping(value, line: int, what: str) -> dict:
    if value is None:
        return {}
    if not isinstance(value, dict):
        raise ValueError(f"line {line}: {what} must be a mapping")
    return value


def _sequence(value, line: int, what: str) -> list:
    if value is None:
        return []
    if not isinstance(value, list):
        raise ValueError(f"line {line}: {what} must be a list")
    return value


def _scalar_map(value, line: int, what: str) -> dict[str, str]:
    """A mapping of scalars as strings, as the reference reads arguments."""
    out = {}
    for k, v in _mapping(value, line, what).items():
        if isinstance(v, (dict, list)):
            raise ValueError(f"line {_line_of(value, k, line)}: {what} values must be scalars")
        out[str(k)] = str(v)
    return out


# -- schema ---------------------------------------------------------------------


def apply_plugin_conf_defaults(option: PluginOption) -> None:
    """Unset enable flags default to True (reference defaults.go:22-52)."""
    for flag in _ENABLE_FLAGS:
        if getattr(option, flag) is None:
            setattr(option, flag, True)


def parse_scheduler_conf(conf_str: str) -> SchedulerConfiguration:
    """YAML string -> SchedulerConfiguration with plugin defaults applied
    (reference util.go:44-63); the same values the JAX package's parser
    gives. Raises ValueError, naming the line, outside the schema's YAML
    subset."""
    data = _load(conf_str) or {}
    if not isinstance(data, dict):
        raise ValueError("line 1: a scheduler conf is a mapping")
    conf = SchedulerConfiguration(
        actions=str(data.get("actions", "")),
        faults=str(data.get("faults") or ""),
        streaming=bool(data.get("streaming", False)),
        trace=str(data.get("trace") if data.get("trace") is not None else ""),
        explain=str(data.get("explain") if data.get("explain") is not None else ""),
        fleet=str(data.get("fleet") if data.get("fleet") is not None else ""),
    )
    for key in ("actions", "faults", "streaming", "trace", "explain", "fleet"):
        if isinstance(data.get(key), (dict, list)):
            raise ValueError(f"line {_line_of(data, key, 1)}: {key} must be a scalar")
    line = _line_of(data, "actionArguments", 1)
    action_args = _mapping(data.get("actionArguments") or None, line, "actionArguments")
    for action_name, args in action_args.items():
        conf.action_arguments[str(action_name)] = _scalar_map(
            args or None, _line_of(action_args, action_name, line), f"actionArguments.{action_name}"
        )
    line = _line_of(data, "tiers", 1)
    tiers = _sequence(data.get("tiers") or None, line, "tiers")
    for t, tier_data in enumerate(tiers):
        tline = tiers.item_lines[t] if isinstance(tiers, _Seq) else line
        tier_data = _mapping(tier_data, tline, "a tier")
        tier = Tier()
        pline = _line_of(tier_data, "plugins", tline)
        plugins = _sequence(tier_data.get("plugins") or None, pline, "plugins")
        for p, plugin_data in enumerate(plugins):
            oline = plugins.item_lines[p] if isinstance(plugins, _Seq) else pline
            plugin_data = _mapping(plugin_data, oline, "a plugin")
            if isinstance(plugin_data.get("name"), (dict, list)):
                raise ValueError(f"line {_line_of(plugin_data, 'name', oline)}: a plugin name must be a scalar")
            option = PluginOption(name=str(plugin_data.get("name", "")))
            for yaml_key, attr in _YAML_FLAG_KEYS.items():
                if yaml_key in plugin_data:
                    setattr(option, attr, bool(plugin_data[yaml_key]))
            option.arguments = _scalar_map(
                plugin_data.get("arguments") or None, _line_of(plugin_data, "arguments", oline), "arguments"
            )
            apply_plugin_conf_defaults(option)
            tier.plugins.append(option)
        conf.tiers.append(tier)
    return conf


def load_scheduler_conf(
    conf_str: str,
) -> tuple[list["Action"], list[Tier], dict[str, dict[str, str]]]:
    """YAML -> ([Action], [Tier], action_arguments); unknown action names
    raise (reference util.go:44-73). Imported lazily to avoid a framework
    import cycle."""
    from kube_batch_tpu_torch.framework import get_action

    conf = parse_scheduler_conf(conf_str)
    actions: list["Action"] = []
    for action_name in conf.actions.split(","):
        name = action_name.strip()
        if not name:
            continue
        action = get_action(name)
        if action is None:
            raise ValueError(f"failed to find Action {name!r}")
        actions.append(action)
    return actions, conf.tiers, conf.action_arguments


def read_scheduler_conf(conf_path: str) -> str:
    """reference util.go:75-81."""
    with open(conf_path, "r", encoding="utf-8") as f:
        return f.read()
