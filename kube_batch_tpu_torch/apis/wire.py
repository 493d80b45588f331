"""Full-fidelity wire codec for the store-backend protocol.

The scheduler HTTP endpoints in ``server.py`` serialize objects for
*observability* — a pod on ``/apis/v1alpha1/pods`` carries only
namespace/name/phase/node. A networked store backend
(``cache/backend.py``) needs the whole object back: requests, gang
annotations, affinity, tolerations — everything the solve reads. This
module is that codec: a generic recursive encoder/decoder over the
``apis/types.py`` dataclasses, driven by field type hints, so a new
field on any API type rides the wire without touching this file.

Encoding rules: dataclass -> dict of encoded fields, str-Enum -> its
value, dict -> encoded values (keys stay strings), list/tuple -> JSON
array, scalars/None pass through. Decoding inverts field-by-field from
the declared type; unknown wire fields are ignored (forward
compatibility) and missing ones fall back to the dataclass default.

Wire protocol v2 (negotiated, see deployment/README.md) adds two layers
on top of the same wire-dict data model:

- **binary framing** (``dumps_binary`` / ``loads_binary``): a
  length-prefixed msgpack-style tagged encoding of the wire dicts —
  stdlib-only, big-endian, every string/container length-prefixed, the
  whole message behind a 4-byte magic + payload length header so a
  codec mismatch fails loudly instead of half-parsing. Round-trip
  equality against the JSON codec is pinned by the ``--json``
  self-check CLI (``python -m kube_batch_tpu_torch.apis.wire --json``) and
  tests/test_wire_v2.py (the port: tests/test_torch_wire_v2.py).
- **field-level deltas** (``delta_of`` / ``apply_delta``): a MODIFIED
  watch event under v2 carries only the changed top-level fields (plus
  tombstones for fields the encoding dropped) instead of the full
  object; the client mirror applies the patch in place via
  ``dataclasses.replace``.
"""

from __future__ import annotations

import dataclasses
import struct
import typing
from enum import Enum
from typing import Any, Optional, Union

from kube_batch_tpu_torch.apis import types as api_types

__all__ = [
    "KIND_TYPES",
    "CODECS",
    "BINARY_CONTENT_TYPE",
    "JSON_CONTENT_TYPE",
    "to_wire",
    "from_wire",
    "decode_kind",
    "encode_kind",
    "dumps_binary",
    "loads_binary",
    "delta_of",
    "apply_delta",
]

# Negotiable codecs for the /backend/v1/ surface. "json" is the v1
# baseline every server speaks; "binary" is offered by v2 servers in
# their /backend/v1/version capability advertisement.
CODECS = ("json", "binary")
JSON_CONTENT_TYPE = "application/json"
BINARY_CONTENT_TYPE = "application/x-kbt-binary"

# kind name (cache/store.py KINDS) -> dataclass; string keys on purpose:
# apis/ sits below cache/ in the layering and must not import it.
KIND_TYPES: dict[str, type] = {
    "pods": api_types.Pod,
    "nodes": api_types.Node,
    "podgroups": api_types.PodGroup,
    "queues": api_types.Queue,
    "poddisruptionbudgets": api_types.PodDisruptionBudget,
    "priorityclasses": api_types.PriorityClass,
    "persistentvolumes": api_types.PersistentVolume,
    "persistentvolumeclaims": api_types.PersistentVolumeClaim,
    "storageclasses": api_types.StorageClass,
    "leases": api_types.Lease,
}

_hints_cache: dict[type, dict[str, Any]] = {}


def _hints(cls: type) -> dict[str, Any]:
    hints = _hints_cache.get(cls)
    if hints is None:
        # types.py uses `from __future__ import annotations`: field types
        # are strings until resolved against the defining module
        hints = typing.get_type_hints(cls, vars(api_types))
        _hints_cache[cls] = hints
    return hints


def to_wire(obj: Any) -> Any:
    """Encode any API object (or nested fragment) to JSON-able data."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            f.name: to_wire(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, Enum):
        return obj.value
    if isinstance(obj, dict):
        return {k: to_wire(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_wire(v) for v in obj]
    return obj


def from_wire(hint: Any, data: Any) -> Any:
    """Decode wire data back into the shape ``hint`` declares."""
    origin = typing.get_origin(hint)
    if origin is Union:
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        if data is None:
            return None
        return from_wire(args[0], data) if args else data
    if origin in (list, tuple):
        args = typing.get_args(hint)
        if data is None:
            return [] if origin is list else ()
        if origin is list:
            inner = args[0] if args else Any
            return [from_wire(inner, v) for v in data]
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(from_wire(args[0], v) for v in data)
        return tuple(
            from_wire(args[i] if i < len(args) else Any, v)
            for i, v in enumerate(data)
        )
    if origin is dict:
        args = typing.get_args(hint)
        inner = args[1] if len(args) == 2 else Any
        return {k: from_wire(inner, v) for k, v in (data or {}).items()}
    if isinstance(hint, type) and issubclass(hint, Enum):
        return hint(data)
    if isinstance(hint, type) and dataclasses.is_dataclass(hint):
        if data is None:
            return None
        hints = _hints(hint)
        names = {f.name for f in dataclasses.fields(hint)}
        kwargs = {
            k: from_wire(hints.get(k, Any), v)
            for k, v in data.items()
            if k in names
        }
        return hint(**kwargs)
    return data


def decode_kind(kind: str, data: dict) -> Any:
    """Decode one wire object of the named store kind."""
    cls = KIND_TYPES.get(kind)
    if cls is None:
        raise KeyError(f"unknown wire kind {kind!r}")
    return from_wire(cls, data)


def encode_kind(kind: str, obj: Any) -> Optional[dict]:
    """Encode one store object of the named kind (None passes through —
    watch deletes carry no new object)."""
    if obj is None:
        return None
    if kind not in KIND_TYPES:
        raise KeyError(f"unknown wire kind {kind!r}")
    return to_wire(obj)


# -- binary framing (wire protocol v2) ---------------------------------------
#
# Tagged msgpack-style encoding of the SAME wire-dict data model the
# JSON codec carries (None/bool/int/float/str/list/dict). Big-endian
# throughout; every string and container is length-prefixed; the whole
# message rides behind a magic + payload-length header. Hand-rolled on
# struct only — the container bakes no msgpack dependency, and the
# subset here is exactly what to_wire can produce.

_MAGIC = b"KBW2"  # 4-byte frame magic: "kbt binary wire, protocol 2"

_T_NONE = 0xC0
_T_FALSE = 0xC2
_T_TRUE = 0xC3
_T_F64 = 0xCB
_T_U8, _T_U16, _T_U32, _T_U64 = 0xCC, 0xCD, 0xCE, 0xCF
_T_I8, _T_I16, _T_I32, _T_I64 = 0xD0, 0xD1, 0xD2, 0xD3
_T_S8, _T_S16, _T_S32 = 0xD9, 0xDA, 0xDB
_T_A16, _T_A32 = 0xDC, 0xDD
_T_M16, _T_M32 = 0xDE, 0xDF


def _pack_value(obj: Any, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int) and not isinstance(obj, bool):
        if 0 <= obj < 0x80:
            out.append(struct.pack(">B", obj))
        elif -32 <= obj < 0:
            out.append(struct.pack(">B", 0x100 + obj))
        elif obj >= 0:
            for tag, fmt, hi in (
                (_T_U8, ">B", 1 << 8), (_T_U16, ">H", 1 << 16),
                (_T_U32, ">I", 1 << 32), (_T_U64, ">Q", 1 << 64),
            ):
                if obj < hi:
                    out.append(struct.pack(">B", tag) + struct.pack(fmt, obj))
                    return
            raise ValueError(f"int too large for binary wire codec: {obj}")
        else:
            for tag, fmt, lo in (
                (_T_I8, ">b", -(1 << 7)), (_T_I16, ">h", -(1 << 15)),
                (_T_I32, ">i", -(1 << 31)), (_T_I64, ">q", -(1 << 63)),
            ):
                if obj >= lo:
                    out.append(struct.pack(">B", tag) + struct.pack(fmt, obj))
                    return
            raise ValueError(f"int too small for binary wire codec: {obj}")
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", _T_F64, obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            out.append(struct.pack(">B", 0xA0 | n))
        elif n < 0x100:
            out.append(struct.pack(">BB", _T_S8, n))
        elif n < 0x10000:
            out.append(struct.pack(">BH", _T_S16, n))
        else:
            out.append(struct.pack(">BI", _T_S32, n))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(struct.pack(">B", 0x90 | n))
        elif n < 0x10000:
            out.append(struct.pack(">BH", _T_A16, n))
        else:
            out.append(struct.pack(">BI", _T_A32, n))
        for v in obj:
            _pack_value(v, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(struct.pack(">B", 0x80 | n))
        elif n < 0x10000:
            out.append(struct.pack(">BH", _T_M16, n))
        else:
            out.append(struct.pack(">BI", _T_M32, n))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"binary wire map keys must be str, got {type(k).__name__}")
            _pack_value(k, out)
            _pack_value(v, out)
    else:
        raise TypeError(f"type not encodable on the binary wire: {type(obj).__name__}")


def _unpack_value(data: bytes, pos: int) -> tuple[Any, int]:
    if pos >= len(data):
        raise ValueError("binary wire payload truncated")
    tag = data[pos]
    pos += 1
    if tag < 0x80:
        return tag, pos
    if tag >= 0xE0:
        return tag - 0x100, pos
    if 0xA0 <= tag < 0xC0:
        n = tag & 0x1F
        return data[pos:pos + n].decode("utf-8"), pos + n
    if 0x90 <= tag < 0xA0:
        return _unpack_seq(data, pos, tag & 0x0F)
    if 0x80 <= tag < 0x90:
        return _unpack_map(data, pos, tag & 0x0F)
    if tag == _T_NONE:
        return None, pos
    if tag == _T_TRUE:
        return True, pos
    if tag == _T_FALSE:
        return False, pos
    if tag == _T_F64:
        return struct.unpack_from(">d", data, pos)[0], pos + 8
    for t, fmt, size in (
        (_T_U8, ">B", 1), (_T_U16, ">H", 2), (_T_U32, ">I", 4), (_T_U64, ">Q", 8),
        (_T_I8, ">b", 1), (_T_I16, ">h", 2), (_T_I32, ">i", 4), (_T_I64, ">q", 8),
    ):
        if tag == t:
            return struct.unpack_from(fmt, data, pos)[0], pos + size
    for t, fmt, size in ((_T_S8, ">B", 1), (_T_S16, ">H", 2), (_T_S32, ">I", 4)):
        if tag == t:
            n = struct.unpack_from(fmt, data, pos)[0]
            pos += size
            if pos + n > len(data):
                raise ValueError("binary wire payload truncated")
            return data[pos:pos + n].decode("utf-8"), pos + n
    if tag in (_T_A16, _T_A32):
        fmt, size = (">H", 2) if tag == _T_A16 else (">I", 4)
        n = struct.unpack_from(fmt, data, pos)[0]
        return _unpack_seq(data, pos + size, n)
    if tag in (_T_M16, _T_M32):
        fmt, size = (">H", 2) if tag == _T_M16 else (">I", 4)
        n = struct.unpack_from(fmt, data, pos)[0]
        return _unpack_map(data, pos + size, n)
    raise ValueError(f"unknown binary wire tag 0x{tag:02x}")


def _unpack_seq(data: bytes, pos: int, n: int) -> tuple[list, int]:
    items = []
    for _ in range(n):
        v, pos = _unpack_value(data, pos)
        items.append(v)
    return items, pos


def _unpack_map(data: bytes, pos: int, n: int) -> tuple[dict, int]:
    items = {}
    for _ in range(n):
        k, pos = _unpack_value(data, pos)
        if not isinstance(k, str):
            raise ValueError("binary wire map key is not a string")
        v, pos = _unpack_value(data, pos)
        items[k] = v
    return items, pos


def dumps_binary(obj: Any) -> bytes:
    """Encode wire-dict data (the to_wire data model) to a framed
    binary message: ``KBW2`` magic + u32 payload length + payload."""
    out: list = []
    _pack_value(obj, out)
    payload = b"".join(out)
    return _MAGIC + struct.pack(">I", len(payload)) + payload


def loads_binary(data: bytes) -> Any:
    """Inverse of :func:`dumps_binary`. A wrong-codec body (JSON bytes
    handed to the binary decoder, or vice versa) fails on the frame
    magic — the loud half of the codec-mismatch triage ladder."""
    if len(data) < 8 or data[:4] != _MAGIC:
        raise ValueError(
            "not a KBW2 binary wire frame (codec mismatch? the peer may "
            "be speaking JSON — check KBT_WIRE_CODEC and the negotiated "
            "protocol on /backend/v1/version)"
        )
    (n,) = struct.unpack_from(">I", data, 4)
    if len(data) != 8 + n:
        raise ValueError(
            f"binary wire frame length mismatch (header says {n}, "
            f"got {len(data) - 8} payload bytes)"
        )
    value, pos = _unpack_value(data, 8)
    if pos != len(data):
        raise ValueError("binary wire frame has trailing bytes")
    return value


# -- field-level deltas (wire protocol v2 watch) -----------------------------

_MISSING = object()


def delta_of(kind: str, old_obj: Any, new_obj: Any) -> dict:
    """Field-level patch turning ``old_obj`` into ``new_obj``:
    ``{"changed": {field: wire value}, "removed": [field, ...]}``.
    Top-level dataclass fields only — nested changes ride as the whole
    changed field, which for the hot MODIFIED event (a pod bind:
    node_name + phase) is a fraction of the full object."""
    if kind not in KIND_TYPES:
        raise KeyError(f"unknown wire kind {kind!r}")
    old_w = to_wire(old_obj) or {}
    new_w = to_wire(new_obj) or {}
    changed = {k: v for k, v in new_w.items() if old_w.get(k, _MISSING) != v}
    removed = [k for k in old_w if k not in new_w]
    return {"changed": changed, "removed": removed}


def apply_delta(kind: str, obj: Any, delta: dict) -> Any:
    """Apply a :func:`delta_of` patch to a decoded object, returning the
    patched object (``dataclasses.replace`` — the input is not mutated,
    preserving the mirror's replace-don't-mutate contract). Removed
    fields reset to their dataclass default."""
    cls = KIND_TYPES.get(kind)
    if cls is None:
        raise KeyError(f"unknown wire kind {kind!r}")
    hints = _hints(cls)
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs: dict[str, Any] = {}
    for name, value in (delta.get("changed") or {}).items():
        if name in fields:  # unknown fields: same forward-compat rule as from_wire
            kwargs[name] = from_wire(hints.get(name, Any), value)
    for name in delta.get("removed") or ():
        f = fields.get(name)
        if f is None:
            continue
        if f.default is not dataclasses.MISSING:
            kwargs[name] = f.default
        elif f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
            kwargs[name] = f.default_factory()  # type: ignore[misc]
    return dataclasses.replace(obj, **kwargs)


# -- seeded self-check CLI (python -m kube_batch_tpu_torch.apis.wire) ---------


def _gen_value(hint: Any, rng, depth: int = 0) -> Any:
    """Generate a seeded value of the hinted type (the property-test
    input source: every API dataclass, every field, no fixtures)."""
    origin = typing.get_origin(hint)
    if origin is Union:
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        if not args or rng.random() < 0.25:
            return None
        return _gen_value(args[0], rng, depth)
    if origin is list:
        args = typing.get_args(hint)
        inner = args[0] if args else str
        return [_gen_value(inner, rng, depth + 1) for _ in range(rng.randrange(3))]
    if origin is tuple:
        args = typing.get_args(hint)
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(
                _gen_value(args[0], rng, depth + 1) for _ in range(rng.randrange(3))
            )
        return tuple(_gen_value(a, rng, depth + 1) for a in args)
    if origin is dict:
        args = typing.get_args(hint)
        inner = args[1] if len(args) == 2 else str
        return {
            f"k{rng.randrange(1000)}": _gen_value(inner, rng, depth + 1)
            for _ in range(rng.randrange(3))
        }
    if isinstance(hint, type) and issubclass(hint, Enum):
        return rng.choice(list(hint))
    if isinstance(hint, type) and dataclasses.is_dataclass(hint):
        hints = _hints(hint)
        return hint(**{
            f.name: _gen_value(hints.get(f.name, str), rng, depth + 1)
            for f in dataclasses.fields(hint)
        })
    if hint is bool:
        return rng.random() < 0.5
    if hint is int:
        return rng.randrange(-(1 << 40), 1 << 40)
    if hint is float:
        return rng.choice([0.0, 1.5, -2.25, float(rng.randrange(1 << 30))])
    if hint is str:
        return "".join(rng.choice("abcdefghij-/ü") for _ in range(rng.randrange(12)))
    return f"any{rng.randrange(100)}"


def self_check(seed: int = 0, cases: int = 5) -> dict:
    """Seeded codec property suite over every wire kind. Properties:
    JSON round trip == dataclass; binary round trip == JSON wire dict
    AND == dataclass; cross-codec re-encode is byte-stable; unknown
    wire fields are tolerated; delta_of/apply_delta reproduces a
    mutated object exactly."""
    import json as _json
    import random as _random

    rng = _random.Random(seed)
    checked = failures = 0
    json_bytes = binary_bytes = 0
    errors: list[str] = []
    for kind, cls in sorted(KIND_TYPES.items()):
        for case in range(cases):
            checked += 1
            try:
                obj = _gen_value(cls, rng)
                wire_dict = encode_kind(kind, obj)
                jtext = _json.dumps(wire_dict, sort_keys=True)
                json_bytes += len(jtext.encode())
                # 1: JSON round trip inverts to the same dataclass
                assert decode_kind(kind, _json.loads(jtext)) == obj, "json != dataclass"
                # 2: binary round trip preserves the wire dict and object
                frame = dumps_binary(wire_dict)
                binary_bytes += len(frame)
                back = loads_binary(frame)
                assert back == wire_dict, "binary wire dict drifted"
                assert decode_kind(kind, back) == obj, "binary != dataclass"
                # 3: cross-codec re-encode stability (binary -> json -> binary)
                assert _json.dumps(back, sort_keys=True) == jtext, "re-encode unstable"
                assert dumps_binary(back) == frame, "binary re-encode unstable"
                # 4: unknown-field tolerance (forward compatibility)
                poisoned = dict(wire_dict)
                poisoned["__future_field__"] = {"nested": [1, 2.5, "x", None]}
                assert decode_kind(kind, poisoned) == obj, "unknown field broke decode"
                # 5: delta round trip on a mutated twin
                twin = _gen_value(cls, rng)
                patch = delta_of(kind, obj, twin)
                assert apply_delta(kind, obj, patch) == twin, "delta != twin"
            except Exception as e:  # noqa: BLE001 - the gate reports, not raises
                failures += 1
                errors.append(f"{kind}[{case}]: {e}")
    return {
        "ok": failures == 0,
        "kinds": len(KIND_TYPES),
        "cases": checked,
        "failures": failures,
        "errors": errors[:10],
        "json_bytes": json_bytes,
        "binary_bytes": binary_bytes,
        "seed": seed,
    }


def main(argv: Optional[list] = None) -> int:
    import argparse
    import json as _json

    ap = argparse.ArgumentParser(
        prog="python -m kube_batch_tpu_torch.apis.wire",
        description="Wire-codec self-check: seeded JSON/binary/delta "
                    "round-trip properties over every API kind.",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cases", type=int, default=5, help="cases per kind")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit one machine-readable summary line")
    args = ap.parse_args(argv)
    summary = self_check(seed=args.seed, cases=args.cases)
    if args.as_json:
        print(_json.dumps(summary, sort_keys=True))
    else:
        for err in summary["errors"]:
            print(f"wire: FAIL {err}")
        print(
            f"wire: {'ok' if summary['ok'] else 'FAILED'} "
            f"({summary['cases']} cases over {summary['kinds']} kinds, "
            f"json {summary['json_bytes']}B vs binary {summary['binary_bytes']}B)"
        )
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
