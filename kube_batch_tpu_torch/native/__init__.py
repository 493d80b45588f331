"""Native (C++) hot loops: the encoder's extractors, kernel B1's class
dedup and the replay's bulk session surgery (_hotloops.cpp).

``get()`` returns the compiled ``_hotloops`` module, built with g++ at
first use (native/build.py) into the package's _build directory, or None
when the package switch is off (``set_enabled(False)``: how the tests and
chip_smoke.py's reference runs take the Python twins) or the module could
not be built or loaded. Every caller keeps its Python twin for None and
for a native call that raises.

Nothing falls back quietly: a build or load failure and every native call
abandoned for its Python twin (``note_fallback``) are counted in
``fallbacks`` and logged; ``calls`` counts the native calls that returned
(``note_call``). chip_smoke.py fails on any fallback.
"""

from __future__ import annotations

import collections
import importlib.util
import logging
import sys
import threading

log = logging.getLogger(__name__)

MODULE_NAME = __name__ + "._hotloops"

_enabled = True
_lib = None
_load_error: Exception | None = None
_lock = threading.Lock()
_warned: set[str] = set()

#: native function -> calls that returned (the fast path ran)
calls: collections.Counter = collections.Counter()
#: native function (or "load") -> times its Python twin ran instead
fallbacks: collections.Counter = collections.Counter()


def set_enabled(flag: bool) -> None:
    """The package switch: off, every caller runs its Python twin."""
    global _enabled
    _enabled = bool(flag)


def load():
    """Build the module when missing and import it; raises on failure."""
    global _lib
    with _lock:
        if _lib is None:
            from kube_batch_tpu_torch.native import build

            path = build.ensure()
            spec = importlib.util.spec_from_file_location(MODULE_NAME, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            sys.modules[MODULE_NAME] = mod
            _lib = mod
    return _lib


def get():
    """The module, or None (switch off, or it cannot be built or loaded:
    counted once as a ``load`` fallback)."""
    global _load_error
    if not _enabled:
        return None
    if _lib is not None:
        return _lib
    if _load_error is not None:
        return None
    try:
        return load()
    except Exception as e:  # noqa: BLE001 -- any build/load failure means the Python twins
        _load_error = e
        note_fallback("load", e)
        return None


def note_call(fn: str) -> None:
    calls[fn] += 1


def note_fallback(fn: str, err: BaseException) -> None:
    """One native path abandoned for its Python twin: counted every time,
    logged once per function (the twin is correct, so this is a defect
    signal, not a failure of the cycle)."""
    fallbacks[fn] += 1
    if fn not in _warned:
        _warned.add(fn)
        log.warning("native %s failed; using the Python twin", fn, exc_info=err)


def reset_counts() -> None:
    calls.clear()
    fallbacks.clear()
