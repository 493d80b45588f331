"""The package's verbosity, the counterpart of glog's ``-v``.

Log lines go through stdlib loggers under ``kube_batch_tpu_torch``; this
level decides only what the code itself narrates per object (per-gang
dispatch lines at 4 and above). A hot path gates on it, never on whether
some logger is enabled for DEBUG: a host application's logging setup
must not change which path the scheduler takes.
"""

from __future__ import annotations

_verbosity = 0


def set_verbosity(v: int) -> None:
    global _verbosity
    _verbosity = int(v)


def get_verbosity() -> int:
    return _verbosity
