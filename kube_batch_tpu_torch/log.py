"""glog-style leveled logging for the whole package, the counterpart of
the JAX package's ``log.py``.

- ``V(n).infof(...)`` emits only when the verbosity is >= n (set with
  ``set_verbosity``, or the ``KB_TPU_V`` environment variable read at
  import, like glog's ``-v`` flag);
- ``errorf`` / ``warningf`` / ``infof`` are unconditional, at the
  matching stdlib severities;
- the line format is glog's ``I0729 18:22:08.123456 file.py:42] ...``
  (``GlogFormatter``).

Every line goes through stdlib loggers under ``kube_batch_tpu_torch``, so
a host application re-routes them with ordinary handlers. Unlike the JAX
module, the package logger keeps ``propagate`` on: at its first line this
module gives it a glog handler on stderr only where the root logger has
none (a host application, ``server.run`` or a test's log capture already
takes the records there, and a second handler would print each twice).

The verbosity decides only what the code itself narrates per object
(per-gang dispatch lines at 4 and above). A hot path gates on it, never
on whether some logger is enabled for DEBUG: a host application's
logging setup must not change which path the scheduler takes.
"""

from __future__ import annotations

import logging
import os
import sys
import time

_logger = logging.getLogger("kube_batch_tpu_torch")
_verbosity = int(os.environ.get("KB_TPU_V", "0"))


class GlogFormatter(logging.Formatter):
    """glog's line: severity letter, month and day, the time to the
    microsecond, ``file:line]``, the message."""

    _SEV = {"DEBUG": "I", "INFO": "I", "WARNING": "W", "ERROR": "E", "CRITICAL": "F"}

    def format(self, record: logging.LogRecord) -> str:
        t = time.localtime(record.created)
        return (
            f"{self._SEV.get(record.levelname, 'I')}"
            f"{t.tm_mon:02d}{t.tm_mday:02d} "
            f"{t.tm_hour:02d}:{t.tm_min:02d}:{t.tm_sec:02d}."
            f"{int(record.msecs * 1000):06d} "
            f"{record.filename}:{record.lineno}] {record.getMessage()}"
        )


def glog_handler() -> logging.Handler:
    """A stderr handler with the glog formatter (``server.run`` puts one on
    the root logger)."""
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(GlogFormatter())
    return h


def _ensure_handler() -> None:
    if not _logger.handlers and not logging.getLogger().handlers:
        _logger.addHandler(glog_handler())
        if _logger.level == logging.NOTSET:
            _logger.setLevel(logging.INFO)


def set_verbosity(v: int) -> None:
    """Equivalent of glog's ``-v`` flag."""
    global _verbosity
    _verbosity = int(v)


def get_verbosity() -> int:
    return _verbosity


class _Verbose:
    __slots__ = ("enabled",)

    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled

    def infof(self, fmt: str, *args) -> None:
        if self.enabled:
            _ensure_handler()
            _logger.info(fmt % args if args else fmt, stacklevel=2)


def V(level: int) -> _Verbose:  # noqa: N802 (glog parity)
    return _Verbose(_verbosity >= level)


def infof(fmt: str, *args) -> None:
    _ensure_handler()
    _logger.info(fmt % args if args else fmt, stacklevel=2)


def warningf(fmt: str, *args) -> None:
    _ensure_handler()
    _logger.warning(fmt % args if args else fmt, stacklevel=2)


def errorf(fmt: str, *args) -> None:
    _ensure_handler()
    _logger.error(fmt % args if args else fmt, stacklevel=2)
