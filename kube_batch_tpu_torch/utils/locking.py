"""Lock-discipline markers and a runtime lock-order witness.

The threaded layers (cache, store, workqueue, journal, watch hub)
follow a clone-under-mutex discipline: every attribute declared guarded
must only be touched lexically inside ``with self.<lock>`` or in a
method the caller promises to invoke with the lock held. Two ways to
make that promise, both checked statically:

- name the method with a ``_locked`` suffix (the convention
  ``WatchHub._activate_locked`` already uses), or
- decorate it with :func:`assume_locked`.

``assume_locked`` is a runtime no-op — it exists so the promise is
visible at the definition site and greppable, so a reader can tell a
deliberate lock-held helper from a forgotten ``with``.
"""

from __future__ import annotations

import threading
from typing import Callable, TypeVar

_F = TypeVar("_F", bound=Callable)


def assume_locked(fn: _F) -> _F:
    """Mark ``fn`` as called only with its owner's lock already held.

    Keep these helpers small and truly internal (leading underscore):
    the marker is a promise about every caller."""
    fn.__assume_locked__ = True  # type: ignore[attr-defined]
    return fn


class _WitnessedLock:
    """Context-manager proxy delegating to the wrapped lock while
    reporting acquire/release to the witness. Passes through the
    Condition surface (wait/notify/...) untouched."""

    def __init__(self, witness: "LockOrderWitness", name: str, lock) -> None:
        self._witness = witness
        self._name = name
        self._lock = lock

    def __enter__(self):
        self._lock.acquire()
        self._witness._note_acquire(self._name)
        return self

    def __exit__(self, *exc):
        self._witness._note_release(self._name)
        self._lock.release()
        return False

    def acquire(self, *a, **kw):
        got = self._lock.acquire(*a, **kw)
        if got:
            self._witness._note_acquire(self._name)
        return got

    def release(self):
        self._witness._note_release(self._name)
        return self._lock.release()

    def __getattr__(self, attr):  # wait/notify/notify_all/locked/...
        return getattr(self._lock, attr)


class LockOrderWitness:
    """Record the observed lock acquisition order as directed edges
    (held -> acquired, per thread-local held stack) and flag the first
    reversal. It sees the dynamic graph — event handlers, plugin
    callbacks, anything dispatched through indirection. Wrap the locks
    under test (``obj._mutex = witness.wrap("SchedulerCache._mutex",
    obj._mutex)``), drive the workload, then assert ``violations == []``.

    A violation records both edge sites: the pair was acquired A-then-B
    on one path and B-then-A on another — the classic ABBA interleaving
    that deadlocks under load without ever deadlocking in the test."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._tls = threading.local()
        self._edges: dict[tuple[str, str], str] = {}  #: guarded_by _mu
        self.violations: list[str] = []  #: guarded_by _mu
        # Optional observer called as on_acquire(name) after each
        # acquisition is recorded; None costs one attribute read per
        # acquire.
        self.on_acquire: Callable[[str], None] | None = None

    def wrap(self, name: str, lock) -> _WitnessedLock:
        return _WitnessedLock(self, name, lock)

    def _held(self) -> list:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _note_acquire(self, name: str) -> None:
        held = self._held()
        if held:
            where = threading.current_thread().name
            with self._mu:
                for h in held:
                    if h == name:
                        continue
                    self._edges.setdefault((h, name), where)
                    rev = self._edges.get((name, h))
                    if rev is not None:
                        msg = (
                            f"lock-order reversal: {h} -> {name} "
                            f"(thread {where}) vs {name} -> {h} "
                            f"(thread {rev})"
                        )
                        if msg not in self.violations:
                            self.violations.append(msg)
        held.append(name)
        if self.on_acquire is not None:
            self.on_acquire(name)

    def _note_release(self, name: str) -> None:
        held = self._held()
        if name in held:
            # remove the innermost occurrence (non-LIFO release is legal
            # for plain Locks)
            for i in range(len(held) - 1, -1, -1):
                if held[i] == name:
                    del held[i]
                    break

    def assert_clean(self) -> None:
        with self._mu:
            if self.violations:
                raise AssertionError(
                    "lock-order witness recorded reversals:\n  "
                    + "\n  ".join(self.violations)
                )
