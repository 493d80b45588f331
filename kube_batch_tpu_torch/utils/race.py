"""Runtime happens-before race witness (the dynamic half of the
KBT-T thread analysis, as :class:`~kube_batch_tpu_torch.utils.locking.
LockOrderWitness` is the dynamic half of KBT-D).

:class:`RaceWitness` is a vector-clock data-race detector in the
Djit+/FastTrack family, sized for drills rather than production:

- ``wrap(name, lock)`` proxies a live lock (same surface as
  ``LockOrderWitness.wrap``); acquire joins the acquirer's clock with
  the lock's clock, release publishes the holder's clock into the lock
  — so two critical sections on one lock are always ordered.
- ``spawn(target)`` returns a thread whose start inherits the parent's
  clock (fork edge) and whose ``join()`` merges the child's final clock
  back (join edge) — so start/join-ordered accesses are ordered.
- ``watch(obj, fields)`` instruments declared hot fields (lane token
  buckets, resident-table patches, mirror entries, lease slot maps,
  fence state) with a lightweight data descriptor: every read/write
  records ``(thread epoch, lock-set, seq)``. Fields holding containers
  mutated in place should be declared ``"touch"`` — a bare attribute
  read is then treated as a potential mutation.

Two accesses to one field conflict when they are not both reads, come
from different threads, share no lock, and neither happens-before the
other under the vector clocks. Each report carries a deterministic
access-trace id (``field:seqA-seqB`` — seq numbers are assigned in
access order, so a deterministic drive reproduces them exactly, the way
KBT-I counterexamples replay under the ``VirtualClock``).

``KBT_RACE_WITNESS=1`` arms the witness inside the smokes/drills that
support it (the streaming chaos drive, the thread-analysis CLI); it is
never on in production paths.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Union

__all__ = [
    "ENV",
    "enabled",
    "RaceWitness",
    "thread_snapshot",
    "leaked_threads",
    "assert_no_leaked_threads",
]

ENV = "KBT_RACE_WITNESS"

_SLOT_PREFIX = "_race_witness$"


def enabled() -> bool:
    """The ``KBT_RACE_WITNESS`` env gate for drives that can arm a
    witness over their hot fields (off by default: instrumented reads
    cost a descriptor call each)."""
    return (os.environ.get(ENV, "") or "").strip().lower() in (
        "1", "true", "on", "yes"
    )


def _join_into(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if v > dst.get(k, 0):
            dst[k] = v


@dataclass(frozen=True)
class _Access:
    token: str  # logical thread id ("T0", "T1", ... in first-seen order)
    thread: str  # OS thread name at access time (for the report only)
    kind: str  # "r" read, "w" write, "t" touch (read of an in-place-mutable)
    stamp: int  # the issuing thread's own clock component at access time
    lockset: frozenset
    seq: int  # global deterministic access sequence number


class _WatchedField:
    """Data descriptor installed on a dynamic subclass by
    :meth:`RaceWitness.watch`. The value lives in the instance dict
    under a mangled slot so the descriptor always wins the lookup."""

    def __init__(self, witness: "RaceWitness", field: str, token: str, mode: str) -> None:
        self._witness = witness
        self._field = field
        self._token = token  # reported name (may alias several fields)
        self._slot = _SLOT_PREFIX + field
        self._mode = mode  # "rw" or "touch"

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        self._witness._access(self._token, "t" if self._mode == "touch" else "r")
        try:
            return obj.__dict__[self._slot]
        except KeyError:
            raise AttributeError(self._field) from None

    def __set__(self, obj, value) -> None:
        self._witness._access(self._token, "w")
        obj.__dict__[self._slot] = value


class _RaceLock:
    """Context-manager proxy: delegates to the wrapped lock while
    feeding acquire/release sync edges (and the thread's lock-set) to
    the witness. The Condition surface passes through untouched."""

    def __init__(self, witness: "RaceWitness", name: str, lock) -> None:
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


class _WitnessedThread(threading.Thread):
    """Thread whose start is a fork edge and whose join is a join edge."""

    def __init__(
        self, witness: "RaceWitness", snapshot: dict, token: str, *a, **kw
    ) -> None:
        super().__init__(*a, **kw)
        self._race_witness = witness
        self._race_snapshot = snapshot
        self._race_token = token

    def run(self) -> None:
        self._race_witness._thread_begin(self._race_snapshot, self._race_token)
        try:
            super().run()
        finally:
            self._race_witness._thread_end(self)

    def join(self, timeout: Optional[float] = None) -> None:
        super().join(timeout)
        if not self.is_alive():
            self._race_witness._join_edge(self)


class RaceWitness:
    """Vector-clock happens-before detector over wrapped locks,
    witnessed threads and watched fields. Drive the workload, then
    ``assert_clean()`` (or read ``reports``)."""

    # bounded per-field access history: old entries age out FIFO — long
    # drives stay O(1) per field, at the cost of missing races more
    # than HISTORY accesses apart (fine for drill-sized workloads)
    HISTORY = 128

    def __init__(self, clock: Optional[object] = None) -> None:
        self._mu = threading.Lock()
        self._clock = clock  # optional VirtualClock for report stamps
        self._tokens: dict[int, str] = {}  #: guarded_by _mu  (ident -> Tn)
        self._clocks: dict[str, dict] = {}  #: guarded_by _mu  (Tn -> VC)
        self._lock_clocks: dict[str, dict] = {}  #: guarded_by _mu
        self._locksets: dict[int, list] = {}  #: guarded_by _mu  (ident -> held)
        self._accesses: dict[str, list] = {}  #: guarded_by _mu  (field -> [_Access])
        self._final: dict[int, dict] = {}  #: guarded_by _mu  (thread id() -> VC)
        self._reported: set = set()  #: guarded_by _mu
        self._watched_classes: dict = {}  #: guarded_by _mu
        self._seq = 0  #: guarded_by _mu
        self._ntok = 0  #: guarded_by _mu
        self.reports: list[str] = []  #: guarded_by _mu
        # Optional observer called as on_access(name) after each watched
        # access. The interleaving model checker hangs its step-footprint
        # recorder here (field-level KBT-I002); None costs one attribute
        # read per access.
        self.on_access: Callable[[str], None] | None = None

    # -- clock plumbing ------------------------------------------------------

    def _token_locked(self, ident: int) -> str:
        tok = self._tokens.get(ident)
        if tok is None:
            tok = self._new_token_locked()
            self._tokens[ident] = tok
            self._clocks[tok] = {tok: 1}
        return tok

    def _new_token_locked(self) -> str:
        tok = f"T{self._ntok}"
        self._ntok += 1
        return tok

    def _note_acquire(self, name: str) -> None:
        ident = threading.get_ident()
        with self._mu:
            tok = self._token_locked(ident)
            _join_into(self._clocks[tok], self._lock_clocks.get(name, {}))
            self._locksets.setdefault(ident, []).append(name)

    def _note_release(self, name: str) -> None:
        ident = threading.get_ident()
        with self._mu:
            tok = self._token_locked(ident)
            vc = self._clocks[tok]
            lc = self._lock_clocks.setdefault(name, {})
            _join_into(lc, vc)
            vc[tok] = vc.get(tok, 0) + 1
            held = self._locksets.get(ident, [])
            for i in range(len(held) - 1, -1, -1):
                if held[i] == name:
                    del held[i]
                    break

    def _thread_begin(self, snapshot: dict, tok: str) -> None:
        # the token was allocated at spawn() time (deterministic spawn
        # order), NOT derived from the OS ident — idents are recycled,
        # and a recycled ident must not inherit a dead thread's clock
        ident = threading.get_ident()
        with self._mu:
            self._tokens[ident] = tok
            vc = dict(snapshot)
            vc[tok] = vc.get(tok, 0) + 1
            self._clocks[tok] = vc

    def _thread_end(self, thread: threading.Thread) -> None:
        ident = threading.get_ident()
        with self._mu:
            tok = self._token_locked(ident)
            self._final[id(thread)] = dict(self._clocks[tok])
            self._tokens.pop(ident, None)  # the ident may be recycled
            self._locksets.pop(ident, None)

    def _join_edge(self, thread: threading.Thread) -> None:
        ident = threading.get_ident()
        with self._mu:
            final = self._final.get(id(thread))
            if final is not None:
                tok = self._token_locked(ident)
                _join_into(self._clocks[tok], final)

    # -- public wiring -------------------------------------------------------

    def wrap(self, name: str, lock) -> _RaceLock:
        return _RaceLock(self, name, lock)

    def spawn(
        self,
        target: Callable,
        *,
        name: Optional[str] = None,
        args: tuple = (),
        kwargs: Optional[dict] = None,
        daemon: bool = True,
    ) -> _WitnessedThread:
        """A thread carrying fork/join happens-before edges. Not
        started; the caller starts and (bounded-)joins it."""
        ident = threading.get_ident()
        with self._mu:
            tok = self._token_locked(ident)
            vc = self._clocks[tok]
            snapshot = dict(vc)
            vc[tok] = vc.get(tok, 0) + 1
            child_tok = self._new_token_locked()
        return _WitnessedThread(
            self, snapshot, child_tok,
            target=target, name=name, args=args, kwargs=kwargs or {},
            daemon=daemon,
        )

    def watch(
        self,
        obj,
        fields: Union[Iterable[str], dict],
        token: Optional[str] = None,
    ):
        """Instrument ``obj``'s listed fields in place (the instance is
        moved onto a dynamic subclass carrying the descriptors).
        ``fields`` is an iterable (read/write semantics) or a
        ``{field: "rw" | "touch"}`` dict — declare ``"touch"`` for
        containers mutated in place, so a bare read counts as a
        potential write. ``token`` aliases every field to one reported
        name (the interleave footprint tokens); default is
        ``ClassName.field``. Returns ``obj``."""
        modes = dict(fields) if isinstance(fields, dict) else {
            f: "rw" for f in fields
        }
        cls = type(obj)
        key = (cls, tuple(sorted(modes.items())), token)
        with self._mu:
            sub = self._watched_classes.get(key)
            if sub is None:
                ns = {
                    f: _WatchedField(
                        self, f, token or f"{cls.__name__}.{f}", mode
                    )
                    for f, mode in modes.items()
                }
                ns["_race_witness_base"] = cls
                sub = type(cls.__name__, (cls,), ns)
                self._watched_classes[key] = sub
        for f in modes:
            if f in obj.__dict__:
                obj.__dict__[_SLOT_PREFIX + f] = obj.__dict__.pop(f)
        obj.__class__ = sub
        return obj

    @staticmethod
    def unwatch(obj):
        """Restore a watched instance to its original class (teardown
        hygiene so witness-free asserts see plain attributes)."""
        base = getattr(type(obj), "_race_witness_base", None)
        if base is None:
            return obj
        for slot in [k for k in obj.__dict__ if k.startswith(_SLOT_PREFIX)]:
            obj.__dict__[slot[len(_SLOT_PREFIX):]] = obj.__dict__.pop(slot)
        obj.__class__ = base
        return obj

    # -- detection -----------------------------------------------------------

    def _access(self, field: str, kind: str) -> None:
        ident = threading.get_ident()
        observer = self.on_access
        with self._mu:
            tok = self._token_locked(ident)
            vc = self._clocks[tok]
            seq = self._seq
            self._seq += 1
            lockset = frozenset(self._locksets.get(ident, ()))
            cur = _Access(
                tok, threading.current_thread().name, kind,
                vc.get(tok, 0), lockset, seq,
            )
            hist = self._accesses.setdefault(field, [])
            for prior in hist:
                if prior.token == tok:
                    continue
                if prior.kind == "r" and kind == "r":
                    continue
                if prior.stamp <= vc.get(prior.token, 0):
                    continue  # ordered by happens-before
                if prior.lockset & lockset:
                    continue  # a common lock orders them (defensive)
                dedup = (field, prior.token, tok, prior.kind, kind)
                if dedup in self._reported:
                    continue
                self._reported.add(dedup)
                stamp = (
                    f" t={self._clock.now():g}"
                    if self._clock is not None and hasattr(self._clock, "now")
                    else ""
                )
                self.reports.append(
                    f"race on {field}:{stamp} {_KINDS[kind]} by {tok} "
                    f"({cur.thread}, locks={sorted(lockset) or '{}'}) is "
                    f"unordered with {_KINDS[prior.kind]} by {prior.token} "
                    f"({prior.thread}, locks={sorted(prior.lockset) or '{}'}) "
                    f"[trace {field}:{prior.seq}-{seq}]"
                )
            hist.append(cur)
            if len(hist) > self.HISTORY:
                del hist[: len(hist) - self.HISTORY]
        if observer is not None:
            observer(field)

    def assert_clean(self) -> None:
        with self._mu:
            if self.reports:
                raise AssertionError(
                    "race witness recorded unordered conflicting accesses:\n  "
                    + "\n  ".join(self.reports)
                )


_KINDS = {"r": "read", "w": "write", "t": "touch"}


# -- leaked-thread teardown helper --------------------------------------------


def thread_snapshot() -> set:
    """idents of currently-alive threads (take before the code under
    test starts any)."""
    return {t.ident for t in threading.enumerate()}


def leaked_threads(
    before: set,
    *,
    grace_s: float = 2.0,
    include_daemon: bool = False,
) -> list:
    """Threads alive now that were not in ``before``, after a bounded
    grace join. Non-daemon leaks hang interpreter shutdown and always
    count; daemon leaks (a pump whose ``stop()`` was never called)
    count only with ``include_daemon`` — prefixes ``kb-``/``kbt-`` name
    this package's own thread roots in the report."""
    fresh = [
        t for t in threading.enumerate()
        if t.ident not in before and t is not threading.current_thread()
    ]
    deadline = time.monotonic() + grace_s
    for t in fresh:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break
        t.join(timeout=remaining)
    return [
        t for t in fresh
        if t.is_alive() and (include_daemon or not t.daemon)
    ]


def assert_no_leaked_threads(before: set, **kw) -> None:
    leaked = leaked_threads(before, **kw)
    if leaked:
        raise AssertionError(
            "leaked thread(s) past teardown: "
            + ", ".join(
                f"{t.name}{' (daemon)' if t.daemon else ''}" for t in leaked
            )
            + " — every start() needs a reachable bounded join/stop path"
        )
