"""Pipelined scheduling cycles (``KBT_PIPELINE``, default off).

The synchronous cycle is encode-upload -> device solve -> replay/dispatch,
back to back. This module owns the machinery that overlaps the third
phase with the *next* cycle:

- :class:`DispatchFence` — a process-wide rendezvous between cycle N's
  deferred replay/dispatch (submitted onto the cache's kb-write pool by
  ``actions/torch_allocate``) and cycle N+1, which must not snapshot the
  cluster until N's binds have landed. The fence preserves the
  statement/journal ordering the synchronous path gets for free:
  dispatch N < snapshot N+1 < dispatch N+1.
- **Loud degradation** — a fence timeout (wedged writer pool, or the
  ``pipeline.fence`` fault point in a drill) marks the pipeline
  degraded: :func:`enabled` flips false, every subsequent cycle runs the
  synchronous path, a degraded-cycle metric and a flight-recorder dump
  fire. Degradation is sticky until :func:`reset` (operator action /
  test hygiene) because a fence that timed out once has already proven
  the overlap assumption wrong for this process.
- overlap accounting — ``pipeline_overlap_fraction`` is MEASURED, not
  inferred: the deferred finisher stamps its dispatch window
  ``[d0, d1]`` (:meth:`DispatchFence.record_dispatch_window`), the
  consumer's join stamps its blocked window ``[w0, w1]``, and the
  fraction is ``1 - |[w0,w1] ∩ [d0,d1]| / (d1 - d0)``: 1.0 means the
  dispatch ran entirely under the next cycle's work, 0.0 means the
  fence serialized the cycles after all. Exposed as
  ``fence.last_overlap_fraction`` for a harness's per-run record
  (chip_smoke.py's ``pipelined_50k_5k``);
  ``pipeline_fence_wait_seconds`` records every wait.

Sessions carry the in-flight work as ``ssn.deferred_dispatch`` (a
``concurrent.futures.Future``); ``framework.close_session`` joins it
before the commit write-back so job status never races the binds it
describes. Caches without a writer pool (``testing.FakeCache``) fall
back to a lazy module-level single-thread executor, so the pipelined
path is testable without the full cache daemon.

Env knobs: ``KBT_PIPELINE`` turns the pipeline on;
``KBT_PIPELINE_FENCE_TIMEOUT_S`` bounds the fence wait (default 30s).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Callable, Optional

from kube_batch_tpu_torch import faults, metrics

log = logging.getLogger(__name__)

__all__ = [
    "ENV",
    "FENCE_TIMEOUT_ENV",
    "DispatchFence",
    "fence",
    "enabled",
    "env_on",
    "fence_timeout_s",
    "submit",
    "join_session",
    "reset",
]

ENV = "KBT_PIPELINE"
FENCE_TIMEOUT_ENV = "KBT_PIPELINE_FENCE_TIMEOUT_S"

_TRUTHY = ("1", "true", "on", "yes")


def env_on() -> bool:
    """The raw env gate, ignoring degradation state."""
    return (os.environ.get(ENV, "") or "").strip().lower() in _TRUTHY


def enabled() -> bool:
    """Pipelined cycles are on: env gate set AND the fence has not
    degraded this process to the synchronous path."""
    return env_on() and fence.degraded_reason is None


def fence_timeout_s() -> float:
    raw = os.environ.get(FENCE_TIMEOUT_ENV, "")
    try:
        return float(raw) if raw else 30.0
    except ValueError:
        log.error("%s=%r is not a number; using 30", FENCE_TIMEOUT_ENV, raw)
        return 30.0


class DispatchFence:
    """Rendezvous between cycle N's deferred dispatch and cycle N+1.

    ``arm(future)`` is called by the action after submitting the
    post-solve phase; ``wait()`` is called at the top of the next cycle
    (and by a harness between repeats). ``wait()`` returning
    False means the caller must NOT proceed with a pipelined cycle: the
    dispatch either timed out (still in flight — the future stays armed
    so a later wait can re-join it) or raised (already logged by the
    finisher; the fence only records the degradation).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._future: Optional[Future] = None  #: guarded_by _lock
        self._dispatch_s = 0.0  #: guarded_by _lock
        self._dispatch_t0 = 0.0  #: guarded_by _lock
        self._dispatch_t1 = 0.0  #: guarded_by _lock
        # one overlap sample per dispatch window: the FIRST join after a
        # window records it, later joins of the same window do not
        self._overlap_fresh = False  #: guarded_by _lock
        self.last_overlap_fraction: Optional[float] = None  #: guarded_by _lock
        self.degraded_reason: Optional[str] = None  #: guarded_by _lock

    def arm(self, future: Future) -> None:
        with self._lock:
            self._future = future

    def pending(self) -> bool:
        with self._lock:
            return self._future is not None and not self._future.done()

    def record_dispatch_window(self, t0: float, t1: float) -> None:
        """Called by the deferred finisher with its own
        ``time.perf_counter()`` start/end stamps — the denominator of
        the measured overlap fraction."""
        with self._lock:
            self._dispatch_t0 = float(t0)
            self._dispatch_t1 = float(t1)
            self._dispatch_s = max(0.0, float(t1) - float(t0))
            self._overlap_fresh = True

    def record_dispatch_seconds(self, seconds: float) -> None:
        """Back-compat duration form: a dispatch that just finished,
        ``seconds`` long (window ends now)."""
        now = time.perf_counter()
        self.record_dispatch_window(now - float(seconds), now)

    def record_join(self, w0: float, w1: float) -> None:
        """One consumer join of the deferred dispatch, blocked over
        ``[w0, w1]``. Computes the device-event-honest overlap fraction
        against the recorded dispatch window: the share of the dispatch
        that did NOT block the join."""
        with self._lock:
            if not self._overlap_fresh or self._dispatch_t1 <= self._dispatch_t0:
                return
            d0, d1 = self._dispatch_t0, self._dispatch_t1
            self._overlap_fresh = False
            blocked = max(0.0, min(w1, d1) - max(w0, d0))
            fraction = max(0.0, min(1.0, 1.0 - blocked / (d1 - d0)))
            self.last_overlap_fraction = fraction
        metrics.set_pipeline_overlap_fraction(fraction)

    def degrade(self, reason: str) -> None:
        """Sticky: flips :func:`enabled` false for the process, loudly."""
        with self._lock:
            if self.degraded_reason is not None:
                return
            self.degraded_reason = reason
        log.error(
            "pipeline degraded to synchronous cycles: %s "
            "(sticky until pipeline.reset())", reason,
        )
        metrics.register_degraded_cycle("pipeline", reason.split(":")[0])
        from kube_batch_tpu_torch import obs

        obs.recorder.dump(reason="pipeline.degraded", min_interval_s=5.0)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Join the in-flight deferred dispatch. True = clean (or
        nothing in flight); False = the caller must take the synchronous
        path (the fence has already degraded the pipeline)."""
        with self._lock:
            fut = self._future
        if fut is None:
            return True
        if timeout is None:
            timeout = fence_timeout_s()
        wedged = faults.should_fire("pipeline.fence")
        t0 = time.perf_counter()
        ok = True
        try:
            if wedged:
                raise _FutureTimeout()
            fut.result(timeout=timeout)
        except _FutureTimeout:
            ok = False
            reason = (
                "fault injected: pipeline.fence" if wedged
                else f"fence timeout: dispatch still in flight after {timeout:g}s"
            )
            self.degrade(reason)
            # the future stays armed: the dispatch may still land, and
            # the (now synchronous) next cycle must re-join it first
        except Exception as e:  # noqa: BLE001 - finisher already logged it
            ok = False
            self.degrade(f"deferred dispatch raised {type(e).__name__}: {e}")
            with self._lock:
                if self._future is fut:  # a newer future may be armed
                    self._future = None
        t1 = time.perf_counter()
        metrics.observe_pipeline_fence_wait(t1 - t0)
        with self._lock:
            if ok and self._future is fut:  # don't drop a newer arm()
                self._future = None
        if ok:
            self.record_join(t0, t1)
        return ok

    def reset(self) -> None:
        with self._lock:
            fut = self._future
            self._future = None
            self._dispatch_s = 0.0
            self._dispatch_t0 = 0.0
            self._dispatch_t1 = 0.0
            self._overlap_fresh = False
            self.last_overlap_fraction = None
            self.degraded_reason = None
        if fut is not None and not fut.done():
            try:
                fut.result(timeout=fence_timeout_s())
            except Exception:  # noqa: BLE001 - reset is best-effort teardown
                pass


fence = DispatchFence()

# Lazy fallback executor for caches without a kb-write pool (FakeCache,
# the interleave harness): one thread keeps the deferred dispatches of a
# single scheduler strictly ordered, which is all the fence needs.
_fallback: Optional[ThreadPoolExecutor] = None
_fallback_lock = threading.Lock()


def submit(cache, fn: Callable[[], None]) -> Future:
    """Submit the post-solve dispatch closure: onto the cache's writer
    pool when it exposes one, else onto the module fallback thread."""
    sub = getattr(cache, "submit_dispatch", None)
    if callable(sub):
        return sub(fn)
    global _fallback
    with _fallback_lock:
        if _fallback is None:
            _fallback = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="kbt-pipeline"
            )
    return _fallback.submit(fn)


def join_session(ssn, timeout: Optional[float] = None) -> None:
    """Block until ``ssn``'s deferred dispatch (if any) has landed,
    re-raising its exception. close_session calls this before the commit
    write-back; harnesses call it before reading binder state. The join
    window feeds the measured overlap fraction (the first join after a
    dispatch window records it)."""
    fut = getattr(ssn, "deferred_dispatch", None)
    if fut is None:
        return
    ssn.deferred_dispatch = None
    w0 = time.perf_counter()
    fut.result(timeout=timeout if timeout is not None else fence_timeout_s())
    fence.record_join(w0, time.perf_counter())


def reset() -> None:
    """Clear fence + degradation state (test hygiene between drills),
    and retire the lazy fallback thread so drills do not leak it."""
    global _fallback
    with _fallback_lock:
        pool = _fallback
        _fallback = None
    if pool is not None:
        pool.shutdown(wait=True)
    fence.reset()
