"""Rate-limited retry queue (the shape of client-go's
``workqueue.RateLimitingInterface`` as the cache uses it:
``cache/cache.go:103-106`` — errTasks / deletedJobs).

Semantics kept from the reference's DefaultControllerRateLimiter usage:

- ``add_rate_limited(item)`` enqueues after a per-item exponential
  backoff (base 5ms doubling to a 1s cap — client-go's
  ItemExponentialFailureRateLimiter defaults, scaled for an in-process
  store where there is no network RTT to hide);
- duplicate adds of an item already waiting or queued coalesce;
- ``get(timeout)`` blocks for a ready item (None on timeout/shutdown);
- ``done(item)`` must follow every successful ``get`` before the item
  can be re-added (mirrors workqueue's processing-set semantics);
- ``forget(item)`` resets the item's failure count.

Items are identified by a caller-supplied key function (defaults to the
item itself) so mutable TaskInfo/JobInfo objects can ride the queue.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Any, Callable, Optional

from kube_batch_tpu_torch.utils.locking import assume_locked

_BASE_DELAY = 0.005
_MAX_DELAY = 1.0


class RateLimitingQueue:
    def __init__(self, key_fn: Optional[Callable[[Any], Any]] = None) -> None:
        self._key = key_fn or (lambda item: item)
        self._cond = threading.Condition()
        self._heap: list[tuple[float, int, Any]] = []  # (ready_at, seq, key)
        self._items: dict[Any, Any] = {}  # key -> newest item payload
        self._pending: set = set()  # keys waiting or queued
        self._processing: set = set()
        self._dirty: dict[Any, float] = {}  # re-added while processing -> ready_at
        self._failures: dict[Any, int] = {}
        self._seq = 0
        self._shutdown = False

    @assume_locked
    def _delay(self, key: Any) -> float:
        n = self._failures.get(key, 0)
        self._failures[key] = n + 1
        return min(_BASE_DELAY * (2**n), _MAX_DELAY)

    def add(self, item: Any) -> None:
        self._add(item, 0.0)

    def add_rate_limited(self, item: Any) -> None:
        with self._cond:
            delay = self._delay(self._key(item))
        self._add(item, delay)

    def _add(self, item: Any, delay: float) -> None:
        key = self._key(item)
        with self._cond:
            if self._shutdown:
                return
            self._items[key] = item
            ready_at = time.monotonic() + delay
            if key in self._processing:
                # Keep the earliest requested ready time; done() requeues
                # at it so the rate-limit delay is not discarded.
                self._dirty[key] = min(self._dirty.get(key, ready_at), ready_at)
                return
            if key in self._pending:
                return
            self._pending.add(key)
            self._seq += 1
            heapq.heappush(self._heap, (ready_at, self._seq, key))
            self._cond.notify()

    def get(self, timeout: Optional[float] = None) -> Optional[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                if self._shutdown:
                    return None
                now = time.monotonic()
                if self._heap and self._heap[0][0] <= now:
                    _, _, key = heapq.heappop(self._heap)
                    self._pending.discard(key)
                    self._processing.add(key)
                    return self._items[key]
                if self._heap:
                    wait = self._heap[0][0] - now
                else:
                    wait = None
                if deadline is not None:
                    remaining = deadline - now
                    if remaining <= 0:
                        return None
                    wait = remaining if wait is None else min(wait, remaining)
                self._cond.wait(wait)

    def done(self, item: Any) -> None:
        key = self._key(item)
        with self._cond:
            self._processing.discard(key)
            if key in self._dirty:
                ready_at = self._dirty.pop(key)
                self._pending.add(key)
                self._seq += 1
                heapq.heappush(self._heap, (ready_at, self._seq, key))
                self._cond.notify()
            elif key not in self._pending:
                self._items.pop(key, None)

    def forget(self, item: Any) -> None:
        with self._cond:
            self._failures.pop(self._key(item), None)

    def failures(self, item: Any) -> int:
        """Rate-limited adds recorded for this item since the last
        forget (client-go's NumRequeues) — what a caller's terminal-drop
        budget compares against."""
        with self._cond:
            return self._failures.get(self._key(item), 0)

    def __len__(self) -> int:
        with self._cond:
            return len(self._pending) + len(self._processing)

    def shut_down(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()

    def restart(self) -> None:
        """Reopen after shut_down (queued items survive); lets an owner
        stop() and later run() again without hot-spinning its workers
        on a permanently shut queue."""
        with self._cond:
            self._shutdown = False
