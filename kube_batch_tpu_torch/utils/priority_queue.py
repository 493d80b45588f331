"""Scheduling queue ordered by a caller-supplied less-fn
(reference pkg/scheduler/util/priority_queue.go:26-100).

The less-fn returns True when the left item should pop before the right
item, exactly like the reference's ``api.LessFn``. The item that the
less-fn ranks first pops first; ties keep insertion order.

Implementation note (documented deviation): the reference backs this with
``container/heap``. A heap evaluates the comparator only along sift
paths, so when keys mutate while items sit in the heap (proportion queue
shares and drf job shares change after every allocation —
proportion.go:202-223, drf.go:135-154) the pop order becomes an accident
of heap shape. Here ``pop`` re-evaluates the comparator across the live
items and returns the currently-best one — the order the policy *means*.
For static keys this is exactly heap behavior (every comparator here
falls back to creation-time/uid, a total order, so ties cannot occur);
for dynamic keys it is deterministic freshest-order selection, which the
vectorized kernel reproduces exactly (ops/kernels.py selection keys).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

LessFn = Callable[[Any, Any], bool]


class PriorityQueue:
    """reference priority_queue.go:26-67."""

    def __init__(self, less_fn: Optional[LessFn] = None) -> None:
        self._less_fn = less_fn
        self._items: list[Any] = []  # insertion order (tie-break)

    def push(self, value: Any) -> None:
        self._items.append(value)

    def pop(self) -> Any:
        if not self._items:
            return None
        less = self._less_fn
        best = 0
        if less is not None:
            for i in range(1, len(self._items)):
                # strict comparison keeps the earliest-inserted of ties
                if less(self._items[i], self._items[best]):
                    best = i
        return self._items.pop(best)

    def empty(self) -> bool:
        return not self._items

    def __len__(self) -> int:
        return len(self._items)
