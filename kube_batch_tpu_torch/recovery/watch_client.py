"""Bounded-staleness watch client over the scheduler's HTTP list+watch
API (server.py WatchHub).

The role of client-go's Reflector against our watch surface: maintain a
local mirror of one or more kinds, and *know how stale it is*. External
consumers (a control-plane bridge, a second scheduler reading a remote
store, dashboards) previously had to hand-roll the k8s watch contract;
this client implements it hardened:

- **reconnect with jittered exponential backoff**: a connection error
  (arbiter restart, network blip) retries at ``min_backoff`` doubling
  to ``max_backoff``, with a uniform jitter factor so a fleet of
  watchers does not reconnect in lockstep (thundering herd);
- **410-Gone relist-storm coalescing**: a Gone means re-list — but under
  event churn a slow watcher can be Gone'd every poll, and naive
  re-listing turns the recovery path into a full-list DoS of the
  server. Relists per kind are coalesced to at most one per
  ``relist_min_interval`` seconds; Gones inside the window wait it out;
- **snapshot-age gauge**: seconds since the mirror was last known
  current (successful list or poll), exported as
  ``kube_batch_tpu_watch_snapshot_age_seconds`` — the number the
  refuse-to-schedule staleness guard (scheduler.py,
  ``KBT_MAX_SNAPSHOT_AGE_S``) compares against.

Use ``start()``/``stop()`` for one background thread per kind, or drive
``list_kind``/``poll_once`` directly (tests do).
"""

from __future__ import annotations

import json
import logging
import random
import threading
import time
import urllib.error
import urllib.request
from typing import Optional

from kube_batch_tpu_torch import metrics

log = logging.getLogger(__name__)


def _obj_key(body: dict) -> str:
    if "namespace" in body:
        return f"{body['namespace']}/{body['name']}"
    return str(body.get("name"))


class ResilientWatcher:
    """Hardened list+watch mirror of ``kinds`` at ``base_url``."""

    def __init__(
        self,
        base_url: str,
        kinds: tuple[str, ...],
        poll_timeout: float = 5.0,
        min_backoff: float = 0.05,
        max_backoff: float = 5.0,
        relist_min_interval: float = 1.0,
        rng: Optional[random.Random] = None,
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self.kinds = tuple(kinds)
        self.poll_timeout = poll_timeout
        self.min_backoff = min_backoff
        self.max_backoff = max_backoff
        self.relist_min_interval = relist_min_interval
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        # kind -> {obj_key: serialized object} — the mirror
        self.mirror: dict[str, dict[str, dict]] = {k: {} for k in self.kinds}  #: guarded_by _lock
        self._rv: dict[str, int] = {k: 0 for k in self.kinds}  #: guarded_by _lock
        self._last_sync: dict[str, Optional[float]] = {k: None for k in self.kinds}  #: guarded_by _lock
        self._last_relist: dict[str, float] = {k: 0.0 for k in self.kinds}  #: guarded_by _lock
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # -- one round-trip each ------------------------------------------------

    def _get(self, path: str, timeout: float) -> dict:
        with urllib.request.urlopen(f"{self.base_url}{path}", timeout=timeout) as r:
            return json.loads(r.read())

    def list_kind(self, kind: str) -> None:
        """Full re-list: replace the kind's mirror and resume the watch
        from the returned resourceVersion. Coalesced: inside the
        relist_min_interval window the call waits for the window to
        close first (the storm damper)."""
        now = time.monotonic()
        with self._lock:
            wait = self._last_relist[kind] + self.relist_min_interval - now
        if wait > 0:
            if self._stop.wait(wait):  # blocking wait stays outside the lock
                return
        with self._lock:
            # max(): a concurrent direct list_kind call may have stamped
            # the window while we waited — never move the window backwards
            self._last_relist[kind] = max(
                self._last_relist[kind], time.monotonic()
            )
        payload = self._get(f"/apis/v1alpha1/{kind}", timeout=self.poll_timeout + 5)
        with self._lock:
            self.mirror[kind] = {_obj_key(o): o for o in payload["items"]}
            self._rv[kind] = payload["resourceVersion"]
        self._mark_sync(kind)
        metrics.register_watch_relist(kind)

    def poll_once(self, kind: str) -> str:
        """One watch long-poll; applies events. Returns "ok" | "gone"
        (410: the caller must re-list; the thread loop does)."""
        with self._lock:
            since = self._rv[kind]
        try:
            payload = self._get(
                f"/apis/v1alpha1/watch/{kind}"
                f"?since={since}&timeout={self.poll_timeout}",
                timeout=self.poll_timeout + 5,
            )
        except urllib.error.HTTPError as e:
            if e.code == 410:
                body = json.loads(e.read() or b"{}")
                with self._lock:
                    # absolute resume point dictated by the server's 410
                    # body, NOT derived from the rv we polled with — a
                    # compaction may legitimately move it backwards
                    self._rv[kind] = int(body.get("resourceVersion", 0))  # noqa: KBT-T003
                return "gone"
            raise
        with self._lock:
            m = self.mirror[kind]
            for ev in payload["events"]:
                key = _obj_key(ev["object"])
                if ev["type"] == "DELETED":
                    m.pop(key, None)
                else:
                    m[key] = ev["object"]
            # absolute server-issued rv; one watch thread per kind
            self._rv[kind] = payload["resourceVersion"]  # noqa: KBT-T003
        self._mark_sync(kind)
        return "ok"

    # -- staleness ----------------------------------------------------------

    def _mark_sync(self, kind: str) -> None:
        with self._lock:
            self._last_sync[kind] = time.monotonic()
        metrics.set_watch_snapshot_age(self.snapshot_age())

    def snapshot_age(self) -> float:
        """Seconds since the *oldest* kind was last known current (inf
        before the first successful list). This is the guard's input:
        one stalled kind makes the whole snapshot stale."""
        with self._lock:
            ages = []
            now = time.monotonic()
            for kind in self.kinds:
                t = self._last_sync[kind]
                if t is None:
                    return float("inf")
                ages.append(now - t)
        age = max(ages) if ages else float("inf")
        metrics.set_watch_snapshot_age(age)
        return age

    def stale(self, threshold: float) -> bool:
        return self.snapshot_age() > threshold

    # -- lifecycle ----------------------------------------------------------

    def _loop(self, kind: str) -> None:
        backoff = self.min_backoff
        listed = False
        while not self._stop.is_set():
            try:
                if not listed:
                    self.list_kind(kind)
                    listed = True
                status = self.poll_once(kind)
                if status == "gone":
                    listed = False  # re-list (coalesced) next iteration
                    continue
                backoff = self.min_backoff  # healthy round-trip
            except Exception as e:  # noqa: BLE001 - reconnect path
                # jittered exponential backoff: 0.5-1.5x the nominal
                # delay so restarting fleets fan out
                delay = backoff * (0.5 + self._rng.random())
                log.debug(
                    "watch %s: %s; reconnecting in %.2fs", kind, e, delay
                )
                backoff = min(backoff * 2.0, self.max_backoff)
                self._stop.wait(delay)

    def start(self) -> None:
        if self._threads:  # idempotent: a second start must not double
            return         # the watcher population
        self._stop.clear()
        for kind in self.kinds:
            t = threading.Thread(
                target=self._loop, args=(kind,), name=f"kb-watch-{kind}", daemon=True
            )
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=self.poll_timeout + 6)
        self._threads.clear()
