"""Store backends: the ClusterStore surface behind an interface.

Everything SchedulerCache needs from "the cluster" is a narrow surface — subscribe (``add_event_handler`` with
initial replay), read (``get`` / ``list`` / ``get_pod``), write
(``update_pod`` / ``delete_pod`` / ``update_pod_group`` /
``update_persistent_volume`` / ``update_persistent_volume_claim``),
optimistic transactions (``conditional_bind_many`` /
``conditional_evict``) and the monotonic ``version`` those transactions
are checked against. This module names that surface (``StoreBackend``)
and provides both implementations:

- ``InProcessBackend``: the ClusterStore itself (zero behavior change —
  the single-process fast path every existing test runs on);
- ``LoopbackBackend``: the same surface over the scheduler server's
  ``/backend/v1/`` HTTP protocol — full-fidelity wire objects
  (apis/wire.py), list+watch with per-kind cursors and the 410-Gone
  re-list contract, and conditional writes whose 409 replies are
  reconstructed into the same typed ``StaleWrite`` the in-process store
  raises, so the cache's conflict dispatch is backend-agnostic.

Federation (federation.py) runs N schedulers, each over its own
LoopbackBackend against one shared store process: Omega-style shared
state with optimistic concurrency instead of pessimistic partitioning.

The mirror is pulled, not pushed: ``pump()`` executes one deterministic
poll pass over every subscribed kind (tests
call it explicitly; ``start()`` runs it on a background thread for real
deployments). Staleness is first-class — ``snapshot_age()`` reports
seconds since the last fully-successful pump, and the cache's
refuse-to-schedule guard (KBT_MAX_SNAPSHOT_AGE_S) consumes it via the
``staleness_fn`` hook.
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Optional

from kube_batch_tpu_torch import faults, log as pkg_log, metrics, obs
from kube_batch_tpu_torch.apis import wire
from kube_batch_tpu_torch.cache.store import (
    KINDS,
    NODES,
    PODS,
    PRIORITY_CLASSES,
    PVCS,
    PVS,
    POD_GROUPS,
    QUEUES,
    ClusterStore,
    EventHandler,
    StaleWrite,
    obj_key,
)

log = logging.getLogger(__name__)

__all__ = [
    "StoreBackend",
    "InProcessBackend",
    "LoopbackBackend",
    "BackendPartitioned",
]


class BackendPartitioned(ConnectionError):
    """The store backend is unreachable (real transport failure or the
    ``federation.partition`` fault). Transient by contract: the cache's
    ``_write_with_retry`` retries it, the pump skips the round and lets
    ``snapshot_age`` grow until the partition heals."""


# Keep-alive pool size per backend (wire protocol v2). One connection
# serves the pump; the rest absorb concurrent write-side dispatches.
POOL_ENV = "KBT_BACKEND_POOL"
# Client codec preference (negotiated down to what the server offers).
CODEC_ENV = "KBT_WIRE_CODEC"
# A list (the first sync of a kind, or a relist after 410) moves the whole
# kind: at 50,000 pods the store takes longer than the request timeout to
# encode it, so a list waits up to this long instead. The JAX package
# lists under the request timeout.
LIST_TIMEOUT_S = 120.0


def _pool_size() -> int:
    try:
        return max(1, int(os.environ.get(POOL_ENV, "") or 4))
    except ValueError:
        log.error("%s=%r is not an integer; using 4", POOL_ENV, os.environ.get(POOL_ENV))
        return 4


class _ConnectionPool:
    """Bounded keep-alive ``http.client`` connection pool — the v2
    transport. Checkout is health-checked (a connection whose socket
    died idle is discarded, never handed out); a request that fails on
    a REUSED connection is the keep-alive race (the server closed the
    socket between our requests) and is retried once on a fresh
    connection for idempotent GETs only — POSTs surface the failure to
    the caller's retry ladder, which is conflict-safe by versioning."""

    def __init__(self, host: str, port: int, size: int, timeout: float) -> None:
        self._host, self._port = host, port
        self._size = size
        self._timeout = timeout
        self._lock = threading.Lock()
        self._idle: list[http.client.HTTPConnection] = []
        self._in_use = 0

    def acquire(self) -> tuple[http.client.HTTPConnection, bool]:
        """-> (connection, reused). Dead idle sockets are discarded."""
        conn = None
        with self._lock:
            while self._idle:
                c = self._idle.pop()
                if c.sock is not None:
                    conn = c
                    break
                c.close()
            self._in_use += 1
            in_use = self._in_use
        metrics.set_backend_pool_in_use(in_use)
        if conn is not None:
            return conn, True
        fresh = http.client.HTTPConnection(
            self._host, self._port, timeout=self._timeout
        )
        fresh.connect()
        # TCP_NODELAY: without it, the second request on a kept-alive
        # connection sits out Nagle vs delayed-ACK (~40ms) — more than
        # the whole round trip this pool exists to amortize.
        fresh.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return fresh, False

    def release(self, conn: http.client.HTTPConnection, discard: bool = False) -> None:
        with self._lock:
            self._in_use = max(0, self._in_use - 1)
            in_use = self._in_use
            if not discard and conn.sock is not None and len(self._idle) < self._size:
                self._idle.append(conn)
                conn = None  # type: ignore[assignment]
        metrics.set_backend_pool_in_use(in_use)
        if conn is not None:
            conn.close()

    def close(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, []
        for c in idle:
            c.close()


class StoreBackend:
    """The surface SchedulerCache (and its default write-side helpers)
    requires from a cluster store. Documentation-by-interface: both
    implementations duck-type it, nothing isinstance-checks it.

    Required:
      add_event_handler(kind, EventHandler)  # + initial-list replay
      get(kind, key) / list(kind) / get_pod(namespace, name)
      update_pod(pod) / delete_pod(namespace, name)
      update_pod_group(pg)
      update_persistent_volume(pv) / update_persistent_volume_claim(pvc)
      conditional_bind_many(bindings, snapshot_version) -> applied pods
      conditional_evict(namespace, name, snapshot_version)
      version  # monotonic store version (int property)
    """


class InProcessBackend(ClusterStore):
    """The in-process store IS the backend — the single-process fast
    path. A distinct class (rather than an alias) so deployments can
    name which backend they constructed in logs and measurements."""


class LoopbackBackend:
    """StoreBackend over the scheduler server's ``/backend/v1/`` HTTP
    protocol (server.py). Reads come from a local mirror fed by
    full-fidelity list+watch; writes go over the wire; conditional
    writes re-raise the server's typed 409 as ``StaleWrite``."""

    def __init__(
        self,
        base_url: str,
        kinds: tuple = KINDS,
        timeout: float = 5.0,
        protocol: Optional[int] = None,
        codec: Optional[str] = None,
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self.kinds = tuple(kinds)
        self.timeout = timeout
        # Wire protocol v2 negotiation. `protocol`/`codec` cap what this
        # client will ASK for; what it actually RUNS is the min with what
        # the server's /version advertises — a v1-only arbiter answers
        # with a bare storeVersion and that reply IS the downgrade signal.
        self._protocol_pref = int(protocol) if protocol else 2
        self._codec_pref = codec or os.environ.get(CODEC_ENV, "") or "binary"
        if self._codec_pref not in wire.CODECS:
            log.error(
                "%s=%r is not one of %s; using json",
                CODEC_ENV, self._codec_pref, "/".join(wire.CODECS),
            )
            self._codec_pref = "json"
        self._protocol: Optional[int] = None  #: guarded_by _lock (None = not yet negotiated)
        self._codec = "json"  #: guarded_by _lock
        self._features: frozenset[str] = frozenset()  #: guarded_by _lock
        # Any partition (real or injected) forces renegotiation on the
        # next request: the peer we reconnect to after a partition may be
        # a different (older or newer) server build.
        self._needs_negotiation = True  #: guarded_by _lock
        parsed = urllib.parse.urlsplit(self.base_url)
        self._pool = _ConnectionPool(
            parsed.hostname or "localhost",
            parsed.port or 80,
            _pool_size(),
            timeout,
        )
        # Cumulative protocol bytes (tx/rx) for measurements; the metric
        # family store_backend_bytes_total is process-global, these are
        # per-backend so a run can report wire_bytes_per_bind per backend.
        self.bytes_tx = 0  #: guarded_by _lock
        self.bytes_rx = 0  #: guarded_by _lock
        self._lock = threading.RLock()
        self._mirror: dict[str, dict[str, Any]] = {k: {} for k in self.kinds}  #: guarded_by _lock
        self._handlers: dict[str, list[EventHandler]] = {k: [] for k in self.kinds}
        # Per-kind watch cursor: the server's rv is a global sequence but
        # rings are per kind, so a cursor advanced by one kind's poll must
        # never be reused for another kind (it would skip that kind's
        # events below it).
        self._cursor: dict[str, int] = {k: 0 for k in self.kinds}  #: guarded_by _lock
        self._synced: dict[str, bool] = {k: False for k in self.kinds}  #: guarded_by _lock
        # Last storeVersion any reply carried: the `version` property's
        # fallback when the backend is partitioned (snapshot() must not
        # fail just because version couldn't be refreshed).
        self._store_version = 0  #: guarded_by _lock
        self._last_pump_ok = time.monotonic()  #: guarded_by _lock
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- transport ---------------------------------------------------------

    def _send_urllib(
        self, method: str, path: str, data: Optional[bytes], headers: dict,
        timeout: Optional[float] = None,
    ) -> tuple[int, str, bytes]:
        """v1 transport: one urllib round trip per op (pre-v2 semantics,
        byte-for-byte). OSError propagates — the caller maps it."""
        req = urllib.request.Request(
            f"{self.base_url}{path}", data=data, headers=headers, method=method
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout or self.timeout) as resp:
                return resp.status, resp.headers.get("Content-Type", ""), resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.headers.get("Content-Type", ""), e.read()

    def _send_pooled(
        self, method: str, path: str, data: Optional[bytes], headers: dict,
        timeout: Optional[float] = None,
    ) -> tuple[int, str, bytes]:
        """v2 transport: keep-alive round trip on a pooled connection.
        A failure on a REUSED connection is the keep-alive race (server
        closed the socket between our requests): retried once on a fresh
        connection for idempotent GETs only — a POST replayed blind could
        double-apply a conditional write, so POSTs surface the failure to
        the version-checked retry ladder instead."""
        retried = False
        while True:
            conn, reused = self._pool.acquire()
            try:
                conn.timeout = timeout or self.timeout
                if conn.sock is not None:
                    conn.sock.settimeout(conn.timeout)
                conn.request(method, path, body=data, headers=headers)
                resp = conn.getresponse()
                raw = resp.read()
                ctype = resp.headers.get("Content-Type", "")
                status, will_close = resp.status, resp.will_close
            except (http.client.HTTPException, OSError):
                self._pool.release(conn, discard=True)
                if reused and method == "GET" and not retried:
                    retried = True
                    continue
                raise
            self._pool.release(conn, discard=will_close)
            return status, ctype, raw

    def _negotiate(self) -> None:
        """Settle protocol/codec/features from GET /backend/v1/version.
        Always plain-JSON urllib (no pooled transport, no codec
        assumptions — this must work against any server generation). A
        v1 server's bare ``{"storeVersion": N}`` reply IS the downgrade
        signal; no extra round trip, no error path."""
        status, _, raw = self._send_urllib(
            "GET", "/backend/v1/version", None, {"Accept": wire.JSON_CONTENT_TYPE}
        )
        if status != 200:
            raise BackendPartitioned(f"negotiate: HTTP {status}")
        payload = json.loads(raw)
        proto = min(self._protocol_pref, int(payload.get("protocol", 1)))
        offered = payload.get("codecs", ["json"]) if proto >= 2 else ["json"]
        codec = (
            "binary"
            if proto >= 2 and self._codec_pref == "binary" and "binary" in offered
            else "json"
        )
        features = frozenset(payload.get("features", ())) if proto >= 2 else frozenset()
        with self._lock:
            changed = (proto, codec) != (self._protocol, self._codec)
            self._protocol, self._codec, self._features = proto, codec, features
            self._needs_negotiation = False
            if "storeVersion" in payload:
                self._store_version = max(
                    self._store_version, int(payload["storeVersion"])
                )
        if changed:
            log.info(
                "store backend %s negotiated protocol v%d codec=%s features=%s",
                self.base_url, proto, codec, ",".join(sorted(features)) or "-",
            )

    def _mark_renegotiate(self) -> None:
        """The peer we talk to next may be a different server generation
        (partition heal, arbiter restart, rolling upgrade) — re-run
        version negotiation before the next request."""
        with self._lock:
            self._needs_negotiation = True

    def _request(
        self,
        op: str,
        method: str,
        path: str,
        body: Optional[dict] = None,
        not_found_ok: bool = False,
        timeout: Optional[float] = None,
    ):
        """One metered round-trip over the negotiated transport (``timeout``
        overrides the request timeout for this op). Raises
        BackendPartitioned on transport failure (injected or real),
        StaleWrite on a conflict 409, _Unsupported on a 404 the caller
        opted into (v2-only route against a v1 server)."""
        if faults.should_fire("federation.partition"):
            self._mark_renegotiate()
            raise BackendPartitioned(
                f"federation.partition: injected transport drop ({op})"
            )
        with self._lock:
            negotiate = self._protocol is None or self._needs_negotiation
        if negotiate:
            try:
                self._negotiate()
            except OSError as e:
                raise BackendPartitioned(f"{op}: negotiate: {e}") from e
        with self._lock:
            proto, codec = self._protocol or 1, self._codec
        if body is not None:
            if codec == "binary":
                data = wire.dumps_binary(body)
                req_ctype = wire.BINARY_CONTENT_TYPE
            else:
                data = json.dumps(body).encode()
                req_ctype = wire.JSON_CONTENT_TYPE
        else:
            data, req_ctype = None, wire.JSON_CONTENT_TYPE
        headers = {"Content-Type": req_ctype}
        if proto >= 2:
            headers["Accept"] = (
                wire.BINARY_CONTENT_TYPE if codec == "binary"
                else wire.JSON_CONTENT_TYPE
            )
        # trace propagation (kube_batch_tpu_torch.obs): the current span's ids
        # ride as headers so the store arbiter's server-side span joins
        # this scheduler's trace — a federated conflict's full retry
        # story renders as ONE trace across N processes
        headers.update(obs.current_headers())
        start = time.perf_counter()
        try:
            send = self._send_pooled if proto >= 2 else self._send_urllib
            status, resp_ctype, raw = send(method, path, data, headers, timeout)
        except OSError as e:  # connection refused/reset, timeout
            self._mark_renegotiate()
            raise BackendPartitioned(f"{op}: {e}") from e
        finally:
            metrics.observe_store_backend_rtt(op, time.perf_counter() - start)
        rx_codec = (
            "binary" if wire.BINARY_CONTENT_TYPE in (resp_ctype or "") else "json"
        )
        if data is not None:
            metrics.register_store_backend_bytes(
                "tx", "binary" if req_ctype == wire.BINARY_CONTENT_TYPE else "json",
                len(data),
            )
        metrics.register_store_backend_bytes("rx", rx_codec, len(raw))
        with self._lock:
            self.bytes_tx += len(data) if data is not None else 0
            self.bytes_rx += len(raw)
        try:
            if rx_codec == "binary":
                payload = wire.loads_binary(raw)
            else:
                payload = json.loads(raw) if raw else {}
        except ValueError as e:
            if status == 200:
                self._mark_renegotiate()
                raise BackendPartitioned(f"{op}: undecodable reply: {e}") from e
            payload = {}
        if status == 409 and isinstance(payload, dict) and "conflict" in payload:
            c = payload["conflict"]
            raise StaleWrite(
                c.get("kind", ""),
                c.get("key", ""),
                c.get("reason", "conflict"),
                int(c.get("expected", 0)),
                int(c.get("actual", 0)),
            )
        if status == 410:
            raise _Gone(int(payload.get("resourceVersion", 0)))
        if status == 404 and not_found_ok:
            raise _Unsupported(path)
        if status >= 400:
            self._mark_renegotiate()
            raise BackendPartitioned(f"{op}: HTTP {status}")
        if isinstance(payload, dict) and "storeVersion" in payload:
            with self._lock:
                self._store_version = max(
                    self._store_version, int(payload["storeVersion"])
                )
        return payload

    # -- subscribe ---------------------------------------------------------

    def add_event_handler(self, kind: str, handler: EventHandler) -> None:
        """Register + initial replay of the current mirror, matching the
        in-process store's informer contract. The first subscription of a
        kind lists it over the wire to seed the mirror."""
        with self._lock:
            synced = self._synced[kind]
        listing = None if synced else self._fetch_list(kind)
        with self._lock:
            if listing is not None and not self._synced[kind]:
                self._mirror[kind], self._cursor[kind] = listing
                self._synced[kind] = True
            self._handlers[kind].append(handler)
            replay = list(self._mirror[kind].values())
        for obj in replay:
            handler.add(obj)

    def _fetch_list(self, kind: str) -> tuple[dict, int]:
        """Blocking list over the wire — never called under _lock (the
        round trip can stall for the full transport timeout)."""
        payload = self._request(
            "list", "GET", f"/backend/v1/{kind}",
            timeout=max(self.timeout, LIST_TIMEOUT_S),
        )
        mirror = {
            obj_key(kind, obj): obj
            for obj in (wire.decode_kind(kind, d) for d in payload["items"])
        }
        # rv was read BEFORE the server listed: resuming the watch from it
        # re-delivers anything concurrent with the list (at-least-once);
        # redelivery is diffed against the mirror, so it degrades to a
        # no-op update, never a lost event.
        return mirror, int(payload["resourceVersion"])

    # -- pump (watch -> mirror -> handlers) --------------------------------

    def pump(self, timeout: float = 0.0) -> int:
        """One deterministic poll pass over every subscribed kind;
        returns the number of events dispatched. Under negotiated
        protocol v2 this is a single combined long-poll (watchall) whose
        MODIFIED events arrive as field-level deltas; under v1 it is the
        original per-kind cursor poll. A partition skips the round
        (mirror stales, snapshot_age grows) instead of raising."""
        if faults.should_fire("stream.pump"):
            # injected pump drop (streaming-federation drills): the round
            # is skipped whole — no partial event batch — so the mirror
            # simply ages and the staleness guard / backstop full cycle
            # own the degradation, exactly as for a real partition
            pkg_log.V(3).infof("stream.pump: injected watch-pump drop")
            self._stop.wait(0.02)  # keep an armed drill from spinning hot
            return 0
        with self._lock:
            use_v2 = (
                self._protocol is not None
                and not self._needs_negotiation
                and self._protocol >= 2
                and "longpoll" in self._features
            )
        if use_v2:
            try:
                return self._pump_v2(timeout)
            except _Unsupported:
                # Mid-run downgrade: the arbiter we reconnected to after a
                # partition is v1-only. Renegotiate, fall back this round.
                self._mark_renegotiate()
        return self._pump_v1(timeout)

    def _apply_events(self, kind: str, events: list[dict]) -> int:
        """Decode wire payloads OUTSIDE the mirror lock — a fat gang's
        payload decode under ``_lock`` would stall every concurrent
        mirror read (snapshot, conflict resync) for the duration — then
        apply the prepared batch under it. Delta events (v2) patch the
        mirror object in place; a delta for a key the mirror doesn't
        hold means its ADDED was missed — heal by re-list."""
        prepared: list[tuple] = []
        for ev in events:
            if "delta" in ev:
                prepared.append(("patch", ev["delta"]))
            elif ev["type"] == "DELETED" and "object" not in ev:
                prepared.append(("delkey", ev["key"]))
            else:
                prepared.append((ev["type"], wire.decode_kind(kind, ev["object"])))
        need_relist = False
        batch: list[tuple] = []
        with self._lock:
            mirror = self._mirror[kind]
            for verb, arg in prepared:
                if verb == "patch":
                    key = arg["key"]
                    old = mirror.get(key)
                    if old is None:
                        need_relist = True
                        continue
                    new = wire.apply_delta(kind, old, arg)
                    mirror[key] = new
                    batch.append(("update", old, new))
                elif verb == "delkey" or verb == "DELETED":
                    key = arg if verb == "delkey" else obj_key(kind, arg)
                    old = mirror.pop(key, None)
                    if old is not None:
                        batch.append(("delete", old, None))
                else:
                    obj = arg
                    key = obj_key(kind, obj)
                    old = mirror.get(key)
                    mirror[key] = obj
                    batch.append(
                        ("add", None, obj) if old is None else ("update", old, obj)
                    )
            handlers = list(self._handlers[kind])
        dispatched = self._dispatch(handlers, batch)
        if need_relist:
            dispatched += self._relist(kind)
        return dispatched

    def _pump_v1(self, timeout: float = 0.0) -> int:
        """Per-kind cursor poll — the pre-v2 pass, byte-for-byte on the
        wire (full objects, one request per kind)."""
        dispatched = 0
        try:
            for kind in self.kinds:
                with self._lock:
                    if not self._synced[kind]:
                        continue
                    since = self._cursor[kind]
                try:
                    payload = self._request(
                        "watch",
                        "GET",
                        f"/backend/v1/watch/{kind}?since={since}&timeout={timeout}",
                    )
                except _Gone:
                    # 410: our cursor fell out of the ring — re-list and
                    # synthesize the diff so handlers still see every
                    # transition exactly once from their point of view.
                    dispatched += self._relist(kind)
                    continue
                dispatched += self._apply_events(kind, payload.get("events", []))
                with self._lock:
                    # absolute server-issued rv; only the pump thread
                    # advances cursors between list re-seeds
                    self._cursor[kind] = int(payload["resourceVersion"])  # noqa: KBT-T003
        except BackendPartitioned as e:
            pkg_log.V(3).infof("backend pump skipped: %s", e)
            return dispatched
        with self._lock:
            self._last_pump_ok = time.monotonic()
        return dispatched

    def _pump_v2(self, timeout: float = 0.0) -> int:
        """One combined long-poll over every synced kind: the server
        parks the request until ANY kind has events past its cursor, so
        an idle federation costs one parked request per window instead
        of len(kinds) polls per period. Raises _Unsupported on 404 (v1
        server behind this URL now) for pump() to downgrade."""
        with self._lock:
            cursors = {k: self._cursor[k] for k in self.kinds if self._synced[k]}
            delta = "delta" in self._features
        if not cursors:
            return 0
        qs = ",".join(f"{k}:{since}" for k, since in cursors.items())
        path = f"/backend/v1/watchall?cursors={qs}&timeout={timeout}"
        if delta:
            path += "&delta=1"
        dispatched = 0
        try:
            payload = self._request("watch", "GET", path, not_found_ok=True)
            rv = int(payload["resourceVersion"])
            for kind, res in payload.get("kinds", {}).items():
                if kind not in self.kinds:  # mirror keys == kinds, fixed at init
                    continue
                if res.get("status") == "gone":
                    dispatched += self._relist(kind)
                    continue
                dispatched += self._apply_events(kind, res.get("events", []))
                # rv was read under the same hub lock that collected
                # every kind's events — safe to advance all polled
                # cursors to it in one go.
                with self._lock:
                    self._cursor[kind] = rv  # noqa: KBT-T003 (absolute server rv)
        except BackendPartitioned as e:
            pkg_log.V(3).infof("backend pump skipped: %s", e)
            return dispatched
        with self._lock:
            self._last_pump_ok = time.monotonic()
        return dispatched

    def _relist(self, kind: str) -> int:
        """410 heal: list, diff against the mirror, dispatch the delta."""
        after, rv = self._fetch_list(kind)
        with self._lock:
            before = dict(self._mirror[kind])
            self._mirror[kind] = after
            self._cursor[kind] = rv
            self._synced[kind] = True
            handlers = list(self._handlers[kind])
            batch: list[tuple] = []
            for key, obj in after.items():
                old = before.get(key)
                if old is None:
                    batch.append(("add", None, obj))
                elif old is not obj:
                    batch.append(("update", old, obj))
            for key, old in before.items():
                if key not in after:
                    batch.append(("delete", old, None))
        return self._dispatch(handlers, batch)

    @staticmethod
    def _dispatch(handlers: list[EventHandler], batch: list[tuple]) -> int:
        for verb, old, new in batch:
            for h in handlers:
                # A handler raising must not kill the pump thread: the
                # pump is shared infrastructure, and one bad object
                # stalling EVERY kind's watch silently is the worst
                # failure mode a shard has. Log and keep pumping — the
                # mirror itself is already updated, so a later relist or
                # event for the same key re-converges the handler state.
                try:
                    if verb == "add":
                        h.add(new)
                    elif verb == "update":
                        h.update(old, new)
                    else:
                        h.delete(old)
                except Exception as e:  # noqa: BLE001 — pump survival
                    log.error(
                        "watch handler %s failed (%s): %s", verb,
                        type(e).__name__, e,
                    )
        return len(batch)

    def start(self, period: float = 0.2) -> None:
        """Background pump for real deployments (tests call pump())."""
        if self._thread is not None:
            return
        self._stop.clear()
        # v2 long-poll window: park on the server as long as possible
        # while staying safely under the transport read timeout (or
        # urlopen/pool would kill an intentionally-parked request).
        longpoll = max(period, min(10.0, max(0.5, self.timeout - 1.0)))

        def loop() -> None:
            while not self._stop.is_set():
                with self._lock:
                    parked = (
                        self._protocol is not None
                        and self._protocol >= 2
                        and "longpoll" in self._features
                    )
                self.pump(timeout=longpoll if parked else period)

        self._thread = threading.Thread(target=loop, name="kb-backend", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._pool.close()

    def snapshot_age(self) -> float:
        """Seconds since the last fully-successful pump — the
        staleness_fn the cache's refuse-to-schedule guard reads."""
        with self._lock:
            return max(0.0, time.monotonic() - self._last_pump_ok)

    # -- reads (mirror) ----------------------------------------------------

    def get(self, kind: str, key: str) -> Optional[Any]:
        with self._lock:
            return self._mirror[kind].get(key)

    def list(self, kind: str) -> list[Any]:
        with self._lock:
            return list(self._mirror[kind].values())

    def get_pod(self, namespace: str, name: str):
        return self.get(PODS, f"{namespace}/{name}")

    # -- writes (wire) -----------------------------------------------------

    @property
    def version(self) -> int:
        """Current store version; last-seen fallback under partition so
        snapshot() keeps working while the transport heals (a stale
        version only makes this scheduler's next dispatch MORE likely to
        lose a conflict — safe by construction)."""
        try:
            payload = self._request("version", "GET", "/backend/v1/version")
            return int(payload["storeVersion"])
        except (BackendPartitioned, StaleWrite, KeyError, ValueError):
            with self._lock:
                return self._store_version

    def conditional_bind_many(
        self, bindings: list[tuple[str, str, str]], snapshot_version: int
    ) -> int:
        payload = self._request(
            "bind",
            "POST",
            "/backend/v1/bind",
            {"bindings": [list(b) for b in bindings],
             "snapshotVersion": snapshot_version},
        )
        return int(payload.get("applied", 0))

    def conditional_evict(self, namespace: str, name: str, snapshot_version: int):
        payload = self._request(
            "evict",
            "POST",
            "/backend/v1/evict",
            {"namespace": namespace, "name": name,
             "snapshotVersion": snapshot_version},
        )
        return payload.get("evicted")

    # -- coalesced conditional txns (wire protocol v2) ---------------------

    def supports_txn(self) -> bool:
        """True when the negotiated protocol carries /backend/v1/txn.
        False before first contact or after a partition — the cache
        falls back to per-gang writes until negotiation settles."""
        with self._lock:
            return (
                self._protocol is not None
                and not self._needs_negotiation
                and self._protocol >= 2
                and "txn" in self._features
            )

    def submit_txn(self, txns: list[dict]) -> list[dict]:
        """Batch of conditional txns in ONE round trip; returns per-txn
        results (``{"applied": N}`` | ``{"evicted": bool}`` |
        ``{"conflict": {...}}``) in submission order. A 404 means the
        server downgraded mid-run: renegotiate and surface a partition
        so the caller degrades to per-gang v1 writes."""
        try:
            payload = self._request(
                "txn", "POST", "/backend/v1/txn", {"txns": txns}, not_found_ok=True
            )
        except _Unsupported:
            self._mark_renegotiate()
            raise BackendPartitioned(
                "txn: endpoint gone (server downgraded?); renegotiating"
            ) from None
        results = payload.get("results", [])
        if len(results) != len(txns):
            raise BackendPartitioned(
                f"txn: {len(results)} results for {len(txns)} txns"
            )
        return results

    def _lease_verb(self, name: str, verb: str, body: dict) -> Any:
        """POST the arbiter's lease endpoint and reconstruct the Lease
        the store returned, so callers (ShardSlotManager, electors) see
        the same object shape from an HTTP arbiter as from an in-process
        ClusterStore. The name is percent-encoded whole (safe="") — a
        raw '/' would smear across path segments and arbitrate the
        wrong scope."""
        from kube_batch_tpu_torch.apis.types import Lease, ObjectMeta

        quoted = urllib.parse.quote(name, safe="")
        payload = self._request(
            f"lease.{verb}", "POST", f"/apis/v1alpha1/leases/{quoted}/{verb}", body
        )
        return Lease(
            metadata=ObjectMeta(name=payload.get("name", name)),
            holder_identity=str(payload.get("holder", "")),
            lease_duration_seconds=float(payload.get("lease_duration", 0.0)),
            renew_time=float(payload.get("renew_time", 0.0)),
            lease_transitions=int(payload.get("transitions", 0)),
        )

    def try_acquire_lease(
        self, name: str, identity: str, lease_duration: float = 15.0
    ) -> Any:
        """Acquire-or-renew through the arbiter (store.py semantics, the
        arbiter's clock). Raises BackendPartitioned on transport failure
        — the caller treats that as 'did not acquire this round'."""
        return self._lease_verb(
            name, "acquire", {"identity": identity, "lease_duration": lease_duration}
        )

    def release_lease(self, name: str, identity: str) -> Any:
        return self._lease_verb(name, "release", {"identity": identity})

    def _crud(self, kind: str, verb: str, obj=None, key: Optional[str] = None) -> None:
        body: dict[str, Any] = {"verb": verb}
        if obj is not None:
            body["object"] = wire.encode_kind(kind, obj)
        if key is not None:
            body["key"] = key
        self._request(f"{verb}.{kind}", "POST", f"/backend/v1/{kind}", body)

    def create(self, kind: str, obj) -> Any:
        self._crud(kind, "create", obj)
        return obj

    def update(self, kind: str, obj) -> Any:
        self._crud(kind, "update", obj)
        return obj

    def delete(self, kind: str, key: str) -> None:
        self._crud(kind, "delete", key=key)

    def update_pod(self, pod) -> Any:
        return self.update(PODS, pod)

    def delete_pod(self, namespace: str, name: str) -> None:
        self.delete(PODS, f"{namespace}/{name}")

    def create_pod(self, pod) -> Any:
        return self.create(PODS, pod)

    def update_pod_group(self, pg) -> Any:
        return self.update(POD_GROUPS, pg)

    def update_persistent_volume(self, pv) -> Any:
        return self.update(PVS, pv)

    def update_persistent_volume_claim(self, pvc) -> Any:
        return self.update(PVCS, pvc)

    # The typed conveniences the server's workload API handler calls, so
    # a federated scheduler's own HTTP endpoint proxies mutations through
    # to the store process instead of 500ing on a missing method.

    def create_queue(self, q) -> Any:
        return self.create(QUEUES, q)

    def delete_queue(self, name: str) -> None:
        self.delete(QUEUES, name)

    def create_node(self, n) -> Any:
        return self.create(NODES, n)

    def delete_node(self, name: str) -> None:
        self.delete(NODES, name)

    def create_pod_group(self, pg) -> Any:
        return self.create(POD_GROUPS, pg)

    def delete_pod_group(self, namespace: str, name: str) -> None:
        self.delete(POD_GROUPS, f"{namespace}/{name}")

    def create_priority_class(self, pc) -> Any:
        return self.create(PRIORITY_CLASSES, pc)

    def delete_priority_class(self, name: str) -> None:
        self.delete(PRIORITY_CLASSES, name)

    def create_persistent_volume(self, pv) -> Any:
        return self.create(PVS, pv)

    def delete_persistent_volume(self, name: str) -> None:
        self.delete(PVS, name)

    def create_persistent_volume_claim(self, pvc) -> Any:
        return self.create(PVCS, pvc)

    def delete_persistent_volume_claim(self, namespace: str, name: str) -> None:
        self.delete(PVCS, f"{namespace}/{name}")


class _Gone(Exception):
    """Internal: the watch cursor fell behind the server ring (410)."""

    def __init__(self, rv: int) -> None:
        super().__init__(f"410 gone (rv {rv})")
        self.rv = rv


class _Unsupported(Exception):
    """Internal: a v2-only route 404ed — the server behind this URL is a
    v1 generation (rolling downgrade, partition heal to an older peer).
    Callers renegotiate and take their v1 path."""

    def __init__(self, path: str) -> None:
        super().__init__(f"unsupported route {path} (v1 server?)")
        self.path = path
