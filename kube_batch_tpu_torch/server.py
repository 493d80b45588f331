"""The scheduler as a process: flags, the HTTP surface, the loop
(reference cmd/kube-batch/app/server.go:63-140 +
cmd/kube-batch/app/options/options.go:33-90).

``SchedulerServer`` assembles the full stack for one process: an
in-process ``ClusterStore`` (cache/store.py, the API-server stand-in),
the ``SchedulerCache`` its event handlers feed (cache/cache.py), the
``Scheduler`` loop on its own thread (``kb-loop``), and a
ThreadingHTTPServer (``kb-http``) that exposes:

- ``GET /metrics``   — Prometheus text exposition
  (``metrics.render_prometheus_text``);
- ``GET /healthz``   — liveness;
- ``GET /version``   — ``version.info()``;
- ``GET /debug/trace`` — flight-recorder ring (recent cycle traces;
  ``?dump=1`` also writes the JSONL + Chrome trace files);
- ``GET /debug/slo`` — per-queue time-to-bind / queue-wait quantiles
  (``obs.slo``); ``?raw=1`` serves the mergeable sketches and key
  counters a fleet aggregator scrapes (obs/fleet.py ``raw_slo_payload``);
- ``GET /debug/fleet`` — the cluster-wide rollup of the ``--fleet`` /
  ``KBT_FLEET`` peers (a forced scrape; ``{"enabled": false}`` when off);
- ``GET /debug/explain`` — per-gang unschedulability forensics and their
  aggregate (obs/explain.py, ``KBT_EXPLAIN``; ``?gang=ns/name`` filters);
- ``GET /debug/admission`` — the admission gate's lanes and controller
  (admission.py, ``KBT_ADMISSION``; ``{"enabled": false}`` when off);
- ``GET|POST /apis/v1alpha1/queues`` and
  ``DELETE /apis/v1alpha1/queues/<name>`` — the queue CRD surface the
  CLI talks to (cli/queue.py);
- ``GET|POST /apis/v1alpha1/pods`` / ``nodes`` / ``podgroups`` /
  ``priorityclasses`` / ``poddisruptionbudgets`` / ``persistentvolumes`` /
  ``persistentvolumeclaims`` / ``storageclasses`` and the matching
  ``DELETE`` routes — the workload-ingestion surface; creations fan out
  to the cache's event handlers through the store. Pod ingestion also
  stands in for the k8s admission controller: a pod without an explicit
  priority gets it resolved from its named PriorityClass or the global
  default class;
- ``GET /apis/v1alpha1/watch/<kind>?since=N&timeout=S`` — the long-poll
  watch (``WatchHub``; 410 Gone when the client fell behind the ring or
  the ``watch.drop`` fault point fired);
- ``POST /apis/v1alpha1/leases/<name>/acquire`` and ``.../release`` —
  leader-election arbitration over the store's lease verbs (the name
  percent-encoded); ``GET /apis/v1alpha1/leases`` lists them.

Pod JSON: ``{"name", "namespace", "group", "requests": {"cpu": 1,
"memory": "512Mi", ...scalars}, "priority", "priority_class_name",
"labels", "node_selector", "node_name", "phase", "scheduler_name",
"volumes"}``. Node JSON: ``{"name", "allocatable": {...}, "labels"}``.
PodGroup JSON: ``{"name", "namespace", "queue", "min_member"}``.

HA: the reference elects a leader through a ConfigMap resource lock
(server.go:96-137). Two tiers here, as in the JAX package:

- single host (``--lock-file``): an OS file lock (``flock``,
  ``LeaderElector``) — exactly one scheduler process per lock file runs
  the loop; the kernel releases the lock if the holder dies and a
  blocked standby takes over;
- cluster-wide (``--lease-url``): a Lease object in a shared
  ClusterStore, renewed over the HTTP API with the reference's
  15 s lease / 10 s renew-deadline / 5 s retry semantics
  (``StoreLeaseElector``); any scheduler-API endpoint can arbitrate,
  arbitration runs atomically under the arbiter's clock, and a leader
  that cannot renew within the deadline exits fatally
  (OnStoppedLeading glog.Fatalf parity, server.go:133-135).

Crash consistency: ``--journal`` (or ``KBT_JOURNAL``) attaches a
write-intent journal to the cache (recovery/journal.py), and ``start()``
reconciles it against the store (recovery/reconcile.py) before the loop
thread starts — on a restart and on a takeover alike, since a leader
only starts after acquiring.

Run it with ``python -m kube_batch_tpu_torch.server --scheduler-conf
examples/scheduler-conf-torch-pipeline.yaml``: the conf's
``torch_allocate`` solves on the card unless it says ``device: cpu``.
An HA pair adds ``--leader-elect --lease-url http://ARBITER:PORT
--journal PATH`` to each replica. Importing this module, ``--help`` and
``--version`` touch no card.

The store-backend protocol (``/backend/v1/``, cache/backend.py's client):
``GET /backend/v1/version`` (the store version and, on a v2 server, the
protocol level, codecs and features: the client's one negotiation read),
``GET /backend/v1/watchall?cursors=kind:N,...`` (v2's combined long-poll),
``GET /backend/v1/watch/<kind>`` and ``GET /backend/v1/<kind>``
(full-fidelity objects, apis/wire.py), and ``POST /backend/v1/bind``,
``/txn`` (v2), ``/evict`` and ``/<kind>`` (create/update/delete), where a
lost conditional write is a typed 409. A v2 server keeps connections
alive and answers in the binary codec when the client's ``Accept`` asks
for it; ``wire_protocol=1`` pins the v1 surface. ``--store-backend URL``
(federation) schedules over such a store process instead of an
in-process store, as shard ``KBT_FEDERATION=i/N`` of N, keyed by
``KBT_SHARD_KEY``, with its slot leased through the store
(federation.py).

Operator surfaces: ``--fleet URL,...`` (or ``KBT_FLEET``) makes any
scheduler, or a process with an unmatched ``--scheduler-name``, a fleet
aggregator that refreshes its rollup on each ``/metrics`` scrape;
``KBT_ADMISSION`` arms the workload POST's admission gate, which refuses
overload with 429 and ``Retry-After`` and is credited when an admitted pod
binds or is deleted while pending; ``KBT_EXPLAIN`` fills
``/debug/explain``.
"""

from __future__ import annotations

import argparse
import fcntl
import json
import logging
import math
import os
import socket
import threading
import time
import urllib.parse
import urllib.request
import uuid
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from kube_batch_tpu_torch import faults, log as pkg_log, metrics, obs, version
from kube_batch_tpu_torch.apis.types import (
    NodeSelectorTerm,
    ObjectMeta,
    PersistentVolume,
    PersistentVolumeClaim,
    PodDisruptionBudget,
    PodPhase,
    PriorityClass,
    Queue,
    QueueSpec,
    StorageClass,
    VolumeBindingMode,
    VolumePhase,
)
from kube_batch_tpu_torch.apis import wire
from kube_batch_tpu_torch.cache import ClusterStore, LoopbackBackend, SchedulerCache
from kube_batch_tpu_torch.cache.store import (
    KINDS,
    AlreadyExists,
    EventHandler,
    StaleWrite,
    obj_key,
)
from kube_batch_tpu_torch.federation import (
    ENV as FED_ENV,
    FederatedCache,
    ShardSlotManager,
    parse_shard_spec,
    shard_journal_dir,
    shard_journal_path,
    shard_key_mode,
)
from kube_batch_tpu_torch.recovery import WriteIntentJournal, reconcile_journal
from kube_batch_tpu_torch.recovery.reconcile import ReconcileReport
from kube_batch_tpu_torch.scheduler import Scheduler
from kube_batch_tpu_torch.testing import (
    build_node,
    build_pod,
    build_pod_group,
    build_resource_list,
    parse_quantity,
)

log = logging.getLogger(__name__)

DEFAULT_SCHEDULER_NAME = "kube-batch-tpu"
DEFAULT_SCHEDULE_PERIOD = 1.0
DEFAULT_QUEUE = "default"
DEFAULT_LISTEN_ADDRESS = ":8080"


# -- wire serialization (shared by the list and watch endpoints) ------------

SERIALIZERS = {
    "queues": lambda q: {"name": q.name, "weight": q.spec.weight},
    "pods": lambda p: {
        "namespace": p.namespace,
        "name": p.name,
        "phase": p.phase.value,
        "node": p.node_name,
    },
    "nodes": lambda n: {"name": n.name, "allocatable": dict(n.allocatable)},
    "podgroups": lambda g: {
        "namespace": g.metadata.namespace,
        "name": g.name,
        "queue": g.spec.queue,
        "min_member": g.spec.min_member,
        "phase": g.status.phase.value,
    },
    "priorityclasses": lambda pc: {
        "name": pc.name,
        "value": pc.value,
        "global_default": pc.global_default,
    },
    "poddisruptionbudgets": lambda b: {
        "namespace": b.metadata.namespace,
        "name": b.name,
        "min_available": b.min_available,
        "selector": b.selector,
    },
    "persistentvolumes": lambda v: {
        "name": v.name,
        "capacity": v.capacity_storage,
        "storage_class": v.storage_class_name,
        "phase": v.phase.value,
        "claim_ref": v.claim_ref,
    },
    "persistentvolumeclaims": lambda c: {
        "namespace": c.namespace,
        "name": c.name,
        "storage_class": c.storage_class_name,
        "request": c.request_storage,
        "phase": c.phase.value,
        "volume_name": c.volume_name,
    },
    "storageclasses": lambda s: {
        "name": s.name,
        "provisioner": s.provisioner,
        "volume_binding_mode": s.volume_binding_mode.value,
    },
    "leases": lambda l: {
        "name": l.name,
        "holder": l.holder_identity,
        "lease_duration": l.lease_duration_seconds,
        "acquire_time": l.acquire_time,
        "renew_time": l.renew_time,
        "transitions": l.lease_transitions,
    },
}


class WatchHub:
    """List+watch for external consumers: the store's
    event fan-out journaled with monotonic sequence numbers and exposed
    over HTTP long-poll (`GET /apis/v1alpha1/watch/<kind>?since=N`).

    The reference's clients get this from the generated
    SharedInformerFactory against the API server
    (pkg/client/informers/externalversions/factory.go); in-process, the
    hub subscribes one handler per kind and keeps a bounded ring of
    events **per kind**: one slow watcher of a churning kind can only
    ever hold MAX_EVENTS of that kind's events — it cannot grow the
    buffer without limit, and it cannot evict a quiet kind's events.
    `since` is the resourceVersion returned by list/watch replies; a
    client that falls behind its kind's ring gets `gone` and must
    re-list, exactly the k8s 410-Gone contract."""

    MAX_EVENTS = 8192  # ring capacity PER KIND

    def __init__(self, store: ClusterStore, max_events: Optional[int] = None) -> None:
        self._cond = threading.Condition()
        self.max_events = max_events or self.MAX_EVENTS
        # kind -> ring of (seq, verb, body), seq-ascending
        self._events: dict[str, deque] = {k: deque() for k in KINDS}
        self._seq = 0
        # Newest dropped seq per kind: Gone fires only when events of the
        # *requested* kind actually fell out of its ring, so a watcher of
        # a quiet kind is not forced to re-list because pods churned.
        self._dropped: dict[str, int] = {}
        self._closed = False
        # The journal is lazy: until the first list/watch consumer reads
        # a resourceVersion, events only bump the counter — no body
        # serialization, ring append, or notify on the store's hot
        # mutation path. `_journal_start` is the seq at activation;
        # a `since` before it is Gone (nothing earlier was journaled,
        # and no client can legitimately hold such an rv).
        self._active = False
        self._journal_start = 0
        for kind in KINDS:
            store.add_event_handler(
                kind,
                EventHandler(
                    on_add=lambda obj, k=kind: self._emit(k, "ADDED", obj),
                    on_update=lambda old, new, k=kind: self._emit(
                        k, "MODIFIED", new, old
                    ),
                    on_delete=lambda obj, k=kind: self._emit(k, "DELETED", obj),
                ),
            )

    def _emit(self, kind: str, verb: str, obj, old=None) -> None:
        if not self._active:
            # Double-checked under the lock; pre-activation events only
            # bump the counter (nobody is owed them).
            with self._cond:
                if not self._active:
                    self._seq += 1
                    return
        # The ring holds the object itself; serialization happens at poll
        # time per consumer (observability summary vs the full-fidelity
        # wire codec for store backends). Store objects are replaced, not
        # mutated (the mutation detector enforces it), so a late poll
        # serializes exactly the state the event captured. MODIFIED
        # entries also carry the replaced object so a v2 delta consumer
        # can be served the field-level patch; the patch itself is
        # computed lazily at first delta poll and cached in the entry
        # (slot 4) — computed once per event, not per consumer, and
        # never on the mutation hot path.
        with self._cond:
            self._seq += 1
            ring = self._events[kind]
            if len(ring) >= self.max_events:
                # true 410 on overflow: the dropped seq fences every
                # watcher holding an rv at or before it into a re-list
                self._dropped[kind] = ring.popleft()[0]
            ring.append([self._seq, verb, obj, old, None])
            self._cond.notify_all()

    def close(self) -> None:
        """Wake every blocked poll (server shutdown)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def _activate_locked(self) -> None:
        if not self._active:
            self._active = True
            self._journal_start = self._seq

    @property
    def resource_version(self) -> int:
        with self._cond:
            self._activate_locked()
            return self._seq

    def _event_payload(self, kind: str, entry: list, ser, delta: bool) -> dict:
        """Serialize one ring entry for a consumer. ``delta`` (v2 wire
        consumers only) turns MODIFIED into a field-level patch and
        DELETED into a bare key tombstone; ADDED always carries the
        full object (the client has nothing to patch)."""
        seq, verb, obj, old, cached = entry
        if delta and verb == "MODIFIED" and old is not None:
            patch = cached
            if patch is None:
                patch = {"key": obj_key(kind, obj)}
                patch.update(wire.delta_of(kind, old, obj))
                entry[4] = patch  # computed once per event, cached
            return {"seq": seq, "type": verb, "delta": patch}
        if delta and verb == "DELETED":
            return {"seq": seq, "type": verb, "key": obj_key(kind, obj)}
        return {"seq": seq, "type": verb, "object": ser(obj)}

    def _collect_locked(
        self, kind: str, since: int, full: bool, delta: bool
    ) -> list[dict]:
        """Events past ``since`` for one kind. Ring entries are
        seq-ascending: walk from the right only as far as `since` —
        O(new events), not O(ring). Caller holds ``_cond``."""
        ser = wire.to_wire if full else SERIALIZERS[kind]
        batch: list[dict] = []
        for entry in reversed(self._events[kind]):
            if entry[0] <= since:
                break
            batch.append(self._event_payload(kind, entry, ser, delta))
        batch.reverse()
        return batch

    def poll(
        self,
        kind: str,
        since: int,
        timeout: float,
        stop: threading.Event,
        wire: bool = False,
        delta: bool = False,
    ) -> tuple[str, list[dict], int]:
        """("ok" | "gone", events, resourceVersion). Blocks up to
        `timeout` seconds for the first event past `since`. ``wire``
        selects the full-fidelity codec (apis/wire.py, store backends)
        over the observability summary serializer; ``delta`` (v2)
        additionally compresses MODIFIED events into field patches."""
        if faults.should_fire("watch.drop"):
            # Injected stream drop: the 410-Gone contract — the client
            # must re-list and resume from the returned resourceVersion.
            with self._cond:
                return "gone", [], self._seq
        deadline = time.monotonic() + timeout
        while True:
            with self._cond:
                self._activate_locked()
                if since < max(self._dropped.get(kind, 0), self._journal_start):
                    return "gone", [], self._seq
                batch = self._collect_locked(kind, since, wire, delta)
                if batch:
                    return "ok", batch, self._seq
                remaining = deadline - time.monotonic()
                if remaining <= 0 or stop.is_set() or self._closed:
                    return "ok", [], self._seq
                self._cond.wait(min(remaining, 1.0))

    def poll_multi(
        self,
        cursors: dict[str, int],
        timeout: float,
        stop: threading.Event,
        delta: bool = False,
    ) -> tuple[dict[str, dict], int]:
        """The v2 combined long-poll: one blocking call over EVERY
        subscribed kind's cursor, returning the moment ANY kind has an
        event past its cursor — the client's pump thread blocks here on
        the server instead of walking kinds with per-kind timeouts.
        Returns ``({kind: {"status": "ok"|"gone", "events": [...]}},
        resourceVersion)``; per-kind gone (ring overflow) rides inline
        so one fallen-behind kind re-lists without aborting the rest.
        Always the full-fidelity wire codec (backend consumers only)."""
        if faults.should_fire("watch.drop"):
            with self._cond:
                return (
                    {k: {"status": "gone", "events": []} for k in cursors},
                    self._seq,
                )
        deadline = time.monotonic() + timeout
        while True:
            with self._cond:
                self._activate_locked()
                out: dict[str, dict] = {}
                ready = False
                for kind, since in cursors.items():
                    if since < max(self._dropped.get(kind, 0), self._journal_start):
                        out[kind] = {"status": "gone", "events": []}
                        ready = True
                        continue
                    batch = self._collect_locked(kind, since, True, delta)
                    out[kind] = {"status": "ok", "events": batch}
                    ready = ready or bool(batch)
                remaining = deadline - time.monotonic()
                if ready or remaining <= 0 or stop.is_set() or self._closed:
                    return out, self._seq
                self._cond.wait(min(remaining, 1.0))


class LeaderElector:
    """flock-based leader election (see module docstring)."""

    def __init__(self, lock_file: str, identity: str) -> None:
        self.lock_file = lock_file
        self.identity = identity
        self._fh = None

    def acquire(self, blocking: bool = True) -> bool:
        self._fh = open(self.lock_file, "a+")  # noqa: SIM115 - held for process life
        flags = fcntl.LOCK_EX | (0 if blocking else fcntl.LOCK_NB)
        try:
            fcntl.flock(self._fh, flags)
        except BlockingIOError:
            self._fh.close()
            self._fh = None
            return False
        self._fh.seek(0)
        self._fh.truncate()
        self._fh.write(self.identity)
        self._fh.flush()
        log.info("became leader: %s", self.identity)
        return True

    def release(self) -> None:
        if self._fh is not None:
            fcntl.flock(self._fh, fcntl.LOCK_UN)
            self._fh.close()
            self._fh = None


class StoreLeaseElector:
    """Cluster-wide leader election through a lease in a ClusterStore —
    the distributed half of HA (the flock LeaderElector stays the
    single-host fast path). Mirrors the reference's
    leaderelection.RunOrDie over a ConfigMap resource lock
    (cmd/kube-batch/app/server.go:115-139): lease_duration 15 s,
    renew_deadline 10 s, retry_period 5 s, identity
    ``hostname_pid_uuid``.

    The arbiter is either an in-process ``ClusterStore`` or the HTTP
    base URL of any scheduler-API server (``http://host:port``) — two
    machines point at the same URL and exactly one leads. The entire
    acquire-or-renew ladder executes atomically inside the arbiter under
    the ARBITER's clock, so candidate clock skew cannot split the lease.

    Renewal failures (network, arbiter down) are tolerated until
    ``renew_deadline`` has passed since the last successful renewal;
    then ``on_lost`` fires — process-level callers treat that as fatal,
    exactly like the reference's OnStoppedLeading glog.Fatalf
    (server.go:133-135)."""

    def __init__(
        self,
        arbiter,
        lease_name: str,
        identity: str,
        lease_duration: float = 15.0,
        renew_deadline: float = 10.0,
        retry_period: float = 5.0,
    ) -> None:
        self.arbiter = arbiter
        self.lease_name = lease_name
        self.identity = identity
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self.retry_period = retry_period
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._watchdog: Optional[threading.Thread] = None
        self.is_leader = False

    # -- one arbitration round-trip ----------------------------------------

    def _post(self, verb: str, payload: dict, timeout: float) -> dict:
        """One lease POST to the remote arbiter (shared by acquire and
        release so the path/encoding scheme cannot drift apart)."""
        req = urllib.request.Request(
            f"{self.arbiter.rstrip('/')}/apis/v1alpha1/leases/"
            f"{urllib.parse.quote(self.lease_name, safe='')}/{verb}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())

    def _try_acquire(self, timeout: float = 5.0) -> bool:
        """One acquire-or-renew attempt; True iff we hold the lease.
        ``timeout`` bounds the HTTP round-trip — the renewal loop shrinks
        it to its remaining deadline budget so a hanging arbiter cannot
        push loss-detection past the lease expiry."""
        if faults.should_fire("lease.renew"):
            raise faults.FaultInjected("lease.renew: injected arbiter partition")
        if isinstance(self.arbiter, str):
            return bool(
                self._post(
                    "acquire",
                    {
                        "identity": self.identity,
                        "lease_duration": self.lease_duration,
                    },
                    timeout,
                ).get("acquired")
            )
        lease = self.arbiter.try_acquire_lease(
            self.lease_name, self.identity, self.lease_duration
        )
        return lease.holder_identity == self.identity

    def _release(self, timeout: float = 5.0) -> None:
        try:
            if isinstance(self.arbiter, str):
                self._post("release", {"identity": self.identity}, timeout)
            else:
                self.arbiter.release_lease(self.lease_name, self.identity)
        except Exception as e:  # best-effort: expiry will hand over anyway
            log.error("lease release failed (standby waits out the lease): %s", e)

    # -- lifecycle ----------------------------------------------------------

    def acquire(self, blocking: bool = True) -> bool:
        """Contend until the lease is ours (retry_period cadence, like
        client-go's acquire loop). Non-blocking: one attempt."""
        while not self._stop.is_set():
            try:
                if self._try_acquire():
                    self.is_leader = True
                    log.info(
                        "became leader: %s (lease %s)", self.identity, self.lease_name
                    )
                    return True
            except Exception as e:
                log.error("lease acquire attempt failed: %s", e)
            if not blocking:
                return False
            self._stop.wait(self.retry_period)
        return False

    def start_renewing(self, on_lost) -> None:
        """Background renewal at retry_period cadence; fires ``on_lost``
        (once) if renew_deadline passes without a successful renewal or
        the arbiter reports another holder. A separate watchdog enforces
        the deadline on WALL time, independent of the renewal thread —
        urllib's timeout is per-socket-operation, so an arbiter dripping
        bytes could otherwise pin a renewal attempt (and loss detection)
        past the lease expiry."""
        lost_once = threading.Event()
        lost_lock = threading.Lock()  # watchdog + renewal race on the set

        def fire_lost(why: str) -> None:
            with lost_lock:
                if lost_once.is_set():
                    return
                lost_once.set()
            self._lose(why, on_lost)

        state = {"last_ok": time.monotonic()}

        def watchdog() -> None:
            while not self._stop.wait(
                min(0.5, max(0.05, self.renew_deadline / 10))
            ):
                if time.monotonic() - state["last_ok"] >= self.renew_deadline:
                    fire_lost("renew deadline exceeded (watchdog)")
                    return

        def loop() -> None:
            last_ok = state["last_ok"]
            wait = self.retry_period
            while not self._stop.wait(wait):
                # Deadline budget bounds each attempt (client-go bounds
                # renewals with a renewDeadline-scoped context for the
                # same reason): a hanging arbiter must not delay loss-
                # detection past the point where the lease can expire
                # under a standby.
                remaining = self.renew_deadline - (time.monotonic() - last_ok)
                if remaining <= 0:
                    fire_lost("renew deadline exceeded before attempt")
                    return
                try:
                    if self._try_acquire(timeout=max(0.5, min(5.0, remaining))):
                        if lost_once.is_set():
                            return  # watchdog already declared the loss
                        last_ok = time.monotonic()
                        state["last_ok"] = last_ok
                        wait = self.retry_period
                        continue
                    # someone else holds it — we were fenced out
                    fire_lost("lost to another holder")
                    return
                except Exception as e:
                    log.error("lease renewal attempt failed: %s", e)
                elapsed = time.monotonic() - last_ok
                if elapsed >= self.renew_deadline:
                    fire_lost("renew deadline exceeded")
                    return
                # After a failure, retry fast enough that several attempts
                # fit inside the remaining budget — a single transient
                # arbiter blip must not consume the whole deadline.
                wait = max(
                    0.05, min(self.retry_period, (self.renew_deadline - elapsed) / 3)
                )

        self._thread = threading.Thread(target=loop, name="kb-lease", daemon=True)
        self._thread.start()
        self._watchdog = threading.Thread(
            target=watchdog, name="kb-lease-watchdog", daemon=True
        )
        self._watchdog.start()

    def _lose(self, why: str, on_lost) -> None:
        log.error("lease %s: %s", self.lease_name, why)
        was_leader = self.is_leader
        self.is_leader = False
        if was_leader:
            # Best-effort release BEFORE on_lost: a renewal
            # already in flight when the watchdog fired can still land at
            # the arbiter (urllib's timeout is per-socket-op), silently
            # re-extending a dead leader's lease by a full window while
            # the standby waits it out. Clearing the holder bounds that
            # window to the in-flight attempt. Short timeout: on_lost is
            # typically a fatal exit, and renew_deadline + this bound must
            # stay under lease_duration (15/10/5 reference ratios hold).
            self._release(timeout=min(2.0, self.retry_period))
        on_lost()

    def release(self) -> None:
        """Stop renewing and hand the lease off gracefully. The release
        POST is sent only once the renewal thread has provably finished —
        an in-flight renewal landing after the release would silently
        re-take the lease for a dying process; if the thread cannot be
        joined in time we skip the hand-off and let the standby wait out
        the lease (the crash path, safe)."""
        self._stop.set()
        if self._watchdog is not None:
            self._watchdog.join(timeout=2)
            self._watchdog = None
        joined = True
        if self._thread is not None:
            self._thread.join(timeout=7)  # > max attempt timeout + retry
            joined = not self._thread.is_alive()
            if joined:
                self._thread = None
        if self.is_leader:
            self.is_leader = False
            if joined:
                self._release()
            else:
                log.error(
                    "lease %s: renewal still in flight at shutdown; skipping "
                    "graceful release (standby waits out the lease)",
                    self.lease_name,
                )


def _make_handler(server: "SchedulerServer"):
    class Handler(BaseHTTPRequestHandler):
        # Wire protocol v2: HTTP/1.1 keep-alive so the backend client's
        # connection pool reuses sockets across requests (_reply always
        # sends Content-Length, which 1.1 persistence requires). A
        # v1-pinned server keeps http.server's 1.0 default — one
        # connection per op, exactly the pre-v2 wire behavior.
        if getattr(server, "wire_protocol", 2) >= 2:
            protocol_version = "HTTP/1.1"
            # TCP_NODELAY (socketserver applies this per connection in
            # StreamRequestHandler.setup): without it every
            # reused-connection round trip sits out the Nagle vs
            # delayed-ACK interaction (~40ms) — more latency than the
            # whole RTT the keep-alive transport exists to amortize.
            disable_nagle_algorithm = True

        def log_message(self, fmt, *args):  # route http.server chatter to V(4)
            pkg_log.V(4).infof("http: " + fmt, *args)

        def _reply(self, code: int, body: str, ctype: str = "application/json",
                   headers: Optional[dict] = None) -> None:
            self._reply_bytes(code, body.encode(), ctype, headers)

        def _reply_bytes(self, code: int, data: bytes, ctype: str,
                         headers: Optional[dict] = None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            for key, value in (headers or {}).items():
                self.send_header(key, value)
            self.end_headers()
            self.wfile.write(data)

        def _wants_binary(self) -> bool:
            """Content negotiation for /backend/v1/ replies: the client
            advertises the binary codec in Accept; a v1-pinned server
            never honors it (the client then sees JSON come back and
            keeps speaking JSON — negotiation by response)."""
            return server.wire_protocol >= 2 and wire.BINARY_CONTENT_TYPE in (
                self.headers.get("Accept") or ""
            )

        def _backend_reply(self, code: int, payload: dict) -> None:
            """Serialize a /backend/v1/ reply in the negotiated codec.
            Error replies stay JSON on purpose: a mixed-version client
            must be able to read a 404/409/410 before (or without)
            codec agreement."""
            if code == 200 and self._wants_binary():
                self._reply_bytes(
                    code,
                    wire.dumps_binary(payload),
                    wire.BINARY_CONTENT_TYPE,
                )
            else:
                self._reply(code, json.dumps(payload))

        def do_GET(self):  # noqa: N802 (http.server API)
            parsed = urllib.parse.urlsplit(self.path)
            path = parsed.path
            if path == "/metrics":
                # Refresh the SLO quantile gauges from the sliding windows
                # right before exposition: scrape-time freshness without a
                # publisher thread. An aggregator (KBT_FLEET) refreshes its
                # rollup the same way (rate-limited inside), and the
                # admission gate its gauges.
                obs.slo.publish()
                from kube_batch_tpu_torch import admission
                from kube_batch_tpu_torch.obs import fleet as obs_fleet

                obs_fleet.refresh()
                admission.publish()
                self._reply(
                    200, metrics.render_prometheus_text(), "text/plain; version=0.0.4"
                )
            elif path == "/healthz":
                self._reply(200, "ok", "text/plain")
            elif path == "/version":
                self._reply(200, "\n".join(version.info()) + "\n", "text/plain")
            elif path == "/debug/trace":
                # Flight-recorder peek: the bounded ring of recent cycle
                # traces. ``?dump=1`` additionally writes the jsonl +
                # Chrome trace files and returns their paths.
                query = urllib.parse.parse_qs(parsed.query)
                payload = {
                    "enabled": obs.enabled(),
                    "traces": obs.recorder.trace_count(),
                    "spans": obs.recorder.spans(),
                }
                if query.get("dump", ["0"])[0] not in ("", "0", "false"):
                    payload["dump"] = obs.recorder.dump(reason="debug_endpoint")
                self._reply(200, json.dumps(payload))
            elif path == "/debug/slo":
                # ``?raw=1``: the serialized mergeable sketches (the fleet
                # aggregation wire form) instead of the quantile snapshot
                query = urllib.parse.parse_qs(parsed.query)
                if query.get("raw", ["0"])[0] not in ("", "0", "false"):
                    from kube_batch_tpu_torch.obs import fleet as obs_fleet

                    self._reply(200, json.dumps(obs_fleet.raw_slo_payload()))
                else:
                    self._reply(200, json.dumps(obs.slo.snapshot()))
            elif path == "/debug/fleet":
                # the cluster-wide rollup: a forced scrape of the configured
                # peers, merged ({"enabled": false} when KBT_FLEET is off)
                from kube_batch_tpu_torch.obs import fleet as obs_fleet

                self._reply(200, json.dumps(obs_fleet.refresh(force=True)))
            elif path == "/debug/explain":
                # the forensics registry (obs/explain): per-gang records and
                # their aggregate; ``?gang=ns/name`` filters to one gang
                from kube_batch_tpu_torch.obs import explain as obs_explain

                query = urllib.parse.parse_qs(parsed.query)
                gang = query.get("gang", [""])[0] or None
                self._reply(200, json.dumps(obs_explain.debug_payload(gang)))
            elif path == "/debug/admission":
                # the admission control plane (admission.py): lanes and the
                # backpressure controller ({"enabled": false} when off)
                from kube_batch_tpu_torch import admission

                self._reply(200, json.dumps(admission.debug_payload()))
            elif path == "/backend/v1/version":
                # Store-backend protocol (cache/backend.py): the store
                # version optimistic writes are checked against. A v2
                # server additionally advertises its protocol level and
                # capabilities here — the client's one negotiation read;
                # a v1 server's bare reply IS the downgrade signal.
                payload = {"storeVersion": server.store.version}
                if server.wire_protocol >= 2:
                    payload.update(
                        {
                            "protocol": 2,
                            "codecs": ["json", "binary"],
                            "features": ["delta", "txn", "longpoll"],
                        }
                    )
                self._backend_reply(200, payload)
            elif path == "/backend/v1/watchall":
                # v2 combined long-poll (absent under a v1 pin: the 404
                # sends a v2 client back to per-kind polling).
                if server.wire_protocol < 2:
                    self._reply(404, json.dumps({"error": "not found"}))
                    return
                query = urllib.parse.parse_qs(parsed.query)
                try:
                    timeout = float(query.get("timeout", ["30"])[0])
                    cursors = {}
                    for part in query.get("cursors", [""])[0].split(","):
                        if not part:
                            continue
                        kind, _, since = part.partition(":")
                        if kind not in SERIALIZERS:
                            raise ValueError(kind)
                        cursors[kind] = int(since or "0")
                except ValueError:
                    self._reply(400, json.dumps({"error": "bad cursors/timeout"}))
                    return
                if not math.isfinite(timeout):
                    self._reply(400, json.dumps({"error": "bad cursors/timeout"}))
                    return
                timeout = min(max(timeout, 0.0), 300.0)
                delta = query.get("delta", ["0"])[0] not in ("", "0", "false")
                kinds, rv = server.watch_hub.poll_multi(
                    cursors, timeout, server._stop, delta=delta
                )
                metrics.register_longpoll_wakeup(
                    "events"
                    if any(k["events"] or k["status"] == "gone" for k in kinds.values())
                    else "timeout"
                )
                self._backend_reply(
                    200,
                    {
                        "kinds": kinds,
                        "resourceVersion": rv,
                        "storeVersion": server.store.version,
                    },
                )
            elif path.startswith("/backend/v1/watch/"):
                kind = path[len("/backend/v1/watch/"):]
                if kind not in SERIALIZERS:
                    self._reply(404, json.dumps({"error": f"unknown kind {kind!r}"}))
                    return
                query = urllib.parse.parse_qs(parsed.query)
                try:
                    since = int(query.get("since", ["0"])[0])
                    timeout = float(query.get("timeout", ["30"])[0])
                except ValueError:
                    self._reply(400, json.dumps({"error": "bad since/timeout"}))
                    return
                if not math.isfinite(timeout):
                    self._reply(400, json.dumps({"error": "bad since/timeout"}))
                    return
                timeout = min(max(timeout, 0.0), 300.0)
                delta = server.wire_protocol >= 2 and query.get("delta", ["0"])[
                    0
                ] not in ("", "0", "false")
                status, events, rv = server.watch_hub.poll(
                    kind, since, timeout, server._stop, wire=True, delta=delta
                )
                if status == "gone":
                    self._reply(
                        410, json.dumps({"error": "too old", "resourceVersion": rv})
                    )
                    return
                self._backend_reply(
                    200, {"events": events, "resourceVersion": rv}
                )
            elif path.startswith("/backend/v1/"):
                kind = path[len("/backend/v1/"):]
                if kind not in SERIALIZERS:
                    self._reply(404, json.dumps({"error": "not found"}))
                    return
                # rv BEFORE the list, same at-least-once rule as the
                # observability list endpoint below.
                rv = server.watch_hub.resource_version
                store_v = server.store.version
                items = [wire.to_wire(obj) for obj in server.store.list(kind)]
                self._backend_reply(
                    200,
                    {
                        "items": items,
                        "resourceVersion": rv,
                        "storeVersion": store_v,
                    },
                )
            elif path.startswith("/apis/v1alpha1/watch/"):
                kind = path[len("/apis/v1alpha1/watch/"):]
                if kind not in SERIALIZERS:
                    self._reply(404, json.dumps({"error": f"unknown kind {kind!r}"}))
                    return
                query = urllib.parse.parse_qs(parsed.query)
                try:
                    since = int(query.get("since", ["0"])[0])
                    timeout = float(query.get("timeout", ["30"])[0])
                except ValueError:
                    self._reply(400, json.dumps({"error": "bad since/timeout"}))
                    return
                if not math.isfinite(timeout):  # nan/inf would spin forever
                    self._reply(400, json.dumps({"error": "bad since/timeout"}))
                    return
                timeout = min(max(timeout, 0.0), 300.0)
                status, events, rv = server.watch_hub.poll(
                    kind, since, timeout, server._stop
                )
                if status == "gone":
                    # k8s 410 Gone: the client's resourceVersion fell out
                    # of the ring; it must re-list and resume from there.
                    self._reply(
                        410, json.dumps({"error": "too old", "resourceVersion": rv})
                    )
                    return
                self._reply(
                    200, json.dumps({"events": events, "resourceVersion": rv})
                )
            elif path.startswith("/apis/v1alpha1/"):
                kind = path[len("/apis/v1alpha1/"):]
                ser = SERIALIZERS.get(kind)
                if ser is None:
                    self._reply(404, json.dumps({"error": "not found"}))
                    return
                # rv read BEFORE the list: a watch from this rv re-delivers
                # anything that lands between the two reads (at-least-once)
                # rather than silently skipping it.
                rv = server.watch_hub.resource_version
                items = [ser(obj) for obj in server.store.list(kind)]
                self._reply(
                    200, json.dumps({"items": items, "resourceVersion": rv})
                )
            else:
                self._reply(404, json.dumps({"error": "not found"}))


        def _read_body(self) -> dict:
            length = int(self.headers.get("Content-Length", "0"))
            raw = self.rfile.read(length) or b"{}"
            ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
            if ctype == wire.BINARY_CONTENT_TYPE:
                if server.wire_protocol < 2:
                    raise ValueError(
                        "binary request body on a v1 server (re-negotiate: "
                        "GET /backend/v1/version)"
                    )
                return wire.loads_binary(raw)
            return json.loads(raw)

        def _backend_post(self, tail: str, body: dict) -> None:
            """Store-backend mutation surface (cache/backend.py client).

            Conditional writes carry the caller's snapshot version and a
            stale one is a 409 with the full StaleWrite payload — the
            client re-raises it so the dispatch path is backend-agnostic.
            The generic CRUD route takes full-fidelity wire objects
            (apis/wire.py), unlike the lossy ingestion routes below.
            """
            def parse_bindings(raw) -> list:
                if not isinstance(raw, list):
                    raise ValueError("bindings must be a list")
                bindings = []
                for entry in raw:
                    if not (isinstance(entry, (list, tuple)) and len(entry) == 3):
                        raise ValueError(
                            "each binding must be [namespace, name, hostname]"
                        )
                    bindings.append(tuple(str(x) for x in entry))
                return bindings

            try:
                if tail == "bind":
                    bindings = parse_bindings(body.get("bindings"))
                    version = int(body.get("snapshotVersion", 0))
                    # Store-side half of the distributed bind trace: the
                    # client (cache/backend.py) sends its gang.bind span
                    # context in X-KBT-* headers; parenting on it makes a
                    # federated conflict retry one connected trace across
                    # scheduler and arbiter processes.
                    with obs.span(
                        "store.bind",
                        parent=obs.from_headers(self.headers),
                        binds=len(bindings),
                        version=version,
                    ) as bspan:
                        applied = server.store.conditional_bind_many(
                            bindings, version
                        )
                        bspan.set_attr("applied", len(applied))
                    self._backend_reply(
                        200,
                        {
                            "applied": len(applied),
                            "storeVersion": server.store.version,
                        },
                    )
                elif tail == "txn":
                    # v2 coalesced conditional writes: one round trip, a
                    # batch of per-gang transactions, per-transaction 409
                    # results inline (the HTTP status stays 200 — one
                    # conflicted gang must not fail its batchmates).
                    if server.wire_protocol < 2:
                        self._reply(404, json.dumps({"error": "not found"}))
                        return
                    txns = body.get("txns")
                    if not isinstance(txns, list):
                        raise ValueError("txns must be a list")
                    results = []
                    with obs.span(
                        "store.txn",
                        parent=obs.from_headers(self.headers),
                        txns=len(txns),
                    ) as tspan:
                        for txn in txns:
                            if not isinstance(txn, dict):
                                raise ValueError("each txn must be an object")
                            op = txn.get("op")
                            version = int(txn.get("snapshotVersion", 0))
                            try:
                                if op == "bind":
                                    applied = server.store.conditional_bind_many(
                                        parse_bindings(txn.get("bindings")), version
                                    )
                                    results.append({"applied": len(applied)})
                                elif op in ("evict", "unbind"):
                                    old = server.store.conditional_evict(
                                        str(txn.get("namespace", "")),
                                        str(txn.get("name", "")),
                                        version,
                                    )
                                    results.append({"evicted": old is not None})
                                else:
                                    raise ValueError(f"unknown txn op {op!r}")
                            except StaleWrite as e:
                                results.append(
                                    {
                                        "conflict": {
                                            "kind": e.kind,
                                            "key": e.key,
                                            "reason": e.reason,
                                            "expected": e.expected,
                                            "actual": e.actual,
                                        }
                                    }
                                )
                        tspan.set_attr(
                            "conflicts",
                            sum(1 for r in results if "conflict" in r),
                        )
                    metrics.observe_txn_batch_size(len(txns))
                    self._backend_reply(
                        200,
                        {
                            "results": results,
                            "storeVersion": server.store.version,
                        },
                    )
                elif tail == "evict":
                    namespace = str(body.get("namespace", ""))
                    name = str(body.get("name", ""))
                    if not name:
                        raise ValueError("name must be non-empty")
                    version = int(body.get("snapshotVersion", 0))
                    old = server.store.conditional_evict(namespace, name, version)
                    self._backend_reply(
                        200,
                        {
                            "evicted": old is not None,
                            "storeVersion": server.store.version,
                        },
                    )
                elif tail in SERIALIZERS:
                    verb = body.get("verb")
                    if verb == "create":
                        obj = wire.decode_kind(tail, body.get("object") or {})
                        server.store.create(tail, obj)
                    elif verb == "update":
                        obj = wire.decode_kind(tail, body.get("object") or {})
                        server.store.update(tail, obj)
                    elif verb == "delete":
                        key = body.get("key")
                        if not isinstance(key, str) or not key:
                            raise ValueError("delete needs a non-empty string key")
                        server.store.delete(tail, key)
                    else:
                        raise ValueError(f"unknown verb {verb!r}")
                    self._backend_reply(
                        200, {"storeVersion": server.store.version}
                    )
                else:
                    self._reply(404, json.dumps({"error": "not found"}))
            except StaleWrite as e:
                # Optimistic-concurrency loss: typed 409 so the backend
                # client can reconstruct the exact conflict and the loser
                # resyncs only the conflicted gang.
                self._reply(
                    409,
                    json.dumps(
                        {
                            "conflict": {
                                "kind": e.kind,
                                "key": e.key,
                                "reason": e.reason,
                                "expected": e.expected,
                                "actual": e.actual,
                            }
                        }
                    ),
                )

        def do_POST(self):  # noqa: N802
            # Validation before anything reaches the store: a type-poisoned
            # object (str priority, str labels) would not fail here — it
            # would fail inside every subsequent scheduling cycle.
            def field(body, key, typ, default, required: bool = False):
                if key not in body:
                    if required:
                        raise ValueError(f"missing required field {key!r}")
                    return default
                val = body[key]
                if isinstance(val, bool) and typ is not bool:
                    raise ValueError(f"field {key!r} must be {typ.__name__}, got bool")
                if typ is int and isinstance(val, (int, str)):
                    return int(val)
                if not isinstance(val, typ):
                    raise ValueError(
                        f"field {key!r} must be {typ.__name__}, got {type(val).__name__}"
                    )
                return val

            def resource_list(d) -> dict:
                if not isinstance(d, dict):
                    raise ValueError("resource list must be an object")
                for k, v in d.items():
                    if isinstance(v, bool) or not isinstance(v, (int, float, str)):
                        raise ValueError(
                            f"resource {k!r} must be a number or quantity string"
                        )
                # k8s-style quantity strings ("8Gi", "500m") -> floats
                return build_resource_list(
                    cpu=d.get("cpu", 0),
                    memory=d.get("memory", 0),
                    pods=int(d.get("pods", 0)),
                    **{k: v for k, v in d.items() if k not in ("cpu", "memory", "pods")},
                )


            try:
                body = self._read_body()
                if not isinstance(body, dict):
                    raise ValueError("request body must be a JSON object")
                if self.path.startswith("/backend/v1/"):
                    self._backend_post(self.path[len("/backend/v1/"):], body)
                elif self.path == "/apis/v1alpha1/queues":
                    name = field(body, "name", str, None, required=True)
                    weight = field(body, "weight", int, 1)
                    if weight < 1:
                        raise ValueError("weight must be >= 1")
                    server.store.create_queue(
                        Queue(metadata=ObjectMeta(name=name), spec=QueueSpec(weight=weight))
                    )
                    self._reply(201, json.dumps({"name": name, "weight": weight}))
                elif self.path == "/apis/v1alpha1/pods":
                    name = field(body, "name", str, None, required=True)
                    namespace = field(body, "namespace", str, "default")
                    pod = build_pod(
                        namespace=namespace,
                        name=name,
                        node_name=field(body, "node_name", str, ""),
                        phase=PodPhase(field(body, "phase", str, "Pending")),
                        req=resource_list(body.get("requests", {})),
                        group_name=field(body, "group", str, ""),
                        labels=field(body, "labels", dict, None),
                        priority=field(body, "priority", int, None),
                        node_selector=field(body, "node_selector", dict, None),
                        scheduler_name=field(
                            body, "scheduler_name", str, server.cache.scheduler_name
                        ),
                        volumes=[
                            str(v) for v in field(body, "volumes", list, []) or []
                        ],
                    )
                    pod.priority_class_name = field(body, "priority_class_name", str, "")
                    # Admission-controller stand-in: kube-batch reads
                    # pod.Spec.Priority already resolved by k8s admission
                    # from the PriorityClass; with no admission layer here,
                    # ingestion resolves it (named class, else the global
                    # default class).
                    if pod.priority is None:
                        pc = None
                        if pod.priority_class_name:
                            pc = server.store.get(
                                "priorityclasses", pod.priority_class_name
                            )
                            if pc is None:
                                raise ValueError(
                                    f"unknown priority class {pod.priority_class_name!r}"
                                )
                        else:
                            pc = next(
                                (
                                    c
                                    for c in server.store.list("priorityclasses")
                                    if c.global_default
                                ),
                                None,
                            )
                        if pc is not None:
                            pod.priority = pc.value
                    # Per-tenant admission (admission.py): resolve the pod's
                    # queue (the explicit field, else its podgroup's, else
                    # the default), ask the lane gate, and refuse overload
                    # loudly: 429 with Retry-After, never a silent drop or
                    # an unbounded queue.
                    from kube_batch_tpu_torch import admission

                    decision = None
                    pod_key = f"{pod.namespace}/{pod.name}"
                    if admission.enabled():
                        from kube_batch_tpu_torch.apis.types import GROUP_NAME_ANNOTATION_KEY

                        queue = field(body, "queue", str, "")
                        group = pod.metadata.annotations.get(GROUP_NAME_ANNOTATION_KEY, "")
                        if not queue and group:
                            pg = server.store.get("podgroups", f"{pod.namespace}/{group}")
                            if pg is not None:
                                queue = pg.spec.queue
                        decision = admission.decide(queue or server.cache.default_queue, pod_key)
                    if decision is not None and not decision.admitted:
                        self._reply(
                            429,
                            json.dumps({
                                "error": "admission shed",
                                "lane": decision.lane,
                                "reason": decision.reason,
                                "retry_after_s": round(decision.retry_after_s, 3),
                            }),
                            headers={"Retry-After": str(max(1, int(decision.retry_after_s + 0.999)))},
                        )
                    else:
                        try:
                            server.store.create_pod(pod)
                        except Exception:
                            admission.release(pod_key)
                            raise
                        self._reply(
                            201, json.dumps({"namespace": pod.namespace, "name": pod.name})
                        )
                elif self.path == "/apis/v1alpha1/nodes":
                    name = field(body, "name", str, None, required=True)
                    node = build_node(
                        name,
                        resource_list(body.get("allocatable", {})),
                        labels=field(body, "labels", dict, None),
                    )
                    server.store.create_node(node)
                    self._reply(201, json.dumps({"name": node.name}))
                elif self.path == "/apis/v1alpha1/podgroups":
                    name = field(body, "name", str, None, required=True)
                    namespace = field(body, "namespace", str, "default")
                    pg = build_pod_group(
                        name,
                        namespace=namespace,
                        queue=field(body, "queue", str, server.cache.default_queue),
                        min_member=field(body, "min_member", int, 1),
                    )
                    server.store.create_pod_group(pg)
                    self._reply(
                        201,
                        json.dumps({"namespace": pg.metadata.namespace, "name": pg.name}),
                    )
                elif self.path == "/apis/v1alpha1/priorityclasses":
                    name = field(body, "name", str, None, required=True)
                    pc = PriorityClass(
                        metadata=ObjectMeta(name=name, uid=f"pc-{name}"),
                        value=field(body, "value", int, 0),
                        global_default=field(body, "global_default", bool, False),
                    )
                    server.store.create_priority_class(pc)
                    self._reply(201, json.dumps({"name": name, "value": pc.value}))
                elif self.path == "/apis/v1alpha1/poddisruptionbudgets":
                    name = field(body, "name", str, None, required=True)
                    namespace = field(body, "namespace", str, "default")
                    pdb = PodDisruptionBudget(
                        metadata=ObjectMeta(
                            name=name, namespace=namespace, uid=f"pdb-{namespace}-{name}"
                        ),
                        min_available=field(body, "min_available", int, 0),
                        selector=field(body, "selector", dict, None) or {},
                    )
                    server.store.create_pdb(pdb)
                    self._reply(201, json.dumps({"namespace": namespace, "name": name}))
                elif self.path == "/apis/v1alpha1/persistentvolumes":
                    name = field(body, "name", str, None, required=True)
                    terms = []
                    for t in field(body, "node_affinity", list, []) or []:
                        if not isinstance(t, dict):
                            raise ValueError("node_affinity entries must be objects")
                        terms.append(
                            NodeSelectorTerm(
                                key=str(t.get("key", "")),
                                operator=str(t.get("operator", "In")),
                                values=[str(v) for v in t.get("values", [])],
                            )
                        )
                    pv = PersistentVolume(
                        metadata=ObjectMeta(name=name, uid=f"pv-{name}"),
                        capacity_storage=parse_quantity(body.get("capacity", 0)),
                        storage_class_name=field(body, "storage_class", str, ""),
                        node_affinity=terms,
                        # Mirroring an existing cluster needs bound state
                        # expressible at ingestion time.
                        claim_ref=field(body, "claim_ref", str, ""),
                        phase=VolumePhase(field(body, "phase", str, "Available")),
                    )
                    server.store.create_persistent_volume(pv)
                    self._reply(201, json.dumps({"name": name}))
                elif self.path == "/apis/v1alpha1/persistentvolumeclaims":
                    name = field(body, "name", str, None, required=True)
                    namespace = field(body, "namespace", str, "default")
                    volume_name = field(body, "volume_name", str, "")
                    pvc = PersistentVolumeClaim(
                        metadata=ObjectMeta(
                            name=name, namespace=namespace, uid=f"pvc-{namespace}-{name}"
                        ),
                        storage_class_name=field(body, "storage_class", str, ""),
                        request_storage=parse_quantity(body.get("request", 0)),
                        volume_name=volume_name,
                        phase=VolumePhase(
                            field(body, "phase", str, "Bound" if volume_name else "Pending")
                        ),
                    )
                    server.store.create_persistent_volume_claim(pvc)
                    self._reply(201, json.dumps({"namespace": namespace, "name": name}))
                elif (
                    self.path.startswith("/apis/v1alpha1/leases/")
                    and self.path.endswith(("/acquire", "/release"))
                ):
                    # Leader-election arbitration endpoint: the whole
                    # acquire-or-renew ladder runs atomically inside the
                    # store under the ARBITER's clock (store.py
                    # try_acquire_lease) — the role the reference's API
                    # server plays for its ConfigMap resource lock
                    # (cmd/kube-batch/app/server.go:115-139).
                    parts = self.path.strip("/").split("/")
                    if len(parts) != 5:
                        # a raw '/' in the name would smear across path
                        # segments and arbitrate the wrong scope —
                        # electors quote(name, safe="") to prevent this
                        raise ValueError(
                            "lease path must be /apis/v1alpha1/leases/<name>/<verb> "
                            "(percent-encode the name)"
                        )
                    # unquote restores the exact scope so HTTP and
                    # in-process candidates on the same name contend on
                    # the same lease
                    lease_name, verb = urllib.parse.unquote(parts[3]), parts[4]
                    if not lease_name:
                        raise ValueError("lease name must be non-empty")
                    identity = field(body, "identity", str, None, required=True)
                    if verb == "acquire":
                        duration = body.get("lease_duration", 15.0)
                        if isinstance(duration, bool) or not isinstance(
                            duration, (int, float)
                        ):
                            raise ValueError("lease_duration must be a number")
                        lease = server.store.try_acquire_lease(
                            lease_name, identity, float(duration)
                        )
                    else:
                        lease = server.store.release_lease(lease_name, identity)
                    if lease is None:
                        self._reply(404, json.dumps({"error": "lease not found"}))
                        return
                    self._reply(
                        200,
                        json.dumps(
                            {
                                "name": lease_name,
                                "holder": lease.holder_identity,
                                "acquired": lease.holder_identity == identity,
                                "lease_duration": lease.lease_duration_seconds,
                                "renew_time": lease.renew_time,
                                "transitions": lease.lease_transitions,
                            }
                        ),
                    )
                elif self.path == "/apis/v1alpha1/storageclasses":
                    name = field(body, "name", str, None, required=True)
                    sc = StorageClass(
                        metadata=ObjectMeta(name=name, uid=f"sc-{name}"),
                        provisioner=field(body, "provisioner", str, ""),
                        volume_binding_mode=VolumeBindingMode(
                            field(body, "volume_binding_mode", str, "Immediate")
                        ),
                    )
                    server.store.create_storage_class(sc)
                    self._reply(201, json.dumps({"name": name}))
                else:
                    self._reply(404, json.dumps({"error": "not found"}))
            except AlreadyExists as e:
                self._reply(409, json.dumps({"error": str(e.args[0])}))
            except (ValueError, TypeError, KeyError, json.JSONDecodeError) as e:
                self._reply(400, json.dumps({"error": str(e)}))

        def do_DELETE(self):  # noqa: N802
            parts = self.path.strip("/").split("/")
            try:
                if parts[:2] != ["apis", "v1alpha1"] or len(parts) < 4:
                    self._reply(404, json.dumps({"error": "not found"}))
                    return
                kind, rest = parts[2], parts[3:]
                if kind == "queues" and len(rest) == 1:
                    server.store.delete_queue(rest[0])
                elif kind == "nodes" and len(rest) == 1:
                    server.store.delete_node(rest[0])
                elif kind == "pods" and len(rest) == 2:
                    server.store.delete_pod(rest[0], rest[1])
                elif kind == "podgroups" and len(rest) == 2:
                    server.store.delete_pod_group(rest[0], rest[1])
                elif kind == "priorityclasses" and len(rest) == 1:
                    server.store.delete_priority_class(rest[0])
                elif kind == "poddisruptionbudgets" and len(rest) == 2:
                    server.store.delete("poddisruptionbudgets", f"{rest[0]}/{rest[1]}")
                elif kind == "persistentvolumes" and len(rest) == 1:
                    server.store.delete_persistent_volume(rest[0])
                elif kind == "persistentvolumeclaims" and len(rest) == 2:
                    server.store.delete_persistent_volume_claim(rest[0], rest[1])
                elif kind == "storageclasses" and len(rest) == 1:
                    server.store.delete("storageclasses", rest[0])
                else:
                    self._reply(404, json.dumps({"error": "not found"}))
                    return
            except KeyError as e:
                self._reply(404, json.dumps({"error": str(e)}))
                return
            self._reply(200, json.dumps({"deleted": "/".join(parts[3:])}))

    return Handler


class SchedulerServer:
    """One process worth of scheduler: store + cache + loop + HTTP.
    ``store``: an existing ``ClusterStore`` to schedule over (None: a new
    one); ``journal_path``: the write-intent journal's file (None: the
    ``KBT_JOURNAL`` path, and with neither no journal); ``device``: the
    CUDA device the loop thread makes current (``Scheduler.run``; None:
    the thread's default, ``cuda:0``); ``store_backend_url``: schedule over
    that store process's ``/backend/v1/`` protocol as a federation shard
    (``KBT_FEDERATION``) instead of over ``store``; ``wire_protocol``: the
    store-backend protocol this server speaks (2, or 1 to pin v1)."""

    def __init__(
        self,
        scheduler_name: str = DEFAULT_SCHEDULER_NAME,
        scheduler_conf: Optional[str] = None,
        schedule_period: float = DEFAULT_SCHEDULE_PERIOD,
        default_queue: str = DEFAULT_QUEUE,
        listen_address: str = DEFAULT_LISTEN_ADDRESS,
        store: Optional[ClusterStore] = None,
        journal_path: Optional[str] = None,
        device=None,
        store_backend_url: Optional[str] = None,
        wire_protocol: int = 2,
    ) -> None:
        # Store-backend wire protocol this server SPEAKS (not what any
        # client negotiated): 2 advertises delta watch / txn batches /
        # the binary codec on /backend/v1/version and serves HTTP/1.1
        # keep-alive; 1 pins the pre-v2 surface byte-for-byte (mixed-
        # version drills pass 1 here).
        self.wire_protocol = int(wire_protocol)

        # Federation mode (--store-backend): this process schedules over
        # a remote store's /backend/v1/ protocol instead of owning an
        # in-process store. The LoopbackBackend mirror duck-types the
        # store surface, so the watch hub, the observability reads and
        # the workload API below all serve (and proxy) from it.
        self.backend = None
        if store_backend_url:
            self.backend = LoopbackBackend(store_backend_url)
            self.store = self.backend
        else:
            self.store = store or ClusterStore()
        self.watch_hub = WatchHub(self.store)
        # Crash-consistent write side (recovery/): --journal / KBT_JOURNAL
        # attaches a bind-intent WAL to the cache; start() reconciles it
        # against store truth before the loop runs.
        self.journal = None
        journal_path = journal_path or os.environ.get("KBT_JOURNAL", "").strip()
        if journal_path:
            self.journal = WriteIntentJournal(journal_path)
        self.slot_manager = None
        if self.backend is not None:
            shard, shards = parse_shard_spec(
                os.environ.get(FED_ENV, "").strip() or "1"
            )
            # Dynamic resharding: KBT_SHARD_JOURNAL_DIR gives every shard
            # a well-known per-slot journal (shard-{i}.wal) that a
            # survivor reconciles on adoption; an explicit --journal /
            # KBT_JOURNAL path wins.
            if self.journal is None and shards > 1 and shard_journal_dir():
                self.journal = WriteIntentJournal(
                    shard_journal_path(shard_journal_dir(), shard)
                )
            self.cache = FederatedCache(
                self.backend, shard=shard, shards=shards,
                shard_key=shard_key_mode(), scheduler_name=scheduler_name,
                default_queue=default_queue, journal=self.journal,
                staleness_fn=self.backend.snapshot_age,
            )
            if shards > 1:
                # Leased shard slots: this process holds (and renews) the
                # lease for its primary slot and adopts orphaned peers'
                # slots; the LoopbackBackend is the lease arbiter (its
                # lease verbs POST the store process's
                # /apis/v1alpha1/leases/ endpoint, its LEASES mirror is
                # the slot-watch).
                self.slot_manager = ShardSlotManager(
                    self.backend, self.cache,
                    identity=f"{scheduler_name}-{shard}@{os.getpid()}",
                    on_owned_change=lambda adopted, removed: (
                        self.scheduler.on_owned_slots_changed(adopted, removed)
                    ),
                )
        else:
            self.cache = SchedulerCache(
                self.store, scheduler_name=scheduler_name,
                default_queue=default_queue, journal=self.journal,
            )
        self.scheduler = Scheduler(
            self.cache, scheduler_conf=scheduler_conf, schedule_period=schedule_period
        )
        self.device = device
        host, _, port = listen_address.rpartition(":")
        # Unlike the reference's ListenAddress (app/options/options.go),
        # which only serves metrics/healthz, this port also carries the
        # unauthenticated mutating workload API — so a bare ":8080"
        # defaults to loopback; binding other interfaces requires naming
        # them explicitly (e.g. "0.0.0.0:8080").
        self.httpd = ThreadingHTTPServer((host or "127.0.0.1", int(port)), _make_handler(self))
        self.httpd.daemon_threads = True
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    @property
    def listen_port(self) -> int:
        return self.httpd.server_address[1]

    def reconcile(self) -> Optional[ReconcileReport]:
        """Takeover reconciliation (recovery/reconcile.py): scan the
        bind-intent journal against store truth — confirm landed writes,
        re-dispatch orphans, roll back half-bound gangs. Runs before the
        loop on every start (process restart AND lease takeover both
        pass through here: a leader only start()s after acquiring)."""
        if self.journal is None:
            return None
        return reconcile_journal(self.journal, self.store)

    def start(self) -> None:
        # Ensure the default queue exists (the reference expects an admin
        # to create it; the in-process store bootstraps it — in
        # federation mode the store process owns that bootstrap).
        if (
            self.backend is None
            and self.store.get("queues", self.cache.default_queue) is None
        ):
            self.store.create_queue(
                Queue(metadata=ObjectMeta(name=self.cache.default_queue))
            )
        self.reconcile()
        # Arm the workload API's admission gate (KBT_ADMISSION) and keep its
        # backlog accounting true: an admitted pod stops counting against
        # its lane when it binds, or when it is deleted while pending.
        from kube_batch_tpu_torch import admission

        if admission.configure() and self.backend is None:
            self.store.add_event_handler(
                "pods",
                EventHandler(
                    on_update=lambda old, new: (
                        admission.note_done(f"{new.namespace}/{new.name}")
                        if (not old.node_name and new.node_name) else None
                    ),
                    on_delete=lambda obj: admission.note_done(f"{obj.namespace}/{obj.name}"),
                ),
            )
        if self.backend is not None:
            self.backend.start()
        if self.slot_manager is not None:
            # Acquire in the background: the cache already owns its
            # primary slot's filter, and optimistic binds keep a brief
            # double-ownership overlap correct — so scheduling need not
            # wait out a reclaim handshake with a survivor that adopted
            # our slot while we were down.
            threading.Thread(
                target=self.slot_manager.start,
                kwargs={"deadline_s": 3600.0},
                name="kb-slot-acquire",
                daemon=True,
            ).start()
        self._stop.clear()
        t_http = threading.Thread(
            target=self.httpd.serve_forever, name="kb-http", daemon=True
        )
        t_sched = threading.Thread(
            target=self.scheduler.run,
            args=(self._stop,),
            kwargs={"device": self.device},
            name="kb-loop",
            daemon=True,
        )
        t_http.start()
        t_sched.start()
        self._threads = [t_http, t_sched]

    def stop(self) -> None:
        self._stop.set()
        if self.slot_manager is not None:
            # release owned slots so survivors adopt immediately instead
            # of waiting out the lease (the graceful half of failover)
            self.slot_manager.stop(release=True)
        self.watch_hub.close()
        self.httpd.shutdown()
        self.httpd.server_close()
        if self.backend is not None:
            self.backend.stop()
        self.cache.stop()
        for t in self._threads:
            # the loop finishes the cycle in flight before it sees the stop
            t.join(timeout=10)
            while t.is_alive():
                log.warning("stop: waiting for %s to finish its cycle", t.name)
                t.join(timeout=10)
        self._threads.clear()
        if self.journal is not None:
            self.journal.close()


def build_parser() -> argparse.ArgumentParser:
    """Flags at parity with options.go:57-78."""
    p = argparse.ArgumentParser(
        prog="kube-batch-tpu-torch",
        description="batch scheduler with the allocate solve on a CUDA card "
        "(kube-batch capability parity)",
    )
    p.add_argument(
        "--scheduler-name",
        default=DEFAULT_SCHEDULER_NAME,
        help="handle pods whose scheduler_name matches this",
    )
    p.add_argument(
        "--scheduler-conf", default="", help="absolute path of the scheduler conf file"
    )
    p.add_argument(
        "--schedule-period",
        type=float,
        default=DEFAULT_SCHEDULE_PERIOD,
        help="seconds between scheduling cycles",
    )
    p.add_argument(
        "--default-queue", default=DEFAULT_QUEUE, help="default queue for jobs"
    )
    p.add_argument(
        "--listen-address",
        default=DEFAULT_LISTEN_ADDRESS,
        help="HTTP listen address for /metrics and the workload/queue API; "
        "a bare ':PORT' binds loopback only — this port carries an "
        "unauthenticated mutating API, so name an interface (e.g. "
        "'0.0.0.0:8080') to expose it",
    )
    p.add_argument(
        "--leader-elect",
        action="store_true",
        help="acquire the lock file before running the loop (HA standby)",
    )
    p.add_argument(
        "--lock-file",
        default="",
        help="leader-election lock file (single-host HA; required with "
        "--leader-elect unless --lease-url is set)",
    )
    p.add_argument(
        "--lease-url",
        default="",
        help="base URL of the lease arbiter (any scheduler-API endpoint, "
        "e.g. http://store-host:8080) for cluster-wide leader election; "
        "replaces --lock-file when set",
    )
    p.add_argument(
        "--lease-name",
        default="kube-batch",
        help="lease object name under the arbiter (reference lock object "
        "name, server.go:117)",
    )
    p.add_argument(
        "--store-backend",
        default="",
        help="base URL of a store process (e.g. http://store:8080): run "
        "this scheduler over its /backend/v1/ protocol instead of an "
        "in-process store — federation mode. The shard is "
        "KBT_FEDERATION='i/N', the partition key KBT_SHARD_KEY "
        "(queue|namespace|gang); conflicting placements resolve by "
        "optimistic concurrency (losers retry with a fresh snapshot)",
    )
    p.add_argument(
        "--journal",
        default="",
        help="bind-intent journal (WAL) path for crash-consistent "
        "failover; reconciled against store truth on startup/takeover "
        "(env KBT_JOURNAL; empty = journaling off)",
    )
    p.add_argument(
        "--fleet",
        default="",
        help="comma-separated peer base URLs (http://host:port) to "
        "aggregate fleet-wide SLO sketches and counters from — serves "
        "cluster-wide kbt..._fleet_* gauges on /metrics and the merged "
        "rollup on /debug/fleet (env KBT_FLEET; empty = off). Works "
        "from any scheduler, or standalone with an unmatched "
        "--scheduler-name as a dedicated observatory",
    )
    p.add_argument("--version", action="store_true", help="show version and quit")
    p.add_argument("-v", type=int, default=0, help="log verbosity (glog -v)")
    return p


def run(argv: Optional[list[str]] = None) -> None:
    """reference app.Run (server.go:63-140)."""
    opt = build_parser().parse_args(argv)
    if opt.version:
        version.print_version_and_exit()
    if opt.leader_elect and not (opt.lock_file or opt.lease_url):
        raise SystemExit(
            "--lock-file or --lease-url must be set when --leader-elect is enabled"
        )
    pkg_log.set_verbosity(opt.v)
    # glog's lines, as the JAX server's (log.py), for every logger
    logging.basicConfig(level=logging.DEBUG if opt.v >= 4 else logging.INFO, handlers=[pkg_log.glog_handler()])
    # Last-gasp observability: dump the flight-recorder ring on SIGTERM
    # (chains any previously-installed handler).
    obs.install_signal_dump()
    if opt.fleet:
        # the flag arms the environment the conf reload resolves, so a conf
        # without a fleet: key cannot undo it on the next cycle
        from kube_batch_tpu_torch.obs import fleet as _fleet

        os.environ[_fleet.ENV] = opt.fleet
        _fleet.configure()

    elector = None
    if opt.leader_elect:
        identity = f"{socket.gethostname()}_{os.getpid()}_{uuid.uuid4().hex[:8]}"
        if opt.lease_url:
            elector = StoreLeaseElector(opt.lease_url, opt.lease_name, identity)
            log.info(
                "waiting for leadership on lease %s at %s ...",
                opt.lease_name, opt.lease_url,
            )
            elector.acquire(blocking=True)

            def _lost() -> None:
                # the reference's OnStoppedLeading is glog.Fatalf
                # (server.go:133-135): a fenced-out leader must not keep
                # mutating cluster state.
                log.error("leaderelection lost")
                os._exit(1)

            elector.start_renewing(_lost)
        else:
            elector = LeaderElector(opt.lock_file, identity)
            log.info("waiting for leadership on %s ...", opt.lock_file)
            elector.acquire(blocking=True)

    server = SchedulerServer(
        scheduler_name=opt.scheduler_name,
        scheduler_conf=opt.scheduler_conf or None,
        schedule_period=opt.schedule_period,
        default_queue=opt.default_queue,
        listen_address=opt.listen_address,
        journal_path=opt.journal or None,
        store_backend_url=opt.store_backend or None,
    )
    # start() reconciles the journal before the loop: both the restart
    # and the lease-takeover path land here only once leadership (if
    # any) is held, so reconciliation always runs under the lease.
    server.start()
    log.info(
        "kube-batch-tpu-torch %s serving on :%d, scheduling every %.2fs",
        version.VERSION, server.listen_port, opt.schedule_period,
    )
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        if elector is not None:
            elector.release()


if __name__ == "__main__":
    run()
