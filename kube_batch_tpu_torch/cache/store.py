"""In-process cluster store: the API-server + informer substitute.

The reference's cache subscribes nine client-go informers to the API
server (cache/cache.go:233-301) and receives add/update/delete callbacks
as the watch stream delivers deltas. TPU-native kube-batch runs against
an in-process object store instead: callers (tests, the simulator, a
future external bridge) mutate the store through k8s-shaped CRUD calls,
and the store dispatches the same add/update/delete callbacks to every
registered handler — including an initial-list replay on registration,
which is what makes ``has_synced`` true (the WaitForCacheSync
equivalent, cache/cache.go:327-348).

Event dispatch is synchronous in the mutating caller's thread, ordered
per object, outside the store lock (so a handler may re-enter the
store). That preserves the informer contract the cache depends on —
events for one object arrive in order — without a background pump
thread per kind.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from kube_batch_tpu_torch.utils.locking import assume_locked
from kube_batch_tpu_torch.apis.types import (
    Lease,
    Node,
    ObjectMeta,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    PodDisruptionBudget,
    PodGroup,
    PodPhase,
    PriorityClass,
    Queue,
    StorageClass,
)

log = logging.getLogger(__name__)

PODS = "pods"
NODES = "nodes"
POD_GROUPS = "podgroups"
QUEUES = "queues"
PDBS = "poddisruptionbudgets"
PRIORITY_CLASSES = "priorityclasses"
PVS = "persistentvolumes"
PVCS = "persistentvolumeclaims"
STORAGE_CLASSES = "storageclasses"
LEASES = "leases"

KINDS = (
    PODS, NODES, POD_GROUPS, QUEUES, PDBS, PRIORITY_CLASSES,
    PVS, PVCS, STORAGE_CLASSES, LEASES,
)

# Kinds whose objects are cluster-scoped (keyed by name, not ns/name).
_CLUSTER_SCOPED = {NODES, QUEUES, PRIORITY_CLASSES, PVS, STORAGE_CLASSES, LEASES}


class AlreadyExists(KeyError):
    """create() of a key already present — typed so API layers can map
    it to HTTP 409 without string-matching the message."""


class StaleWrite(RuntimeError):
    """Optimistic-concurrency rejection (Omega-style): a conditional
    write carried a snapshot version older than the store state it would
    overwrite, or the write no longer applies to current truth. Typed —
    and carrying the conflicted object — so the losing scheduler can
    resync just the conflicted gang and retry, instead of treating the
    rejection like an infrastructure write failure."""

    def __init__(
        self, kind: str, key: str, reason: str, expected: int, actual: int
    ) -> None:
        super().__init__(
            f"stale write on {kind} {key!r}: {reason} "
            f"(snapshot v{expected}, store v{actual})"
        )
        self.kind = kind
        self.key = key
        self.reason = reason
        self.expected = expected
        self.actual = actual


def obj_key(kind: str, obj: Any) -> str:
    meta = obj.metadata
    if kind in _CLUSTER_SCOPED:
        return meta.name
    return f"{meta.namespace}/{meta.name}"


@dataclass
class EventHandler:
    """One informer subscription (client-go ResourceEventHandlerFuncs +
    the optional FilterFunc of FilteringResourceEventHandler)."""

    on_add: Optional[Callable[[Any], None]] = None
    on_update: Optional[Callable[[Any, Any], None]] = None
    on_delete: Optional[Callable[[Any], None]] = None
    filter: Optional[Callable[[Any], bool]] = None

    def _passes(self, obj: Any) -> bool:
        return self.filter is None or self.filter(obj)

    def add(self, obj: Any) -> None:
        if self.on_add and self._passes(obj):
            self.on_add(obj)

    def update(self, old: Any, new: Any) -> None:
        # client-go FilteringResourceEventHandler semantics: an update
        # whose old object was filtered out is delivered as an Add, and
        # one whose new object is filtered out as a Delete.
        old_ok, new_ok = self._passes(old), self._passes(new)
        if old_ok and new_ok:
            if self.on_update:
                self.on_update(old, new)
        elif new_ok:
            if self.on_add:
                self.on_add(new)
        elif old_ok:
            if self.on_delete:
                self.on_delete(old)

    def delete(self, obj: Any) -> None:
        if self.on_delete and self._passes(obj):
            self.on_delete(obj)


@dataclass
class _KindStore:
    objects: dict[str, Any] = field(default_factory=dict)
    handlers: list[EventHandler] = field(default_factory=list)


class ClusterStore:
    """Thread-safe object store with informer-style event fan-out."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._kinds: dict[str, _KindStore] = {k: _KindStore() for k in KINDS}
        # Events are appended under _lock (atomically with the mutation)
        # and drained FIFO under _dispatch_lock, so handlers observe
        # every event exactly once, in mutation order, even under
        # concurrent writers — the informer delivery contract. The
        # dispatch lock is re-entrant: a handler may mutate the store,
        # and the nested event is delivered inline.
        self._dispatch_lock = threading.RLock()
        self._events: deque = deque()  # (verb, handlers, old, new)
        # Optimistic-concurrency state (all #: guarded_by _lock):
        # _version counts every committed mutation; a scheduler stamps
        # it into its snapshot and sends it back with each conditional
        # write. _placement_version[node] is the store version of the
        # last placement write touching that node — the conflict check
        # is per node, not global, so schedulers binding onto disjoint
        # nodes never conflict. _node_alloc[node] is the running sum of
        # bound, non-terminal pod requests, maintained incrementally so
        # the conditional commit can reject an over-capacity bind in
        # O(gang) instead of O(pods).
        self._version = 0
        self._placement_version: dict[str, int] = {}
        self._node_alloc: dict[str, Any] = {}

    # -- event pump --------------------------------------------------------

    def _drain(self) -> None:
        while True:
            with self._dispatch_lock:
                with self._lock:
                    if not self._events:
                        return
                    verb, handlers, old, new = self._events.popleft()
                for h in handlers:
                    if verb == "add":
                        h.add(new)
                    elif verb == "update":
                        h.update(old, new)
                    else:
                        h.delete(old)

    # -- subscription ------------------------------------------------------

    def add_event_handler(self, kind: str, handler: EventHandler) -> None:
        """Register + initial-list replay (informer.AddEventHandler).
        Registration and replay enqueue atomically with respect to
        concurrent mutations, so the handler sees each object exactly
        once — either via replay or via the mutation's own event."""
        with self._lock:
            ks = self._kinds[kind]
            ks.handlers.append(handler)
            for obj in ks.objects.values():
                self._events.append(("add", [handler], None, obj))
        self._drain()

    # -- optimistic-concurrency bookkeeping --------------------------------

    @property
    def version(self) -> int:
        """Monotonic store version: bumps once per committed mutation.
        Schedulers stamp it into their snapshot and send it back with
        every conditional write (conditional_bind_many / _unbind)."""
        with self._lock:
            return self._version

    def placement_version(self, node: str) -> int:
        """Store version of the last placement write touching ``node``
        (0 = never placed on). The per-node conflict granularity."""
        with self._lock:
            return self._placement_version.get(node, 0)

    def node_allocated(self, node: str) -> Any:
        """Clone of the incremental allocated-resource sum for ``node``
        (bound, non-terminal pods). Bench/fsck introspection."""
        from kube_batch_tpu_torch.api.resource_info import Resource

        with self._lock:
            alloc = self._node_alloc.get(node)
            return alloc.clone() if alloc is not None else Resource.empty()

    @assume_locked
    def _bump_locked(self) -> int:
        self._version += 1
        return self._version

    @assume_locked
    def _account_locked(self, kind: str, old: Any, new: Any) -> None:
        """Maintain _node_alloc/_placement_version across one committed
        pod mutation. Runs AFTER _bump_locked so the placement version
        recorded is the mutation's own version. A pod contributes to its
        node's allocation while bound and non-terminal; any transition
        in or out of that state is a placement write on the node."""
        if kind != PODS:
            return
        from kube_batch_tpu_torch.api.helpers import get_pod_resource_request
        from kube_batch_tpu_torch.api.resource_info import Resource

        for pod, sign in ((old, -1), (new, +1)):
            if pod is None or not pod.node_name:
                continue
            if pod.phase in (PodPhase.SUCCEEDED, PodPhase.FAILED):
                continue
            node = pod.node_name
            req = get_pod_resource_request(pod)
            alloc = self._node_alloc.setdefault(node, Resource.empty())
            if sign > 0:
                alloc.add(req)
            else:
                # tolerant subtract (Resource.sub raises on epsilon
                # underflow; symmetric add/remove must never throw here)
                alloc.milli_cpu -= req.milli_cpu
                alloc.memory -= req.memory
                for name, q in req.scalars.items():
                    alloc.scalars[name] = alloc.scalars.get(name, 0.0) - q
            self._placement_version[node] = self._version

    # -- CRUD --------------------------------------------------------------

    @assume_locked
    def _ks(self, kind: str) -> _KindStore:
        ks = self._kinds.get(kind)
        if ks is None:
            raise KeyError(f"unknown kind {kind!r}")
        return ks

    def create(self, kind: str, obj: Any) -> Any:
        key = obj_key(kind, obj)
        with self._lock:
            ks = self._ks(kind)
            if key in ks.objects:
                raise AlreadyExists(f"{kind} {key!r} already exists")
            ks.objects[key] = obj
            self._bump_locked()
            self._account_locked(kind, None, obj)
            self._events.append(("add", list(ks.handlers), None, obj))
        log.debug("store: created %s %s", kind, key)
        self._drain()
        return obj

    def update(self, kind: str, obj: Any) -> Any:
        key = obj_key(kind, obj)
        with self._lock:
            ks = self._ks(kind)
            old = ks.objects.get(key)
            if old is None:
                raise KeyError(f"{kind} {key!r} not found")
            ks.objects[key] = obj
            self._bump_locked()
            self._account_locked(kind, old, obj)
            self._events.append(("update", list(ks.handlers), old, obj))
        log.debug("store: updated %s %s", kind, key)
        self._drain()
        return obj

    def delete(self, kind: str, key: str) -> Any:
        with self._lock:
            ks = self._ks(kind)
            obj = ks.objects.pop(key, None)
            if obj is None:
                raise KeyError(f"{kind} {key!r} not found")
            self._bump_locked()
            self._account_locked(kind, obj, None)
            self._events.append(("delete", list(ks.handlers), obj, None))
        log.debug("store: deleted %s %s", kind, key)
        self._drain()
        return obj

    # -- conditional writes (Omega-style optimistic concurrency) -----------

    def conditional_bind_many(
        self, bindings: list[tuple[str, str, str]], snapshot_version: int
    ) -> list[Pod]:
        """Transactionally bind ``[(namespace, name, hostname)]`` against
        the snapshot the scheduler solved over. Every entry is checked
        under ONE lock hold before ANY entry is applied — all-or-nothing
        per call, so the caller dispatches one gang per transaction and a
        rejected gang needs no rollback. Rejection reasons (StaleWrite):

        - ``missing``       the pod was deleted since the snapshot
        - ``already_bound`` another scheduler placed the pod first
        - ``no_node``       the target node is gone
        - ``stale_node``    the node took a placement write the snapshot
                            never saw (per-node version check)
        - ``capacity``      store-side admission: requests no longer fit
        - ``injected``      the ``store.conflict`` fault drill

        A pod already bound to the SAME host is skipped, not rejected —
        that is the idempotent journal re-dispatch case."""
        from kube_batch_tpu_torch import faults
        from kube_batch_tpu_torch.api.helpers import get_pod_resource_request
        from kube_batch_tpu_torch.api.resource_info import Resource

        with self._lock:
            if faults.should_fire("store.conflict"):
                ns, name, _h = bindings[0] if bindings else ("", "", "")
                raise StaleWrite(
                    PODS, f"{ns}/{name}", "injected", snapshot_version, self._version
                )
            ks = self._ks(PODS)
            nodes = self._ks(NODES).objects
            staged: list[tuple[str, Pod, str]] = []
            batch_alloc: dict[str, Resource] = {}
            for ns, name, hostname in bindings:
                key = f"{ns}/{name}"
                old = ks.objects.get(key)
                if old is None:
                    raise StaleWrite(
                        PODS, key, "missing", snapshot_version, self._version
                    )
                if old.node_name:
                    if old.node_name == hostname:
                        continue  # journal re-dispatch: already landed
                    raise StaleWrite(
                        PODS, key, "already_bound", snapshot_version, self._version
                    )
                node = nodes.get(hostname)
                if node is None:
                    raise StaleWrite(
                        NODES, hostname, "no_node", snapshot_version, self._version
                    )
                node_v = self._placement_version.get(hostname, 0)
                if node_v > snapshot_version:
                    raise StaleWrite(
                        NODES, hostname, "stale_node", snapshot_version, node_v
                    )
                req = get_pod_resource_request(old)
                pending = batch_alloc.setdefault(hostname, Resource.empty())
                have = self._node_alloc.get(hostname)
                total = have.clone() if have is not None else Resource.empty()
                total.add(pending).add(req)
                if not total.less_equal(Resource.from_resource_list(node.allocatable)):
                    raise StaleWrite(
                        NODES, hostname, "capacity", snapshot_version, self._version
                    )
                pending.add(req)
                staged.append((key, old, hostname))
            applied: list[Pod] = []
            for key, old, hostname in staged:
                new = dataclasses.replace(old, node_name=hostname)
                ks.objects[key] = new
                self._bump_locked()
                self._account_locked(PODS, old, new)
                self._events.append(("update", list(ks.handlers), old, new))
                applied.append(new)
        log.debug(
            "store: conditionally bound %d pod(s) at snapshot v%d",
            len(applied), snapshot_version,
        )
        self._drain()
        return applied

    def conditional_unbind(
        self, namespace: str, name: str, snapshot_version: int
    ) -> Optional[Pod]:
        """Optimistic evict twin of conditional_bind_many: clear the
        pod's placement iff its node took no placement write since the
        snapshot. An already-unbound pod is the idempotent re-dispatch
        case and returns the current object unchanged."""
        from kube_batch_tpu_torch import faults

        key = f"{namespace}/{name}"
        with self._lock:
            if faults.should_fire("store.conflict"):
                raise StaleWrite(
                    PODS, key, "injected", snapshot_version, self._version
                )
            ks = self._ks(PODS)
            old = ks.objects.get(key)
            if old is None:
                raise StaleWrite(PODS, key, "missing", snapshot_version, self._version)
            if not old.node_name:
                return old  # journal re-dispatch: already unbound
            node_v = self._placement_version.get(old.node_name, 0)
            if node_v > snapshot_version:
                raise StaleWrite(
                    NODES, old.node_name, "stale_node", snapshot_version, node_v
                )
            new = dataclasses.replace(old, node_name="")
            ks.objects[key] = new
            self._bump_locked()
            self._account_locked(PODS, old, new)
            self._events.append(("update", list(ks.handlers), old, new))
        log.debug(
            "store: conditionally unbound %s at snapshot v%d", key, snapshot_version
        )
        self._drain()
        return new

    def conditional_evict(
        self, namespace: str, name: str, snapshot_version: int
    ) -> Optional[Pod]:
        """Optimistic delete (the evictor's transaction): remove the pod
        iff its node took no placement write since the snapshot — a
        preemption decision solved over a stale view must not kill a pod
        another scheduler just placed around. A pod already gone is the
        idempotent re-dispatch case."""
        from kube_batch_tpu_torch import faults

        key = f"{namespace}/{name}"
        with self._lock:
            if faults.should_fire("store.conflict"):
                raise StaleWrite(
                    PODS, key, "injected", snapshot_version, self._version
                )
            ks = self._ks(PODS)
            old = ks.objects.get(key)
            if old is None:
                return None  # journal re-dispatch: already evicted
            if old.node_name:
                node_v = self._placement_version.get(old.node_name, 0)
                if node_v > snapshot_version:
                    raise StaleWrite(
                        NODES, old.node_name, "stale_node", snapshot_version, node_v
                    )
            ks.objects.pop(key)
            self._bump_locked()
            self._account_locked(PODS, old, None)
            self._events.append(("delete", list(ks.handlers), old, None))
        log.debug(
            "store: conditionally evicted %s at snapshot v%d", key, snapshot_version
        )
        self._drain()
        return old

    def get(self, kind: str, key: str) -> Optional[Any]:
        with self._lock:
            return self._ks(kind).objects.get(key)

    def list(self, kind: str) -> list[Any]:
        with self._lock:
            return list(self._ks(kind).objects.values())

    # -- leader-election arbiter -------------------------------------------

    def try_acquire_lease(
        self,
        name: str,
        identity: str,
        lease_duration: float = 15.0,
        now: Optional[float] = None,
    ) -> Lease:
        """Atomic acquire-or-renew of the named Lease; returns the lease
        as it stands after the attempt (caller checks ``holder_identity``
        to learn whether it leads). The arbitration ladder matches
        client-go's leaderelection.tryAcquireOrRenew
        (the reference drives it via leaderelection.RunOrDie,
        cmd/kube-batch/app/server.go:127-139):

        - no lease, or holder released (empty), or lease expired
          (``now > renew_time + lease_duration_seconds``): take it —
          transitions+1 when taking over from a different holder;
        - held by us: renew (refresh renew_time);
        - held by someone else and fresh: no mutation.

        All times are THIS store's clock, so two candidates on hosts
        with skewed clocks still agree on expiry."""
        import math
        import time as _time

        if not identity:
            # "" is the released sentinel — accepting it would report
            # acquired=true while leaving the lease free for anyone
            # (split-brain)
            raise ValueError("lease identity must be non-empty")
        if not (
            isinstance(lease_duration, (int, float))
            and math.isfinite(lease_duration)
            and 0 < lease_duration <= 86400
        ):
            # NaN/inf never expire (blocking failover forever after the
            # holder dies); <=0 is instantly stealable from a live leader
            raise ValueError("lease_duration must be in (0, 86400] seconds")
        now = _time.time() if now is None else now
        with self._lock:
            ks = self._ks(LEASES)
            cur: Optional[Lease] = ks.objects.get(name)
            if cur is not None and cur.holder_identity not in ("", identity):
                expired = now > cur.renew_time + cur.lease_duration_seconds
                if not expired:
                    return cur
            new = Lease(
                metadata=ObjectMeta(name=name),
                holder_identity=identity,
                lease_duration_seconds=lease_duration,
                acquire_time=(
                    cur.acquire_time
                    if cur is not None and cur.holder_identity == identity
                    else now
                ),
                renew_time=now,
                lease_transitions=(
                    cur.lease_transitions
                    + (1 if cur.holder_identity != identity else 0)
                    if cur is not None
                    else 0
                ),
            )
            ks.objects[name] = new
            self._bump_locked()
            if cur is None:
                self._events.append(("add", list(ks.handlers), None, new))
            else:
                self._events.append(("update", list(ks.handlers), cur, new))
        if cur is None or cur.holder_identity != identity:
            log.info("lease %s acquired by %s", name, identity)
        self._drain()
        return new

    def release_lease(self, name: str, identity: str) -> Optional[Lease]:
        """Graceful hand-off: the holder clears its identity so a standby
        can take over immediately instead of waiting out the lease (the
        client-go ReleaseOnCancel behavior). No-op unless ``identity``
        currently holds the lease."""
        if not identity:
            # "" is the released sentinel; '""' == already-released holder
            # would otherwise pass the holder check below
            raise ValueError("lease identity must be non-empty")
        with self._lock:
            ks = self._ks(LEASES)
            cur: Optional[Lease] = ks.objects.get(name)
            if cur is None or cur.holder_identity != identity:
                return cur
            new = Lease(
                metadata=cur.metadata,
                holder_identity="",
                lease_duration_seconds=cur.lease_duration_seconds,
                acquire_time=cur.acquire_time,
                renew_time=cur.renew_time,
                lease_transitions=cur.lease_transitions,
            )
            ks.objects[name] = new
            self._bump_locked()
            self._events.append(("update", list(ks.handlers), cur, new))
        log.info("lease %s released by %s", name, identity)
        self._drain()
        return new

    # -- typed conveniences (what tests and the simulator use) -------------

    def create_pod(self, pod: Pod) -> Pod:
        return self.create(PODS, pod)

    def update_pod(self, pod: Pod) -> Pod:
        return self.update(PODS, pod)

    def delete_pod(self, namespace: str, name: str) -> Pod:
        return self.delete(PODS, f"{namespace}/{name}")

    def get_pod(self, namespace: str, name: str) -> Optional[Pod]:
        return self.get(PODS, f"{namespace}/{name}")

    def create_node(self, node: Node) -> Node:
        return self.create(NODES, node)

    def update_node(self, node: Node) -> Node:
        return self.update(NODES, node)

    def delete_node(self, name: str) -> Node:
        return self.delete(NODES, name)

    def create_pod_group(self, pg: PodGroup) -> PodGroup:
        return self.create(POD_GROUPS, pg)

    def update_pod_group(self, pg: PodGroup) -> PodGroup:
        return self.update(POD_GROUPS, pg)

    def delete_pod_group(self, namespace: str, name: str) -> PodGroup:
        return self.delete(POD_GROUPS, f"{namespace}/{name}")

    def create_queue(self, q: Queue) -> Queue:
        return self.create(QUEUES, q)

    def delete_queue(self, name: str) -> Queue:
        return self.delete(QUEUES, name)

    def create_pdb(self, pdb: PodDisruptionBudget) -> PodDisruptionBudget:
        return self.create(PDBS, pdb)

    def create_priority_class(self, pc: PriorityClass) -> PriorityClass:
        return self.create(PRIORITY_CLASSES, pc)

    def delete_priority_class(self, name: str) -> PriorityClass:
        return self.delete(PRIORITY_CLASSES, name)

    def create_persistent_volume(self, pv: PersistentVolume) -> PersistentVolume:
        return self.create(PVS, pv)

    def update_persistent_volume(self, pv: PersistentVolume) -> PersistentVolume:
        return self.update(PVS, pv)

    def delete_persistent_volume(self, name: str) -> PersistentVolume:
        return self.delete(PVS, name)

    def create_persistent_volume_claim(
        self, pvc: PersistentVolumeClaim
    ) -> PersistentVolumeClaim:
        return self.create(PVCS, pvc)

    def update_persistent_volume_claim(
        self, pvc: PersistentVolumeClaim
    ) -> PersistentVolumeClaim:
        return self.update(PVCS, pvc)

    def delete_persistent_volume_claim(
        self, namespace: str, name: str
    ) -> PersistentVolumeClaim:
        return self.delete(PVCS, f"{namespace}/{name}")

    def create_storage_class(self, sc: StorageClass) -> StorageClass:
        return self.create(STORAGE_CLASSES, sc)
