"""SchedulerCache: the event-driven mutable mirror of the cluster.

Redesign of reference pkg/scheduler/cache/cache.go:72-345 +
event_handlers.go:37-795 + util.go:42-60 for the in-process runtime:
instead of nine client-go informers against an API server, the cache
subscribes to a ClusterStore (cache/store.py) and receives the same
add/update/delete callbacks. Everything downstream is kept:

- Jobs/Nodes/Queues/PriorityClasses mirrors under one mutex;
- the pod filter (only this scheduler's pending pods + every
  non-pending pod, cache.go:245-266);
- shadow PodGroups for podgroup-less pods (util.go:42-60);
- PriorityClass resolution at snapshot time (cache.go:570-580);
- write side: Bind/Evict mutate the mirror synchronously, then fire
  the store write asynchronously; a failed write re-enters through the
  rate-limited ``errTasks`` resync queue (cache.go:480-534);
- terminated jobs are garbage-collected through the ``deletedJobs``
  queue (cache.go:480-510);
- Snapshot() deep-clones jobs/nodes/queues for the session
  (cache.go:535-585).

The default write side is the store itself (the in-process stand-in for
the API server): Bind writes ``pod.node_name`` back through
``store.update_pod`` — which re-enters the cache as an update event and
flips the task Binding->Bound, exactly how a kubelet-confirmed bind
round-trips through the watch stream in the reference.

The write side's fault points (faults/): ``bind.write`` and
``evict.write`` reject a store write, which ``_write_with_retry`` retries
in place (``KBT_WRITE_RETRIES``, default 2, each retry counted in
``write_retries_total{op}``) before the errTasks resync takes it;
``bind.slow`` stalls each bind attempt 50 ms. A task whose resync keeps
failing is dropped after ``KBT_RESYNC_MAX_RETRIES`` (default 15) attempts
and counted in ``resync_dropped_total``.

Every informer event feeds the encode cache's dirty feed
(``ops/encode_cache.note_store_event``) after the mirror mutex is
released, so a warm encode never reuses a churned object's rows.

Crash consistency (recovery/): with a ``WriteIntentJournal`` attached
(``journal=``), every bind and evict appends an intent record before its
store write is submitted to the kb-write pool (``bind_many``: one append
for the whole bulk statement, under the ``journal.append`` span of the
``dispatch`` span, each record carrying the cycle id and the cycle's
trace id) and confirms it after the write acks. An intent whose write
falls to the errTasks resync stays unconfirmed, for the next takeover's
reconciliation. An append failure (I/O, the ``journal.append`` point)
dispatches the batch unjournaled, counted in
``journal_records_total{state="append_failed"}`` and logged.

Federation (``conditional_binds=``, on by default when ``KBT_FEDERATION``
is set): bulk binds and evicts go out as conditional (versioned) store
transactions, one per gang, each carrying the store version the last
``snapshot()`` solved over. With ``KBT_TXN_COALESCE`` on (the default) and
a store that offers ``submit_txn`` (``cache/backend.py`` over wire v2),
every gang of one dispatch rides one round trip. A loser retries with a
fresh version up to ``KBT_CONFLICT_MAX_RETRIES`` (default 3) times, then
accepts store truth: its intents are confirmed and its tasks resync.
``_pod_filter`` is the hook ``federation.FederatedCache`` overrides to keep
one shard's pending pods (with its own ``_has_task`` dedupe guard).

Streaming and pipelined cycles: ``clone_jobs_for_stream`` and
``clone_queues_for_stream`` give a micro-cycle (streaming.py) its
restricted world with ``snapshot()``'s filters, and ``submit_dispatch``
runs a pipelined cycle's deferred post-solve closure (pipeline.py) on the
kb-write pool, or inline when the pool is not started.

With ``KBT_EXPLAIN`` on, each journaled intent carries its gang's
compact explain payload (obs/explain.py ``intent_payload``), published by
the allocate action before its dispatch reaches the journal.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from kube_batch_tpu_torch import faults, log as pkg_log, metrics, obs
from kube_batch_tpu_torch.api.cluster_info import ClusterInfo
from kube_batch_tpu_torch.api.job_info import JobInfo, TaskInfo, job_key, pod_key
from kube_batch_tpu_torch.api.node_info import NodeInfo
from kube_batch_tpu_torch.api.queue_info import QueueInfo
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.apis.types import (
    Node,
    Pod,
    PodCondition,
    PodDisruptionBudget,
    PodGroup,
    PodGroupPhase,
    PodGroupSpec,
    PodPhase,
    PriorityClass,
    Queue,
    ObjectMeta,
)
from kube_batch_tpu_torch.cache.store import (
    NODES,
    PDBS,
    POD_GROUPS,
    PODS,
    PRIORITY_CLASSES,
    PVCS,
    PVS,
    QUEUES,
    STORAGE_CLASSES,
    ClusterStore,
    EventHandler,
    StaleWrite,
    obj_key,
)
from kube_batch_tpu_torch.ops import encode_cache as _encode_cache
from kube_batch_tpu_torch.utils.locking import assume_locked
from kube_batch_tpu_torch.utils.workqueue import RateLimitingQueue

log = logging.getLogger(__name__)


def _notify_encode_cache(kind: str, key: str, obj=None, old=None) -> None:
    """Dirty-feed hook for the incremental encoder
    (ops/encode_cache.py): every informer event bumps the monotonic
    store version and drops the churned object's memo entries; the same
    feed fans out ``(kind, key, obj, old)`` to its listeners. Called
    AFTER releasing the mirror mutex (listeners may take their own
    locks)."""
    _encode_cache.note_store_event(kind, key, obj=obj, old=old)

SHADOW_POD_GROUP_KEY = "kube-batch-tpu/shadow-pod-group"


def shadow_pod_group(pg: Optional[PodGroup]) -> bool:
    """reference cache/util.go:33-41."""
    if pg is None:
        return True
    return SHADOW_POD_GROUP_KEY in pg.metadata.annotations


def create_shadow_pod_group(pod: Pod) -> PodGroup:
    """Single-member gang for a pod with no PodGroup
    (reference cache/util.go:43-60). Job identity follows the pod's
    controller when it has one, so sibling pods of one controller share
    a shadow group. Phase starts Inqueue: the Go zero-value phase (\"\")
    passes allocate's Pending gate (allocate.go:52); our dataclass
    default is Pending, so the equivalent pass-through is explicit."""
    jid = pod.metadata.owner_job or pod.metadata.uid
    pg = PodGroup(
        metadata=ObjectMeta(
            name=str(jid),
            namespace=pod.namespace,
            uid=f"shadow-{jid}",
            annotations={SHADOW_POD_GROUP_KEY: str(jid)},
        ),
        spec=PodGroupSpec(min_member=1),
    )
    pg.status.phase = PodGroupPhase.INQUEUE
    return pg


def _is_terminated(status: TaskStatus) -> bool:
    """reference event_handlers.go:37-39."""
    return status in (TaskStatus.SUCCEEDED, TaskStatus.FAILED)


def job_terminated(job: JobInfo) -> bool:
    """reference api/helpers.go:101-106 — with one divergence: a shadow
    PodGroup counts as absent. It exists only inside the cache, so no
    store delete event will ever unset it; without this, every shadow
    job would leak in ``jobs`` (and get cloned into every snapshot)
    after its pod is deleted."""
    return shadow_pod_group(job.pod_group) and job.pdb is None and not job.tasks


class StoreBinder:
    """Default Binder: writes the bind back to the store (the reference's
    defaultBinder posts a v1.Binding to the API server, cache.go:110-129).
    The store update re-enters the cache as a pod update event."""

    def __init__(self, store: ClusterStore) -> None:
        self._store = store

    def bind(self, pod: Pod, hostname: str) -> None:
        bound = dataclasses.replace(pod, node_name=hostname)
        self._store.update_pod(bound)

    def bind_many_versioned(
        self, bindings: list[tuple[str, str, str]], snapshot_version: int
    ) -> None:
        """Optimistic gang transaction: all entries commit or the store
        raises StaleWrite (federation dispatch path, one gang per call)."""
        self._store.conditional_bind_many(bindings, snapshot_version)


class StoreEvictor:
    """Default Evictor: deletes the pod from the store (the reference's
    defaultEvictor deletes it from the API server, cache.go:131-146)."""

    def __init__(self, store: ClusterStore) -> None:
        self._store = store

    def evict(self, pod: Pod) -> None:
        pkg_log.V(3).infof("Evicting pod %s/%s", pod.namespace, pod.name)
        self._store.delete_pod(pod.namespace, pod.name)

    def evict_versioned(self, pod: Pod, snapshot_version: int) -> None:
        """Optimistic evict: rejected with StaleWrite when the pod's node
        took a placement write the snapshot never saw."""
        pkg_log.V(3).infof(
            "Evicting pod %s/%s (snapshot v%d)",
            pod.namespace, pod.name, snapshot_version,
        )
        self._store.conditional_evict(pod.namespace, pod.name, snapshot_version)


class StoreStatusUpdater:
    """Default StatusUpdater (reference cache.go:149-166)."""

    def __init__(self, store: ClusterStore) -> None:
        self._store = store

    def update_pod_condition(self, pod: Pod, condition: PodCondition) -> None:
        """Write the condition through the store (the reference posts it
        to the API server) so subscribers see the update event and stale
        TaskInfo.pod references can't swallow it."""
        cur = self._store.get_pod(pod.namespace, pod.name)
        if cur is None:
            return
        conds = list(cur.conditions)
        for i, c in enumerate(conds):
            if c.type == condition.type:
                if (c.status, c.reason, c.message) == (
                    condition.status,
                    condition.reason,
                    condition.message,
                ):
                    return
                conds[i] = condition
                break
        else:
            conds.append(condition)
        self._store.update_pod(dataclasses.replace(cur, conditions=conds))

    def update_pod_group(self, pg: PodGroup) -> None:
        if self._store.get(POD_GROUPS, f"{pg.metadata.namespace}/{pg.name}") is not None:
            self._store.update_pod_group(pg)


class NoopVolumeBinder:
    """Volume hooks as structural no-ops (the reference test utils'
    FakeVolumeBinder shape, util/test_utils.go:150-163)."""

    def allocate_volumes(self, task: TaskInfo, hostname: str) -> None:
        return None

    def bind_volumes(self, task: TaskInfo) -> None:
        return None


class VolumeBindingError(Exception):
    """A pod's claims cannot be satisfied on the chosen node (assume
    time) or the assumed binding no longer holds (bind time)."""


class StoreVolumeBinder:
    """Assume-at-allocate / bind-at-dispatch volume binder over the
    in-process store — the role the reference's defaultVolumeBinder +
    upstream k8s volumebinder play (cache.go:165-189; contract
    interface.go:46-56; call sites session.go:241-260 and :298-322).

    Mirrors of PVs/PVCs/StorageClasses are fed by store subscriptions
    (the reference wires the same three informers into newSchedulerCache,
    cache.go:268-297).

    - `allocate_volumes(task, hostname)` (= AssumePodVolumes): for every
      claim the pod mounts, verify a bound claim's PV tolerates the node,
      or pick the smallest Available PV matching class/capacity/topology
      and record the assumption in-memory. Raises VolumeBindingError when
      any claim cannot be satisfied — the session leaves the task
      unallocated, like the serial loop does on AssumePodVolumes error.
    - `bind_volumes(task)` (= BindPodVolumes): write the assumed
      bindings through the store (PV.claim_ref + both phases -> Bound).
      Raises when an assumed PV was claimed or deleted meanwhile; the
      session routes that through the errTasks resync queue.

    All static binding happens at schedule time regardless of the class's
    volume_binding_mode (in-process there is no separate PV controller to
    do Immediate-mode binding earlier); the StorageClass mirror validates
    that claims name real classes. Dynamic provisioning has no in-process
    counterpart: any class with no pre-provisioned matching PV fails the
    assume, exactly like a cluster whose provisioner is down."""

    def __init__(self, store: ClusterStore) -> None:
        self._store = store
        self._lock = threading.RLock()
        self._pvs: dict[str, object] = {}
        self._pvcs: dict[str, object] = {}
        self._classes: dict[str, object] = {}
        # task uid -> {pvc_key: pv_name} assumed (not yet written)
        self._assumed: dict[str, dict[str, str]] = {}
        # pv name -> pvc_key reserved by an assumption
        self._reserved: dict[str, str] = {}
        for kind, mirror in ((PVS, self._pvs), (PVCS, self._pvcs), (STORAGE_CLASSES, self._classes)):
            store.add_event_handler(
                kind,
                EventHandler(
                    on_add=lambda obj, m=mirror, k=kind: self._upsert(m, k, obj),
                    on_update=lambda old, new, m=mirror, k=kind: self._upsert(m, k, new),
                    on_delete=lambda obj, m=mirror, k=kind: self._remove(m, k, obj),
                ),
            )

    def _key(self, kind: str, obj) -> str:
        return obj_key(kind, obj)

    def _upsert(self, mirror: dict, kind: str, obj) -> None:
        with self._lock:
            mirror[self._key(kind, obj)] = obj

    def _remove(self, mirror: dict, kind: str, obj) -> None:
        with self._lock:
            mirror.pop(self._key(kind, obj), None)

    # -- assume (AssumePodVolumes, session.go:241-260) ---------------------

    def allocate_volumes(self, task: TaskInfo, hostname: str) -> None:
        claims = getattr(task.pod, "volumes", None)
        if not claims:
            task.volume_ready = True
            return
        node = self._store.get(NODES, hostname)
        node_labels = node.metadata.labels if node is not None else {}
        with self._lock:
            assumed: dict[str, str] = {}
            all_bound = True
            for claim in claims:
                pvc_key = f"{task.namespace}/{claim}"
                pvc = self._pvcs.get(pvc_key)
                if pvc is None:
                    raise VolumeBindingError(
                        f"pod <{task.namespace}/{task.name}> mounts unknown "
                        f"claim <{pvc_key}>"
                    )
                if (
                    pvc.storage_class_name
                    and pvc.storage_class_name not in self._classes
                ):
                    raise VolumeBindingError(
                        f"claim <{pvc_key}> names unknown storage class "
                        f"<{pvc.storage_class_name}>"
                    )
                if pvc.volume_name:
                    pv = self._pvs.get(pvc.volume_name)
                    if pv is None:
                        raise VolumeBindingError(
                            f"claim <{pvc_key}> bound to missing volume "
                            f"<{pvc.volume_name}>"
                        )
                    if not self._pv_fits_node(pv, node_labels):
                        raise VolumeBindingError(
                            f"volume <{pv.name}> of claim <{pvc_key}> does "
                            f"not tolerate node <{hostname}>"
                        )
                    continue
                pv = self._find_best_pv(
                    pvc, pvc_key, node_labels, exclude=set(assumed.values())
                )
                if pv is None:
                    raise VolumeBindingError(
                        f"no persistent volume satisfies claim <{pvc_key}> "
                        f"on node <{hostname}>"
                    )
                assumed[pvc_key] = pv.name
                all_bound = False
            # commit assumptions only when every claim succeeded
            for pvc_key, pv_name in assumed.items():
                self._reserved[pv_name] = pvc_key
            if assumed:
                self._assumed.setdefault(task.uid, {}).update(assumed)
            task.volume_ready = all_bound

    @assume_locked
    def _find_best_pv(self, pvc, pvc_key: str, node_labels: dict, exclude=frozenset()):
        """Smallest Available PV matching class/capacity/topology, not
        reserved by another assumption nor picked for a sibling claim of
        the same pod (`exclude`) — k8s findBestMatchPVForClaim."""
        from kube_batch_tpu_torch.apis.types import VolumePhase

        best = None
        for pv in self._pvs.values():
            if pv.phase != VolumePhase.AVAILABLE or pv.claim_ref:
                continue
            if pv.name in exclude:
                continue
            reserved_for = self._reserved.get(pv.name)
            if reserved_for is not None and reserved_for != pvc_key:
                continue
            if pv.storage_class_name != pvc.storage_class_name:
                continue
            if pv.capacity_storage < pvc.request_storage:
                continue
            if not self._pv_fits_node(pv, node_labels):
                continue
            if best is None or pv.capacity_storage < best.capacity_storage:
                best = pv
        return best

    @staticmethod
    def _pv_fits_node(pv, node_labels: dict) -> bool:
        if not pv.node_affinity:
            return True
        return any(term.matches(node_labels) for term in pv.node_affinity)

    # -- bind (BindPodVolumes, session.go:298-322) -------------------------

    def bind_volumes(self, task: TaskInfo) -> None:
        from kube_batch_tpu_torch.apis.types import VolumePhase

        with self._lock:
            # Read, don't pop: a failed bind must keep the assumption
            # record (and its reservations), or a retry would vacuously
            # succeed and bind the pod without its volumes. Successful
            # writes are idempotent on retry (claim_ref == pvc_key
            # passes the conflict check), so partial failure is safe.
            assumed = dict(self._assumed.get(task.uid, {}))
        for pvc_key, pv_name in assumed.items():
            pv = self._store.get(PVS, pv_name)
            pvc = self._store.get(PVCS, pvc_key)
            if pv is None or pvc is None:
                raise VolumeBindingError(
                    f"assumed volume <{pv_name}> or claim <{pvc_key}> "
                    "vanished before bind"
                )
            if pv.claim_ref and pv.claim_ref != pvc_key:
                raise VolumeBindingError(
                    f"assumed volume <{pv_name}> was claimed by "
                    f"<{pv.claim_ref}>"
                )
            self._store.update_persistent_volume(
                dataclasses.replace(pv, claim_ref=pvc_key, phase=VolumePhase.BOUND)
            )
            self._store.update_persistent_volume_claim(
                dataclasses.replace(
                    pvc, volume_name=pv_name, phase=VolumePhase.BOUND
                )
            )
        task.volume_ready = True
        with self._lock:
            # Re-read under the writing lock: only retire the entries we
            # actually bound — a concurrent assume may have added more.
            rec = self._assumed.get(task.uid)
            if rec is not None:
                for pvc_key in assumed:
                    rec.pop(pvc_key, None)
                if not rec:
                    self._assumed.pop(task.uid, None)
            for pv_name in assumed.values():
                self._reserved.pop(pv_name, None)

    # -- rollback (a failed/abandoned assumption must free the PVs) --------

    def forget(self, task_uid: str) -> None:
        with self._lock:
            for pv_name in self._assumed.pop(task_uid, {}).values():
                self._reserved.pop(pv_name, None)

    def reset(self) -> None:
        """Drop every outstanding assumption. Called at snapshot time:
        assume/bind both happen synchronously within one session, so
        anything still assumed when a new session starts belongs to a
        gang that never dispatched — its PVs must come back.

        Within a cycle, an unready gang's reservations deliberately
        persist: the reference keeps an Allocated-but-not-ready gang's
        *node* resources held for the rest of the cycle too (the task
        stays Allocated on its NodeInfo until the session ends,
        session.go:241-296) — volumes follow the same lifetime so a
        later job cannot take a PV out from under a gang that might
        still complete this cycle."""
        with self._lock:
            self._assumed.clear()
            self._reserved.clear()


class SchedulerCache:
    """The L2 cache (reference cache/cache.go:72-108)."""

    def __init__(
        self,
        store: ClusterStore,
        scheduler_name: str = "kube-batch-tpu",
        default_queue: str = "default",
        binder=None,
        evictor=None,
        status_updater=None,
        volume_binder=None,
        journal=None,
        staleness_fn=None,
        conditional_binds: Optional[bool] = None,
    ) -> None:
        self._mutex = threading.RLock()
        self.store = store
        self.scheduler_name = scheduler_name
        self.default_queue = default_queue
        # Crash consistency (recovery/): when a WriteIntentJournal is
        # attached, every bind/evict appends an intent BEFORE its store
        # write dispatches and confirms AFTER the write acks, so a
        # takeover can reconcile the in-flight set instead of guessing.
        self.journal = journal
        # Scheduling cycle id, stamped into journal records; the
        # scheduler loop advances it each run_once (the cycle span's
        # ``cycle`` attribute).
        self.cycle = 0
        # Bounded-staleness hook: a watch-fed deployment wires the
        # watcher's snapshot_age here; the in-process store is
        # synchronously consistent (age 0).
        self._staleness_fn = staleness_fn

        self.jobs: dict[str, JobInfo] = {}
        self.nodes: dict[str, NodeInfo] = {}
        self.queues: dict[str, QueueInfo] = {}
        self.priority_classes: dict[str, PriorityClass] = {}
        self._default_priority_class: Optional[PriorityClass] = None
        self._default_priority = 0

        self.binder = binder or StoreBinder(store)
        self.evictor = evictor or StoreEvictor(store)
        self.status_updater = status_updater or StoreStatusUpdater(store)
        self.volume_binder = volume_binder or StoreVolumeBinder(store)

        self._err_tasks = RateLimitingQueue(key_fn=lambda t: t.uid)
        self._deleted_jobs = RateLimitingQueue(key_fn=lambda j: j.uid)
        # Transient write-side failures retry in place (with jitter)
        # before the heavier errTasks resync path; see _write_with_retry.
        try:
            self._write_retries = max(0, int(os.environ.get("KBT_WRITE_RETRIES", "2")))
        except ValueError:
            log.error(
                "KBT_WRITE_RETRIES=%r is not an integer; using 2",
                os.environ.get("KBT_WRITE_RETRIES"),
            )
            self._write_retries = 2
        # errTasks terminal drop: a permanently-rejected write must not
        # ride the resync queue forever (see _process_resync_task).
        try:
            self._resync_max_retries = max(
                1, int(os.environ.get("KBT_RESYNC_MAX_RETRIES", "15"))
            )
        except ValueError:
            log.error(
                "KBT_RESYNC_MAX_RETRIES=%r is not an integer; using 15",
                os.environ.get("KBT_RESYNC_MAX_RETRIES"),
            )
            self._resync_max_retries = 15
        # Omega-style optimistic dispatch (federation): bulk binds and
        # evicts go through the store's conditional transactions, one
        # gang per transaction, carrying the snapshot's store version.
        # A StaleWrite loser refreshes its version and retries up to
        # KBT_CONFLICT_MAX_RETRIES times with jittered backoff; a
        # terminal loser accepts store truth (confirm the intent, resync
        # the gang's tasks). On by default when KBT_FEDERATION is set;
        # federation.py passes conditional_binds=True explicitly.
        if conditional_binds is None:
            conditional_binds = bool(os.environ.get("KBT_FEDERATION", ""))
        self._conditional_binds = conditional_binds
        try:
            self._conflict_max_retries = max(
                0, int(os.environ.get("KBT_CONFLICT_MAX_RETRIES", "3"))
            )
        except ValueError:
            log.error(
                "KBT_CONFLICT_MAX_RETRIES=%r is not an integer; using 3",
                os.environ.get("KBT_CONFLICT_MAX_RETRIES"),
            )
            self._conflict_max_retries = 3
        # Coalesced conditional writes (wire protocol v2): every gang
        # dispatched by one cycle rides ONE /backend/v1/txn round trip
        # (all-or-nothing per gang, per-txn conflict results) when the
        # negotiated backend supports it. Off -> per-gang round trips.
        self._txn_coalesce = os.environ.get(
            "KBT_TXN_COALESCE", "1"
        ).lower() not in ("", "0", "false")
        # Store version this cache's latest snapshot solved over — the
        # version every conditional dispatch carries (#: guarded_by _mutex
        # for writes; dispatch reads the int atomically).
        self._snapshot_version = 0
        self._writer: Optional[ThreadPoolExecutor] = None
        self._workers: list[threading.Thread] = []
        self._stop = threading.Event()
        self._synced = False

        self._subscribe()

    # -- informer wiring (reference cache.go:233-301) ----------------------

    def _pod_filter(self, pod: Pod) -> bool:
        """Only this scheduler's pending pods, plus every non-pending pod
        (they hold node resources no matter who scheduled them)."""
        if pod.scheduler_name == self.scheduler_name and pod.phase == PodPhase.PENDING:
            return True
        return pod.phase != PodPhase.PENDING

    def _subscribe(self) -> None:
        s = self.store
        s.add_event_handler(
            PODS,
            EventHandler(
                on_add=self.add_pod,
                on_update=self.update_pod,
                on_delete=self.delete_pod,
                filter=self._pod_filter,
            ),
        )
        s.add_event_handler(
            NODES,
            EventHandler(
                on_add=self.add_node,
                on_update=self.update_node,
                on_delete=self.delete_node,
            ),
        )
        s.add_event_handler(
            POD_GROUPS,
            EventHandler(
                on_add=self.add_pod_group,
                on_update=self.update_pod_group,
                on_delete=self.delete_pod_group,
            ),
        )
        s.add_event_handler(
            QUEUES,
            EventHandler(
                on_add=self.add_queue,
                on_update=self.update_queue,
                on_delete=self.delete_queue,
            ),
        )
        s.add_event_handler(
            PDBS,
            EventHandler(
                on_add=self.add_pdb,
                on_update=self.update_pdb,
                on_delete=self.delete_pdb,
            ),
        )
        s.add_event_handler(
            PRIORITY_CLASSES,
            EventHandler(
                on_add=self.add_priority_class,
                on_update=self.update_priority_class,
                on_delete=self.delete_priority_class,
            ),
        )
        self._synced = True

    def run(self) -> None:
        """Start the resync + GC workers and the async write pool
        (reference cache.go:304-325)."""
        if self._writer is not None:
            return
        self._stop.clear()
        self._err_tasks.restart()
        self._deleted_jobs.restart()
        self._writer = ThreadPoolExecutor(max_workers=8, thread_name_prefix="kb-write")
        for name, fn in (
            ("kb-resync", self._process_resync_task),
            ("kb-gc", self._process_cleanup_job),
        ):
            t = threading.Thread(target=self._worker, args=(fn,), name=name, daemon=True)
            t.start()
            self._workers.append(t)

    def stop(self) -> None:
        self._stop.set()
        self._err_tasks.shut_down()
        self._deleted_jobs.shut_down()
        if self._writer is not None:
            self._writer.shutdown(wait=True)
            self._writer = None
        for t in self._workers:
            t.join(timeout=5)
        self._workers.clear()

    def wait_for_cache_sync(self) -> bool:
        """The store replays existing objects at subscription, so the
        mirror is synchronously warm (reference cache.go:327-348)."""
        return self._synced

    def snapshot_age(self) -> float:
        """Seconds the mirror may lag the source of truth — 0 for the
        in-process store (synchronous event dispatch); a watch-fed
        deployment wires its watcher's snapshot_age via staleness_fn.
        The scheduler's refuse-to-schedule guard (KBT_MAX_SNAPSHOT_AGE_S)
        reads this every cycle."""
        if self._staleness_fn is not None:
            return float(self._staleness_fn())
        return 0.0

    def _worker(self, fn) -> None:
        while not self._stop.is_set():
            fn()

    # -- job/task primitives (reference event_handlers.go:43-180) ----------

    @assume_locked
    def _get_or_create_job(self, ti: TaskInfo) -> Optional[JobInfo]:
        if not ti.job:
            if ti.pod.scheduler_name != self.scheduler_name:
                pkg_log.V(4).infof(
                    "Pod %s/%s not scheduled by %s, skip shadow PodGroup",
                    ti.namespace, ti.name, self.scheduler_name,
                )
                return None
            pg = create_shadow_pod_group(ti.pod)
            ti.job = job_key(pg.metadata.namespace, pg.name)
            if ti.job not in self.jobs:
                job = JobInfo(ti.job)
                job.set_pod_group(pg)
                job.queue = self.default_queue
                self.jobs[ti.job] = job
        elif ti.job not in self.jobs:
            self.jobs[ti.job] = JobInfo(ti.job)
        return self.jobs[ti.job]

    @assume_locked
    def _add_task(self, ti: TaskInfo) -> None:
        job = self._get_or_create_job(ti)
        if job is not None:
            job.add_task_info(ti)
        if ti.node_name:
            if ti.node_name not in self.nodes:
                self.nodes[ti.node_name] = NodeInfo(None)
            if not _is_terminated(ti.status):
                # overcommit=True: this is the watch-event path — the
                # store already committed the bind. A cross-shard bind
                # race can oversubscribe a node; the mirror records the
                # negative idle (node reads unfit) instead of raising
                # out of the pump thread.
                self.nodes[ti.node_name].add_task(ti, overcommit=True)

    @assume_locked
    def _add_pod(self, pod: Pod) -> None:
        self._add_task(TaskInfo(pod))

    @assume_locked
    def _delete_task(self, ti: TaskInfo) -> None:
        job_err = node_err = None
        if ti.job:
            job = self.jobs.get(ti.job)
            if job is not None:
                try:
                    job.delete_task_info(ti)
                except KeyError as e:
                    job_err = e
            else:
                job_err = KeyError(f"job {ti.job} not found for task {ti.namespace}/{ti.name}")
        if ti.node_name:
            node = self.nodes.get(ti.node_name)
            # Terminated tasks were never added to the node (_add_task
            # guards with _is_terminated), so only remove what is
            # actually resident — otherwise every delete/update of a
            # Succeeded/Failed pod raises and strands the task.
            if node is not None and pod_key(ti.pod) in node.tasks:
                try:
                    node.remove_task(ti)
                except KeyError as e:
                    node_err = e
        if job_err or node_err:
            raise KeyError(f"{job_err or ''}; {node_err or ''}")

    @assume_locked
    def _update_task(self, old: TaskInfo, new: TaskInfo) -> None:
        self._delete_task(old)
        self._add_task(new)

    def _resolve_shadow_job(self, pi: TaskInfo) -> None:
        """Recompute the shadow job id for a podgroup-less pod of this
        scheduler, so delete/update events find the job that
        ``_get_or_create_job`` filed the task under. (The reference
        recomputes only from the annotation, event_handlers.go:160-180,
        which strands shadow-job members on delete — fixed here.)"""
        if not pi.job and pi.pod.scheduler_name == self.scheduler_name:
            pi.job = job_key(
                pi.pod.namespace, pi.pod.metadata.owner_job or pi.pod.metadata.uid
            )

    @assume_locked
    def _delete_pod(self, pod: Pod) -> None:
        pi = TaskInfo(pod)
        self._resolve_shadow_job(pi)
        # Prefer the cached task: it carries Binding/Bound state the bare
        # pod does not (reference event_handlers.go:160-172).
        task = pi
        job = self.jobs.get(pi.job)
        if job is not None and pi.uid in job.tasks:
            task = job.tasks[pi.uid]
        self._delete_task(task)
        job = self.jobs.get(pi.job)
        if job is not None and job_terminated(job):
            self._delete_job(job)

    def _sync_task(self, old_task: TaskInfo) -> None:
        """Re-fetch the pod and reconcile (reference event_handlers.go:97-115)."""
        with self._mutex:
            pod = self.store.get_pod(old_task.namespace, old_task.name)
            if pod is None:
                self._delete_task(old_task)
                pkg_log.V(3).infof(
                    "Pod %s/%s was deleted, removed from cache",
                    old_task.namespace, old_task.name,
                )
                return
            self._update_task(old_task, TaskInfo(pod))

    # -- public pod handlers -----------------------------------------------

    def add_pod(self, pod: Pod) -> None:
        with self._mutex:
            try:
                self._add_pod(pod)
            except KeyError as e:
                log.error("Failed to add pod %s/%s to cache: %s", pod.namespace, pod.name, e)
                return
        _notify_encode_cache(PODS, pod.metadata.uid, obj=pod)
        pkg_log.V(3).infof("Added pod <%s/%s> to cache", pod.namespace, pod.name)

    def update_pod(self, old: Pod, new: Pod) -> None:
        with self._mutex:
            try:
                self._delete_pod(old)
                self._add_pod(new)
            except KeyError as e:
                log.error("Failed to update pod %s/%s in cache: %s", new.namespace, new.name, e)
                return
        _notify_encode_cache(PODS, new.metadata.uid, obj=new, old=old)
        pkg_log.V(3).infof("Updated pod <%s/%s> in cache", new.namespace, new.name)

    def delete_pod(self, pod: Pod) -> None:
        with self._mutex:
            try:
                self._delete_pod(pod)
            except KeyError as e:
                log.error("Failed to delete pod %s/%s from cache: %s", pod.namespace, pod.name, e)
                return
        _notify_encode_cache(PODS, pod.metadata.uid, old=pod)
        pkg_log.V(3).infof("Deleted pod <%s/%s> from cache", pod.namespace, pod.name)

    # -- node handlers (reference event_handlers.go:262-370) ---------------

    def add_node(self, node: Node) -> None:
        with self._mutex:
            if node.name in self.nodes:
                self.nodes[node.name].set_node(node)
            else:
                self.nodes[node.name] = NodeInfo(node)
        _notify_encode_cache(NODES, node.name, obj=node)

    def update_node(self, old: Node, new: Node) -> None:
        with self._mutex:
            ni = self.nodes.get(new.name)
            if ni is None:
                log.error("Failed to update node %s: does not exist in cache", new.name)
                return
            if (
                old.allocatable != new.allocatable
                or old.capacity != new.capacity
                or old.taints != new.taints
                or old.metadata.labels != new.metadata.labels
                or old.unschedulable != new.unschedulable
                or old.conditions != new.conditions
            ):
                ni.set_node(new)
                changed = True
            else:
                changed = False
        if changed:
            _notify_encode_cache(NODES, new.name, obj=new, old=old)

    def delete_node(self, node: Node) -> None:
        with self._mutex:
            if node.name not in self.nodes:
                log.error("Failed to delete node %s: does not exist in cache", node.name)
                return
            del self.nodes[node.name]
        _notify_encode_cache(NODES, node.name, old=node)

    # -- podgroup handlers (reference event_handlers.go:372-493) -----------

    @assume_locked
    def _set_pod_group(self, pg: PodGroup) -> None:
        jid = job_key(pg.metadata.namespace, pg.name)
        if jid not in self.jobs:
            self.jobs[jid] = JobInfo(jid)
        self.jobs[jid].set_pod_group(pg)
        if not pg.spec.queue:
            self.jobs[jid].queue = self.default_queue

    def add_pod_group(self, pg: PodGroup) -> None:
        with self._mutex:
            self._set_pod_group(pg)
        _notify_encode_cache(
            POD_GROUPS, f"{pg.metadata.namespace}/{pg.name}", obj=pg
        )
        pkg_log.V(4).infof("Added PodGroup <%s/%s> to cache", pg.metadata.namespace, pg.name)

    def update_pod_group(self, old: PodGroup, new: PodGroup) -> None:
        with self._mutex:
            self._set_pod_group(new)
        _notify_encode_cache(
            POD_GROUPS, f"{new.metadata.namespace}/{new.name}", obj=new, old=old
        )

    def delete_pod_group(self, pg: PodGroup) -> None:
        with self._mutex:
            jid = job_key(pg.metadata.namespace, pg.name)
            job = self.jobs.get(jid)
            if job is None:
                log.error("Failed to delete PodGroup %s: job not found", jid)
                return
            job.unset_pod_group()
            self._delete_job(job)
        _notify_encode_cache(POD_GROUPS, f"{pg.metadata.namespace}/{pg.name}", old=pg)

    # -- pdb handlers (reference event_handlers.go:494-604) ----------------

    def add_pdb(self, pdb: PodDisruptionBudget) -> None:
        with self._mutex:
            self._set_pdb(pdb)

    def update_pdb(self, old: PodDisruptionBudget, new: PodDisruptionBudget) -> None:
        with self._mutex:
            self._set_pdb(new)

    def delete_pdb(self, pdb: PodDisruptionBudget) -> None:
        with self._mutex:
            jid = pdb.metadata.owner_job or f"{pdb.metadata.namespace}/{pdb.name}"
            job = self.jobs.get(jid)
            if job is None:
                log.error("Failed to delete PDB %s: job not found", jid)
                return
            job.unset_pdb()
            self._delete_job(job)

    @assume_locked
    def _set_pdb(self, pdb: PodDisruptionBudget) -> None:
        jid = pdb.metadata.owner_job or f"{pdb.metadata.namespace}/{pdb.name}"
        if jid not in self.jobs:
            self.jobs[jid] = JobInfo(jid)
        self.jobs[jid].set_pdb(pdb)
        # PDBs predate queues; they land in the default queue — unless a
        # PodGroup already assigned one (don't stomp it).
        if not self.jobs[jid].queue:
            self.jobs[jid].queue = self.default_queue

    # -- queue handlers (reference event_handlers.go:607-699) --------------

    def add_queue(self, q: Queue) -> None:
        with self._mutex:
            qi = QueueInfo(q)
            self.queues[qi.name] = qi
        _notify_encode_cache(QUEUES, q.name, obj=q)

    def update_queue(self, old: Queue, new: Queue) -> None:
        with self._mutex:
            self.queues.pop(old.name, None)
            self.queues[new.name] = QueueInfo(new)
        _notify_encode_cache(QUEUES, new.name, obj=new, old=old)

    def delete_queue(self, q: Queue) -> None:
        with self._mutex:
            self.queues.pop(q.name, None)
        _notify_encode_cache(QUEUES, q.name, old=q)

    # -- priorityclass handlers (reference event_handlers.go:701-795) ------

    def add_priority_class(self, pc: PriorityClass) -> None:
        with self._mutex:
            self._add_priority_class(pc)

    def update_priority_class(self, old: PriorityClass, new: PriorityClass) -> None:
        with self._mutex:
            self._delete_priority_class(old)
            self._add_priority_class(new)

    def delete_priority_class(self, pc: PriorityClass) -> None:
        with self._mutex:
            self._delete_priority_class(pc)

    @assume_locked
    def _add_priority_class(self, pc: PriorityClass) -> None:
        if pc.global_default:
            if self._default_priority_class is not None:
                log.error(
                    "Updated default priority class from <%s> to <%s> forcefully",
                    self._default_priority_class.name, pc.name,
                )
            self._default_priority_class = pc
            self._default_priority = pc.value
        self.priority_classes[pc.name] = pc

    @assume_locked
    def _delete_priority_class(self, pc: PriorityClass) -> None:
        if pc.global_default:
            self._default_priority_class = None
            self._default_priority = 0
        self.priority_classes.pop(pc.name, None)

    # -- write side (reference cache.go:369-448) ---------------------------

    @assume_locked
    def _find_job_and_task(self, ti: TaskInfo) -> tuple[JobInfo, TaskInfo]:
        job = self.jobs.get(ti.job)
        if job is None:
            raise KeyError(f"failed to find job {ti.job} for task {ti.uid}")
        task = job.tasks.get(ti.uid)
        if task is None:
            raise KeyError(f"failed to find task {ti.uid} in status {ti.status}")
        return job, task

    # -- write-intent journal hooks (recovery/journal.py) ------------------

    def _journal_intents(self, op: str, entries: list) -> list:
        """Append-before-dispatch; a journal failure degrades to an
        unjournaled dispatch, loudly — availability over protection."""
        if self.journal is None or not entries:
            return [None] * len(entries)
        try:
            # span link both ways: the append is a child span of the
            # dispatching cycle, and the journal records carry the trace
            # id so a takeover's reconciliation can name the trace that
            # wrote each intent it re-litigates
            cur = obs.current()
            # explain payloads (obs/explain): the allocate action publishes
            # per-gang forensics into the process registry before its
            # dispatch reaches here, so each intent can carry the compact
            # (verdict, reason) label of the decision it records
            explain = None
            from kube_batch_tpu_torch.obs import explain as _explain

            if _explain.enabled():
                explain = {}
                for gang in {e[0] for e in entries}:
                    payload = _explain.intent_payload(gang)
                    if payload is not None:
                        explain[gang] = payload
            with obs.span("journal.append", op=op, n=len(entries)) as jspan:
                seqs = self.journal.append_intents(
                    op, entries, cycle=self.cycle,
                    trace=cur.trace_id if cur is not None else "",
                    explain=explain,
                )
                jspan.set_attr("first_seq", seqs[0] if seqs else None)
                return seqs
        except Exception as e:  # noqa: BLE001 - disk full / injected fault
            metrics.register_journal_records("append_failed", len(entries))
            log.error(
                "journal append failed (%s); dispatching %d %s write(s) "
                "unjournaled", e, len(entries), op,
            )
            return [None] * len(entries)

    def _journal_confirm(self, seq) -> None:
        """Confirm-after-ack (no-op for unjournaled writes)."""
        if seq is None or self.journal is None:
            return
        try:
            self.journal.confirm(seq)
            obs.event("journal.confirm", seq=seq)
        except Exception as e:  # noqa: BLE001
            log.error("journal confirm of seq %s failed: %s", seq, e)

    def bind(self, ti: TaskInfo, hostname: str) -> None:
        """Mirror update now, API write async; failure resyncs
        (reference cache.go:404-448)."""
        with self._mutex:
            job, task = self._find_job_and_task(ti)
            node = self.nodes.get(hostname)
            if node is None:
                raise KeyError(f"failed to bind task {task.uid}: host {hostname} missing")
            job.update_task_status(task, TaskStatus.BINDING)
            task.node_name = hostname
            # overcommit=True: the session solved over a snapshot; the
            # live node may have drifted since. Raising here would strand
            # the task in Binding with no write submitted and no resync.
            node.add_task(task, overcommit=True)
            pod = task.pod
        seqs = self._journal_intents(
            "bind", [(task.job, f"{pod.namespace}/{pod.name}", hostname)]
        )
        self._submit_write(self._do_bind, pod, hostname, task, seqs[0])

    def bind_many(self, pairs: list, keys=None) -> None:
        """Bulk bind for the replay path: the per-bind net effect of
        `bind()` under ONE mutex acquisition and ONE async write
        submission (the reference fires a goroutine per pod,
        cache.go:439-445; a vectorized action produces 50k binds in one
        call, so the write side batches to match). `pairs` is
        [(TaskInfo, hostname)]; a pair whose job/task/host vanished from
        the mirror (concurrent delete events run under this same mutex)
        routes through errTasks instead of aborting the batch, and
        per-pod write failures still resync individually. ``keys`` is
        the replay's precomputed key hint — this binder resolves
        jobs/tasks itself, so it is accepted for protocol compatibility
        and unused. The ``dispatch`` span covers the host side: the
        resolve under the mutex, the journal append and the submission
        to the pool."""
        del keys
        with obs.span("dispatch", binds=len(pairs)):
            resolved = []
            failed = []
            with self._mutex:
                for ti, hostname in pairs:
                    try:
                        job, task = self._find_job_and_task(ti)
                        node = self.nodes.get(hostname)
                        if node is None:
                            raise KeyError(f"host {hostname} missing")
                    except KeyError as e:
                        log.error("Failed to bind task %s: %s", ti.uid, e)
                        failed.append(ti)
                        continue
                    job.update_task_status(task, TaskStatus.BINDING)
                    task.node_name = hostname
                    # overcommit=True: same as bind() — snapshot drift
                    # must not strand the task
                    node.add_task(task, overcommit=True)
                    resolved.append((task.pod, hostname, task))
            for ti in failed:
                self.resync_task(ti)
            # One journal append covers the whole bulk statement (the gang
            # ids ride per entry), flushed before the batch dispatches — a
            # leader killed mid-batch leaves exactly the unconfirmed suffix
            # for the standby's reconciliation.
            seqs = self._journal_intents(
                "bind",
                [
                    (task.job, f"{pod.namespace}/{pod.name}", hostname)
                    for pod, hostname, task in resolved
                ],
            )
            # the kb-write pool thread has no ambient contextvar context:
            # capture the current span HERE and pass it through, or the
            # async half of the bind would start a disconnected trace
            self._submit_write(
                self._do_bind_many,
                [(p, h, t, s) for (p, h, t), s in zip(resolved, seqs)],
                obs.current(),
            )

    def _do_bind_many(self, resolved: list, ctx=None) -> None:
        if self._conditional_binds and hasattr(self.binder, "bind_many_versioned"):
            # one optimistic transaction per gang: a gang commits whole
            # or loses whole, so the conflict loser re-solves a complete
            # gang instead of reconciling a half-bound one
            gangs: dict[str, list] = {}
            for entry in resolved:
                gangs.setdefault(entry[2].job, []).append(entry)
            # Coalescing (wire protocol v2): every gang this cycle
            # dispatched rides one /backend/v1/txn round trip instead of
            # one RTT per gang. Gangs stay all-or-nothing — the batch is
            # transport-level only; a conflicted gang falls back to the
            # per-gang retry ladder with a fresh version.
            supports = getattr(self.store, "supports_txn", None)
            if (
                self._txn_coalesce
                and len(gangs) > 1
                and callable(supports)
                and supports()
            ):
                self._do_bind_txn(gangs, ctx)
                return
            for gang in gangs.values():
                self._do_bind_gang(gang, ctx)
            return
        for pod, hostname, task, seq in resolved:
            self._do_bind(pod, hostname, task, seq)

    def _do_bind_txn(self, gangs: dict, ctx=None) -> None:
        """Dispatch every gang of this cycle in ONE coalesced store txn.
        Exactly-once is per gang, exactly as in the per-gang path: each
        txn carries its own snapshot version, an applied gang confirms
        its own journal seqs, a conflicted gang re-enters
        ``_do_bind_gang``'s retry ladder (which refreshes the version),
        and a transport failure mid-batch degrades LOUDLY to per-gang v1
        writes — whose conditional versions make any server-side partial
        application resolve to store truth, never a double bind."""
        order = list(gangs.values())
        txns = []
        for entries in order:
            version = self._snapshot_version
            if faults.should_fire("federation.stale_assign"):
                version = 0  # deliberately ancient: forces the conflict path
            txns.append(
                {
                    "op": "bind",
                    "bindings": [
                        [pod.namespace, pod.name, hostname]
                        for pod, hostname, _task, _seq in entries
                    ],
                    "snapshotVersion": version,
                }
            )
        pods = sum(len(e) for e in order)
        with obs.span(
            "txn.batch", parent=ctx, gangs=len(order), pods=pods
        ) as tspan:
            if faults.should_fire("store.txn_batch"):
                results = None
            else:
                try:
                    results = self.store.submit_txn(txns)
                except Exception as e:  # noqa: BLE001 - any batch failure degrades
                    log.error("coalesced txn batch failed (%s)", e)
                    results = None
            if results is None:
                tspan.set_attr("outcome", "degraded")
                log.error(
                    "degrading %d gang(s) to per-gang conditional writes",
                    len(order),
                )
                for entries in order:
                    self._do_bind_gang(entries, ctx)
                return
            conflicts = 0
            for entries, result in zip(order, results):
                if "conflict" not in result:
                    metrics.register_federation_conflict(
                        "clean", exemplar=tspan.trace_id
                    )
                    for _pod, _hostname, _task, seq in entries:
                        self._journal_confirm(seq)
                    continue
                conflicts += 1
                c = result["conflict"]
                what = f"gang <{entries[0][2].job}> ({len(entries)} pod(s))"
                for node in sorted(
                    {h for _p, h, _t, _s in entries}
                ):
                    metrics.register_federation_node_conflict(node)
                metrics.register_federation_conflict(
                    "retried", exemplar=tspan.trace_id
                )
                metrics.register_bind_retry()
                log.warning(
                    "bind of %s conflicted in coalesced txn (%s %s: %s), "
                    "re-dispatching per-gang",
                    what, c.get("kind", ""), c.get("key", ""),
                    c.get("reason", "conflict"),
                )
                self._do_bind_gang(entries, ctx)
            tspan.set_attr("outcome", "ok")
            tspan.set_attr("conflicts", conflicts)

    def _do_bind_gang(self, entries: list, ctx=None) -> None:
        """Dispatch one gang as a conditional store transaction carrying
        the snapshot version (Omega optimistic concurrency). On
        StaleWrite the loser refreshes its version and retries with
        jittered backoff; past KBT_CONFLICT_MAX_RETRIES it accepts store
        truth — the journal intents are confirmed (the conflict resolved
        them: the winning placement stands) and the gang's tasks resync
        from the store, re-solving next cycle. This is reconcile_journal's
        takeover-time "store truth wins" rule applied per cycle.

        ``ctx`` is the dispatching cycle's span, captured before the
        kb-write pool hop (bind_many) — the gang.bind span parents to it
        so a conflict's whole retry story stays on one trace."""
        bindings = [
            (pod.namespace, pod.name, hostname)
            for pod, hostname, _task, _seq in entries
        ]
        version = self._snapshot_version
        if faults.should_fire("federation.stale_assign"):
            version = 0  # deliberately ancient: forces the conflict path
        what = f"gang <{entries[0][2].job}> ({len(entries)} pod(s))"
        delay = 0.02
        conflicts = 0
        with obs.span(
            "gang.bind", parent=ctx, gang=str(entries[0][2].job), pods=len(entries),
        ) as gspan:
            while True:
                try:
                    self._write_with_retry(
                        "bind",
                        what,
                        lambda v=version: self.binder.bind_many_versioned(bindings, v),
                    )
                    gspan.set_attr("outcome", "won" if conflicts else "clean")
                    gspan.set_attr("conflicts", conflicts)
                    metrics.register_federation_conflict(
                        "won" if conflicts else "clean",
                        exemplar=gspan.trace_id,
                    )
                    for _pod, _hostname, _task, seq in entries:
                        self._journal_confirm(seq)
                    return
                except StaleWrite as e:
                    conflicts += 1
                    # per-node conflict accounting: the fleet heatmap
                    # ranks contended nodes from deltas of this counter
                    for node in sorted({h for _ns, _n, h in bindings}):
                        metrics.register_federation_node_conflict(node)
                    if conflicts > self._conflict_max_retries:
                        gspan.set_attr("outcome", "lost")
                        gspan.set_attr("conflicts", conflicts)
                        metrics.register_federation_conflict(
                            "lost", exemplar=gspan.trace_id
                        )
                        log.error(
                            "bind of %s lost the conflict after %d retr%s (%s); "
                            "accepting store truth and resyncing the gang",
                            what, conflicts - 1, "y" if conflicts == 2 else "ies", e,
                        )
                        for _pod, _hostname, task, seq in entries:
                            self._journal_confirm(seq)
                            self.resync_task(task)
                        return
                    gspan.event("conflict", retry=conflicts, error=str(e))
                    metrics.register_federation_conflict(
                        "retried", exemplar=gspan.trace_id
                    )
                    metrics.register_bind_retry()
                    log.warning(
                        "bind of %s conflicted (%s), retry %d/%d with fresh version",
                        what, e, conflicts, self._conflict_max_retries,
                    )
                    time.sleep(delay * (0.5 + random.random()))
                    delay = min(delay * 2.0, 0.5)
                    version = getattr(self.store, "version", version)
                except Exception as e:  # noqa: BLE001 - infrastructure failure
                    # unchanged rung 2: the intents stay unconfirmed, the
                    # resync path (or a takeover reconciliation) re-drives
                    gspan.set_attr("outcome", "error")
                    log.error("Failed to bind %s: %s", what, e)
                    for _pod, _hostname, task, _seq in entries:
                        self.resync_task(task)
                    return


    def _write_with_retry(self, op: str, what: str, fn) -> None:
        """Bounded in-place retry with exponential backoff + jitter for
        transient write-side failures, before the errTasks resync path
        takes over. The reference fires a goroutine per bind and routes
        any failure straight to resync (cache.go:439-448) — a full
        re-sync plus a whole scheduling cycle of latency for what is
        usually a blip; retrying the write first keeps the bind landing
        in this cycle (degradation-ladder rung 1), with resync as the
        unchanged rung 2. Fault points ``{bind,evict}.write`` (rejected
        write) and ``bind.slow`` (stalled binder) inject per attempt."""
        delay = 0.02
        attempt = 0
        while True:
            try:
                if op == "bind" and faults.should_fire("bind.slow"):
                    time.sleep(0.05)
                if faults.should_fire(f"{op}.write"):
                    raise faults.FaultInjected(f"{op}.write")
                fn()
                return
            except StaleWrite:
                # optimistic conflict, not a transient infrastructure
                # failure: re-sending the same snapshot version would
                # lose again — the caller refreshes the version first
                raise
            except Exception as e:
                attempt += 1
                if attempt > self._write_retries:
                    raise
                metrics.register_write_retry(op)
                log.warning(
                    "%s of %s failed (attempt %d/%d), retrying: %s",
                    op, what, attempt, self._write_retries + 1, e,
                )
                time.sleep(delay * (0.5 + random.random()))
                delay = min(delay * 2.0, 0.5)

    def _do_bind(self, pod: Pod, hostname: str, task: TaskInfo, seq=None) -> None:
        try:
            self._write_with_retry(
                "bind",
                f"<{pod.namespace}/{pod.name}>",
                lambda: self.binder.bind(pod, hostname),
            )
            self._journal_confirm(seq)
        except Exception as e:  # noqa: BLE001 - any write failure resyncs
            # the journal intent stays unconfirmed: either the resync
            # path lands the write later or the next takeover's
            # reconciliation re-drives it (both idempotent)
            log.error("Failed to bind pod <%s/%s>: %s", pod.namespace, pod.name, e)
            self.resync_task(task)

    def evict(self, ti: TaskInfo, reason: str) -> None:
        """reference cache.go:369-401."""
        with self._mutex:
            job, task = self._find_job_and_task(ti)
            node = self.nodes.get(task.node_name)
            if node is None:
                raise KeyError(f"failed to evict task {task.uid}: host {task.node_name} missing")
            job.update_task_status(task, TaskStatus.RELEASING)
            node.update_task(task)
            pod = task.pod
        seqs = self._journal_intents(
            "evict", [(task.job, f"{pod.namespace}/{pod.name}", "")]
        )
        self._submit_write(self._do_evict, pod, task, seqs[0])

    def _do_evict(self, pod: Pod, task: TaskInfo, seq=None) -> None:
        conditional = self._conditional_binds and hasattr(
            self.evictor, "evict_versioned"
        )
        version = self._snapshot_version
        if conditional and faults.should_fire("federation.stale_assign"):
            version = 0
        try:
            if conditional:
                self._write_with_retry(
                    "evict",
                    f"<{pod.namespace}/{pod.name}>",
                    lambda: self.evictor.evict_versioned(pod, version),
                )
            else:
                self._write_with_retry(
                    "evict",
                    f"<{pod.namespace}/{pod.name}>",
                    lambda: self.evictor.evict(pod),
                )
            self._journal_confirm(seq)
        except StaleWrite as e:
            # an evict that lost the race is moot: whatever placement won
            # invalidated the preemption plan — accept store truth now
            # (no blind retry loop; the next cycle re-solves)
            metrics.register_federation_conflict("lost")
            log.error(
                "Evict of <%s/%s> lost the conflict (%s); accepting store truth",
                pod.namespace, pod.name, e,
            )
            self._journal_confirm(seq)
            self.resync_task(task)
        except Exception as e:  # noqa: BLE001
            log.error("Failed to evict pod <%s/%s>: %s", pod.namespace, pod.name, e)
            self.resync_task(task)

    def _submit_write(self, fn, *args) -> None:
        if self._writer is not None:
            self._writer.submit(fn, *args)
        else:
            fn(*args)  # run() not started (unit tests): write inline

    def submit_dispatch(self, fn):
        """Run a deferred post-solve dispatch closure on the kb-write
        pool, returning its Future (pipeline.py rides this for
        KBT_PIPELINE cycles). Unlike `_submit_write`, the caller needs the
        Future: the dispatch fence joins it before the next cycle's
        snapshot. With the pool off (run() not started), the closure runs
        inline and the returned Future is already done: the pipelined
        path degenerates to the synchronous one."""
        from concurrent.futures import Future

        if self._writer is not None:
            return self._writer.submit(fn)
        fut: Future = Future()
        try:
            fut.set_result(fn())
        except BaseException as e:  # noqa: BLE001 - carried by the future
            fut.set_exception(e)
        return fut

    # -- resync + GC workers (reference cache.go:480-534) ------------------

    def resync_task(self, task: TaskInfo) -> None:
        self._err_tasks.add_rate_limited(task)

    def _process_resync_task(self) -> None:
        task = self._err_tasks.get(timeout=0.2)
        if task is None:
            return
        try:
            self._sync_task(task)
            self._err_tasks.forget(task)
        except Exception as e:  # noqa: BLE001
            # Per-task retry budget: a permanently-rejected write (pod
            # poisoned, store rejecting the key forever) must not ride
            # the queue forever — after the budget it drops terminally,
            # metered and narrated; the task's pod stays whatever the
            # store says it is, which a later event or takeover
            # reconciliation can still repair.
            if self._err_tasks.failures(task) >= self._resync_max_retries:
                metrics.register_resync_drop()
                log.error(
                    "Giving up on resync of pod <%s/%s> after %d attempts "
                    "(terminal drop): %s",
                    task.namespace, task.name, self._resync_max_retries, e,
                )
                self._err_tasks.forget(task)
            else:
                log.error(
                    "Failed to sync pod <%s/%s>, retry: %s",
                    task.namespace, task.name, e,
                )
                self._err_tasks.add_rate_limited(task)
        finally:
            self._err_tasks.done(task)

    def _delete_job(self, job: JobInfo) -> None:
        pkg_log.V(3).infof("Try to delete job <%s>", job.uid)
        self._deleted_jobs.add_rate_limited(job)

    def _process_cleanup_job(self) -> None:
        job = self._deleted_jobs.get(timeout=0.2)
        if job is None:
            return
        try:
            with self._mutex:
                if job_terminated(job):
                    self.jobs.pop(job.uid, None)
                    self._deleted_jobs.forget(job)
                    pkg_log.V(3).infof("Job <%s> deleted from cache", job.uid)
                else:
                    self._deleted_jobs.add_rate_limited(job)
        finally:
            self._deleted_jobs.done(job)

    # -- snapshot (reference cache.go:535-585) -----------------------------

    def snapshot(self) -> ClusterInfo:
        reset = getattr(self.volume_binder, "reset", None)
        if reset is not None:
            reset()  # assumptions never outlive a session (see reset())
        with self._mutex:
            snapshot = ClusterInfo()
            # Stamp the store version this snapshot solves over — every
            # conditional dispatch until the next snapshot carries it.
            self._snapshot_version = getattr(self.store, "version", 0)
            for name, node in self.nodes.items():
                snapshot.nodes[name] = node.clone()
            for name, q in self.queues.items():
                snapshot.queues[name] = q.clone()
            for uid, job in self.jobs.items():
                if job.pod_group is None and job.pdb is None:
                    pkg_log.V(4).infof("Job <%s> has no scheduling spec, ignored", uid)
                    continue
                if job.queue not in snapshot.queues:
                    pkg_log.V(3).infof(
                        "Queue <%s> of job <%s/%s> does not exist, ignored",
                        job.queue, job.namespace, job.name,
                    )
                    continue
                if job.pod_group is not None:
                    job.priority = self._default_priority
                    pc = self.priority_classes.get(job.pod_group.spec.priority_class_name)
                    if pc is not None:
                        job.priority = pc.value
                snapshot.jobs[uid] = job.clone()
            pkg_log.V(3).infof(
                "Snapshot: %d jobs, %d queues, %d nodes",
                len(snapshot.jobs), len(snapshot.queues), len(snapshot.nodes),
            )
            return snapshot

    def clone_jobs_for_stream(self, job_keys) -> tuple[dict[str, JobInfo], set[str]]:
        """Fresh clones of just the named jobs, with exactly snapshot()'s
        admission filters and priority resolution: the streaming
        micro-cycle's restricted job view (streaming.py). Returns
        ``(jobs, missing)``: keys the mirror does not track at all land
        in ``missing`` (the gang is gone: prune it from the backlog);
        jobs that merely fail an admission filter are omitted from both
        (not schedulable this micro-cycle; the full cycle decides)."""
        with self._mutex:
            out: dict[str, JobInfo] = {}
            missing: set[str] = set()
            for uid in job_keys:
                job = self.jobs.get(uid)
                if job is None:
                    missing.add(uid)
                    continue
                if job.pod_group is None and job.pdb is None:
                    continue
                if job.queue not in self.queues:
                    continue
                if job.pod_group is not None:
                    job.priority = self._default_priority
                    pc = self.priority_classes.get(job.pod_group.spec.priority_class_name)
                    if pc is not None:
                        job.priority = pc.value
                out[uid] = job.clone()
            return out, missing

    def clone_queues_for_stream(self) -> dict[str, QueueInfo]:
        """All queues, cloned under the mutex (snapshot()'s queue leg)."""
        with self._mutex:
            return {name: q.clone() for name, q in self.queues.items()}

    # -- status write-back (reference cache.go:621-666) --------------------

    def _task_unschedulable(self, task: TaskInfo, message: str) -> None:
        self.status_updater.update_pod_condition(
            task.pod,
            PodCondition(
                type="PodScheduled",
                status="False",
                reason="Unschedulable",
                message=message,
            ),
        )

    def record_job_status_event(self, job: JobInfo) -> None:
        job_err_msg = job.fit_error()
        for status in (TaskStatus.ALLOCATED, TaskStatus.PENDING):
            # list(): the condition write can re-enter as a pod update
            # event and re-index this very job when ``job`` is the live
            # mirror object rather than a snapshot clone.
            for task in list(job.task_status_index.get(status, {}).values()):
                try:
                    self._task_unschedulable(task, job_err_msg)
                except Exception as e:  # noqa: BLE001
                    log.error(
                        "Failed to update unschedulable task status <%s/%s>: %s",
                        task.namespace, task.name, e,
                    )

    def update_job_status(self, job: JobInfo) -> JobInfo:
        if not shadow_pod_group(job.pod_group):
            self.status_updater.update_pod_group(job.pod_group)
        self.record_job_status_event(job)
        return job

    # -- volume hooks ------------------------------------------------------

    def allocate_volumes(self, task: TaskInfo, hostname: str) -> None:
        self.volume_binder.allocate_volumes(task, hostname)

    def bind_volumes(self, task: TaskInfo) -> None:
        self.volume_binder.bind_volumes(task)
