"""Sharded multi-scheduler federation: Omega-style shared state.

Instead of one scheduler process owning the
whole cluster, N schedulers run concurrently against ONE store, each
responsible for a shard of the pending workload (partitioned by queue,
namespace, or gang — ``KBT_SHARD_KEY``). There is no pessimistic
partitioning of *nodes*: every scheduler sees full cluster state and
solves over all capacity, and correctness comes from optimistic
concurrency at dispatch time (Omega, Schwarzkopf et al., EuroSys'13):

- every ``bind_many``/evict transaction carries the store version the
  scheduler's snapshot was taken at (``SchedulerCache.snapshot()``
  stamps it);
- the store commits a gang all-or-nothing and rejects the transaction
  with a typed ``StaleWrite`` when any target node took a placement
  write the snapshot never saw, the pod was already placed, or
  store-side admission says the requests no longer fit
  (``ClusterStore.conditional_bind_many``);
- the loser refreshes its version and retries with jittered backoff up
  to ``KBT_CONFLICT_MAX_RETRIES`` times; a terminal loser accepts store
  truth — its journal intent is confirmed (store truth IS the outcome)
  and the gang resyncs through the ordinary errTasks machinery
  (``SchedulerCache._do_bind_gang``).

Shards are about *work division*, not safety: two schedulers
accidentally configured with the same shard stay correct (every
double-place loses its conflict), they just waste solves. Gangs never
split across shards — all three shard keys are gang-stable (a gang's
pods share a podgroup, hence a queue and a namespace).

Deployment shapes:

- in-process: N ``FederatedCache`` over one ``ClusterStore`` (or its
  ``InProcessBackend``), each with its own ``Scheduler`` thread;
- networked (docker-compose topology in deployment/): N scheduler
  processes, each a ``LoopbackBackend`` speaking ``/backend/v1/`` to
  one store process (a SchedulerServer whose own loop is idled by an
  unmatched scheduler name).

Leased shard slots: the ``i`` in ``i/N`` is not a static assignment but this scheduler's *primary slot* — each of the N
shard slots is a store lease (``shard-slot-{i}``, arbitrated by
``ClusterStore.try_acquire_lease`` under the arbiter's clock), held and
renewed by a ``ShardSlotManager``. When a slot's lease expires (its
owner died) survivors race to adopt it: the winner reconciles the dead
shard's write-intent journal against store truth
(``recovery.reconcile_journal``), widens its ``FederatedCache`` owned
set, and schedules the orphaned backlog. A graceful ``handoff`` (stop
dispatching, drain in-flight intents, release the lease) supports
planned moves, which conflict-aware rebalancing drives off the
conflict counters when ``KBT_SHARD_REBALANCE`` is set.

Env surface: ``KBT_FEDERATION`` (shard spec ``i/N``, or any non-empty
value to force conditional dispatch on), ``KBT_SHARD_KEY`` (``queue`` |
``namespace`` | ``gang``; default ``queue``),
``KBT_CONFLICT_MAX_RETRIES`` (cache.py; default 3),
``KBT_SHARD_ADOPT`` (default on), ``KBT_SHARD_LEASE_S`` /
``KBT_SHARD_RENEW_S`` (slot lease TTL / renew cadence),
``KBT_SHARD_REBALANCE`` (conflict delta per probe round that sheds an
adopted slot; 0 = off), ``KBT_SHARD_JOURNAL_DIR`` (shared directory of
per-slot journals, ``shard-{i}.wal`` — what adoption reconciles).

The shards solve on the card: ``smoke`` and ``smoke_kill_one`` write a
conf whose ``torch_allocate`` runs on ``device`` (``cuda`` unless the
caller asks for ``cpu``), and ``bulk=True`` is ``enqueue, torch_allocate``
with the size floor off, so every gang rides ``bind_many``'s conditional
transactions. The JAX package's streaming federation drill
(``smoke_streaming``) comes with the port's streaming layer.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
import time
import zlib
from typing import Callable, Optional

from kube_batch_tpu_torch import faults, metrics
from kube_batch_tpu_torch.api.job_info import get_job_id, job_key
from kube_batch_tpu_torch.apis.types import PodPhase
from kube_batch_tpu_torch.cache import SchedulerCache
from kube_batch_tpu_torch.cache.store import LEASES, NODES, POD_GROUPS, PODS, EventHandler

log = logging.getLogger(__name__)

__all__ = [
    "ENV",
    "SHARD_KEY_ENV",
    "SHARD_KEYS",
    "ADOPT_ENV",
    "LEASE_ENV",
    "RENEW_ENV",
    "REBALANCE_ENV",
    "JOURNAL_DIR_ENV",
    "SLOT_LEASE_PREFIX",
    "enabled",
    "parse_shard_spec",
    "shard_key_mode",
    "shard_key_of",
    "shard_index",
    "slot_lease_name",
    "parse_slot_lease_name",
    "reclaim_lease_name",
    "adopt_enabled",
    "slot_lease_seconds",
    "slot_renew_seconds",
    "shard_journal_dir",
    "shard_journal_path",
    "rebalance_threshold",
    "plan_rebalance",
    "ShardSlotManager",
    "FederatedCache",
    "fsck",
    "smoke",
    "smoke_kill_one",
]

ENV = "KBT_FEDERATION"
SHARD_KEY_ENV = "KBT_SHARD_KEY"
SHARD_KEYS = ("queue", "namespace", "gang")

# -- leased shard slots: env surface -----------------------------------------
ADOPT_ENV = "KBT_SHARD_ADOPT"  # default on; 0/false/no/off disables adoption
LEASE_ENV = "KBT_SHARD_LEASE_S"  # slot lease TTL (default 15.0)
RENEW_ENV = "KBT_SHARD_RENEW_S"  # renew/probe cadence (default lease/3)
REBALANCE_ENV = "KBT_SHARD_REBALANCE"  # conflict delta/round that sheds a slot
JOURNAL_DIR_ENV = "KBT_SHARD_JOURNAL_DIR"  # shared dir of shard-{i}.wal journals

SLOT_LEASE_PREFIX = "shard-slot-"
_RECLAIM_SUFFIX = "-reclaim"
_OFF_WORDS = ("0", "false", "no", "off")


def enabled() -> bool:
    """Process-wide federation switch; also flips SchedulerCache into
    conditional (optimistic) dispatch by default (cache.py)."""
    return os.environ.get(ENV, "") not in ("", "0")


def parse_shard_spec(value: str) -> tuple[int, int]:
    """``"i/N"`` -> (i, N); a bare ``"N"`` or truthy flag -> (0, 1)
    (conditional dispatch on, no workload partition)."""
    value = value.strip()
    if "/" in value:
        i_s, n_s = value.split("/", 1)
        shard, shards = int(i_s), int(n_s)
        if shards < 1 or not (0 <= shard < shards):
            raise ValueError(f"bad shard spec {value!r}: want i/N with 0 <= i < N")
        return shard, shards
    return 0, 1


def shard_key_mode() -> str:
    mode = os.environ.get(SHARD_KEY_ENV, "queue").strip() or "queue"
    if mode not in SHARD_KEYS:
        log.error(
            "%s=%r is not one of %s; using 'queue'", SHARD_KEY_ENV, mode, SHARD_KEYS
        )
        return "queue"
    return mode


def _gang_key(pod) -> str:
    jid = get_job_id(pod)
    if jid:
        return jid
    return job_key(pod.namespace, pod.metadata.owner_job or pod.metadata.uid)


def shard_key_of(pod, store=None, mode: str = "queue") -> str:
    """The stable string a pod shards on. All modes are gang-stable: a
    gang's pods share a podgroup, hence one queue and one namespace, so
    a gang never splits across schedulers (min_member gating would see
    partial gangs otherwise)."""
    if mode == "namespace":
        return pod.namespace
    if mode == "gang":
        return _gang_key(pod)
    # queue: resolve through the podgroup; a pod whose group has not
    # arrived yet (or a shadow gang) falls back to its gang key — still
    # gang-stable, just spread differently until the group lands.
    jid = get_job_id(pod)
    if store is not None and jid:
        pg = store.get(POD_GROUPS, jid)
        if pg is not None and pg.spec.queue:
            return pg.spec.queue
    return _gang_key(pod)


def shard_index(key: str, shards: int) -> int:
    """crc32-based bucket: stable across processes (``hash()`` is salted
    per interpreter and would shard each process differently)."""
    if shards <= 1:
        return 0
    return zlib.crc32(key.encode()) % shards


# -- leased shard slots ------------------------------------------------------


def slot_lease_name(slot: int) -> str:
    return f"{SLOT_LEASE_PREFIX}{slot}"


def reclaim_lease_name(slot: int) -> str:
    """The store-mediated 'please hand slot N back' request: a joining
    scheduler whose primary slot is held by a survivor acquires this
    lease; the survivor's probe loop sees a live reclaim holder and
    gracefully hands the slot off."""
    return f"{SLOT_LEASE_PREFIX}{slot}{_RECLAIM_SUFFIX}"


def parse_slot_lease_name(name: str) -> Optional[int]:
    """The slot index a lease name arbitrates, or None for non-slot
    leases (elector leases, reclaim requests)."""
    if not name.startswith(SLOT_LEASE_PREFIX) or name.endswith(_RECLAIM_SUFFIX):
        return None
    try:
        return int(name[len(SLOT_LEASE_PREFIX):])
    except ValueError:
        return None


def adopt_enabled() -> bool:
    return os.environ.get(ADOPT_ENV, "1").strip().lower() not in _OFF_WORDS


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        log.error("%s=%r is not a number; using %s", name, raw, default)
        return default


def slot_lease_seconds() -> float:
    return max(0.1, _env_float(LEASE_ENV, 15.0))


def slot_renew_seconds(lease_s: Optional[float] = None) -> float:
    lease_s = slot_lease_seconds() if lease_s is None else lease_s
    return max(0.02, _env_float(RENEW_ENV, lease_s / 3.0))


def rebalance_threshold() -> float:
    return max(0.0, _env_float(REBALANCE_ENV, 0.0))


def shard_journal_dir() -> str:
    return os.environ.get(JOURNAL_DIR_ENV, "").strip()


def shard_journal_path(journal_dir: str, slot: int) -> str:
    return os.path.join(journal_dir, f"shard-{slot}.wal")


def plan_rebalance(
    owned: set,
    primary: int,
    adoption_order: list,
    conflicts_delta: float,
    threshold: float,
) -> Optional[int]:
    """Pure rebalance policy: when this scheduler is conflict-hot
    (``conflicts_delta`` since the last probe round >= ``threshold``)
    and owns more than its primary, shed the most recently adopted
    non-primary slot — the gang keys it picked up last are the ones a
    less contended peer should own. Returns the slot to hand off, or
    None."""
    if threshold <= 0 or conflicts_delta < threshold:
        return None
    candidates = [s for s in adoption_order if s in owned and s != primary]
    if not candidates:
        return None
    return candidates[-1]


class ShardSlotManager:
    """Leased ownership of shard slots for one ``FederatedCache``.

    Each of the N shard slots is a store lease named ``shard-slot-{i}``
    (arbitrated by the store's ``try_acquire_lease`` ladder — the same
    machinery the leader elector uses, so expiry, release sentinels and
    transitions all follow the arbiter's clock). The manager:

    - acquires its **primary** slot at start (requesting a graceful
      reclaim when a survivor adopted it first);
    - **renews** every owned slot each ``renew_s`` (the ``shard.lease_flap``
      fault point drops one renewal round — the lease survives one
      missed renewal by construction, so nobody double-adopts);
    - **adopts** orphaned slots: a released slot immediately, an
      expired slot as soon as the arbiter agrees, a never-claimed slot
      after a startup grace (so a slow-starting peer is not robbed).
      Adoption is breaker-backed (an injected/real takeover failure
      releases the slot and backs off) and runs journal takeover
      reconciliation against the dead shard's ``shard-{i}.wal`` before
      the backlog is re-ingested;
    - **hands off** slots gracefully (stop dispatching, drain in-flight
      journal intents, release) for planned moves, reclaim requests and
      conflict-aware rebalancing (``plan_rebalance``).

    The arbiter is duck-typed: an in-process ``ClusterStore`` or a
    ``LoopbackBackend`` (whose lease verbs POST the arbiter's
    ``/apis/v1alpha1/leases/`` endpoint and whose LEASES mirror is the
    ``/backend/v1/`` slot-watch that wakes the probe loop on release)."""

    def __init__(
        self,
        arbiter,
        cache: "FederatedCache",
        identity: Optional[str] = None,
        *,
        lease_s: Optional[float] = None,
        renew_s: Optional[float] = None,
        adopt: Optional[bool] = None,
        journal_dir: Optional[str] = None,
        grace_s: Optional[float] = None,
        rebalance: Optional[float] = None,
        conflict_fn: Optional[Callable[[], float]] = None,
        on_owned_change: Optional[Callable[[set, set], None]] = None,
    ) -> None:
        self.arbiter = arbiter
        self.cache = cache
        self.primary = cache.shard
        self.shards = cache.shards
        self.identity = identity or f"shard-{self.primary}@{os.getpid()}.{id(self):x}"
        self.lease_s = slot_lease_seconds() if lease_s is None else float(lease_s)
        self.renew_s = (
            slot_renew_seconds(self.lease_s) if renew_s is None else float(renew_s)
        )
        self.adopt = adopt_enabled() if adopt is None else bool(adopt)
        self.journal_dir = shard_journal_dir() if journal_dir is None else journal_dir
        self.grace_s = self.lease_s if grace_s is None else float(grace_s)
        self.rebalance = rebalance_threshold() if rebalance is None else float(rebalance)
        self._conflict_fn = conflict_fn
        self._on_owned_change = on_owned_change
        self._lock = threading.Lock()
        self._owned: set[int] = set()  #: guarded_by _lock
        self._adoption_order: list[int] = []  #: guarded_by _lock
        self._reclaiming = False  #: guarded_by _lock
        self._last_conflicts = 0.0  #: guarded_by _lock
        self._breaker = faults.CircuitBreaker(
            f"shard-adopt-{self.primary}", failure_threshold=3, reset_timeout=2.0
        )
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._started_at: Optional[float] = None
        self._watching = False

    # -- introspection -------------------------------------------------------

    def owned_slots(self) -> set[int]:
        with self._lock:
            return set(self._owned)

    # -- lifecycle -----------------------------------------------------------

    def start(self, deadline_s: float = 60.0) -> bool:
        """Acquire the primary slot (requesting reclaim from a survivor
        that adopted it), publish ownership, start the renew/probe loop.
        Returns False if the primary could not be acquired within
        ``deadline_s`` (the loop is NOT started)."""
        deadline = time.monotonic() + deadline_s
        reclaim = reclaim_lease_name(self.primary)
        requested = False
        try:
            while not self._stop.is_set():
                try:
                    lease = self.arbiter.try_acquire_lease(
                        slot_lease_name(self.primary), self.identity, self.lease_s
                    )
                except ConnectionError as e:  # BackendPartitioned
                    log.warning("slot %d acquire: arbiter unreachable (%s)",
                                 self.primary, e)
                    lease = None
                if lease is not None and lease.holder_identity == self.identity:
                    break
                if time.monotonic() >= deadline:
                    return False
                if lease is not None and not requested:
                    # a survivor adopted our slot while we were down:
                    # ask for it back through the store
                    try:
                        self.arbiter.try_acquire_lease(
                            reclaim, self.identity, max(self.lease_s, 2 * self.renew_s)
                        )
                        requested = True
                    except ConnectionError:
                        pass
                time.sleep(min(self.renew_s, 0.25))
        finally:
            if requested:
                try:
                    self.arbiter.release_lease(reclaim, self.identity)
                except ConnectionError:
                    pass
        if self._stop.is_set():
            return False
        self._set_owned({self.primary})
        self._started_at = time.monotonic()
        self._watch_slots()
        self._thread = threading.Thread(
            target=self._loop, name=f"kb-slot-mgr-{self.primary}", daemon=True
        )
        self._thread.start()
        return True

    def stop(self, release: bool = True) -> None:
        """Graceful shutdown: stop the loop and (by default) release
        every owned slot so survivors adopt immediately instead of
        waiting out the lease."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if release:
            for slot in self.owned_slots():
                try:
                    self.arbiter.release_lease(slot_lease_name(slot), self.identity)
                except ConnectionError:
                    pass

    def kill(self) -> None:
        """Simulated SIGKILL for chaos drills: stop renewing WITHOUT
        releasing — the slots must expire on the arbiter's clock, which
        is exactly what survivors' adoption is tested against."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    # -- the loop ------------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.renew_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 - the loop must survive
                log.error("slot manager %s: probe round failed: %s",
                           self.identity, e)

    def step(self) -> None:
        """One renew/probe round — called from the loop, and directly by
        deterministic tests."""
        self._renew_owned()
        self._honor_reclaims()
        self._maybe_rebalance()
        if self.adopt:
            self._probe_orphans()

    def _watch_slots(self) -> None:
        """Subscribe the arbiter's LEASES feed (the in-process store's
        handler ring, or the LoopbackBackend's ``/backend/v1/`` mirror —
        the slot-watch) so a released slot wakes the probe loop
        immediately instead of waiting out a probe period."""
        if self._watching:
            return

        def _on_lease(old, new) -> None:
            if self._stop.is_set():
                return
            if parse_slot_lease_name(new.metadata.name) is None:
                return
            # only a RELEASE (graceful handoff / shutdown) wakes the
            # probe immediately — peer renewals carry no new work, and
            # expiry is passive (the periodic probe discovers it)
            if not new.holder_identity:
                self._wake.set()

        try:
            self.arbiter.add_event_handler(LEASES, EventHandler(on_update=_on_lease))
            self._watching = True
        except Exception as e:  # noqa: BLE001 - watch is an optimization
            log.warning("slot manager %s: lease watch unavailable (%s); "
                         "falling back to periodic probes", self.identity, e)

    # -- renewal -------------------------------------------------------------

    def _renew_owned(self) -> None:
        if faults.should_fire("shard.lease_flap"):
            # one dropped renewal round: the lease outlives a single
            # missed renewal (renew_s < lease_s), so no survivor can
            # adopt — the reacquire next round is a no-op transition
            log.warning("slot manager %s: renewal round dropped (lease flap)",
                         self.identity)
            return
        for slot in sorted(self.owned_slots()):
            name = slot_lease_name(slot)
            try:
                lease = self.arbiter.try_acquire_lease(name, self.identity, self.lease_s)
            except ConnectionError as e:
                log.warning("slot %d renew: arbiter unreachable (%s)", slot, e)
                continue
            if lease.holder_identity != self.identity:
                # lost the slot (expired while we were wedged and a
                # survivor adopted it): drop it from the owned set so we
                # stop dispatching work we no longer own
                log.error(
                    "slot %d lost to %s; dropping from owned set",
                    slot, lease.holder_identity or "<released>",
                )
                with self._lock:
                    owned = set(self._owned)
                owned.discard(slot)
                self._set_owned(owned)

    # -- adoption ------------------------------------------------------------

    def _probe_orphans(self) -> None:
        now = time.monotonic()
        in_grace = (
            self._started_at is not None and now - self._started_at < self.grace_s
        )
        owned = self.owned_slots()
        for slot in range(self.shards):
            if slot in owned:
                continue
            name = slot_lease_name(slot)
            cur = self.arbiter.get(LEASES, name)
            if cur is None and in_grace:
                # never claimed: give a slow-starting peer its grace
                continue
            req = self.arbiter.get(LEASES, reclaim_lease_name(slot))
            if (
                req is not None
                and req.holder_identity
                and req.holder_identity != self.identity
                and time.time() <= req.renew_time + req.lease_duration_seconds
            ):
                # a reclaiming primary has dibs on this slot — don't
                # race (or instantly re-adopt) the lease we just
                # released for it
                continue
            t0 = time.monotonic()
            try:
                lease = self.arbiter.try_acquire_lease(name, self.identity, self.lease_s)
            except ConnectionError:
                continue
            if lease.holder_identity != self.identity:
                continue  # still live, or another survivor won the race
            if cur is not None and cur.holder_identity == self.identity:
                # we already held it (e.g. a handoff raced our own
                # renewal) — nothing to adopt
                continue
            self._adopt(slot, t0)

    def _adopt(self, slot: int, t0: float) -> None:
        """We hold the orphaned slot's lease; take over its work:
        reconcile the dead owner's journal against store truth, widen
        the cache's owned set (which re-ingests the orphaned backlog),
        and notify the scheduler so streaming seeds the adopted gang
        keys. Breaker-backed: a takeover failure releases the slot and
        backs off, so a poisoned journal cannot wedge every survivor in
        a tight adopt/crash loop."""
        if not self._breaker.allow():
            metrics.register_shard_adoption("flap_suppressed")
            try:
                self.arbiter.release_lease(slot_lease_name(slot), self.identity)
            except ConnectionError:
                pass
            return
        try:
            if faults.should_fire("shard.adopt"):
                raise faults.FaultInjected("shard.adopt: injected takeover failure")
            report = self._reconcile_peer_journal(slot)
            with self._lock:
                owned = set(self._owned) | {slot}
            change = self.cache.set_owned_slots(owned)
            with self._lock:
                # merge, don't overwrite: a concurrent handoff may have
                # retired another slot while set_owned_slots ran
                self._owned = set(self._owned) | {slot}
                self._adoption_order.append(slot)
            self._publish_owned(owned)
            self._notify(change["adopted_gangs"], change["removed_gangs"])
            took = time.monotonic() - t0
            metrics.register_shard_adoption("adopted")
            metrics.observe_shard_takeover(took)
            self._breaker.record_success()
            log.info(
                "slot %d adopted by %s in %.3fs (%d pod(s) re-ingested%s)",
                slot, self.identity, took, change["adopted_pods"],
                f"; journal: {report.as_dict()}" if report is not None else "",
            )
        except Exception as e:  # noqa: BLE001 - takeover must not kill the loop
            self._breaker.record_failure()
            metrics.register_shard_adoption("failed")
            log.error("slot %d adoption failed (%s); releasing for retry", slot, e)
            try:
                self.arbiter.release_lease(slot_lease_name(slot), self.identity)
            except ConnectionError:
                pass

    def _reconcile_peer_journal(self, slot: int):
        """Journal takeover for the dead owner of ``slot``: replay its
        ``shard-{slot}.wal`` and reconcile the in-flight intents against
        store truth (confirm landed, re-dispatch orphaned, roll back
        half-bound gangs) BEFORE the backlog is rescheduled — otherwise
        the adopter would race the dead shard's already-dispatched
        writes. Never raises on a missing/foreign journal (adoption
        proceeds; the optimistic-bind path stays correct regardless)."""
        if not self.journal_dir or slot == self.primary:
            return None
        path = shard_journal_path(self.journal_dir, slot)
        if not os.path.exists(path):
            return None
        from kube_batch_tpu_torch.recovery import WriteIntentJournal, reconcile_journal

        journal = WriteIntentJournal(path)
        try:
            return reconcile_journal(journal, self.cache.store)
        finally:
            journal.close()

    # -- handoff -------------------------------------------------------------

    def handoff(self, slot: int, drain_s: Optional[float] = None) -> bool:
        """Graceful planned move of an owned slot: stop dispatching its
        work (narrow the cache filter first), drain this scheduler's
        in-flight journal intents for pods in the slot, then release the
        lease so the next owner adopts with a clean journal. An injected
        ``shard.handoff`` failure aborts the protocol and keeps the slot
        (we still hold the lease — correctness over the planned move)."""
        with self._lock:
            if slot not in self._owned:
                return False
            owned = set(self._owned)
        owned.discard(slot)
        change = self.cache.set_owned_slots(owned)
        try:
            if faults.should_fire("shard.handoff"):
                raise faults.FaultInjected("shard.handoff: injected handoff failure")
            self._drain_slot(slot, drain_s)
            self.arbiter.release_lease(slot_lease_name(slot), self.identity)
        except Exception as e:  # noqa: BLE001 - keep the slot on any failure
            log.error("slot %d handoff aborted (%s); keeping the slot", slot, e)
            restored = self.cache.set_owned_slots(owned | {slot})
            self._notify(restored["adopted_gangs"], restored["removed_gangs"])
            metrics.register_shard_handoff("aborted")
            return False
        with self._lock:
            # merge, don't overwrite: a concurrent adopt may have added
            # another slot while we drained this one
            self._owned = set(self._owned) - {slot}
            if slot in self._adoption_order:
                self._adoption_order.remove(slot)
        self._publish_owned(owned)
        self._notify(change["adopted_gangs"], change["removed_gangs"])
        metrics.register_shard_handoff("completed")
        log.info("slot %d handed off by %s", slot, self.identity)
        return True

    def _drain_slot(self, slot: int, drain_s: Optional[float]) -> None:
        """Wait (bounded) until this cache's journal holds no in-flight
        intent for a pod hashing into ``slot`` — the 'confirm journal'
        step of the handoff protocol. The filter is already narrowed, so
        no NEW intents for the slot can appear; this only waits out the
        write pool's in-flight tail."""
        journal = getattr(self.cache, "journal", None)
        if journal is None:
            return
        deadline = time.monotonic() + (self.lease_s if drain_s is None else drain_s)
        while time.monotonic() < deadline:
            pending = False
            for intent in journal.outstanding():
                ns, _, name = intent.pod.partition("/")
                pod = self.cache.store.get_pod(ns, name)
                if pod is None:
                    continue
                key = shard_key_of(pod, self.cache.store, self.cache.shard_key)
                if shard_index(key, self.shards) == slot:
                    pending = True
                    break
            if not pending:
                return
            time.sleep(min(0.01, self.renew_s))
        log.warning(
            "slot %d handoff: drain window expired with intents still in "
            "flight; the next owner's takeover reconciliation covers them",
            slot,
        )

    def _honor_reclaims(self) -> None:
        """A joining scheduler that found its primary adopted acquires
        ``shard-slot-{i}-reclaim``; hand adopted slots back to live
        reclaimers (the polite half of the reclaim protocol)."""
        owned = self.owned_slots()
        now = time.time()
        for slot in sorted(owned):
            if slot == self.primary:
                continue
            req = self.arbiter.get(LEASES, reclaim_lease_name(slot))
            if req is None or not req.holder_identity:
                continue
            if now > req.renew_time + req.lease_duration_seconds:
                continue  # stale request; the joiner died again
            log.info("slot %d reclaim requested by %s; handing off",
                      slot, req.holder_identity)
            self.handoff(slot)

    # -- rebalancing ---------------------------------------------------------

    def _maybe_rebalance(self) -> None:
        """Conflict-aware shedding: when this scheduler's bind-conflict
        counters (the same deltas the fleet heatmap aggregates) grow
        faster than ``KBT_SHARD_REBALANCE`` per probe round and it owns
        adopted slots, hand the most recent one off — a less contended
        peer adopts it within the lease window."""
        if self.rebalance <= 0:
            return
        fn = self._conflict_fn or _process_conflicts_total
        total = float(fn())
        with self._lock:
            delta = total - self._last_conflicts
            self._last_conflicts = total
            owned = set(self._owned)
            order = list(self._adoption_order)
        slot = plan_rebalance(owned, self.primary, order, delta, self.rebalance)
        if slot is not None:
            log.info(
                "rebalance: conflict delta %.0f >= %.0f; shedding slot %d",
                delta, self.rebalance, slot,
            )
            self.handoff(slot)

    # -- bookkeeping ---------------------------------------------------------

    def _set_owned(self, owned: set) -> None:
        change = self.cache.set_owned_slots(owned)
        with self._lock:
            self._owned = set(owned)
        self._publish_owned(owned)
        self._notify(change["adopted_gangs"], change["removed_gangs"])

    def _publish_owned(self, owned: set) -> None:
        metrics.set_shard_slots_owned(len(owned))
        for slot in range(self.shards):
            metrics.set_shard_slot_owned(slot, slot in owned)

    def _notify(self, adopted_gangs: set, removed_gangs: set) -> None:
        if self._on_owned_change is not None and (adopted_gangs or removed_gangs):
            try:
                self._on_owned_change(set(adopted_gangs), set(removed_gangs))
            except Exception as e:  # noqa: BLE001 - observer must not break takeover
                log.error("owned-change callback failed: %s", e)


def _process_conflicts_total() -> float:
    """Sum of this process's contended-bind outcomes (won/retried/lost)
    — the default conflict signal ``_maybe_rebalance`` thresholds."""
    total = 0.0
    for key, value in metrics.federation_conflicts.samples().items():
        labels = dict(key)
        if labels.get("outcome") in ("won", "retried", "lost"):
            total += value
    return total


class FederatedCache(SchedulerCache):
    """A SchedulerCache owning a dynamic set of shard slots.

    The pod filter narrows the base rule ("my pending pods + every
    non-pending pod") to "my pending pods *in my owned slots* + every
    non-pending pod" — full cluster capacity stays visible, only the
    work divides. The owned set starts as ``{shard}`` (the primary
    slot) and widens/narrows at runtime as a ``ShardSlotManager``
    adopts orphaned slots or hands slots off; ``set_owned_slots``
    backfills the mirror from store truth so pods whose events predate
    a filter flip are not lost. Conditional (optimistic) dispatch is
    forced on."""

    def __init__(
        self,
        store,
        shard: int = 0,
        shards: int = 1,
        shard_key: Optional[str] = None,
        **kwargs,
    ) -> None:
        if not (0 <= shard < max(1, shards)):
            raise ValueError(f"shard {shard} out of range for {shards} shards")
        self.shard = shard
        self.shards = max(1, shards)
        self.shard_key = shard_key or shard_key_mode()
        if self.shard_key not in SHARD_KEYS:
            raise ValueError(f"shard_key must be one of {SHARD_KEYS}")
        # Set before super().__init__: subscription replays existing
        # store objects through _pod_filter during construction. Reads
        # are a single attribute load (atomic swap on ownership change).
        self._owned: frozenset[int] = frozenset({shard})
        kwargs["conditional_binds"] = True
        super().__init__(store, **kwargs)

    @property
    def owned_slots(self) -> frozenset:
        return self._owned

    def _pod_filter(self, pod) -> bool:
        # Only UNBOUND pending pods shard: a bound pod — even one still
        # phase-Pending, and even another shard's — holds node capacity
        # this scheduler must account for, or its snapshots would
        # over-place and every dispatch under contention would lose its
        # store-side admission check forever (conflict livelock).
        if pod.phase == PodPhase.PENDING and not pod.node_name:
            return (
                pod.scheduler_name == self.scheduler_name
                and shard_index(
                    shard_key_of(pod, self.store, self.shard_key), self.shards
                )
                in self._owned
            )
        return True  # bound/terminal pods hold capacity for everyone

    def _has_task(self, pod) -> bool:
        """Whether the mirror already tracks this pod (dedupe guard for
        the backfill below: ``_add_pod`` is not idempotent)."""
        from kube_batch_tpu_torch.api.job_info import TaskInfo

        ti = TaskInfo(pod)
        self._resolve_shadow_job(ti)
        if not ti.job:
            return False
        with self._mutex:
            job = self.jobs.get(ti.job)
            return job is not None and ti.uid in job.tasks

    def set_owned_slots(self, slots) -> dict:
        """Swap the owned-slot set and reconcile the mirror against
        store truth. Ordering is the correctness argument: the filter
        flips FIRST (future events for added slots pass, removed slots
        drop), THEN the store is listed and the mirror backfilled — so
        an event racing the flip is at worst applied twice, and the
        dedupe guard makes the second application a no-op. Returns what
        changed: added/removed slots, re-ingested pod count, and the
        gang keys gained/lost (what streaming seeds/prunes)."""
        new = frozenset(int(s) for s in slots)
        for s in new:
            if not (0 <= s < self.shards):
                raise ValueError(f"slot {s} out of range for {self.shards} shards")
        old = self._owned
        change = {
            "added": set(new - old),
            "removed": set(old - new),
            "adopted_pods": 0,
            "adopted_gangs": set(),
            "removed_gangs": set(),
        }
        if new == old:
            return change
        self._owned = new
        for pod in self.store.list(PODS):
            if pod.phase != PodPhase.PENDING or pod.node_name:
                continue
            if pod.scheduler_name != self.scheduler_name:
                continue
            idx = shard_index(
                shard_key_of(pod, self.store, self.shard_key), self.shards
            )
            if idx in change["added"]:
                change["adopted_gangs"].add(_gang_key(pod))
                if not self._has_task(pod):
                    self.add_pod(pod)
                    change["adopted_pods"] += 1
            elif idx in change["removed"]:
                change["removed_gangs"].add(_gang_key(pod))
                if self._has_task(pod):
                    self.delete_pod(pod)
        if change["added"] or change["removed"]:
            log.info(
                "owned slots %s -> %s (+%s -%s; %d pod(s) re-ingested)",
                sorted(old), sorted(new), sorted(change["added"]),
                sorted(change["removed"]), change["adopted_pods"],
            )
        return change


# -- fsck --------------------------------------------------------------------


def fsck(
    store,
    epsilon: float = 1e-6,
    shard_key: Optional[str] = None,
    now: Optional[float] = None,
) -> list[str]:
    """Cross-scheduler consistency check over store truth; returns
    violations (empty = clean). Invariants:

    - every bound, non-terminal pod names an existing node;
    - per node, the sum of bound non-terminal requests fits allocatable;
    - the store's incremental allocation ledger (``node_allocated``)
      agrees with that recomputed sum — a drifted ledger means a
      conditional admission decision was made against wrong state;
    - **unowned slots**: when the world runs leased shard slots
      (``shard-slot-*`` leases exist), every slot with pending unbound
      pods must have a live, unexpired lease — orphaned work is visible
      to operators even with adoption disabled. ``shard_key`` overrides
      the hash mode (default: this process's ``KBT_SHARD_KEY``);
      ``now`` pins the expiry clock for deterministic tests."""
    from kube_batch_tpu_torch.api.helpers import get_pod_resource_request
    from kube_batch_tpu_torch.api.resource_info import Resource

    out: list[str] = []
    nodes = {n.name: n for n in store.list(NODES)}
    per_node: dict[str, Resource] = {}
    for pod in store.list(PODS):
        if not pod.node_name or pod.phase in (PodPhase.SUCCEEDED, PodPhase.FAILED):
            continue
        if pod.node_name not in nodes:
            out.append(
                f"pod {pod.namespace}/{pod.name} bound to missing node "
                f"{pod.node_name!r}"
            )
            continue
        per_node.setdefault(pod.node_name, Resource.empty()).add(
            get_pod_resource_request(pod)
        )
    for name, used in per_node.items():
        cap = Resource.from_resource_list(nodes[name].allocatable)
        if not used.less_equal(cap):
            out.append(f"node {name} over capacity: used {used} > allocatable {cap}")
    ledger = getattr(store, "node_allocated", None)
    if ledger is not None:
        for name in nodes:
            have = ledger(name)
            want = per_node.get(name, Resource.empty())
            if abs(have.milli_cpu - want.milli_cpu) > epsilon or abs(
                have.memory - want.memory
            ) > epsilon:
                out.append(
                    f"node {name} allocation ledger drift: ledger {have} vs "
                    f"recomputed {want}"
                )
    # unowned-slot check: only meaningful when slot leases exist (plain
    # static-map or single-scheduler worlds skip it)
    slot_leases = {}
    for lease in store.list(LEASES):
        slot = parse_slot_lease_name(lease.metadata.name)
        if slot is not None:
            slot_leases[slot] = lease
    if slot_leases:
        now = time.time() if now is None else now
        slots_n = max(slot_leases) + 1
        mode = shard_key or shard_key_mode()
        pending_by_slot: dict[int, int] = {}
        for pod in store.list(PODS):
            if pod.phase == PodPhase.PENDING and not pod.node_name:
                idx = shard_index(shard_key_of(pod, store, mode), slots_n)
                pending_by_slot[idx] = pending_by_slot.get(idx, 0) + 1
        for slot, n in sorted(pending_by_slot.items()):
            lease = slot_leases.get(slot)
            live = (
                lease is not None
                and lease.holder_identity
                and now <= lease.renew_time + lease.lease_duration_seconds
            )
            if not live:
                holder = "no lease" if lease is None else (
                    "released" if not lease.holder_identity
                    else f"expired lease held by {lease.holder_identity}"
                )
                out.append(
                    f"unowned slot {slot}: {n} pending pod(s) but no live "
                    f"lease ({holder})"
                )
    return out


# -- smoke -------------------------------------------------------------------


def _seed_world(store, gangs: int, members: int, nodes: int) -> None:
    from kube_batch_tpu_torch.testing import (
        build_node,
        build_pod,
        build_pod_group,
        build_queue,
        build_resource_list,
    )

    if store.get("queues", "default") is None:
        store.create_queue(build_queue("default"))
    for i in range(nodes):
        store.create_node(
            build_node(f"n{i}", build_resource_list(cpu=8, memory="8Gi", pods=32))
        )
    for g in range(gangs):
        name = f"fg{g}"
        store.create_pod_group(build_pod_group(name, min_member=members))
        for m in range(members):
            store.create_pod(
                build_pod(
                    name=f"{name}-p{m}",
                    group_name=name,
                    req=build_resource_list(cpu=1, memory="512Mi"),
                )
            )


# The bulk-dispatch conf (the JAX package's ``enqueue, xla_allocate``):
# no O(cluster) fairness sweeps, and the size floor off so small worlds
# still route through bind_many's gang transactions instead of per-pod
# serial dispatch.
BULK_CONF = """actions: "enqueue, torch_allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: predicates
  - name: nodeorder
"""


def write_conf(device: str = "cuda", bulk: bool = False, directory=None) -> str:
    """Write the smoke's scheduler conf to a temporary file and return its
    path: the bulk conf, or the scheduler's default pipeline, with
    ``torch_allocate`` solving on ``device`` (and, for bulk, the size
    floor off). The caller unlinks it."""
    from kube_batch_tpu_torch.scheduler import DEFAULT_SCHEDULER_CONF

    body = BULK_CONF if bulk else DEFAULT_SCHEDULER_CONF.lstrip("\n")
    body += f"actionArguments:\n  torch_allocate:\n    device: {device}\n"
    if bulk:
        body += "    min_device_pairs: 0\n"
    fd, path = tempfile.mkstemp(suffix=".yaml", prefix="kbt-fed-", dir=directory)
    with os.fdopen(fd, "w") as fh:
        fh.write(body)
    return path


def _wait_all_bound(store, total: int, deadline_s: float) -> bool:
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        pods = store.list(PODS)
        if len(pods) >= total and all(p.node_name for p in pods):
            return True
        time.sleep(0.005)
    return False


def smoke(
    shards: int = 2,
    gangs: int = 6,
    members: int = 3,
    nodes: int = 8,
    protocol: Optional[int] = None,
    codec: Optional[str] = None,
    rtt_probes: int = 0,
    bulk: bool = False,
    device: str = "cuda",
) -> dict:
    """End-to-end federation proof, runnable standalone
    (``python -m kube_batch_tpu_torch.federation``):

    1. start a real SchedulerServer on loopback whose own loop is idled
       (unmatched scheduler name) — it is the store process;
    2. run ``shards`` FederatedCache+Scheduler pairs against it, each
       over its own LoopbackBackend (the full wire path: list+watch,
       conditional binds, 409 conflicts);
    3. assert every pod bound exactly once (a store-side handler counts
       ""->node transitions per pod), the union placement is
       capacity-valid (fsck clean), and the *set* of bound pods matches
       a single-scheduler twin on an identical world (which pods bind
       is deterministic; which node wins a race is not).

    ``protocol``/``codec`` pin the wire generation:
    ``protocol=1`` runs the whole topology on the pre-v2 surface
    (server pinned, clients capped), ``protocol=2`` the full v2 stack.
    When pinned, the result additionally carries the measured row —
    ``binds_per_s``, ``wire_bytes_per_bind`` (protocol bytes both
    directions over total binds), ``backend_rtt_p50_s`` (``rtt_probes``
    timed version round-trips: fresh-connection urllib under v1, pooled
    keep-alive under v2) and server-side txn batch stats.

    ``bulk=True`` runs every scheduler (and the parity twin) on the
    gang bulk-dispatch conf (``BULK_CONF``: ``enqueue, torch_allocate``
    with the size floor off) so binds flow through ``bind_many`` — the
    path that opens all-or-nothing gang transactions and, under v2,
    coalesces the cycle's gangs into one ``/backend/v1/txn`` round
    trip. The default pipeline routes these small worlds below its size
    floor to the serial allocate, which binds per task and never
    batches. ``device`` is where ``torch_allocate`` solves."""
    import statistics

    from kube_batch_tpu_torch.cache import LoopbackBackend
    from kube_batch_tpu_torch.scheduler import Scheduler
    from kube_batch_tpu_torch.server import SchedulerServer

    total = gangs * members
    conf_path = write_conf(device, bulk)
    # the store process's own loop is idle (unmatched scheduler name);
    # the conf keeps its torch_allocate on the same device as the shards
    server = SchedulerServer(
        scheduler_name="store-arbiter", listen_address="127.0.0.1:0",
        scheduler_conf=conf_path, schedule_period=60.0,
        wire_protocol=1 if protocol == 1 else 2,
    )
    server.start()
    bind_counts: dict[str, int] = {}
    counts_lock = threading.Lock()

    def _count_bind(old, new) -> None:
        if not old.node_name and new.node_name:
            with counts_lock:
                key = f"{new.namespace}/{new.name}"
                bind_counts[key] = bind_counts.get(key, 0) + 1

    server.store.add_event_handler(PODS, EventHandler(on_update=_count_bind))
    backends: list[LoopbackBackend] = []
    scheds: list[tuple[Scheduler, threading.Thread]] = []
    stop = threading.Event()
    txn0 = metrics.store_backend_txn_batch.snapshot()
    rtts: list[float] = []
    negotiated: tuple = (None, None)
    wire_bytes = 0
    elapsed = 0.0
    try:
        _seed_world(server.store, gangs, members, nodes)
        base = f"http://127.0.0.1:{server.listen_port}"
        t0 = time.monotonic()
        for i in range(shards):
            backend = LoopbackBackend(base, protocol=protocol, codec=codec)
            cache = FederatedCache(
                backend, shard=i, shards=shards, shard_key="gang",
                staleness_fn=backend.snapshot_age,
            )
            cache.run()
            backend.start(period=0.02)
            backends.append(backend)
            sched = Scheduler(
                cache, scheduler_conf=conf_path, schedule_period=0.05
            )
            t = threading.Thread(
                target=sched.run, args=(stop,), name=f"kb-fed-{i}", daemon=True
            )
            t.start()
            scheds.append((sched, t))
        all_bound = _wait_all_bound(server.store, total, deadline_s=60.0)
        elapsed = time.monotonic() - t0
        for _ in range(max(0, rtt_probes)):
            p0 = time.perf_counter()
            backends[0].version
            rtts.append(time.perf_counter() - p0)
    finally:
        stop.set()
        for _, t in scheds:
            t.join(timeout=10.0)
        for backend in backends:
            backend.stop()
        for sched, _ in scheds:
            sched.cache.stop()
        if backends:
            negotiated = (backends[0]._protocol, backends[0]._codec)
            wire_bytes = sum(b.bytes_tx + b.bytes_rx for b in backends)
        server.stop()

    violations = fsck(server.store)
    counts = dict(bind_counts)
    exactly_once = all_bound and sorted(counts.values()) == [1] * total

    # single-scheduler twin: same world, one cache, in-process
    from kube_batch_tpu_torch.cache import ClusterStore

    twin = ClusterStore()
    _seed_world(twin, gangs, members, nodes)
    twin_cache = SchedulerCache(twin)
    twin_cache.run()
    twin_sched = Scheduler(
        twin_cache, scheduler_conf=conf_path, schedule_period=0.02
    )
    twin_stop = threading.Event()
    t = threading.Thread(target=twin_sched.run, args=(twin_stop,), daemon=True)
    t.start()
    try:
        _wait_all_bound(twin, total, deadline_s=30.0)
    finally:
        twin_stop.set()
        t.join(timeout=10.0)
        twin_cache.stop()
        try:
            os.unlink(conf_path)
        except OSError:
            pass
    fed_bound = {
        f"{p.namespace}/{p.name}"
        for p in server.store.list(PODS)
        if p.node_name
    }
    twin_bound = {
        f"{p.namespace}/{p.name}" for p in twin.list(PODS) if p.node_name
    }

    out = {
        "shards": shards,
        "pods": total,
        "bound": len(fed_bound),
        "exactly_once": exactly_once,
        "double_binds": sum(1 for v in counts.values() if v > 1),
        "fsck_violations": violations,
        "union_parity": fed_bound == twin_bound,
    }
    if protocol is not None:
        txn1 = metrics.store_backend_txn_batch.snapshot()
        batches = txn1["count"] - txn0["count"]
        out.update(
            {
                "protocol": negotiated[0],
                "codec": negotiated[1],
                "elapsed_s": round(elapsed, 4),
                "binds_per_s": (
                    round(total / elapsed, 2) if elapsed > 0 else 0.0
                ),
                "wire_bytes_per_bind": round(wire_bytes / max(1, total), 1),
                "backend_rtt_p50_s": (
                    round(statistics.median(rtts), 6) if rtts else None
                ),
                "txn_batches": batches,
                "txn_batch_mean": (
                    round((txn1["sum"] - txn0["sum"]) / batches, 2)
                    if batches else 0.0
                ),
            }
        )
    out["ok"] = bool(
        all_bound
        and exactly_once
        and not violations
        and out["union_parity"]
        and out["bound"] == total
    )
    return out


def smoke_kill_one(
    shards: int = 4,
    gangs: int = 16,
    members: int = 2,
    nodes: int = 12,
    lease_s: float = 1.0,
    renew_s: float = 0.25,
    strict: bool = False,
    device: str = "cuda",
    bulk: bool = False,
) -> dict:
    """Kill-and-adopt drill (``python -m kube_batch_tpu_torch.federation
    --kill-one``):

    1. run ``shards`` FederatedCache+Scheduler pairs over ONE in-process
       store, each holding its primary slot through a ``ShardSlotManager``
       (short leases: ``lease_s``/``renew_s``) and journaling intents to
       ``shard-{i}.wal``;
    2. the shard owning the most gangs gets a dying binder that raises a
       BaseException mid-``bind_many`` after a few gang transactions —
       the in-process analogue of SIGKILL-ing the owner with the write
       pool mid-batch — then its slot manager is ``kill()``-ed (renewals
       stop WITHOUT release, so the lease must expire on the arbiter's
       clock);
    3. while the lease runs out, fsck is polled for the ``unowned slot``
       violation (the operator-visible orphaned-work window);
    4. a survivor must adopt the slot within the lease window
       (lease + 2×renew + slack), reconcile the dead shard's journal,
       and schedule its backlog;
    5. final asserts: every pod bound exactly once (zero lost, zero
       duplicate), fsck clean, union parity vs a single-scheduler twin,
       and exactly one survivor owns the orphaned slot.

    MTTR here = binder death -> first post-kill bind of a pod hashing to
    the victim's slot (journal re-dispatch or adopted-backlog bind,
    whichever lands first). ``strict`` additionally requires the
    unowned-slot fsck window to have been OBSERVED by the poll (the
    window is real but an aggressive adopter can shrink it below the
    poll period, so by default it is reported, not gated). Every shard
    and the twin run the scheduler's default pipeline with
    ``torch_allocate`` on ``device`` (below its size floor on this world:
    the serial allocate, one bind per task), or with ``bulk`` the bulk
    conf, whose gangs go out through ``bind_many``'s gang transactions
    and whose solve runs on ``device`` whatever the world's size."""
    from kube_batch_tpu_torch.cache import ClusterStore
    from kube_batch_tpu_torch.cache.cache import StoreBinder
    from kube_batch_tpu_torch.recovery import WriteIntentJournal
    from kube_batch_tpu_torch.scheduler import Scheduler

    total = gangs * members
    die_after = 2

    class _Killed(BaseException):
        # BaseException on purpose: nothing between the binder and the
        # kb-write pool may catch it, mirroring a process death
        pass

    killed: dict = {"evt": threading.Event()}

    class _DyingBinder(StoreBinder):
        """Commits ``left`` write statements, then dies forever."""

        def __init__(self, store, left):
            super().__init__(store)
            self.left = left

        def _die(self):
            if "t" not in killed:
                killed["t"] = time.monotonic()
            killed["evt"].set()
            raise _Killed()

        def bind_many_versioned(self, bindings, snapshot_version):
            if killed["evt"].is_set() or self.left <= 0:
                self._die()
            self.left -= 1
            return super().bind_many_versioned(bindings, snapshot_version)

        def bind(self, pod, hostname):
            if killed["evt"].is_set() or self.left <= 0:
                self._die()
            self.left -= 1
            super().bind(pod, hostname)

    store = ClusterStore()
    _seed_world(store, gangs, members, nodes)

    # victim = the slot owning the most gangs (guarantees work both
    # before the kill and orphaned after it)
    gang_slot: dict[str, int] = {}
    for pod in store.list(PODS):
        gang_slot[_gang_key(pod)] = shard_index(
            shard_key_of(pod, store, "gang"), shards
        )
    per_slot: dict[int, int] = {}
    for slot in gang_slot.values():
        per_slot[slot] = per_slot.get(slot, 0) + 1
    victim = max(per_slot, key=lambda s: (per_slot[s], -s))

    bind_counts: dict[str, int] = {}
    bind_times: list = []  # (slot, monotonic stamp)
    counts_lock = threading.Lock()

    def _count_bind(old, new) -> None:
        if not old.node_name and new.node_name:
            with counts_lock:
                key = f"{new.namespace}/{new.name}"
                bind_counts[key] = bind_counts.get(key, 0) + 1
                bind_times.append(
                    (shard_index(shard_key_of(new, store, "gang"), shards),
                     time.monotonic())
                )

    store.add_event_handler(PODS, EventHandler(on_update=_count_bind))

    mgrs: list = []
    caches: list = []
    journals: list = []
    threads: list = []
    stops: list = []
    note = ""
    t_kill = None
    t_adopt = None
    adopter = None
    unowned_observed = False
    all_bound = False
    with tempfile.TemporaryDirectory() as tmp:
        conf_path = write_conf(device, bulk, directory=tmp)
        try:
            for i in range(shards):
                journal = WriteIntentJournal(shard_journal_path(tmp, i))
                journals.append(journal)
                binder = _DyingBinder(store, die_after) if i == victim else None
                cache = FederatedCache(
                    store, shard=i, shards=shards, shard_key="gang",
                    binder=binder, journal=journal,
                )
                cache.run()
                caches.append(cache)
                sched = Scheduler(
                    cache, scheduler_conf=conf_path, schedule_period=0.05
                )
                mgr = ShardSlotManager(
                    store, cache, identity=f"kb-smoke-{i}",
                    lease_s=lease_s, renew_s=renew_s, adopt=True,
                    journal_dir=tmp, grace_s=5.0, rebalance=0,
                    on_owned_change=(
                        lambda a, r, s=sched: s.on_owned_slots_changed(a, r)
                    ),
                )
                if not mgr.start(deadline_s=10.0):
                    raise RuntimeError(f"shard {i} never acquired its slot")
                mgrs.append(mgr)
                stop = threading.Event()
                stops.append(stop)
                t = threading.Thread(
                    target=sched.run, args=(stop,), name=f"kb-kill-{i}",
                    daemon=True,
                )
                t.start()
                threads.append(t)

            if not killed["evt"].wait(timeout=30.0):
                note = "victim never dispatched (no kill happened)"
            else:
                t_kill = killed["t"]
                # the "SIGKILL": stop the victim's scheduler and stop
                # renewing WITHOUT releasing — the lease must expire
                stops[victim].set()
                threads[victim].join(timeout=10.0)
                mgrs[victim].kill()
                deadline = time.monotonic() + 30.0
                while time.monotonic() < deadline:
                    for i, mgr in enumerate(mgrs):
                        if i != victim and victim in mgr.owned_slots():
                            t_adopt = time.monotonic()
                            adopter = mgr.identity
                            break
                    if t_adopt is not None:
                        break
                    if not unowned_observed:
                        unowned_observed = any(
                            v.startswith(f"unowned slot {victim}")
                            for v in fsck(store, shard_key="gang")
                        )
                    time.sleep(0.005)
                all_bound = _wait_all_bound(store, total, deadline_s=60.0)
        finally:
            for stop in stops:
                stop.set()
            for t in threads:
                t.join(timeout=10.0)
            double_owned = sum(
                1 for i, mgr in enumerate(mgrs)
                if i != victim and victim in mgr.owned_slots()
            )
            for i, mgr in enumerate(mgrs):
                if i != victim:
                    mgr.stop(release=True)
            for cache in caches:
                cache.stop()
            for journal in journals:
                journal.close()

    violations = fsck(store, shard_key="gang")
    counts = dict(bind_counts)
    exactly_once = all_bound and sorted(counts.values()) == [1] * total

    # single-scheduler twin on an identical world: the SET of bound pods
    # must match (which pods bind is deterministic)
    twin = ClusterStore()
    _seed_world(twin, gangs, members, nodes)
    twin_cache = SchedulerCache(twin)
    twin_cache.run()
    conf_path = write_conf(device, bulk)
    twin_sched = Scheduler(twin_cache, scheduler_conf=conf_path, schedule_period=0.02)
    twin_stop = threading.Event()
    t = threading.Thread(target=twin_sched.run, args=(twin_stop,), daemon=True)
    t.start()
    try:
        _wait_all_bound(twin, total, deadline_s=30.0)
    finally:
        twin_stop.set()
        t.join(timeout=10.0)
        twin_cache.stop()
        os.unlink(conf_path)
    fed_bound = {
        f"{p.namespace}/{p.name}" for p in store.list(PODS) if p.node_name
    }
    twin_bound = {
        f"{p.namespace}/{p.name}" for p in twin.list(PODS) if p.node_name
    }

    takeover_window_s = lease_s + 2 * renew_s + 1.0
    takeover_s = (
        round(t_adopt - t_kill, 4)
        if (t_adopt is not None and t_kill is not None) else None
    )
    mttr_s = None
    if t_kill is not None:
        with counts_lock:
            post = [
                t for slot, t in bind_times if slot == victim and t > t_kill
            ]
        if post:
            mttr_s = round(min(post) - t_kill, 4)

    out = {
        "shards": shards,
        "pods": total,
        "bound": len(fed_bound),
        "victim_slot": victim,
        "victim_gangs": per_slot.get(victim, 0),
        "adopter": adopter,
        "takeover_s": takeover_s,
        "takeover_window_s": round(takeover_window_s, 4),
        "mttr_s": mttr_s,
        "unowned_window_observed": unowned_observed,
        "double_owned": double_owned,
        "exactly_once": exactly_once,
        "double_binds": sum(1 for v in counts.values() if v > 1),
        "fsck_violations": violations,
        "union_parity": fed_bound == twin_bound,
        "lease_s": lease_s,
        "renew_s": renew_s,
        "note": note or (
            "in-process SIGKILL: dying binder raises mid-bind_many, slot "
            "manager stops renewing without release; survivor adopts on "
            "lease expiry, reconciles the journal, schedules the backlog"
        ),
    }
    out["ok"] = bool(
        all_bound
        and exactly_once
        and not violations
        and out["union_parity"]
        and out["bound"] == total
        and adopter is not None
        and double_owned == 1
        and takeover_s is not None
        and takeover_s <= takeover_window_s
        and mttr_s is not None
        and mttr_s <= takeover_window_s + 3.0
        and (unowned_observed or not strict)
    )
    return out


def main(argv: Optional[list[str]] = None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(
        description="federation smoke: N schedulers over one store, "
        "optimistic conflicts, exactly-once binds; --kill-one runs the "
        "kill-and-adopt drill (leased slots, survivor adoption, MTTR)"
    )
    parser.add_argument("--shards", type=int, default=None)
    parser.add_argument("--gangs", type=int, default=None)
    parser.add_argument("--members", type=int, default=None)
    parser.add_argument("--nodes", type=int, default=None)
    parser.add_argument(
        "--wire-protocol", type=int, default=None, choices=(1, 2),
        help="pin the wire generation (1 = pre-v2 surface end to end, "
        "2 = full v2 stack) and emit the measured transport row",
    )
    parser.add_argument(
        "--codec", default=None, choices=("json", "binary"),
        help="with --wire-protocol: the client codec preference",
    )
    parser.add_argument(
        "--rtt-probes", type=int, default=0,
        help="with --wire-protocol: timed version round-trips for the "
        "backend_rtt_p50_s column",
    )
    parser.add_argument(
        "--bulk", action="store_true",
        help="schedule on the gang bulk-dispatch conf (bind_many -> "
        "gang transactions; v2 coalesces them per cycle); with --kill-one "
        "the owner dies mid-bind_many",
    )
    parser.add_argument(
        "--kill-one", action="store_true",
        help="kill-and-adopt drill: SIGKILL one shard owner mid-bind_many "
        "and require a survivor to adopt its slot within the lease window",
    )
    parser.add_argument(
        "--strict", action="store_true",
        help="with --kill-one: also require the transient 'unowned slot' "
        "fsck window to have been observed",
    )
    parser.add_argument(
        "--streaming", action="store_true",
        help="the streaming-federation parity drill; it needs the streaming "
        "layer, which the port does not have yet, so it exits with an error",
    )
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where each shard's torch_allocate solves (default: the card)",
    )
    parser.add_argument(
        "--json", action="store_true", help="print the result dict as JSON"
    )
    args = parser.parse_args(argv)
    if args.streaming:
        parser.error(
            "--streaming needs the streaming scheduler (streaming.py), which "
            "the port does not have yet"
        )
    if args.kill_one:
        result = smoke_kill_one(
            shards=args.shards or 4,
            gangs=args.gangs or 16,
            members=args.members or 2,
            strict=args.strict,
            device=args.device,
            bulk=args.bulk,
        )
    else:
        result = smoke(
            shards=args.shards or 2,
            gangs=args.gangs or 6,
            members=args.members or 3,
            nodes=args.nodes or 8,
            protocol=args.wire_protocol,
            codec=args.codec,
            rtt_probes=args.rtt_probes,
            bulk=args.bulk,
            device=args.device,
        )
    if args.json:
        print(json.dumps(result, sort_keys=True))
    elif args.kill_one:
        status = "ok" if result["ok"] else "FAILED"
        print(
            f"federation kill drill: {status} (victim slot "
            f"{result['victim_slot']} adopted by {result['adopter']} in "
            f"{result['takeover_s']}s <= {result['takeover_window_s']}s, "
            f"mttr={result['mttr_s']}s, {result['bound']}/{result['pods']} "
            f"pods bound, exactly_once={result['exactly_once']}, "
            f"union_parity={result['union_parity']}, "
            f"fsck={'clean' if not result['fsck_violations'] else result['fsck_violations']})"
        )
    else:
        status = "ok" if result["ok"] else "FAILED"
        print(
            f"federation smoke: {status} ({result['bound']}/{result['pods']} pods "
            f"bound across {result['shards']} schedulers, exactly_once="
            f"{result['exactly_once']}, union_parity={result['union_parity']}, "
            f"fsck={'clean' if not result['fsck_violations'] else result['fsck_violations']})"
        )
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    # re-enter through the canonical module: `python -m` executes this
    # file as __main__, whose module-level state would otherwise be
    # distinct from the one other modules import
    from kube_batch_tpu_torch.federation import main as _canonical_main

    raise SystemExit(_canonical_main())
