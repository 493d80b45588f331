"""The port's dynamic resharding, case for case with
tests/test_resharding.py: leased shard slots, survivor adoption, graceful
handoff and the reclaim protocol.

The headline e2e is the kill drill: SIGKILL one shard owner
mid-``bind_many`` at N=4 (dying binder through the optimistic path +
``ShardSlotManager.kill()`` so the lease must expire on the arbiter's
clock) and require a survivor to adopt the orphaned slot within the
lease window with zero lost and zero duplicate binds, union parity
against a single-scheduler twin, and a clean fsck. Around it, the
deterministic pieces: the fsck unowned-slot check, ``set_owned_slots``
backfill/dedupe, lease-flap single-ownership, breaker-backed adoption
failure, handoff abort-on-fault, the reclaim protocol, and the
owned-slot callback.

The two streaming cases (``test_on_owned_slots_changed_seeds_and_prunes_
stream_trigger``, whose periodic-mode half is also
``test_on_owned_slots_changed_is_a_noop_in_periodic_mode``, and
``test_handoff_parity_under_streaming_micro_cycles``) drive the port's
``StreamTrigger``; the handoff runs through both packages and ends at the
same placements. The fleet series that
the JAX exposition test also names come with the fleet rollup (A15.5).
The parity cases at the end hold the port's adoption against the JAX
package's: a dead shard's journal written by one package is reconciled
by the other's adoption, and the kill drill ends the same in both.
"""

from __future__ import annotations

import pytest

from kube_batch_tpu_torch import faults, metrics
from kube_batch_tpu_torch.api.job_info import job_key
from kube_batch_tpu_torch.cache import ClusterStore, SchedulerCache
from kube_batch_tpu_torch.cache.store import LEASES, PODS
from kube_batch_tpu_torch.federation import (
    FederatedCache,
    ShardSlotManager,
    fsck,
    parse_slot_lease_name,
    plan_rebalance,
    reclaim_lease_name,
    shard_index,
    shard_journal_path,
    slot_lease_name,
    smoke_kill_one,
)
from kube_batch_tpu_torch.recovery import WriteIntentJournal
from kube_batch_tpu_torch.testing import (
    build_node,
    build_pod,
    build_pod_group,
    build_queue,
    build_resource_list,
)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.registry.reset()
    faults.solver_ladder.reset()
    yield
    faults.registry.reset()
    faults.solver_ladder.reset()


def seed_store(store, nodes=2, cpu=16, gangs=(), members=2):
    if store.get("queues", "default") is None:
        store.create_queue(build_queue("default"))
    for i in range(nodes):
        store.create_node(
            build_node(
                f"n{i}", build_resource_list(cpu=cpu, memory=f"{cpu}Gi", pods=64)
            )
        )
    for g in gangs:
        store.create_pod_group(build_pod_group(g, min_member=members))
        for m in range(members):
            store.create_pod(
                build_pod(
                    name=f"{g}-p{m}", group_name=g,
                    req=build_resource_list(cpu=1, memory="512Mi"),
                )
            )


def gangs_for_slots(shards: int, per_slot: int = 1) -> dict[int, list[str]]:
    """Deterministically pick gang names hashing into each slot (crc32
    is stable, so the picks are stable too)."""
    out: dict[int, list[str]] = {s: [] for s in range(shards)}
    i = 0
    while any(len(v) < per_slot for v in out.values()):
        name = f"g{i}"
        slot = shard_index(job_key("default", name), shards)
        if len(out[slot]) < per_slot:
            out[slot].append(name)
        i += 1
    return out


def make_pair(store, tmp_path, shards=2):
    """Two FederatedCaches + managers (no loops started: tests drive
    ``step()``/``handoff()`` directly for determinism)."""
    caches, mgrs = [], []
    for i in range(shards):
        cache = FederatedCache(store, shard=i, shards=shards, shard_key="gang")
        mgr = ShardSlotManager(
            store, cache, identity=f"mgr-{i}",
            lease_s=60.0, renew_s=1.0, adopt=True,
            journal_dir=str(tmp_path), grace_s=0.0, rebalance=0,
        )
        store.try_acquire_lease(slot_lease_name(i), mgr.identity, mgr.lease_s)
        mgr._set_owned({i})
        caches.append(cache)
        mgrs.append(mgr)
    return caches, mgrs


# -- slot-lease naming --------------------------------------------------------


def test_slot_lease_name_round_trip():
    assert parse_slot_lease_name(slot_lease_name(3)) == 3
    assert parse_slot_lease_name("shard-slot-0") == 0
    assert parse_slot_lease_name("not-a-slot") is None
    assert parse_slot_lease_name("shard-slot-x") is None
    # reclaim leases are NOT slot leases (they must never wake adoption)
    assert parse_slot_lease_name(reclaim_lease_name(3)) is None


def test_plan_rebalance_sheds_most_recent_adoption_only():
    # below threshold, no adopted slots, or primary-only: nothing to shed
    assert plan_rebalance({0}, 0, [], 100.0, 10.0) is None
    assert plan_rebalance({0, 1}, 0, [1], 5.0, 10.0) is None
    assert plan_rebalance({0, 1}, 0, [1], 50.0, 0.0) is None  # disabled
    # most recently adopted non-primary slot goes first
    assert plan_rebalance({0, 1, 2}, 0, [1, 2], 50.0, 10.0) == 2
    assert plan_rebalance({0, 1, 2}, 0, [2, 1], 50.0, 10.0) == 1


# -- the kill drill (the acceptance e2e) --------------------------------------


def test_kill_one_shard_owner_adopts_within_lease_window():
    """SIGKILL mid-bind_many at N=4: a survivor adopts within the lease
    window, zero lost/duplicate binds, union parity vs the twin, fsck
    clean after recovery."""
    out = smoke_kill_one(shards=4, gangs=16, members=2, device="cpu")
    assert out["ok"], out
    assert out["adopter"] is not None
    assert out["double_owned"] == 1, "orphaned slot adopted more than once"
    assert out["takeover_s"] <= out["takeover_window_s"], out
    assert out["mttr_s"] is not None
    assert out["double_binds"] == 0
    assert out["exactly_once"]
    assert out["union_parity"]
    assert out["fsck_violations"] == []
    assert out["bound"] == out["pods"]


# -- fsck: unowned slots ------------------------------------------------------


def test_fsck_reports_unowned_slot_with_pending_pods():
    store = ClusterStore()
    picks = gangs_for_slots(2)
    seed_store(store, gangs=[picks[0][0], picks[1][0]])
    # slot 1 live, slot 0's lease expired long ago
    store.try_acquire_lease(slot_lease_name(0), "dead", 5.0, now=100.0)
    store.try_acquire_lease(slot_lease_name(1), "alive", 5.0, now=200.0)
    violations = fsck(store, shard_key="gang", now=200.0)
    assert any(v.startswith("unowned slot 0:") for v in violations), violations
    assert not any(v.startswith("unowned slot 1:") for v in violations)
    # a released slot (graceful shutdown, nobody adopted yet) is also
    # unowned work
    store.try_acquire_lease(slot_lease_name(0), "dead", 5.0, now=201.0)
    store.release_lease(slot_lease_name(0), "dead")
    violations = fsck(store, shard_key="gang", now=202.0)
    assert any("released" in v for v in violations if v.startswith("unowned slot 0"))
    # once someone live holds it, the check clears
    store.try_acquire_lease(slot_lease_name(0), "survivor", 5.0, now=203.0)
    assert fsck(store, shard_key="gang", now=203.0) == []


def test_fsck_without_slot_leases_skips_the_check():
    store = ClusterStore()
    picks = gangs_for_slots(2)
    seed_store(store, gangs=[picks[0][0]])
    assert fsck(store, shard_key="gang") == []  # static-map world: no leases


# -- FederatedCache.set_owned_slots ------------------------------------------


def test_set_owned_slots_backfills_and_dedupes():
    store = ClusterStore()
    picks = gangs_for_slots(2, per_slot=2)
    seed_store(store, gangs=picks[0] + picks[1], members=2)
    cache = FederatedCache(store, shard=0, shards=2, shard_key="gang")
    # primary slot only: slot-1 pods are filtered out of the mirror
    assert all(not cache._has_task(p) for p in store.list(PODS)
               if p.name.startswith(tuple(picks[1])))
    # pre-ingest ONE slot-1 pod (an event that raced the flip): the
    # backfill must dedupe it, not double-add
    raced = next(
        p for p in store.list(PODS) if p.name.startswith(picks[1][0])
    )
    cache.add_pod(raced)
    change = cache.set_owned_slots({0, 1})
    assert change["added"] == {1}
    assert change["adopted_pods"] == 3  # 4 slot-1 pods minus the raced one
    assert change["adopted_gangs"] == {f"default/{g}" for g in picks[1]}
    assert cache.owned_slots == frozenset({0, 1})
    # idempotent: same set is a no-op
    again = cache.set_owned_slots({0, 1})
    assert again["added"] == set() and again["adopted_pods"] == 0
    # narrowing drops the slot's tasks from the mirror
    change = cache.set_owned_slots({0})
    assert change["removed"] == {1}
    assert change["removed_gangs"] == {f"default/{g}" for g in picks[1]}
    assert all(not cache._has_task(p) for p in store.list(PODS)
               if p.name.startswith(tuple(picks[1])))
    with pytest.raises(ValueError):
        cache.set_owned_slots({0, 7})


# -- lease flap ---------------------------------------------------------------


def test_lease_flap_drops_one_renewal_without_double_adoption():
    store = ClusterStore()
    tmp = None
    caches, mgrs = [], []
    for i in range(2):
        cache = FederatedCache(store, shard=i, shards=2, shard_key="gang")
        mgr = ShardSlotManager(
            store, cache, identity=f"flap-{i}",
            lease_s=60.0, renew_s=1.0, adopt=True,
            journal_dir=tmp, grace_s=0.0, rebalance=0,
        )
        store.try_acquire_lease(slot_lease_name(i), mgr.identity, 60.0)
        mgr._set_owned({i})
        caches.append(cache)
        mgrs.append(mgr)
    before = store.get(LEASES, slot_lease_name(0)).lease_transitions
    faults.registry.arm("shard.lease_flap", count=1)
    mgrs[0].step()  # renewal round dropped entirely
    mgrs[1].step()  # peer probes: slot 0's lease is stale-but-live
    lease = store.get(LEASES, slot_lease_name(0))
    assert lease.holder_identity == "flap-0"
    assert 0 not in mgrs[1].owned_slots()
    mgrs[0].step()  # next round reacquires: same holder, no transition
    lease = store.get(LEASES, slot_lease_name(0))
    assert lease.holder_identity == "flap-0"
    assert lease.lease_transitions == before


# -- adoption: breaker-backed failure ----------------------------------------


def test_injected_adopt_failure_releases_slot_then_retry_succeeds(tmp_path):
    store = ClusterStore()
    picks = gangs_for_slots(2)
    seed_store(store, gangs=[picks[0][0], picks[1][0]])
    caches, mgrs = make_pair(store, tmp_path)
    # slot 0's owner dies: release-without-renew is simulated by just
    # deleting its renewals — expire it via a fresh short lease
    store.release_lease(slot_lease_name(0), "mgr-0")
    before = dict(metrics.shard_adoptions.samples())
    faults.registry.arm("shard.adopt", count=1)
    mgrs[1].step()  # probe wins the lease, takeover fails, slot released
    lease = store.get(LEASES, slot_lease_name(0))
    assert not lease.holder_identity, "failed adoption must release the slot"
    assert 0 not in mgrs[1].owned_slots()
    failed = metrics.shard_adoptions.samples().get((("outcome", "failed"),), 0)
    assert failed == before.get((("outcome", "failed"),), 0) + 1
    mgrs[1].step()  # fault exhausted: the retry adopts for real
    assert 0 in mgrs[1].owned_slots()
    assert store.get(LEASES, slot_lease_name(0)).holder_identity == "mgr-1"
    assert caches[1].owned_slots == frozenset({0, 1})


def test_open_breaker_suppresses_adoption_and_releases(tmp_path):
    store = ClusterStore()
    picks = gangs_for_slots(2)
    seed_store(store, gangs=[picks[0][0], picks[1][0]])
    caches, mgrs = make_pair(store, tmp_path)
    store.release_lease(slot_lease_name(0), "mgr-0")
    for _ in range(3):
        mgrs[1]._breaker.record_failure()
    assert not mgrs[1]._breaker.allow()
    before = metrics.shard_adoptions.samples().get(
        (("outcome", "flap_suppressed"),), 0
    )
    mgrs[1].step()
    after = metrics.shard_adoptions.samples().get(
        (("outcome", "flap_suppressed"),), 0
    )
    assert after == before + 1
    assert 0 not in mgrs[1].owned_slots()
    assert not store.get(LEASES, slot_lease_name(0)).holder_identity


# -- handoff ------------------------------------------------------------------


def test_handoff_moves_slot_and_backlog_to_peer(tmp_path):
    store = ClusterStore()
    picks = gangs_for_slots(2, per_slot=2)
    seed_store(store, gangs=picks[0] + picks[1], members=2)
    caches, mgrs = make_pair(store, tmp_path)
    # adopt slot 1 onto mgr-0 first (simulating an earlier takeover)
    store.release_lease(slot_lease_name(1), "mgr-1")
    mgrs[1]._set_owned(set())
    mgrs[0].step()
    assert mgrs[0].owned_slots() == {0, 1}
    assert caches[0].owned_slots == frozenset({0, 1})
    # planned move back: drain + release, then the peer re-adopts
    assert mgrs[0].handoff(1)
    assert mgrs[0].owned_slots() == {0}
    assert not store.get(LEASES, slot_lease_name(1)).holder_identity
    completed = metrics.shard_handoffs.samples().get(
        (("outcome", "completed"),), 0
    )
    assert completed >= 1
    mgrs[1].step()
    assert mgrs[1].owned_slots() == {1}
    assert caches[1].owned_slots == frozenset({1})
    # slot-1 backlog follows the owner: mgr-1's cache tracks its pods
    slot1_pods = [
        p for p in store.list(PODS) if p.name.startswith(tuple(picks[1]))
    ]
    assert all(caches[1]._has_task(p) for p in slot1_pods)
    assert all(not caches[0]._has_task(p) for p in slot1_pods)


def test_injected_handoff_failure_keeps_slot_and_backlog(tmp_path):
    store = ClusterStore()
    picks = gangs_for_slots(2, per_slot=1)
    seed_store(store, gangs=[picks[0][0], picks[1][0]], members=2)
    caches, mgrs = make_pair(store, tmp_path)
    store.release_lease(slot_lease_name(1), "mgr-1")
    mgrs[1]._set_owned(set())
    mgrs[0].step()
    assert mgrs[0].owned_slots() == {0, 1}
    faults.registry.arm("shard.handoff", count=1)
    before = metrics.shard_handoffs.samples().get((("outcome", "aborted"),), 0)
    assert not mgrs[0].handoff(1)
    assert metrics.shard_handoffs.samples().get(
        (("outcome", "aborted"),), 0
    ) == before + 1
    # the slot is kept whole: lease still held, owned set restored, the
    # backlog still tracked
    assert mgrs[0].owned_slots() == {0, 1}
    assert store.get(LEASES, slot_lease_name(1)).holder_identity == "mgr-0"
    assert caches[0].owned_slots == frozenset({0, 1})
    slot1_pods = [
        p for p in store.list(PODS) if p.name.startswith(picks[1][0])
    ]
    assert all(caches[0]._has_task(p) for p in slot1_pods)


def test_handoff_of_unowned_slot_is_refused(tmp_path):
    store = ClusterStore()
    seed_store(store)
    _, mgrs = make_pair(store, tmp_path)
    assert not mgrs[0].handoff(1)


# -- reclaim protocol ---------------------------------------------------------


def test_reclaim_request_hands_adopted_slot_back(tmp_path):
    store = ClusterStore()
    picks = gangs_for_slots(2)
    seed_store(store, gangs=[picks[0][0], picks[1][0]])
    caches, mgrs = make_pair(store, tmp_path)
    # shard 1 died; shard 0 adopted its slot
    store.release_lease(slot_lease_name(1), "mgr-1")
    mgrs[1]._set_owned(set())
    mgrs[0].step()
    assert mgrs[0].owned_slots() == {0, 1}
    # the reborn shard 1 requests its primary back (what start() does
    # when it finds the slot held by a survivor)
    store.try_acquire_lease(reclaim_lease_name(1), "mgr-1-reborn", 60.0)
    mgrs[0].step()  # _honor_reclaims -> graceful handoff
    assert mgrs[0].owned_slots() == {0}
    assert not store.get(LEASES, slot_lease_name(1)).holder_identity
    lease = store.try_acquire_lease(slot_lease_name(1), "mgr-1-reborn", 60.0)
    assert lease.holder_identity == "mgr-1-reborn"


def test_stale_reclaim_request_is_ignored(tmp_path):
    store = ClusterStore()
    seed_store(store)
    _, mgrs = make_pair(store, tmp_path)
    store.release_lease(slot_lease_name(1), "mgr-1")
    mgrs[1]._set_owned(set())
    mgrs[0].step()
    assert mgrs[0].owned_slots() == {0, 1}
    # an expired reclaim (the joiner died again) must not trigger a move
    store.try_acquire_lease(
        reclaim_lease_name(1), "mgr-1-reborn", 0.5, now=1.0
    )
    mgrs[0].step()
    assert mgrs[0].owned_slots() == {0, 1}


def test_start_and_stop_release_primary(tmp_path):
    store = ClusterStore()
    seed_store(store)
    cache = FederatedCache(store, shard=0, shards=2, shard_key="gang")
    mgr = ShardSlotManager(
        store, cache, identity="starter",
        lease_s=60.0, renew_s=30.0, adopt=False,
        journal_dir=str(tmp_path), grace_s=0.0, rebalance=0,
    )
    assert mgr.start(deadline_s=5.0)
    assert mgr.owned_slots() == {0}
    assert store.get(LEASES, slot_lease_name(0)).holder_identity == "starter"
    mgr.stop(release=True)
    assert not store.get(LEASES, slot_lease_name(0)).holder_identity


# -- the owned-slot callback ---------------------------------------------------


def test_on_owned_slots_changed_is_a_noop_in_periodic_mode(tmp_path):
    from kube_batch_tpu_torch.scheduler import Scheduler

    store = ClusterStore()
    seed_store(store)
    cache = SchedulerCache(store)
    sched = Scheduler(cache, schedule_period=1000.0)
    # periodic mode: the next full cycle re-snapshots the widened mirror
    sched.on_owned_slots_changed({"default/ga"}, {"default/gb"})
    sched.on_owned_slots_changed(set())
    assert sched._stream_trigger is None


def test_on_owned_slots_changed_seeds_and_prunes_stream_trigger(tmp_path):
    from kube_batch_tpu_torch.scheduler import Scheduler
    from kube_batch_tpu_torch.streaming import StreamTrigger

    store = ClusterStore()
    seed_store(store)
    cache = SchedulerCache(store)
    sched = Scheduler(cache, schedule_period=1000.0)
    # periodic mode: no trigger, the call is a no-op
    sched.on_owned_slots_changed({"default/ga"}, {"default/gb"})
    trigger = StreamTrigger()
    sched._stream_trigger = trigger
    with trigger._lock:
        trigger._gangs.add("default/gb")
    sched.on_owned_slots_changed({"default/ga"}, {"default/gb"})
    with trigger._lock:
        backlog = set(trigger._gangs)
    assert backlog == {"default/ga"}  # adopted seeded, removed pruned
    assert trigger._event.is_set()


def _handoff_under_streaming(m, tmp_path) -> dict:
    """The JAX suite's handoff-under-streaming case on one package's
    modules ``m``; returns the final placements."""
    store = m.ClusterStore()
    picks = m.gangs_for_slots(2, per_slot=1)
    m.seed_store(store, nodes=2, gangs=[picks[1][0]], members=2)
    bind_counts: dict[str, int] = {}

    def on_update(old, new):
        if not old.node_name and new.node_name:
            key = f"{new.namespace}/{new.name}"
            bind_counts[key] = bind_counts.get(key, 0) + 1

    store.add_event_handler(PODS, m.EventHandler(on_update=on_update))
    caches, mgrs = m.make_pair(store, tmp_path)
    receiver = caches[1]  # slot 1's gang will be handed TO shard 1...
    # ...but first shard 0 adopted it (shard 1 restarted empty)
    store.release_lease(slot_lease_name(1), "mgr-1")
    mgrs[1]._set_owned(set())
    mgrs[0].step()
    assert mgrs[0].owned_slots() == {0, 1}
    assert not receiver._has_task(next(iter(store.list(PODS))))
    conf = tmp_path / f"conf-{m.name}.yaml"
    conf.write_text(m.conf)
    sched = m.Scheduler(receiver, scheduler_conf=str(conf), schedule_period=1000.0)
    trigger, state = m.StreamTrigger(), m.StreamState()
    sched._stream_trigger = trigger
    sched._stream_state = state
    trigger.attach()
    try:
        sched.run_once()  # adopt the resident table (nothing to bind yet)
        mgrs[1]._on_owned_change = lambda adopted, removed: sched.on_owned_slots_changed(adopted, removed)
        # the planned move: mgr-0 drains and releases, mgr-1 re-adopts; the
        # owned-change callback seeds the gang into the trigger
        assert mgrs[0].handoff(1)
        mgrs[1].step()
        assert mgrs[1].owned_slots() == {1}
        work = trigger.drain()
        assert f"default/{picks[1][0]}" in work.gangs
        assert sched.run_micro(work)
    finally:
        trigger.detach()
    placed = {f"{p.namespace}/{p.name}": p.node_name for p in store.list(PODS)}
    assert all(placed.values()), placed
    assert sorted(bind_counts.values()) == [1] * len(placed)
    assert m.fsck(store, shard_key="gang") == []
    return placed


def test_handoff_parity_under_streaming_micro_cycles(tmp_path):
    """A graceful handoff while the receiving scheduler runs streaming
    micro-cycles: the adopted gang keys are seeded into the trigger, the
    next micro drain binds exactly the handed-off backlog, the world ends
    exactly-once and fsck-clean, and at the JAX package's placements."""
    from types import SimpleNamespace

    import test_resharding as jax_side
    from kube_batch_tpu import cache as jax_cache
    from kube_batch_tpu import federation as jax_federation
    from kube_batch_tpu import scheduler as jax_scheduler
    from kube_batch_tpu import streaming as jax_streaming
    from kube_batch_tpu_torch import streaming
    from kube_batch_tpu_torch.cache import EventHandler
    from kube_batch_tpu_torch.scheduler import Scheduler

    port = SimpleNamespace(
        name="port", ClusterStore=ClusterStore, EventHandler=EventHandler, Scheduler=Scheduler,
        StreamTrigger=streaming.StreamTrigger, StreamState=streaming.StreamState, seed_store=seed_store,
        make_pair=make_pair, gangs_for_slots=gangs_for_slots, fsck=fsck,
        conf=streaming.smoke_conf(True, "cpu"),
    )
    jax = SimpleNamespace(
        name="jax", ClusterStore=jax_cache.ClusterStore, EventHandler=jax_cache.EventHandler,
        Scheduler=jax_scheduler.Scheduler, StreamTrigger=jax_streaming.StreamTrigger,
        StreamState=jax_streaming.StreamState, seed_store=jax_side.seed_store, make_pair=jax_side.make_pair,
        gangs_for_slots=jax_side.gangs_for_slots, fsck=jax_federation.fsck,
        conf=jax_streaming.SMOKE_CONF.format(streaming="true"),
    )
    assert _handoff_under_streaming(port, tmp_path) == _handoff_under_streaming(jax, tmp_path)


# -- journals -----------------------------------------------------------------


def test_adoption_reconciles_dead_shards_journal(tmp_path):
    """Orphaned intents in the dead owner's shard WAL are re-driven by
    the adopter BEFORE the backlog is rescheduled: the journaled
    placement lands exactly once even though the dead shard never
    dispatched it."""
    store = ClusterStore()
    picks = gangs_for_slots(2)
    seed_store(store, gangs=[picks[0][0], picks[1][0]], members=2)
    caches, mgrs = make_pair(store, tmp_path)
    # the dead shard journaled a gang's intents but never dispatched
    dead_slot = 0
    gang = picks[dead_slot][0]
    wal = WriteIntentJournal(shard_journal_path(str(tmp_path), dead_slot))
    entries = [
        (job_key("default", gang), f"default/{gang}-p{m}", "n0")
        for m in range(2)
    ]
    wal.append_intents("bind", entries, cycle=1, trace=None)
    wal.close()
    store.release_lease(slot_lease_name(dead_slot), "mgr-0")
    mgrs[0]._set_owned(set())
    mgrs[1].step()  # adoption runs reconcile_journal against the WAL
    assert dead_slot in mgrs[1].owned_slots()
    for m in range(2):
        pod = store.get_pod("default", f"{gang}-p{m}")
        assert pod.node_name == "n0", "journaled intent was not re-driven"
    orphans = WriteIntentJournal.replay(
        shard_journal_path(str(tmp_path), dead_slot)
    ).orphans
    assert orphans == []
    assert fsck(store, shard_key="gang") == []


# -- lease verbs over HTTP ----------------------------------------------------


@pytest.fixture()
def arbiter(tmp_path):
    from kube_batch_tpu_torch.federation import write_conf
    from kube_batch_tpu_torch.server import SchedulerServer

    srv = SchedulerServer(
        scheduler_name="store-arbiter", listen_address="127.0.0.1:0",
        scheduler_conf=write_conf("cpu", directory=str(tmp_path)),
        schedule_period=60.0,
    )
    srv.start()
    try:
        yield srv
    finally:
        srv.stop()


def test_loopback_lease_verbs_round_trip(arbiter):
    """Slot leases work over the wire: a remote shard's try-acquire,
    renew-as-holder, steal-refused, release, and re-acquire all route
    through the arbiter's store."""
    from kube_batch_tpu_torch.cache import LoopbackBackend

    backend = LoopbackBackend(f"http://127.0.0.1:{arbiter.listen_port}")
    name = slot_lease_name(0)
    lease = backend.try_acquire_lease(name, "remote-a", lease_duration=60.0)
    assert lease.holder_identity == "remote-a"
    # renewal by the holder keeps it; a live steal attempt is refused
    assert backend.try_acquire_lease(name, "remote-a", 60.0).holder_identity == "remote-a"
    assert backend.try_acquire_lease(name, "remote-b", 60.0).holder_identity == "remote-a"
    # the arbiter's own store agrees
    assert arbiter.store.get(LEASES, name).holder_identity == "remote-a"
    released = backend.release_lease(name, "remote-a")
    assert not released.holder_identity
    assert backend.try_acquire_lease(name, "remote-b", 60.0).holder_identity == "remote-b"


# -- metrics / observability --------------------------------------------------


def test_ownership_gauges_track_owned_set(tmp_path):
    store = ClusterStore()
    seed_store(store)
    _, mgrs = make_pair(store, tmp_path)
    mgrs[0]._publish_owned({0})
    assert metrics.shard_slots_owned.samples().get((), 0) == 1
    per_slot = metrics.shard_slot_owned.samples()
    assert per_slot.get((("slot", "0"),)) == 1.0
    assert per_slot.get((("slot", "1"),)) == 0.0
    mgrs[0]._publish_owned({0, 1})
    assert metrics.shard_slots_owned.samples().get((), 0) == 2
    assert metrics.shard_slot_owned.samples().get((("slot", "1"),)) == 1.0


def test_resharding_metrics_in_exposition():
    text = metrics.render_prometheus_text()
    for family in (
        "kube_batch_tpu_shard_slots_owned",
        "kube_batch_tpu_shard_slot_owned",
        "kube_batch_tpu_shard_adoptions_total",
        "kube_batch_tpu_shard_handoffs_total",
        "kube_batch_tpu_shard_takeover_seconds",
    ):
        assert family in text, family


# -- held against the JAX package -------------------------------------------

import kube_batch_tpu.federation as jax_federation  # noqa: E402
from kube_batch_tpu import faults as jax_faults  # noqa: E402
from kube_batch_tpu import testing as jax_testing  # noqa: E402
from kube_batch_tpu.api.job_info import job_key as jax_job_key  # noqa: E402
from kube_batch_tpu.cache import ClusterStore as JaxClusterStore  # noqa: E402
from kube_batch_tpu.recovery import WriteIntentJournal as JaxWriteIntentJournal  # noqa: E402

import kube_batch_tpu_torch.federation as torch_federation  # noqa: E402
from kube_batch_tpu_torch import testing as torch_testing  # noqa: E402

PACKAGES = {
    "port": (torch_federation, ClusterStore, torch_testing, WriteIntentJournal, faults, job_key),
    "jax": (jax_federation, JaxClusterStore, jax_testing, JaxWriteIntentJournal, jax_faults,
            jax_job_key),
}


def _pair_in(pkg: str, tmp_path, gangs, members=2):
    fed, store_cls, t, _journal, _faults, _key = PACKAGES[pkg]
    store = store_cls()
    store.create_queue(t.build_queue("default"))
    for i in range(2):
        store.create_node(
            t.build_node(f"n{i}", t.build_resource_list(cpu=16, memory="16Gi", pods=64))
        )
    for g in gangs:
        store.create_pod_group(t.build_pod_group(g, min_member=members))
        for m in range(members):
            store.create_pod(
                t.build_pod(
                    name=f"{g}-p{m}", group_name=g,
                    req=t.build_resource_list(cpu=1, memory="512Mi"),
                )
            )
    caches, mgrs = [], []
    for i in range(2):
        cache = fed.FederatedCache(store, shard=i, shards=2, shard_key="gang")
        mgr = fed.ShardSlotManager(
            store, cache, identity=f"mgr-{i}",
            lease_s=60.0, renew_s=1.0, adopt=True,
            journal_dir=str(tmp_path), grace_s=0.0, rebalance=0,
        )
        store.try_acquire_lease(fed.slot_lease_name(i), mgr.identity, mgr.lease_s)
        mgr._set_owned({i})
        caches.append(cache)
        mgrs.append(mgr)
    return fed, store, caches, mgrs


def _outcome(fed, store, caches, mgrs) -> dict:
    return {
        "owned": [sorted(m.owned_slots()) for m in mgrs],
        "cache_owned": [sorted(c.owned_slots) for c in caches],
        "holders": [
            store.get(LEASES, fed.slot_lease_name(i)).holder_identity for i in range(2)
        ],
        "tracked": [
            sorted(p.name for p in store.list(PODS) if c._has_task(p)) for c in caches
        ],
        "placements": sorted((p.name, p.node_name) for p in store.list(PODS)),
        "fsck": fed.fsck(store, shard_key="gang"),
    }


def _drill_adopt_fails_once(pkg, fed, store, caches, mgrs, flt):
    store.release_lease(fed.slot_lease_name(0), "mgr-0")
    flt.registry.arm("shard.adopt", count=1)
    mgrs[1].step()
    first = sorted(mgrs[1].owned_slots())
    mgrs[1].step()
    return {"after_failure": first}


def _drill_handoff(pkg, fed, store, caches, mgrs, flt):
    store.release_lease(fed.slot_lease_name(1), "mgr-1")
    mgrs[1]._set_owned(set())
    mgrs[0].step()
    moved = mgrs[0].handoff(1)
    mgrs[1].step()
    return {"handed_off": moved}


def _drill_handoff_fails(pkg, fed, store, caches, mgrs, flt):
    store.release_lease(fed.slot_lease_name(1), "mgr-1")
    mgrs[1]._set_owned(set())
    mgrs[0].step()
    flt.registry.arm("shard.handoff", count=1)
    return {"handed_off": mgrs[0].handoff(1)}


def _drill_lease_flap(pkg, fed, store, caches, mgrs, flt):
    before = store.get(LEASES, fed.slot_lease_name(0)).lease_transitions
    flt.registry.arm("shard.lease_flap", count=1)
    mgrs[0].step()
    mgrs[1].step()
    mgrs[0].step()
    after = store.get(LEASES, fed.slot_lease_name(0)).lease_transitions
    return {"transitions": after - before}


def _drill_reclaim(pkg, fed, store, caches, mgrs, flt):
    store.release_lease(fed.slot_lease_name(1), "mgr-1")
    mgrs[1]._set_owned(set())
    mgrs[0].step()
    store.try_acquire_lease(fed.reclaim_lease_name(1), "mgr-1-reborn", 60.0)
    mgrs[0].step()
    return {}


DRILLS = {
    "adopt_fails_once": _drill_adopt_fails_once,
    "handoff": _drill_handoff,
    "handoff_fails": _drill_handoff_fails,
    "lease_flap": _drill_lease_flap,
    "reclaim": _drill_reclaim,
}


@pytest.mark.parametrize("drill", sorted(DRILLS))
def test_resharding_drill_ends_as_in_the_jax_package(tmp_path, drill):
    """Each drill, on the same two-shard world in both packages, ends with
    the same owned slots, lease holders, tracked backlog, placements and
    fsck report."""
    picks = gangs_for_slots(2, per_slot=2)
    gangs = picks[0] + picks[1]
    outcomes = {}
    for pkg in ("port", "jax"):
        flt = PACKAGES[pkg][4]
        flt.registry.reset()
        d = tmp_path / pkg
        d.mkdir()
        fed, store, caches, mgrs = _pair_in(pkg, d, gangs)
        try:
            extra = DRILLS[drill](pkg, fed, store, caches, mgrs, flt)
        finally:
            flt.registry.reset()
        outcomes[pkg] = {**_outcome(fed, store, caches, mgrs), **extra}
    assert outcomes["port"] == outcomes["jax"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_adoption_reconciles_the_other_packages_journal(tmp_path, writer):
    """The dead shard's WAL written by one package is re-driven by the
    other package's adoption: the journaled placement lands exactly once
    and the journal holds no orphan after."""
    adopter = "port" if writer == "jax" else "jax"
    picks = gangs_for_slots(2)
    gangs = [picks[0][0], picks[1][0]]
    fed, store, caches, mgrs = _pair_in(adopter, tmp_path, gangs)
    _fed_w, _store_w, _t_w, journal_cls, _f_w, key_fn = PACKAGES[writer]
    dead_slot = 0
    gang = picks[dead_slot][0]
    path = fed.shard_journal_path(str(tmp_path), dead_slot)
    wal = journal_cls(path)
    wal.append_intents(
        "bind",
        [(key_fn("default", gang), f"default/{gang}-p{m}", "n0") for m in range(2)],
        cycle=1, trace=None,
    )
    wal.close()
    store.release_lease(fed.slot_lease_name(dead_slot), "mgr-0")
    mgrs[0]._set_owned(set())
    mgrs[1].step()
    assert dead_slot in mgrs[1].owned_slots()
    for m in range(2):
        assert store.get_pod("default", f"{gang}-p{m}").node_name == "n0"
    assert journal_cls.replay(path).orphans == []
    assert fed.fsck(store, shard_key="gang") == []


def test_kill_drill_ends_as_in_the_jax_package():
    """The kill-and-adopt drill in both packages: the same victim slot, a
    single adopter, every pod bound exactly once, union parity and a
    clean fsck in each (which survivor adopts, and when, is a race)."""
    keys = (
        "ok", "shards", "pods", "bound", "victim_slot", "victim_gangs", "double_owned",
        "exactly_once", "double_binds", "fsck_violations", "union_parity",
    )
    port = torch_federation.smoke_kill_one(shards=4, gangs=16, members=2, device="cpu")
    jax = jax_federation.smoke_kill_one(shards=4, gangs=16, members=2)
    assert {k: port[k] for k in keys} == {k: jax[k] for k in keys}
    assert port["ok"], port
