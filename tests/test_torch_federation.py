"""The port's sharded multi-scheduler federation, case for case with
tests/test_federation.py, then held against the JAX package: the store's
conditional-write transactions, the ``/backend/v1/`` wire path
(LoopbackBackend against a real SchedulerServer), shard-key helpers,
lease edge cases under real concurrency, and the conflict chaos drill —
``store.conflict`` + ``federation.partition`` armed, two schedulers on
one store, one of them killed mid-conflict, zero lost and zero
duplicate binds after reconciliation.

The parity cases at the end run the same seeded worlds through the JAX
package and the port: ``shard_index`` over 10,000 keys in every shard-key
mode, one federated shard bind for bind against the JAX ``FederatedCache``,
N = 2 and 4 shards on a small world of the scale-out row's shape (the
same bound set, exactly once, ``fsck`` clean), and four shard threads'
encodes through the shared encode cache against cold encodes. Every
scheduler here solves on the CPU (``device: cpu``); the tolerance is
exact, since placements are discrete.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import threading
import time
import zlib

import pytest

from kube_batch_tpu_torch import faults, metrics
from kube_batch_tpu_torch.api.job_info import job_key
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.apis import wire
from kube_batch_tpu_torch.apis.types import PodGroupPhase, PodPhase
from kube_batch_tpu_torch.cache import (
    BackendPartitioned,
    ClusterStore,
    EventHandler,
    LoopbackBackend,
    SchedulerCache,
    StaleWrite,
)
from kube_batch_tpu_torch.cache.cache import StoreBinder
from kube_batch_tpu_torch.cache.store import LEASES, NODES, PODS, POD_GROUPS, QUEUES
from kube_batch_tpu_torch.faults.mutation_detector import MutationDetector
from kube_batch_tpu_torch.federation import (
    SHARD_KEYS,
    FederatedCache,
    enabled,
    fsck,
    parse_shard_spec,
    shard_index,
    shard_key_mode,
    shard_key_of,
    write_conf,
)
from kube_batch_tpu_torch.recovery import WriteIntentJournal, reconcile_journal
from kube_batch_tpu_torch.server import SchedulerServer
from kube_batch_tpu_torch.testing import (
    build_node,
    build_pod,
    build_pod_group,
    build_queue,
    build_resource_list,
)
from kube_batch_tpu_torch.utils.locking import LockOrderWitness


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.registry.reset()
    faults.solver_ladder.reset()
    yield
    faults.registry.reset()
    faults.solver_ladder.reset()


def seed_store(store, nodes=1, cpu=16, gangs=(), members=3):
    if store.get(QUEUES, "default") is None:  # the server pre-seeds one
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


def bind_gang(cache, gang, node="n0"):
    """Dispatch every pending task of ``gang`` as one bulk bind (the
    federation unit: one gang = one optimistic transaction)."""
    uid = job_key("default", gang)
    with cache._mutex:
        job = cache.jobs.get(uid)
        pending = (
            list(job.task_status_index.get(TaskStatus.PENDING, {}).values())
            if job is not None
            else []
        )
    assert pending, f"gang {gang} has no pending tasks in this cache"
    cache.bind_many([(t, node) for t in pending])


def count_bind_events(store):
    """pod key -> number of unbound->bound transitions (the
    duplicate-bind detector of the acceptance criterion)."""
    counts: dict[str, int] = {}
    lock = threading.Lock()

    def on_update(old, new):
        if not old.node_name and new.node_name:
            with lock:
                key = f"{new.namespace}/{new.name}"
                counts[key] = counts.get(key, 0) + 1

    store.add_event_handler(PODS, EventHandler(on_update=on_update))
    return counts


# -- conditional store writes ------------------------------------------------


def test_conditional_bind_commits_and_bumps_placement_version():
    store = ClusterStore()
    seed_store(store, gangs=("g0",), members=2)
    v = store.version
    assert store.placement_version("n0") == 0
    applied = store.conditional_bind_many([("default", "g0-p0", "n0")], v)
    assert [p.name for p in applied] == ["g0-p0"]
    assert store.get_pod("default", "g0-p0").node_name == "n0"
    assert store.placement_version("n0") > v
    assert store.version > v


def test_stale_node_conflict_is_typed():
    store = ClusterStore()
    seed_store(store, gangs=("g0",), members=2)
    v = store.version  # both schedulers snapshot here
    store.conditional_bind_many([("default", "g0-p0", "n0")], v)
    with pytest.raises(StaleWrite) as ei:
        store.conditional_bind_many([("default", "g0-p1", "n0")], v)
    e = ei.value
    assert (e.kind, e.key, e.reason) == (NODES, "n0", "stale_node")
    assert e.expected == v and e.actual > v
    assert f"stale write on {NODES} 'n0': stale_node" in str(e)
    # the loser's pod is untouched — a rejected gang needs no rollback
    assert store.get_pod("default", "g0-p1").node_name == ""
    # refresh-and-retry wins (the _do_bind_gang loop's contract)
    store.conditional_bind_many([("default", "g0-p1", "n0")], store.version)
    assert store.get_pod("default", "g0-p1").node_name == "n0"


def test_same_host_rebind_is_idempotent_skip_not_conflict():
    """The journal re-dispatch case: re-sending a landed bind (even with
    an ancient snapshot version) must skip, not conflict."""
    store = ClusterStore()
    seed_store(store, gangs=("g0",), members=1)
    v = store.version
    store.conditional_bind_many([("default", "g0-p0", "n0")], v)
    applied = store.conditional_bind_many([("default", "g0-p0", "n0")], v)
    assert applied == []


def test_already_bound_elsewhere_missing_and_no_node_reject():
    store = ClusterStore()
    seed_store(store, nodes=2, gangs=("g0",), members=1)
    store.conditional_bind_many([("default", "g0-p0", "n0")], store.version)
    with pytest.raises(StaleWrite) as ei:
        store.conditional_bind_many([("default", "g0-p0", "n1")], store.version)
    assert ei.value.reason == "already_bound"
    with pytest.raises(StaleWrite) as ei:
        store.conditional_bind_many([("default", "ghost", "n0")], store.version)
    assert ei.value.reason == "missing"
    store.create_pod(build_pod(name="solo", req=build_resource_list(cpu=1)))
    with pytest.raises(StaleWrite) as ei:
        store.conditional_bind_many([("default", "solo", "n9")], store.version)
    assert ei.value.reason == "no_node"


def test_capacity_rejection_is_all_or_nothing():
    """Store-side admission: a gang that no longer fits rejects whole —
    no member is applied, the store version does not move."""
    store = ClusterStore()
    seed_store(store, cpu=2, gangs=("g0",), members=3)  # 3x1cpu onto 2cpu
    v = store.version
    with pytest.raises(StaleWrite) as ei:
        store.conditional_bind_many(
            [("default", f"g0-p{m}", "n0") for m in range(3)], v
        )
    assert ei.value.reason == "capacity"
    assert store.version == v
    assert all(not p.node_name for p in store.list(PODS))


def test_conditional_evict_stale_then_fresh_then_idempotent():
    store = ClusterStore()
    seed_store(store, gangs=("g0",), members=2)
    stale = store.version
    store.conditional_bind_many([("default", "g0-p0", "n0")], stale)
    # the preemption plan was solved before that placement: rejected
    with pytest.raises(StaleWrite) as ei:
        store.conditional_evict("default", "g0-p0", stale)
    assert ei.value.reason == "stale_node"
    assert store.conditional_evict("default", "g0-p0", store.version) is not None
    assert store.get_pod("default", "g0-p0") is None
    # journal re-dispatch of a landed evict: idempotent None
    assert store.conditional_evict("default", "g0-p0", store.version) is None


def test_store_conflict_fault_injects_typed_conflict():
    store = ClusterStore()
    seed_store(store, gangs=("g0",), members=1)
    faults.registry.arm("store.conflict", count=1)
    with pytest.raises(StaleWrite) as ei:
        store.conditional_bind_many([("default", "g0-p0", "n0")], store.version)
    assert ei.value.reason == "injected"
    # count exhausted: the retry lands
    store.conditional_bind_many([("default", "g0-p0", "n0")], store.version)
    assert store.get_pod("default", "g0-p0").node_name == "n0"


# -- wire codec --------------------------------------------------------------


def test_wire_codec_round_trips_through_json():
    pod = build_pod(
        name="w0", group_name="gw", req=build_resource_list(cpu=2, memory="1Gi"),
        labels={"tier": "batch"}, node_name="n3", phase=PodPhase.RUNNING,
    )
    node = build_node("n3", build_resource_list(cpu=8, memory="8Gi", pods=16),
                      labels={"zone": "a"})
    pg = build_pod_group("gw", min_member=4)
    q = build_queue("default", weight=3)
    for kind, obj in ((PODS, pod), (NODES, node), (POD_GROUPS, pg), (QUEUES, q)):
        data = json.loads(json.dumps(wire.encode_kind(kind, obj)))
        assert wire.decode_kind(kind, data) == obj


# -- shard keys --------------------------------------------------------------


def test_parse_shard_spec():
    assert parse_shard_spec("1/4") == (1, 4)
    assert parse_shard_spec(" 0/1 ") == (0, 1)
    assert parse_shard_spec("1") == (0, 1)  # bare flag: no partition
    for bad in ("4/4", "-1/2", "a/b", "1/0"):
        with pytest.raises(ValueError):
            parse_shard_spec(bad)


def test_shard_index_is_crc32_stable():
    # hash() is per-process salted; the bucket must be crc32 so every
    # scheduler process agrees on the partition
    assert shard_index("default/ga", 4) == zlib.crc32(b"default/ga") % 4
    assert shard_index("anything", 1) == 0


def test_all_shard_key_modes_are_gang_stable():
    store = ClusterStore()
    store.create_queue(build_queue("qx"))
    store.create_pod_group(build_pod_group("g1", queue="qx", min_member=2))
    pods = [build_pod(name=f"g1-p{m}", group_name="g1") for m in range(3)]
    for mode in SHARD_KEYS:
        keys = {shard_key_of(p, store, mode) for p in pods}
        assert len(keys) == 1, f"mode {mode} split a gang: {keys}"
    assert shard_key_of(pods[0], store, "queue") == "qx"
    assert shard_key_of(pods[0], store, "namespace") == "default"
    # a pod whose group has not arrived falls back to its gang key
    orphan = build_pod(name="solo", group_name="never-created")
    assert shard_key_of(orphan, store, "queue") == job_key(
        "default", "never-created"
    )


def test_federated_cache_filter_shards_only_unbound_pending():
    store = ClusterStore()
    seed_store(store)
    cache = FederatedCache(store, shard=0, shards=2, shard_key="gang")
    # "ga" and "gm" land in opposite crc32 buckets; pick whichever is
    # shard 0 as "mine" so the test is robust to bucket reassignment
    p_ga = build_pod(name="mine", group_name="ga")
    p_gm = build_pod(name="other", group_name="gm")
    assert shard_index(job_key("default", "ga"), 2) != shard_index(
        job_key("default", "gm"), 2
    )
    mine, other = (
        (p_ga, p_gm)
        if shard_index(job_key("default", "ga"), 2) == 0
        else (p_gm, p_ga)
    )
    assert cache._pod_filter(mine)
    assert not cache._pod_filter(other)
    # the other shard's pod becomes visible the moment it holds capacity
    # (bound but still phase-Pending) — the conflict-livelock guard
    assert cache._pod_filter(dataclasses.replace(other, node_name="n0"))
    assert cache._pod_filter(dataclasses.replace(other, phase=PodPhase.RUNNING,
                                                 node_name="n0"))
    with pytest.raises(ValueError):
        FederatedCache(store, shard=2, shards=2)
    with pytest.raises(ValueError):
        FederatedCache(store, shard=0, shards=2, shard_key="bogus")


def test_env_surface(monkeypatch):
    monkeypatch.delenv("KBT_FEDERATION", raising=False)
    assert not enabled()
    monkeypatch.setenv("KBT_FEDERATION", "0")
    assert not enabled()
    monkeypatch.setenv("KBT_FEDERATION", "1/2")
    assert enabled()
    assert SchedulerCache(ClusterStore())._conditional_binds
    monkeypatch.setenv("KBT_SHARD_KEY", "gang")
    assert shard_key_mode() == "gang"
    monkeypatch.setenv("KBT_SHARD_KEY", "bogus")
    assert shard_key_mode() == "queue"  # loud fallback, never a crash
    monkeypatch.setenv("KBT_CONFLICT_MAX_RETRIES", "7")
    assert SchedulerCache(ClusterStore())._conflict_max_retries == 7
    monkeypatch.setenv("KBT_CONFLICT_MAX_RETRIES", "lots")
    assert SchedulerCache(ClusterStore())._conflict_max_retries == 3


def test_federation_metrics_registered_in_exposition():
    metrics.register_federation_conflict("clean")
    metrics.register_bind_retry()
    metrics.observe_store_backend_rtt("list", 0.001)
    text = metrics.render_prometheus_text()
    for name in (
        "federation_conflicts_total",
        "bind_retries_total",
        "store_backend_rtt_seconds",
    ):
        assert name in text


# -- lease edge cases (satellite: leader-election arbiter) -------------------


def test_lease_concurrent_two_identities_witnessed():
    """Two identities hammer try_acquire/release concurrently under a
    LockOrderWitness. Safety: the holder NEVER transfers directly
    between two live identities — every handoff passes through the
    released sentinel (duration is 30s, so expiry can't arbitrate)."""
    store = ClusterStore()
    witness = LockOrderWitness()
    store._lock = witness.wrap("store._lock", store._lock)
    store._dispatch_lock = witness.wrap(
        "store._dispatch_lock", store._dispatch_lock
    )
    transitions: list[tuple[str, str]] = []
    store.add_event_handler(
        LEASES,
        EventHandler(
            on_update=lambda old, new: transitions.append(
                (old.holder_identity, new.holder_identity)
            )
        ),
    )
    acquired = {"a": 0, "b": 0}
    errors: list[BaseException] = []

    def worker(ident: str) -> None:
        try:
            for _ in range(40):
                lease = store.try_acquire_lease("kb-fed", ident, 30.0)
                if lease.holder_identity == ident:
                    acquired[ident] += 1
                    store.release_lease("kb-fed", ident)
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors
    assert witness.violations == []
    assert sum(acquired.values()) >= 1
    final = store.get(LEASES, "kb-fed")
    assert final.holder_identity in ("", "a", "b")
    for old, new in transitions:
        if old and new:
            assert old == new, f"live steal {old}->{new} without release"


def test_lease_released_sentinel_lets_waiter_take_over_immediately():
    store = ClusterStore()
    a = store.try_acquire_lease("kb", "a", 15.0, now=100.0)
    assert (a.holder_identity, a.lease_transitions) == ("a", 0)
    # fresh and held by a: b's attempt mutates nothing, not even version
    v = store.version
    assert store.try_acquire_lease("kb", "b", 15.0, now=101.0).holder_identity == "a"
    assert store.version == v
    released = store.release_lease("kb", "a")
    assert released.holder_identity == ""
    assert store.version == v + 1
    # third waiter: the "" sentinel is takeable NOW, well inside the
    # original 15s window — no expiry wait (ReleaseOnCancel behavior)
    c = store.try_acquire_lease("kb", "c", 15.0, now=102.0)
    assert (c.holder_identity, c.lease_transitions) == ("c", 1)
    assert c.acquire_time == 102.0
    # and c now holds it fresh against everyone else
    assert store.try_acquire_lease("kb", "b", 15.0, now=103.0).holder_identity == "c"


def test_lease_empty_identity_rejected_both_ways():
    store = ClusterStore()
    with pytest.raises(ValueError):
        store.try_acquire_lease("kb", "", 15.0)
    with pytest.raises(ValueError):
        store.release_lease("kb", "")


# -- LoopbackBackend over a live server --------------------------------------


@pytest.fixture()
def cpu_conf(tmp_path):
    """The default pipeline with torch_allocate on the CPU."""
    path = write_conf("cpu", directory=str(tmp_path))
    yield path
    os.unlink(path)


@pytest.fixture()
def arbiter(cpu_conf):
    """A real SchedulerServer acting as the store process: its own loop
    is idled by a scheduler name no workload pod carries."""
    srv = SchedulerServer(
        scheduler_name="store-arbiter", listen_address="127.0.0.1:0",
        scheduler_conf=cpu_conf, schedule_period=60.0,
    )
    srv.start()
    try:
        yield srv
    finally:
        srv.stop()


def _backend_for(arbiter) -> LoopbackBackend:
    return LoopbackBackend(f"http://127.0.0.1:{arbiter.listen_port}")


def test_backend_list_watch_mirror(arbiter):
    seed_store(arbiter.store, gangs=("g0",), members=1)
    backend = _backend_for(arbiter)
    events: list[tuple] = []
    backend.add_event_handler(
        PODS,
        EventHandler(
            on_add=lambda obj: events.append(("add", obj.name)),
            on_update=lambda old, new: events.append(("update", new.name)),
            on_delete=lambda obj: events.append(("delete", obj.name)),
        ),
    )
    # subscription listed + replayed the current world, full fidelity
    assert events == [("add", "g0-p0")]
    assert backend.get_pod("default", "g0-p0") == arbiter.store.get_pod(
        "default", "g0-p0"
    )
    arbiter.store.create_pod(build_pod(name="late", req=build_resource_list(cpu=1)))
    arbiter.store.conditional_bind_many(
        [("default", "g0-p0", "n0")], arbiter.store.version
    )
    assert backend.pump() >= 2
    assert backend.get_pod("default", "g0-p0").node_name == "n0"
    assert {p.name for p in backend.list(PODS)} == {"g0-p0", "late"}
    arbiter.store.delete_pod("default", "late")
    backend.pump()
    assert ("delete", "late") in events
    assert backend.get_pod("default", "late") is None


def test_backend_conditional_writes_and_409_reconstruction(arbiter):
    seed_store(arbiter.store, gangs=("g0",), members=2)
    backend = _backend_for(arbiter)
    v = backend.version
    assert v == arbiter.store.version
    assert backend.conditional_bind_many([("default", "g0-p0", "n0")], v) == 1
    # the server's typed 409 comes back as the SAME StaleWrite the
    # in-process store raises — conflict dispatch is backend-agnostic
    with pytest.raises(StaleWrite) as ei:
        backend.conditional_bind_many([("default", "g0-p1", "n0")], v)
    e = ei.value
    assert (e.kind, e.key, e.reason) == (NODES, "n0", "stale_node")
    assert e.expected == v and e.actual > v
    assert backend.conditional_bind_many(
        [("default", "g0-p1", "n0")], backend.version
    ) == 1
    assert backend.conditional_evict(
        "default", "g0-p1", backend.version
    ) is True
    assert backend.conditional_evict(
        "default", "g0-p1", backend.version
    ) is False  # idempotent re-dispatch
    assert arbiter.store.get_pod("default", "g0-p1") is None


def test_backend_crud_writes_land_in_store(arbiter):
    seed_store(arbiter.store)
    backend = _backend_for(arbiter)
    backend.create_pod(build_pod(name="px", req=build_resource_list(cpu=1)))
    assert arbiter.store.get_pod("default", "px") is not None
    backend.update_pod(
        dataclasses.replace(arbiter.store.get_pod("default", "px"),
                            phase=PodPhase.RUNNING)
    )
    assert arbiter.store.get_pod("default", "px").phase == PodPhase.RUNNING
    backend.delete_pod("default", "px")
    assert arbiter.store.get_pod("default", "px") is None
    backend.create(POD_GROUPS, build_pod_group("gX", min_member=2))
    assert arbiter.store.get(POD_GROUPS, "default/gX").spec.min_member == 2
    backend.update_pod_group(build_pod_group("gX", min_member=5))
    assert arbiter.store.get(POD_GROUPS, "default/gX").spec.min_member == 5


def test_backend_watch_410_heals_by_relist(arbiter):
    seed_store(arbiter.store, gangs=("g0",), members=1)
    backend = _backend_for(arbiter)
    seen: list[str] = []
    backend.add_event_handler(
        PODS, EventHandler(on_add=lambda obj: seen.append(obj.name))
    )
    arbiter.store.create_pod(build_pod(name="during-gap",
                                       req=build_resource_list(cpu=1)))
    # watch.drop injects the 410-Gone contract on the next poll: the
    # backend must re-list and synthesize the diff — the pod created
    # behind its back arrives exactly once
    faults.registry.arm("watch.drop", count=1)
    assert backend.pump() >= 1
    assert seen.count("during-gap") == 1
    assert {p.name for p in backend.list(PODS)} == {
        p.name for p in arbiter.store.list(PODS)
    }
    # the healed cursor resumes the ordinary stream
    arbiter.store.create_pod(build_pod(name="after-heal",
                                       req=build_resource_list(cpu=1)))
    backend.pump()
    assert seen.count("after-heal") == 1


# -- the chaos drills --------------------------------------------------------


class _Killed(BaseException):
    """SIGKILL stand-in (BaseException: no retry ladder survives it)."""


class KillingBinder(StoreBinder):
    """Dies on its Nth conditional dispatch — with store.conflict armed
    for the first call, N=2 kills the scheduler exactly mid-conflict
    (after the loss, before the retry lands)."""

    def __init__(self, store, die_on_call: int) -> None:
        super().__init__(store)
        self.calls = 0
        self.die_on_call = die_on_call

    def bind_many_versioned(self, bindings, snapshot_version) -> None:
        self.calls += 1
        if self.calls >= self.die_on_call:
            raise _Killed()
        super().bind_many_versioned(bindings, snapshot_version)


@pytest.mark.chaos
def test_chaos_conflict_kill_mid_retry_then_reconcile(tmp_path):
    """THE acceptance drill: two federated schedulers on one store,
    store.conflict armed; scheduler B loses its optimistic dispatch and
    is killed on the conflict retry; B's journal holds the whole gang as
    orphans; takeover reconciliation re-drives it — zero lost binds,
    zero duplicate binds, fsck clean, mutation detector clean."""
    store = ClusterStore()
    seed_store(store, gangs=("ga", "gb"), members=3)
    bind_counts = count_bind_events(store)
    ja = WriteIntentJournal(str(tmp_path / "a.wal"))
    jb = WriteIntentJournal(str(tmp_path / "b.wal"))
    # each cache's shard is whichever bucket its gang hashes into, so
    # the drill stays valid if crc32's assignment ever changes
    cache_a = FederatedCache(
        store, shard=shard_index(job_key("default", "ga"), 2), shards=2,
        shard_key="gang", journal=ja,
    )
    cache_b = FederatedCache(
        store, shard=shard_index(job_key("default", "gb"), 2), shards=2,
        shard_key="gang", journal=jb, binder=KillingBinder(store, die_on_call=2),
    )
    cache_a.snapshot()
    cache_b.snapshot()  # both solved over the same store version
    bind_gang(cache_a, "ga")
    assert all(
        store.get_pod("default", f"ga-p{m}").node_name == "n0" for m in range(3)
    )
    retried0 = metrics.federation_conflicts.value({"outcome": "retried"})
    faults.registry.arm("store.conflict", count=1)
    with pytest.raises(_Killed):
        bind_gang(cache_b, "gb")
    # died mid-conflict: one retry was in flight, nothing of gb landed
    assert metrics.federation_conflicts.value({"outcome": "retried"}) == retried0 + 1
    assert all(not store.get_pod("default", f"gb-p{m}").node_name for m in range(3))
    orphans = WriteIntentJournal.replay(jb.path).orphans
    assert [(i.op, i.pod) for i in orphans] == [
        ("bind", f"default/gb-p{m}") for m in range(3)
    ]

    # takeover: fresh journal handle against the same WAL, reconcile
    # before any loop runs; store truth drives, mutation detector armed
    jb_standby = WriteIntentJournal(jb.path)
    det = MutationDetector(store)
    det.snapshot()
    report = reconcile_journal(jb_standby, store)
    assert det.violations() == []
    assert report.redispatched == 3 and report.rolled_back == 0
    assert all(
        store.get_pod("default", f"{g}-p{m}").node_name == "n0"
        for g in ("ga", "gb") for m in range(3)
    )
    assert sorted(bind_counts) == sorted(
        f"default/{g}-p{m}" for g in ("ga", "gb") for m in range(3)
    )
    assert all(n == 1 for n in bind_counts.values()), f"duplicates: {bind_counts}"
    assert fsck(store) == []
    assert WriteIntentJournal.replay(jb.path).orphans == []
    ja.close()
    jb.close()
    jb_standby.close()


@pytest.mark.chaos
def test_chaos_natural_conflict_loser_retries_and_wins(tmp_path):
    """No faults: two schedulers snapshot the same version and race onto
    one node — the second dispatch loses stale_node for real and wins
    its refresh-retry. Both gangs end bound exactly once."""
    store = ClusterStore()
    seed_store(store, gangs=("ga", "gb"), members=3)
    bind_counts = count_bind_events(store)
    cache_a = FederatedCache(
        store, shard=shard_index(job_key("default", "ga"), 2), shards=2,
        shard_key="gang",
    )
    cache_b = FederatedCache(
        store, shard=shard_index(job_key("default", "gb"), 2), shards=2,
        shard_key="gang",
    )
    cache_a.snapshot()
    cache_b.snapshot()
    won0 = metrics.federation_conflicts.value({"outcome": "won"})
    bind_gang(cache_a, "ga")
    bind_gang(cache_b, "gb")  # stale snapshot: conflicts, retries, wins
    assert metrics.federation_conflicts.value({"outcome": "won"}) == won0 + 1
    assert all(n == 1 for n in bind_counts.values())
    assert len(bind_counts) == 6
    assert fsck(store) == []


@pytest.mark.chaos
def test_chaos_stale_assign_fault_forces_conflict_retry():
    """federation.stale_assign zeroes the dispatched snapshot version:
    on a node with placement history the dispatch must lose once, meter
    a retry, and land on the refreshed version."""
    store = ClusterStore()
    seed_store(store, gangs=("ga",), members=2)
    store.create_pod(build_pod(name="warm", req=build_resource_list(cpu=1)))
    store.conditional_bind_many([("default", "warm", "n0")], store.version)
    cache = SchedulerCache(store, conditional_binds=True)
    cache.snapshot()
    retries0 = metrics.bind_retries.value()
    faults.registry.arm("federation.stale_assign", count=1)
    bind_gang(cache, "ga")
    assert metrics.bind_retries.value() == retries0 + 1
    assert all(
        store.get_pod("default", f"ga-p{m}").node_name == "n0" for m in range(2)
    )
    assert fsck(store) == []


@pytest.mark.chaos
def test_chaos_partition_skips_pump_and_heals(arbiter):
    """federation.partition drops the backend's transport: the pump
    skips the round (mirror stales, snapshot_age keeps growing), a
    conditional write surfaces BackendPartitioned; when the fault
    exhausts, the next pump delivers everything missed and writes land."""
    seed_store(arbiter.store, gangs=("g0",), members=1)
    backend = _backend_for(arbiter)
    backend.add_event_handler(PODS, EventHandler())
    assert backend.pump() == 0  # baseline healthy round
    v = backend.version
    t0 = backend._last_pump_ok
    arbiter.store.create_pod(build_pod(name="missed",
                                       req=build_resource_list(cpu=1)))
    # three drops: the pump round, the version probe, the write
    faults.registry.arm("federation.partition", count=3)
    assert backend.pump() == 0  # round skipped, no exception
    assert backend._last_pump_ok == t0  # staleness keeps accruing
    assert backend.get_pod("default", "missed") is None
    assert backend.snapshot_age() >= 0.0
    # version falls back to last-seen instead of failing snapshot()
    assert backend.version == backend._store_version
    with pytest.raises(BackendPartitioned):
        backend.conditional_bind_many([("default", "g0-p0", "n0")], v)
    # fault exhausted: the partition heals
    assert backend.pump() >= 1
    assert backend._last_pump_ok > t0
    assert backend.get_pod("default", "missed") is not None
    assert backend.conditional_bind_many(
        [("default", "g0-p0", "n0")], backend.version
    ) == 1
    backend.pump()
    assert backend.get_pod("default", "g0-p0").node_name == "n0"
    assert fsck(arbiter.store) == []


# -- mixed-version federation (wire protocol v2) -----------------------------


def test_v2_client_negotiates_down_against_v1_server(cpu_conf):
    """A v2 client against a v1-only arbiter: the bare storeVersion
    reply IS the downgrade signal — no error path, no extra round trip,
    and every v1 surface (list, watch, conditional writes) keeps
    working byte-for-byte."""
    srv = SchedulerServer(
        scheduler_name="store-arbiter", listen_address="127.0.0.1:0",
        scheduler_conf=cpu_conf, schedule_period=60.0, wire_protocol=1,
    )
    srv.start()
    try:
        seed_store(srv.store, gangs=("g0",), members=2)
        backend = LoopbackBackend(f"http://127.0.0.1:{srv.listen_port}")
        events: list[str] = []
        backend.add_event_handler(
            PODS, EventHandler(on_add=lambda o: events.append(o.name))
        )
        assert backend._protocol == 1 and backend._codec == "json"
        assert not backend.supports_txn()  # the cache's coalescing gate
        assert sorted(events) == ["g0-p0", "g0-p1"]
        v = backend.version
        assert backend.conditional_bind_many(
            [("default", "g0-p0", "n0")], v
        ) == 1
        assert backend.pump() >= 1  # per-kind v1 polls, full objects
        assert backend.get_pod("default", "g0-p0").node_name == "n0"
        assert fsck(srv.store) == []
    finally:
        srv.stop()


def test_v1_pinned_client_against_v2_server(arbiter):
    """The other direction of the matrix: an old (protocol-capped)
    client against a v2 arbiter runs the negotiated minimum — v1,
    json — and the server never pushes v2 surfaces at it."""
    seed_store(arbiter.store, gangs=("g0",), members=2)
    backend = LoopbackBackend(
        f"http://127.0.0.1:{arbiter.listen_port}", protocol=1
    )
    backend.add_event_handler(PODS, EventHandler())
    assert backend._protocol == 1 and backend._codec == "json"
    assert not backend.supports_txn()
    v = backend.version
    assert backend.conditional_bind_many([("default", "g0-p0", "n0")], v) == 1
    assert backend.pump() >= 1
    assert backend.get_pod("default", "g0-p0").node_name == "n0"
    assert fsck(arbiter.store) == []


def test_partition_forces_renegotiation_midrun(arbiter):
    """After any partition (injected or real) the peer we reconnect to
    may be a different server generation: the backend must drop its
    negotiated state and re-run version negotiation before the next
    request — and still deliver the events the dropped round missed."""
    seed_store(arbiter.store, gangs=("g0",), members=1)
    backend = _backend_for(arbiter)
    backend.add_event_handler(PODS, EventHandler())
    assert backend._protocol == 2 and backend.supports_txn()
    faults.registry.arm("federation.partition", count=1)
    arbiter.store.create_pod(
        build_pod(name="px", req=build_resource_list(cpu=1))
    )
    assert backend.pump() == 0  # dropped round
    assert backend._needs_negotiation
    assert not backend.supports_txn()  # coalescing gate closes until settled
    # next pass renegotiates first, then delivers the missed event
    assert backend.pump() >= 1
    assert backend._protocol == 2 and backend.supports_txn()
    assert backend.get_pod("default", "px") is not None


def test_rolling_downgrade_midrun_renegotiates_down(arbiter):
    """Rolling downgrade drill: the arbiter behind the same URL flips
    to v1 mid-run. The client's watchall 404s (_Unsupported), the SAME
    pump falls back to per-kind v1 polling — renegotiating on the way —
    and conditional writes keep landing; when the arbiter comes back as
    v2 the client upgrades again on its next negotiation."""
    seed_store(arbiter.store, gangs=("g0",), members=2)
    backend = _backend_for(arbiter)
    backend.add_event_handler(PODS, EventHandler())
    assert backend._protocol == 2 and backend.supports_txn()
    arbiter.wire_protocol = 1  # same listener, older build
    arbiter.store.create_pod(
        build_pod(name="px", req=build_resource_list(cpu=1))
    )
    assert backend.pump() >= 1  # watchall 404 -> v1 fallback, same round
    assert backend.get_pod("default", "px") is not None
    assert backend._protocol == 1 and backend._codec == "json"
    assert not backend.supports_txn()
    v = backend.version
    assert backend.conditional_bind_many([("default", "g0-p0", "n0")], v) == 1
    # heal: the arbiter rolls forward again
    arbiter.wire_protocol = 2
    backend._mark_renegotiate()
    assert backend.version == arbiter.store.version
    assert backend._protocol == 2 and backend.supports_txn()
    assert fsck(arbiter.store) == []


# -- held against the JAX package -------------------------------------------

import numpy as np  # noqa: E402

from kube_batch_tpu.cache import ClusterStore as JaxClusterStore  # noqa: E402
from kube_batch_tpu.cache import EventHandler as JaxEventHandler  # noqa: E402
from kube_batch_tpu.federation import FederatedCache as JaxFederatedCache  # noqa: E402
from kube_batch_tpu.federation import fsck as jax_fsck  # noqa: E402
from kube_batch_tpu.federation import shard_index as jax_shard_index  # noqa: E402
from kube_batch_tpu.federation import shard_key_of as jax_shard_key_of  # noqa: E402
from kube_batch_tpu.scheduler import Scheduler as JaxScheduler  # noqa: E402
from kube_batch_tpu import testing as jax_testing  # noqa: E402

from kube_batch_tpu_torch import testing as torch_testing  # noqa: E402
from kube_batch_tpu_torch.conf import parse_scheduler_conf  # noqa: E402
from kube_batch_tpu_torch.framework import close_session, open_session  # noqa: E402
from kube_batch_tpu_torch.ops import encode_cache  # noqa: E402
from kube_batch_tpu_torch.ops.encode import encode_session  # noqa: E402
from kube_batch_tpu_torch.scheduler import Scheduler  # noqa: E402

# The scale-out row's world (bench.py federation_scaleout_row) cut to the
# CPU: gangs x members pods of 1 cpu / 1Gi on nodes of 16 cpu / 32Gi / 32
# pods, every gang keyed to a shard by crc32 of its gang key.
SCALEOUT = {"gangs": 200, "members": 4, "nodes": 100}

# The JAX side's twin of the port's bulk conf: the same tiers, with the
# serial allocate in place of torch_allocate (which the port holds bind
# for bind against it).
JAX_BULK_CONF = """actions: "enqueue, allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: predicates
  - name: nodeorder
"""


def _seed_scaleout(store, t, gangs: int, members: int, nodes: int) -> None:
    store.create_queue(t.build_queue("default"))
    for i in range(nodes):
        store.create_node(
            t.build_node(f"n{i}", t.build_resource_list(cpu=16, memory="32Gi", pods=32))
        )
    for g in range(gangs):
        store.create_pod_group(t.build_pod_group(f"f{g}", min_member=members))
        for m in range(members):
            store.create_pod(
                t.build_pod(
                    name=f"f{g}-p{m}", group_name=f"f{g}",
                    req=t.build_resource_list(cpu=1, memory="1Gi"),
                )
            )


def _placements(store) -> dict[str, str]:
    return {f"{p.namespace}/{p.name}": p.node_name for p in store.list(PODS)}


def test_shard_index_matches_for_10000_keys_in_every_mode():
    """shard_key_of and shard_index agree with the JAX package's on
    10,000 seeded pods, in every shard-key mode and at N = 1..8."""
    rng = np.random.default_rng(10)
    stores = {}
    for name, store_cls, t in (
        ("port", ClusterStore, torch_testing),
        ("jax", JaxClusterStore, jax_testing),
    ):
        store = store_cls()
        for q in range(7):
            store.create_queue(t.build_queue(f"q{q}"))
        stores[name] = (store, t)
    pods = {"port": [], "jax": []}
    draws = rng.integers(0, 1 << 30, size=(10_000, 3))
    for i, (ns_i, g_i, q_i) in enumerate(draws):
        ns, group, queue = f"ns{ns_i % 13}", f"g{g_i % 2500}", f"q{q_i % 7}"
        for name, (store, t) in stores.items():
            if i % 3 and store.get(POD_GROUPS, f"{ns}/{group}") is None:
                store.create_pod_group(
                    t.build_pod_group(group, namespace=ns, queue=queue, min_member=1)
                )
            pods[name].append(t.build_pod(namespace=ns, name=f"p{i}", group_name=group))
    for mode in SHARD_KEYS:
        for p_port, p_jax in zip(pods["port"], pods["jax"]):
            k_port = shard_key_of(p_port, stores["port"][0], mode)
            k_jax = jax_shard_key_of(p_jax, stores["jax"][0], mode)
            assert k_port == k_jax
            for n in range(1, 9):
                assert shard_index(k_port, n) == jax_shard_index(k_jax, n)


def _run_cycles(scheds, store, total: int, max_rounds: int = 6) -> None:
    for _ in range(max_rounds):
        for s in scheds:
            s.run_once()
        if sum(1 for p in store.list(PODS) if p.node_name) >= total:
            return


def test_one_shard_binds_bind_for_bind_with_the_jax_federated_cache(tmp_path):
    """N = 1: one FederatedCache over the scale-out world, the scheduler's
    default pipeline (torch_allocate on the CPU) against the JAX package's
    default pipeline over its FederatedCache: every pod on the same node."""
    w = SCALEOUT
    total = w["gangs"] * w["members"]
    port_store, jax_store = ClusterStore(), JaxClusterStore()
    _seed_scaleout(port_store, torch_testing, **w)
    _seed_scaleout(jax_store, jax_testing, **w)
    conf = write_conf("cpu", directory=str(tmp_path))
    port_cache = FederatedCache(port_store, shard=0, shards=1, shard_key="gang")
    jax_cache = JaxFederatedCache(jax_store, shard=0, shards=1, shard_key="gang")
    _run_cycles([Scheduler(port_cache, scheduler_conf=conf)], port_store, total)
    _run_cycles([JaxScheduler(jax_cache)], jax_store, total)
    port_bound, jax_bound = _placements(port_store), _placements(jax_store)
    assert sum(1 for v in port_bound.values() if v) == total
    assert port_bound == jax_bound
    assert fsck(port_store) == [] and jax_fsck(jax_store) == []


@pytest.mark.parametrize("shards", [2, 4])
def test_shards_drain_the_scaleout_world_like_the_jax_package(tmp_path, shards):
    """N = 2 and 4 shard threads over one store in each package: the same
    bound set, every pod bound exactly once, fsck clean."""
    w = SCALEOUT
    total = w["gangs"] * w["members"]
    conf = write_conf("cpu", bulk=True, directory=str(tmp_path))
    jax_conf = tmp_path / "jax-bulk.yaml"
    jax_conf.write_text(JAX_BULK_CONF)
    results = {}
    for name, store_cls, t, cache_cls, sched_cls, handler, conf_path in (
        ("port", ClusterStore, torch_testing, FederatedCache, Scheduler, EventHandler, conf),
        ("jax", JaxClusterStore, jax_testing, JaxFederatedCache, JaxScheduler,
         JaxEventHandler, str(jax_conf)),
    ):
        store = store_cls()
        _seed_scaleout(store, t, **w)
        counts: dict[str, int] = {}
        lock = threading.Lock()

        def on_update(old, new, counts=counts, lock=lock):
            if not old.node_name and new.node_name:
                with lock:
                    key = f"{new.namespace}/{new.name}"
                    counts[key] = counts.get(key, 0) + 1

        store.add_event_handler(PODS, handler(on_update=on_update))
        caches = [
            cache_cls(store, shard=i, shards=shards, shard_key="gang") for i in range(shards)
        ]
        stop = threading.Event()
        threads = []
        for i, cache in enumerate(caches):
            sched = sched_cls(cache, scheduler_conf=conf_path, schedule_period=0.02)
            th = threading.Thread(target=sched.run, args=(stop,), name=f"kb-fed-{i}", daemon=True)
            th.start()
            threads.append(th)
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            with lock:
                if len(counts) >= total:
                    break
            time.sleep(0.01)
        stop.set()
        for th in threads:
            th.join(timeout=60.0)
        for cache in caches:
            cache.stop()
        results[name] = (store, dict(counts))
    (port_store, port_counts), (jax_store, jax_counts) = results["port"], results["jax"]
    for counts in (port_counts, jax_counts):
        assert len(counts) == total
        assert all(n == 1 for n in counts.values()), "a pod was bound twice"
    port_bound = {k for k, v in _placements(port_store).items() if v}
    jax_bound = {k for k, v in _placements(jax_store).items() if v}
    assert port_bound == jax_bound
    assert fsck(port_store) == [] and jax_fsck(jax_store) == []


ENCODE_TIERS = """
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""


def _encode(ssn):
    return encode_session(
        ssn.jobs, ssn.nodes, ssn.queues, dtype=np.float32,
        drf=ssn.plugins.get("drf"), proportion=ssn.plugins.get("proportion"),
        session=ssn,
    )


def _same_encode(a, b) -> bool:
    if set(a.arrays) != set(b.arrays) or a.node_names != b.node_names:
        return False
    if [t.uid for t in a.tasks] != [t.uid for t in b.tasks]:
        return False
    return all(
        np.asarray(a.arrays[k]).tobytes() == np.asarray(b.arrays[k]).tobytes()
        for k in a.arrays
    )


def _label_key_world(shards: int):
    """Nodes labeled under one key per shard; each shard's gangs select
    nodes by their shard's key, so the shards' encodes ask the shared
    cache for node signatures under different label keys."""
    store = ClusterStore()
    store.create_queue(build_queue("default"))
    for i in range(24):
        store.create_node(
            build_node(
                f"n{i}", build_resource_list(cpu=16, memory="32Gi", pods=32),
                labels={f"key{s}": "a" if (i + s) % 2 else "b" for s in range(shards)},
            )
        )
    made = {s: 0 for s in range(shards)}
    g = 0
    while min(made.values()) < 3:
        name = f"lg{g}"
        slot = shard_index(job_key("default", name), shards)
        g += 1
        if made[slot] >= 3:
            continue
        made[slot] += 1
        pg = build_pod_group(name, min_member=2)
        pg.status.phase = PodGroupPhase.INQUEUE  # past enqueue: encodable
        store.create_pod_group(pg)
        for m in range(2):
            store.create_pod(
                build_pod(
                    name=f"{name}-p{m}", group_name=name,
                    req=build_resource_list(cpu=1, memory="1Gi"),
                    node_selector={f"key{slot}": "a"},
                )
            )
    return store


def test_four_shard_threads_warm_encodes_equal_cold_encodes():
    """Four shard threads encode their own pending sets through the one
    process-wide encode cache at once, the interpreter switching threads
    as often as it can: every warm encode equals its shard's cold encode
    byte for byte."""
    shards = 4
    store = _label_key_world(shards)
    tiers = parse_scheduler_conf(ENCODE_TIERS).tiers
    caches = [
        FederatedCache(store, shard=i, shards=shards, shard_key="gang") for i in range(shards)
    ]
    sessions = [open_session(c, tiers) for c in caches]
    encode_cache.get().invalidate_all("test")
    encode_cache.set_enabled(False)
    try:
        cold = [_encode(s) for s in sessions]
    finally:
        encode_cache.set_enabled(True)
    assert all(len(c.tasks) == 6 for c in cold)
    barrier = threading.Barrier(shards)
    mismatches: list = []
    fractions: dict[int, list] = {i: [] for i in range(shards)}

    def worker(i):
        barrier.wait()
        for _ in range(6):
            enc = _encode(sessions[i])
            fractions[i].append(enc.warm_fraction)
            if not _same_encode(enc, cold[i]):
                mismatches.append(i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(shards)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # hand the interpreter over as often as it will go
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert mismatches == []
    assert all(len(f) == 6 and all(0.0 <= x <= 1.0 for x in f) for f in fractions.values())
    # after the concurrent use the cache is whole: a shard's next encodes
    # are warm and still equal its cold one, and the warm share read on
    # this thread is this thread's encode's
    _encode(sessions[0])
    again = _encode(sessions[0])
    assert _same_encode(again, cold[0])
    assert again.warm_fraction > 0.5 and encode_cache.get().warm_fraction == again.warm_fraction
    for s in sessions:
        close_session(s)


def test_a_node_slot_never_changes_under_its_holder():
    """The interleaving the shards produce: shard A takes a node's slot
    under its label keys, shard B re-keys the node under its own; A's
    slot still holds A's signature."""
    ec = encode_cache.EncodeCache()
    node = type("N", (), {})()
    node.name, node.node = "n0", object()
    sig = lambda n, keys: ("sig", tuple(sorted(keys)))  # noqa: E731
    statics = lambda n: (True, 32)  # noqa: E731
    held = ec.node_row(node, frozenset({"key0"}), sig, statics)
    other = ec.node_row(node, frozenset({"key1"}), sig, statics)
    assert held.sig == ("sig", ("key0",)) and held.sig_label_keys == frozenset({"key0"})
    assert other.sig == ("sig", ("key1",)) and other is not held
    assert (other.ok, other.max_tasks) == (True, 32)
    again = ec.node_row(node, frozenset({"key1"}), sig, statics)
    assert again is other


# -- the entry points: the federation CLI and the compose topology ------------

import signal  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402

from kube_batch_tpu_torch import federation as torch_federation  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_federation_cli_measures_the_v2_bulk_row(capsys):
    """``python -m kube_batch_tpu_torch.federation --bulk --wire-protocol 2
    --device cpu --json``: the gangs ride coalesced txn batches over the
    binary codec, every pod bound exactly once."""
    assert torch_federation.main(["--json", "--bulk", "--wire-protocol", "2", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] and out["exactly_once"] and out["union_parity"]
    assert (out["protocol"], out["codec"]) == (2, "binary")
    assert out["txn_batches"] >= 1 and out["bound"] == out["pods"] == 18


def test_federation_cli_refuses_streaming_until_the_port_has_it(capsys):
    """The port has the streaming layer now: ``--streaming --device cpu``
    runs the streaming-federation drill and exits 0; without ``--device
    cpu`` and with no card it raises before any shard starts."""
    import torch

    assert torch_federation.main(["--streaming", "--device", "cpu", "--gangs", "2", "--members", "2", "--json"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["ok"] and result["micro_cycles"] > 0 and result["bound"] == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torch_federation.main(["--streaming"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_the_compose_federation_profile_on_the_cpu(arbiter, tmp_path):
    """The shipped compose file's ``federation`` profile as processes: a
    store server and two ``python -m kube_batch_tpu_torch.server
    --store-backend URL`` shards (``KBT_FEDERATION=0/2`` and ``1/2``,
    ``KBT_SHARD_KEY=gang``): every pending pod bound exactly once, fsck
    clean, each shard answering ``/metrics`` with its conflict series, and
    both ending on SIGINT with code 0."""
    import urllib.request

    seed_store(arbiter.store, nodes=4, gangs=tuple(f"c{i}" for i in range(8)), members=3)
    counts = count_bind_events(arbiter.store)
    conf = write_conf("cpu", bulk=True, directory=str(tmp_path))
    url = f"http://127.0.0.1:{arbiter.listen_port}"
    procs, ports = [], []
    for i in range(2):
        port = _free_port()
        env = dict(os.environ, KBT_FEDERATION=f"{i}/2", KBT_SHARD_KEY="gang", PYTHONPATH=ROOT)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kube_batch_tpu_torch.server", "--store-backend", url,
             "--scheduler-conf", conf, "--listen-address", f"127.0.0.1:{port}", "--schedule-period", "0.2"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        ports.append(port)
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and len(counts) < 24:
            assert all(p.poll() is None for p in procs), [p.communicate()[0][-2000:] for p in procs]
            time.sleep(0.1)
        assert sorted(counts) == sorted(f"default/c{i}-p{m}" for i in range(8) for m in range(3))
        time.sleep(0.5)
        assert all(n == 1 for n in counts.values()), counts
        assert fsck(arbiter.store, shard_key="gang") == []
        for port in ports:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
                text = r.read().decode()
            assert "kube_batch_tpu_federation_conflicts_total" in text
            assert 'kube_batch_tpu_store_backend_bytes_total{codec="binary"' in text
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
        outs = [p.communicate(timeout=60)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[-2000:] for o in outs]
