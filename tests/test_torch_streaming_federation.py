"""The port's streaming federation, case for case with
tests/test_streaming_federation.py: echo filtering over delta-patched
mirrors, absorb-mode occupancy patches, overcommit-tolerant watch
accounting and the backend pump's hygiene, each held against the JAX
package where the two can see the same objects; then
``federation.smoke_streaming`` run through both packages, its placements
compared pod for pod.

The regression class pinned here, as in the JAX suite: federated shards
mirror the store through the /backend/v1/ watch, and under wire v2
MODIFIED events arrive as field-level deltas applied with
``wire.apply_delta``. The StreamTrigger's echo rules depend on the
mirror's replace-don't-mutate contract: ``apply_delta`` returns a *new*
object while the handler still holds the old one.
"""

from __future__ import annotations

import dataclasses
import importlib
import time

import pytest

from test_torch_streaming import BOTH, JAX, PORT

for _P in BOTH:
    _P.wire = importlib.import_module(f"{_P.name}.apis.wire")
    _P.federation = importlib.import_module(f"{_P.name}.federation")


@pytest.fixture(autouse=True)
def _clean_faults():
    for P in BOTH:
        P.faults.registry.reset()
        P.faults.solver_ladder.reset()
    yield
    for P in BOTH:
        P.faults.registry.reset()
        P.faults.solver_ladder.reset()


@pytest.fixture()
def arbiter():
    """The port's SchedulerServer as the store process (its own loop
    idled by a scheduler name no workload pod carries)."""
    srv = PORT.server.SchedulerServer(
        scheduler_name="store-arbiter", listen_address="127.0.0.1:0", schedule_period=60.0,
    )
    srv.start()
    try:
        yield srv
    finally:
        srv.stop()


# -- delta-codec echo filtering -----------------------------------------------


def _bind_echo(P) -> tuple:
    t = P.t
    pending = t.build_pod(name="p0", group_name="g0", req=t.build_resource_list(cpu=1))
    bound = dataclasses.replace(pending, node_name="n1")
    delta = P.wire.delta_of("pods", pending, bound)
    assert "node_name" in delta["changed"] and not delta["removed"]
    patched = P.wire.apply_delta("pods", pending, delta)
    assert patched is not pending, "apply_delta must copy, not mutate"
    assert pending.node_name == "" and patched.node_name == "n1"
    trig = P.streaming.StreamTrigger(absorb_external=True)
    uid = pending.metadata.uid
    trig._on_event("pods", uid, pending, None)
    backlog0 = trig.backlog_pods()
    trig.drain()
    trig._on_event("pods", uid, patched, pending)
    work = trig.drain()
    return backlog0, trig.backlog_pods(), trig.wait(0), work.stale, work.bound_patches, sorted(delta["changed"])


def test_delta_patched_bind_echo_keeps_old_new_distinct():
    """A v2 bind echo applied with apply_delta is a NEW object, so the
    trigger still sees the transition: arrival closed, no wake, no stale
    degrade."""
    got = _bind_echo(PORT)
    assert got == _bind_echo(JAX)
    assert got[:5] == (1, 0, False, False, [])


def _podgroup_echo(P) -> tuple:
    t = P.t
    pg = t.build_pod_group("g1", min_member=3)
    status2 = dataclasses.replace(pg, status=dataclasses.replace(pg.status, phase=P.types.PodGroupPhase.RUNNING))
    patched = P.wire.apply_delta("podgroups", pg, P.wire.delta_of("podgroups", pg, status2))
    assert patched is not pg and patched.spec == pg.spec, "a status delta must not disturb the spec"
    trig = P.streaming.StreamTrigger()
    trig._on_event("podgroups", "default/g1", patched, pg)
    seen = [(trig.wait(0), trig.drain().gangs)]
    spec2 = dataclasses.replace(pg, spec=dataclasses.replace(pg.spec, min_member=5))
    patched2 = P.wire.apply_delta("podgroups", pg, P.wire.delta_of("podgroups", pg, spec2))
    assert patched2.spec.min_member == 5
    trig._on_event("podgroups", "default/g1", patched2, pg)
    seen.append((trig.wait(0), trig.drain().gangs))
    return seen


def test_delta_patched_podgroup_status_echo_not_redirtied():
    """close_session's status-only write-back through the v2 delta codec
    keeps spec equality, so the trigger skips it; a real spec change
    through the same codec dirties the gang."""
    got = _podgroup_echo(PORT)
    assert got == _podgroup_echo(JAX) == [(False, set()), (True, {"default/g1"})]


# -- absorb mode (federated streaming) ---------------------------------------


def test_absorb_mode_turns_peer_churn_into_patches_not_degrade():
    """A peer shard's bind crosses the federated filter as a bound-pod ADD
    (no wake) and its release as a DELETE (wake). Without absorb mode both
    degrade to a stale full cycle."""
    for P in BOTH:
        t = P.t
        peer = t.build_pod(name="peer-0", node_name="n2", req=t.build_resource_list(cpu=1))
        key = peer.metadata.uid
        trig = P.streaming.StreamTrigger(absorb_external=True)
        trig._on_event("pods", key, peer, None)
        assert not trig.wait(0), "a peer bind must not wake the loop"
        work = trig.drain()
        assert work.bound_patches == [("add", key, peer)] and not work.stale
        trig._on_event("pods", key, None, peer)
        assert trig.wait(0), "a peer release frees capacity: wake"
        work = trig.drain()
        assert work.bound_patches == [("remove", key, peer)] and not work.stale
        solo = P.streaming.StreamTrigger()
        solo._on_event("pods", key, peer, None)
        work = solo.drain()
        assert work.stale and "appeared outside a cycle" in work.stale_reason


def _resident(P, cpu: int = 4):
    t = P.t
    ni = P.api.NodeInfo(t.build_node("n0", t.build_resource_list(cpu=cpu, memory=f"{cpu}Gi", pods=16)))

    class _Session:
        nodes = {"n0": ni}

    st = P.streaming.StreamState()
    st.adopt_full_cycle(_Session())
    return st, ni


def test_apply_bound_patches_absorbs_and_skips_duplicates():
    for P in BOTH:
        st, ni = _resident(P, cpu=4)
        peer = P.t.build_pod(name="peer-1", node_name="n0", req=P.t.build_resource_list(cpu=1, memory="512Mi"))
        idle0 = ni.idle.milli_cpu
        assert st.apply_bound_patches([("add", "k", peer)]) is True
        assert ni.idle.milli_cpu == idle0 - 1000 and len(ni.tasks) == 1
        # a duplicate add: the adopted snapshot beat the patch to it
        assert st.apply_bound_patches([("add", "k", peer)]) is True
        assert len(ni.tasks) == 1 and st.valid
        assert st.apply_bound_patches([("remove", "k", peer)]) is True
        assert ni.idle.milli_cpu == idle0 and not ni.tasks
        assert st.apply_bound_patches([("remove", "k", peer)]) is True
        assert st.valid


def test_apply_bound_patches_invalidates_on_true_divergence():
    for P in BOTH:
        st, _ = _resident(P)
        ghost = P.t.build_pod(name="g", node_name="nowhere", req=P.t.build_resource_list(cpu=1))
        assert st.apply_bound_patches([("add", "k", ghost)]) is False
        assert not st.valid and "not resident" in st.reason
        st, _ = _resident(P, cpu=1)
        fat = P.t.build_pod(name="fat", node_name="n0", req=P.t.build_resource_list(cpu=2))
        assert st.apply_bound_patches([("add", "k", fat)]) is False
        assert not st.valid


# -- overcommit-tolerant watch accounting ------------------------------------


def test_watch_delivered_bind_race_records_negative_idle_and_heals():
    """Two shards race binds onto one node; the loser's mirror records the
    overcommit (negative idle) instead of killing the pump, a clone of the
    oversubscribed node survives, and deleting one pod heals it."""
    for P in BOTH:
        t = P.t
        store = P.cache.ClusterStore()
        store.create_queue(t.build_queue("default"))
        store.create_node(t.build_node("tiny", t.build_resource_list(cpu=1, memory="1Gi", pods=8)))
        cache = P.cache.SchedulerCache(store)
        for i in range(2):
            store.create_pod(t.build_pod(name=f"winner-{i}", node_name="tiny",
                                         req=t.build_resource_list(cpu=1, memory="512Mi")))
        with cache._mutex:
            ni = cache.nodes["tiny"]
            assert len(ni.tasks) == 2
            assert ni.idle.milli_cpu == -1000, "an overcommit must read as negative idle"
            assert ni.clone().idle.milli_cpu == -1000
        store.delete_pod("default", "winner-1")
        with cache._mutex:
            ni = cache.nodes["tiny"]
            assert len(ni.tasks) == 1 and ni.idle.milli_cpu == 0


# -- pump hygiene ------------------------------------------------------------


def test_backend_pump_thread_shutdown_hygiene(arbiter):
    """start() spawns one kb-backend thread; stop() joins it and clears
    the handle; both are idempotent."""
    backend = PORT.cache.LoopbackBackend(f"http://127.0.0.1:{arbiter.listen_port}")
    seen: list[str] = []
    backend.add_event_handler("pods", PORT.store.EventHandler(on_add=lambda obj: seen.append(obj.name)))
    backend.start(period=0.02)
    t = backend._thread
    assert t is not None and t.is_alive()
    backend.start(period=0.02)
    assert backend._thread is t, "a double start must not spawn a second pump"
    arbiter.store.create_pod(PORT.t.build_pod(name="live", req=PORT.t.build_resource_list(cpu=1)))
    deadline = time.monotonic() + 5.0
    while "live" not in seen and time.monotonic() < deadline:
        time.sleep(0.005)
    assert "live" in seen
    backend.stop()
    assert backend._thread is None and not t.is_alive()
    backend.stop()
    assert backend._thread is None


def test_trigger_attach_detach_restores_listener_count():
    for P in BOTH:
        before = P.encode_cache.listener_count()
        trig = P.streaming.StreamTrigger()
        trig.attach()
        assert P.encode_cache.listener_count() == before + 1
        trig.detach()
        assert P.encode_cache.listener_count() == before
        trig.detach()  # idempotent
        assert P.encode_cache.listener_count() == before


def test_bad_handler_does_not_kill_the_pump(arbiter):
    backend = PORT.cache.LoopbackBackend(f"http://127.0.0.1:{arbiter.listen_port}")

    def explode(obj):
        raise ValueError(f"poison object {obj.name}")

    seen: list[str] = []
    backend.add_event_handler("pods", PORT.store.EventHandler(on_add=explode))
    backend.add_event_handler("pods", PORT.store.EventHandler(on_add=lambda obj: seen.append(obj.name)))
    arbiter.store.create_pod(PORT.t.build_pod(name="a", req=PORT.t.build_resource_list(cpu=1)))
    assert backend.pump() >= 1
    assert seen == ["a"], "the handler after the poisoned one must still run"
    arbiter.store.create_pod(PORT.t.build_pod(name="b", req=PORT.t.build_resource_list(cpu=1)))
    assert backend.pump() >= 1
    assert seen == ["a", "b"], "the pump must survive to the next round"


def test_stream_pump_fault_skips_rounds_then_redelivers(arbiter):
    backend = PORT.cache.LoopbackBackend(f"http://127.0.0.1:{arbiter.listen_port}")
    seen: list[str] = []
    backend.add_event_handler("pods", PORT.store.EventHandler(on_add=lambda obj: seen.append(obj.name)))
    arbiter.store.create_pod(PORT.t.build_pod(name="held", req=PORT.t.build_resource_list(cpu=1)))
    PORT.faults.registry.arm("stream.pump", count=2)
    assert backend.pump() == 0 and backend.pump() == 0
    assert seen == [], "a dropped round must not leak a partial batch"
    assert backend.pump() >= 1
    assert seen == ["held"], "an exhausted fault must redeliver exactly once"


# -- the drill through both packages ------------------------------------------


def _smoke_streaming(P, monkeypatch) -> tuple[dict, list]:
    """``smoke_streaming`` on P (the port on the CPU), with each mode's
    final placements taken at its fsck."""
    placed = []
    real = P.federation.fsck

    def fsck(store, *a, **k):
        placed.append({f"{p.namespace}/{p.name}": p.node_name for p in store.list("pods")})
        return real(store, *a, **k)

    monkeypatch.setattr(P.federation, "fsck", fsck)
    kwargs = {"device": "cpu"} if P is PORT else {}
    return P.federation.smoke_streaming(**kwargs), placed


def test_smoke_streaming_binds_as_the_jax_package(monkeypatch):
    """The streaming-federation drill (``python -m
    kube_batch_tpu_torch.federation --streaming --device cpu``): two
    absorb-mode shards over the wire, streaming against periodic, bind for
    bind in each package, and the port's placements equal the JAX
    package's in both modes."""
    port, port_placed = _smoke_streaming(PORT, monkeypatch)
    jax, jax_placed = _smoke_streaming(JAX, monkeypatch)
    assert port["ok"], port
    assert port["micro_cycles"] > 0 and port["full_cycle_micro_cycles"] == 0
    assert len(port_placed) == 2 and all(port_placed[0].values())
    assert port_placed == jax_placed
    for key in ("shards", "gangs", "pods", "bound", "parity", "exactly_once", "listeners_clean", "pumps_joined", "ok"):
        assert port[key] == jax[key], key
