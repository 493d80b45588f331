"""The port's tensor arena (ops/encode_cache ``TensorArena``) on torch_allocate's
path: the hazards of keeping the rungs' statics resident across cycles.

Held here, each against the same cycles with the arena off (the encode
cache off, every static uploaded afresh):
- (a) a write that bypasses the arena's memo: the fused rung's affinity
  refresh after a pod-affinity pause must go through the arena, so the
  resident buffer and the memo agree and the next cycle is exact;
- (b) readers after the solve: under ``KBT_PIPELINE`` with explain on,
  over churning cycles, explain's records (read from B1's statics where
  they lie) and the binds equal the arena-off run, and the banks alternate;
- (c) in-process shards: two threads solving two worlds through one
  action each bind what they bind alone, each in an arena of its own;
- (d) cycles of different shapes: a streaming micro-cycle between full
  cycles uploads the statics whole (its task axis differs) and says so in
  its counters, binding what the arena-off run binds.

The card case (marked ``cuda``) holds the in-place row update, the pinned
uploads and a mesh slab on the card. This file imports no jax, so the card
run takes it with ``--noconftest``.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import pytest
import torch

import kube_batch_tpu_torch.actions  # noqa: F401  (registers the port's actions)
import kube_batch_tpu_torch.plugins  # noqa: F401  (registers the port's plugins)
from kube_batch_tpu_torch import models, pipeline
from kube_batch_tpu_torch.apis.types import Affinity, PodAffinityTerm
from kube_batch_tpu_torch.obs import explain
from kube_batch_tpu_torch.ops import encode_cache
from kube_batch_tpu_torch.scheduler import Scheduler
from kube_batch_tpu_torch.testing import (
    FakeCache,
    build_cluster,
    build_node,
    build_pod,
    build_pod_group,
    build_queue,
    build_resource_list,
)

CONF = """
actions: "enqueue, torch_allocate"
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
actionArguments:
  torch_allocate:
    device: cpu
    min_device_pairs: 0
"""


@pytest.fixture
def conf(tmp_path) -> str:
    path = tmp_path / "conf.yaml"
    path.write_text(CONF)
    return str(path)


@pytest.fixture(autouse=True)
def _cache_on():
    encode_cache.set_enabled(True)
    yield
    encode_cache.set_enabled(True)


def relabel(cluster, node_name: str, key: str) -> None:
    """Replace a node's Node object by a relabelled copy (a watch event)."""
    ni = cluster.nodes[node_name]
    n = ni.node
    ni.set_node(dataclasses.replace(n, metadata=dataclasses.replace(n.metadata, labels={**n.metadata.labels,
                                                                                       key: "1"})))


def add_gang(cluster, name: str, size: int) -> None:
    queue = sorted(cluster.queues.values(), key=lambda q: q.name)[0]
    gang = build_cluster(
        [build_pod(name=f"{name}-{i}", group_name=name, req=build_resource_list(cpu=1, memory="1Gi"))
         for i in range(size)],
        [], [build_pod_group(name, queue=queue.name, min_member=size)], [queue.queue],
    )
    cluster.jobs.update(gang.jobs)


def allocate_action(sched):
    return next(a for a in sched.actions if a.name == "torch_allocate")


def slot(arena, name: str):
    return arena._slots[(name, arena.bank)]


def affinity_world():
    """Four one-pod gangs with a preferred pod affinity to ``pack=yes``
    (each a host-only task: a pause, a host step and a resume) among eight
    plain ``pack=yes`` pods: once a paired pod lands, the affinity scores
    of every later task move, so each host step refreshes the fused rung's
    affinity static."""
    pods, groups = [], []
    for i in range(12):
        p = build_pod(name=f"p{i}", group_name=f"g{i}", req=build_resource_list(cpu=1, memory="1Gi"),
                      labels={"pack": "yes"})
        p.metadata.creation_timestamp = float(i)
        if i % 3 == 0:
            p.affinity = Affinity(
                pod_affinity_preferred=[(8, PodAffinityTerm({"pack": "yes"}, "kubernetes.io/hostname"))])
        pg = build_pod_group(f"g{i}", min_member=1)
        pg.metadata.creation_timestamp = float(i)
        pods.append(p)
        groups.append(pg)
    nodes = [build_node(f"n{i}", build_resource_list(cpu=4, memory="8Gi", pods=10)) for i in range(4)]
    return build_cluster(pods, nodes, groups, [build_queue("default")])


def run_cycles(conf: str, cluster, cycles: int, arena_on: bool, churn=None) -> tuple[list, object]:
    """``cycles`` run_once of one scheduler over ``cluster`` with the arena
    on or off; ``churn(cluster, i)`` before cycle i > 0. Returns the binds
    after every cycle and the scheduler."""
    encode_cache.set_enabled(arena_on)
    cache = FakeCache(cluster)
    sched = Scheduler(cache, conf)
    out = []
    for i in range(cycles):
        if churn is not None and i:
            churn(cluster, i)
        sched.run_once()
        out.append(dict(cache.binder.binds))
    return out, sched


def test_a_the_affinity_refresh_goes_through_the_arena(conf):
    """After a pod-affinity pause and resume the fused rung re-folds its
    affinity static; with the arena that is a new host buffer uploaded
    through it, so the resident copy equals its memo after the cycle, and
    a second cycle (which starts from the unrefreshed statics) binds as
    the arena-off run does."""
    off, _ = run_cycles(conf, affinity_world(), 2, arena_on=False)
    on, sched = run_cycles(conf, affinity_world(), 2, arena_on=True)
    action = allocate_action(sched)
    arena = action.arena_for(sched.cache, "cpu")
    assert action.last_timings["host_steps"] == 4
    assert on == off and len(on[0]) == 12
    for name in ("fused_istatic", "fused_fstatic"):
        s = slot(arena, name)
        np.testing.assert_array_equal(s.device.numpy(), s.host)
    # every host step's refresh went up through the arena (two cycles of
    # two uploads and four refreshes), each a row update of the changed
    # scores; the second cycle's first upload wrote the refreshed scores
    # back to the unrefreshed ones
    assert arena.reuses + arena.row_updates + arena.full_uploads == 2 * (2 + 4)
    assert arena.row_updates >= 2 * 4 + 1


def test_b_pipelined_explain_reads_what_the_arena_off_run_reads(conf, monkeypatch):
    """KBT_PIPELINE with explain on over six cycles (two unchanged, a node
    relabelled, a new gang, one unchanged): every cycle's explain records
    and binds equal the arena-off run's; the banks alternate cycle by
    cycle, and the third cycle reuses the first cycle's bank."""
    monkeypatch.setenv(explain.ENV, "1")
    monkeypatch.setenv(pipeline.ENV, "1")

    def churn(cluster, i):
        if i == 3:
            relabel(cluster, sorted(cluster.nodes)[0], "churn")
        elif i == 4:
            add_gang(cluster, "arena-new-gang", 4)

    def run(arena_on: bool):
        pipeline.reset()
        explain.configure()
        explain.records.clear()
        encode_cache.set_enabled(arena_on)
        cluster = models.preempt_mix(400, 16, seed=1)
        cache = FakeCache(cluster)
        sched = Scheduler(cache, conf)
        records, binds, banks = [], [], []
        for i in range(6):
            churn(cluster, i)
            sched.run_once()
            assert pipeline.fence.wait()  # the deferred dispatch, which publishes the records, has landed
            records.append(sorted(explain.records.snapshot(), key=lambda r: r["name"]))
            binds.append(dict(cache.binder.binds))
            if arena_on:
                banks.append(allocate_action(sched).arena_for(cache, "cpu").bank)
        return records, binds, banks, sched

    try:
        off = run(False)
        on = run(True)
    finally:
        pipeline.reset()
        explain.configure("off")
        explain.records.clear()
    assert on[0] == off[0] and on[1] == off[1]
    assert all(on[0]) and on[1][0]
    assert on[2] == [1, 0, 1, 0, 1, 0]
    arena = allocate_action(on[3]).arena_for(on[3].cache, "cpu")
    assert arena.reuses >= 2 and arena.reuses + arena.row_updates + arena.full_uploads == 6 * 2
    assert set(arena.hbm_bytes_by_slab()) == {"fused_istatic", "fused_fstatic"}


def test_c_two_threads_through_one_action_bind_as_alone(conf):
    """Two schedulers over two worlds share the conf's action objects (as
    in-process federation shards do) and run their cycles at once, a node
    relabelled before each later cycle: each binds, cycle for cycle, what
    it binds alone, and each cache has an arena of its own."""
    worlds = {
        "a": lambda: models.preempt_mix(400, 16, seed=1),
        "b": lambda: models.multi_queue(300, 12, seed=3),
    }

    def churn(cluster, i):
        relabel(cluster, sorted(cluster.nodes)[i], f"churn{i}")

    solo = {k: run_cycles(conf, make(), 4, True, churn)[0] for k, make in worlds.items()}
    clusters = {k: make() for k, make in worlds.items()}
    scheds = {k: Scheduler(FakeCache(c), conf) for k, c in clusters.items()}
    assert allocate_action(scheds["a"]) is allocate_action(scheds["b"])
    start = threading.Barrier(2)
    got: dict = {}
    errors = []

    def shard(k):
        try:
            out = []
            start.wait()
            for i in range(4):
                if i:
                    churn(clusters[k], i)
                scheds[k].run_once()
                out.append(dict(scheds[k].cache.binder.binds))
            got[k] = out
        except Exception as e:  # noqa: BLE001 - re-raised below on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=shard, args=(k,)) for k in worlds]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert got == solo
    action = allocate_action(scheds["a"])
    arenas = [action.arena_for(scheds[k].cache, "cpu") for k in worlds]
    assert arenas[0] is not arenas[1]
    assert all(a.full_uploads >= 2 and a.reuses + a.row_updates >= 1 for a in arenas)


def test_d_micro_cycles_between_full_cycles_upload_whole_and_say_so(tmp_path):
    """A streaming micro-cycle solves a few tasks over the resident table:
    its task axis differs from the full cycle's, so its statics go up
    whole (counted in its ``last_timings``), and the next full cycle does
    the same; the placements equal the arena-off run's."""
    from kube_batch_tpu_torch.cache import ClusterStore, SchedulerCache
    from kube_batch_tpu_torch.streaming import StreamState, StreamTrigger, smoke_conf

    path = tmp_path / "stream.yaml"
    path.write_text(smoke_conf(True, "cpu"))

    def run(arena_on: bool):
        encode_cache.set_enabled(arena_on)
        store = ClusterStore()
        store.create_queue(build_queue("default"))
        for i in range(6):
            store.create_node(build_node(f"n{i}", build_resource_list(cpu=16, memory="16Gi", pods=64)))

        def arrive(name, members):
            store.create_pod_group(build_pod_group(name, min_member=members))
            for m in range(members):
                store.create_pod(build_pod(name=f"{name}-p{m}", group_name=name,
                                           req=build_resource_list(cpu=1, memory="512Mi")))

        for g in range(3):
            arrive(f"full{g}", 4)
        sched = Scheduler(SchedulerCache(store), scheduler_conf=str(path), schedule_period=5.0)
        trigger, state = StreamTrigger(), StreamState()
        sched._stream_trigger, sched._stream_state = trigger, state
        trigger.attach()
        kinds = []
        action = allocate_action(sched)
        try:
            sched.run_once()
            kinds.append(("full", dict(action.last_timings)))
            arrive("micro0", 2)
            assert sched.run_micro(trigger.drain())
            kinds.append(("micro", dict(action.last_timings)))
            arrive("full3", 4)
            sched.run_once()
            kinds.append(("full", dict(action.last_timings)))
        finally:
            trigger.detach()
            sched.cache.stop()
        placed = {f"{p.namespace}/{p.name}": p.node_name for p in store.list("pods")}
        return placed, kinds

    off, _ = run(False)
    placed, kinds = run(True)
    assert placed == off and all(placed.values())
    counts = [(kind, *(t[f"arena_{k}"] for k in ("reuses", "row_updates", "full_uploads"))) for kind, t in kinds]
    # each cycle uploads B1's two statics once; the micro-cycle's task axis
    # differs from the full cycle's, so at least its task statics go whole
    assert [sum(c[1:]) for c in counts] == [2, 2, 2], counts
    assert counts[0][3] == 2 and counts[1][3] >= 1, counts


# -- the card ----------------------------------------------------------------


@pytest.mark.cuda
def test_row_update_keeps_the_buffer_on_the_card():
    """On the card: a row update writes the resident buffer in place (its
    data_ptr() does not move) through one pinned staging copy, a full
    upload lands exactly by either route (pageable to an idle card, pinned
    staging behind queued work), and a mesh slab splits along its node
    axis."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned, non-blocking uploads run only on a card")
    card = torch.device("cuda", torch.cuda.current_device())
    arena = encode_cache.TensorArena(card)
    rng = np.random.default_rng(0)
    for name, host in (("fused_fstatic", rng.random(4096, dtype=np.float32)),
                       ("node_idle", rng.random((512, 4), dtype=np.float32))):
        dev = arena.upload(name, host)
        assert dev.device == card and dev.dtype == torch.from_numpy(host).dtype
        torch.cuda.synchronize()
        np.testing.assert_array_equal(dev.cpu().numpy(), host)
        ptr = dev.data_ptr()
        churn = host.copy()
        churn[rng.choice(host.shape[0], size=17, replace=False)] += 1
        before = arena.row_updates
        got = arena.upload(name, churn)
        assert arena.row_updates == before + 1
        assert got is dev and got.data_ptr() == ptr
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), churn)
    # a full upload lands exactly by either route: pageable (the card idle)
    # and pinned staging (behind queued work)
    torch.cuda.synchronize()
    for host in (rng.random(1024, dtype=np.float32), rng.random(1 << 20, dtype=np.float32)):
        for busy in (False, True):
            if busy:
                torch.cuda._sleep(2_000_000)
            dev = arena.upload("class_task_req", host.copy())
            torch.cuda.synchronize()
            np.testing.assert_array_equal(dev.cpu().numpy(), host)
            host = host + 1
    # a mesh slab: four shards of the card, split along the node axis
    cnode = rng.integers(0, 2, (6, 512)).astype(np.int32)
    parts = arena.upload("sharded_cnode", cnode, mesh=[card] * 4)
    torch.cuda.synchronize()
    assert len(parts) == 4
    np.testing.assert_array_equal(torch.cat([p.cpu() for p in parts], dim=1).numpy(), cnode)
    assert arena.upload("sharded_cnode", cnode.copy(), mesh=[card] * 4) is parts
