"""The port's cross-cycle encode cache (kube_batch_tpu_torch/ops/encode_cache.py).

The contract: with the cache on (the default), a warm encode — and a
churned re-encode — is byte-identical to a cold encode of the same world,
at float32 (B1's inputs) and at float64 (the scans' inputs); every
scheduling path the port has (the serial action, the fused rung, the
sharded rung) places bind for bind as with the cache off; and the twin
pipeline over two cycles, cache and native loops on and off, gives the
JAX TPU conf's task states, binds and evicts on every test world. The
JAX package runs with jax x64 off (the production float32 policy).

The tensor arena (``TensorArena``, the end of this file) is held against
the JAX arena on seeded sequences of uploads and views: equal counters,
bank, bytes per slab, watermark and contents after every call; the JAX
suite's ``test_arena_reuse_and_row_delta`` and
``test_arena_device_view_passthrough`` run on both arenas.

The cache is process-wide: a fixture invalidates it around each test, so
xdist workers and test order cannot leak state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from kube_batch_tpu.conf import parse_scheduler_conf as jax_parse
from kube_batch_tpu.framework import close_session as jax_close
from kube_batch_tpu.framework import get_action as jax_get_action
from kube_batch_tpu.framework import open_session as jax_open
from kube_batch_tpu.testing import FakeCache as JaxFakeCache
from kube_batch_tpu.testing import x64_enabled

import kube_batch_tpu_torch.scheduler as torch_scheduler
import kube_batch_tpu_torch.testing as torch_testing
from kube_batch_tpu_torch import actions as _torch_actions  # noqa: F401  (registers the port's actions)
from kube_batch_tpu_torch import faults, metrics, native
from kube_batch_tpu_torch import models as torch_models
from kube_batch_tpu_torch import plugins as _torch_plugins  # noqa: F401  (registers the port's plugins)
from kube_batch_tpu_torch.conf import parse_scheduler_conf as torch_parse
from kube_batch_tpu_torch.framework import close_session, get_action, open_session
from kube_batch_tpu_torch.ops import encode_cache
from kube_batch_tpu_torch.ops.encode import encode_session
from kube_batch_tpu_torch.testing import (
    FakeCache,
    build_cluster,
    build_node,
    build_pod,
    build_pod_group,
    build_queue,
    build_resource_list,
)

import test_xla_preempt
import test_xla_reclaim
from test_torch_pipeline import GENERATORS, TPU, TWIN, pipeline_actions
from test_torch_preempt import session_state

CONF = """
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
CPU = {"torch_allocate": {"device": "cpu", "min_device_pairs": "0"}}
DTYPES = pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])


@pytest.fixture(autouse=True)
def _fresh_cache():
    """Every test starts cold, with both switches on and no armed fault."""
    encode_cache.set_enabled(True)
    native.set_enabled(True)
    encode_cache.get().invalidate_all("test")
    faults.registry.reset()
    native.reset_counts()
    yield
    encode_cache.set_enabled(True)
    native.set_enabled(True)
    encode_cache.get().invalidate_all("test")
    faults.registry.reset()
    native.reset_counts()


def _tiers():
    return torch_parse(CONF).tiers


def _encode(ssn, dtype=np.float64):
    return encode_session(
        ssn.jobs, ssn.nodes, ssn.queues, dtype=dtype,
        drf=ssn.plugins.get("drf"), proportion=ssn.plugins.get("proportion"),
        session=ssn,
    )


def _assert_arrays_equal(a, b, what=""):
    assert set(a.arrays) == set(b.arrays)
    for k in a.arrays:
        x, y = np.asarray(a.arrays[k]), np.asarray(b.arrays[k])
        assert x.shape == y.shape and x.dtype == y.dtype, f"{what} arrays[{k}]"
        assert x.tobytes() == y.tobytes(), f"{what} arrays[{k}] diverges"
    assert [t.uid for t in a.tasks] == [t.uid for t in b.tasks]
    assert a.node_names == b.node_names and a.scalar_names == b.scalar_names


def _relabel(node_info, labels):
    """Replace the Node object under a NodeInfo (the watch-event shape)."""
    n = node_info.node
    node_info.set_node(dataclasses.replace(n, metadata=dataclasses.replace(n.metadata, labels=labels)))


# -- encode-level parity -----------------------------------------------------


@DTYPES
def test_warm_encode_byte_identical_to_cold(dtype):
    ssn = open_session(FakeCache(torch_models.multi_queue(400, 64)), _tiers())
    cold = _encode(ssn, dtype)
    assert cold.warm_fraction == 0.0
    warm = _encode(ssn, dtype)
    _assert_arrays_equal(cold, warm, "warm")
    assert warm.warm_fraction > 0.5 and encode_cache.get().warm_fraction == warm.warm_fraction
    close_session(ssn)


@DTYPES
def test_churned_encode_identical_to_fresh_cold(dtype):
    """Node churn (a label flip through set_node) invalidates exactly the
    churned rows: the re-encode equals a fully cold encode of the churned
    world."""
    ssn = open_session(FakeCache(torch_models.multi_queue(400, 64)), _tiers())
    _encode(ssn, dtype)
    for name in sorted(ssn.nodes)[:3]:
        ssn.nodes[name].set_node(
            build_node(name, build_resource_list(cpu=8, memory="16Gi", pods=110), labels={"churn/zone": "z1"})
        )
    churn = _encode(ssn, dtype)
    encode_cache.get().invalidate_all("test")
    _assert_arrays_equal(_encode(ssn, dtype), churn, "churn")
    close_session(ssn)


@DTYPES
def test_pod_churn_through_the_dirty_feed(dtype):
    """Replaced Pod objects of pending tasks, reported through the dirty
    feed: the task block is dropped and the re-encode equals a cold one."""
    ssn = open_session(FakeCache(torch_models.preempt_mix(600, 40, seed=1)), _tiers())
    first = _encode(ssn, dtype)
    from kube_batch_tpu_torch.apis.types import Toleration

    for t in first.tasks[::50]:
        t.pod = dataclasses.replace(
            t.pod, tolerations=[Toleration(key="churn", operator="Exists", effect="NoSchedule")]
        )
        encode_cache.note_store_event("pods", t.uid, t.pod)
    churn = _encode(ssn, dtype)
    assert churn.warm_fraction > 0.5
    assert len(churn.task_reps) > len(first.task_reps)  # the new signature is a new group
    encode_cache.get().invalidate_all("test")
    _assert_arrays_equal(_encode(ssn, dtype), churn, "pod churn")
    close_session(ssn)


def test_session_mutation_invalidates_task_block():
    """state_seq is the task block's freshness key: after the session
    mutates (an allocate), the re-encode sees the shrunken pending set."""
    ssn = open_session(FakeCache(torch_models.multi_queue(120, 16)), _tiers())
    enc1 = _encode(ssn)
    node = next(iter(ssn.nodes.values()))
    ssn.allocate(enc1.tasks[0], node.name)
    enc2 = _encode(ssn)
    assert enc2.n_tasks == enc1.n_tasks - 1
    encode_cache.get().invalidate_all("test")
    _assert_arrays_equal(_encode(ssn), enc2, "post-mutation")
    close_session(ssn)


def test_dtype_is_part_of_the_task_block_key():
    ssn = open_session(FakeCache(torch_models.multi_queue(200, 16)), _tiers())
    f64 = _encode(ssn, np.float64)
    f32 = _encode(ssn, np.float32)
    assert f32.arrays["task_req"].dtype == np.float32 and f64.arrays["task_req"].dtype == np.float64
    encode_cache.get().invalidate_all("test")
    _assert_arrays_equal(_encode(ssn, np.float32), f32, "f32 after f64")
    close_session(ssn)


@DTYPES
def test_selector_affinity_world_parity(dtype):
    """Signature-heavy world (selectors + labeled nodes): the pair memo
    reproduces the compat/affinity products exactly."""
    nodes = [
        build_node(
            f"n{i:03d}", build_resource_list(cpu=4, memory="8Gi", pods=20),
            labels={"disk": "ssd" if i % 2 else "hdd", "zone": f"z{i % 3}"},
        )
        for i in range(24)
    ]
    pods, pgs = [], []
    for j in range(12):
        name = f"job{j:02d}"
        pgs.append(build_pod_group(name, min_member=1))
        for t in range(4):
            pods.append(build_pod(
                name=f"{name}-t{t}", group_name=name, req=build_resource_list(cpu=1, memory="1Gi"),
                node_selector={"disk": "ssd"} if j % 2 else None,
            ))
    ssn = open_session(FakeCache(build_cluster(pods, nodes, pgs, [build_queue("default")])), _tiers())
    cold = _encode(ssn, dtype)
    _assert_arrays_equal(cold, _encode(ssn, dtype), "selector")
    ssn.nodes["n001"].set_node(
        build_node("n001", build_resource_list(cpu=4, memory="8Gi", pods=20), labels={"disk": "nvme", "zone": "z9"})
    )
    churn = _encode(ssn, dtype)
    encode_cache.get().invalidate_all("test")
    _assert_arrays_equal(_encode(ssn, dtype), churn, "selector-churn")
    close_session(ssn)


# -- action-level placement parity --------------------------------------------


def _run_action(make, action="torch_allocate", args=None):
    cache = FakeCache(make())
    ssn = open_session(cache, _tiers(), args if args is not None else CPU)
    get_action(action).execute(ssn)
    state = session_state(ssn)
    close_session(ssn)
    return state, dict(cache.binder.binds)


@pytest.mark.parametrize("mesh", [None, 2, 4])
def test_placements_identical_cache_on_vs_off(mesh):
    """Placements bind for bind identical to the cache-off path on the
    fused rung and on the sharded rung (2 and 4 CPU shards); the cache-on
    runs go twice, the second over the per-object memos."""
    args = {"torch_allocate": {**CPU["torch_allocate"], **({"mesh": f"cpu:{mesh}"} if mesh else {})}}
    make = lambda: torch_models.synthetic(300, 64)  # noqa: E731
    encode_cache.set_enabled(False)
    off = _run_action(make, args=args)
    encode_cache.set_enabled(True)
    on = _run_action(make, args=args)
    on2 = _run_action(make, args=args)
    assert on == off and on2 == off and off[1]


def test_serial_action_untouched_by_cache():
    """The serial allocate does not encode: cache on/off cannot differ."""
    make = lambda: torch_models.synthetic(120, 16)  # noqa: E731
    encode_cache.set_enabled(False)
    off = _run_action(make, "allocate")
    encode_cache.set_enabled(True)
    on = _run_action(make, "allocate")
    assert on == off and not encode_cache.get()._node_static


# -- the encode.cache fault and churn over scheduler cycles ---------------------


def _drive(tmp_path, cache_on: bool, arm_fault: bool):
    """Four Scheduler cycles over one FakeCache: a new gang arrives every
    cycle, a node is relabelled before cycle 3, and with ``arm_fault`` the
    encode.cache fault fires once in cycle 3. Returns the binds of every
    cycle."""
    encode_cache.set_enabled(cache_on)
    encode_cache.get().invalidate_all("test")
    faults.registry.reset()
    conf = tmp_path / "conf.yaml"
    conf.write_text(
        'actions: "enqueue, torch_allocate"\n' + CONF
        + "actionArguments:\n  torch_allocate:\n    device: cpu\n    min_device_pairs: 0\n"
    )
    nodes = [build_node(f"n{i}", build_resource_list(cpu=16, memory="32Gi", pods=64)) for i in range(8)]
    cache = FakeCache(build_cluster([], nodes, [], [build_queue("default")]))
    sched = torch_scheduler.Scheduler(cache, str(conf))
    per_cycle = []
    for cycle in range(4):
        gang = build_cluster(
            [build_pod(name=f"c{cycle}-p{m}", group_name=f"g{cycle}", req=build_resource_list(cpu=1, memory="512Mi"))
             for m in range(4)],
            [], [build_pod_group(f"g{cycle}", min_member=4)], [build_queue("default")],
        )
        cache.cluster.jobs.update(gang.jobs)
        if cycle == 2:
            _relabel(cache.cluster.nodes["n0"], {"churn": "1"})
            if arm_fault:
                faults.registry.arm("encode.cache", count=1)
        sched.run_once()
        per_cycle.append(dict(cache.binder.binds))
    return per_cycle


def test_encode_cache_fault_and_churn_binds_identical(tmp_path):
    """The encode.cache fault fired mid-run and a node churned between
    cycles: binds over the whole run equal the cache-off twin's, and the
    fault dropped the cache (a cold encode, metered)."""
    binds_off = _drive(tmp_path, cache_on=False, arm_fault=False)
    fired0 = metrics.fault_injections.value({"point": "encode.cache"})
    inval0 = metrics.encode_cache_invalidations.value({"reason": "fault"})
    binds_on = _drive(tmp_path, cache_on=True, arm_fault=True)
    assert binds_on == binds_off
    assert len(binds_on[-1]) == 16, "unbound pods left behind"
    assert metrics.fault_injections.value({"point": "encode.cache"}) == fired0 + 1
    assert metrics.encode_cache_invalidations.value({"reason": "fault"}) == inval0 + 1


def test_fault_drops_the_state_and_the_encode_runs_cold():
    ssn = open_session(FakeCache(torch_models.multi_queue(60, 8)), _tiers())
    cold = _encode(ssn)
    ec = encode_cache.get()
    assert ec._node_static and ec._task_block is not None
    faults.registry.arm("encode.cache", count=1)
    poisoned = _encode(ssn)
    assert poisoned.warm_fraction == 0.0 and not ec._node_static and ec._task_block is None
    _assert_arrays_equal(cold, poisoned, "poisoned")
    assert _encode(ssn).warm_fraction == 0.0  # rebuilt from nothing, then warm again
    assert _encode(ssn).warm_fraction > 0.5
    close_session(ssn)


# -- dirty feed + metrics ----------------------------------------------------


def test_dirty_feed_drops_entries_and_meters():
    ec = encode_cache.get()
    ssn = open_session(FakeCache(torch_models.multi_queue(60, 8)), _tiers())
    enc = _encode(ssn)
    assert ec._node_static and ec._pod_sigs is not None
    name = next(iter(ec._node_static))
    v0 = ec.version
    before = metrics.encode_cache_invalidations.value({"reason": "nodes"})
    encode_cache.note_store_event("nodes", name)
    assert name not in ec._node_static
    assert ec.version == v0 + 1
    assert metrics.encode_cache_invalidations.value({"reason": "nodes"}) == before + 1
    # a pod event drops the task block and the pod's signature memo
    ec.task_sig(enc.tasks[0], False, lambda t, w: ("sig",))
    assert ec._task_block is not None and enc.tasks[0].uid in ec._pod_sigs
    pods_before = metrics.encode_cache_invalidations.value({"reason": "pods"})
    encode_cache.note_store_event("pods", enc.tasks[0].uid)
    assert ec._task_block is None and enc.tasks[0].uid not in ec._pod_sigs
    assert metrics.encode_cache_invalidations.value({"reason": "pods"}) == pods_before + 1
    close_session(ssn)


def test_store_listeners_get_every_event_and_never_raise():
    seen = []
    base = encode_cache.listener_count()

    def listener(kind, key, obj, old):
        seen.append((kind, key, obj, old))

    def broken(kind, key, obj, old):
        raise RuntimeError("a trigger bug")

    encode_cache.add_store_listener(listener)
    encode_cache.add_store_listener(listener)  # idempotent
    encode_cache.add_store_listener(broken)
    assert encode_cache.listener_count() == base + 2
    encode_cache.set_enabled(False)  # listeners hear the feed with the cache off too
    encode_cache.note_store_event("nodes", "n0", "new", "old")
    encode_cache.remove_store_listener(listener)
    encode_cache.remove_store_listener(broken)
    encode_cache.remove_store_listener(broken)
    encode_cache.note_store_event("nodes", "n1")
    assert seen == [("nodes", "n0", "new", "old")]
    assert encode_cache.listener_count() == base


def test_warm_fraction_metric_set():
    ssn = open_session(FakeCache(torch_models.multi_queue(60, 8)), _tiers())
    hits = metrics.encode_cache_hits.value()
    _encode(ssn)
    assert metrics.encode_warm_fraction.value() == 0.0
    _encode(ssn)
    assert metrics.encode_warm_fraction.value() > 0.5
    assert metrics.encode_cache_hits.value() > hits
    close_session(ssn)


def test_disabled_cache_is_inert():
    encode_cache.set_enabled(False)
    ec = encode_cache.get()
    ssn = open_session(FakeCache(torch_models.multi_queue(60, 8)), _tiers())
    a, b = _encode(ssn), _encode(ssn)
    assert ec._task_block is None and not ec._node_static and not ec._pairs
    assert a.warm_fraction == b.warm_fraction == 0.0
    encode_cache.note_store_event("nodes", "n0")
    assert ec.version == 0 or not ec._node_static
    close_session(ssn)


def test_capacity_backstop_clears_the_memos(monkeypatch):
    ssn = open_session(FakeCache(torch_models.multi_queue(60, 8)), _tiers())
    _encode(ssn)
    ec = encode_cache.get()
    monkeypatch.setattr(encode_cache, "_MAX_NODE_ENTRIES", 1)
    before = metrics.encode_cache_invalidations.value({"reason": "capacity"})
    ec.begin_encode()
    assert not ec._node_static and not ec._pod_sigs
    assert metrics.encode_cache_invalidations.value({"reason": "capacity"}) == before + 1
    close_session(ssn)


# -- the twin pipeline over two cycles against the JAX TPU conf --------------------


def _churn(cluster):
    """The same between-cycle churn in either package's cluster: the first
    node's Node object replaced by a relabelled copy."""
    name = sorted(cluster.nodes)[0]
    _relabel(cluster.nodes[name], {**cluster.nodes[name].node.metadata.labels, "churn": "1"})


def _jax_two_cycles(cluster, text):
    actions = pipeline_actions(text, jax_parse)
    out = []
    with x64_enabled(False):
        cache = JaxFakeCache(cluster)
        for cycle in range(2):
            if cycle:
                _churn(cache.cluster)
            ssn = jax_open(cache, jax_parse(text).tiers)
            for name in actions:
                jax_get_action(name).execute(ssn)
            state = session_state(ssn)
            jax_close(ssn)
            out.append((state, dict(cache.binder.binds), list(cache.evictor.evicts)))
    return out


def _torch_two_cycles(cluster, conf_path, monkeypatch):
    cache = torch_testing.FakeCache(cluster)
    sched = torch_scheduler.Scheduler(cache, conf_path)
    close = torch_scheduler.close_session
    out = []
    for cycle in range(2):
        if cycle:
            _churn(cache.cluster)
        seen = {}

        def capture(ssn, discard=False):
            seen.update(session_state(ssn))
            close(ssn, discard=discard)

        monkeypatch.setattr(torch_scheduler, "close_session", capture)
        sched.run_once()
        monkeypatch.undo()
        out.append((seen, dict(cache.binder.binds), list(cache.evictor.evicts)))
    return out, sched


@pytest.mark.parametrize("gen", GENERATORS)
@pytest.mark.parametrize("seed", range(12))
def test_twin_pipeline_two_cycles_equal_the_tpu_conf(tmp_path, monkeypatch, gen, seed):
    jax_gen = getattr({"gen_contended_cluster": test_xla_preempt,
                       "gen_contended_reclaim_cluster": test_xla_reclaim}[gen], gen)
    with open(TPU) as f:
        tpu_text = f.read()
    want = _jax_two_cycles(jax_gen(seed), tpu_text)
    with open(TWIN) as f:
        twin = f.read() + "actionArguments:\n  torch_allocate:\n    device: cpu\n    min_device_pairs: 0\n"
    path = tmp_path / "twin.yaml"
    path.write_text(twin)
    got_on, sched = _torch_two_cycles(getattr(torch_testing, gen)(seed), str(path), monkeypatch)
    assert got_on == want, f"{gen} seed {seed}, cache and native on"
    assert not native.fallbacks
    timings = [getattr(a, "last_timings", {}) for a in sched.actions]
    warm = [t["warm_fraction"] for t in timings if "encode_s" in t]
    assert warm and max(warm) > 0.5, "the second cycle's encodes ran cold"
    encode_cache.set_enabled(False)
    native.set_enabled(False)
    native.reset_counts()
    got_off, _ = _torch_two_cycles(getattr(torch_testing, gen)(seed), str(path), monkeypatch)
    assert got_off == want, f"{gen} seed {seed}, cache and native off"
    assert not native.calls


# -- tensor arena ------------------------------------------------------------


def _arena_pair():
    from kube_batch_tpu.ops.encode_cache import TensorArena as JaxArena

    return encode_cache.TensorArena("cpu"), JaxArena()


def _arena_state(a) -> tuple:
    return (a.bank, a.reuses, a.row_updates, a.full_uploads, a.rows_uploaded, a.hbm_bytes_by_slab(),
            a.hbm_watermark_bytes)


def test_arena_reuse_and_row_delta():
    for arena in _arena_pair():
        host = np.arange(32.0).reshape(8, 4)
        d1 = arena.upload("node_idle", host)
        assert arena.full_uploads == 1
        # identical content, different object -> buffer reuse, no upload
        d2 = arena.upload("node_idle", host.copy())
        assert arena.reuses == 1 and d2 is d1
        # one changed row -> an in-place row update, not a full transfer
        churn = host.copy()
        churn[3] = [100.0, 101.0, 102.0, 103.0]
        d3 = arena.upload("node_idle", churn)
        assert arena.row_updates == 1 and arena.rows_uploaded == 1
        np.testing.assert_array_equal(np.asarray(d3), churn)
        # many changed rows -> full re-upload
        big = churn * 7.0
        d4 = arena.upload("node_idle", big)
        assert arena.full_uploads == 2
        np.testing.assert_array_equal(np.asarray(d4), big)
        # shape change -> fresh buffer
        grown = np.ones((16, 4))
        d5 = arena.upload("node_idle", grown)
        assert arena.full_uploads == 3
        np.testing.assert_array_equal(np.asarray(d5), grown)


def test_arena_row_update_keeps_the_buffer():
    """The port's row update writes the resident buffer in place: the
    tensor returned is the same object at the same data pointer."""
    arena = encode_cache.TensorArena("cpu")
    host = np.arange(40, dtype=np.float32)
    d1 = arena.upload("fused_fstatic", host)
    ptr = d1.data_ptr()
    churn = host.copy()
    churn[[2, 17]] = -1
    d2 = arena.upload("fused_fstatic", churn)
    assert d2 is d1 and d2.data_ptr() == ptr and arena.row_updates == 1 and arena.rows_uploaded == 2
    np.testing.assert_array_equal(d2.numpy(), churn)
    assert not np.shares_memory(d2.numpy(), churn)  # the device copy never aliases the host memo
    # B1's int buffer is never row updated: reused or uploaded whole
    ints = np.arange(40, dtype=np.int32)
    i1 = arena.upload("fused_istatic", ints)
    ints2 = ints.copy()
    ints2[3] = -1
    assert arena.upload("fused_istatic", ints2) is not i1 and arena.row_updates == 1 and arena.full_uploads == 3


def test_arena_device_view_passthrough():
    arrays = {
        "node_idle": np.ones((8, 4)),
        "compat": np.ones((2, 3), bool),
        "node_gid": np.zeros(8, np.int32),  # unmanaged: passes through
    }
    for arena in _arena_pair():
        view = arena.device_view(arrays)
        assert view["node_gid"] is arrays["node_gid"]
        np.testing.assert_array_equal(np.asarray(view["node_idle"]), arrays["node_idle"])
        np.testing.assert_array_equal(np.asarray(view["compat"]), arrays["compat"])


_ARENA_SLABS = {  # name -> (rows, trailing shape, dtype)
    "node_idle": (24, (4,), np.float32),
    "node_alloc": (24, (4,), np.float32),
    "task_req": (10, (4,), np.float32),
    "compat": (6, (24,), np.bool_),
    "class_members": (24, (), np.int32),
}


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_arena_equals_the_jax_arena_on_seeded_sequences(monkeypatch, seed, pipelined):
    """Both arenas take the same seeded sequence of uploads and views (the
    same object again, an equal copy, a few rows changed, most rows
    changed, a shape change, a dtype change); after every call their
    counters, bank, bytes per slab, watermark and the returned contents
    are equal."""
    from kube_batch_tpu_torch import pipeline

    if pipelined:
        monkeypatch.setenv(pipeline.ENV, "1")
    else:
        monkeypatch.delenv(pipeline.ENV, raising=False)
    rng = np.random.default_rng(seed)
    port, ref = _arena_pair()
    last: dict = {}

    def fresh(name, rows=None, dtype=None):
        n, tail, dt = _ARENA_SLABS[name]
        shape = (rows or n,) + tail
        dt = dtype or dt
        if dt == np.bool_:
            return rng.random(shape) < 0.5
        return rng.integers(0, 50, size=shape).astype(dt)

    def next_host(name):
        prev = last.get(name)
        op = rng.integers(0, 6) if prev is not None else 4
        if op == 0:
            return prev  # the same object
        if op == 1:
            return prev.copy()
        x = prev.copy() if op in (2, 3) else None
        if op == 2:  # a few rows
            rows = rng.choice(x.shape[0], size=max(1, x.shape[0] // 8), replace=False)
            x[rows] = fresh(name, rows=len(rows), dtype=x.dtype)
        elif op == 3:  # most rows
            x = fresh(name, rows=x.shape[0], dtype=x.dtype)
        elif op == 4:
            x = fresh(name, rows=int(rng.choice([_ARENA_SLABS[name][0], _ARENA_SLABS[name][0] * 2])))
        else:
            x = prev.astype(np.float64) if prev.dtype != np.float64 else prev.astype(np.float32)
        return x

    for _ in range(40):
        if rng.random() < 0.3:
            arrays = {name: next_host(name) for name in ("node_idle", "node_alloc", "task_req", "compat")}
            last.update(arrays)
            got, want = port.device_view(arrays), ref.device_view(arrays)
            pairs = [(got[k], want[k], arrays[k]) for k in arrays]
        else:
            name = str(rng.choice(sorted(_ARENA_SLABS)))
            host = next_host(name)
            last[name] = host
            pairs = [(port.upload(name, host), ref.upload(name, host), host)]
        for g, w, h in pairs:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            np.testing.assert_array_equal(g.numpy(), h)
        assert _arena_state(port) == _arena_state(ref)
    assert port.reuses and port.row_updates and port.full_uploads
