"""The port's unschedulability forensics (obs/explain.py, ops/explain.py),
case for case with tests/test_explain.py, then held against the JAX
package.

The port schedules with ``enqueue, torch_allocate`` on ``device: cpu``
with the size floor off (``min_device_pairs: 0``), the JAX suite's
``enqueue, xla_allocate``; the mesh cases use ``mesh: cpu:N`` (the
sharded rung, kernel B2's plain version) where the JAX suite shards over
its virtual CPU devices. The parity cases at the end feed both packages
the same numpy inputs: ``explain_batch`` over seeded random arrays with
planted ties (integers and booleans equal, scores equal at float32 with
tolerance 0), and the records of serial, fused and sharded against the
JAX serial, XLA and mesh records on ``_smoke_world()`` as canonical JSON.
The port-only cases: the pipelined cycle's deferred closure makes no CUDA
call with explain on, and an aborted cycle leaves no record. The card
test holds ``explain_batch`` on the card against its CPU run.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import kube_batch_tpu_torch.actions  # noqa: F401
import kube_batch_tpu_torch.plugins  # noqa: F401
from kube_batch_tpu_torch import obs, pipeline
from kube_batch_tpu_torch.apis.types import POD_GROUP_UNSCHEDULABLE_TYPE
from kube_batch_tpu_torch.cache import ClusterStore, SchedulerCache
from kube_batch_tpu_torch.cache.store import POD_GROUPS, PODS
from kube_batch_tpu_torch.conf import parse_scheduler_conf
from kube_batch_tpu_torch.framework import close_session, get_action, open_session
from kube_batch_tpu_torch.obs import explain
from kube_batch_tpu_torch.ops import explain as ops_explain
from kube_batch_tpu_torch.recovery import WriteIntentJournal
from kube_batch_tpu_torch.scheduler import Scheduler
from kube_batch_tpu_torch.testing import (
    FakeCache,
    build_node,
    build_pod,
    build_pod_group,
    build_queue,
    build_resource_list,
)

TORCH_CONF = """
actions: "enqueue, torch_allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: predicates
  - name: nodeorder
actionArguments:
  torch_allocate:
    device: cpu
    min_device_pairs: 0
"""

SMOKE_TIERS_TORCH = explain._SMOKE_TIERS.replace('actions: "allocate"', 'actions: "torch_allocate"')


@pytest.fixture
def explaining(monkeypatch):
    """Explain on through the environment (the switch the scheduler's conf
    reload re-resolves every cycle), registry cleared."""
    monkeypatch.setenv(explain.ENV, "1")
    explain.configure()
    explain.records.clear()
    yield
    explain.configure("off")
    explain.records.clear()


def wait_until(pred, timeout=15.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


def run_smoke_world(action_name, mesh=None):
    """One session over the seeded per-plane world through the action
    registry; returns (records, engaged mesh size, jobs)."""
    tiers_yaml = explain._SMOKE_TIERS if action_name == "allocate" else SMOKE_TIERS_TORCH
    cache = FakeCache(explain._smoke_world())
    args = {"torch_allocate": {"device": "cpu", "min_device_pairs": "0"}}
    if mesh:
        args["torch_allocate"]["mesh"] = mesh
    ssn = open_session(cache, parse_scheduler_conf(tiers_yaml).tiers, args)
    action = get_action(action_name)
    try:
        action.execute(ssn)
        jobs = dict(ssn.jobs)
    finally:
        close_session(ssn)
    recs = dict(getattr(ssn, "explain_records", {}) or {})
    return recs, getattr(action, "last_mesh_size", 1), jobs


def canon(recs):
    return json.dumps(recs, sort_keys=True)


# -- parity: serial = fused = sharded -----------------------------------------


def test_explain_parity_serial_xla_mesh(explaining):
    """Records from the serial action's task-by-task twin, the fused rung's
    batched pass and the sharded rung's at 2, 4 and 8 shards are equal as
    canonical JSON."""
    serial, _, _ = run_smoke_world("allocate")
    fused, mesh1, _ = run_smoke_world("torch_allocate")
    assert mesh1 == 1
    assert serial and canon(serial) == canon(fused)
    for n in (2, 4, 8):
        sharded, mesh_n, _ = run_smoke_world("torch_allocate", mesh=f"cpu:{n}")
        assert mesh_n == n, f"mesh cpu:{n} did not engage"
        assert canon(sharded) == canon(fused)


def test_designed_reasons_and_would_fit_if(explaining):
    recs, _, _ = run_smoke_world("torch_allocate")
    expected = {
        "default/g-static": "static",
        "default/g-resources": "resources",
        "default/g-ports": "ports",
        "default/g-room": "room",
    }
    for uid, plane in expected.items():
        rec = recs[uid]
        assert rec["verdict"] == "unschedulable"
        assert rec["reason"] == plane
        assert rec["feasible"] == 0
        assert rec["would_fit_if"][plane], f"{uid}: {plane} not a would-fit fix"
        assert rec["eliminated"][plane] > 0
        assert rec["near_miss"], f"{uid}: no near-miss nodes"
        for nm in rec["near_miss"]:
            assert set(nm["planes"]) == set(explain.PLANES)
    bound = recs["default/g-bound"]
    assert bound["verdict"] == "bound" and bound["reason"] == "bound"
    assert bound["ready"] >= bound["min"]


def test_ports_gang_reads_ports_not_static(explaining):
    recs, _, _ = run_smoke_world("torch_allocate")
    rec = recs["default/g-ports"]
    assert rec["eliminated"]["static"] > rec["eliminated"]["ports"]
    assert rec["would_fit_if"]["static"] and rec["would_fit_if"]["ports"]
    assert rec["reason"] == "ports"


# -- conditions ---------------------------------------------------------------


def test_conditions_carry_reason_and_forensics_message(explaining):
    _, _, jobs = run_smoke_world("torch_allocate")
    for uid, plane in (("default/g-ports", "ports"), ("default/g-room", "room")):
        conds = jobs[uid].pod_group.status.conditions
        assert conds, f"{uid}: no condition written"
        last = conds[-1]
        assert last.type == POD_GROUP_UNSCHEDULABLE_TYPE
        assert last.reason == plane
        assert "nodes feasible" in last.message
        assert plane in last.message.split("would fit if: ")[1]
    bound_conds = jobs["default/g-bound"].pod_group.status.conditions
    assert all(c.reason not in explain.PLANES for c in bound_conds)


# -- off path -----------------------------------------------------------------


def test_off_cycle_records_nothing(tmp_path):
    assert not explain.enabled()
    recs, _, jobs = run_smoke_world("torch_allocate")
    assert recs == {}
    assert explain.records.snapshot() == []
    for uid in ("default/g-ports", "default/g-room"):
        conds = jobs[uid].pod_group.status.conditions
        assert conds and conds[-1].reason not in explain.PLANES


def test_off_overhead_is_one_branch():
    assert not explain.enabled()
    n = 20_000
    t0 = time.perf_counter()
    for _ in range(n):
        if explain.enabled():  # pragma: no cover - off in this test
            explain.explain_session(None)
    off_cost = (time.perf_counter() - t0) / n
    assert off_cost < 5e-5


# -- scheduler integration: journal, debug endpoint, hot reload ---------------


def seed_store(store, stuck=True):
    store.create_queue(build_queue("default"))
    for i in range(4):
        store.create_node(build_node(f"n{i}", build_resource_list(cpu=16, memory="16Gi", pods=32)))
    store.create_pod_group(build_pod_group("g-fit", min_member=3))
    for m in range(3):
        store.create_pod(build_pod(
            name=f"g-fit-p{m}", group_name="g-fit",
            req=build_resource_list(cpu=1, memory="512Mi"),
        ))
    if stuck:
        store.create_pod_group(build_pod_group("g-stuck", min_member=1))
        store.create_pod(build_pod(
            name="g-stuck-p0", group_name="g-stuck",
            req=build_resource_list(cpu=999, memory="512Mi"),
        ))


def make_scheduler(store, tmp_path, conf=TORCH_CONF, journal=None, period=0.05):
    path = tmp_path / "conf.yaml"
    path.write_text(conf)
    cache = SchedulerCache(store, journal=journal)
    return cache, Scheduler(cache, scheduler_conf=str(path), schedule_period=period)


def test_journal_intents_carry_explain_field(tmp_path, explaining):
    store = ClusterStore()
    seed_store(store)
    jpath = tmp_path / "j.wal"
    _, sched = make_scheduler(store, tmp_path, journal=WriteIntentJournal(str(jpath)))
    sched.run_once()
    assert sched.cache.binder
    lines = [json.loads(ln) for ln in jpath.read_text().splitlines()]
    intents = [r for r in lines if r.get("rec") == "intent"]
    assert intents, "no bind intents journaled"
    tagged = [r for r in intents if "explain" in r]
    assert tagged, "no intent carried an explain payload"
    for r in tagged:
        assert r["explain"]["verdict"] == "bound"
        assert r["explain"]["reason"] == "bound"
        assert r["explain"]["ready"] >= r["explain"]["min"]
    stuck = explain.records.get("default/g-stuck")
    assert stuck is not None and stuck["verdict"] == "unschedulable"
    assert stuck["reason"] == "resources"


def test_debug_explain_endpoint(tmp_path, explaining):
    from kube_batch_tpu_torch.server import SchedulerServer

    store = ClusterStore()
    seed_store(store)
    _, sched = make_scheduler(store, tmp_path)
    sched.run_once()
    conf = tmp_path / "server.yaml"
    conf.write_text(TORCH_CONF)
    server = SchedulerServer(
        scheduler_name="explain-test", listen_address="127.0.0.1:0",
        schedule_period=60.0, scheduler_conf=str(conf),
    )
    server.start()
    try:
        def get(path):
            url = f"http://127.0.0.1:{server.listen_port}{path}"
            with urllib.request.urlopen(url, timeout=5) as r:
                return r.status, json.loads(r.read().decode())

        status, payload = get("/debug/explain")
        assert status == 200 and payload["enabled"]
        names = {r["name"] for r in payload["records"]}
        assert {"default/g-fit", "default/g-stuck"} <= names
        assert payload["aggregate"]["unschedulable"] >= 1
        assert payload["aggregate"]["reasons"].get("resources", 0) >= 1

        status, one = get("/debug/explain?gang=default/g-stuck")
        assert status == 200 and len(one["records"]) == 1
        assert one["records"][0]["reason"] == "resources"
        assert one["records"][0]["would_fit_if"]["resources"]
    finally:
        server.stop()


def test_conf_explain_key_hot_reloads_the_switch(tmp_path):
    store = ClusterStore()
    seed_store(store, stuck=False)
    conf = tmp_path / "conf.yaml"
    conf.write_text(TORCH_CONF + 'explain: "on"\n')
    cache = SchedulerCache(store)
    sched = Scheduler(cache, scheduler_conf=str(conf), schedule_period=0.05)
    try:
        sched._load_conf()
        assert explain.enabled()
        conf.write_text(TORCH_CONF + 'explain: "off"\n')
        sched._load_conf()
        assert not explain.enabled()
    finally:
        explain.configure("off")


# -- streaming: dirty gangs only ----------------------------------------------

STREAM_CONF = TORCH_CONF + "streaming: true\n"


def test_micro_cycle_explains_dirty_gangs_only(tmp_path, explaining):
    store = ClusterStore()
    seed_store(store)  # g-fit binds, g-stuck stays unschedulable
    cache, sched = make_scheduler(store, tmp_path, conf=STREAM_CONF, period=30.0)
    stop = threading.Event()
    t = threading.Thread(target=sched.run, args=(stop,), daemon=True)
    t.start()
    try:
        wait_until(lambda: explain.records.get("default/g-stuck") is not None,
                   what="full-cycle explain record for g-stuck")
        stuck_before = explain.records.get("default/g-stuck")
        assert stuck_before["reason"] == "resources"
        micro_before = sched.micro_cycles_run
        store.create_pod_group(build_pod_group("g-new", min_member=2))
        for m in range(2):
            store.create_pod(build_pod(
                name=f"g-new-p{m}", group_name="g-new",
                req=build_resource_list(cpu=1, memory="512Mi"),
            ))
        wait_until(lambda: sum(1 for p in store.list(PODS) if p.node_name) >= 5,
                   what="micro-cycle binds for g-new")
    finally:
        stop.set()
        t.join(timeout=10.0)
        cache.stop()
    if sched.micro_cycles_run > micro_before:
        micro_spans = [
            s for s in obs.recorder.spans() if s["name"] == "explain" and s["attrs"].get("micro")
        ] if obs.enabled() else []
        for s in micro_spans:
            assert s["attrs"]["gangs"] <= 1
    new_rec = explain.records.get("default/g-new")
    assert new_rec is not None and new_rec["verdict"] == "bound"
    stuck = explain.records.get("default/g-stuck")
    assert stuck is not None and stuck["reason"] == "resources"
    twin_store = ClusterStore()
    seed_store(twin_store)
    twin_store.create_pod_group(build_pod_group("g-new", min_member=2))
    for m in range(2):
        twin_store.create_pod(build_pod(
            name=f"g-new-p{m}", group_name="g-new",
            req=build_resource_list(cpu=1, memory="512Mi"),
        ))
    explain.records.clear()
    _, twin = make_scheduler(twin_store, tmp_path)
    twin.run_once()
    twin_rec = explain.records.get("default/g-new")
    assert twin_rec is not None
    assert {k: new_rec[k] for k in ("verdict", "reason", "min")} == \
        {k: twin_rec[k] for k in ("verdict", "reason", "min")}


# -- federation: shard-local reasons + cross-shard aggregate ------------------


def test_federated_shards_aggregate_matches_single_twin(tmp_path, explaining):
    from kube_batch_tpu_torch.federation import FederatedCache

    store = ClusterStore()
    seed_store(store)
    shard_records = {}
    for shard in range(2):
        explain.records.clear()
        path = tmp_path / f"conf-{shard}.yaml"
        path.write_text(TORCH_CONF)
        cache = FederatedCache(store, shard=shard, shards=2, shard_key="gang")
        sched = Scheduler(cache, scheduler_conf=str(path), schedule_period=0.05)
        sched.run_once()
        shard_records[shard] = {r["name"]: r for r in explain.records.snapshot()}
    names = [set(r) for r in shard_records.values()]
    assert names[0].isdisjoint(names[1])
    assert names[0] | names[1] == {"default/g-fit", "default/g-stuck"}
    stuck_shard = 0 if "default/g-stuck" in names[0] else 1
    assert shard_records[stuck_shard]["default/g-stuck"]["reason"] == "resources"
    agg = explain.aggregate_conditions(store.list(POD_GROUPS))
    assert agg["unschedulable"] == 1
    assert agg["reasons"] == {"resources": 1}
    twin_store = ClusterStore()
    seed_store(twin_store)
    explain.records.clear()
    _, twin = make_scheduler(twin_store, tmp_path)
    twin.run_once()
    assert agg == explain.aggregate_conditions(twin_store.list(POD_GROUPS))


# -- registry bounds ----------------------------------------------------------


def test_registry_is_bounded_and_lru():
    reg = explain._Registry(max_records=3)
    for i in range(5):
        reg.update({f"g{i}": {"gang": f"g{i}"}})
    assert len(reg.snapshot()) == 3
    assert reg.get("g0") is None and reg.get("g4") is not None
    reg.update({"g2": {"gang": "g2", "touched": True}})  # moves to back
    reg.update({"g5": {"gang": "g5"}})
    assert reg.get("g2") is not None
    reg.clear()
    assert reg.snapshot() == []


# -- the port's own: the deferred closure and the abort -----------------------


def _pipe_scheduler(tmp_path, store):
    cache = SchedulerCache(store)
    path = tmp_path / "pipe.yaml"
    path.write_text(TORCH_CONF)
    return cache, Scheduler(cache, scheduler_conf=str(path), schedule_period=5.0)


def test_pipelined_explain_runs_before_submit_and_the_closure_makes_no_cuda_call(
    tmp_path, monkeypatch, explaining
):
    """Under KBT_PIPELINE the batched pass runs on the scheduling thread
    before the deferred dispatch is submitted, and the deferred closure,
    which publishes the records, makes no CUDA call and holds no tensor."""
    from test_torch_pipelined_cycles import _cells

    monkeypatch.setenv("KBT_PIPELINE", "1")
    pipeline.reset()
    store = ClusterStore()
    seed_store(store)
    _, sched = _pipe_scheduler(tmp_path, store)
    events = []
    real_batch = ops_explain.explain_batch

    def batch(*a, **k):
        events.append(("pass", threading.current_thread()))
        return real_batch(*a, **k)

    real_records = explain.post_solve_records

    def records(*a, **k):
        events.append(("records", threading.current_thread()))
        return real_records(*a, **k)

    monkeypatch.setattr(ops_explain, "explain_batch", batch)
    monkeypatch.setattr(explain, "post_solve_records", records)
    captured = []
    real_submit = pipeline.submit

    def submit(cache, fn):
        events.append(("submit", threading.current_thread()))
        captured.append(fn)
        calls = []

        def no_cuda(name):
            def refuse(*a, **k):
                calls.append(name)
                raise AssertionError(f"the deferred dispatch called torch.cuda.{name}")
            return refuse

        with monkeypatch.context() as m:
            for name in ("synchronize", "set_device", "current_device", "current_stream", "is_available",
                         "device_count"):
                m.setattr(torch.cuda, name, no_cuda(name))
            m.setattr(torch.Tensor, "cuda", lambda *a, **k: no_cuda("Tensor.cuda")())
            fut = real_submit(cache, fn)
            fut.exception(timeout=10.0)
        assert not calls
        return fut

    monkeypatch.setattr(pipeline, "submit", submit)
    try:
        sched.run_once()
    finally:
        pipeline.reset()
    main = threading.current_thread()
    assert [e for e, _ in events] == ["pass", "submit", "records"], events
    assert events[0][1] is main and events[1][1] is main
    assert len(captured) == 1
    cells = _cells(captured[0])
    assert not [v for v in cells if isinstance(v, torch.Tensor)], "the closure holds a tensor"
    fx = [v for v in cells if isinstance(v, explain.Forensics)]
    assert len(fx) == 1 and all(isinstance(x, np.ndarray) for x in fx[0].out)
    assert explain.records.get("default/g-stuck")["reason"] == "resources"


@pytest.mark.parametrize("pipelined", [False, True])
def test_overrun_abort_leaves_no_explain_record(tmp_path, monkeypatch, explaining, pipelined):
    """``cycle.overrun`` aborts the cycle at the dispatch barrier: no
    record reaches the registry or the session, synchronous or pipelined;
    the next cycle publishes them."""
    from kube_batch_tpu_torch import faults

    if pipelined:
        monkeypatch.setenv("KBT_PIPELINE", "1")
    pipeline.reset()
    store = ClusterStore()
    seed_store(store)
    cache, sched = _pipe_scheduler(tmp_path, store)
    sched._hard_deadline = 60.0
    faults.registry.arm("cycle.overrun", count=1)
    try:
        sched.run_once()
        assert sched.last_timings.get("aborted"), sched.last_timings
        assert explain.records.snapshot() == []
        assert not any(p.node_name for p in store.list(PODS))
        sched.run_once()
        assert explain.records.get("default/g-stuck")["reason"] == "resources"
        assert explain.records.get("default/g-fit")["verdict"] == "bound"
    finally:
        faults.registry.reset()
        pipeline.reset()


def test_fused_inputs_equal_uploaded_inputs(explaining):
    """The fused rung's pass over kernel B1's packed statics and final
    state buffers equals the pass over the uploaded explain subset, on a
    world with pending gangs and on one with live pod-affinity scores."""
    from kube_batch_tpu_torch.actions.torch_allocate import TorchAllocateAction
    from kube_batch_tpu_torch.apis.types import Affinity, PodAffinityTerm
    from kube_batch_tpu_torch.models import preempt_mix

    # preferred pod affinity on eight gangs' first pods: each is stepped on
    # the host, and once one is resident the group's InterPodAffinity
    # scores are live (folded into B1's affinity table, left out of explain)
    affine = preempt_mix(2000, 40, seed=1)
    jobs = sorted((j for j in affine.jobs.values() if j.name.startswith("job-")), key=lambda j: j.uid)
    for job in jobs[::3][:8]:
        pod = min(job.tasks.values(), key=lambda t: t.uid).pod
        pod.metadata.labels = {"app": "web"}
        pod.affinity = Affinity(pod_affinity_preferred=[(10, PodAffinityTerm(label_selector={"app": "web"}))])
    for world in (preempt_mix(2000, 40, seed=1), explain._smoke_world(), affine):
        cache = FakeCache(world)
        ssn = open_session(cache, parse_scheduler_conf(SMOKE_TIERS_TORCH).tiers,
                           {"torch_allocate": {"device": "cpu", "min_device_pairs": "0"}})
        captured = {}
        real = explain.forensics

        def spy(enc, arrays, state, inputs=None, topk=explain.TOP_K):
            captured.update(enc=enc, arrays=arrays, state=state, inputs=inputs)
            return real(enc, arrays, state, inputs, topk)

        action = TorchAllocateAction()
        try:
            explain.forensics = spy
            action.execute(ssn)
        finally:
            explain.forensics = real
            close_session(ssn)
        assert action.last_solver_tier == "fused"
        if world is affine:
            assert action.last_timings["host_steps"] > 0
            assert np.asarray(captured["arrays"]["pod_sc"]).any()
        fused = real(captured["enc"], captured["arrays"], captured["state"], captured["inputs"])
        uploaded = real(captured["enc"], captured["arrays"], captured["state"], None)
        assert fused.job_rows == uploaded.job_rows and fused.out is not None
        for x, y in zip(fused.out, uploaded.out):
            assert x.dtype == y.dtype and np.array_equal(x, y)


# -- held against the JAX package ---------------------------------------------


def _random_world(seed: int, n_valid: int | None = None):
    """Seeded arrays for one explain pass: identical node capacities plant
    score ties, ``n_valid`` below k plants exhausted near-miss lists."""
    T, N, R, P, GT, NG = 40, 24, 3, 4, 5, 4
    rng = np.random.default_rng(seed)
    f = np.float32
    n_valid = N - 3 if n_valid is None else n_valid
    a = {
        "task_req": rng.integers(0, 4, (T, R)).astype(f) * f(500),
        "task_res": rng.integers(0, 4, (T, R)).astype(f) * f(500),
        "task_gid": rng.integers(0, GT, T).astype(np.int32),
        "task_has_sc": rng.random(T) < 0.2,
        "task_ports": rng.random((T, P)) < 0.15,
        "node_ok": (np.arange(N) < n_valid) & (rng.random(N) < 0.9),
        "node_valid": np.arange(N) < n_valid,
        "node_gid": rng.integers(0, NG, N).astype(np.int32),
        "node_max_tasks": rng.integers(0, 6, N).astype(np.int32),
        "node_alloc": np.repeat(np.array([[4000, 8000, 2000]], f), N, 0),
        "node_idle_has_sc": rng.random(N) < 0.5,
        "node_rel_has_sc": rng.random(N) < 0.5,
        "compat": rng.random((GT, NG)) < 0.7,
        "aff_sc": rng.integers(0, 3, (GT, NG)).astype(f),
        "eps": np.full(R, 1e-3, f),
        "w_least": f(1), "w_balanced": f(1), "w_aff": f(2),
    }
    idle = (rng.integers(0, 8, (N, R)) * 500).astype(f)
    rel = (rng.integers(0, 4, (N, R)) * 500).astype(f)
    used = a["node_alloc"] - idle
    ntasks = rng.integers(0, 6, N).astype(np.int32)
    nports = rng.random((N, P)) < 0.2
    rows = ops_explain.pad_rows(list(range(0, T, 3)))
    return a, (idle, rel, used, ntasks, nports), rows


@pytest.mark.parametrize("n_valid", [None, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_explain_batch_matches_jax_on_random_arrays_with_planted_ties(seed, n_valid):
    from kube_batch_tpu.ops import explain as jax_explain
    from kube_batch_tpu.testing import x64_enabled

    a, state, rows = _random_world(seed, n_valid)
    with x64_enabled(False):
        want = jax_explain.explain_batch(a, *state, rows, topk=3)
    got = [x.numpy() for x in ops_explain.explain_batch(a, *state, rows, topk=3)]
    twin = ops_explain.explain_rows_np(a, *state, rows, topk=3)
    live = rows >= 0
    for i, (w, g, t) in enumerate(zip(want, got, twin)):
        assert w.dtype == g.dtype, (i, w.dtype, g.dtype)
        assert np.array_equal(w, g), i  # padding rows included, tolerance 0
        assert np.array_equal(t[live], g[live]), i
    np.testing.assert_array_equal(
        ops_explain.explain_rows_np(a, *state, rows, topk=3)[3],
        jax_explain.explain_rows_np(a, *state, rows, topk=3)[3],
    )


@pytest.mark.parametrize("seed", [0, 3])
def test_explain_batch_classes_equals_explain_batch(seed):
    a, state, rows = _random_world(seed)
    full = ops_explain.explain_batch(a, *state, rows, topk=3)
    classes = ops_explain.explain_batch_classes(a, *state, rows, topk=3)
    for x, y in zip(full, classes):
        assert np.array_equal(x.numpy(), y.numpy())


def test_records_match_jax_serial_xla_and_mesh_on_the_smoke_world(explaining, monkeypatch):
    """The port's serial, fused and sharded records equal the JAX
    package's serial, XLA and mesh records as canonical JSON."""
    import test_explain as jax_test_explain
    from kube_batch_tpu.obs import explain as jax_explain_obs
    from kube_batch_tpu.testing import x64_enabled

    monkeypatch.setenv(jax_explain_obs.ENV, "1")
    jax_explain_obs.configure()
    try:
        with x64_enabled(False):
            jax_serial, _, _ = jax_test_explain.run_smoke_world("allocate")
            jax_xla, _, _ = jax_test_explain.run_smoke_world("xla_allocate")
            jax_mesh, mesh_n, _ = jax_test_explain.run_smoke_world("xla_allocate", mesh="cpu:2")
    finally:
        jax_explain_obs.configure("off")
        jax_explain_obs.records.clear()
    assert mesh_n == 2
    want = canon(jax_xla)
    assert canon(jax_serial) == canon(jax_mesh) == want
    serial, _, _ = run_smoke_world("allocate")
    fused, _, _ = run_smoke_world("torch_allocate")
    sharded, _, _ = run_smoke_world("torch_allocate", mesh="cpu:2")
    assert canon(serial) == canon(fused) == canon(sharded) == want


def test_explain_smoke_passes_on_the_cpu():
    result = explain.smoke(device="cpu")
    assert result["ok"], result
    assert result["tiers"] == ["fused", "sharded"]


@pytest.mark.cuda
def test_explain_batch_on_the_card_equals_its_cpu_run():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: explain_batch's card run is held against its CPU run")
    a, state, rows = _random_world(5)
    dev = torch.device("cuda", 0)
    card_a = {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in a.items()}
    card_state = [torch.as_tensor(x).to(dev) for x in state]
    got = ops_explain.explain_batch(card_a, *card_state, rows, topk=3)
    want = ops_explain.explain_batch(a, *state, rows, topk=3)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w)
