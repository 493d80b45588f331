"""The port's `torch_allocate` action against the JAX package's actions.

Every world is built twice from the same builders and seed, once with the
JAX package (`kube_batch_tpu.testing` / `kube_batch_tpu.models`) and once
with the port's, and goes through each package's `FakeCache`, session and
action. On the CPU (``device: cpu``, the kernels' plain versions) the
port's action must give the JAX `xla_allocate` action's and the serial
`allocate` action's outcome exactly: binds, and ``{task uid: (status,
node)}`` over every task of the session. The JAX actions run with jax x64
off (float32, the production policy the port follows).

Also held here: the pod-affinity pause / host step / resume path on both
rungs, the solver state between segments, the InterPodAffinity refresh,
the three routes to serial, failures that must raise, and the cycle
budget.
"""

import functools
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import kube_batch_tpu.apis.types as jax_apis
import kube_batch_tpu.testing as jax_testing
from kube_batch_tpu import models as jax_models
from kube_batch_tpu.testing import x64_enabled

import kube_batch_tpu_torch.actions.torch_allocate as TA
import kube_batch_tpu_torch.apis.types as torch_apis
import kube_batch_tpu_torch.testing as torch_testing
from kube_batch_tpu_torch import actions as _torch_actions  # noqa: F401  (registers the port's actions)
from kube_batch_tpu_torch import models as torch_models
from kube_batch_tpu_torch import plugins as _torch_plugins  # noqa: F401  (registers the port's plugins)
from kube_batch_tpu_torch.conf import parse_scheduler_conf as torch_parse
from kube_batch_tpu_torch.framework import close_session as torch_close
from kube_batch_tpu_torch.framework import get_action as torch_get_action
from kube_batch_tpu_torch.framework import open_session as torch_open
from kube_batch_tpu_torch.ops.kernels import SolveState
from kube_batch_tpu_torch.recovery.budget import CycleBudget, CycleDeadlineExceeded

from test_torch_encode import WORLDS, build_world
from test_xla_allocate import DEFAULT_TIERS_YAML, TIERS_YAML, run_and_capture

JAX = SimpleNamespace(t=jax_testing, apis=jax_apis, models=jax_models)
TORCH = SimpleNamespace(t=torch_testing, apis=torch_apis, models=torch_models)

CPU = {"device": "cpu", "min_device_pairs": "0"}
MESH = {**CPU, "mesh": "cpu:4"}
MESH_K4 = {**MESH, "exchange_batch": "4"}


# -- scenarios, built with either package's builders ------------------------


def _rl(P, **kw):
    return P.t.build_resource_list(**kw)


def gang_atomic(P):
    pods = [P.t.build_pod(name=f"p{i}", group_name="pg1", req=_rl(P, cpu=1, memory="512Mi")) for i in range(3)]
    nodes = [P.t.build_node(f"n{i}", _rl(P, cpu=1, memory="1Gi", pods=10)) for i in range(3)]
    return P.t.build_cluster(pods, nodes, [P.t.build_pod_group("pg1", min_member=3)], [P.t.build_queue("default")])


def gang_starved(P):
    """minMember=4 with 3 slots: 3 tasks sit Allocated, nothing binds."""
    pods = [P.t.build_pod(name=f"p{i}", group_name="pg1", req=_rl(P, cpu=1, memory="512Mi")) for i in range(4)]
    nodes = [P.t.build_node(f"n{i}", _rl(P, cpu=1, memory="1Gi", pods=10)) for i in range(3)]
    return P.t.build_cluster(pods, nodes, [P.t.build_pod_group("pg1", min_member=4)], [P.t.build_queue("default")])


def priority_spread(P):
    pods = [
        P.t.build_pod(name=f"lo{i}", group_name="lo", req=_rl(P, cpu=1, memory="512Mi"), priority=1)
        for i in range(2)
    ] + [
        P.t.build_pod(name=f"hi{i}", group_name="hi", req=_rl(P, cpu=1, memory="512Mi"), priority=9)
        for i in range(2)
    ]
    nodes = [P.t.build_node(f"n{i}", _rl(P, cpu=2, memory="2Gi", pods=10)) for i in range(2)]
    pgs = [P.t.build_pod_group("lo", min_member=1), P.t.build_pod_group("hi", min_member=1)]
    return P.t.build_cluster(pods, nodes, pgs, [P.t.build_queue("default")])


def selectors_and_taints(P):
    sel = P.t.build_pod(name="sel", group_name="pg1", req=_rl(P, cpu=1, memory="256Mi"), node_selector={"zone": "a"})
    tol = P.t.build_pod(name="tol", group_name="pg1", req=_rl(P, cpu=1, memory="256Mi"))
    tol.tolerations = [P.apis.Toleration(key="dedicated", operator="Equal", value="infra", effect="NoSchedule")]
    plain = P.t.build_pod(name="plain", group_name="pg1", req=_rl(P, cpu=1, memory="256Mi"))
    n_zone = P.t.build_node("zone-a", _rl(P, cpu=1, memory="1Gi", pods=10), labels={"zone": "a"})
    n_taint = P.t.build_node("tainted", _rl(P, cpu=8, memory="8Gi", pods=10))
    n_taint.taints = [P.apis.Taint(key="dedicated", value="infra", effect="NoSchedule")]
    n_plain = P.t.build_node("plain", _rl(P, cpu=1, memory="1Gi", pods=10))
    return P.t.build_cluster(
        [sel, tol, plain], [n_zone, n_taint, n_plain], [P.t.build_pod_group("pg1", min_member=1)],
        [P.t.build_queue("default")],
    )


def pipelined(P):
    """A task that fits only a terminating pod's resources pipelines."""
    leaving = P.t.build_pod(
        name="leaving", node_name="n0", phase=P.apis.PodPhase.RUNNING, req=_rl(P, cpu=1, memory="1Gi"),
    )
    leaving.metadata.deletion_timestamp = 1.0
    pending = P.t.build_pod(name="pending", group_name="pg1", req=_rl(P, cpu=1, memory="1Gi"))
    nodes = [P.t.build_node("n0", _rl(P, cpu=1, memory="1Gi", pods=10))]
    return P.t.build_cluster(
        [leaving, pending], nodes, [P.t.build_pod_group("pg1", min_member=1)], [P.t.build_queue("default")]
    )


def multi_queue(P):
    pods, pgs = [], []
    for q in ("qa", "qb"):
        for j in range(2):
            name = f"{q}-j{j}"
            pgs.append(P.t.build_pod_group(name, queue=q, min_member=1))
            pods.extend(
                P.t.build_pod(name=f"{name}-p{i}", group_name=name, req=_rl(P, cpu=1, memory="256Mi"))
                for i in range(2)
            )
    nodes = [P.t.build_node(f"n{i}", _rl(P, cpu=2, memory="2Gi", pods=10)) for i in range(3)]
    return P.t.build_cluster(pods, nodes, pgs, [P.t.build_queue("qa"), P.t.build_queue("qb")])


def proportion_overused(P):
    """A queue past its deserved share is skipped for the cycle
    (proportion.go:188-199)."""
    pods, pgs = [], []
    for q, njobs in (("qa", 3), ("qb", 3)):
        for j in range(njobs):
            name = f"{q}-j{j}"
            pgs.append(P.t.build_pod_group(name, queue=q, min_member=1))
            pods.extend(
                P.t.build_pod(name=f"{name}-p{i}", group_name=name, req=_rl(P, cpu=1, memory="1Gi"))
                for i in range(2)
            )
    nodes = [P.t.build_node(f"n{i}", _rl(P, cpu=2, memory="2Gi", pods=10)) for i in range(3)]
    qa, qb = P.t.build_queue("qa", weight=1), P.t.build_queue("qb", weight=5)
    qa.metadata.creation_timestamp, qb.metadata.creation_timestamp = 0.0, 1.0
    return P.t.build_cluster(pods, nodes, pgs, [qa, qb])


def drf_order(P):
    """A job already holding resources yields to the zero-share job."""
    fat = P.t.build_pod(
        name="fat-r0", group_name="fat", node_name="n0", phase=P.apis.PodPhase.RUNNING,
        req=_rl(P, cpu=2, memory="2Gi"),
    )
    pods = [fat] + [
        P.t.build_pod(name=f"fat-p{i}", group_name="fat", req=_rl(P, cpu=1, memory="1Gi")) for i in range(2)
    ] + [
        P.t.build_pod(name=f"thin-p{i}", group_name="thin", req=_rl(P, cpu=1, memory="1Gi")) for i in range(2)
    ]
    nodes = [P.t.build_node(f"n{i}", _rl(P, cpu=4, memory="4Gi", pods=10)) for i in range(2)]
    pg_fat, pg_thin = P.t.build_pod_group("fat", min_member=1), P.t.build_pod_group("thin", min_member=1)
    pg_fat.metadata.creation_timestamp, pg_thin.metadata.creation_timestamp = 0.0, 1.0
    return P.t.build_cluster(pods, nodes, [pg_fat, pg_thin], [P.t.build_queue("default")])


def host_ports(P):
    pods = [P.t.build_pod(name=f"web{i}", group_name="pg1", req=_rl(P, cpu=1, memory="128Mi")) for i in range(3)]
    for p in pods:
        p.containers[0].ports = [8080]
    nodes = [P.t.build_node(f"n{i}", _rl(P, cpu=8, memory="8Gi", pods=10)) for i in range(2)]
    return P.t.build_cluster(pods, nodes, [P.t.build_pod_group("pg1", min_member=1)], [P.t.build_queue("default")])


def node_affinity_score(P):
    pod = P.t.build_pod(name="aff", group_name="pg1", req=_rl(P, cpu=1, memory="128Mi"))
    pod.affinity = P.apis.Affinity(
        node_affinity_preferred=[(20, P.apis.NodeSelectorTerm(key="disk", operator="In", values=["ssd"]))]
    )
    nodes = [
        P.t.build_node("big", _rl(P, cpu=16, memory="16Gi", pods=10)),
        P.t.build_node("ssd", _rl(P, cpu=2, memory="2Gi", pods=10), labels={"disk": "ssd"}),
    ]
    return P.t.build_cluster([pod], nodes, [P.t.build_pod_group("pg1", min_member=1)], [P.t.build_queue("default")])


def scalar_resources(P):
    """GPU nodes beside plain ones; gangs asking for GPUs, and one that
    cannot get enough (the Go nil-scalar-map paths of drf/proportion)."""
    gpu = "nvidia.com/gpu"
    nodes = []
    for i in range(4):
        rl = _rl(P, cpu=8, memory="16Gi", pods=20)
        if i % 2 == 0:
            rl[gpu] = 4.0
        nodes.append(P.t.build_node(f"n{i}", rl))
    pods, pgs = [], []
    for j, (n, want, q) in enumerate(((3, 2.0, "qa"), (2, 4.0, "qb"), (2, 0.0, "qa"), (3, 3.0, "qb"))):
        name = f"job{j}"
        pgs.append(P.t.build_pod_group(name, queue=q, min_member=n))
        for t in range(n):
            rl = _rl(P, cpu=1, memory="1Gi")
            if want:
                rl[gpu] = want
            pods.append(P.t.build_pod(name=f"{name}-t{t}", group_name=name, req=rl))
    return P.t.build_cluster(pods, nodes, pgs, [P.t.build_queue("qa", weight=2), P.t.build_queue("qb")])


def pod_affinity_one(P):
    """One follower with a required pod affinity to the anchor on n0: one
    host step."""
    anchor = P.t.build_pod(
        name="anchor", node_name="n0", phase=P.apis.PodPhase.RUNNING, req=_rl(P, cpu=1, memory="128Mi"),
        labels={"app": "db"},
    )
    follower = P.t.build_pod(name="follower", group_name="pg1", req=_rl(P, cpu=1, memory="128Mi"))
    follower.affinity = P.apis.Affinity(pod_affinity_required=[P.apis.PodAffinityTerm(label_selector={"app": "db"})])
    others = [P.t.build_pod(name=f"o{i}", group_name="pg2", req=_rl(P, cpu=1, memory="256Mi")) for i in range(3)]
    nodes = [P.t.build_node(f"n{i}", _rl(P, cpu=4, memory="4Gi", pods=10)) for i in range(3)]
    pg1, pg2 = P.t.build_pod_group("pg1", min_member=1), P.t.build_pod_group("pg2", min_member=2)
    pg2.metadata.creation_timestamp = pg1.metadata.creation_timestamp + 1.0
    return P.t.build_cluster([anchor, follower, *others], nodes, [pg1, pg2], [P.t.build_queue("default")])


def pod_affinity_many(P):
    """A web tier whose replicas repel each other (required anti-affinity
    on the hostname), cache pods drawn to the web tier (required
    affinity), and plain pods that carry the web label and so score the
    nodes the stepped pods land on: several host steps, each changing the
    InterPodAffinity scores of what follows."""
    web = {"app": "web"}
    pods, pgs = [], []
    for i in range(4):
        p = P.t.build_pod(name=f"web{i}", group_name="web", req=_rl(P, cpu=1, memory="512Mi"), labels=dict(web))
        p.affinity = P.apis.Affinity(pod_anti_affinity_required=[P.apis.PodAffinityTerm(label_selector=dict(web))])
        pods.append(p)
    pgs.append(P.t.build_pod_group("web", min_member=3))
    for i in range(2):
        p = P.t.build_pod(name=f"cache{i}", group_name=f"cache{i}", req=_rl(P, cpu=1, memory="256Mi"))
        p.affinity = P.apis.Affinity(pod_affinity_required=[P.apis.PodAffinityTerm(label_selector=dict(web))])
        pg = P.t.build_pod_group(f"cache{i}", min_member=1)
        pg.metadata.creation_timestamp = 10.0 + i
        pods.append(p)
        pgs.append(pg)
    for i in range(6):
        p = P.t.build_pod(name=f"plain{i}", group_name="plain", req=_rl(P, cpu=1, memory="256Mi"), labels=dict(web))
        pods.append(p)
    pg = P.t.build_pod_group("plain", min_member=2)
    pg.metadata.creation_timestamp = 20.0
    pgs.append(pg)
    nodes = [P.t.build_node(f"n{i}", _rl(P, cpu=4, memory="8Gi", pods=10)) for i in range(5)]
    return P.t.build_cluster(pods, nodes, pgs, [P.t.build_queue("default")])


def pod_affinity_refresh(P):
    """The anchor runs on n0; the stepped follower's required affinity
    term matches the later db-labelled pods, so once it is resident those
    pods score n0 highest — only if the solver sees the refreshed scores."""
    anchor = P.t.build_pod(
        name="anchor", node_name="n0", phase=P.apis.PodPhase.RUNNING, req=_rl(P, cpu=2, memory="2Gi"),
        labels={"app": "db"},
    )
    follower = P.t.build_pod(name="follower", group_name="f", req=_rl(P, cpu=1, memory="512Mi"))
    follower.affinity = P.apis.Affinity(pod_affinity_required=[P.apis.PodAffinityTerm(label_selector={"app": "db"})])
    later = [
        P.t.build_pod(name=f"db{i}", group_name="later", req=_rl(P, cpu=1, memory="512Mi"), labels={"app": "db"})
        for i in range(2)
    ]
    pg_f, pg_l = P.t.build_pod_group("f", min_member=1), P.t.build_pod_group("later", min_member=2)
    pg_l.metadata.creation_timestamp = pg_f.metadata.creation_timestamp + 1.0
    nodes = [P.t.build_node(f"n{i}", _rl(P, cpu=16, memory="32Gi", pods=20)) for i in range(3)]
    return P.t.build_cluster([anchor, follower, *later], nodes, [pg_f, pg_l], [P.t.build_queue("default")])


def volume_task(P):
    """A pod with a volume claim is stepped on the host (the volume
    binder's allocate/bind), its gang mates are solved."""
    pods = [P.t.build_pod(name=f"p{i}", group_name="pg1", req=_rl(P, cpu=1, memory="512Mi")) for i in range(3)]
    pods[1].volumes = ["claim-a"]
    nodes = [P.t.build_node(f"n{i}", _rl(P, cpu=2, memory="2Gi", pods=10)) for i in range(2)]
    return P.t.build_cluster(pods, nodes, [P.t.build_pod_group("pg1", min_member=3)], [P.t.build_queue("default")])


SCENARIOS = {
    f.__name__: f
    for f in (
        gang_atomic, gang_starved, priority_spread, selectors_and_taints, pipelined, multi_queue,
        proportion_overused, drf_order, host_ports, node_affinity_score, scalar_resources,
        pod_affinity_one, pod_affinity_many, pod_affinity_refresh, volume_task,
    )
}
# no priority plugin: a conf outside the solve's envelope
NO_PRIORITY_YAML = """
tiers:
- plugins:
  - name: gang
- plugins:
  - name: predicates
  - name: nodeorder
"""
CONFS = {"default": DEFAULT_TIERS_YAML, "no_fair_share": TIERS_YAML, "no_priority": NO_PRIORITY_YAML}
PARITY_CONFS = ["default", "no_fair_share"]


def make(key: str, P):
    """A scenario or a WORLDS entry of test_torch_encode, with P's builders."""
    if key in SCENARIOS:
        return SCENARIOS[key](P)
    return build_world(P.models, key)


# -- running each package's actions -----------------------------------------


def _task_keys(cluster):
    return {t.uid: f"{t.namespace}/{t.name}" for job in cluster.jobs.values() for t in job.tasks.values()}


@functools.lru_cache(maxsize=None)
def jax_outcome(action: str, key: str, conf: str):
    """({task uid: (status name, node)}, binds) of one JAX action."""
    with x64_enabled(False):
        state, binds = run_and_capture(action, make(key, JAX), CONFS[conf])
    return {uid: (st.name, node) for uid, (st, node) in state.items()}, binds


def torch_run(key: str, conf: str, args=None, action=None, cluster=None, budget=None):
    """One port action over a FakeCache world; returns (state, binds,
    action, cache) with state as ``jax_outcome``'s."""
    cache = torch_testing.FakeCache(cluster if cluster is not None else make(key, TORCH))
    ssn = torch_open(cache, torch_parse(CONFS[conf]).tiers, {"torch_allocate": dict(CPU if args is None else args)})
    ssn.cycle_budget = budget
    act = action if action is not None else TA.TorchAllocateAction()
    act.execute(ssn)
    state = {
        t.uid: (t.status.name, t.node_name)
        for job in ssn.jobs.values()
        for tasks in job.task_status_index.values()
        for t in tasks.values()
    }
    torch_close(ssn)
    return state, dict(cache.binder.binds), act, cache


def assert_parity(key: str, conf: str, args, tier: str):
    serial = jax_outcome("allocate", key, conf)
    xla = jax_outcome("xla_allocate", key, conf)
    state, binds, act, _ = torch_run(key, conf, args)
    assert act.last_solver_tier == tier
    assert xla == serial
    assert (state, binds) == serial
    return act


# -- parity -----------------------------------------------------------------


@pytest.mark.parametrize("conf", PARITY_CONFS)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scenario_fused_equals_xla_and_serial(scenario, conf):
    assert_parity(scenario, conf, CPU, "fused")


@pytest.mark.parametrize("conf", PARITY_CONFS)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scenario_sharded_equals_xla_and_serial(scenario, conf):
    act = assert_parity(scenario, conf, MESH, "sharded")
    assert act.last_mesh_size == 4


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_world_fused_equals_xla_and_serial(world):
    act = assert_parity(world, "default", CPU, "fused")
    assert act.last_timings["host_steps"] == 0


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_world_sharded_equals_xla_and_serial(world):
    assert_parity(world, "default", MESH, "sharded")


@pytest.mark.parametrize("world", ["multi_queue_400_40", "preempt_mix_2000_40_seed1"])
def test_world_without_fair_share(world):
    assert_parity(world, "no_fair_share", CPU, "fused")
    assert_parity(world, "no_fair_share", MESH, "sharded")


@pytest.mark.parametrize("key", ["multi_tenant_ml_8_8_3", "pod_affinity_many", "scalar_resources"])
def test_batched_exchange_equals_serial(key):
    act = assert_parity(key, "default", MESH_K4, "sharded")
    assert act.last_batched_iters > 0


# -- pause and resume ---------------------------------------------------------


@pytest.mark.parametrize("args", [CPU, MESH], ids=["fused", "sharded"])
@pytest.mark.parametrize("key, steps", [("pod_affinity_one", 1), ("pod_affinity_many", 6), ("volume_task", 1)])
def test_host_steps(key, steps, args):
    """Each host-only task reaching the head of its job is one host step;
    the outcome is serial's (asserted by the parity tests above too)."""
    state, binds, act, _ = torch_run(key, "default", args)
    assert act.last_timings["host_steps"] == steps
    assert (state, binds) == jax_outcome("allocate", key, "default")


def test_rungs_end_in_the_same_state_after_pauses():
    _, _, fused, _ = torch_run("pod_affinity_many", "default", CPU)
    _, _, sharded, _ = torch_run("pod_affinity_many", "default", MESH)
    for f in SolveState._fields:
        a, b = getattr(fused.last_state, f), getattr(sharded.last_state, f)
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), f


@pytest.mark.parametrize("args", [CPU, MESH], ids=["fused", "sharded"])
def test_state_keeps_its_dtypes_and_shapes_across_a_host_step(monkeypatch, args):
    """The host step patches a copy of the state; every field must keep the
    dtype and shape the solvers pack (int32 scalars, [N, P] bool ports)."""
    seen = []
    real = TA.TorchAllocateAction._host_step

    def spy(self, ssn, enc, arrays, replay, s):
        before = {f: (getattr(s, f).dtype, tuple(getattr(s, f).shape)) for f in SolveState._fields}
        out = real(self, ssn, enc, arrays, replay, s)
        seen.append((before, {f: (getattr(out, f).dtype, tuple(getattr(out, f).shape)) for f in SolveState._fields}))
        return out

    monkeypatch.setattr(TA.TorchAllocateAction, "_host_step", spy)
    torch_run("pod_affinity_many", "default", args)
    assert len(seen) == 6
    for before, after in seen:
        assert before == after
        for f in ("it", "step", "cur", "paused_at"):
            assert after[f] == (torch.int32, ())
        assert after["nports"][0] == torch.bool and len(after["nports"][1]) == 2
        assert after["job_active"][0] == torch.bool and after["idle"][0] == torch.float32


@pytest.mark.parametrize("solver_name", ["FusedSolver", "ShardedBlockSolver"])
def test_pod_sc_refresh_reaches_the_solvers_dict(monkeypatch, solver_name):
    """After the host step, the solver's own arrays carry the
    InterPodAffinity scores of the session as it now stands: the stepped
    follower's affinity term lifts n0 for the db-labelled pods."""
    from kube_batch_tpu_torch.ops.encode import compute_pod_sc

    cls = getattr(TA, solver_name)
    seen = []
    real = cls.solve

    def spy(self, state=None):
        seen.append(np.array(self.a["pod_sc"]))
        return real(self, state)

    monkeypatch.setattr(cls, "solve", spy)
    real_step = TA.TorchAllocateAction._host_step
    expected = []

    def step(self, ssn, enc, arrays, replay, s):
        out = real_step(self, ssn, enc, arrays, replay, s)
        expected.append(compute_pod_sc(enc.task_reps, ssn.nodes, enc.node_names, arrays["pod_sc"].shape[1], np.float32))
        return out

    monkeypatch.setattr(TA.TorchAllocateAction, "_host_step", step)
    state, binds, act, _ = torch_run("pod_affinity_refresh", "default", CPU if solver_name == "FusedSolver" else MESH)
    assert act.last_timings["host_steps"] == 1 and len(seen) == 2
    assert not np.array_equal(seen[0], seen[1])
    np.testing.assert_array_equal(seen[1], expected[0])
    assert seen[1].max() == 10.0
    assert (state, binds) == jax_outcome("allocate", "pod_affinity_refresh", "default")
    assert binds["default/db0"] == binds["default/db1"] == "n0"


# -- routing ----------------------------------------------------------------

def _serial_outcome(key, conf_text):
    """The port's own serial allocate on the same world and tiers."""
    cache = torch_testing.FakeCache(make(key, TORCH))
    ssn = torch_open(cache, torch_parse(conf_text).tiers)
    torch_get_action("allocate").execute(ssn)
    torch_close(ssn)
    return dict(cache.binder.binds)


def test_out_of_envelope_conf_routes_serial():
    _, binds, act, _ = torch_run("priority_spread", "no_priority", CPU)
    assert act.last_solver_tier == "serial"
    assert act.last_timings["serial_reason"] == "envelope"
    assert binds == _serial_outcome("priority_spread", NO_PRIORITY_YAML) == jax_outcome(
        "allocate", "priority_spread", "no_priority"
    )[1]


def test_below_the_size_floor_routes_serial():
    _, binds, act, _ = torch_run("gang_atomic", "default", {"device": "cpu"})
    assert act.last_solver_tier == "serial"
    assert act.last_timings["serial_reason"] == "size_floor" and "serial_routed_s" in act.last_timings
    assert binds == jax_outcome("allocate", "gang_atomic", "default")[1] and len(binds) == 3
    # a mesh request skips the floor
    _, binds, act, _ = torch_run("gang_atomic", "default", {"device": "cpu", "mesh": "cpu:2"})
    assert act.last_solver_tier == "sharded" and len(binds) == 3


@pytest.mark.parametrize("pods, nodes, tier", [(25, 4, "serial"), (50, 8, "fused")])
def test_the_default_floor_lies_between_100_and_400_pairs(pods, nodes, tier):
    """The default floor (256 pending tasks x nodes) sends preempt_mix(25,
    4), 100 pairs, to serial and solves preempt_mix(50, 8), 400 pairs, on
    the device: on the H100 serial takes about as long as the fused rung at
    100 pairs and twice as long at 400."""
    assert TA.DEFAULT_MIN_DEVICE_PAIRS == 256
    _, binds, act, _ = torch_run(None, "default", {"device": "cpu"}, cluster=TORCH.models.preempt_mix(pods, nodes))
    assert act.last_solver_tier == tier
    cache = torch_testing.FakeCache(TORCH.models.preempt_mix(pods, nodes))
    ssn = torch_open(cache, torch_parse(CONFS["default"]).tiers)
    torch_get_action("allocate").execute(ssn)
    assert binds == dict(cache.binder.binds) and len(binds) == pods


def test_a_nan_weight_routes_serial(monkeypatch):
    monkeypatch.setattr(TA, "_nodeorder_weights", lambda ssn: (math.nan, 1, 1, 1))
    _, binds, act, _ = torch_run("multi_queue", "default", CPU)
    assert act.last_solver_tier == "serial"
    assert act.last_timings["serial_reason"] == "nonfinite: w_least"
    assert binds == jax_outcome("allocate", "multi_queue", "default")[1]


# -- failures raise -------------------------------------------------------------


@pytest.mark.parametrize("solver_name, args", [("FusedSolver", CPU), ("ShardedBlockSolver", MESH)])
def test_a_failing_solve_raises_and_binds_nothing(monkeypatch, solver_name, args):
    def broken(self, state=None):
        raise RuntimeError("kernel launch failed: injected")

    monkeypatch.setattr(getattr(TA, solver_name), "solve", broken)
    cache = torch_testing.FakeCache(make("gang_atomic", TORCH))
    ssn = torch_open(cache, torch_parse(DEFAULT_TIERS_YAML).tiers, {"torch_allocate": args})
    with pytest.raises(TA.DeviceSolveError, match="injected"):
        TA.TorchAllocateAction().execute(ssn)
    assert cache.binder.binds == {}


def test_a_solver_that_cannot_be_made_raises(monkeypatch):
    def broken(*a, **k):
        raise ValueError("past the kernel's shared-memory limit: injected")

    monkeypatch.setattr(TA, "FusedSolver", broken)
    cache = torch_testing.FakeCache(make("gang_atomic", TORCH))
    ssn = torch_open(cache, torch_parse(DEFAULT_TIERS_YAML).tiers, {"torch_allocate": CPU})
    with pytest.raises(TA.DeviceSolveError, match="fused rung.*shared-memory limit"):
        TA.TorchAllocateAction().execute(ssn)
    assert cache.binder.binds == {}


@pytest.mark.parametrize("args", [{"min_device_pairs": "0"}, {"device": "cuda", "min_device_pairs": "0"},
                                  {"mesh": "cuda:4"}])
def test_cuda_without_a_card_raises(monkeypatch, args):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cache = torch_testing.FakeCache(make("gang_atomic", TORCH))
    ssn = torch_open(cache, torch_parse(DEFAULT_TIERS_YAML).tiers, {"torch_allocate": args})
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        TA.TorchAllocateAction().execute(ssn)
    assert cache.binder.binds == {}


@pytest.mark.parametrize("args, match", [
    ({"device": "cpu", "mesh": "cuda:4"}, "mesh backend"),
    ({"device": "cpu", "mesh": "tpu:4"}, "not cpu or cuda"),
    ({"device": "cpu", "mesh": "many"}, "not a device count"),
    ({"device": "cpu", "min_device_pairs": "x"}, "not an integer"),
    ({"device": "cpu", "mesh": "cpu:4", "exchange_batch": "x"}, "not an integer"),
])
def test_bad_arguments_raise(args, match):
    cache = torch_testing.FakeCache(make("gang_atomic", TORCH))
    ssn = torch_open(cache, torch_parse(DEFAULT_TIERS_YAML).tiers, {"torch_allocate": args})
    with pytest.raises(ValueError, match=match):
        TA.TorchAllocateAction().execute(ssn)


def test_mesh_forms_resolve():
    act = TA.TorchAllocateAction()
    cpu = torch.device("cpu")
    assert act._resolve({"device": "cpu"}) == (cpu, None)
    assert act._resolve({"device": "cpu", "mesh": "off"}) == (cpu, None)
    assert act._resolve({"mesh": "cpu:4"}) == (cpu, (cpu,) * 4)
    assert act._resolve({"mesh": "cpu:6"}) == (cpu, (cpu,) * 4)  # clamped to a power of two
    assert act._resolve({"device": "cpu", "mesh": "auto"}) == (cpu, None)  # one visible cpu device
    assert act._resolve({"device": "cpu", "mesh": "8"}) == (cpu, None)
    assert act._resolve({"mesh": "cpu:1"}) == (cpu, None)
    assert act._resolve({"device": "cpu", "mesh": "False"}) == (cpu, None)  # a conf's plain `mesh: off`


# -- the cycle budget -------------------------------------------------------------


def _cluster_digest(cluster):
    tasks = sorted((t.uid, t.status.name, t.node_name) for j in cluster.jobs.values() for t in j.tasks.values())
    nodes = sorted(
        (n.name, n.idle.milli_cpu, n.idle.memory, n.used.milli_cpu, n.releasing.milli_cpu, tuple(sorted(n.tasks)))
        for n in cluster.nodes.values()
    )
    phases = sorted((uid, j.pod_group.status.phase.value) for uid, j in cluster.jobs.items())
    return tasks, nodes, phases


@pytest.mark.parametrize("spent_after", [0, 2], ids=["at_solver_entry", "at_a_later_gate"])
def test_a_spent_hard_budget_aborts_before_dispatch(spent_after):
    """The clock passes the hard budget at the first gate it reads, or
    after a host step (the second segment's solver entry): nothing binds
    and the cache's world is as it was."""
    ticks = iter([0.0] + [0.0] * spent_after + [100.0] * 100)
    budget = CycleBudget(hard_s=1.0, clock=lambda: next(ticks))
    cluster = make("pod_affinity_one", TORCH)
    before = _cluster_digest(cluster)
    with pytest.raises(CycleDeadlineExceeded):
        torch_run("pod_affinity_one", "default", CPU, cluster=cluster, budget=budget)
    assert _cluster_digest(cluster) == before


def test_budget_gates_in_order():
    """A budget that never runs out passes every gate: solver entry twice
    (one host step), between segments, the dispatch barrier."""
    seen = []

    class Recording(CycleBudget):
        def check(self, where):
            seen.append(where)
            super().check(where)

    _, binds, _, _ = torch_run("pod_affinity_one", "default", CPU, budget=Recording(hard_s=1e9))
    assert seen == ["solver entry", "between solve segments", "solver entry", "dispatch barrier"]
    assert binds == jax_outcome("allocate", "pod_affinity_one", "default")[1]
