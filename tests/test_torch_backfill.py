"""The port's `torch_backfill` against the JAX package's `xla_backfill`
and both packages' serial `backfill`, on the scenes of
tests/test_xla_backfill.py built with either package's builders: node
selectors, taints and tolerations, cordon, max-task pressure, host ports,
pod-affinity tasks walked serially, more than 63 distinct host ports
(the serial route), and an out-of-envelope conf. Outcomes compared
exactly: task statuses and nodes, every node's resident tasks, and the
binds."""

import random
from types import SimpleNamespace

import pytest

import kube_batch_tpu.apis.types as jax_apis
import kube_batch_tpu.testing as jax_testing
from kube_batch_tpu.conf import parse_scheduler_conf as jax_parse
from kube_batch_tpu.framework import close_session as jax_close
from kube_batch_tpu.framework import get_action as jax_get_action
from kube_batch_tpu.framework import open_session as jax_open
from kube_batch_tpu.testing import x64_enabled

import kube_batch_tpu_torch.apis.types as torch_apis
import kube_batch_tpu_torch.testing as torch_testing
from kube_batch_tpu_torch.conf import parse_scheduler_conf as torch_parse
from kube_batch_tpu_torch.framework import close_session as torch_close
from kube_batch_tpu_torch.framework import get_action as torch_get_action
from kube_batch_tpu_torch.framework import open_session as torch_open

from test_torch_preempt import session_state
from test_xla_backfill import TIERS

JAX = SimpleNamespace(t=jax_testing, apis=jax_apis, parse=jax_parse, open=jax_open, close=jax_close,
                      get=jax_get_action)
TORCH = SimpleNamespace(t=torch_testing, apis=torch_apis, parse=torch_parse, open=torch_open, close=torch_close,
                        get=torch_get_action)

NO_PREDICATES = """
tiers:
- plugins:
  - name: priority
  - name: gang
"""


def run(P, action, cluster, tiers_yaml=TIERS):
    with x64_enabled(False):
        cache = P.t.FakeCache(cluster)
        ssn = P.open(cache, P.parse(tiers_yaml).tiers)
        P.get(action).execute(ssn)
        out = session_state(ssn), {name: sorted(n.tasks) for name, n in ssn.nodes.items()}, dict(cache.binder.binds)
        P.close(ssn)
    return out


def assert_backfill_parity(scene, tiers_yaml=TIERS):
    want = run(JAX, "backfill", scene(JAX), tiers_yaml)
    assert run(JAX, "xla_backfill", scene(JAX), tiers_yaml) == want
    assert run(TORCH, "backfill", scene(TORCH), tiers_yaml) == want
    assert run(TORCH, "torch_backfill", scene(TORCH), tiers_yaml) == want
    return want


def be_pod(P, name, **kw):
    """BestEffort pod: zero requests (backfill's only clientele)."""
    return P.t.build_pod(name=name, req=None, **kw)


def one_group(P, pods, nodes, *extra_groups):
    groups = [P.t.build_pod_group("g", min_member=1), *extra_groups]
    return P.t.build_cluster(pods, nodes, groups, [P.t.build_queue("default")])


def first_node(P):
    pods = [be_pod(P, f"be{i}", group_name="g") for i in range(4)]
    return one_group(P, pods, [P.t.build_node(f"n{i}", alloc={"cpu": 1.0, "pods": 110}) for i in range(3)])


def selector_and_taints(P):
    pods = [be_pod(P, f"sel{i}", group_name="g", node_selector={"zone": "a"}) for i in range(6)]
    for i in range(6):
        p = be_pod(P, f"tol{i}", group_name="g")
        p.tolerations.append(P.apis.Toleration(key="dedicated", operator="Exists"))
        pods.append(p)
    pods += [be_pod(P, f"plain{i}", group_name="g") for i in range(6)]
    nodes = [
        P.t.build_node("a0", alloc={"cpu": 1.0, "pods": 110}, labels={"zone": "a"}),
        P.t.build_node("b0", alloc={"cpu": 1.0, "pods": 110}, labels={"zone": "b"}),
        P.t.build_node("t0", alloc={"cpu": 1.0, "pods": 110}),
    ]
    nodes[2].taints.append(P.apis.Taint(key="dedicated", effect="NoSchedule"))
    cordoned = P.t.build_node("c0", alloc={"cpu": 1.0, "pods": 110})
    cordoned.unschedulable = True
    return one_group(P, pods, nodes + [cordoned])


def max_task_pressure(P):
    pods = [be_pod(P, f"be{i}", group_name="g") for i in range(8)]
    nodes = [P.t.build_node("n0", alloc={"cpu": 1.0, "pods": 3}), P.t.build_node("n1", alloc={"cpu": 1.0, "pods": 10})]
    return one_group(P, pods, nodes)


def host_ports(P):
    pods = []
    for i in range(3):
        p = be_pod(P, f"port{i}", group_name="g")
        p.containers[0].ports = [8080]
        pods.append(p)
    return one_group(P, pods, [P.t.build_node(f"n{i}", alloc={"cpu": 1.0, "pods": 110}) for i in range(4)])


def resident_port(P):
    running = be_pod(P, "res", group_name="gr", node_name="n0", phase=P.apis.PodPhase.RUNNING)
    running.containers[0].ports = [9090]
    newp = be_pod(P, "new", group_name="g")
    newp.containers[0].ports = [9090]
    nodes = [P.t.build_node(f"n{i}", alloc={"cpu": 1.0, "pods": 110}) for i in range(2)]
    return one_group(P, [running, newp], nodes, P.t.build_pod_group("gr", min_member=1))


def pod_affinity(P):
    anchor = be_pod(P, "anchor", group_name="ga", node_name="n1", phase=P.apis.PodPhase.RUNNING, labels={"app": "db"})
    follower = be_pod(P, "follower", group_name="g")
    follower.affinity = P.apis.Affinity(
        pod_affinity_required=[P.apis.PodAffinityTerm(label_selector={"app": "db"}, topology_key="kubernetes.io/hostname")]
    )
    nodes = [P.t.build_node(f"n{i}", alloc={"cpu": 1.0, "pods": 110}) for i in range(2)]
    return one_group(P, [anchor, follower], nodes, P.t.build_pod_group("ga", min_member=1))


def pending_group(P):
    pods = [
        P.t.build_pod(name="heavy", req={"cpu": 1.0}, group_name="g"),
        be_pod(P, "light", group_name="g"),
        be_pod(P, "gated", group_name="pending-g"),
    ]
    cluster = one_group(P, pods, [P.t.build_node("n0", alloc={"cpu": 4.0, "pods": 110})],
                        P.t.build_pod_group("pending-g", min_member=1))
    # keep pending-g in Pending phase (build_cluster promotes to Inqueue)
    cluster.jobs["default/pending-g"].pod_group.status.phase = P.apis.PodGroupPhase.PENDING
    return cluster


def many_ports(P):
    """64 BestEffort pods on 64 distinct host ports: past the scan's
    63-bit mask, so torch_backfill runs the serial action."""
    pods = []
    for i in range(64):
        p = be_pod(P, f"port{i:02d}", group_name="g")
        p.containers[0].ports = [10_000 + i]
        pods.append(p)
    return one_group(P, pods, [P.t.build_node(f"n{i}", alloc={"cpu": 1.0, "pods": 30}) for i in range(3)])


SCENES = {f.__name__: f for f in (first_node, selector_and_taints, max_task_pressure, host_ports, resident_port,
                                  pod_affinity, pending_group)}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_scene_parity(scene):
    assert_backfill_parity(SCENES[scene])
    assert torch_get_action("torch_backfill").last_timings["placed"] >= 1


def test_scene_outcomes():
    """What the scenes are for: first node in name order, selectors and
    cordon, max-task spill, one port-8080 pod per node, the resident's
    port, the affinity follower on the anchor's node."""
    state, node_tasks, _ = assert_backfill_parity(first_node)
    assert all(host == "n0" for _, host in state.values())
    state, _, _ = assert_backfill_parity(selector_and_taints)
    assert all(host == "a0" for uid, (_, host) in state.items() if "sel" in uid)
    assert all(host != "c0" for _, host in state.values())
    _, node_tasks, _ = assert_backfill_parity(max_task_pressure)
    assert (len(node_tasks["n0"]), len(node_tasks["n1"])) == (3, 5)
    state, _, _ = assert_backfill_parity(host_ports)
    assert len({host for _, host in state.values()}) == 3
    state, _, _ = assert_backfill_parity(resident_port)
    assert state["default-new"][1] == "n1"
    state, _, _ = assert_backfill_parity(pod_affinity)
    assert state["default-follower"][1] == "n1"
    state, _, _ = assert_backfill_parity(pending_group)
    assert (state["default-light"][1], state["default-heavy"][1], state["default-gated"][1]) == ("n0", "", "")


def test_more_than_63_ports_runs_serial_backfill():
    state, _, binds = assert_backfill_parity(many_ports)
    assert len(binds) == 64
    t = torch_get_action("torch_backfill").last_timings
    assert t["serial_reason"] == "ports>63"


def randomized(P, seed):
    zones = ["a", "b", "c"]
    rng = random.Random(seed)
    pods = []
    for i in range(rng.randint(10, 60)):
        kind = rng.random()
        p = be_pod(P, f"be{i}", group_name=f"g{i % 5}")
        if kind < 0.25:
            p.node_selector.update({"zone": rng.choice(zones)})
        elif kind < 0.4:
            p.tolerations.append(P.apis.Toleration(key="dedicated", operator="Exists"))
        elif kind < 0.5:
            p.containers[0].ports = [rng.choice([80, 443, 8080])]
        pods.append(p)
    nodes = []
    for i in range(rng.randint(3, 12)):
        node = P.t.build_node(f"n{i:02d}", alloc={"cpu": 1.0, "pods": rng.choice([2, 4, 110])},
                              labels={"zone": rng.choice(zones)})
        if rng.random() < 0.2:
            node.taints.append(P.apis.Taint(key="dedicated", effect="NoSchedule"))
        if rng.random() < 0.1:
            node.unschedulable = True
        nodes.append(node)
    return P.t.build_cluster(pods, nodes, [P.t.build_pod_group(f"g{i}", min_member=1) for i in range(5)],
                             [P.t.build_queue("default")])


@pytest.mark.parametrize("seed", range(24))
def test_randomized_parity(seed):
    assert_backfill_parity(lambda P: randomized(P, seed))


def test_out_of_envelope_conf_runs_serial_backfill():
    assert_backfill_parity(first_node, NO_PREDICATES)
    assert torch_get_action("torch_backfill").last_timings["serial_reason"] == "envelope"
