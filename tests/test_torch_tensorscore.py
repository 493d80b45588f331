"""The port's `tensorscore` plugin against the JAX package's and the
port's `nodeorder`, and `torch_allocate` under a conf naming it.

- Scores: every (pending task, node) pair of a session scores the same
  through the port's tensorscore, the JAX tensorscore and the port's
  nodeorder — exactly, before and after a session mutation (the memo
  keys on ``ssn.state_seq``).
- The envelope: a conf naming tensorscore solves on torch_allocate's
  device rungs (the plain versions here) and binds as the JAX
  `xla_allocate` does under it, and as the serial allocate does under
  nodeorder.
- The bulk replay bumps ``state_seq``: with two host-stepped pods apart,
  the second is scored against the replayed fillers' Used vectors.

The cases of tests/test_tensorscore.py and their twins:
test_allocate_synthetic, test_allocate_scalar_resources,
test_property_sweep and test_preempt_with_tensorscore under the same names
at the end of this file (each package's serial action under tensorscore
and under nodeorder, the four outcomes equal);
test_xla_allocate_tensorscore_multi_pause_pod_affinity is
test_second_host_step_sees_the_replayed_fillers; and
test_xla_allocate_accepts_tensorscore_conf is
test_tensorscore_conf_solves_on_the_device_rung (its ``synthetic_200_20``
world among the others).
"""

import pytest

from kube_batch_tpu.conf import parse_scheduler_conf as jax_parse
from kube_batch_tpu.framework import close_session as jax_close
from kube_batch_tpu.framework import open_session as jax_open
from kube_batch_tpu.testing import x64_enabled

import kube_batch_tpu_torch.testing as torch_testing
from kube_batch_tpu_torch.actions.torch_allocate import TorchAllocateAction
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.conf import parse_scheduler_conf as torch_parse
from kube_batch_tpu_torch.framework import close_session as torch_close
from kube_batch_tpu_torch.framework import open_session as torch_open

from test_torch_actions import JAX, TORCH, make
from test_torch_preempt import jax_run, torch_run


def tiers_with(score_plugin: str) -> str:
    return f"""
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: {score_plugin}
"""


TENSORSCORE = tiers_with("tensorscore")
NODEORDER = tiers_with("nodeorder")
SCORE_WORLDS = ["node_affinity_score", "pod_affinity_many", "scalar_resources", "synthetic_200_20",
                "preempt_mix_2000_40_seed1"]
MAX_SCORED_TASKS = 40


def scores(ssn) -> dict:
    """{(task uid, node name): score} over the session's first pending
    tasks (uid order) and every node."""
    pending = sorted(
        (t for j in ssn.jobs.values() for t in j.tasks.values() if t.status.name == "PENDING"), key=lambda t: t.uid
    )[:MAX_SCORED_TASKS]
    return {(t.uid, name): ssn.node_order_fn(t, node) for t in pending for name, node in sorted(ssn.nodes.items())}


def scores_before_and_after(P, key, tiers_yaml, open_, close, parse):
    """Scores, then one pending task allocated onto the first node with
    room for it, then the scores again."""
    cache = P.t.FakeCache(make(key, P))
    ssn = open_(cache, parse(tiers_yaml).tiers)
    before = scores(ssn)
    task = min((t for j in ssn.jobs.values() for t in j.tasks.values() if t.status.name == "PENDING"),
               key=lambda t: t.uid)
    ssn.allocate(task, next(n for _, n in sorted(ssn.nodes.items()) if task.init_resreq.less_equal(n.idle)).name)
    after = scores(ssn)
    close(ssn)
    return before, after


@pytest.mark.parametrize("key", SCORE_WORLDS)
def test_scores_equal_jax_tensorscore_and_nodeorder(key):
    with x64_enabled(False):
        want = scores_before_and_after(JAX, key, TENSORSCORE, jax_open, jax_close, jax_parse)
    got = scores_before_and_after(TORCH, key, TENSORSCORE, torch_open, torch_close, torch_parse)
    serial = scores_before_and_after(TORCH, key, NODEORDER, torch_open, torch_close, torch_parse)
    assert got == want
    assert got == serial
    assert got[0] and got[0] != got[1]


ALLOCATE_WORLDS = ["gang_atomic", "priority_spread", "pipelined", "multi_queue", "node_affinity_score",
                   "scalar_resources", "pod_affinity_many", "synthetic_200_20", "preempt_mix_2000_40_seed1"]


@pytest.mark.parametrize("mesh", ["off", "cpu:4"])
@pytest.mark.parametrize("key", ALLOCATE_WORLDS)
def test_tensorscore_conf_solves_on_the_device_rung(key, mesh):
    """A conf naming tensorscore is inside torch_allocate's envelope: it
    solves on the fused or sharded rung, with the JAX xla_allocate's and
    the serial nodeorder allocate's outcome."""
    args = {"torch_allocate": {"device": "cpu", "min_device_pairs": "0", "mesh": mesh}}
    want = jax_run(["xla_allocate"], make(key, JAX), TENSORSCORE)
    assert jax_run(["allocate"], make(key, JAX), NODEORDER) == want
    got = torch_run(["torch_allocate"], make(key, TORCH), TENSORSCORE, args)
    assert got == want
    from kube_batch_tpu_torch.framework import get_action

    assert get_action("torch_allocate").last_solver_tier == ("fused" if mesh == "off" else "sharded")


def two_pauses(P):
    """Two required-affinity pods separated by fillers that shift the
    LeastRequested balance between the anchors' nodes (the JAX package's
    tests/test_tensorscore.py scene)."""
    rl = P.t.build_resource_list
    pods, groups = [], []
    for i in (0, 1):
        pods.append(P.t.build_pod(name=f"anchor{i}", node_name=f"n{i}", phase=P.apis.PodPhase.RUNNING,
                                  req=rl(cpu=1, memory="128Mi"), labels={"app": "db"}))

    def gang(name, pod, ts):
        pod.metadata.creation_timestamp = ts
        pg = P.t.build_pod_group(name, min_member=1)
        pg.metadata.creation_timestamp = ts
        pods.append(pod)
        groups.append(pg)

    def follower(name):
        pod = P.t.build_pod(name=name, group_name=f"g-{name}", req=rl(cpu=1, memory="256Mi"))
        pod.affinity = P.apis.Affinity(pod_affinity_required=[P.apis.PodAffinityTerm(label_selector={"app": "db"})])
        return pod

    gang("g-aff1", follower("aff1"), 0.0)
    for i in range(4):
        gang(f"g-fill{i}", P.t.build_pod(name=f"fill{i}", group_name=f"g-fill{i}", req=rl(cpu=2, memory="2Gi")),
             1.0 + i)
    gang("g-aff2", follower("aff2"), 10.0)
    nodes = [P.t.build_node(f"n{i}", rl(cpu=8, memory="8Gi", pods=20)) for i in range(3)]
    return P.t.build_cluster(pods, nodes, groups, [P.t.build_queue("default")])


@pytest.mark.parametrize("mesh", ["off", "cpu:4"])
def test_second_host_step_sees_the_replayed_fillers(mesh):
    args = {"torch_allocate": {"device": "cpu", "min_device_pairs": "0", "mesh": mesh}}
    want = jax_run(["allocate"], two_pauses(JAX), NODEORDER)
    assert jax_run(["xla_allocate"], two_pauses(JAX), TENSORSCORE) == want
    assert torch_run(["allocate"], two_pauses(TORCH), TENSORSCORE) == want
    assert torch_run(["torch_allocate"], two_pauses(TORCH), TENSORSCORE, args) == want


def test_bulk_replay_bumps_state_seq():
    """With no host step the bulk replay is the only writer of node
    accounting in torch_allocate; it must advance ``state_seq`` so the
    tensorscore and nodeorder memos miss after it."""
    cache = torch_testing.FakeCache(make("synthetic_200_20", TORCH))
    ssn = torch_open(cache, torch_parse(TENSORSCORE).tiers, {"torch_allocate": {"device": "cpu"}})
    task = next(t for j in ssn.jobs.values() for t in j.tasks.values() if t.status == TaskStatus.PENDING)
    node = ssn.nodes[sorted(ssn.nodes)[0]]
    before = ssn.node_order_fn(task, node)
    seq = ssn.state_seq
    act = TorchAllocateAction()
    act.execute(ssn)
    assert act.last_solver_tier == "fused" and act.last_timings["host_steps"] == 0
    assert ssn.state_seq > seq
    assert cache.binder.binds
    # the memo missed: the score is the one a fresh session over the
    # replayed node state gives
    fresh = torch_open(torch_testing.FakeCache(make("synthetic_200_20", TORCH)), torch_parse(NODEORDER).tiers)
    fresh_node = fresh.nodes[node.name]
    fresh_node.used = node.used.clone()
    fresh.bump_state()
    assert ssn.node_order_fn(task, node) == fresh.node_order_fn(fresh.jobs[task.job].tasks[task.uid], fresh_node)
    assert ssn.node_order_fn(task, node) != before
    torch_close(ssn)
    torch_close(fresh)


# -- twins of tests/test_tensorscore.py's serial cases --------------------------


def assert_same_outcome(make, action="allocate"):
    """``action`` under nodeorder and under tensorscore, in both packages:
    four equal outcomes (task states, binds, evicts)."""
    want = jax_run([action], make(JAX), NODEORDER)
    assert jax_run([action], make(JAX), TENSORSCORE) == want
    assert torch_run([action], make(TORCH), NODEORDER) == want
    assert torch_run([action], make(TORCH), TENSORSCORE) == want
    return want


def test_allocate_synthetic():
    _, binds, _ = assert_same_outcome(lambda P: P.models.synthetic(300, 30))
    assert binds


def test_allocate_scalar_resources():
    _, binds, _ = assert_same_outcome(lambda P: P.models.multi_tenant_ml(n_jobs=10, n_nodes=10, n_queues=4))
    assert binds


def gen_cluster(P, seed: int):
    """tests/test_xla_allocate.py's ``gen_cluster`` with P's builders: the
    same draws in the same order."""
    import random

    rng = random.Random(seed)
    t, apis = P.t, P.apis
    queues = [t.build_queue(f"q{i}", weight=rng.randint(1, 3)) for i in range(rng.randint(1, 3))]
    for i, q in enumerate(queues):
        q.metadata.creation_timestamp = float(i)
    with_scalars = rng.random() < 0.35
    nodes = []
    for i in range(rng.randint(3, 10)):
        labels = {}
        if rng.random() < 0.4:
            labels["zone"] = rng.choice(["a", "b"])
        rl = t.build_resource_list(
            cpu=rng.randint(1, 8), memory=f"{rng.choice([1024, 2048, 4096, 8192])}Mi", pods=rng.randint(3, 12)
        )
        if with_scalars and rng.random() < 0.6:
            rl[P.models.GPU] = float(rng.choice([1, 2, 4]))
        node = t.build_node(f"n{i:02d}", rl, labels=labels)
        if rng.random() < 0.15:
            node.taints = [apis.Taint(key="dedicated", value="infra", effect="NoSchedule")]
        if rng.random() < 0.1:
            node.unschedulable = True
        nodes.append(node)
    pods, pgs = [], []
    for j in range(rng.randint(1, 7)):
        name = f"job{j}"
        n_tasks = rng.randint(1, 5)
        min_member = rng.randint(1, n_tasks + (1 if rng.random() < 0.2 else 0))
        pg = t.build_pod_group(name, queue=rng.choice(queues).name, min_member=min_member)
        pg.metadata.creation_timestamp = float(rng.randint(0, 3))
        pgs.append(pg)
        prio = rng.choice([None, 1, 5, 9])
        for k in range(n_tasks):
            req = t.build_resource_list(
                cpu=f"{rng.randint(1, 16) * 250}m", memory=f"{rng.choice([128, 256, 512, 1024, 2048])}Mi"
            )
            if with_scalars and rng.random() < 0.4:
                req[P.models.GPU] = float(rng.choice([1, 2]))
            pod = t.build_pod(
                name=f"{name}-t{k}", group_name=name, req=req,
                priority=prio if rng.random() < 0.8 else rng.choice([1, 5, 9]),
            )
            pod.metadata.creation_timestamp = float(rng.randint(0, 3))
            if rng.random() < 0.2:
                pod.node_selector = {"zone": rng.choice(["a", "b"])}
            if rng.random() < 0.15:
                pod.tolerations = [
                    apis.Toleration(key="dedicated", operator="Equal", value="infra", effect="NoSchedule")
                ]
            if rng.random() < 0.1:
                pod.affinity = apis.Affinity(node_affinity_preferred=[
                    (rng.randint(1, 10), apis.NodeSelectorTerm(key="zone", operator="In", values=["a"]))
                ])
            pods.append(pod)
    headroom = {
        n.name: [n.allocatable.get("cpu", 0.0) * 1000.0, n.allocatable.get("memory", 0.0)] for n in nodes
    }
    for r in range(rng.randint(0, 6)):
        node = rng.choice(nodes)
        cpu_m = rng.randint(1, 4) * 250
        mem_mi = rng.choice([128, 256, 512])
        room = headroom[node.name]
        if room[0] < cpu_m or room[1] < mem_mi * 1024 * 1024:
            continue
        room[0] -= cpu_m
        room[1] -= mem_mi * 1024 * 1024
        pod = t.build_pod(
            name=f"resident{r}", node_name=node.name, phase=apis.PodPhase.RUNNING,
            req=t.build_resource_list(cpu=f"{cpu_m}m", memory=f"{mem_mi}Mi"),
        )
        if rng.random() < 0.3:
            pod.metadata.deletion_timestamp = 1.0
        pods.append(pod)
    return t.build_cluster(pods, nodes, pgs, queues)


def test_gen_cluster_copy_draws_the_jax_worlds():
    from test_xla_allocate import gen_cluster as jax_gen_cluster

    for seed in range(16):
        want = jax_run(["allocate"], jax_gen_cluster(seed), NODEORDER)
        assert jax_run(["allocate"], gen_cluster(JAX, seed), NODEORDER) == want


def test_property_sweep():
    for seed in range(16):
        assert_same_outcome(lambda P: gen_cluster(P, seed))


def test_preempt_with_tensorscore():
    import test_xla_preempt

    for seed in range(8):
        assert_same_outcome(
            lambda P: (test_xla_preempt if P is JAX else torch_testing).gen_contended_cluster(seed), "preempt"
        )
