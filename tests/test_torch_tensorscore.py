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
