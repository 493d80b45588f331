"""The `torch_allocate` action on the card against the same action on the
CPU (the kernels' plain versions), through each package-side session.

Every test here carries the `cuda` marker and skips without a GPU. The
file imports only the port (no jax), so it also runs where the JAX
package is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cycle_card.py

On the same world both devices must give the same binds, the same
``{task uid: (status, node)}``, the same host steps and the same final
`SolveState`, field for field; the fused rung on the card must launch
kernel B1 once per solve segment and the sharded rung kernel B2 once per
shard per placing iteration.
"""

import pytest
import torch

from kube_batch_tpu_torch import models
from kube_batch_tpu_torch.actions.torch_allocate import TorchAllocateAction
from kube_batch_tpu_torch.apis.types import Affinity, PodAffinityTerm, PodPhase
from kube_batch_tpu_torch.conf import parse_scheduler_conf
from kube_batch_tpu_torch.framework import close_session, open_session
from kube_batch_tpu_torch.ops import block_step as bs
from kube_batch_tpu_torch.ops import fused_solve as fs
from kube_batch_tpu_torch.ops.kernels import SolveState
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


def pod_affinity_world():
    """An anchor on n0 and a follower with a required pod affinity to it
    (one host step), beside ordinary gangs."""
    rl = build_resource_list(cpu=1, memory="256Mi")
    anchor = build_pod(name="anchor", node_name="n0", phase=PodPhase.RUNNING, req=rl, labels={"app": "db"})
    follower = build_pod(name="follower", group_name="f", req=rl)
    follower.affinity = Affinity(pod_affinity_required=[PodAffinityTerm(label_selector={"app": "db"})])
    pods = [anchor, follower] + [build_pod(name=f"p{i}", group_name=f"g{i % 3}", req=rl) for i in range(9)]
    pgs = [build_pod_group("f", min_member=1)] + [build_pod_group(f"g{j}", min_member=2) for j in range(3)]
    for i, pg in enumerate(pgs):
        pg.metadata.creation_timestamp = float(i + 1)
    nodes = [build_node(f"n{i}", build_resource_list(cpu=4, memory="4Gi", pods=10)) for i in range(4)]
    return build_cluster(pods, nodes, pgs, [build_queue("default")])


WORLDS = {
    "synthetic_200_20": lambda: models.synthetic(200, 20),
    "multi_tenant_ml_8_8_3": lambda: models.multi_tenant_ml(8, 8, 3),
    "preempt_mix_2000_40_seed1": lambda: models.preempt_mix(2000, 40, seed=1),
    "pod_affinity": pod_affinity_world,
}


def run(world: str, args: dict):
    cache = FakeCache(WORLDS[world]())
    ssn = open_session(cache, parse_scheduler_conf(CONF).tiers, {"torch_allocate": {"min_device_pairs": "0", **args}})
    act = TorchAllocateAction()
    act.execute(ssn)
    state = {
        t.uid: (t.status.name, t.node_name)
        for job in ssn.jobs.values()
        for tasks in job.task_status_index.values()
        for t in tasks.values()
    }
    close_session(ssn)
    return state, dict(cache.binder.binds), act


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", ["off", "4"])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_card_cycle_equals_cpu_cycle(world, mesh):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cpu = run(world, {"device": "cpu", "mesh": f"cpu:{mesh}" if mesh != "off" else "off"})
    fs.fused_solve.launches = bs.block_step.launches = 0
    card = run(world, {"device": "cuda", "mesh": f"cuda:{mesh}" if mesh != "off" else "off"})
    torch.cuda.synchronize()
    (cs, cb, ca), (gs, gb, ga) = cpu, card
    assert ga.last_solver_tier == ca.last_solver_tier == ("fused" if mesh == "off" else "sharded")
    assert (gs, gb) == (cs, cb)
    assert gb
    assert ga.last_timings["host_steps"] == ca.last_timings["host_steps"] == (1 if world == "pod_affinity" else 0)
    for f in SolveState._fields:
        a, b = getattr(ca.last_state, f), getattr(ga.last_state, f)
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), f
    segments = 1 + ga.last_timings["host_steps"]
    if mesh == "off":
        assert (fs.fused_solve.launches, bs.block_step.launches) == (segments, 0)
    else:
        placing = ga.last_counts["placing_iterations"]
        assert placing == ca.last_counts["placing_iterations"] > 0
        assert (fs.fused_solve.launches, bs.block_step.launches) == (0, 4 * placing) == (0, ga.last_counts["launches"])
