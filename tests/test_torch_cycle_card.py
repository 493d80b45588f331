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
shard per placing iteration. The solver ladder's ``solve.fused`` and
``solve.sharded`` drills on the card must give the CPU's binds and task
states on the same degraded paths, and an error of the card itself (a
cluster it cannot hold, a launch it refuses) must raise, not degrade.
"""

import pytest
import torch

from kube_batch_tpu_torch import models
from kube_batch_tpu_torch.actions.torch_allocate import DeviceSolveError, TorchAllocateAction
from kube_batch_tpu_torch.apis.types import Affinity, PodAffinityTerm, PodPhase
from kube_batch_tpu_torch.conf import parse_scheduler_conf
from kube_batch_tpu_torch.framework import close_session, open_session
from kube_batch_tpu_torch.ops import block_step as bs
from kube_batch_tpu_torch.ops import fused_solve as fs
from kube_batch_tpu_torch.ops import mesh_solve as ms
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
    fs.fused_solve.launches = bs.block_step.launches = ms.mesh_solve.launches = 0
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
    launches = (fs.fused_solve.launches, bs.block_step.launches, ms.mesh_solve.launches)
    if mesh == "off":
        assert launches == (segments, 0, 0)
    else:
        # kernel B4: the four shards lie on one card, one launch a segment
        placing = ga.last_counts["placing_iterations"]
        assert placing == ca.last_counts["placing_iterations"] > 0
        assert launches == (0, 0, segments) and ga.last_counts["launches"] == segments
        assert ga.last_timings["sharded_impl"] == ca.last_timings["sharded_impl"] == "mesh_kernel"


@pytest.mark.cuda
@pytest.mark.parametrize("drill", ["solve.fused", "solve.sharded"])
@pytest.mark.parametrize("world", ["preempt_mix_2000_40_seed1", "pod_affinity"])
def test_card_drill_equals_cpu_drill(monkeypatch, world, drill):
    """The solver ladder's drills on the card against the same drills on
    the CPU, each under a fresh ladder: ``solve.fused`` fails the fused
    rung's segment after B1 ran it and the cycle finishes serially;
    ``solve.sharded`` fails the sharded rung's first segment after it ran
    (B4 launched once, on the one card of the four shards) and the fused
    rung resumes it in the same cycle (B1 once per remaining segment).
    Binds and task states equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from kube_batch_tpu_torch import faults

    outs = []
    try:
        for device in ("cpu", "cuda"):
            ladder = faults.DegradationLadder(("sharded", "fused", "serial"))
            monkeypatch.setattr(faults, "solver_ladder", ladder)
            faults.registry.reset()
            faults.registry.arm(drill, count=1)
            fs.fused_solve.launches = bs.block_step.launches = ms.mesh_solve.launches = 0
            mesh = f"{device}:4" if drill == "solve.sharded" else "off"
            state, binds, act = run(world, {"device": device, "mesh": mesh})
            if device == "cuda":
                torch.cuda.synchronize()
            outs.append((state, binds, act, (fs.fused_solve.launches, bs.block_step.launches + ms.mesh_solve.launches,
                                             bs.block_step.launches), ladder))
    finally:
        faults.registry.reset()
    (cs, cb, ca, _, cl), (gs, gb, ga, (b1, b4, b2), gl) = outs
    assert (gs, gb) == (cs, cb) and gb
    if drill == "solve.fused":
        assert ga.last_solver_tier == ca.last_solver_tier == "serial"
        assert ga.last_timings["serial_reason"] == "solve_failed"
        assert (b1, b4) == (1, 0) and gl.breakers["fused"].failures == cl.breakers["fused"].failures == 1
    else:
        assert ga.last_solver_tier == ca.last_solver_tier == "fused"
        # B4 launches once for the sharded rung's first segment, even where
        # it pauses before its first placing iteration (pod_affinity)
        assert (b4, b2) == (1, 0) and b1 == 1 + ga.last_timings["host_steps"]
        assert gl.breakers["sharded"].failures == cl.breakers["sharded"].failures == 1


@pytest.mark.cuda
@pytest.mark.parametrize("refused", ["occupancy", "launch"])
def test_a_card_error_of_the_fused_rung_raises(monkeypatch, refused):
    """A cluster of 64 CTAs, past the largest a Hopper card holds (16): the
    occupancy check refuses it when the solver is made, before any solve;
    with the check skipped, the card refuses the launch inside the solve.
    Either raises ``DeviceSolveError`` out of the action: it feeds no
    breaker and counts no degraded cycle (the rung below is the CPU). The
    card solves the next cycle."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from kube_batch_tpu_torch import faults, metrics

    ladder = faults.DegradationLadder(("sharded", "fused", "serial"))
    monkeypatch.setattr(faults, "solver_ladder", ladder)
    launch_args = fs._launch_args

    def too_wide(dims):
        geo, args = launch_args(dims)
        args.k = 64
        return geo, args

    monkeypatch.setattr(fs, "_launch_args", too_wide)
    if refused == "launch":
        monkeypatch.setattr(fs, "_check_occupancy", lambda index, args: None)
    degraded = sum(metrics.degraded_cycles.samples().values())
    fs.fused_solve.launches = 0
    want = "cannot take this snapshot" if refused == "occupancy" else "failed on cuda.*launch failed"
    with pytest.raises(DeviceSolveError, match=want):
        run("preempt_mix_2000_40_seed1", {"device": "cuda"})
    assert fs.fused_solve.launches == 0
    assert all(b.failures == 0 and b.state == "closed" for b in ladder.breakers.values())
    assert sum(metrics.degraded_cycles.samples().values()) == degraded
    monkeypatch.undo()
    _, binds, act = run("preempt_mix_2000_40_seed1", {"device": "cuda"})
    assert act.last_solver_tier == "fused" and binds


@pytest.mark.cuda
def test_a_server_cycle_on_the_card_equals_the_cpu_cycle(tmp_path):
    """One cycle of the port as a process on the card against the same
    cycle on the CPU: ``preempt_mix(2000, 40, seed=1)`` seeded into a
    store (PodGroups Pending), a ``SchedulerCache`` over it and the twin
    pipeline conf through ``Scheduler.run_once``; the store shows the same
    binds and the same evictions, and the card's cycle launched B1."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import os

    from kube_batch_tpu_torch.cache import ClusterStore, SchedulerCache
    from kube_batch_tpu_torch.scheduler import Scheduler
    from kube_batch_tpu_torch.testing import seed_store

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "examples", "scheduler-conf-torch-pipeline.yaml")) as f:
        twin = f.read()
    out = {}
    for device in ("cpu", "cuda"):
        path = tmp_path / f"{device}.yaml"
        path.write_text(twin + f"actionArguments:\n  torch_allocate:\n    device: {device}\n    min_device_pairs: 0\n")
        store = ClusterStore()
        seed_store(store, *models.preempt_mix_objects(2000, 40, seed=1))
        cache = SchedulerCache(store)  # no write pool: the writes land inline
        sched = Scheduler(cache, str(path))
        fs.fused_solve.launches = bs.block_step.launches = 0
        sched.run_once()
        torch.cuda.synchronize()
        out[device] = (
            sorted((p.metadata.name, p.node_name) for p in store.list("pods")),
            sched.actions[2].last_solver_tier,
            (fs.fused_solve.launches, bs.block_step.launches),
        )
        cache.stop()
    (cpu_pods, cpu_tier, _), (card_pods, card_tier, card_launches) = out["cpu"], out["cuda"]
    assert card_pods == cpu_pods and card_tier == cpu_tier == "fused"
    assert sum(1 for _, node in card_pods if node) > 1000 and len(card_pods) < 2020  # binds and evictions
    assert card_launches == (1, 0)
