"""The GSPMD rung's surface in the port (``parallel/sharded.py``:
``ShardedSolver``, ``sharded_solve_allocate``) and torch_allocate's mesh,
case for case with tests/test_parallel.py, each held against the JAX
package on the same worlds (jax x64 off, the production float32 policy).

The port's surface is a thin layer over ``ShardedBlockSolver``; on a mesh
of CPU devices (``["cpu"] * m``) every shard keeps its own node block and
the block step runs its plain version, as the JAX suite's 8-device
virtual CPU mesh does.

The JAX cases and their counterparts here:
- ``test_sharded_solve_matches_single_device[2|4|8]`` (``:41``) and
  ``test_sharded_solve_multi_queue`` (``:58``): the same names; the port's
  sharded result against its single-device solve and against the JAX
  package's ``sharded_solve_allocate`` on ``make_mesh(n)``.
- ``test_xla_allocate_action_sharded_10k_parity`` (``:191``):
  ``test_torch_allocate_action_sharded_10k_parity``; torch_allocate with
  ``mesh: cpu:8`` at 10k tasks x 1k nodes, binds equal to its fused run
  and to the JAX action's.
- ``test_scheduler_conf_mesh_reaches_action`` (``:218``): the same name,
  through the port's ``Scheduler`` and conf.
- ``test_sharded_action_pod_affinity_resume_parity`` (``:242``): the same
  name; two pauses, host steps and sharded resumes, binds equal to the
  fused run and the JAX action's.
- ``test_sharded_solve_10k_class_bucket`` (``:305``): the same name,
  ``sharded_solve_allocate`` on 8 CPU shards with drf and proportion,
  against the port's fused solve and the JAX sharded solve.
- Out of scope: ``test_dryrun_multichip_contract`` (``:67``),
  ``test_dryrun_hermetic_to_poisoned_tpu`` (``:76``),
  ``test_dryrun_inprocess_path_touches_only_cpu`` (``:104``) and
  ``test_entry_contract`` (``:168``) test the JAX package's root-level
  ``__graft_entry__.py`` (its multichip dry run and jit entry), which the
  port does not have and no queue item ports.

Port-only cases at the end: a node bucket the mesh does not divide (the
JAX surface raises; the port's rung pads), the static blocks reused
through the tensor arena, and K of the batched exchange: the conf's
``exchange_batch`` where it names one, else the JAX package's rule
(``KBT_PIPELINE`` and ``KBT_EXCHANGE_BATCH``).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

import kube_batch_tpu.actions  # noqa: F401  (registers the JAX actions)
import kube_batch_tpu.plugins  # noqa: F401
from kube_batch_tpu import models as jax_models
from kube_batch_tpu.conf import parse_scheduler_conf as jax_parse
from kube_batch_tpu.framework import close_session as jax_close
from kube_batch_tpu.framework import get_action as jax_get_action
from kube_batch_tpu.framework import open_session as jax_open
from kube_batch_tpu.ops.encode import encode_session as jax_encode_session
from kube_batch_tpu.parallel import make_mesh as jax_make_mesh
from kube_batch_tpu.parallel import sharded_solve_allocate as jax_sharded_solve_allocate
from kube_batch_tpu.testing import FakeCache as JaxFakeCache
from kube_batch_tpu.testing import x64_enabled

import kube_batch_tpu_torch.actions  # noqa: F401  (registers the port's actions)
import kube_batch_tpu_torch.plugins  # noqa: F401
from kube_batch_tpu_torch import models, pipeline
from kube_batch_tpu_torch import testing as tt
from kube_batch_tpu_torch.conf import parse_scheduler_conf
from kube_batch_tpu_torch.framework import close_session, get_action, open_session
from kube_batch_tpu_torch.ops.carry import arrays_from_numpy
from kube_batch_tpu_torch.ops.encode import encode_session
from kube_batch_tpu_torch.ops.encode_cache import TensorArena
from kube_batch_tpu_torch.ops.kernels import result_of, solve_allocate_state
from kube_batch_tpu_torch.parallel import make_mesh
from kube_batch_tpu_torch.parallel.sharded import ShardedSolver, sharded_solve_allocate
from kube_batch_tpu_torch.scheduler import Scheduler

TIERS_YAML = """
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: predicates
  - name: nodeorder
"""

DEFAULT_TIERS_YAML = """
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""

RESULT = ("assigned_node", "assigned_kind", "assign_pos", "ready_cnt", "n_assigned")


def _weights(arrays: dict) -> dict:
    one = np.float32(1)
    return {**arrays, "w_least": one, "w_balanced": one, "w_aff": one, "w_podaff": one}


def encoded(make, tiers: str = TIERS_YAML, fair: bool = False) -> tuple[dict, dict]:
    """The solver arrays of one seeded world in each package (float32; the
    JAX package with x64 off), after checking they are equal."""
    with x64_enabled(False):
        ssn = jax_open(JaxFakeCache(make(jax_models)), jax_parse(tiers).tiers)
        j = jax_encode_session(ssn.jobs, ssn.nodes, ssn.queues, dtype=np.float32,
                               drf=ssn.plugins.get("drf") if fair else None,
                               proportion=ssn.plugins.get("proportion") if fair else None)
        jax_close(ssn)
    ssn = open_session(tt.FakeCache(make(models)), parse_scheduler_conf(tiers).tiers)
    t = encode_session(ssn.jobs, ssn.nodes, ssn.queues, dtype=np.float32,
                       drf=ssn.plugins.get("drf") if fair else None,
                       proportion=ssn.plugins.get("proportion") if fair else None)
    close_session(ssn)
    ja, ta = (_weights({k: np.asarray(v) for k, v in e.arrays.items() if k != "task_created"}) for e in (j, t))
    assert set(ja) == set(ta)
    for k in ja:
        np.testing.assert_array_equal(ja[k], ta[k], err_msg=k)
    return ja, ta


def assert_results_equal(ref, got, ctx: str, fields=RESULT) -> None:
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)), np.asarray(getattr(got, f)), err_msg=f"{ctx}: {f}")


def cpu_mesh(n: int):
    return make_mesh(devices=["cpu"] * n)


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_sharded_solve_matches_single_device(n_devices):
    ja, ta = encoded(lambda pkg: pkg.synthetic(120, 24, seed=3))
    single = result_of(solve_allocate_state(arrays_from_numpy(ta)))
    sharded = sharded_solve_allocate(ta, cpu_mesh(n_devices))
    assert_results_equal(single, sharded, f"m={n_devices} vs single")
    assert int(single.n_assigned) == int(sharded.n_assigned) > 0
    with x64_enabled(False):
        ref = jax_sharded_solve_allocate(ja, jax_make_mesh(n_devices))
    assert_results_equal(ref, sharded, f"m={n_devices} vs JAX", RESULT[:3] + ("n_assigned",))


def test_sharded_solve_multi_queue():
    ja, ta = encoded(lambda pkg: pkg.multi_queue(96, 16, n_queues=3, tasks_per_job=6, seed=7))
    single = result_of(solve_allocate_state(arrays_from_numpy(ta)))
    sharded = sharded_solve_allocate(ta, cpu_mesh(8))
    assert_results_equal(single, sharded, "m=8 vs single", ("assigned_node",))
    with x64_enabled(False):
        ref = jax_sharded_solve_allocate(ja, jax_make_mesh(8))
    assert_results_equal(ref, sharded, "m=8 vs JAX", ("assigned_node",))


def _jax_action(cluster, tiers: str, args: dict) -> tuple[dict, int]:
    with x64_enabled(False):
        cache = JaxFakeCache(cluster)
        ssn = jax_open(cache, jax_parse(tiers).tiers, args)
        action = jax_get_action("xla_allocate")
        action.execute(ssn)
        jax_close(ssn)
    return dict(cache.binder.binds), action.last_mesh_size


def _port_action(cluster, tiers: str, mesh_spec: str) -> tuple[dict, int, str]:
    cache = tt.FakeCache(cluster)
    ssn = open_session(cache, parse_scheduler_conf(tiers).tiers,
                       {"torch_allocate": {"device": "cpu", "mesh": mesh_spec}})
    action = get_action("torch_allocate")
    action.execute(ssn)
    close_session(ssn)
    return dict(cache.binder.binds), action.last_mesh_size, action.last_solver_tier


def test_torch_allocate_action_sharded_10k_parity():
    """The multi-device path through the real action: conf-style
    arguments select an 8-shard mesh, the action comes from the registry,
    and at 10k tasks x 1k nodes the sharded run's binds equal the fused
    run's and the JAX action's on its 8-device mesh."""
    sharded, mesh_n, tier = _port_action(models.multi_queue(10_000, 1000), DEFAULT_TIERS_YAML, "cpu:8")
    assert mesh_n == 8 and tier == "sharded", "sharded path did not engage"
    single, mesh_1, tier_1 = _port_action(models.multi_queue(10_000, 1000), DEFAULT_TIERS_YAML, "off")
    assert mesh_1 == 1 and tier_1 == "fused"
    assert len(sharded) == 10_000
    assert sharded == single
    ref, ref_n = _jax_action(jax_models.multi_queue(10_000, 1000), DEFAULT_TIERS_YAML, {"xla_allocate": {"mesh": "cpu:8"}})
    assert ref_n == 8 and sharded == ref


def test_scheduler_conf_mesh_reaches_action(tmp_path):
    """The actionArguments flow: conf text -> Scheduler -> open_session ->
    torch_allocate resolves the mesh (two CPU shards)."""

    def run(mesh_args: str):
        path = tmp_path / f"conf{len(mesh_args)}.yaml"
        path.write_text('actions: "torch_allocate"\n' + TIERS_YAML
                        + "actionArguments:\n  torch_allocate:\n    device: cpu\n    min_device_pairs: 0\n"
                        + mesh_args)
        cache = tt.FakeCache(models.synthetic(48, 8, seed=5))
        sched = Scheduler(cache, str(path))
        sched.run_once()
        action = next(a for a in sched.actions if a.name == "torch_allocate")
        return dict(cache.binder.binds), action.last_mesh_size

    sharded, mesh_n = run('    mesh: "cpu:2"\n')
    assert mesh_n == 2
    single, mesh_1 = run("")
    assert mesh_1 == 1
    assert sharded == single and len(sharded) > 0
    ref, _ = _jax_action(jax_models.synthetic(48, 8, seed=5), TIERS_YAML, {"xla_allocate": {"mesh": "cpu:2"}})
    assert sharded == ref


def _affinity_world(t):
    """``t`` is a package's ``testing`` module; its ``apis.types`` builds
    the affinity terms."""
    from importlib import import_module

    types = import_module(t.__name__.split(".")[0] + ".apis.types")
    anchor = t.build_pod(name="anchor", node_name="n0", phase=types.PodPhase.RUNNING,
                         req=t.build_resource_list(cpu=1, memory="128Mi"), labels={"app": "db"})
    pods, groups = [anchor], []
    for i in range(12):
        p = t.build_pod(name=f"p{i}", group_name=f"g{i}", req=t.build_resource_list(cpu=1, memory="256Mi"))
        p.metadata.creation_timestamp = float(i)
        if i in (4, 9):  # two host-only tasks -> two pause/resume trips
            p.affinity = types.Affinity(pod_affinity_required=[types.PodAffinityTerm(label_selector={"app": "db"})])
        pg = t.build_pod_group(f"g{i}", min_member=1)
        pg.metadata.creation_timestamp = float(i)
        pods.append(p)
        groups.append(pg)
    nodes = [t.build_node(f"n{i}", t.build_resource_list(cpu=8, memory="8Gi", pods=20)) for i in range(4)]
    return t.build_cluster(pods, nodes, groups, [t.build_queue("default")])


def test_sharded_action_pod_affinity_resume_parity():
    """The segmented pod-affinity hybrid under a mesh: the paused state is
    gathered to the host, serial-stepped, and re-enters the sharded
    resume; binds match the single-device run and the JAX action's."""
    import kube_batch_tpu.testing as jax_testing

    sharded, mesh_n, tier = _port_action(_affinity_world(tt), TIERS_YAML, "cpu:4")
    assert mesh_n == 4 and tier == "sharded"
    single, _, _ = _port_action(_affinity_world(tt), TIERS_YAML, "off")
    assert sharded == single and len(sharded) == 12
    ref, _ = _jax_action(_affinity_world(jax_testing), TIERS_YAML, {"xla_allocate": {"mesh": "cpu:4"}})
    assert sharded == ref


@functools.lru_cache(maxsize=1)
def _bucket_10k():
    return encoded(lambda pkg: pkg.multi_queue(10_000, 1000), DEFAULT_TIERS_YAML, fair=True)


def test_sharded_solve_10k_class_bucket():
    """Scale: a 10k-task x 1k-node bucket under the default conf (drf and
    proportion in the loop state), sharded 8 ways (128 node columns a
    shard): assignment for assignment the single-device solve's and the
    JAX sharded solve's."""
    ja, ta = _bucket_10k()
    single = result_of(solve_allocate_state(arrays_from_numpy(ta), None, True, True))
    sharded = sharded_solve_allocate(ta, cpu_mesh(8), enable_drf=True, enable_proportion=True)
    assert_results_equal(single, sharded, "10k m=8", ("assigned_node", "assigned_kind"))
    assert int(single.n_assigned) == int(sharded.n_assigned) == 10_000
    with x64_enabled(False):
        ref = jax_sharded_solve_allocate(ja, jax_make_mesh(8), enable_drf=True, enable_proportion=True)
    assert_results_equal(ref, sharded, "10k m=8 vs JAX", ("assigned_node", "assigned_kind"))


# -- port-only: the surface ------------------------------------------------------


def test_node_bucket_not_divisible_is_padded_where_jax_raises():
    """A node bucket the mesh does not divide: the JAX surface raises its
    divisibility ValueError; the port's rung pads the node axis itself, so
    its surface solves, equal to the single-device solve."""
    from kube_batch_tpu.parallel.sharded import ShardedSolver as JaxShardedSolver

    ja, ta = encoded(lambda pkg: pkg.synthetic(120, 24, seed=3))
    with x64_enabled(False), pytest.raises(ValueError, match="not divisible by mesh size 3"):
        JaxShardedSolver(ja, jax_make_mesh(3))
    single = result_of(solve_allocate_state(arrays_from_numpy(ta), None, False, False))
    assert_results_equal(single, sharded_solve_allocate(ta, cpu_mesh(3)), "m=3", ("assigned_node", "assigned_kind"))
    state = ShardedSolver(ta, cpu_mesh(3)).solve(None)
    np.testing.assert_array_equal(state.assigned_node.numpy(), single.assigned_node.numpy())


def test_sharded_solver_resumes_and_reuses_its_static_blocks_through_the_arena():
    """``solve(None)`` then ``solve(state)`` from the paused-free end state
    is a fixed point; a second ShardedSolver over equal statics reuses all
    three of kernel B4's static slabs from the arena (the cards' placement,
    no row delta), and both equal the JAX ShardedSolver field for field."""
    from kube_batch_tpu.parallel.sharded import ShardedSolver as JaxShardedSolver

    ja, ta = encoded(lambda pkg: pkg.preempt_mix(300, 16, seed=1), DEFAULT_TIERS_YAML, fair=True)
    arena = TensorArena("cpu")
    first = ShardedSolver(ta, cpu_mesh(4), True, True, arena=arena)
    got = first.solve(None)
    assert arena.full_uploads == 3 and arena.reuses == 0
    again = ShardedSolver(ta, cpu_mesh(4), True, True, arena=arena).solve(None)
    assert arena.full_uploads == 3 and arena.reuses == 3 and arena.row_updates == 0
    with x64_enabled(False):
        ref = JaxShardedSolver(ja, jax_make_mesh(4), True, True).solve(None)
    for f in ref._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)), getattr(got, f).numpy(), err_msg=f)
        np.testing.assert_array_equal(getattr(again, f).numpy(), getattr(got, f).numpy(), err_msg=f)
    resumed = first.solve(got)
    assert int(resumed.step) == int(got.step)


# -- port-only: K is the conf's alone ---------------------------------------------


@pytest.mark.parametrize("pipelined,raw", [
    (False, ""), (False, "8"), (True, ""), (True, "8"), (True, "0"), (True, "-3"), (True, "100"), (True, "64"),
    (True, "x"),
])
def test_the_environment_leaves_k_to_the_conf(monkeypatch, pipelined, raw):
    """A conf that names ``exchange_batch: 2`` keeps K = 2 whatever the
    environment holds; a conf that names none takes K from the JAX
    package's rule: 1 without the pipeline gate, else
    ``KBT_EXCHANGE_BATCH`` (4 when empty or not an integer, clamped to
    1..64)."""
    import kube_batch_tpu_torch.actions.torch_allocate as TA

    seen = []

    class Spy(TA.ShardedBlockSolver):
        def __init__(self, *a, **k):
            seen.append(k["exchange_batch"])
            super().__init__(*a, **k)

    monkeypatch.setattr(TA, "ShardedBlockSolver", Spy)
    monkeypatch.setenv(pipeline.ENV, "1" if pipelined else "0")
    monkeypatch.setenv("KBT_EXCHANGE_BATCH", raw)
    pipeline.reset()
    try:
        for args in ({}, {"exchange_batch": "2"}):
            cache = tt.FakeCache(models.preempt_mix(200, 8, seed=1))
            ssn = open_session(cache, parse_scheduler_conf(TIERS_YAML).tiers,
                               {"torch_allocate": {"device": "cpu", "mesh": "cpu:2", **args}})
            action = get_action("torch_allocate")
            action.execute(ssn)
            close_session(ssn)
            assert action.last_solver_tier == "sharded" and cache.binder.binds
    finally:
        pipeline.reset()
    rule = {"": 4, "8": 8, "0": 1, "-3": 1, "100": 64, "64": 64, "x": 4}[raw] if pipelined else 1
    assert seen == [rule, 2]
