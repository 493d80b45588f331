"""The port's node-sharded blocked solve against the JAX package's solves.

``ShardedBlockSolver`` runs here on meshes of CPU devices (``["cpu"] *
m``: every shard keeps its own node block, as on the JAX package's
8-device virtual CPU mesh), where the block step runs its plain version.
On the same float32 snapshot, encoded by the JAX package with x64 off, it
must equal

- the JAX package's GSPMD-sharded XLA solve ``ShardedSolver`` on
  ``make_mesh(m)``,
- the JAX twin ``solve_allocate_state``, and
- the port's ``FusedSolver`` on the CPU (the fused kernel's plain version),

every ``SolveState`` field: integers exactly, floats as values (a zero
may carry either sign). The reference's own blocked solver
(``ShardedPallasSolver``) runs under the installed JAX only with a
test-side rename of one ``shard_map`` keyword (its ``check_rep`` is this
JAX's ``check_vma``): tests/test_torch_mesh_batched.py holds the port's
K-deep batched exchange against it that way. Here it is held through what
it is pinned to: these solves and, in tests/test_torch_block_step.py, its
block step.
"""

import functools

import numpy as np
import pytest
import torch

from kube_batch_tpu import models as jax_models
from kube_batch_tpu.ops.kernels import solve_allocate_state
from kube_batch_tpu.parallel import make_mesh as jax_make_mesh
from kube_batch_tpu.parallel.sharded import ShardedSolver
from kube_batch_tpu.testing import x64_enabled

from kube_batch_tpu_torch import models as torch_models
from kube_batch_tpu_torch.ops import block_step as bs
from kube_batch_tpu_torch.ops import carry
from kube_batch_tpu_torch.ops import fused_solve as fs
from kube_batch_tpu_torch.parallel import ShardedBlockSolver, make_mesh, node_blocks
from kube_batch_tpu_torch.solve import allocate

from test_torch_allocate import jax_outcome
from test_torch_encode import jax_encode, solver_arrays
from test_torch_solve import FLOAT_FIELDS, INT_FIELDS

WORLDS = {
    "synthetic_120_24": lambda pkg: pkg.synthetic(120, 24, seed=3),
    "multi_queue_96_16": lambda pkg: pkg.multi_queue(96, 16, n_queues=3, tasks_per_job=6, seed=7),
    "multi_tenant_ml_8_8_3": lambda pkg: pkg.multi_tenant_ml(8, 8, 3),
    # capacity runs short: tasks pipeline onto releasing capacity
    "preempt_mix_2000_40_seed1": lambda pkg: pkg.preempt_mix(2000, 40, seed=1),
}


def assert_states_equal(ref, got, ctx):
    for f in INT_FIELDS + FLOAT_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(ref, f)), np.asarray(getattr(got, f)), err_msg=f"{ctx}: {f}"
        )


def _np_state(s):
    return type(s)(*(np.asarray(x) for x in s))


@functools.lru_cache(maxsize=None)
def reference(world):
    """(solver arrays, JAX twin state, the port's fused plain state)."""
    a = solver_arrays(jax_encode(WORLDS[world](jax_models)))
    with x64_enabled(False):
        twin = _np_state(solve_allocate_state(a, None, enable_drf=True, enable_proportion=True))
    fused = fs.FusedSolver(carry.arrays_from_numpy(a), True, True, device="cpu").solve()
    return a, twin, carry.state_to_numpy(fused)


def sharded(a, m, k=1):
    solver = ShardedBlockSolver(
        carry.arrays_from_numpy(a), ["cpu"] * m, True, True, exchange_batch=k
    )
    return solver, solver.solve()


@pytest.mark.parametrize("m", [1, 2, 4, 8])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_sharded_matches_jax_sharded_twin_and_fused(world, m):
    a, twin, fused = reference(world)
    with x64_enabled(False):
        jax_sharded = _np_state(ShardedSolver(a, jax_make_mesh(m), True, True).solve(None))
    launches = bs.block_step.launches
    solver, got = sharded(a, m)
    got = carry.state_to_numpy(got)
    assert bs.block_step.launches == launches  # CPU blocks never launch the kernel
    assert_states_equal(jax_sharded, got, f"{world} m={m} vs JAX ShardedSolver")
    assert_states_equal(twin, got, f"{world} m={m} vs JAX twin")
    assert_states_equal(fused, got, f"{world} m={m} vs FusedSolver")
    assert solver.counts["placing_iterations"] == int((got.ptr - a["job_start"]).sum())


@pytest.mark.parametrize("world,m", [("synthetic_120_24", 3), ("multi_tenant_ml_8_8_3", 5), ("multi_queue_96_16", 7)])
def test_node_count_not_divisible_by_mesh(world, m):
    """128 encoded nodes over 3, 5 or 7 shards: the last block carries pad
    nodes, which never win; the solve is unchanged."""
    a, twin, fused = reference(world)
    assert a["node_idle"].shape[0] % m != 0
    solver, got = sharded(a, m)
    assert solver.n_pad > a["node_idle"].shape[0]
    got = carry.state_to_numpy(got)
    assert_states_equal(twin, got, f"{world} m={m}")
    assert_states_equal(fused, got, f"{world} m={m}")


@pytest.mark.parametrize(
    "world,m,k",
    [
        ("synthetic_120_24", 2, 2),
        ("synthetic_120_24", 4, 4),
        ("multi_queue_96_16", 2, 4),
        ("multi_queue_96_16", 4, 2),
        ("multi_tenant_ml_8_8_3", 8, 4),
        ("preempt_mix_2000_40_seed1", 2, 2),
    ],
)
def test_batched_exchange_matches_per_iteration_exchange(world, m, k):
    a, twin, _ = reference(world)
    _, one = sharded(a, m, 1)
    solver, got = sharded(a, m, k)
    assert_states_equal(carry.state_to_numpy(one), carry.state_to_numpy(got), f"{world} m={m} K={k}")
    assert_states_equal(twin, carry.state_to_numpy(got), f"{world} m={m} K={k} vs JAX twin")
    assert solver.batched_iters > 0, "no gang iteration committed from a batch"
    assert solver.counts["placing_iterations"] == int((got.ptr.numpy() - a["job_start"]).sum())


# -- pause at a host-only task, host step, resume with fresh pod_sc ---------


def pod_affinity_cluster():
    """An anchor pod on n0 and twelve one-pod gangs, two of which carry a
    required pod affinity to it: two host-only tasks, two pauses."""
    from kube_batch_tpu.apis.types import Affinity, PodAffinityTerm, PodPhase
    from kube_batch_tpu.testing import (
        build_cluster, build_node, build_pod, build_pod_group, build_queue, build_resource_list,
    )

    anchor = build_pod(
        name="anchor", node_name="n0", phase=PodPhase.RUNNING,
        req=build_resource_list(cpu=1, memory="128Mi"), labels={"app": "db"},
    )
    pods, groups = [anchor], []
    for i in range(12):
        p = build_pod(name=f"p{i}", group_name=f"g{i}", req=build_resource_list(cpu=1, memory="256Mi"))
        p.metadata.creation_timestamp = float(i)
        if i in (4, 9):
            p.affinity = Affinity(pod_affinity_required=[PodAffinityTerm(label_selector={"app": "db"})])
        pg = build_pod_group(f"g{i}", min_member=1)
        pg.metadata.creation_timestamp = float(i)
        pods.append(p)
        groups.append(pg)
    nodes = [build_node(f"n{i}", build_resource_list(cpu=8, memory="8Gi", pods=20)) for i in range(4)]
    return build_cluster(pods, nodes, groups, [build_queue("default")])


def host_step(a, s):
    """The host's step of the paused task: bind it to node 0 (where its
    affinity anchor runs), as the session layer would; numpy in and out."""
    s = type(s)(*(np.array(x) for x in s))
    t, cur, node = int(s.paused_at), int(s.cur), 0
    res = a["task_res"][t]
    s.idle[node] -= res
    s.used[node] += res
    s.ntasks[node] += 1
    s.assigned_node[t], s.assigned_kind[t], s.assign_pos[t] = node, 1, int(s.step)
    s.ptr[cur] += 1
    s.ready_cnt[cur] += 1
    s.job_alloc[cur] += res
    s.q_alloc[a["job_queue"][cur]] += res
    done = s.ready_cnt[cur] >= a["job_min"][cur]
    return s._replace(
        step=np.int32(int(s.step) + 1), cur=np.int32(-1 if done else cur), paused_at=np.int32(-1)
    )


@pytest.mark.parametrize("m", [1, 2, 4])
def test_pause_resume_with_refreshed_pod_sc_matches_twin(m):
    """Two pauses at host-only tasks, each followed by a host step and a
    resume with new live InterPodAffinity scores: every segment's state
    equals the JAX twin's segmented solve."""
    a = solver_arrays(jax_encode(pod_affinity_cluster()))
    ta = carry.arrays_from_numpy(a)
    solver = ShardedBlockSolver(ta, ["cpu"] * m, True, True)
    rng = np.random.default_rng(m)
    state_np, got = None, solver.solve()
    for segment in range(3):
        with x64_enabled(False):
            want = _np_state(solve_allocate_state(a, state_np, enable_drf=True, enable_proportion=True))
        assert_states_equal(want, carry.state_to_numpy(got), f"m={m} segment {segment}")
        if segment == 2:
            assert int(want.paused_at) < 0
            break
        assert int(want.paused_at) >= 0
        state_np = host_step(a, want)
        a = {**a, "pod_sc": rng.integers(0, 11, a["pod_sc"].shape).astype(np.float32)}
        ta["pod_sc"] = torch.from_numpy(a["pod_sc"])
        got = solver.solve(carry.state_from_numpy(state_np))


# -- the entry point ---------------------------------------------------------


@pytest.mark.parametrize(
    "world,m",
    [("gang_example", 3), ("synthetic_200_20", 2), ("multi_tenant_ml_8_8_3", 4), ("preempt_mix_2000_40_seed1", 2)],
)
def test_allocate_on_a_mesh_matches_fused_and_serial(world, m):
    from test_torch_encode import build_world

    serial = jax_outcome("allocate", build_world(jax_models, world))
    fused = allocate(build_world(torch_models, world), device="cpu")
    res = allocate(build_world(torch_models, world), mesh=make_mesh(devices=["cpu"] * m))
    assert (res.binds, res.pipelined) == (fused.binds, fused.pipelined) == serial
    assert res.binds
    # the mesh kernel's exchange runs inside its launch, so the solve's own
    # split is the state's upload, the loop and the fetch
    for key in ("encode_s", "pack_s", "solve_s", "dispatch_s", "state_upload_s", "loop_s", "fetch_s"):
        assert key in res.timings


def test_kernel_impl_never_runs_on_cpu():
    """The mesh's device type alone decides: a CPU mesh runs the plain
    versions (B4's and, for the host loop, the block step's) and never a
    kernel, a mixed mesh or any other device type raises, and a cuda
    device asked of the entry point never meets a CPU mesh."""
    from kube_batch_tpu_torch.ops import mesh_solve as ms

    a = carry.arrays_from_numpy(reference("synthetic_120_24")[0])
    launches = ms.mesh_solve.launches
    solver = ShardedBlockSolver(a, ["cpu"] * 2, True, True)
    solver.solve()
    assert solver.impl == "mesh_kernel" and ms.mesh_solve.launches == launches
    assert all(c.xbuf is None and c.device.type == "cpu" for c in solver._mesh.cards)
    solver = ShardedBlockSolver(a, ["cpu"] * 2, True, True, impl="host_loop")
    assert all(step._args is None for step in solver._steps)
    for mesh in (["cpu", "cuda:0"], ["meta"]):
        with pytest.raises(ValueError, match="all cuda or all cpu"):
            ShardedBlockSolver(a, mesh, True, True)
    with pytest.raises(ValueError, match="device='cuda' but the mesh"):
        allocate(torch_models.synthetic(20, 4), device="cuda", mesh=["cpu"])


def test_float64_arrays_are_refused():
    a = carry.arrays_from_numpy(reference("synthetic_120_24")[0])
    a = {**a, "task_req": a["task_req"].double()}
    with pytest.raises(ValueError, match="float32-only"):
        ShardedBlockSolver(a, ["cpu"], True, True)


def test_make_mesh_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)
    assert make_mesh(devices=["cpu"] * 3) == (torch.device("cpu"),) * 3
    assert make_mesh(2, devices=["cpu"] * 3) == (torch.device("cpu"),) * 2


@pytest.mark.parametrize("n,m", [(128, 1), (128, 3), (5120, 4), (1024, 8), (7, 4)])
def test_node_blocks_split_the_padded_axis(n, m):
    blocks = node_blocks(n, m)
    size = -(-n // m)
    assert len(blocks) == m
    assert blocks[0][0] == 0 and blocks[-1][1] == m * size >= n
    assert all(hi - lo == size for lo, hi in blocks)
    assert all(blocks[i][1] == blocks[i + 1][0] for i in range(m - 1))


@pytest.mark.parametrize("R,P,limit", [(9, 1, "resource rank 9"), (2, 32, "32 host ports")])
def test_envelope_raises_naming_the_limit(R, P, limit):
    from test_torch_solve import _envelope_arrays

    with pytest.raises(ValueError, match=limit):
        ShardedBlockSolver(_envelope_arrays(R, P), ["cpu"] * 2, True, True)
