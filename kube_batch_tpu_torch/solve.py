"""The port's lower entry point: a cluster snapshot in, the allocate
action's binds out, with no session (the scheduling cycle,
``scheduler.Scheduler``, is the normal one).

``allocate`` does the work of one allocate cycle of the reference
scheduler under the default conf (priority, gang, conformance / drf,
predicates, proportion, nodeorder): the drf and proportion open-session
state over the whole snapshot, the gang JobValid gate, the encode, the
solve, and the gang dispatch barrier — a job's allocated tasks are bound
only once its ready count reaches its minimum (actions/allocate.go:182-190,
session.go:262-300).

The solve runs on one of two device rungs: without a mesh, the whole solve
in one CUDA launch (``ops/fused_solve.py``); with one, the node-sharded
blocked solve (``parallel/sharded_block.py``), one block-step launch per
shard per placing iteration.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from kube_batch_tpu_torch.api.cluster_info import ClusterInfo
from kube_batch_tpu_torch.framework.session import gate_exempt
from kube_batch_tpu_torch.ops.carry import arrays_from_numpy
from kube_batch_tpu_torch.ops.encode import EncodedSnapshot, encode_session
from kube_batch_tpu_torch.ops.fused_solve import FusedSolver
from kube_batch_tpu_torch.ops.kernels import KIND_ALLOCATED, KIND_PIPELINED, SolveState
from kube_batch_tpu_torch.parallel.sharded_block import ShardedBlockSolver
from kube_batch_tpu_torch.plugins.drf import drf_state
from kube_batch_tpu_torch.plugins.gang import job_valid
from kube_batch_tpu_torch.plugins.proportion import proportion_state


@dataclass
class AllocateResult:
    state: SolveState | None  # post-solve, floats included; None when nothing was pending
    binds: dict[str, str]  # "namespace/name" -> node, in dispatch order
    pipelined: dict[str, str]  # tasks pipelined onto releasing capacity
    encoded: EncodedSnapshot
    # seconds per phase: encode_s, pack_s (pack + static upload), solve_s,
    # dispatch_s, and the solver's own split of solve_s (FusedSolver:
    # state_upload_s, fused_solve_s, fetch_s; ShardedBlockSolver:
    # state_upload_s, loop_s = select_s + exchange_s + update_s, fetch_s)
    timings: dict[str, float] = field(default_factory=dict)


def valid_jobs(cluster: ClusterInfo) -> dict:
    """The session's JobValid gate with the gang plugin's rule
    (gang.go:48-69, session.go:90-112): a job with fewer valid tasks than
    its minimum is left out of the cycle; Pending-phase PodGroups are
    exempt (enqueue owns them)."""
    return {uid: job for uid, job in cluster.jobs.items() if gate_exempt(job) or job_valid(job) is None}


def solver_inputs(enc: EncodedSnapshot, weights) -> dict:
    """The solve's input arrays from an encoded snapshot: the encoder's
    arrays less its host metadata, plus nodeorder's (leastrequested,
    balancedresource, nodeaffinity, podaffinity) weights as float32."""
    arrays = dict(enc.arrays)
    arrays.pop("task_created", None)  # host metadata, not a solve input
    w = np.asarray(weights, np.float32)
    arrays.update(w_least=w[0], w_balanced=w[1], w_aff=w[2], w_podaff=w[3])
    return arrays


def solver_arrays(
    cluster: ClusterInfo,
    enable_drf: bool = True,
    enable_proportion: bool = True,
    weights: tuple[float, float, float, float] = (1, 1, 1, 1),
) -> tuple[EncodedSnapshot, dict]:
    """The solver's input for one allocate cycle over `cluster`: the drf
    and proportion open-session state, the JobValid gate, the encode, and
    nodeorder's weights. Returns the snapshot and its numpy arrays."""
    drf = drf_state(cluster.jobs, cluster.nodes) if enable_drf else None
    prop = (
        proportion_state(cluster.jobs, cluster.nodes, cluster.queues)
        if enable_proportion
        else None
    )
    enc = encode_session(
        valid_jobs(cluster), cluster.nodes, cluster.queues,
        drf=drf, proportion=prop,
    )
    return enc, solver_inputs(enc, weights)


def allocate(
    cluster: ClusterInfo,
    *,
    enable_drf: bool = True,
    enable_proportion: bool = True,
    weights: tuple[float, float, float, float] = (1, 1, 1, 1),
    device: str | torch.device | None = None,
    mesh=None,
) -> AllocateResult:
    """One allocate cycle over `cluster` (not modified).

    ``weights`` are nodeorder's (leastrequested, balancedresource,
    nodeaffinity, podaffinity) weights; the defaults are the plugin's
    defaults (nodeorder.go:139-153). ``device`` defaults to "cuda"; the
    tests pass "cpu", which runs the kernel's plain version.

    ``mesh`` (``parallel.make_mesh``) runs the solve node-sharded over its
    devices with ``ShardedBlockSolver``: the block-step kernel on a CUDA
    mesh, its plain version on a CPU mesh. ``device``, when given, must
    then be of the mesh's device type.

    Raises NotImplementedError when a host-only task (pod affinity or
    volumes) reaches the head of its job: stepping such a task on the host
    and resuming belongs to the session layer (the ``torch_allocate``
    action, driven by ``scheduler.Scheduler``).
    """
    timings: dict[str, float] = {}
    t0 = time.perf_counter()
    enc, arrays = solver_arrays(cluster, enable_drf, enable_proportion, weights)
    timings["encode_s"] = time.perf_counter() - t0
    if not enc.tasks:
        return AllocateResult(None, {}, {}, enc, timings)

    t0 = time.perf_counter()
    if mesh is None:
        solver = FusedSolver(arrays_from_numpy(arrays), enable_drf, enable_proportion, device=device)
    else:
        kinds = {torch.device(d).type for d in mesh}
        if device is not None and kinds != {torch.device(device).type}:
            raise ValueError(f"device={device!r} but the mesh's devices are {sorted(kinds)}")
        solver = ShardedBlockSolver(arrays_from_numpy(arrays), mesh, enable_drf, enable_proportion)
    timings["pack_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = solver.solve()
    timings["solve_s"] = time.perf_counter() - t0
    timings.update(solver.timings)
    if int(state.paused_at) >= 0:
        task = enc.tasks[int(state.paused_at)]
        raise NotImplementedError(
            f"task {task.namespace}/{task.name} needs a host step (pod affinity or "
            "volumes); the pause/resume hybrid is not part of this entry point"
        )

    t0 = time.perf_counter()
    binds, pipelined = dispatch(enc, state)
    timings["dispatch_s"] = time.perf_counter() - t0
    return AllocateResult(state, binds, pipelined, enc, timings)


def dispatch(enc: EncodedSnapshot, state: SolveState) -> tuple[dict[str, str], dict[str, str]]:
    """The gang dispatch barrier over the solve's assignment: allocated
    tasks of jobs whose ready count reached their minimum are bound, job
    by job in row order; pipelined tasks are reported apart (they wait for
    releasing capacity and are not bound this cycle)."""
    n = enc.n_tasks
    node = state.assigned_node[:n].numpy()
    kind = state.assigned_kind[:n].numpy()
    task_job = enc.arrays["task_job"][:n]
    jn = enc.n_jobs
    ready = state.ready_cnt[:jn].numpy() >= enc.arrays["job_min"][:jn]
    names = enc.node_names
    binds: dict[str, str] = {}
    pipelined: dict[str, str] = {}
    for row in np.flatnonzero((kind == KIND_ALLOCATED) & ready[task_job]):
        t = enc.tasks[row]
        binds[f"{t.namespace}/{t.name}"] = names[node[row]]
    for row in np.flatnonzero(kind == KIND_PIPELINED):
        t = enc.tasks[row]
        pipelined[f"{t.namespace}/{t.name}"] = names[node[row]]
    return binds, pipelined
