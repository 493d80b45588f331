#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kube_batch_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds both kernels from their sources, one nvcc each, at once:
   csrc/fused_solve.cu (B1, the whole solve) and csrc/block_step.cu (B2,
   one shard's block step), and prints each entry function's registers,
   spills and static shared memory from ptxas;
   then runs the card tests of both kernels (the ``cuda``-marked tests of
   tests/test_torch_kernel.py and tests/test_torch_block_step.py, pytest
   in a subprocess): bit-equality at the cluster's slice bounds, ties
   across CTAs, pauses, global scratch;
3. holds B1 against its plain version (fused_solve_plain, on the CPU) on
   the same packed inputs of five worlds, ``preempt_mix(50_000, 1_000)``
   the largest: integer state exactly, float state bit for bit (the
   float32 operations and their order are the same on both sides, so no
   tolerance is allowed). At 50k x 5k the whole solve's plain run takes
   minutes of host CPU, so there B1 is held against it over a prefix (the
   first sixteenth of the job rows active) and, over the whole solve,
   through the sharded path (5), whose kernel shares B1's node arithmetic;
4. holds B2 against its plain version (block_step_plain, on the CPU), bit
   for bit, on full-width blocks: the 5,120-node block of
   ``preempt_mix(50_000, 5_000)`` from its entry state and from a
   mid-solve state for one task of every class, the same state split into
   four blocks (non-zero offsets), ``multi_tenant_ml(200, 500)`` (scalar
   resources) with host-port collisions, and a block with no candidate;
   times one call at each block width the main path launches (5,120,
   1,280 and 256 nodes): ``ms`` is the time per call of back-to-back
   launches from Python (CUDA events), as in every earlier run, and
   ``device_ms`` the kernel's own time per launch from the profiler's
   device trace, taken after every main path has run (so the profiler
   cannot slow them), null where the trace holds none;
5. drives the entry point on each of its two device rungs, with the launch
   counters zeroed just before each path and read just after:
   - the fused rung, ``allocate(..., device="cuda")``, on
     ``preempt_mix(50_000, 5_000)`` (capacity to spare) and
     ``preempt_mix(50_000, 1_000)`` (capacity runs short, so tasks
     pipeline onto releasing capacity);
   - the sharded rung, ``allocate(..., mesh=...)``, on 50k x 5k with one
     shard and with four shards on cuda:0, and on 50k x 1k with four;
     each must launch B2 once per shard per placing iteration and give
     the fused rung's binds, pipelined tasks and SolveState, integers
     exactly and floats as values;
   and checks every result's binds (no node past its idle or releasing
   capacity + eps, every bound job at its gang minimum);
6. runs the per-iteration exchange and the K-deep batched exchange
   (``preempt_mix(2000, 40, seed=1)``, four shards, K = 1 and K = 4),
   each timed and held against the fused rung;
7. drives the scheduling cycle, ``Scheduler(FakeCache(world),
   conf).run_once()`` with ``examples/scheduler-conf-torch.yaml``, the
   counters zeroed just before each cycle and read just after:
   - ``scheduler_fused``: ``preempt_mix(50_000, 5_000)`` on the fused
     rung, one B1 launch, binds equal to ``allocate``'s (step 5);
   - ``scheduler_sharded``: ``preempt_mix(50_000, 1_000)`` with
     ``mesh: cuda:4`` (four shards on the one card), as many B2 launches
     as ``allocate`` made on that mesh, binds equal to the fused rung's;
   - ``scheduler_affinity``: ``preempt_mix(10_000, 1_000)`` with 36 pods
     carrying required pod (anti-)affinity terms, on both rungs: host
     steps (each a pause, a serial step of the task, a resume), the same
     count, binds and final SolveState on both;
   each prints ``run_once``'s wall clock and its split (snapshot, plugins,
   the JobValid gate, the action's own split, backfill, close);
   - ``size_floor`` (a measurement, not a main path): ``run_once`` with
     the serial allocate against the fused rung on six small
     ``preempt_mix`` worlds (100 to 102,400 pending tasks x nodes), three
     cycles each, equal binds, and the example conf as it is on each, which
     must run serially exactly below torch_allocate's size floor;
   a failed cycle phase does not stop the others; the script then exits
   non-zero;
8. prints one JSON line per phase, the ``{"kernels": [...]}`` line, and as
   the last line ``{"ok": true, "device": {...}}``.

Each kernel record carries its cluster size ``k`` (CTAs per launch), the
roofline bound (``bound_ms``: the larger of bytes over the HBM rate and
float32 operations over the float32 rate, with the operations counted from
the node-axis work these inputs need) and, for B1, the time per iteration
of every world it times and a latency bound (``latency_bound_ms``: the
world's dependent iterations times the kernel's time per iteration on a
128-node world, measured in the same run).

Any failed phase raises and exits non-zero. Without a CUDA device it exits
with code 2 before printing any result.

    python3 chip_smoke.py --cards

runs instead the sharded rung over every visible card, one shard each
(two or more cards): ``allocate(preempt_mix(50_000, 5_000),
mesh=make_mesh())`` against the fused rung on cuda:0, and the fused rung
on the last card against it too.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

H100_HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# The data sheet's 67 TFLOP/s float32 (outside the tensor cores) counts an
# FMA as two operations. The kernel is built with -fmad=false and issues no
# FMA, so its peak is one float32 instruction per lane and clock: 33.5e12/s.
H100_FP32_OPS_PER_S = 67e12 / 2
# float32 operations (add, subtract, multiply, divide, compare, floor, abs:
# one each) the solve needs per node of the node axis and popped task:
# - each node whose fit has to be tested (statically compatible, with pod
#   room and free ports): per resource dim, idle + eps and releasing + eps,
#   and a compare against each;
# - each feasible node, scored: 2 adds (requested); per LeastRequested dim
#   2 compares, subtract, multiply, divide, floor; 2 compares and 2
#   divides (fractions); Balanced 2 compares, subtract, abs, multiply,
#   subtract; 2 multiplies and 2 adds (score sum); 1 compare (arg-max).
FIT_OPS_PER_DIM = 4
SCORE_OPS_PER_NODE = 29
B2_TIMED_CALLS = 200  # block-step launches per timing
CARD_TESTS = ["tests/test_torch_kernel.py", "tests/test_torch_block_step.py", "tests/test_torch_cycle_card.py"]
AFFINITY_PODS = 36  # pods of scheduler_affinity's world with required pod (anti-)affinity
# size_floor's preempt_mix(pods, nodes) worlds: 100 to 102,400 pending x nodes
FLOOR_WORLDS = ((25, 4), (50, 8), (100, 16), (200, 32), (400, 64), (800, 128))


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> list[dict]:
    """Per entry function in an ``nvcc -Xptxas=-v`` log: registers, spill
    bytes (stores, loads) and static shared memory bytes."""
    import re

    out = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            out.append({"function": m.group(1)})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and out:
            out[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[-1]["smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def card_tests() -> dict:
    """The card tests of both kernels, in a subprocess; raises on any
    failure."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-q", "-m", "cuda", *CARD_TESTS],
        cwd=root, capture_output=True, text=True, timeout=600,
    )
    tail = run.stdout.strip().splitlines()[-1] if run.stdout.strip() else ""
    if run.returncode != 0:
        raise AssertionError(f"card tests failed ({run.returncode}):\n{run.stdout[-4000:]}\n{run.stderr[-2000:]}")
    return {"phase": "card_tests", "files": CARD_TESTS, "summary": tail, "s": time.perf_counter() - t0}


def encoded_arrays(cluster):
    """The entry point's solver input, for the comparisons."""
    from kube_batch_tpu_torch.ops.carry import arrays_from_numpy
    from kube_batch_tpu_torch.solve import solver_arrays

    return arrays_from_numpy(solver_arrays(cluster)[1])


def kernel_vs_plain(name: str, a: dict, timed_runs: int = 1, state=None) -> dict:
    """Run the kernel (card) and the plain version (CPU) on the same packed
    inputs, from ``state`` (default: the entry state); raise on any
    difference. Returns the comparison record."""
    import torch

    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.ops.kernels import init_state

    packed = fs.pack(a, True, True)
    init = fs.pack_state(packed.dims, init_state(a, True, True) if state is None else state, a["job_queue"])

    t0 = time.perf_counter()
    plain = fs.PackedState(packed.dims, init.istate.clone(), init.fstate.clone())
    work = {"fit_nodes": 0, "scored_nodes": 0}
    fs.fused_solve_plain(packed, plain, work)
    plain_ms = (time.perf_counter() - t0) * 1e3

    dev = packed.to("cuda")
    geo = fs.solve_geometry(packed.dims)
    times = []
    for _ in range(timed_runs):
        st = fs.PackedState(packed.dims, init.istate.cuda(), init.fstate.cuda())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fs.fused_solve(dev, st)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    got_i, got_f = st.istate.cpu(), st.fstate.cpu()

    kv = fs.PackedState(packed.dims, got_i, got_f).views()
    pv = plain.views()
    for field in pv:
        if not torch.equal(kv[field], pv[field]):
            diff = (kv[field] != pv[field]).nonzero().flatten()[:5].tolist()
            raise AssertionError(
                f"{name}: kernel and plain differ in {field} at {diff}: "
                f"kernel {kv[field][diff].tolist()} plain {pv[field][diff].tolist()}"
            )
    if not torch.isfinite(got_f).all():
        raise AssertionError(f"{name}: non-finite float state")
    max_abs_err = float((got_f - plain.fstate).abs().max()) if got_f.numel() else 0.0
    d = packed.dims
    scal = kv["scal"]
    popped = int((kv["jptr"] - init.views()["jptr"]).sum())
    bytes_moved = 4 * (
        packed.istatic.numel() + packed.fstatic.numel()
        + 2 * (init.istate.numel() + init.fstate.numel())
    )
    ops = work["fit_nodes"] * FIT_OPS_PER_DIM * d.R + work["scored_nodes"] * SCORE_OPS_PER_NODE
    t_bytes = bytes_moved / H100_HBM_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_OPS_PER_S * 1e3
    ms = times[-1] if timed_runs == 1 else statistics.median(times[1:])
    return {
        "world": name,
        "T": d.T, "N": d.N, "J": d.J, "Q": d.Q, "C": d.C, "R": d.R,
        "k": geo.shape.k, "smem_bytes": geo.smem_bytes, "rep_in_smem": geo.rep_in_smem,
        "iterations": int(scal[0]), "assigned": int(scal[1]), "popped": popped,
        "pipelined": int((kv["tkind"] == 2).sum()),
        "ms": ms, "ms_per_iteration": ms / max(int(scal[0]), 1),
        "first_ms": times[0],
        "plain_ms": plain_ms,
        "max_abs_err": max_abs_err,
        "bytes": bytes_moved, "ops": ops, **work,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "match": True,
    }


def check_binds(res) -> dict:
    """Host-side checks of the entry point's result: capacity per node
    (idle for allocated tasks, releasing for pipelined ones) and the gang
    barrier per job."""
    import numpy as np

    enc, st = res.encoded, res.state
    a = enc.arrays
    n = enc.n_tasks
    node = st.assigned_node[:n].numpy()
    kind = st.assigned_kind[:n].numpy()
    req = a["task_res"][:n].astype(np.float64)
    eps = a["eps"].astype(np.float64)
    for k, pool in ((1, a["node_idle"]), (2, a["node_rel"])):
        rows = kind == k
        load = np.zeros(pool.shape, np.float64)
        np.add.at(load, node[rows], req[rows])
        over = load > pool.astype(np.float64) + eps
        if over.any():
            bad = np.argwhere(over)[0]
            raise AssertionError(f"node {enc.node_names[bad[0]]} over capacity in dim {bad[1]} (kind {k})")
    bound_jobs = {}
    row_of = {f"{t.namespace}/{t.name}": i for i, t in enumerate(enc.tasks)}
    for key in res.binds:
        j = int(a["task_job"][row_of[key]])
        bound_jobs[j] = bound_jobs.get(j, 0) + 1
    for j, cnt in bound_jobs.items():
        ready = int(a["job_ready0"][j]) + cnt
        if ready < int(a["job_min"][j]) or int(st.ready_cnt[j]) < int(a["job_min"][j]):
            raise AssertionError(f"job row {j} bound below its gang minimum")
    return {"capacity_ok": True, "gang_ok": True, "bound_jobs": len(bound_jobs)}


def block_work(block, task) -> dict:
    """The least the block step must read and compute for these inputs,
    node by node as a test that stops at the first failing condition
    would: every node's compat word; for the statically compatible ones,
    the pod count and limit; for those with pod room, the port mask; for
    those (the fit-tested nodes) the scalar-map flags when the task asks
    for scalars, and R idle and R releasing values; for the scored nodes
    (the ones that fit), 2 used and 2 allocatable values and the affinity
    score. (The kernel issues all of a node's loads at once, so it reads
    more.) Returns the node counts and the bytes (each input once, plus
    the record written)."""
    import torch

    from kube_batch_tpu_torch.ops.block_step import RECORD

    R = block.idle.shape[0]
    req = torch.tensor(task.req[:R], dtype=torch.float32, device=block.idle.device)[:, None]
    eps = torch.tensor(task.eps[:R], dtype=torch.float32, device=block.idle.device)[:, None]
    compat = block.cnode[task.gid] != 0
    room = compat & (block.ntasks < block.nmax)
    base = room & ((block.nports & task.tports) == 0)
    fi = (req < block.idle + eps).all(0)
    fr = (req < block.rel + eps).all(0)
    if task.has_sc:
        fi, fr = fi & (block.nihs != 0), fr & (block.nrhs != 0)
    n = {"nodes": block.cnode.shape[1], "compat_nodes": int(compat.sum()), "room_nodes": int(room.sum()),
         "fit_nodes": int(base.sum()), "scored_nodes": int((base & (fi | fr)).sum())}
    words = (
        n["nodes"] + 2 * n["compat_nodes"] + n["room_nodes"]
        + n["fit_nodes"] * (2 * R + (2 if task.has_sc else 0))
        + n["scored_nodes"] * 5
    )
    return {**n, "bytes": 4 * (words + RECORD)}


def kernel_device_ms(fn, calls: int, name: str) -> float | None:
    """Mean device time of the kernels whose name holds ``name`` over
    ``calls`` calls of ``fn``, from the profiler's trace of the card; None
    when the trace holds no device time for them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if name in e.key and e.count > 0]
    total = sum(e.device_time_total for e in events)  # microseconds
    count = sum(e.count for e in events)
    return total / count / 1e3 if count and total > 0 else None


def block_vs_plain(name: str, block, task, timed: bool = False) -> dict:
    """B2 on the card against its plain version on the CPU, on the same
    block and task; raises on any difference. With ``timed``: the time
    per call of back-to-back launches from CUDA events (``ms``, which
    holds the host's cost of each launch too), the plain version's from
    the host clock, the roofline bound, and the prepared step under
    ``"step"`` for ``time_b2_kernel``."""
    import torch

    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops.cluster import cluster_shape

    host = bs.Block(**{k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in block.__dict__.items()})
    out = torch.zeros(bs.RECORD, dtype=torch.int32, device=block.idle.device)
    step = bs.BlockStep(block, out)
    launches = bs.block_step.launches
    got = bs.read_record(step(task).cpu())
    t0 = time.perf_counter()
    want = bs.block_step_plain(host, task)
    plain_ms = (time.perf_counter() - t0) * 1e3
    if got != want:
        raise AssertionError(f"{name}: block step kernel {got} != plain {want}")
    rec = {"case": name, "N": block.cnode.shape[1], "k": cluster_shape(block.cnode.shape[1]).k,
           "off": block.off, "gid": task.gid,
           "score": got[0], "index": got[1], "fits_idle": got[2], "max_abs_err": 0.0}
    if timed:
        for _ in range(10):
            step(task)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(B2_TIMED_CALLS):
            step(task)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / B2_TIMED_CALLS
        t0 = time.perf_counter()
        for _ in range(5):
            bs.block_step_plain(host, task)
        plain_ms = (time.perf_counter() - t0) * 1e3 / 5
        work = block_work(host, task)
        ops = work["fit_nodes"] * FIT_OPS_PER_DIM * block.idle.shape[0] + work["scored_nodes"] * SCORE_OPS_PER_NODE
        t_bytes = work["bytes"] / H100_HBM_BYTES_PER_S * 1e3
        t_ops = ops / H100_FP32_OPS_PER_S * 1e3
        rec.update({
            "step": (step, task), "ms": ms, "plain_ms": plain_ms, **work, "ops": ops,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        })
    rec["plain_ms"] = plain_ms
    bs.block_step.launches = launches  # comparison launches are not the main path's
    return rec


def time_b2_kernel(rec: dict) -> None:
    """Set ``device_ms`` of a timed B2 record: the kernel's device time per
    launch from the profiler's trace (None where the trace has none)."""
    from kube_batch_tpu_torch.ops import block_step as bs

    step, task = rec.pop("step")
    launches = bs.block_step.launches
    kernel_ms = kernel_device_ms(lambda: step(task), B2_TIMED_CALLS, "block_step_kernel")
    bs.block_step.launches = launches  # timing launches are not the main path's
    rec["device_ms"] = kernel_ms


def b2_comparisons(arrays_5k, arrays_1k, arrays_ml) -> list[dict]:
    """B2 against its plain version on every listed input (see the module
    docstring, step 4). Returns the records; the timed ones (``step``
    set) are the main path's blocks at their entry state: 50k x 5k's
    5,120-node block (one shard) and 1,280-node blocks (four), and
    50k x 1k's 256-node blocks (four)."""
    import numpy as np
    import torch

    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops.fused_solve import FusedSolver
    from kube_batch_tpu_torch.ops.kernels import init_state
    from kube_batch_tpu_torch.parallel import ShardedBlockSolver

    cuda = torch.device("cuda", 0)
    recs = []
    entry = init_state(arrays_5k, True, True)
    # a mid-solve node state: the fused kernel's solve of the first half
    # of the jobs
    half = entry._replace(job_active=entry.job_active.clone())
    half.job_active[half.job_active.shape[0] // 2 :] = False
    mid = FusedSolver(arrays_5k, True, True, device=cuda).solve(half)
    one = ShardedBlockSolver(arrays_5k, [cuda], True, True)
    four = ShardedBlockSolver(arrays_5k, [cuda] * 4, True, True)
    for label, state in (("entry", entry), ("mid", mid)):
        one._upload(state)
        four._upload(state)
        for c, task in enumerate(one._tasks):
            timed = label == "entry" and c == 0
            recs.append(block_vs_plain(f"preempt_mix_50k_5k_{label}_class{c}", one.blocks[0], task, timed=timed))
            for k, blk in enumerate(four.blocks):
                recs.append(block_vs_plain(f"preempt_mix_50k_5k_{label}_class{c}_shard{k}of4", blk, task,
                                           timed=timed and k == 0))
    four_1k = ShardedBlockSolver(arrays_1k, [cuda] * 4, True, True)
    four_1k._upload(init_state(arrays_1k, True, True))
    for k, blk in enumerate(four_1k.blocks):
        recs.append(block_vs_plain(f"preempt_mix_50k_1k_entry_class0_shard{k}of4", blk, four_1k._tasks[0],
                                   timed=k == 0))
    # no candidate: nothing idle or releasing anywhere, for the task with
    # the largest cpu request (the encoder's pad rows request nothing, and
    # nothing fits within eps)
    blk = one.blocks[0]
    empty = bs.Block(**{**blk.__dict__, "idle": torch.zeros_like(blk.idle), "rel": torch.zeros_like(blk.rel)})
    rec = block_vs_plain("preempt_mix_50k_5k_no_candidate", empty, max(one._tasks, key=lambda t: t.req[0]))
    if rec["score"] != float("-inf") or rec["index"] != one.n_pad or rec["fits_idle"] != 0:
        raise AssertionError(f"no-candidate block gave {rec}")
    recs.append(rec)
    # scalar resources (GPU/TPU dims, has_sc) and host-port collisions: half
    # the nodes hold port bit 0 or 1, and each task asks for bit 0
    ml = ShardedBlockSolver(arrays_ml, [cuda], True, True)
    ml._upload(init_state(arrays_ml, True, True))
    rng = np.random.default_rng(0)
    ml.blocks[0].nports.copy_(torch.from_numpy(rng.integers(0, 3, ml.n_loc).astype(np.int32)))
    for c, task in enumerate(ml._tasks):
        recs.append(block_vs_plain(f"multi_tenant_ml_200_500_class{c}", ml.blocks[0], task))
        ported = bs.Task.from_buffer_copy(task)
        ported.tports = 1
        recs.append(block_vs_plain(f"multi_tenant_ml_200_500_class{c}_port_collision", ml.blocks[0], ported))
    if not any(t.has_sc for t in ml._tasks):
        raise AssertionError("multi_tenant_ml_200_500 has no task with scalar requests")
    return recs


def same_state(name: str, want, got) -> None:
    """Every SolveState field equal: integers exactly, floats as values."""
    import torch

    for f in want._fields:
        x, y = getattr(want, f), getattr(got, f)
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y):
            raise AssertionError(f"{name}: SolveState.{f} differs from the fused rung's")


def affinity_world():
    """``preempt_mix(10_000, 1_000)`` with the first task of every tenth
    job (36 jobs) labelled ``app: spread-<k % 3>``: three of every four
    repel their own label on the host (required anti-affinity), the fourth
    is drawn to the previous label (required affinity). Each of them is
    stepped on the host when it reaches the head of its job."""
    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch.apis.types import Affinity, PodAffinityTerm

    cluster = models.preempt_mix(10_000, 1_000)
    jobs = sorted((j for j in cluster.jobs.values() if j.name.startswith("job-")), key=lambda j: j.uid)
    for k, job in enumerate(jobs[::10][:AFFINITY_PODS]):
        pod = min(job.tasks.values(), key=lambda t: t.uid).pod
        pod.metadata.labels = {"app": f"spread-{k % 3}"}
        if k % 4 == 3:
            pod.affinity = Affinity(pod_affinity_required=[PodAffinityTerm(label_selector={"app": f"spread-{(k - 1) % 3}"})])
        else:
            pod.affinity = Affinity(pod_anti_affinity_required=[PodAffinityTerm(label_selector={"app": f"spread-{k % 3}"})])
    return cluster


def conf_file(mesh: str | None = None, actions: str | None = None, **args) -> str:
    """examples/scheduler-conf-torch.yaml, with ``actions`` in place of its
    pipeline and ``mesh`` and torch_allocate's other ``args`` set when
    given (written beside the kernels' build, inside the checkout)."""
    import zlib

    from kube_batch_tpu_torch.ops import nvcc

    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(root, "examples", "scheduler-conf-torch.yaml")
    if mesh is not None:
        args = {"mesh": mesh, **args}
    if actions is None and not args:
        return path
    with open(path) as f:
        text = f.read()
    if actions is not None:
        text = text.replace('"torch_allocate, backfill"', f'"{actions}"')
    if args:
        text += "actionArguments:\n  torch_allocate:\n" + "".join(f"    {k}: {v}\n" for k, v in args.items())
    os.makedirs(nvcc.BUILD_DIR, exist_ok=True)
    out = os.path.join(nvcc.BUILD_DIR, f"scheduler-conf-torch-{zlib.crc32(text.encode()):08x}.yaml")
    with open(out, "w") as f:
        f.write(text)
    return out


def size_floor() -> dict:
    """The serial allocate against the fused rung, ``run_once`` for
    ``run_once``, over small ``preempt_mix`` worlds around torch_allocate's
    size floor (pending tasks x nodes below which it runs serially): three
    cycles per arm and world, each over a fresh world, equal binds. Then
    one cycle per world with the example conf as it is, which must route
    serially exactly below ``DEFAULT_MIN_DEVICE_PAIRS`` and solve on the
    fused rung from it up."""
    import torch

    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch.actions.torch_allocate import DEFAULT_MIN_DEVICE_PAIRS
    from kube_batch_tpu_torch.api.types import TaskStatus
    from kube_batch_tpu_torch.scheduler import Scheduler
    from kube_batch_tpu_torch.testing import FakeCache

    arms = {"serial": conf_file(actions="allocate, backfill"), "fused": conf_file(min_device_pairs=0),
            "default": conf_file()}

    def cycle(arm, pods, nodes):
        cache = FakeCache(models.preempt_mix(pods, nodes))
        sched = Scheduler(cache, arms[arm])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched.run_once()
        torch.cuda.synchronize()
        act = sched.actions[0]
        tier = act.last_solver_tier if act.name == "torch_allocate" else "serial"
        return time.perf_counter() - t0, tier, dict(cache.binder.binds)

    rows = []
    for pods, nodes in FLOOR_WORLDS:
        world = models.preempt_mix(pods, nodes)
        pairs = sum(len(j.task_status_index.get(TaskStatus.PENDING, {})) for j in world.jobs.values()) * nodes
        times = {"serial": [], "fused": []}
        for _ in range(3):
            for arm in times:
                s, tier, binds = cycle(arm, pods, nodes)
                if tier != arm:
                    raise AssertionError(f"preempt_mix({pods}, {nodes}) on the {arm} arm solved by {tier!r}")
                if arm == "serial":
                    want = binds
                elif binds != want:
                    raise AssertionError(f"preempt_mix({pods}, {nodes}): the fused rung's binds differ from serial's")
                times[arm].append(s)
        s, tier, binds = cycle("default", pods, nodes)
        expect = "serial" if pairs < DEFAULT_MIN_DEVICE_PAIRS else "fused"
        if tier != expect or binds != want:
            raise AssertionError(f"preempt_mix({pods}, {nodes}), {pairs} pairs: the default conf solved on the "
                                 f"{tier!r} rung, expected {expect!r} below a floor of {DEFAULT_MIN_DEVICE_PAIRS}")
        rows.append({"pods": pods, "nodes": nodes, "pairs": pairs, "binds": len(want),
                     "serial_s": statistics.median(times["serial"]), "fused_s": statistics.median(times["fused"]),
                     "serial_runs_s": times["serial"], "fused_runs_s": times["fused"], "default_tier": tier,
                     "default_s": s})
    serial_wins = [r["pairs"] for r in rows if r["serial_s"] <= r["fused_s"]]
    return {"phase": "size_floor", "min_device_pairs": DEFAULT_MIN_DEVICE_PAIRS, "worlds": rows,
            "serial_wins_up_to_pairs": max(serial_wins, default=0),
            "fused_wins_from_pairs": min((r["pairs"] for r in rows if r["pairs"] > max(serial_wins, default=0)),
                                         default=None)}


def scheduler_cycle(phase: str, cluster, mesh: str | None, tier: str) -> tuple[dict, object, object]:
    """One ``run_once`` over ``FakeCache(cluster)``, the launch counters
    zeroed just before and read just after. Returns the phase record, the
    cache and the action."""
    import torch

    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.scheduler import Scheduler
    from kube_batch_tpu_torch.testing import FakeCache

    cache = FakeCache(cluster)
    sched = Scheduler(cache, conf_file(mesh))
    torch.cuda.synchronize()
    fs.fused_solve.launches = bs.block_step.launches = 0
    t0 = time.perf_counter()
    sched.run_once()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    b1, b2 = fs.fused_solve.launches, bs.block_step.launches
    act = sched.actions[0]
    if act.name != "torch_allocate" or act.last_solver_tier != tier:
        raise AssertionError(f"{phase}: solved by {act.name} on the {act.last_solver_tier!r} rung, not {tier!r}")
    if "aborted" in sched.last_timings:
        raise AssertionError(f"{phase}: the cycle aborted: {sched.last_timings['aborted']}")
    rec = {
        "phase": phase, "mesh": mesh or "off", "tier": act.last_solver_tier, "run_once_s": wall_s,
        "cycle": dict(sched.last_timings), "torch_allocate": dict(act.last_timings),
        "b1_launches": b1, "b2_launches": b2, **({"counts": act.last_counts} if act.last_counts else {}),
        "binds": len(cache.binder.binds),
    }
    return rec, cache, act


def cycle_phases(clusters: dict, results: dict, mesh_launches: dict) -> tuple[list[str], dict]:
    """The three scheduling-cycle phases (module docstring, step 7). Each
    runs whatever the others did; returns the failures and the launches
    of each phase's main path."""
    failures, launches = [], {}

    def run(name, fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - every phase runs; the script fails at the end
            failures.append(f"{name}: {type(e).__name__}: {e}")
            print(f"chip_smoke: {name} failed: {type(e).__name__}: {e}", file=sys.stderr, flush=True)

    def fused():
        rec, cache, _ = scheduler_cycle("scheduler_fused", clusters["preempt_mix_50k_5k"], None, "fused")
        launches["scheduler_fused"] = (rec["b1_launches"], rec["b2_launches"])
        if (rec["b1_launches"], rec["b2_launches"]) != (1, 0):
            raise AssertionError(f"{rec['b1_launches']} B1 and {rec['b2_launches']} B2 launches; expected 1 and 0")
        if cache.binder.binds != results["preempt_mix_50k_5k"].binds:
            raise AssertionError("the cycle's binds differ from allocate()'s on the fused rung")
        emit({**rec, "equal_to_allocate": True})

    def sharded():
        rec, cache, _ = scheduler_cycle("scheduler_sharded", clusters["preempt_mix_50k_1k"], "cuda:4", "sharded")
        launches["scheduler_sharded"] = (rec["b1_launches"], rec["b2_launches"])
        want = mesh_launches[("preempt_mix_50k_1k", 4)]
        if (rec["b1_launches"], rec["b2_launches"]) != (0, want):
            raise AssertionError(f"{rec['b1_launches']} B1 and {rec['b2_launches']} B2 launches; expected 0 and {want}")
        if cache.binder.binds != results["preempt_mix_50k_1k"].binds:
            raise AssertionError("the cycle's binds differ from the fused rung's")
        emit({**rec, "equal_to_fused": True})

    ends = {}

    def affinity(label, mesh, tier):
        def go():
            rec, cache, act = scheduler_cycle(f"scheduler_affinity_{label}", affinity_world(), mesh, tier)
            launches[f"scheduler_affinity_{label}"] = (rec["b1_launches"], rec["b2_launches"])
            steps = act.last_timings["host_steps"]
            if steps < 1:
                raise AssertionError("no host step: no affinity task reached the head of its job")
            if tier == "fused" and rec["b1_launches"] != steps + 1:
                raise AssertionError(f"{rec['b1_launches']} B1 launches for {steps} host steps")
            if tier == "sharded" and rec["b2_launches"] != 4 * act.last_counts["placing_iterations"]:
                raise AssertionError(f"{rec['b2_launches']} B2 launches for {act.last_counts} on four shards")
            ends[label] = (steps, dict(cache.binder.binds), act.last_state)
            emit({**rec, "host_steps": steps, "affinity_pods": AFFINITY_PODS})
        return go

    run("scheduler_fused", fused)
    run("scheduler_sharded", sharded)
    run("scheduler_affinity_fused", affinity("fused", None, "fused"))
    run("scheduler_affinity_sharded", affinity("sharded", "cuda:4", "sharded"))

    def compare():
        if set(ends) != {"fused", "sharded"}:
            raise AssertionError("a rung of scheduler_affinity failed; nothing to compare")
        (fs_, fb, fst), (ss_, sb, sst) = ends["fused"], ends["sharded"]
        if fs_ != ss_:
            raise AssertionError(f"{fs_} host steps on the fused rung, {ss_} on the sharded rung")
        if fb != sb:
            raise AssertionError("the rungs' binds differ")
        same_state("scheduler_affinity sharded", fst, sst)
        emit({"phase": "scheduler_affinity", "host_steps": fs_, "binds": len(fb), "rungs_equal": True})

    run("scheduler_affinity", compare)
    run("size_floor", lambda: emit(size_floor()))
    return failures, launches


def distinct_cards(card: str) -> int:
    """The sharded rung over every visible card, one shard each (see the
    module docstring)."""
    import torch

    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.ops import nvcc
    from kube_batch_tpu_torch.parallel import make_mesh
    from kube_batch_tpu_torch.solve import allocate

    t_start = time.perf_counter()
    m = torch.cuda.device_count()
    if m < 2:
        raise AssertionError(f"--cards needs two or more cards, found {m}")
    nvcc.build(["fused_solve", "block_step"])
    cluster = models.preempt_mix(50_000, 5_000)
    fused = allocate(cluster, device="cuda:0")
    last = torch.device("cuda", m - 1)
    on_last = allocate(cluster, device=last)
    if (on_last.binds, on_last.pipelined) != (fused.binds, fused.pipelined):
        raise AssertionError(f"the fused rung on {last} differs from cuda:0's")
    same_state(f"fused on {last}", fused.state, on_last.state)
    mesh = make_mesh()
    if len(set(mesh)) != m:
        raise AssertionError(f"make_mesh() gave {mesh}, not {m} distinct cards")
    torch.cuda.set_device(0)
    torch.cuda.synchronize()
    fs.fused_solve.launches = bs.block_step.launches = 0
    t0 = time.perf_counter()
    res = allocate(cluster, mesh=mesh)
    for d in mesh:
        torch.cuda.synchronize(d)
    total_s = time.perf_counter() - t0
    launches, stray = bs.block_step.launches, fs.fused_solve.launches
    placing = int((res.state.ptr.numpy() - res.encoded.arrays["job_start"]).sum())
    if stray or launches != placing * m:
        raise AssertionError(f"{launches} block-step and {stray} fused launches; expected {placing} x {m} and 0")
    if (res.binds, res.pipelined) != (fused.binds, fused.pipelined):
        raise AssertionError("the sharded rung over distinct cards differs from the fused rung's binds")
    same_state(f"mesh over {m} cards", fused.state, res.state)
    emit({
        "phase": f"allocate_mesh_preempt_mix_50k_5k_{m}cards", "mesh": [str(d) for d in mesh],
        "total_s": total_s, **res.timings, "iterations": int(res.state.it), "placing_iterations": placing,
        "launches": launches, "binds": len(res.binds), "equal_to_fused": True, **check_binds(res),
    })
    emit({"phase": "total", "s": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": m}})
    return 0


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if argv == ["--cards"]:
        card = card_line()
        emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__, "cuda": torch.version.cuda})
        return distinct_cards(card)
    if argv:
        print(f"chip_smoke: unknown arguments {argv}; usage: chip_smoke.py [--cards]", file=sys.stderr)
        return 2
    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.ops import nvcc
    from kube_batch_tpu_torch.ops.kernels import init_state
    from kube_batch_tpu_torch.parallel import ShardedBlockSolver, make_mesh
    from kube_batch_tpu_torch.solve import allocate

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    logs = nvcc.build(["fused_solve", "block_step"])
    fs._library.load()
    bs._library.load()
    emit({"phase": "build", "s": time.perf_counter() - t0,
          "ptxas": {name: ptxas_summary(log) for name, log in logs.items()}})
    emit(card_tests())

    # -- B1 against its plain version ----------------------------------------
    worlds = [
        ("synthetic_1k_100", lambda: models.synthetic(1000, 100)),
        ("multi_queue_10k_1k", lambda: models.multi_queue(10_000, 1000)),
        ("multi_tenant_ml_200_500", lambda: models.multi_tenant_ml(200, 500)),
    ]
    for name, make in worlds:
        rec = kernel_vs_plain(name, encoded_arrays(make()))
        emit({"phase": "kernel_vs_plain", **rec})
    # the per-iteration floor: a world whose node axis fits one node per
    # thread, so an iteration is the barriers and the dependent loads alone
    floor = kernel_vs_plain("preempt_mix_2k_40_seed1", encoded_arrays(models.preempt_mix(2000, 40, seed=1)),
                            timed_runs=4)
    floor_ms_per_iter = floor["ms_per_iteration"]
    emit({"phase": "kernel_vs_plain", **floor})

    main_worlds = [
        ("preempt_mix_50k_5k", lambda: models.preempt_mix(50_000, 5_000)),
        ("preempt_mix_50k_1k", lambda: models.preempt_mix(50_000, 1_000)),
    ]
    clusters, generate_s = {}, {}
    for name, make in main_worlds:
        t0 = time.perf_counter()
        clusters[name] = make()
        generate_s[name] = time.perf_counter() - t0
    arrays = {name: encoded_arrays(clusters[name]) for name, _ in main_worlds}

    b1_head = kernel_vs_plain("preempt_mix_50k_1k", arrays["preempt_mix_50k_1k"], timed_runs=4)
    b1_head["latency_bound_ms"] = b1_head["iterations"] * floor_ms_per_iter
    emit({"phase": "kernel_vs_plain", **b1_head})
    # B1 at the headline's full width, over a prefix of its work: only the
    # first sixteenth of the job rows active (the whole solve's plain run
    # takes minutes of host CPU)
    prefix = init_state(arrays["preempt_mix_50k_5k"], True, True)
    prefix = prefix._replace(job_active=prefix.job_active.clone())
    prefix.job_active[prefix.job_active.shape[0] // 16 :] = False
    emit({"phase": "kernel_vs_plain", "jobs_active": int(prefix.job_active.sum()),
          **kernel_vs_plain("preempt_mix_50k_5k_jobs_prefix", arrays["preempt_mix_50k_5k"], state=prefix)})

    # -- B2 against its plain version ----------------------------------------
    b2 = b2_comparisons(arrays["preempt_mix_50k_5k"], arrays["preempt_mix_50k_1k"],
                        encoded_arrays(models.multi_tenant_ml(200, 500)))
    b2_timed = {r["N"]: r for r in b2 if "step" in r}
    emit({"phase": "block_vs_plain", "inputs": len(b2), "bit_equal": True})
    b2_head = b2_timed[max(b2_timed)]

    # -- the fused rung's main path, through the entry point -----------------
    results, phases = {}, []
    torch.cuda.synchronize()
    fs.fused_solve.launches = bs.block_step.launches = 0
    for name, _ in main_worlds:
        before = fs.fused_solve.launches
        t0 = time.perf_counter()
        results[name] = allocate(clusters[name], device="cuda")
        torch.cuda.synchronize()
        phases.append((name, time.perf_counter() - t0, fs.fused_solve.launches - before))
    b1_launches, stray = fs.fused_solve.launches, bs.block_step.launches
    if stray:
        raise AssertionError(f"the fused rung launched the block step {stray} times")
    for name, total_s, n_launch in phases:
        if n_launch < 1:
            raise AssertionError(f"allocate on {name} did not launch the fused-solve kernel")
        res = results[name]
        emit({
            "phase": f"allocate_{name}", "generate_s": generate_s[name], "total_s": total_s,
            **res.timings, "binds": len(res.binds), "pipelined": len(res.pipelined),
            "tasks": res.encoded.n_tasks, "nodes": res.encoded.n_nodes, "launches": n_launch,
            **check_binds(res),
        })
    if not results["preempt_mix_50k_1k"].pipelined:
        raise AssertionError("preempt_mix_50k_1k pipelined nothing: the releasing branch did not run")
    b1_ms_5k, b1_iters_5k = [], 0
    for _ in range(2):  # B1 at the headline, kernel only (its plain run is the sharded path's job)
        packed = fs.pack(arrays["preempt_mix_50k_5k"], True, True)
        init = fs.pack_state(packed.dims, init_state(arrays["preempt_mix_50k_5k"], True, True),
                             arrays["preempt_mix_50k_5k"]["job_queue"])
        dev, st = packed.to("cuda"), fs.PackedState(packed.dims, init.istate.cuda(), init.fstate.cuda())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fs.fused_solve(dev, st)
        end.record()
        torch.cuda.synchronize()
        b1_ms_5k.append(start.elapsed_time(end))
        b1_iters_5k = int(st.istate[0])
    fs.fused_solve.launches = b1_launches  # timing launches are not the main path's
    geo_5k = fs.solve_geometry(packed.dims)
    b1_5k = {"ms": b1_ms_5k[-1], "iterations": b1_iters_5k, "ms_per_iteration": b1_ms_5k[-1] / b1_iters_5k,
             "latency_bound_ms": b1_iters_5k * floor_ms_per_iter, "k": geo_5k.shape.k,
             "smem_bytes": geo_5k.smem_bytes}
    emit({"phase": "fused_solve_50k_5k", "runs_ms": b1_ms_5k, **b1_5k})

    # -- the sharded rung's main path ----------------------------------------
    cuda0 = torch.device("cuda", 0)
    b2_launches = 0
    mesh_launches = {}
    for name, m in (("preempt_mix_50k_5k", 1), ("preempt_mix_50k_5k", 4), ("preempt_mix_50k_1k", 4)):
        torch.cuda.synchronize()
        fs.fused_solve.launches = bs.block_step.launches = 0
        t0 = time.perf_counter()
        res = allocate(clusters[name], device="cuda", mesh=make_mesh(devices=[cuda0] * m))
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches, stray = bs.block_step.launches, fs.fused_solve.launches
        placing = int((res.state.ptr - arrays[name]["job_start"]).sum())
        if stray:
            raise AssertionError(f"the sharded rung launched the fused solve {stray} times")
        if launches < 1 or launches != placing * m:
            raise AssertionError(f"{name} m={m}: {launches} block-step launches, expected {placing} x {m}")
        fused = results[name]
        if (res.binds, res.pipelined) != (fused.binds, fused.pipelined):
            raise AssertionError(f"{name} m={m}: binds or pipelined tasks differ from the fused rung's")
        same_state(f"{name} m={m}", fused.state, res.state)
        b2_launches += launches
        mesh_launches[(name, m)] = launches
        emit({
            "phase": f"allocate_mesh_{name}_m{m}", "total_s": total_s, **res.timings,
            "iterations": int(res.state.it), "placing_iterations": placing, "launches": launches,
            "binds": len(res.binds), "pipelined": len(res.pipelined),
            "equal_to_fused": True, **check_binds(res),
        })

    # -- the K-deep batched exchange, beside the per-iteration exchange -----
    small = encoded_arrays(models.preempt_mix(2000, 40, seed=1))
    want = fs.FusedSolver(small, True, True, device=cuda0).solve()
    saved = bs.block_step.launches
    for k in (1, 4):
        solver = ShardedBlockSolver(small, [cuda0] * 4, True, True, exchange_batch=k)
        t0 = time.perf_counter()
        same_state(f"preempt_mix_2k_40_seed1 m=4 K={k}", want, solver.solve())
        solve_s = time.perf_counter() - t0
        if k > 1 and solver.batched_iters < 1:
            raise AssertionError("the batched exchange committed no iteration from a batch")
        emit({"phase": f"exchange_preempt_mix_2k_40_seed1_m4_k{k}", "s": solve_s,
              "batched_iters": solver.batched_iters, **solver.counts, "equal_to_fused": True})
    bs.block_step.launches = saved

    # -- the scheduling cycle: session, plugins, torch_allocate, replay ----
    failures, cycle_launches = cycle_phases(clusters, results, mesh_launches)
    if failures:
        print("chip_smoke: failed phases:\n  " + "\n  ".join(failures), file=sys.stderr, flush=True)
        return 1
    b1_by_path = {"allocate_fused": b1_launches, **{k: v[0] for k, v in cycle_launches.items() if v[0]}}
    b2_by_path = {"allocate_mesh": b2_launches, **{k: v[1] for k, v in cycle_launches.items() if v[1]}}

    for rec in b2_timed.values():  # B2's device time, with the profiler, last
        time_b2_kernel(rec)
        emit({"phase": "block_step_timed", **rec})

    emit({"kernels": [
        {
            "name": "fused_solve",
            "route": "cuda",
            "source": "kube_batch_tpu_torch/csrc/fused_solve.cu",
            "replaces": "kube_batch_tpu/ops/pallas_solve.py:442",
            "launches": sum(b1_by_path.values()),
            "launches_by_path": b1_by_path,
            "max_abs_err": b1_head["max_abs_err"],
            "ms": b1_head["ms"],
            "plain_ms": b1_head["plain_ms"],
            "bound_ms": b1_head["bound_ms"],
            "bound_by": b1_head["bound_by"],
            "library_ms": None,
            "world": "preempt_mix_50k_1k",
            "k": b1_head["k"],
            "ms_per_iteration": b1_head["ms_per_iteration"],
            "latency_bound_ms": b1_head["latency_bound_ms"],
            "floor_ms_per_iteration": floor_ms_per_iter,
            "ms_preempt_mix_50k_5k": b1_5k["ms"],
            "ms_per_iteration_preempt_mix_50k_5k": b1_5k["ms_per_iteration"],
            "latency_bound_ms_preempt_mix_50k_5k": b1_5k["latency_bound_ms"],
            "k_preempt_mix_50k_5k": b1_5k["k"],
        },
        {
            "name": "block_step",
            "route": "cuda",
            "source": "kube_batch_tpu_torch/csrc/block_step.cu",
            "replaces": "kube_batch_tpu/ops/pallas_solve.py:914",
            "launches": sum(b2_by_path.values()),
            "launches_by_path": b2_by_path,
            "max_abs_err": max(r["max_abs_err"] for r in b2),
            "ms": b2_head["ms"],
            "plain_ms": b2_head["plain_ms"],
            "bound_ms": b2_head["bound_ms"],
            "bound_by": b2_head["bound_by"],
            "library_ms": None,
            "world": "preempt_mix_50k_5k, one 5,120-node block, entry state",
            "k": b2_head["k"],
            "device_ms": b2_head["device_ms"],
            "widths": [
                {key: r[key] for key in ("N", "k", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "bytes")}
                for _, r in sorted(b2_timed.items(), reverse=True)
            ],
        },
    ]})
    emit({"phase": "total", "s": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}})  # the one card driven
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
