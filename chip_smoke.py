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
7. prints one JSON line per phase, the ``{"kernels": [...]}`` line, and as
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
CARD_TESTS = ["tests/test_torch_kernel.py", "tests/test_torch_block_step.py"]


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

    for rec in b2_timed.values():  # B2's device time, with the profiler, last
        time_b2_kernel(rec)
        emit({"phase": "block_step_timed", **rec})

    emit({"kernels": [
        {
            "name": "fused_solve",
            "route": "cuda",
            "source": "kube_batch_tpu_torch/csrc/fused_solve.cu",
            "replaces": "kube_batch_tpu/ops/pallas_solve.py:442",
            "launches": b1_launches,
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
            "launches": b2_launches,
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
