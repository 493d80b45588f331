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
8. drives the whole pipeline, ``Scheduler(FakeCache(world),
   "examples/scheduler-conf-torch-pipeline.yaml").run_once()`` (enqueue,
   torch_reclaim, torch_allocate, torch_backfill, torch_preempt with
   tensorscore), the counters zeroed just before each cycle and read just
   after; each phase prints ``run_once``'s wall clock, the per-action
   split (``<action>_s``, and each scan action's float64 encode and
   walk), binds, evicts by reason, ``check_binds``' verdict on the
   allocate step, and the launches, and fails without a B1 launch:
   - ``pipeline_fused_50k_5k``: ``preempt_mix(50_000, 5_000)``, one B1
     launch, binds equal to ``allocate``'s (and so ``scheduler_fused``'s);
   - ``pipeline_fused_50k_1k``: ``preempt_mix(50_000, 1_000)``: starved
     gangs remain, torch_preempt evicts priority-1 residents (about two
     minutes of host work), binds equal to ``allocate``'s;
   - ``pipeline_reclaim``: ``reclaim_world(38_500, 1_000)`` (cut from
     50,000 pods, ``reduced`` in its record), config 4 with its residents
     in running gang jobs of an over-served second queue; torch_reclaim
     evicts;
   - ``pipeline_parity``: the twin conf against the serial scans around
     the same device allocate (``enqueue, reclaim, torch_allocate,
     backfill, preempt`` with nodeorder), both with ``min_device_pairs:
     0``, on seeds 0-11 of ``gen_contended_cluster`` and
     ``gen_contended_reclaim_cluster`` and on ``preempt_mix(2000, 40,
     seed=1)``: equal task states, binds and evict lists, more than 10
     binds and 10 evicts over the sweep;
   a failed pipeline phase does not stop the others either;
9. drives the host fast paths (the native hot loops, built with g++ as
   ``native_build`` beside the kernels' nvcc build, which fails the run if
   they cannot be built or loaded, and the cross-cycle encode cache):
   - ``encode_cache_100k_10k``: one session over ``preempt_mix(100_000,
     10_000)``, at float32 and float64: a cold encode, a warm one, one
     after replacing 1% of the Node objects, one after replacing 1% of the
     pending pods (through the dirty feed), and a cold one again; every
     warm encode byte-identical to a cold encode of the same world;
   - ``warm_cycles_50k_5k``: the twin pipeline's ``Scheduler`` over
     ``preempt_mix(50_000, 5_000)``, three ``run_once`` (cold; nothing
     changed; 1% of the Node objects replaced and one new gang), the
     counters zeroed just before each cycle and read just after, against
     a second scheduler on a twin cache with the cache and the native
     loops off: equal task states, binds and evicts cycle for cycle; each
     cycle's encodes, warm fractions, ``pack_s``, ``replay_s`` and native
     call counts;
   - ``native_parity``: ``scheduler_fused`` and ``pipeline_parity``'s 25
     worlds with the native loops on and off (equal), and B1 on two worlds
     packed with native class numbering and with ``np.unique``'s, each
     bit-equal to its plain version, equal states and binds;
   any native fallback or fired fault point fails the run;
10. drives the solver ladder under injected faults and the cycle under
   trace (the twin pipeline's ``Scheduler`` throughout):
   - ``ladder_drills``: on ``preempt_mix(2000, 40, seed=1)``, each drill
     under a fresh solver ladder (threshold 3), the process ladder
     restored after: (a) ``solve.fused`` once, a serial cycle
     (``solve_failed``); (b) three such cycles open the ``fused`` breaker,
     the next cycle runs serially (``breaker_open``) with no launch, and
     after the backoff the probe cycle launches B1 once and closes it
     (closed -> open -> half_open -> closed); (c) ``mesh: cuda:4`` with
     ``solve.sharded`` once, B2 launches and the fused rung resumes in the
     same cycle with one B1 launch; (d) ``solve.nan``, serial
     (``nonfinite``) with no launch; (e) ``cycle.overrun``, an aborted
     cycle with no bind and PodGroup phases as before, then a cycle that
     binds; (f) a soft deadline of 1 us for three cycles: on ``mesh:
     cuda:4`` it trips the ``sharded`` tier and the next cycle solves on
     the fused rung; on the fused rung the overruns are counted and the
     cycles stay on the card (the rung below is the CPU); (g) ``python -m
     kube_batch_tpu_torch.faults.smoke`` on the card passes its five
     drills; every cycle's binds and task states equal an undisturbed
     fused cycle's;
   - ``overrun_50k_5k``: (e) at ``preempt_mix(50_000, 5_000)``, the second
     cycle's binds equal ``allocate``'s;
   - ``traced_cycles_50k_5k``: warm_cycles_50k_5k's three cycles with
     ``trace: "on"`` against the same cycles with tracing off (equal binds,
     evicts and task states): ``check_tree``, the span tree per cycle,
     each span beside its ``last_timings`` entry, the Chrome trace written
     to ``chiprun_out/traced_cycles_50k_5k.trace.json``, and the
     exposition after the traced cycles (``schedule_attempts`` up by 3,
     ``breaker_state{tier="fused"}`` 0, no degraded cycle, five action
     latencies per cycle), then the warm cycle traced and untraced in
     alternation (``KBT_TRACE`` flipped), with the cyclic collector on
     and held off during the cycle, their medians and spreads;
   every phase outside the drills fails on any degraded cycle, breaker
   transition, fired fault point or native fallback during it;
11. prints one JSON line per phase, the ``{"kernels": [...]}`` line, and as
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

    python3 chip_smoke.py --pipeline-uncut

runs only ``pipeline_reclaim`` on the card at 50,000 pods: the uncut
reclaim pass and the preempt walk after it, minutes of host work.

    python3 chip_smoke.py --ab-warm DIR

runs instead ``warm_cycles_50k_5k`` of the checkout at DIR (the parent
commit, unpacked with ``git archive``) and of this one, in the order DIR,
this, this, DIR, each in a process of its own.

    python3 chip_smoke.py --rehearse CUT

needs no card: the pipeline phases (step 8), the fast paths' (step 9)
and the ladder's and the trace's (step 10) on the CPU, every world's pod
and node counts divided by CUT (the drills' small world is not cut),
torch_allocate on the kernels' plain versions; the host actions' times
predict the card run's.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
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
# pending pods of pipeline_reclaim's reclaim_world on 1,000 nodes, cut from
# 50,000 so that torch_preempt's walk over the starved tasks (each against
# every node; about two minutes in pipeline_fused_50k_1k) is not run twice;
# ``--pipeline-uncut`` runs it at 50,000
RECLAIM_PODS = 38_500


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


def conf_file(mesh: str | None = None, actions: str | None = None, base: str = "scheduler-conf-torch.yaml",
              trace: str | None = None, **args) -> str:
    """examples/<base> (the cycle's conf by default), with ``actions`` in
    place of its pipeline, its ``trace:`` key, and ``mesh`` and
    torch_allocate's other ``args`` set when given (written beside the
    kernels' build, inside the checkout)."""
    import re
    import zlib

    from kube_batch_tpu_torch.ops import nvcc

    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(root, "examples", base)
    if mesh is not None:
        args = {"mesh": mesh, **args}
    if actions is None and trace is None and not args:
        return path
    with open(path) as f:
        text = f.read()
    if trace is not None:
        text = f'trace: "{trace}"\n' + text
    if actions is not None:
        text = re.sub(r'^actions: ".*"$', f'actions: "{actions}"', text, count=1, flags=re.M)
    if args:
        text += "actionArguments:\n  torch_allocate:\n" + "".join(f"    {k}: {v}\n" for k, v in args.items())
    os.makedirs(nvcc.BUILD_DIR, exist_ok=True)
    out = os.path.join(nvcc.BUILD_DIR, f"{base[:-5]}-{zlib.crc32(text.encode()):08x}.yaml")
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
        run_phase(failures, name, fn)

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


PIPELINE_CONF = "scheduler-conf-torch-pipeline.yaml"
# the serial-action pipeline pipeline_parity holds the twin conf against:
# the serial scans around the same device allocate, with nodeorder
SERIAL_SCANS_ACTIONS = "enqueue, reclaim, torch_allocate, backfill, preempt"
PARITY_SEEDS = 12


def reclaim_world(n_pods: int, n_nodes: int, seed: int = 0):
    """``preempt_mix(n_pods, n_nodes)`` with its residents moved into
    running gang jobs of a second queue, ``batch``, which holds more than
    its deserved share: the residents keep their shapes and nodes (one
    4-cpu, 8 GiB pod on every other node, none terminating), four to a
    gang of minimum one; ``batch`` has weight 1 against ``default``'s 9,
    so its deserved share is a tenth of the cluster while both queues ask
    for more. The pending work stays in ``default``: each of its jobs
    reclaims one resident for its first pending task (the first tier's
    gang and conformance plugins pass every resident, so, as in the
    reference's tiered Reclaimable, proportion's share is not consulted)."""
    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch.apis.types import PodPhase
    from kube_batch_tpu_torch.testing import (
        build_cluster,
        build_pod,
        build_pod_group,
        build_queue,
        build_resource_list,
    )

    cluster = models.preempt_mix(n_pods, n_nodes, seed=seed)
    pods = [t.pod for job in cluster.jobs.values() for t in job.tasks.values() if not t.pod.node_name]
    pgs = [job.pod_group for job in cluster.jobs.values() if job.name.startswith("job-")]
    default, batch = build_queue("default", weight=9), build_queue("batch", weight=1)
    batch.metadata.creation_timestamp = default.metadata.creation_timestamp + 1.0
    nodes = [n.node for n in cluster.nodes.values()]
    for k, i in enumerate(range(0, n_nodes, 2)):
        gang = f"batch-{k // 4:05d}"
        if k % 4 == 0:
            pgs.append(build_pod_group(gang, queue="batch", min_member=1))
        pods.append(build_pod(
            name=f"resident-{i:05d}", group_name=gang, node_name=f"node-{i:05d}", phase=PodPhase.RUNNING,
            req=build_resource_list(cpu=4, memory="8192Mi"), priority=1,
        ))
    return build_cluster(pods, nodes, pgs, [default, batch])


def pipeline_cycle(phase: str, cluster, conf: str, device: str) -> tuple[dict, object, object]:
    """One ``run_once`` over ``FakeCache(cluster)`` with ``conf``, the
    launch counters zeroed just before and read just after; evictions
    counted by reason (``reclaim``, ``preempt``); every task's status and
    node read just before the session closes. Returns the phase record,
    the cache and the final task states."""
    import collections
    from types import SimpleNamespace

    import torch

    import kube_batch_tpu_torch.scheduler as sched_mod
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.testing import FakeCache

    cache = FakeCache(cluster)
    reasons = collections.Counter()
    cache_evict = cache.evict

    def evict(task, reason):
        reasons[reason] += 1
        cache_evict(task, reason)

    cache.evict = evict
    states = {}
    close = sched_mod.close_session

    def close_reading_states(ssn, discard=False):
        states.update({t.uid: (t.status.name, t.node_name) for j in ssn.jobs.values() for t in j.tasks.values()})
        close(ssn, discard=discard)

    sched = sched_mod.Scheduler(cache, conf)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    sched_mod.close_session = close_reading_states
    fs.fused_solve.launches = bs.block_step.launches = 0
    try:
        with GcClock() as gc_clock:
            t0 = time.perf_counter()
            sched.run_once()
            sync()
            wall_s = time.perf_counter() - t0
    finally:
        sched_mod.close_session = close
    b1, b2 = fs.fused_solve.launches, bs.block_step.launches
    if "aborted" in sched.last_timings:
        raise AssertionError(f"{phase}: the cycle aborted: {sched.last_timings['aborted']}")
    acts = {a.name: a for a in sched.actions}
    alloc = acts["torch_allocate"]
    binds = dict(cache.binder.binds)
    rec = {
        "phase": phase, "run_once_s": wall_s, "cycle": dict(sched.last_timings),
        "actions": {name: dict(a.last_timings) for name, a in acts.items() if getattr(a, "last_timings", None)},
        "tier": alloc.last_solver_tier, "b1_launches": b1, "b2_launches": b2, "binds": len(binds),
        "evicts": len(cache.evictor.evicts), "evicts_by_reason": dict(reasons), **gc_clock.record(),
    }
    if alloc.last_encoded is not None:
        rows = {f"{t.namespace}/{t.name}" for t in alloc.last_encoded.tasks}
        rec["check_binds"] = check_binds(SimpleNamespace(
            encoded=alloc.last_encoded, state=alloc.last_state, binds={k: v for k, v in binds.items() if k in rows}))
    return rec, cache, states


def pipeline_phases(clusters: dict, results: dict, device: str = "cuda", cut: int = 1,
                    reclaim_pods: int = RECLAIM_PODS, only: tuple = ()) -> tuple[list[str], dict]:
    """The twin pipeline's phases (module docstring, step 8): the whole
    pipeline of examples/scheduler-conf-torch-pipeline.yaml through
    ``Scheduler.run_once``. ``device: cpu`` with ``cut`` > 1 is the CPU
    rehearsal (``--rehearse``): the worlds' pod and node counts divided by
    ``cut``, the kernels' plain versions, no launches to count.
    ``reclaim_pods`` is reclaim_world's pod count, ``only`` a subset of
    the phases to run. Returns the failures and the launches of each
    phase's main path."""
    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch import testing as tt

    failures, launches = [], {}
    on_card = device == "cuda"
    twin = conf_file(base=PIPELINE_CONF, **({} if on_card else {"device": "cpu"}))

    def run(name, fn):
        run_phase(failures, name, fn)

    def world(name, nodes, pods=50_000, make=models.preempt_mix):
        """A config-4 world of ``nodes`` nodes with ``pods`` of its 50,000
        pods, divided by ``cut``, and what was cut (``reduced``, empty
        when nothing was); an uncut main world is reused."""
        p, n = pods // cut, nodes // cut
        reduced = {key: [full, got] for key, full, got in (("pods", 50_000, p), ("nodes", nodes, n)) if full != got}
        if not reduced and name in clusters:
            return clusters[name], reduced
        return make(p, n), reduced

    def launched(rec, want_b1=None):
        launches[rec["phase"]] = (rec["b1_launches"], rec["b2_launches"])
        if not on_card:
            return
        if rec["b1_launches"] < 1 or rec["b2_launches"]:
            raise AssertionError(f"{rec['b1_launches']} B1 and {rec['b2_launches']} B2 launches on the fused rung")
        if want_b1 is not None and rec["b1_launches"] != want_b1:
            raise AssertionError(f"{rec['b1_launches']} B1 launches; expected {want_b1}")

    def fused(name, nodes, want_b1=None):
        """The twin pipeline on a preempt_mix main world: uncut, its binds
        must equal allocate()'s (single queue: reclaim has no victims and
        preempt only pipelines, so the allocate step decides the binds)."""
        cluster, reduced = world(name, nodes)
        rec, cache, _ = pipeline_cycle(f"pipeline_fused_50k_{nodes // 1000}k", cluster, twin, device)
        launched(rec, want_b1)
        if rec["tier"] != "fused":
            raise AssertionError(f"torch_allocate solved on the {rec['tier']!r} rung")
        if not reduced and cache.binder.binds != results[name].binds:
            raise AssertionError("the pipeline's binds differ from allocate()'s (and the scheduler phase's)")
        return {**rec, "reduced": reduced, **({} if reduced else {"equal_to_allocate": True})}

    def fused_5k():
        emit(fused("preempt_mix_50k_5k", 5_000, want_b1=1))

    def fused_1k():
        rec = fused("preempt_mix_50k_1k", 1_000)
        if rec["evicts_by_reason"].get("preempt", 0) < 1:
            raise AssertionError("torch_preempt evicted nothing")
        emit(rec)

    def reclaim():
        cluster, reduced = world("reclaim_world_50k_1k", 1_000, reclaim_pods, make=reclaim_world)
        rec, cache, _ = pipeline_cycle("pipeline_reclaim", cluster, twin, device)
        launched(rec)
        if rec["evicts_by_reason"].get("reclaim", 0) < 1:
            raise AssertionError("torch_reclaim evicted nothing")
        emit({**rec, "reduced": reduced})

    def parity():
        serial = conf_file(actions=SERIAL_SCANS_ACTIONS, min_device_pairs=0, **({} if on_card else {"device": "cpu"}))
        twin0 = conf_file(base=PIPELINE_CONF, min_device_pairs=0, **({} if on_card else {"device": "cpu"}))
        worlds = [(f"{gen}_{seed}", lambda gen=gen, seed=seed: getattr(tt, gen)(seed))
                  for gen in ("gen_contended_cluster", "gen_contended_reclaim_cluster") for seed in range(PARITY_SEEDS)]
        worlds.append(("preempt_mix_2000_40_seed1", lambda: models.preempt_mix(2000, 40, seed=1)))
        binds = evicts = b1 = b2 = 0
        t0 = time.perf_counter()
        per_world = {}
        for name, make in worlds:
            want, want_cache, want_states = pipeline_cycle("serial_scans", make(), serial, device)
            got, got_cache, got_states = pipeline_cycle("twin", make(), twin0, device)
            if (got_states, got_cache.binder.binds, got_cache.evictor.evicts) != (
                    want_states, want_cache.binder.binds, want_cache.evictor.evicts):
                raise AssertionError(f"{name}: the twin conf's task states, binds or evicts differ from the serial scans'")
            binds += got["binds"]
            evicts += got["evicts"]
            b1 += got["b1_launches"] + want["b1_launches"]
            b2 += got["b2_launches"] + want["b2_launches"]
            per_world[name] = {"binds": got["binds"], "evicts": got["evicts"],
                               "twin_s": got["run_once_s"], "serial_scans_s": want["run_once_s"]}
        launches["pipeline_parity"] = (b1, b2)
        if on_card and (b1 < 1 or b2):
            raise AssertionError(f"{b1} B1 and {b2} B2 launches over the sweep")
        if per_world["preempt_mix_2000_40_seed1"]["evicts"] < 1:
            raise AssertionError("preempt_mix(2000, 40, seed=1) evicted nothing")
        if binds <= 10 or evicts <= 10:
            raise AssertionError(f"sweep too tame: {binds} binds, {evicts} evicts")
        emit({"phase": "pipeline_parity", "worlds": len(worlds), "binds": binds, "evicts": evicts,
              "b1_launches": b1, "b2_launches": b2, "s": time.perf_counter() - t0, "equal": True,
              "per_world": per_world})

    for name, fn in (("pipeline_fused_50k_5k", fused_5k), ("pipeline_fused_50k_1k", fused_1k),
                     ("pipeline_reclaim", reclaim), ("pipeline_parity", parity)):
        if not only or name in only:
            run(name, fn)
    return failures, launches


# -- the host fast paths: native hot loops and the encode cache ---------------

# encode_cache_100k_10k's world (the JAX package's own measurement of the
# layer) and warm_cycles_50k_5k's; the share of nodes and of pending pods
# replaced between encodes or cycles
CACHE_WORLD = (100_000, 10_000)
CYCLES_WORLD = (50_000, 5_000)
CHURN = 0.01


class GcClock:
    """Wall time the interpreter's cyclic collector spent, by generation,
    while installed (``gc.callbacks``): what a cycle's host layers lose to
    collections of the objects the snapshot and the replay allocate."""

    def __init__(self) -> None:
        self.s = [0.0, 0.0, 0.0]
        self.n = [0, 0, 0]
        self._t0 = 0.0

    def _cb(self, phase, info) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            g = info["generation"]
            self.s[g] += time.perf_counter() - self._t0
            self.n[g] += 1

    def __enter__(self) -> "GcClock":
        import gc

        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc) -> None:
        import gc

        gc.callbacks.remove(self._cb)

    def record(self) -> dict:
        return {"gc_s": sum(self.s), "gc_s_by_generation": self.s, "gc_collections": self.n}


def native_build() -> dict:
    """Build and load the port's native hot loops (native/build.py: g++
    against this interpreter's headers, into the package's _build
    directory). Raises when either fails: the run never carries on with
    the Python loops on the quiet."""
    from kube_batch_tpu_torch import native
    from kube_batch_tpu_torch.native import build

    t0 = time.perf_counter()
    path = build.ensure()
    build_s = time.perf_counter() - t0
    lib = native.load()
    return {"phase": "native_build", "s": build_s, "compiler": build.compiler_version(),
            "artifact": os.path.relpath(path, os.path.dirname(os.path.abspath(__file__))),
            "functions": sorted(n for n in dir(lib) if not n.startswith("_"))}


def relabel(node_info, key: str) -> None:
    """Replace the Node object under a NodeInfo by a relabelled copy (the
    watch-event shape)."""
    import dataclasses

    n = node_info.node
    labels = {**n.metadata.labels, key: "1"}
    node_info.set_node(dataclasses.replace(n, metadata=dataclasses.replace(n.metadata, labels=labels)))


def tolerate(task, key: str) -> None:
    """Replace a task's Pod object by a copy with one more toleration."""
    import dataclasses

    from kube_batch_tpu_torch.apis.types import Toleration

    task.pod = dataclasses.replace(
        task.pod, tolerations=[*task.pod.tolerations, Toleration(key=key, operator="Exists", effect="NoSchedule")])


def same_arrays(name: str, a, b) -> None:
    """Every array of two encodes byte-identical, and the same rows."""
    import numpy as np

    if set(a.arrays) != set(b.arrays) or [t.uid for t in a.tasks] != [t.uid for t in b.tasks]:
        raise AssertionError(f"{name}: the encodes' array sets or rows differ")
    for k, x in a.arrays.items():
        x, y = np.asarray(x), np.asarray(b.arrays[k])
        if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
            raise AssertionError(f"{name}: arrays[{k!r}] differs from the cold encode's")


def encode_cache_phase(cut: int = 1) -> dict:
    """``encode_cache_100k_10k``: one session over ``preempt_mix(100_000,
    10_000)`` (pods and nodes divided by ``cut``), at float32 and float64:
    a cold encode, a warm one (nothing changed), one after replacing the
    Node object under 1% of nodes, one after replacing the Pod object of
    1% of pending tasks (reported through the dirty feed), and a cold one
    again. Every warm encode must be byte-identical to a cold encode of
    the same world."""
    import numpy as np

    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch import plugins  # noqa: F401  (registers the plugins)
    from kube_batch_tpu_torch.conf import parse_scheduler_conf
    from kube_batch_tpu_torch.framework import close_session, open_session
    from kube_batch_tpu_torch.ops import encode_cache
    from kube_batch_tpu_torch.ops.encode import encode_session
    from kube_batch_tpu_torch.testing import FakeCache

    pods, nodes = CACHE_WORLD[0] // cut, CACHE_WORLD[1] // cut
    t0 = time.perf_counter()
    cache = FakeCache(models.preempt_mix(pods, nodes))
    with open(conf_file(base=PIPELINE_CONF)) as f:
        ssn = open_session(cache, parse_scheduler_conf(f.read()).tiers)
    setup_s = time.perf_counter() - t0
    ec = encode_cache.get()

    def encode(dtype):
        t = time.perf_counter()
        enc = encode_session(ssn.jobs, ssn.nodes, ssn.queues, drf=ssn.plugins.get("drf"),
                             proportion=ssn.plugins.get("proportion"), dtype=dtype, session=ssn)
        return time.perf_counter() - t, enc

    rec = {"phase": "encode_cache_100k_10k", "pods": pods, "nodes": nodes, "setup_s": setup_s}
    if cut > 1:
        rec["reduced"] = {"pods": [CACHE_WORLD[0], pods], "nodes": [CACHE_WORLD[1], nodes]}
    for name, dtype in (("f32", np.float32), ("f64", np.float64)):
        ec.invalidate_all("chip_smoke")
        cold_s, cold = encode(dtype)
        warm_s, warm = encode(dtype)
        same_arrays(f"{name} warm", cold, warm)
        warm_fraction = warm.warm_fraction
        for node_name in sorted(ssn.nodes)[: max(int(nodes * CHURN), 1)]:
            relabel(ssn.nodes[node_name], f"churn-{name}")
        node_churn_s, node_churn = encode(dtype)
        node_churn_fraction = node_churn.warm_fraction
        ec.invalidate_all("chip_smoke")
        cold_nodes_s, cold_nodes = encode(dtype)
        same_arrays(f"{name} node churn", cold_nodes, node_churn)
        churned = cold_nodes.tasks[:: max(int(1 / CHURN), 1)]
        for task in churned:
            tolerate(task, f"churn-{name}")
            encode_cache.note_store_event("pods", task.uid, task.pod)
        pod_churn_s, pod_churn = encode(dtype)
        pod_churn_fraction = pod_churn.warm_fraction
        ec.invalidate_all("chip_smoke")
        cold_again_s, cold_again = encode(dtype)
        same_arrays(f"{name} pod churn", cold_again, pod_churn)
        if warm_fraction <= 0.5:
            raise AssertionError(f"{name}: the warm encode served only {warm_fraction:.2%} of its units warm")
        rec[name] = {
            "cold_s": cold_s, "warm_s": warm_s, "node_churn_s": node_churn_s, "cold_after_node_churn_s": cold_nodes_s,
            "pod_churn_s": pod_churn_s, "cold_again_s": cold_again_s, "warm_fraction": warm_fraction,
            "node_churn_warm_fraction": node_churn_fraction, "pod_churn_warm_fraction": pod_churn_fraction,
            "churned_nodes": max(int(nodes * CHURN), 1), "churned_pods": len(churned), "tasks": cold.n_tasks,
            "byte_identical": True,
        }
    close_session(ssn)
    return rec


def add_gang(cluster, name: str, size: int) -> None:
    """A new pending gang job of ``size`` pods (1 cpu, 1 GiB each) in the
    first queue."""
    from kube_batch_tpu_torch.testing import build_cluster, build_pod, build_pod_group, build_resource_list

    queue = sorted(cluster.queues.values(), key=lambda q: q.name)[0]
    gang = build_cluster(
        [build_pod(name=f"{name}-{i}", group_name=name, req=build_resource_list(cpu=1, memory="1Gi"))
         for i in range(size)],
        [], [build_pod_group(name, queue=queue.name, min_member=size)], [queue.queue],
    )
    cluster.jobs.update(gang.jobs)


def warm_cycles_phase(device: str = "cuda", cut: int = 1) -> tuple[dict, tuple[int, int]]:
    """``warm_cycles_50k_5k``: one Scheduler over the twin pipeline conf on
    ``FakeCache(preempt_mix(50_000, 5_000))`` (divided by ``cut``), three
    ``run_once``: cycle 1 cold, cycle 2 with nothing changed, and before
    cycle 3 the Node object under 1% of nodes replaced and one new gang
    job added. A second scheduler over a twin cache runs the same cycles
    with the encode cache and the native loops off; binds, evicts and task
    states must be equal cycle for cycle. The launch counters are zeroed
    just before each cycle of the fast scheduler and read just after.
    Returns the record and the B1 and B2 launches of those cycles."""
    import torch

    import kube_batch_tpu_torch.scheduler as sched_mod
    from kube_batch_tpu_torch import metrics, models, native
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import encode_cache
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.testing import FakeCache

    on_card = device == "cuda"
    conf = conf_file(base=PIPELINE_CONF, **({} if on_card else {"device": "cpu"}))
    pods, nodes = CYCLES_WORLD[0] // cut, CYCLES_WORLD[1] // cut
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def arm(fast: bool):
        cache = FakeCache(models.preempt_mix(pods, nodes))
        return {"fast": fast, "cache": cache, "sched": sched_mod.Scheduler(cache, conf), "cycles": []}

    arms = [arm(True), arm(False)]
    close = sched_mod.close_session
    b1 = b2 = 0
    for cycle in range(3):
        if cycle == 2:
            for a in arms:
                for node_name in sorted(a["cache"].cluster.nodes)[: max(int(nodes * CHURN), 1)]:
                    relabel(a["cache"].cluster.nodes[node_name], "churn")
                add_gang(a["cache"].cluster, "warm-cycles-new-gang", 8)
        for a in arms:
            native.set_enabled(a["fast"])
            encode_cache.set_enabled(a["fast"])
            if a["fast"] and cycle == 0:
                encode_cache.get().invalidate_all("chip_smoke")
            states = {}

            def close_reading_states(ssn, discard=False):
                states.update({t.uid: (t.status.name, t.node_name) for j in ssn.jobs.values()
                               for t in j.tasks.values()})
                close(ssn, discard=discard)

            native.reset_counts()
            faults_before = sum(metrics.fault_injections.samples().values())
            sync()
            sched_mod.close_session = close_reading_states
            fs.fused_solve.launches = bs.block_step.launches = 0
            try:
                with GcClock() as gc_clock:
                    t0 = time.perf_counter()
                    a["sched"].run_once()
                    sync()
                    wall_s = time.perf_counter() - t0
            finally:
                sched_mod.close_session = close
            launches = (fs.fused_solve.launches, bs.block_step.launches)
            if "aborted" in a["sched"].last_timings:
                raise AssertionError(f"cycle {cycle + 1}: the cycle aborted: {a['sched'].last_timings['aborted']}")
            acts = {x.name: x for x in a["sched"].actions}
            t = {name: dict(getattr(acts[name], "last_timings", {}))
                 for name in ("torch_reclaim", "torch_allocate", "torch_preempt")}
            rec = {
                "run_once_s": wall_s, "snapshot_s": a["sched"].last_timings.get("snapshot_s"),
                "encode_s": {name: t[name].get("encode_s") for name in t},
                "warm_fraction": {name: t[name].get("warm_fraction") for name in t},
                "pack_s": t["torch_allocate"].get("pack_s"), "solve_s": t["torch_allocate"].get("solve_s"),
                "fused_solve_s": t["torch_allocate"].get("fused_solve_s"),
                "replay_s": t["torch_allocate"].get("replay_s"),
                "actions_s": {k: v for k, v in a["sched"].last_timings.items() if k.endswith("_s")},
                "native_calls": dict(native.calls), "native_fallbacks": dict(native.fallbacks),
                "faults_fired": sum(metrics.fault_injections.samples().values()) - faults_before,
                "tier": acts["torch_allocate"].last_solver_tier, "b1_launches": launches[0],
                "b2_launches": launches[1], "binds": len(a["cache"].binder.binds),
                "evicts": len(a["cache"].evictor.evicts), **gc_clock.record(),
            }
            a["cycles"].append((rec, states, dict(a["cache"].binder.binds), list(a["cache"].evictor.evicts)))
            if a["fast"]:
                b1 += launches[0]
                b2 += launches[1]
                if on_card and (launches[0] < 1 or launches[1]):
                    raise AssertionError(f"cycle {cycle + 1}: {launches[0]} B1 and {launches[1]} B2 launches")
                if rec["native_fallbacks"] or rec["faults_fired"]:
                    raise AssertionError(f"cycle {cycle + 1}: native fallbacks {rec['native_fallbacks']}, "
                                         f"{rec['faults_fired']} faults fired")
                if not rec["native_calls"].get("bulk_assign"):
                    raise AssertionError(f"cycle {cycle + 1}: the replay did not run bulk_assign")
            elif rec["native_calls"]:
                raise AssertionError(f"cycle {cycle + 1}: native calls with the native loops off")
    native.set_enabled(True)
    encode_cache.set_enabled(True)
    fast, slow = arms
    for cycle, (f, s) in enumerate(zip(fast["cycles"], slow["cycles"])):
        if f[1:] != s[1:]:
            raise AssertionError(f"cycle {cycle + 1}: the fast paths' task states, binds or evicts differ")
    cycle2 = fast["cycles"][1][0]["warm_fraction"]
    if not any(v for v in cycle2.values()):
        raise AssertionError(f"cycle 2 ran every encode cold: {cycle2}")
    rec = {
        "phase": "warm_cycles_50k_5k", "pods": pods, "nodes": nodes, "churned_nodes": max(int(nodes * CHURN), 1),
        "new_gang": 8, "fast": [c[0] for c in fast["cycles"]], "off": [c[0] for c in slow["cycles"]],
        "equal_cycle_for_cycle": True, "b1_launches": b1, "b2_launches": b2,
        "binds_by_cycle": [len(c[2]) for c in fast["cycles"]],
    }
    if cut > 1:
        rec["reduced"] = {"pods": [CYCLES_WORLD[0], pods], "nodes": [CYCLES_WORLD[1], nodes]}
    return rec, (b1, b2)


def native_parity_phase(clusters: dict, results: dict, device: str = "cuda") -> dict:
    """``native_parity``: ``scheduler_fused`` at 50k x 5k and
    ``pipeline_parity``'s 25 worlds with the native loops on and off
    (equal binds, evicts and task states), and B1 on two worlds packed with
    native class numbering and with ``np.unique`` numbering: each
    bit-equal to its plain version, equal final states and binds."""
    import numpy as np

    from kube_batch_tpu_torch import models, native
    from kube_batch_tpu_torch import testing as tt
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.solve import dispatch, solver_arrays

    on_card = device == "cuda"
    rec = {"phase": "native_parity"}
    try:
        if on_card:
            got = []
            for flag in (True, False):
                native.set_enabled(flag)
                r, cache, _ = scheduler_cycle(f"scheduler_fused_native_{'on' if flag else 'off'}",
                                              clusters["preempt_mix_50k_5k"], None, "fused")
                got.append((dict(cache.binder.binds), r["run_once_s"], r["torch_allocate"].get("replay_s")))
            if got[0][0] != got[1][0] or got[0][0] != results["preempt_mix_50k_5k"].binds:
                raise AssertionError("scheduler_fused: the binds differ with the native loops off")
            rec["scheduler_fused"] = {"binds": len(got[0][0]), "run_once_s": [got[0][1], got[1][1]],
                                      "replay_s": [got[0][2], got[1][2]], "equal": True}
        twin0 = conf_file(base=PIPELINE_CONF, min_device_pairs=0, **({} if on_card else {"device": "cpu"}))
        worlds = [(f"{gen}_{seed}", lambda gen=gen, seed=seed: getattr(tt, gen)(seed))
                  for gen in ("gen_contended_cluster", "gen_contended_reclaim_cluster") for seed in range(PARITY_SEEDS)]
        worlds.append(("preempt_mix_2000_40_seed1", lambda: models.preempt_mix(2000, 40, seed=1)))
        binds = evicts = 0
        for name, make in worlds:
            outs = []
            for flag in (True, False):
                native.set_enabled(flag)
                _, cache, states = pipeline_cycle("twin", make(), twin0, device)
                outs.append((states, cache.binder.binds, cache.evictor.evicts))
            if outs[0] != outs[1]:
                raise AssertionError(f"{name}: the twin pipeline differs with the native loops off")
            binds += len(outs[0][1])
            evicts += len(outs[0][2])
        rec["pipeline_parity"] = {"worlds": len(worlds), "binds": binds, "evicts": evicts, "equal": True}
        numbering = {}
        for name, make in (("preempt_mix_2k_40_seed1", lambda: models.preempt_mix(2000, 40, seed=1)),
                           ("multi_tenant_ml_200_500", lambda: models.multi_tenant_ml(200, 500))):
            a = encoded_arrays(make())
            n = {k: np.asarray(v) for k, v in a.items()}
            per = {}
            for flag in (True, False):
                native.set_enabled(flag)
                _, first, _ = fs._class_inverse(n)
                if on_card:
                    cmp = kernel_vs_plain(f"{name}_native_{flag}", a)
                    per[flag] = (first, cmp["iterations"], cmp["assigned"], cmp["ms"])
                else:
                    per[flag] = (first, None, None, None)
            cluster = make()
            states = {}
            for flag in (True, False):
                native.set_enabled(flag)
                solver = fs.FusedSolver(a, True, True, device="cuda" if on_card else "cpu")
                states[flag] = solver.solve()
            same_state(f"{name}: native and np.unique class numbering", states[True], states[False])
            enc, _ = solver_arrays(cluster)
            if dispatch(enc, states[True]) != dispatch(enc, states[False]):
                raise AssertionError(f"{name}: the binds differ between the class numberings")
            numbering[name] = {"classes": int(per[True][0].shape[0]),
                               "orders_differ": bool(not np.array_equal(per[True][0], per[False][0])),
                               "iterations": per[True][1], "assigned": per[True][2],
                               "ms_native": per[True][3], "ms_np_unique": per[False][3],
                               "binds": len(dispatch(enc, states[True])[0]), "equal": True}
        rec["class_numbering"] = numbering
    finally:
        native.set_enabled(True)
    return rec


def fast_path_phases(clusters: dict, results: dict, device: str = "cuda", cut: int = 1,
                     only: tuple = ()) -> tuple[list[str], dict]:
    """The host fast paths' phases: ``encode_cache_100k_10k``,
    ``warm_cycles_50k_5k`` and ``native_parity`` (``native_build`` runs
    with the kernels' build). Each runs whatever the others did; returns
    the failures and the launches of the warm cycles' main path."""
    failures, launches = [], {}

    def run(name, fn):
        run_phase(failures, name, fn)

    def warm():
        rec, launches["warm_cycles_50k_5k"] = warm_cycles_phase(device, cut)
        emit(rec)

    for name, fn in (("encode_cache_100k_10k", lambda: emit(encode_cache_phase(cut))),
                     ("warm_cycles_50k_5k", warm),
                     ("native_parity", lambda: emit(native_parity_phase(clusters, results, device)))):
        if not only or name in only:
            run(name, fn)
    return failures, launches


def degradations() -> dict:
    """The process's counts of degradations so far: cycles the solver
    ladder ran below their rung, breaker transitions, fired fault points,
    abandoned native calls."""
    from kube_batch_tpu_torch import metrics, native

    return {
        "degraded_cycles": sum(metrics.degraded_cycles.samples().values()),
        "breaker_transitions": sum(metrics.breaker_transitions.samples().values()),
        "fault_injections": sum(metrics.fault_injections.samples().values()),
        "native_fallbacks": sum(native.fallbacks.values()),
    }


def run_phase(failures: list, name: str, fn, drill: bool = False) -> None:
    """Run one phase whatever the others did; a raise is a failure of the
    run, recorded in ``failures``. Outside the drills (which inject their
    faults and check their own degradations), a degradation during the
    phase is a failure too."""
    before = degradations()
    try:
        fn()
        grew = {k: v - before[k] for k, v in degradations().items() if v != before[k]}
        if grew and not drill:
            raise AssertionError(f"degraded with no fault injected: {grew}")
    except Exception as e:  # noqa: BLE001 - every phase runs; the script fails at the end
        failures.append(f"{name}: {type(e).__name__}: {e}")
        print(f"chip_smoke: {name} failed: {type(e).__name__}: {e}", file=sys.stderr, flush=True)


def degradation_failures() -> list[str]:
    """The run's degradations before the drills: any is a failure."""
    from kube_batch_tpu_torch import metrics, native

    bad = []
    if native.fallbacks:
        bad.append(f"native fallbacks: {dict(native.fallbacks)}")
    for name in ("fault_injections", "degraded_cycles", "breaker_transitions"):
        got = {str(dict(k)): v for k, v in getattr(metrics, name).samples().items() if v}
        if got:
            bad.append(f"{name}: {got}")
    return bad


# -- the solver ladder under faults, and the cycle under trace ----------------

DRILL_WORLD = (2000, 40, 1)  # preempt_mix(2000, 40, seed=1)
DRILL_RESET_S = 5.0  # the drills' breaker backoff, skipped on the drills' clock


class DrillClock:
    """The drill ladder's clock: the monotonic clock plus an offset that a
    drill advances past a backoff instead of sleeping through it."""

    def __init__(self) -> None:
        self.offset = 0.0

    def __call__(self) -> float:
        return time.monotonic() + self.offset


def pg_phases(cluster) -> dict:
    """Each PodGroup's phase and running, failed and succeeded counts."""
    return {uid: (j.pod_group.status.phase.value, j.pod_group.status.running, j.pod_group.status.failed,
                  j.pod_group.status.succeeded) for uid, j in cluster.jobs.items() if j.pod_group is not None}


def drill_cycle(sched, cluster, device: str) -> dict:
    """One ``sched.run_once()`` over a fresh ``FakeCache(cluster)``, the
    launch counters zeroed just before and read just after; every task's
    state read just before the session closes; the cycle's binds, evicts,
    torch_allocate's rung and serial reason, and its degradations."""
    import torch

    import kube_batch_tpu_torch.scheduler as sched_mod
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.testing import FakeCache

    sched.cache = FakeCache(cluster)
    states = {}
    close = sched_mod.close_session

    def close_reading_states(ssn, discard=False):
        states.update({t.uid: (t.status.name, t.node_name) for j in ssn.jobs.values() for t in j.tasks.values()})
        close(ssn, discard=discard)

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    before = degradations()
    sync()
    sched_mod.close_session = close_reading_states
    fs.fused_solve.launches = bs.block_step.launches = 0
    try:
        t0 = time.perf_counter()
        sched.run_once()
        sync()
        wall_s = time.perf_counter() - t0
    finally:
        sched_mod.close_session = close
    b1, b2 = fs.fused_solve.launches, bs.block_step.launches
    alloc = next(a for a in sched.actions if a.name == "torch_allocate")
    return {
        "run_once_s": wall_s, "tier": alloc.last_solver_tier, "reason": alloc.last_timings.get("serial_reason"),
        "aborted": sched.last_timings.get("aborted"), "b1_launches": b1, "b2_launches": b2,
        "degradations": {k: v - before[k] for k, v in degradations().items() if v != before[k]},
        "binds": dict(sched.cache.binder.binds), "evicts": list(sched.cache.evictor.evicts), "states": states,
    }


def ladder_drills(device: str = "cuda") -> tuple[dict, tuple[int, int]]:
    """``ladder_drills``: the twin pipeline's Scheduler over
    ``preempt_mix(2000, 40, seed=1)`` (``min_device_pairs: 0``), each drill
    under a fresh solver ladder (threshold 3, a backoff of DRILL_RESET_S on
    a clock the drill advances), the process ladder restored after. Every
    cycle's binds and task states equal an undisturbed fused cycle's on the
    same world:

    (a) ``solve.fused`` once: a serial cycle (``solve_failed``), B1 ran and
        its result was not used;
    (b) three failing cycles open the ``fused`` breaker; the next cycle is
        serial (``breaker_open``) with no launch; after the backoff the
        probe cycle launches B1 once and closes it: closed -> open ->
        half_open -> closed;
    (c) ``mesh: <device>:4`` with ``solve.sharded`` once: B2 launches, then
        the fused rung resumes in the same cycle with one B1 launch;
    (d) ``solve.nan``: serial (``nonfinite``), no launch;
    (e) ``cycle.overrun``: an aborted cycle with no bind and no evict,
        PodGroup phases as before; the next cycle binds what an
        undisturbed cycle binds;
    (f) a soft deadline of 1 us for three cycles: on ``mesh:
        <device>:4`` the ``sharded`` tier trips and the next cycle solves
        on the fused rung; on the fused rung the card's cycles are counted
        as soft overruns and stay on the card (the rung below is the CPU),
        while on the CPU (``--rehearse``) the ``fused`` tier trips and the
        next cycle is serial;
    (g) ``python -m kube_batch_tpu_torch.faults.smoke`` on the device, in
        a process of its own: its five drills pass.

    Returns the record and the B1 and B2 launches of its cycles."""
    from kube_batch_tpu_torch import faults, metrics, models
    from kube_batch_tpu_torch.scheduler import Scheduler

    on_card = device == "cuda"
    pods, nodes, seed = DRILL_WORLD
    conf = conf_file(base=PIPELINE_CONF, min_device_pairs=0, **({} if on_card else {"device": "cpu"}))
    mesh_conf = conf_file(base=PIPELINE_CONF, min_device_pairs=0, mesh=f"{device}:4",
                          **({} if on_card else {"device": "cpu"}))

    def world():
        return models.preempt_mix(pods, nodes, seed=seed)

    launches = [0, 0]
    cycles: dict[str, list] = {}
    process_ladder = faults.solver_ladder

    def cycle(drill, sched, expect_tier, expect_reason=None, b1=None, b2=0, cluster=None):
        rec = drill_cycle(sched, cluster if cluster is not None else world(), device)
        launches[0] += rec["b1_launches"]
        launches[1] += rec["b2_launches"]
        cycles.setdefault(drill, []).append({k: v for k, v in rec.items() if k not in ("binds", "evicts", "states")})
        if rec["aborted"] is None and (rec["tier"], rec["reason"]) != (expect_tier, expect_reason):
            raise AssertionError(f"({drill}): solved on {rec['tier']!r} ({rec['reason']}), expected "
                                 f"{expect_tier!r} ({expect_reason})")
        if on_card and b1 is not None and (rec["b1_launches"] != b1 or b2 is not None and rec["b2_launches"] != b2):
            raise AssertionError(f"({drill}): {rec['b1_launches']} B1 and {rec['b2_launches']} B2 launches, "
                                 f"expected {b1} and {b2}")
        if rec["degradations"].get("native_fallbacks"):
            raise AssertionError(f"({drill}): native fallbacks {rec['degradations']}")
        return rec

    def same_as_clean(drill, rec):
        if (rec["binds"], rec["evicts"], rec["states"]) != (clean["binds"], clean["evicts"], clean["states"]):
            raise AssertionError(f"({drill}): binds, evicts or task states differ from the undisturbed cycle's")

    def fresh(drill):
        faults.registry.reset()
        clock = DrillClock()
        ladder = faults.DegradationLadder(("sharded", "fused", "serial"), failure_threshold=3,
                                          reset_timeout=DRILL_RESET_S, clock=clock)
        history = []
        for b in ladder.breakers.values():
            real = b._transition

            def transition(to, b=b, real=real):
                history.append((b.name, b.state, to))
                real(to)

            b._transition = transition
        faults.set_solver_ladder(ladder)
        return ladder, clock, history

    rec = {"phase": "ladder_drills", "world": f"preempt_mix({pods}, {nodes}, seed={seed})",
           "breaker": {"failure_threshold": 3, "reset_timeout_s": DRILL_RESET_S}}
    try:
        fresh("clean")
        clean = cycle("clean", Scheduler(None, conf), "fused", b1=1)
        if not clean["binds"]:
            raise AssertionError("the undisturbed cycle bound nothing")

        ladder, _, history = fresh("a")
        faults.registry.arm("solve.fused", count=1)
        same_as_clean("a", cycle("a", Scheduler(None, conf), "serial", "solve_failed", b1=1))
        rec["a"] = {"history": history, "fused_failures": ladder.breakers["fused"].failures}
        if ladder.breakers["fused"].failures != 1 or history:
            raise AssertionError(f"(a): fused breaker {ladder.breakers['fused'].failures} failures, {history}")

        ladder, clock, history = fresh("b")
        faults.registry.arm("solve.fused", count=3)
        for _ in range(3):
            same_as_clean("b", cycle("b", Scheduler(None, conf), "serial", "solve_failed", b1=1))
        if ladder.state("fused") != "open":
            raise AssertionError(f"(b): three failures left the fused breaker {ladder.state('fused')}")
        same_as_clean("b", cycle("b", Scheduler(None, conf), "serial", "breaker_open", b1=0))
        clock.offset += DRILL_RESET_S
        same_as_clean("b", cycle("b", Scheduler(None, conf), "fused", b1=1))
        want = [("fused", "closed", "open"), ("fused", "open", "half_open"), ("fused", "half_open", "closed")]
        rec["b"] = {"history": history}
        if history != want:
            raise AssertionError(f"(b): breaker history {history}, expected {want}")

        ladder, _, history = fresh("c")
        faults.registry.arm("solve.sharded", count=1)
        got = cycle("c", Scheduler(None, mesh_conf), "fused", b1=1, b2=None)
        same_as_clean("c", got)
        if on_card and got["b2_launches"] < 1:
            raise AssertionError("(c): the sharded rung launched no block step before it failed")
        rec["c"] = {"history": history, "b2_launches": got["b2_launches"], "b1_launches": got["b1_launches"]}
        if ladder.breakers["sharded"].failures != 1 or history:
            raise AssertionError(f"(c): sharded breaker {ladder.breakers['sharded'].failures} failures, {history}")

        ladder, _, history = fresh("d")
        faults.registry.arm("solve.nan", count=1)
        same_as_clean("d", cycle("d", Scheduler(None, conf), "serial", "nonfinite: w_least", b1=0))
        rec["d"] = {"history": history}

        fresh("e")
        sched = Scheduler(None, conf)
        cluster = world()
        phases = pg_phases(cluster)
        faults.registry.arm("cycle.overrun", count=1)
        got = cycle("e", sched, None, cluster=cluster)
        if "dispatch barrier" not in (got["aborted"] or "") or got["binds"] or got["evicts"]:
            raise AssertionError(f"(e): the overrun did not abort before any bind: {got['aborted']}, "
                                 f"{len(got['binds'])} binds, {len(got['evicts'])} evicts")
        if pg_phases(cluster) != phases:
            raise AssertionError("(e): the aborted cycle changed PodGroup statuses")
        same_as_clean("e", cycle("e", sched, "fused", b1=1, cluster=cluster))
        rec["e"] = {"aborted": got["aborted"]}

        ladder, _, history = fresh("f")
        sched = Scheduler(None, mesh_conf, soft_deadline_s=1e-6)
        for _ in range(3):
            same_as_clean("f", cycle("f", sched, "sharded", b1=0, b2=None))
        if ladder.state("sharded") != "open":
            raise AssertionError(f"(f): three soft overruns left the sharded breaker {ladder.state('sharded')}")
        same_as_clean("f", cycle("f", sched, "fused", b1=1))
        rec["f"] = {"sharded_history": history}
        ladder, _, history = fresh("f")
        sched = Scheduler(None, conf, soft_deadline_s=1e-6)
        soft = {"kind": "soft"}
        overruns = metrics.cycle_overruns.value(soft)
        for _ in range(3):
            same_as_clean("f", cycle("f", sched, "fused", b1=1))
        if on_card:
            same_as_clean("f", cycle("f", sched, "fused", b1=1))
            if ladder.state("fused") != "closed" or history:
                raise AssertionError(f"(f): soft overruns on the card moved the fused breaker: {history}")
        else:
            if ladder.state("fused") != "open":
                raise AssertionError(f"(f): three soft overruns left the fused breaker {ladder.state('fused')}")
            same_as_clean("f", cycle("f", sched, "serial", "breaker_open", b1=0))
        rec["f"]["fused_history"] = history
        rec["f"]["fused_soft_overruns"] = metrics.cycle_overruns.value(soft) - overruns

        faults.registry.reset()
        faults.set_solver_ladder(process_ladder)
        smoke = subprocess.run([sys.executable, "-m", "kube_batch_tpu_torch.faults.smoke", "--device", device],
                               cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
                               timeout=300)
        rec["g"] = {"returncode": smoke.returncode,
                    "lines": [line for line in smoke.stdout.splitlines() if line.startswith("chaos smoke")]}
        if smoke.returncode != 0:
            raise AssertionError(f"(g): the fault smoke exited {smoke.returncode}: {smoke.stdout[-2000:]} "
                                 f"{smoke.stderr[-2000:]}")
    finally:
        faults.registry.reset()
        faults.set_solver_ladder(process_ladder)
    rec["cycles"] = cycles
    rec["binds"], rec["evicts"] = len(clean["binds"]), len(clean["evicts"])
    rec["b1_launches"], rec["b2_launches"] = launches
    return rec, tuple(launches)


def overrun_phase(clusters: dict, results: dict, device: str = "cuda", cut: int = 1) -> tuple[dict, tuple[int, int]]:
    """``overrun_50k_5k``: drill (e) at full width, the twin pipeline on
    ``preempt_mix(50_000, 5_000)``: ``cycle.overrun`` aborts the first
    cycle at the dispatch barrier, after B1 ran and the replay was done,
    and leaves the cache unchanged (no bind, no evict, PodGroup phases as
    before); the second cycle's binds equal ``allocate``'s. Two cycles."""
    from kube_batch_tpu_torch import faults, models
    from kube_batch_tpu_torch.scheduler import Scheduler

    on_card = device == "cuda"
    pods, nodes = CYCLES_WORLD[0] // cut, CYCLES_WORLD[1] // cut
    cluster = clusters.get("preempt_mix_50k_5k") if cut == 1 else None
    cluster = cluster if cluster is not None else models.preempt_mix(pods, nodes)
    sched = Scheduler(None, conf_file(base=PIPELINE_CONF, **({} if on_card else {"device": "cpu"})))
    phases = pg_phases(cluster)
    faults.registry.reset()
    faults.registry.arm("cycle.overrun", count=1)
    try:
        first = drill_cycle(sched, cluster, device)
    finally:
        faults.registry.reset()
    if "dispatch barrier" not in (first["aborted"] or "") or first["binds"] or first["evicts"]:
        raise AssertionError(f"the overrun did not abort before any bind: {first['aborted']}")
    if pg_phases(cluster) != phases:
        raise AssertionError("the aborted cycle changed PodGroup statuses")
    second = drill_cycle(sched, cluster, device)
    if second["aborted"] or second["tier"] != "fused":
        raise AssertionError(f"the second cycle: {second['aborted']}, on the {second['tier']!r} rung")
    if cut == 1 and second["binds"] != results["preempt_mix_50k_5k"].binds:
        raise AssertionError("the second cycle's binds differ from allocate()'s")
    if on_card and (first["b1_launches"], second["b1_launches"]) != (1, 1):
        raise AssertionError(f"{first['b1_launches']} and {second['b1_launches']} B1 launches; expected 1 and 1")
    rec = {"phase": "overrun_50k_5k", "pods": pods, "nodes": nodes,
           "aborted": first["aborted"], "aborted_run_once_s": first["run_once_s"],
           "next_run_once_s": second["run_once_s"], "binds": len(second["binds"]),
           "degradations": first["degradations"],
           "b1_launches": first["b1_launches"] + second["b1_launches"],
           "b2_launches": first["b2_launches"] + second["b2_launches"]}
    if cut > 1:
        rec["reduced"] = {"pods": [CYCLES_WORLD[0], pods], "nodes": [CYCLES_WORLD[1], nodes]}
    else:
        rec["equal_to_allocate"] = True
    return rec, (rec["b1_launches"], rec["b2_launches"])


def exposition_values(text: str) -> dict:
    """The exposition's samples, ``name{labels}`` -> value."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
    return out


TRACED_SPANS = ("cycle", "snapshot", "encode", "solve", "gang.assign", "commit")
SPAN_COST_SPANS = 10_000  # spans timed for the instrumentation's own cost
WARM_ROUNDS = 4  # rounds of traced, untraced, untraced, traced warm cycles


def traced_cycles_phase(device: str = "cuda", cut: int = 1) -> tuple[dict, tuple[int, int]]:
    """``traced_cycles_50k_5k``: warm_cycles_50k_5k's three cycles of the
    twin pipeline (cold; nothing changed; 1% of nodes replaced and a new
    gang) with ``trace: "on"`` in the conf, then the same three cycles over
    a twin world with tracing off; binds, evicts and task states equal
    cycle for cycle. Records ``check_tree`` (empty), each cycle's span tree
    (one ``cycle`` root; snapshot, encode, solve, gang.assign and commit
    under it), each span's duration beside its ``last_timings`` entry,
    ``run_once`` traced and untraced, the Chrome trace (written under
    chiprun_out/), and the exposition read after the traced cycles:
    ``schedule_attempts`` up by 3, ``breaker_state{tier="fused"}`` 0, no
    degraded cycle, five action latencies per cycle. Then the cost of
    tracing on the warm cycle: one scheduler over the untraced arm's world,
    nothing changed since its last cycle, runs WARM_ROUNDS rounds of
    traced, untraced, untraced, traced cycles (``KBT_TRACE`` flipped
    between them, the conf's ``trace:`` empty), after one warm-up cycle of
    each, once with the cyclic collector on and once with it held off
    during each cycle; the medians, spreads and each arm's median
    ``last_timings``."""
    import collections

    import torch

    import kube_batch_tpu_torch.scheduler as sched_mod
    from kube_batch_tpu_torch import metrics, models, obs
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import encode_cache
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.testing import FakeCache

    on_card = device == "cuda"
    root = os.path.dirname(os.path.abspath(__file__))
    extra = {} if on_card else {"device": "cpu"}
    pods, nodes = CYCLES_WORLD[0] // cut, CYCLES_WORLD[1] // cut
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    arms = {}
    launches = [0, 0]
    before_text = metrics.render_prometheus_text()
    after_text = ""
    for arm, trace in (("traced", "on"), ("untraced", "off")):
        conf = conf_file(base=PIPELINE_CONF, trace=trace, **extra)
        cache = FakeCache(models.preempt_mix(pods, nodes))
        sched = sched_mod.Scheduler(cache, conf)
        encode_cache.get().invalidate_all("chip_smoke")
        obs.recorder.clear()
        close = sched_mod.close_session
        out = []
        for cycle in range(3):
            if cycle == 2:
                for node_name in sorted(cache.cluster.nodes)[: max(int(nodes * CHURN), 1)]:
                    relabel(cache.cluster.nodes[node_name], "churn")
                add_gang(cache.cluster, "traced-cycles-new-gang", 8)
            cache.binder.binds.clear()
            del cache.evictor.evicts[:]
            states = {}

            def close_reading_states(ssn, discard=False):
                states.update({t.uid: (t.status.name, t.node_name) for j in ssn.jobs.values()
                               for t in j.tasks.values()})
                close(ssn, discard=discard)

            sync()
            sched_mod.close_session = close_reading_states
            fs.fused_solve.launches = bs.block_step.launches = 0
            try:
                with GcClock() as gc_clock:
                    t0 = time.perf_counter()
                    sched.run_once()
                    sync()
                    wall_s = time.perf_counter() - t0
            finally:
                sched_mod.close_session = close
            if "aborted" in sched.last_timings:
                raise AssertionError(f"{arm} cycle {cycle + 1} aborted: {sched.last_timings['aborted']}")
            alloc = next(a for a in sched.actions if a.name == "torch_allocate")
            launches[0] += fs.fused_solve.launches
            launches[1] += bs.block_step.launches
            if on_card and (fs.fused_solve.launches, bs.block_step.launches) != (1, 0):
                raise AssertionError(f"{arm} cycle {cycle + 1}: {fs.fused_solve.launches} B1 and "
                                     f"{bs.block_step.launches} B2 launches; expected 1 and 0")
            out.append({"run_once_s": wall_s, "gc_s": gc_clock.record()["gc_s"], "timings": dict(sched.last_timings),
                        "torch_allocate": dict(alloc.last_timings), "tier": alloc.last_solver_tier,
                        "binds": dict(cache.binder.binds), "evicts": list(cache.evictor.evicts),
                        "states": states})
        if arm == "traced":
            after_text = metrics.render_prometheus_text()
            spans = obs.recorder.spans()
        arms[arm] = out
    warm_sched = sched_mod.Scheduler(cache, conf_file(base=PIPELINE_CONF, trace="", **extra))
    warm = {mode: warm_trace_cost(warm_sched, cache, sync, launches, on_card, collector=mode == "collector_on")
            for mode in ("collector_on", "collector_off")}
    # the instrumentation's own cost: one span opened and closed, with an
    # attribute, into the flight recorder's ring
    obs.configure("on")
    obs.recorder.clear()
    t0 = time.perf_counter()
    for _ in range(SPAN_COST_SPANS):
        with obs.span("commit", jobs=1):
            pass
    span_cost_s = (time.perf_counter() - t0) / SPAN_COST_SPANS
    obs.configure()
    obs.recorder.clear()
    for cycle, (t, u) in enumerate(zip(arms["traced"], arms["untraced"])):
        if (t["binds"], t["evicts"], t["states"]) != (u["binds"], u["evicts"], u["states"]):
            raise AssertionError(f"cycle {cycle + 1}: binds, evicts or task states differ with tracing on and off")

    violations = obs.check_tree(spans)
    if violations:
        raise AssertionError(f"the span tree is broken: {violations[:5]}")
    by_trace = collections.defaultdict(list)
    for s in spans:
        by_trace[s["trace_id"]].append(s)
    traces = sorted(by_trace.values(), key=lambda ss: min(s["start_us"] for s in ss))
    if len(traces) != 3:
        raise AssertionError(f"{len(traces)} traces for three cycles")
    per_cycle = []
    for cycle, (trace, t) in enumerate(zip(traces, arms["traced"])):
        by_id = {s["span_id"]: s for s in trace}
        pairs = collections.Counter((s["name"], by_id[s["parent_id"]]["name"] if s["parent_id"] else None)
                                    for s in trace)
        want = collections.Counter({("cycle", None): 1, **{(n, "cycle"): 1 for n in TRACED_SPANS[1:]}})
        if pairs != want:
            raise AssertionError(f"cycle {cycle + 1}: span tree {dict(pairs)}, expected {dict(want)}")
        dur = {s["name"]: s["dur_us"] / 1e6 for s in trace}
        attrs = {s["name"]: s["attrs"] for s in trace}
        if attrs["solve"].get("tier") != "fused" or "warm_fraction" not in attrs["encode"]:
            raise AssertionError(f"cycle {cycle + 1}: span attributes {attrs}")
        a, c = t["torch_allocate"], t["timings"]
        per_cycle.append({
            "span_s": dur,
            "last_timings_s": {"cycle": c["run_once_s"], "snapshot": c["snapshot_s"], "encode": a["encode_s"],
                               "solve": a["solve_s"], "gang.assign": a["replay_s"],
                               "commit": c["close_s"]},
            "warm_fraction": attrs["encode"]["warm_fraction"], "tier": attrs["solve"]["tier"],
        })
    chrome = os.path.join(root, "chiprun_out", "traced_cycles_50k_5k.trace.json")
    os.makedirs(os.path.dirname(chrome), exist_ok=True)
    obs.export_chrome(spans, chrome)

    before, after = exposition_values(before_text), exposition_values(after_text)

    def grew(key):
        return after.get(key, 0.0) - before.get(key, 0.0)

    prefix = "kube_batch_tpu_"
    actions = [a.name for a in sched.actions]
    exposition = {
        "schedule_attempts": grew(f"{prefix}schedule_attempts_total"),
        "breaker_state_fused": after.get(f'{prefix}breaker_state{{tier="fused"}}'),
        "degraded_cycles": sum(v for k, v in after.items() if k.startswith(f"{prefix}degraded_cycles_total"))
        - sum(v for k, v in before.items() if k.startswith(f"{prefix}degraded_cycles_total")),
        "action_latency_counts": {
            name: grew(f'{prefix}action_scheduling_latency_count{{action="{name}"}}') for name in actions},
        "series": len([line for line in after_text.splitlines() if line.startswith("# TYPE")]),
    }
    if (exposition["schedule_attempts"], exposition["breaker_state_fused"], exposition["degraded_cycles"]) != (
            3.0, 0.0, 0.0) or len(actions) != 5 or set(exposition["action_latency_counts"].values()) != {3.0}:
        raise AssertionError(f"the exposition after three traced cycles: {exposition}")
    rec = {
        "phase": "traced_cycles_50k_5k", "pods": pods, "nodes": nodes,
        "run_once_s": {arm: [c["run_once_s"] for c in out] for arm, out in arms.items()},
        "gc_s": {arm: [c["gc_s"] for c in out] for arm, out in arms.items()},
        "traced_minus_untraced_s": [t["run_once_s"] - u["run_once_s"]
                                    for t, u in zip(arms["traced"], arms["untraced"])],
        # the same difference with each cycle's cyclic-collector time taken out
        "traced_minus_untraced_net_of_gc_s": [(t["run_once_s"] - t["gc_s"]) - (u["run_once_s"] - u["gc_s"])
                                              for t, u in zip(arms["traced"], arms["untraced"])],
        "spans": len(spans), "span_cost_us": span_cost_s * 1e6,
        "spans_cost_per_cycle_us": span_cost_s * 1e6 * len(spans) / 3,
        "check_tree": violations, "cycles": per_cycle,
        "chrome_trace": os.path.relpath(chrome, root), "exposition": exposition,
        "equal_on_and_off": True, "b1_launches": launches[0], "b2_launches": launches[1],
        "binds_by_cycle": [len(c["binds"]) for c in arms["traced"]],
        "warm_alternating": warm,
    }
    if cut > 1:
        rec["reduced"] = {"pods": [CYCLES_WORLD[0], pods], "nodes": [CYCLES_WORLD[1], nodes]}
    return rec, tuple(launches)


def warm_trace_cost(sched, cache, sync, launches: list, on_card: bool, collector: bool = True) -> dict:
    """Warm cycles of ``sched`` with tracing on and off in the order of
    traced_cycles_phase's docstring; binds, evicts and launches must not
    change from run to run. With ``collector`` False, each cycle runs with
    the cyclic collector off after a full collection outside the timed
    cycle: a generation-2 collection (1-2.6 s at 50k x 5k) cannot land in
    one arm's cycle. Returns each arm's run_once times (and net of the
    collector), their medians and spreads, and each arm's median
    ``last_timings`` entries."""
    import gc

    from kube_batch_tpu_torch import obs
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import fused_solve as fs

    order = ["traced", "untraced"] + ["traced", "untraced", "untraced", "traced"] * WARM_ROUNDS
    runs = {"traced": [], "untraced": []}
    saved = os.environ.get("KBT_TRACE")
    first = None
    try:
        for i, arm in enumerate(order):
            os.environ["KBT_TRACE"] = "1" if arm == "traced" else "0"
            cache.binder.binds.clear()
            del cache.evictor.evicts[:]
            obs.recorder.clear()
            if not collector:
                gc.collect()
                gc.disable()
            sync()
            fs.fused_solve.launches = bs.block_step.launches = 0
            try:
                with GcClock() as gc_clock:
                    t0 = time.perf_counter()
                    sched.run_once()
                    sync()
                    wall_s = time.perf_counter() - t0
            finally:
                gc.enable()
            launches[0] += fs.fused_solve.launches
            launches[1] += bs.block_step.launches
            if "aborted" in sched.last_timings:
                raise AssertionError(f"warm {arm} run {i}: aborted: {sched.last_timings['aborted']}")
            if on_card and (fs.fused_solve.launches, bs.block_step.launches) != (1, 0):
                raise AssertionError(f"warm {arm} run {i}: {fs.fused_solve.launches} B1 and "
                                     f"{bs.block_step.launches} B2 launches; expected 1 and 0")
            if bool(obs.recorder.spans()) != (arm == "traced"):
                raise AssertionError(f"warm {arm} run {i}: {len(obs.recorder.spans())} spans recorded")
            got = (dict(cache.binder.binds), list(cache.evictor.evicts))
            first = first or got
            if got != first:
                raise AssertionError(f"warm {arm} run {i}: binds or evicts differ from the first warm run's")
            alloc = next(a for a in sched.actions if a.name == "torch_allocate")
            if i >= 2:  # after one warm-up cycle of each arm
                runs[arm].append({"run_once_s": wall_s, "gc_s": gc_clock.record()["gc_s"],
                                  "timings": {**sched.last_timings, **{f"torch_allocate.{k}": v for k, v in
                                                                       alloc.last_timings.items()}}})
    finally:
        if saved is None:
            os.environ.pop("KBT_TRACE", None)
        else:
            os.environ["KBT_TRACE"] = saved
        obs.configure()
        obs.recorder.clear()

    def summary(values):
        return {"median": statistics.median(values), "min": min(values), "max": max(values)}

    out = {"order": order, "warm_up_runs": 2, "runs_per_arm": len(runs["traced"])}
    for arm, rs in runs.items():
        keys = [k for k, v in rs[0]["timings"].items() if isinstance(v, float)]
        out[arm] = {
            "run_once_s": [r["run_once_s"] for r in rs],
            "gc_s": [r["gc_s"] for r in rs],
            "run_once": summary([r["run_once_s"] for r in rs]),
            "run_once_net_of_gc": summary([r["run_once_s"] - r["gc_s"] for r in rs]),
            "median_timings_s": {k: statistics.median(r["timings"][k] for r in rs) for k in keys},
        }
    out["median_traced_minus_untraced_s"] = (out["traced"]["run_once"]["median"]
                                             - out["untraced"]["run_once"]["median"])
    out["median_traced_minus_untraced_net_of_gc_s"] = (out["traced"]["run_once_net_of_gc"]["median"]
                                                       - out["untraced"]["run_once_net_of_gc"]["median"])
    return out


def ladder_trace_phases(clusters: dict, results: dict, device: str = "cuda", cut: int = 1) -> tuple[list[str], dict]:
    """The solver ladder's and the trace's phases: ``ladder_drills``,
    ``overrun_50k_5k`` (drills: they inject their faults) and
    ``traced_cycles_50k_5k`` (undisturbed). Returns the failures and the
    launches of each phase's main path."""
    failures, launches = [], {}

    def drills():
        rec, launches["ladder_drills"] = ladder_drills(device)
        emit(rec)

    def overrun():
        rec, launches["overrun_50k_5k"] = overrun_phase(clusters, results, device, cut)
        emit(rec)

    def traced():
        rec, launches["traced_cycles_50k_5k"] = traced_cycles_phase(device, cut)
        emit(rec)

    run_phase(failures, "ladder_drills", drills, drill=True)
    run_phase(failures, "overrun_50k_5k", overrun, drill=True)
    run_phase(failures, "traced_cycles_50k_5k", traced)
    return failures, launches


def pipeline_uncut(card: str, kind: str) -> int:
    """``--pipeline-uncut``: pipeline_reclaim on the card at 50,000 pods,
    the cost of the uncut reclaim pass and of the preempt walk after it
    (minutes of host work; not part of the smoke run)."""
    from kube_batch_tpu_torch.ops import block_step as bs
    from kube_batch_tpu_torch.ops import fused_solve as fs
    from kube_batch_tpu_torch.ops import nvcc

    t_start = time.perf_counter()
    nvcc.build(["fused_solve", "block_step"])
    fs._library.load()
    bs._library.load()
    failures, _ = pipeline_phases({}, {}, reclaim_pods=50_000, only=("pipeline_reclaim",))
    emit({"phase": "total", "s": time.perf_counter() - t_start})
    if failures:
        return 1
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}})
    return 0


def rehearse(argv: list[str]) -> int:
    """``--rehearse CUT``: the pipeline, fast-path, ladder and trace
    phases on the CPU, every world's pod and node counts divided by CUT,
    torch_allocate on the kernels' plain versions. A prediction of the
    host actions' cost, not a measurement of the card."""
    try:
        cut = int(argv[1]) if len(argv) == 2 else 0
    except ValueError:
        cut = 0
    if cut < 2:
        print("chip_smoke: usage: chip_smoke.py --rehearse CUT (an integer of 2 or more)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    emit(native_build())
    failures, _ = pipeline_phases({}, {}, device="cpu", cut=cut)
    fast_failures, _ = fast_path_phases({}, {}, device="cpu", cut=cut)
    failures += fast_failures + degradation_failures()
    ladder_failures, _ = ladder_trace_phases({}, {}, device="cpu", cut=cut)
    failures += ladder_failures
    emit({"phase": "total", "s": time.perf_counter() - t0, "cut": cut})
    return 1 if failures else 0


AB_WARM_CODE = ("import json, sys; sys.path.insert(0, '.'); import chip_smoke as c; "
                "rec, _ = c.warm_cycles_phase('cuda'); print('AB_WARM ' + json.dumps(rec))")


def ab_warm(other: str) -> int:
    """``--ab-warm DIR``: ``warm_cycles_50k_5k`` of the checkout at DIR (the
    parent commit, unpacked with ``git archive``) against this checkout's,
    in the order DIR, this, this, DIR, each in a process of its own on the
    card, tracing off (the default). One record per run: each cycle's
    ``run_once`` and collector time, fast paths on and off."""
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(other)
    failed = 0
    for run, tree in enumerate((other, here, here, other)):
        out = subprocess.run([sys.executable, "-c", AB_WARM_CODE], cwd=tree, capture_output=True, text=True,
                             timeout=900)
        line = next((x for x in out.stdout.splitlines() if x.startswith("AB_WARM ")), None)
        if out.returncode != 0 or line is None:
            failed += 1
            print(f"chip_smoke: ab_warm run {run} in {tree} exited {out.returncode}: {out.stderr[-2000:]}",
                  file=sys.stderr)
            continue
        rec = json.loads(line[len("AB_WARM "):])
        emit({"phase": "ab_warm", "run": run, "tree": "this" if tree == here else "other",
              **{arm: {"run_once_s": [c["run_once_s"] for c in rec[arm]], "gc_s": [c["gc_s"] for c in rec[arm]]}
                 for arm in ("fast", "off")}, "b1_launches": rec["b1_launches"]})
    return 1 if failed else 0


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

    if argv[:1] == ["--rehearse"]:
        return rehearse(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if argv in (["--cards"], ["--pipeline-uncut"]) or argv[:1] == ["--ab-warm"] and len(argv) == 2:
        card = card_line()
        emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__, "cuda": torch.version.cuda})
        if argv == ["--cards"]:
            return distinct_cards(card)
        if argv[0] == "--ab-warm":
            return ab_warm(argv[1])
        return pipeline_uncut(card, torch.cuda.get_device_name(0))
    if argv:
        print(f"chip_smoke: unknown arguments {argv}; usage: chip_smoke.py [--cards | --pipeline-uncut | "
              "--ab-warm DIR | --rehearse CUT]", file=sys.stderr)
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
    native_rec: dict = {}

    def build_native():
        try:
            native_rec.update(native_build())
        except Exception as e:  # noqa: BLE001 - raised below, after the kernels' build
            native_rec["error"] = e

    native_thread = threading.Thread(target=build_native)
    native_thread.start()  # g++ beside the nvcc processes
    logs = nvcc.build(["fused_solve", "block_step"])
    fs._library.load()
    bs._library.load()
    native_thread.join()
    emit({"phase": "build", "s": time.perf_counter() - t0,
          "ptxas": {name: ptxas_summary(log) for name, log in logs.items()}})
    if "error" in native_rec:
        raise RuntimeError(f"native_build: the native hot loops cannot be built or loaded: {native_rec['error']}")
    emit(native_rec)
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
    # -- the twin pipeline: enqueue, reclaim, allocate, backfill, preempt ---
    pipeline_failures, pipeline_launches = pipeline_phases(clusters, results)
    failures += pipeline_failures
    # -- the host fast paths: encode cache, warm cycles, native parity ------
    fast_failures, fast_launches = fast_path_phases(clusters, results)
    failures += fast_failures + degradation_failures()
    # -- the solver ladder under faults, the cycle under trace --------------
    ladder_failures, ladder_launches = ladder_trace_phases(clusters, results)
    failures += ladder_failures
    if failures:
        print("chip_smoke: failed phases:\n  " + "\n  ".join(failures), file=sys.stderr, flush=True)
        return 1
    cycle_launches.update(pipeline_launches)
    cycle_launches.update(fast_launches)
    cycle_launches.update(ladder_launches)
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
