"""The gang-aware allocation solve as plain torch ops (the spec of the fused
kernel in csrc/fused_solve.cu).

One loop iteration = one step of the serial allocate loop (reference
actions/allocate/allocate.go:94-190): select the active queue (proportion
share asc, then static creation/uid rank — session_plugins.go:280-305 +
proportion.go:146-159), drop it for the cycle if overused
(proportion.go:188-199), select the next job from it (priority desc ->
gang non-ready-first -> drf share asc -> creation/uid; priority.go:61-77 +
gang.go:96-118 + drf.go:114-132), pop its next pending task and assign it
to the best feasible node. Feasibility (HOT LOOP #1,
scheduler_helper.go:34-57) and scoring (HOT LOOP #2,
scheduler_helper.go:60-109) are single vectorized ops over the node axis:

- feasibility: epsilon-tolerant resource fit against idle OR releasing
  (allocate.go:78-92 + resource_info.go:255-278, including the Go
  nil-scalar-map parity flags), precomputed label-compat gather, pod-count
  room, dynamic host-port bitmask;
- score: LeastRequested + BalancedResourceAllocation integer formulas plus
  the precomputed affinity terms (nodeorder.go:109-222), argmax with
  first-node tie-break;
- assignment: fits-idle -> allocate, else -> pipeline onto releasing
  (node_info.go:108-136), with the gang barrier — a job reaching
  min_available is re-queued so other jobs get their turn
  (allocate.go:182-185).

Tasks are laid out contiguously per job by the encoder and each job keeps
a next-task pointer, so a task pop is O(1). Iterations are bounded by
T + J + Q + 1 plus one paused iteration per host-only task.

The loop is a Python loop over torch ops: scalar control flow (queue/job
selection only when no job is current, the pop, the retire) runs on the
host, the node-axis work as tensor ops. Float32 throughout, with the same
op order and the same first-index tie-breaks as the reference twin
(kube_batch_tpu/ops/kernels.py), so results agree field for field.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MAX_PRIORITY = 10  # schedulerapi.MaxPriority (nodeorder.py)

KIND_NONE = 0
KIND_ALLOCATED = 1
KIND_PIPELINED = 2


class SolveResult(NamedTuple):
    assigned_node: torch.Tensor  # [T] int32, node row or -1
    assigned_kind: torch.Tensor  # [T] int32, KIND_*
    assign_pos: torch.Tensor  # [T] int32, order of the assignment event, or -1
    ready_cnt: torch.Tensor  # [J] int32, final ready_task_num per job
    n_assigned: torch.Tensor  # int32


class SolveState(NamedTuple):
    """Resumable mid-solve state: a solve that paused on a host-only task
    resumes from here once the host has stepped that task."""

    it: torch.Tensor
    step: torch.Tensor
    cur: torch.Tensor
    ptr: torch.Tensor  # [J] next-task row per job
    assigned_node: torch.Tensor
    assigned_kind: torch.Tensor
    assign_pos: torch.Tensor
    idle: torch.Tensor
    rel: torch.Tensor
    used: torch.Tensor
    ntasks: torch.Tensor
    nports: torch.Tensor
    ready_cnt: torch.Tensor
    job_active: torch.Tensor
    q_dropped: torch.Tensor
    job_alloc: torch.Tensor  # [J,R] drf allocated (zeros when drf off)
    q_alloc: torch.Tensor  # [Q,R] proportion allocated (zeros when off)
    q_alloc_has_sc: torch.Tensor  # [Q] Go nil-scalar-map parity bit
    paused_at: torch.Tensor  # task row the solve paused on (host-only), or -1


def _np(x) -> np.ndarray:
    """A host array view of a CPU tensor (or an array-like)."""
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _lex_argmin(mask: np.ndarray, *keys: np.ndarray) -> tuple[int, bool]:
    """Index of the mask=True element minimizing keys lexicographically;
    first index wins ties. Returns (index, any) — index is garbage when
    any is False."""
    m = mask
    for k in keys:
        sentinel = np.inf if k.dtype.kind == "f" else np.iinfo(k.dtype).max
        kmin = np.where(m, k, k.dtype.type(sentinel)).min()
        m = m & (k == kmin)
    return int(m.argmax()), bool(mask.any())


def ieee_div(x, y):
    """Correctly-rounded x/y, kept from the reference twin: one Newton
    correction with a Dekker/Veltkamp two-product residual. torch's (and
    numpy's) float32 divide is already correctly rounded on the CPU, where
    the correction is then exact and leaves the quotient unchanged. Takes
    torch tensors or numpy arrays."""
    q = x / y
    split = 134217729.0 if q.dtype in (torch.float64, np.float64) else 4097.0
    c = split * q
    qh = c - (c - q)
    ql = q - qh
    d = split * y
    yh = d - (d - y)
    yl = y - yh
    p = q * y
    e = ((qh * yh - p) + qh * yl + ql * yh) + ql * yl  # q*y - p, exactly
    r = (x - p) - e  # residual x - q*y
    return q + r / y


def _le_eps(req: torch.Tensor, pool: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Vectorized Resource.less_equal over the node axis
    (resource_info.go:255-278): per-dimension l < r + eps. ``req`` is one
    task's [R] row ([N] out) or a batch of rows [G, R] ([G, N] out)."""
    return (req[..., None, :] < pool + eps[None, :]).all(dim=-1)


def _share_rows(alloc: np.ndarray, denom: np.ndarray, dims: np.ndarray) -> np.ndarray:
    """Vectorized api.helpers.share over rows: max over masked dims of
    share(alloc, denom) with 0/0 -> 0, x/0 -> 1 (helpers.go:43-60,
    drf.go:161-171, proportion.go:211-223)."""
    safe = np.where(denom == 0, np.ones_like(denom), denom)
    zero_denom = (alloc != 0).astype(alloc.dtype)
    s = np.where(denom == 0, zero_denom, ieee_div(alloc, safe))
    s = np.where(dims, s, np.full_like(s, -np.inf))
    return np.maximum(s.max(axis=-1), s.dtype.type(0))


def select_queue_job(a: dict, s: SolveState, enable_drf: bool, enable_proportion: bool):
    """Queue + job selection (proportion share asc -> overused gate ->
    priority/gang/drf keys). Returns (qsel, q_any, overused, jsel, j_any)
    as Python values; qsel/jsel are garbage when the matching `any` is
    False.

    Runs on the host, in numpy over views of the CPU tensors: it is a
    handful of tiny vector operations per call, which numpy runs at a
    fraction of torch's per-operation cost, and the sharded solve calls it
    once per job change. ``ieee_div`` takes numpy arrays as they are."""
    Q = a["queue_rank"].shape[0]
    job_queue = _np(a["job_queue"])
    eps = _np(a["eps"])
    job_active = _np(s.job_active)
    q_alloc = _np(s.q_alloc)
    counts = np.bincount(job_queue[job_active], minlength=Q)[:Q]
    q_has = (counts > 0) & ~_np(s.q_dropped)
    if enable_proportion:
        q_deserved = _np(a["q_deserved"])
        q_share = _share_rows(q_alloc, q_deserved, _np(a["q_dims"]))
        qsel, q_any = _lex_argmin(q_has, q_share, _np(a["queue_rank"]))
    else:
        qsel, q_any = _lex_argmin(q_has, _np(a["queue_rank"]))

    overused = False
    if enable_proportion:
        # Overused gate: deserved.LessEqual(allocated) with the Go
        # nil-scalar-map branch (proportion.go:188-199 +
        # resource_info.go:255-278).
        d_row = q_deserved[qsel]
        a_row = q_alloc[qsel]
        dim_ok = (d_row < a_row) | (np.abs(a_row - d_row) < eps)
        if dim_ok.shape[0] > 2 and not bool(_np(s.q_alloc_has_sc)[qsel]):
            dim_ok[2:] = False
        overused = bool(np.where(_np(a["q_dims"])[qsel], dim_ok, True).all())

    ready_bit = (_np(s.ready_cnt) >= _np(a["job_min"])).astype(np.int32)
    jmask = job_active & (job_queue == qsel)
    jkeys = [-_np(a["job_prio"]), ready_bit]
    if enable_drf:
        jkeys.append(
            _share_rows(_np(s.job_alloc), _np(a["drf_total"])[None, :], _np(a["drf_dims"])[None, :])
        )
    jkeys.append(_np(a["job_rank"]))
    jsel, j_any = _lex_argmin(jmask, *jkeys)
    return qsel, q_any, overused, jsel, j_any


def init_state(a: dict, enable_drf: bool = False, enable_proportion: bool = False) -> SolveState:
    """Fresh solve state from an encoded snapshot (see ops.encode)."""
    T = a["task_req"].shape[0]
    J = a["job_min"].shape[0]
    Q = a["queue_rank"].shape[0]
    R = a["task_req"].shape[1]
    f32, i32 = torch.float32, torch.int32
    dev = a["task_req"].device

    def scalar(v: int) -> torch.Tensor:
        return torch.tensor(v, dtype=i32, device=dev)

    return SolveState(
        it=scalar(0),
        step=scalar(0),
        cur=scalar(-1),
        ptr=a["job_start"].clone(),
        assigned_node=torch.full((T,), -1, dtype=i32, device=dev),
        assigned_kind=torch.zeros(T, dtype=i32, device=dev),
        assign_pos=torch.full((T,), -1, dtype=i32, device=dev),
        idle=a["node_idle"].clone(),
        rel=a["node_rel"].clone(),
        used=a["node_used"].clone(),
        ntasks=a["node_ntasks"].clone(),
        nports=a["node_ports"].clone(),
        ready_cnt=a["job_ready0"].clone(),
        job_active=a["job_valid"].clone(),
        q_dropped=torch.zeros(Q, dtype=torch.bool, device=dev),
        job_alloc=a["job_alloc0"].clone() if enable_drf else torch.zeros(J, R, dtype=f32, device=dev),
        q_alloc=a["q_alloc0"].clone() if enable_proportion else torch.zeros(Q, R, dtype=f32, device=dev),
        q_alloc_has_sc=(
            a["q_alloc_has_sc0"].clone()
            if enable_proportion
            else torch.zeros(Q, dtype=torch.bool, device=dev)
        ),
        paused_at=scalar(-1),
    )


def _least_dim(rq: torch.Tensor, cp: torch.Tensor) -> torch.Tensor:
    safe = torch.where(cp == 0, torch.ones_like(cp), cp)
    sc = torch.floor(ieee_div((cp - rq) * MAX_PRIORITY, safe)).to(torch.int32)
    return torch.where((cp == 0) | (rq > cp), torch.zeros_like(sc), sc)


def node_scores(
    used: torch.Tensor, node_alloc: torch.Tensor, res: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(least, balanced) int32 over the node axis for a task requesting
    `res` (k8s LeastRequested and BalancedResourceAllocation)."""
    req_cpu = used[:, 0] + res[0]
    req_mem = used[:, 1] + res[1]
    cap_cpu = node_alloc[:, 0]
    cap_mem = node_alloc[:, 1]
    least = (_least_dim(req_cpu, cap_cpu) + _least_dim(req_mem, cap_mem)) // 2
    one = torch.ones_like(cap_cpu)
    cpu_f = torch.where(cap_cpu != 0, ieee_div(req_cpu, torch.where(cap_cpu == 0, one, cap_cpu)), one)
    mem_f = torch.where(cap_mem != 0, ieee_div(req_mem, torch.where(cap_mem == 0, one, cap_mem)), one)
    balanced = torch.where(
        (cpu_f >= 1.0) | (mem_f >= 1.0),
        torch.zeros_like(least),
        (MAX_PRIORITY - (cpu_f - mem_f).abs() * MAX_PRIORITY).to(torch.int32),
    )
    return least, balanced


def solve_allocate_step(
    a: dict,
    state: SolveState | None = None,
    enable_drf: bool = False,
    enable_proportion: bool = False,
    work: dict | None = None,
) -> SolveState:
    """The full allocate solve.

    Runs until every job is retired or, when the encoder flagged host-only
    tasks (`a["task_host_only"]` has any True), until such a task reaches
    the head of its job — then returns with `paused_at` set so the caller
    can step it on the host and resume (`state=` carries everything
    forward). The caller's state tensors are not modified.

    ``work``, when given, accumulates what the solve needs of the node
    axis: ``fit_nodes`` (nodes whose fit against idle/releasing had to be
    tested: statically compatible, with pod room and free ports) and
    ``scored_nodes`` (feasible nodes that had to be scored), summed over
    the popped tasks.
    """
    T = a["task_req"].shape[0]
    J = a["job_min"].shape[0]
    Q = a["queue_rank"].shape[0]

    task_req = a["task_req"]
    task_res = a["task_res"]
    task_gid = a["task_gid"]
    task_has_sc = a["task_has_sc"]
    task_res_has_sc = a["task_res_has_sc"]
    task_ports = a["task_ports"]
    task_host_only = a["task_host_only"]
    node_alloc = a["node_alloc"]
    node_ok = a["node_ok"] & a["node_valid"]
    node_max_tasks = a["node_max_tasks"]
    node_idle_has_sc = a["node_idle_has_sc"]
    node_rel_has_sc = a["node_rel_has_sc"]
    node_gid = a["node_gid"].long()
    compat = a["compat"]
    aff_sc = a["aff_sc"]
    pod_sc = a["pod_sc"]  # [GT, N] InterPodAffinity (zeros when inactive)
    job_end = a["job_end"]
    job_min = a["job_min"]
    job_queue = a["job_queue"]
    eps = a["eps"]
    fdtype = task_req.dtype
    w_least = torch.tensor(float(a["w_least"]), dtype=fdtype)
    w_balanced = torch.tensor(float(a["w_balanced"]), dtype=fdtype)
    w_aff = torch.tensor(float(a["w_aff"]), dtype=fdtype)
    w_podaff = torch.tensor(float(a["w_podaff"]), dtype=fdtype)

    max_iter = T + J + Q + 1 + int(task_host_only.sum())

    if state is None:
        state = init_state(a, enable_drf=enable_drf, enable_proportion=enable_proportion)
    s = SolveState(*(x.clone() for x in state))
    it, step, cur = int(s.it), int(s.step), int(s.cur)
    paused = -1
    job_active = s.job_active

    while (cur >= 0 or bool(job_active.any())) and it < max_iter and paused < 0:
        # -- queue + job selection (only when no job is current) -----------
        if cur < 0:
            qsel, q_any, overused, jsel, j_any = select_queue_job(
                a, s, enable_drf, enable_proportion
            )
            if q_any and overused:
                # Dropping an overused queue retires all its jobs for this
                # cycle (shares only grow during allocate: overused is final).
                job_active &= job_queue != qsel
                s.q_dropped[qsel] = True
            cur = jsel if (q_any and not overused and j_any) else -1

        # -- pop the current job's next pending task (O(1) pointer) --------
        t = int(s.ptr[max(cur, 0)])
        t_any = cur >= 0 and t < int(job_end[cur])
        t = min(t, T - 1)
        drop = cur >= 0 and not t_any  # tasks exhausted -> job leaves the heap
        pause = t_any and bool(task_host_only[t])
        proc = t_any and not pause
        assign = abandon = False

        if proc:
            # -- feasibility over the node axis (HOT LOOP #1) ---------------
            req = task_req[t]
            has_sc = bool(task_has_sc[t])
            fits_idle = _le_eps(req, s.idle, eps)
            fits_rel = _le_eps(req, s.rel, eps)
            if has_sc:
                fits_idle = fits_idle & node_idle_has_sc
                fits_rel = fits_rel & node_rel_has_sc
            gid = int(task_gid[t])
            static_ok = node_ok & compat[gid][node_gid]
            room = s.ntasks < node_max_tasks
            port_ok = ~(task_ports[t][None, :] & s.nports).any(dim=1)
            cand = static_ok & room & port_ok & (fits_idle | fits_rel)
            if work is not None:
                work["fit_nodes"] = work.get("fit_nodes", 0) + int((static_ok & room & port_ok).sum())
                work["scored_nodes"] = work.get("scored_nodes", 0) + int(cand.sum())

            # -- score (HOT LOOP #2) + deterministic best node --------------
            res = task_res[t]
            least, balanced = node_scores(s.used, node_alloc, res)
            score = (
                least.to(fdtype) * w_least
                + balanced.to(fdtype) * w_balanced
                + aff_sc[gid][node_gid] * w_aff
                + pod_sc[gid] * w_podaff
            )
            masked = torch.where(cand, score, torch.full_like(score, float("-inf")))
            assign = bool(cand.any())
            abandon = not assign  # serial `break` without re-push
            if assign:
                nb = int(masked.argmax())
                do_alloc = bool(fits_idle[nb])
                # -- apply the assignment (node_info.go:108-136) ------------
                if do_alloc:
                    s.idle[nb] -= res
                    s.ready_cnt[cur] += 1
                else:  # the predicate guarantees fits_rel
                    s.rel[nb] -= res
                s.used[nb] += res
                s.ntasks[nb] += 1
                s.nports[nb] |= task_ports[t]
                s.assigned_node[t] = nb
                s.assigned_kind[t] = KIND_ALLOCATED if do_alloc else KIND_PIPELINED
                s.assign_pos[t] = step
                # -- drf / proportion session-event bookkeeping (drf.go:135-154,
                # proportion.go:202-223: allocated grows on allocate AND pipeline)
                if enable_drf:
                    s.job_alloc[cur] += res
                if enable_proportion:
                    qcur = int(job_queue[cur])
                    s.q_alloc[qcur] += res
                    if bool(task_res_has_sc[t]):
                        s.q_alloc_has_sc[qcur] = True
            s.ptr[cur] += 1

        # -- gang barrier / job lifecycle (allocate.go:117-119,182-185) -----
        if drop or abandon:
            job_active[cur] = False
            cur = -1
        elif proc and int(s.ready_cnt[cur]) >= int(job_min[cur]):
            cur = -1
        paused = t if pause else -1
        it += 1
        step += int(assign)

    def scalar(v: int) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.int32)

    return s._replace(it=scalar(it), step=scalar(step), cur=scalar(cur), paused_at=scalar(paused))


def result_of(state: SolveState) -> SolveResult:
    return SolveResult(
        assigned_node=state.assigned_node,
        assigned_kind=state.assigned_kind,
        assign_pos=state.assign_pos,
        ready_cnt=state.ready_cnt,
        n_assigned=state.step,
    )


def solve_allocate_state(
    a: dict,
    state: SolveState | None = None,
    enable_drf: bool = False,
    enable_proportion: bool = False,
) -> SolveState:
    return solve_allocate_step(a, state, enable_drf, enable_proportion)
