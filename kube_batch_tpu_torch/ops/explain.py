"""Batched unschedulability forensics over the post-solve state, as torch
ops on the state's device.

The solve (kernel B1, or the sharded rung's B2) tests, for every task it
pops, the four feasibility planes of the serial predicate scan —

- ``static``:    label-compat gather x taints/cordon (``node_ok & compat``)
- ``room``:      pod-count headroom (``ntasks < node_max_tasks``)
- ``ports``:     dynamic host-port disjointness
- ``resources``: epsilon-tolerant fit against idle OR releasing, with the
  Go nil-scalar-map parity bits (resource_info.go:255-278)

— and keeps none of them after the arg-max. This module re-evaluates those
planes *after* the solve, against the final node state, for one
representative task per still-pending gang (the first unassigned row in
pop order, the task the serial loop abandoned on), and reduces them to:

(a) per-plane node elimination counts;
(b) top-k near-miss nodes by the solver's own score, with per-plane
    feasibility bits;
(c) leave-one-plane-out would-fit-if verdicts: does relaxing a single
    plane make at least one node feasible?

``explain_batch`` is one batched pass over the G representative rows on
the device the inputs lie on: planes ``[G, 4, N]`` and scores ``[G, N]``,
the counts and verdicts as reductions, and the top-k as k rounds of
``argmax`` and mask (the first index wins ties, and a row with fewer valid
nodes than k repeats node 0, as numpy's argmax over an all ``-inf`` row
does; ``torch.topk``'s order among ties is not fixed on CUDA). Every divide
goes through ``ops/kernels.ieee_div`` and every fit test through
``_le_eps``; each arithmetic step is its own torch op, so nothing
contracts a multiply and an add into one rounding. ``explain_rows_np`` is
the numpy twin, task by task, which pins explain parity serial = fused =
sharded the way the solver pins placement parity.

Scores omit the InterPodAffinity term (``pod_sc``): it is the one score
input recomputed on the host per segmented step, so the pre-solve matrix
and a serial re-encode's may legitimately differ. The static affinity term
(``aff_sc``) is per (task-group, node-group) and identical across encodes
of the same world, so it stays in the ranking.

Where the inputs come from (``fused_inputs``, ``uploaded_inputs``): on the
fused rung the pass reads kernel B1's packed statics already on the card
(class tables, the expanded static verdict, the pre-weighted affinity
table, capacities, pod caps, flags, eps and weights) and the final state
buffers before their fetch; it uploads nothing but, when the snapshot
carries live InterPodAffinity scores (folded into B1's affinity table),
the affinity table without them. The sharded rung keeps its state on the
host, so there the pass uploads the explain subset of the arrays
(``ARRAY_KEYS``) and the five state fields.
"""

from __future__ import annotations

import numpy as np
import torch

from kube_batch_tpu_torch.ops.class_solve import _pow2, dedup_rows
from kube_batch_tpu_torch.ops.kernels import MAX_PRIORITY, _le_eps, ieee_div

# Fixed plane order: elimination counts, would-fit-if verdicts and
# near-miss bit vectors are all indexed by this tuple, and the dominant
# reason tie-break is first-plane-wins over it.
PLANES = ("static", "room", "ports", "resources")

# Keys of the encode arrays the forensics pass reads (a strict subset of
# the solver's inputs).
ARRAY_KEYS = (
    "task_req",
    "task_res",
    "task_gid",
    "task_has_sc",
    "task_ports",
    "node_ok",
    "node_valid",
    "node_gid",
    "node_max_tasks",
    "node_alloc",
    "node_idle_has_sc",
    "node_rel_has_sc",
    "compat",
    "aff_sc",
    "eps",
)
WEIGHT_KEYS = ("w_least", "w_balanced", "w_aff")


def pad_rows(rows: list[int], floor: int = 8) -> np.ndarray:
    """Pad a representative-row list to the next power-of-two bucket with
    -1 sentinels (the encoder's bucketing discipline)."""
    n = max(len(rows), 1)
    cap = floor
    while cap < n:
        cap *= 2
    out = np.full(cap, -1, np.int32)
    out[: len(rows)] = rows
    return out


def _tensor(x, device=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t if device is None else t.to(device)


def _score_planes(a: dict, idle, rel, used, ntasks, nports, t: torch.Tensor):
    """Planes ``[G, 4, N]`` and scores ``[G, N]`` for the task rows ``t``
    ([G] int64, already clipped to valid rows): the JAX package's per-row
    ``_score_planes``, broadcast over G."""
    fdtype = a["task_req"].dtype
    req = a["task_req"][t]  # [G, R]
    eps = a["eps"]
    fits_idle = _le_eps(req, idle, eps)  # [G, N]
    fits_rel = _le_eps(req, rel, eps)
    has_sc = a["task_has_sc"][t][:, None]
    fits_idle = fits_idle & ~(has_sc & ~a["node_idle_has_sc"][None, :])
    fits_rel = fits_rel & ~(has_sc & ~a["node_rel_has_sc"][None, :])
    resources = fits_idle | fits_rel
    gid = a["task_gid"][t].long()
    node_gid = a["node_gid"].long()
    static_ok = a["node_ok"][None, :] & a["compat"][gid][:, node_gid]
    room = (ntasks < a["node_max_tasks"])[None, :].expand_as(static_ok)
    ports = ~(a["task_ports"][t][:, None, :] & nports[None, :, :]).any(dim=2)
    planes = torch.stack([static_ok, room, ports, resources], dim=1)  # [G, 4, N]

    # Score: the solver's LeastRequested + BalancedResourceAllocation +
    # static-affinity formula, minus the pod_sc term (module docstring).
    res = a["task_res"][t]
    req_cpu = used[None, :, 0] + res[:, 0:1]
    req_mem = used[None, :, 1] + res[:, 1:2]
    cap_cpu = a["node_alloc"][:, 0][None, :].expand_as(req_cpu)
    cap_mem = a["node_alloc"][:, 1][None, :].expand_as(req_mem)
    one = torch.ones_like(cap_cpu)

    def least_dim(rq, cp):
        safe = torch.where(cp == 0, one, cp)
        sc = torch.floor(ieee_div((cp - rq) * MAX_PRIORITY, safe)).to(torch.int32)
        return torch.where((cp == 0) | (rq > cp), torch.zeros_like(sc), sc)

    least = (least_dim(req_cpu, cap_cpu) + least_dim(req_mem, cap_mem)) // 2
    cpu_f = torch.where(cap_cpu != 0, ieee_div(req_cpu, torch.where(cap_cpu == 0, one, cap_cpu)), one)
    mem_f = torch.where(cap_mem != 0, ieee_div(req_mem, torch.where(cap_mem == 0, one, cap_mem)), one)
    balanced = torch.where(
        (cpu_f >= 1.0) | (mem_f >= 1.0),
        torch.zeros_like(least),
        (MAX_PRIORITY - (cpu_f - mem_f).abs() * MAX_PRIORITY).to(torch.int32),
    )
    aff = a["aff_sc"][gid][:, node_gid].to(fdtype)
    score = (
        least.to(fdtype) * a["w_least"].to(fdtype)
        + balanced.to(fdtype) * a["w_balanced"].to(fdtype)
        + aff * a["w_aff"].to(fdtype)
    )
    return planes, score


def _as_inputs(a: dict, state: tuple, device) -> tuple[dict, tuple]:
    sub = {k: _tensor(a[k], device) for k in ARRAY_KEYS}
    for w in WEIGHT_KEYS:
        sub[w] = _tensor(a[w], device).to(sub["task_req"].dtype)
    return sub, tuple(_tensor(x, device) for x in state)


def explain_batch(a, idle, rel, used, ntasks, nports, rep_rows, topk: int = 3):
    """Batched forensics over padded representative rows, on the device
    of ``a["task_req"]``.

    ``a`` holds ``ARRAY_KEYS`` and ``WEIGHT_KEYS`` (tensors or numpy
    arrays; numpy lands on the CPU); the five state tensors are the
    *final* SolveState fields and must lie on the same device (a tensor
    on another device raises: the pass never moves to the CPU quietly).
    Returns tensors on that device: ``(elim [G,4] int32, feasible [G]
    int32, would_fit [G,4] bool, nm_idx [G,k] int32, nm_score [G,k],
    nm_planes [G,k,4] bool)``. Rows where ``rep_rows`` is -1 are padding
    (clipped to row 0) and carry values the caller must mask."""
    device = _tensor(a["task_req"]).device
    for name, x in (("idle", idle), ("rel", rel), ("used", used), ("ntasks", ntasks), ("nports", nports)):
        if isinstance(x, torch.Tensor) and x.device != device:
            raise ValueError(f"explain_batch: {name} lies on {x.device}, the arrays on {device}")
    sub, (idle, rel, used, ntasks, nports) = _as_inputs(a, (idle, rel, used, ntasks, nports), device)
    T = sub["task_req"].shape[0]
    rows = _tensor(rep_rows, device).long()
    t = rows.clamp(min=0).clamp(max=T - 1)
    planes, score = _score_planes(sub, idle, rel, used, ntasks, nports, t)
    valid = sub["node_valid"]
    G, P, N = planes.shape
    elim = (valid[None, None, :] & ~planes).sum(dim=2).to(torch.int32)
    feasible = (valid[None, :] & planes.all(dim=1)).sum(dim=1).to(torch.int32)
    would = torch.stack(
        [
            (valid[None, :] & planes[:, [q for q in range(P) if q != p]].all(dim=1)).any(dim=1)
            for p in range(P)
        ],
        dim=1,
    )
    # Deterministic top-k: k rounds of argmax and mask, first index wins
    # ties (torch.argmax returns the first maximal index), as the numpy
    # twin's loop.
    neg_inf = torch.tensor(float("-inf"), dtype=score.dtype, device=device)
    ranked = torch.where(valid[None, :], score, neg_inf)
    idxs, vals, nplanes = [], [], []
    for _ in range(int(topk)):
        i = torch.argmax(ranked, dim=1)  # [G]
        idxs.append(i.to(torch.int32))
        vals.append(score.gather(1, i[:, None])[:, 0])
        nplanes.append(planes.gather(2, i[:, None, None].expand(G, P, 1))[:, :, 0])
        ranked = ranked.scatter(1, i[:, None], neg_inf.expand(G, 1))
    return elim, feasible, would, torch.stack(idxs, dim=1), torch.stack(vals, dim=1), torch.stack(nplanes, dim=1)


# Node-side keys _score_planes reads per node: the class key for the
# compressed explain path. Two nodes with identical bytes across these
# slabs plus the five state tensors produce identical planes and scores,
# so forensics only has to evaluate one representative per class.
_CLASS_NODE_KEYS = (
    "node_alloc",
    "node_ok",
    "node_valid",
    "node_gid",
    "node_max_tasks",
    "node_idle_has_sc",
    "node_rel_has_sc",
)


def explain_batch_classes(a, idle, rel, used, ntasks, nports, rep_rows, topk: int = 3):
    """Class-compressed forensics: the outputs of ``explain_batch``, with
    the per-node evaluation folded to one row per node equivalence class
    (the static node slabs ``_score_planes`` reads plus the five state
    tensors). Planes and scores are evaluated on class representatives
    on the device of ``a["task_req"]``, then expanded on the host:
    elimination / feasible counts by valid member multiplicity,
    would-fit-if by class validity, and the top-k by replaying the
    node-level argmax tie contract (score descending, lowest node row
    wins ties) from the sorted member lists. Returns CPU tensors.
    ``obs/explain.forensics`` routes here under ``KBT_CLASS_COMPRESS``."""
    device = _tensor(a["task_req"]).device

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    idle, rel, used, ntasks, nports = (host(x) for x in (idle, rel, used, ntasks, nports))
    sub = {k: host(a[k]) for k in ARRAY_KEYS}
    first, inv = dedup_rows([sub[k] for k in _CLASS_NODE_KEYS] + [idle, rel, used, ntasks, nports])
    C = int(first.shape[0])
    counts = np.bincount(inv, minlength=C).astype(np.int64)
    order = np.argsort(inv, kind="stable").astype(np.int64)
    off = np.zeros(C, np.int64)
    np.cumsum(counts[:-1], out=off[1:])
    rep = order[off]  # lowest member row per class

    # pad the class axis to a power-of-two bucket (index-0 repeats)
    Cp = _pow2(C)
    rep_p = np.concatenate([rep, np.zeros(Cp - C, np.int64)])
    for key in _CLASS_NODE_KEYS:
        sub[key] = sub[key][rep_p]
    dev_a, state = _as_inputs(
        {**sub, **{w: host(a[w]) for w in WEIGHT_KEYS}},
        (idle[rep_p], rel[rep_p], used[rep_p], ntasks[rep_p], nports[rep_p]),
        device,
    )
    T = dev_a["task_req"].shape[0]
    t = _tensor(rep_rows, device).long().clamp(min=0).clamp(max=T - 1)
    planes_c, score_c = _score_planes(dev_a, *state, t)
    planes_c = planes_c.cpu().numpy()  # [G, 4, Cp]
    score_c = score_c.cpu().numpy()  # [G, Cp]

    valid_c = np.asarray(host(a["node_valid"]), bool)[rep]  # class-uniform
    vcounts = np.where(valid_c, counts, 0)
    G = len(rep_rows)
    k = int(topk)
    P = len(PLANES)
    elim = np.zeros((G, P), np.int32)
    feasible = np.zeros(G, np.int32)
    would = np.zeros((G, P), bool)
    nm_idx = np.zeros((G, k), np.int32)
    nm_score = np.zeros((G, k), score_c.dtype)
    nm_planes = np.zeros((G, k, P), bool)
    vcls = np.flatnonzero(valid_c)
    for g in range(G):  # padding rows too: they carry row 0's values, as explain_batch's do
        pl = planes_c[g][:, :C]  # [4, C]
        sc = score_c[g][:C]
        elim[g] = (vcounts[None, :] * ~pl).sum(axis=1)
        feasible[g] = int((vcounts * pl.all(axis=0)).sum())
        for p in range(P):
            relaxed = pl.copy()
            relaxed[p] = True
            would[g, p] = bool((valid_c & relaxed.all(axis=0)).any())
        # Top-k replay of the node-level argmax+mask rounds: classes by
        # (score desc, lowest member); take classes until k members are
        # covered, then extend through the boundary score's tie group,
        # since members of equal-score classes interleave by node row.
        m = 0
        if vcls.size:
            o = vcls[np.lexsort((rep[vcls], -sc[vcls]))]
            taken = 0
            i = 0
            while i < o.size and taken < k:
                taken += counts[o[i]]
                i += 1
            while i < o.size and sc[o[i]] == sc[o[i - 1]]:
                i += 1
            chosen = o[:i]
            mem_nodes = np.concatenate([order[off[c] : off[c] + counts[c]] for c in chosen])
            mem_cls = np.repeat(chosen, counts[chosen])
            sidx = np.lexsort((mem_nodes, -sc[mem_cls]))[:k]
            nodes, cls = mem_nodes[sidx], mem_cls[sidx]
            m = nodes.size
            nm_idx[g, :m] = nodes
            nm_score[g, :m] = sc[cls]
            nm_planes[g, :m] = pl[:, cls].T
        if m < k:
            # argmax over an all -inf ranking returns row 0: the pad entry
            # is node 0's raw score and planes, repeated
            c0 = inv[0]
            nm_idx[g, m:] = 0
            nm_score[g, m:] = sc[c0]
            nm_planes[g, m:] = pl[:, c0]
    return tuple(torch.from_numpy(x) for x in (elim, feasible, would, nm_idx, nm_score, nm_planes))


def _score_planes_np(a, idle, rel, used, ntasks, nports, t: int):
    """The twin's plane and score math for one task row, host numpy
    (numpy's divide already rounds correctly)."""
    fdtype = a["task_req"].dtype
    req = a["task_req"][t]
    fits_idle = np.all(req[None, :] < idle + a["eps"][None, :], axis=1)
    fits_rel = np.all(req[None, :] < rel + a["eps"][None, :], axis=1)
    has_sc = a["task_has_sc"][t]
    fits_idle = fits_idle & ~(has_sc & ~a["node_idle_has_sc"])
    fits_rel = fits_rel & ~(has_sc & ~a["node_rel_has_sc"])
    resources = fits_idle | fits_rel
    static_ok = a["node_ok"] & a["compat"][a["task_gid"][t], a["node_gid"]]
    room = ntasks < a["node_max_tasks"]
    ports = ~np.any(a["task_ports"][t][None, :] & nports, axis=1)
    planes = np.stack([static_ok, room, ports, resources])  # [4, N]

    res = a["task_res"][t]
    req_cpu = used[:, 0] + res[0]
    req_mem = used[:, 1] + res[1]
    cap_cpu = a["node_alloc"][:, 0]
    cap_mem = a["node_alloc"][:, 1]

    def least_dim(rq, cp):
        safe = np.where(cp == 0, 1.0, cp)
        sc = np.floor((cp - rq) * MAX_PRIORITY / safe).astype(np.int32)
        return np.where((cp == 0) | (rq > cp), 0, sc)

    least = (least_dim(req_cpu, cap_cpu) + least_dim(req_mem, cap_mem)) // 2
    cpu_f = np.where(cap_cpu != 0, req_cpu / np.where(cap_cpu == 0, 1.0, cap_cpu), 1.0)
    mem_f = np.where(cap_mem != 0, req_mem / np.where(cap_mem == 0, 1.0, cap_mem), 1.0)
    balanced = np.where(
        (cpu_f >= 1.0) | (mem_f >= 1.0),
        0,
        (MAX_PRIORITY - np.abs(cpu_f - mem_f) * MAX_PRIORITY).astype(np.int32),
    )
    score = (
        least.astype(fdtype) * np.asarray(a["w_least"], fdtype)
        + balanced.astype(fdtype) * np.asarray(a["w_balanced"], fdtype)
        + a["aff_sc"][a["task_gid"][t], a["node_gid"]].astype(fdtype) * np.asarray(a["w_aff"], fdtype)
    )
    return planes, score


def explain_rows_np(a, idle, rel, used, ntasks, nports, rep_rows, topk: int = 3):
    """The serial twin: the same numbers, computed task by task with host
    numpy (the correctness-oracle side of explain parity)."""
    valid = np.asarray(a["node_valid"], bool)
    G = len(rep_rows)
    k = int(topk)
    elim = np.zeros((G, len(PLANES)), np.int32)
    feasible = np.zeros(G, np.int32)
    would = np.zeros((G, len(PLANES)), bool)
    nm_idx = np.zeros((G, k), np.int32)
    nm_score = np.zeros((G, k), np.float64)
    nm_planes = np.zeros((G, k, len(PLANES)), bool)
    for g, t in enumerate(rep_rows):
        if t < 0:
            continue
        planes, score = _score_planes_np(a, idle, rel, used, ntasks, nports, int(t))
        elim[g] = np.sum(valid[None, :] & ~planes, axis=1)
        feasible[g] = np.sum(valid & np.all(planes, axis=0))
        for p in range(len(PLANES)):
            relaxed = planes.copy()
            relaxed[p] = True
            would[g, p] = bool(np.any(valid & np.all(relaxed, axis=0)))
        ranked = np.where(valid, score, -np.inf)
        for j in range(k):
            i = int(np.argmax(ranked))
            nm_idx[g, j] = i
            nm_score[g, j] = score[i]
            nm_planes[g, j] = planes[:, i]
            ranked[i] = -np.inf
    return elim, feasible, would, nm_idx, nm_score, nm_planes


# -- the pass's inputs on the solver's device ---------------------------------


def uploaded_inputs(arrays: dict, state, device) -> tuple[dict, tuple]:
    """The pass's inputs on ``device`` from the host arrays and a fetched
    SolveState (CPU tensors): the ``ARRAY_KEYS`` subset, the weights and
    the five state fields, uploaded (shared, not copied, on the CPU)."""
    return _as_inputs(arrays, (state.idle, state.rel, state.used, state.ntasks, state.nports), device)


def fused_inputs(solver, arrays: dict) -> tuple[dict, tuple]:
    """The pass's inputs from a ``FusedSolver`` after its last segment:
    kernel B1's packed statics and final state buffers, read where they
    lie (the card, or the CPU for a ``device: cpu`` rung). The packed
    static verdict (``compat[:, node_gid] & node_ok & node_valid``) stands
    in for ``node_ok & compat`` with the node axis as its own group axis;
    it agrees on every node, since a padded node is never ``node_ok``.
    ``node_valid`` is the first ``n`` rows. B1's affinity table carries
    ``w_aff`` (and ``pod_sc``, when live InterPodAffinity scores were
    folded in: then the table without them is uploaded)."""
    from kube_batch_tpu_torch.ops.fused_solve import _ports_bool

    packed, ps = solver.packed, solver.device_state
    if ps is None:
        raise ValueError("fused_inputs: the solver has not solved")
    d = packed.dims
    v = packed.views()
    s = ps.views()
    dev = packed.istatic.device
    T, N, C, GT, R = d.T, d.N, d.C, d.GT, d.R
    cls = v["tcls"].long()
    pod_sc = np.asarray(arrays["pod_sc"])
    if pod_sc.ndim == 2 and pod_sc.any():
        f32 = np.float32
        node_gid = np.asarray(arrays["node_gid"], np.int64)
        aff = torch.from_numpy(np.asarray(arrays["aff_sc"], f32)[:, node_gid] * f32(arrays["w_aff"])).to(dev)
    else:
        aff = v["affw"].view(GT, N)
    n_valid = int(np.asarray(arrays["node_valid"]).sum())
    node_alloc = v["nalloc"].view(2, N).T
    f32 = torch.float32
    a = dict(
        task_req=v["creq"].view(R, C).T[cls],
        task_res=v["cres"].view(R, C).T[cls],
        task_gid=v["cgid"][cls],
        task_has_sc=v["chs"][cls] != 0,
        task_ports=_ports_bool(v["cpt"][cls], d.P),
        node_ok=torch.ones(N, dtype=torch.bool, device=dev),
        node_valid=torch.arange(N, device=dev) < n_valid,
        node_gid=torch.arange(N, dtype=torch.int32, device=dev),
        node_max_tasks=v["nmax"],
        node_alloc=node_alloc,
        node_idle_has_sc=v["nihs"] != 0,
        node_rel_has_sc=v["nrhs"] != 0,
        compat=v["cnode"].view(GT, N) != 0,
        aff_sc=aff,
        eps=v["eps"],
        w_least=v["wts"][0],
        w_balanced=v["wts"][1],
        w_aff=torch.ones((), dtype=f32, device=dev),
    )
    state = (
        s["idle"].view(R, N).T,
        s["rel"].view(R, N).T,
        s["used"].view(R, N).T,
        s["ntasks"],
        _ports_bool(s["nports"], d.P),
    )
    return a, state
