"""Node-class compressed solve (``KBT_CLASS_COMPRESS``, default off).

Large fleets hold few distinct node *shapes* (capacity, labels and
taints, idle vector), so the node axis the solver scans every gang
iteration is mostly redundant. This module folds interchangeable nodes
into equivalence classes and runs feasibility, score and arg-max at class
granularity:

- The per-node class key is byte-exact over every array the solve's fit
  and score read (idle, releasing, used, capacity, pod count, port mask,
  static-feasibility bits, label/affinity group, the live InterPodAffinity
  column): two nodes share a class iff the uncompressed solve could not
  tell them apart.
- Dedup runs through the native ``class_dedup`` hash pass (multi-buffer
  keys) with a widened ``np.unique`` fallback behind the
  ``native.class_dedup`` fault point.
- The segment loop, ``class_step``, follows the uncompressed loop
  (``ops/kernels.solve_allocate_step``) operation for operation over the
  slot axis, with a multiplicity per slot. Selection is the lex arg-min of
  (-score, lowest member node row), which is the uncompressed arg-max's
  first-row tie-break, so placement is bind-for-bind identical.
- **Dynamic splitting**: a bind changes only the chosen node, so that
  member splits off into a fresh singleton slot (statics copied, the
  task's deltas applied) while its parent loses one member and advances
  its member cursor. The slot axis is padded to a sticky power-of-two
  bucket; slot exhaustion stops the segment without committing the
  iteration, the host re-buckets to the next power of two and resumes.
- At segment boundaries (a host-only task's pause, the segment budget,
  the next cycle's encode) the table regroups from the node-space state:
  split members whose rows re-converged **re-merge**, and a node whose
  static key changed is re-keyed (``class_table_splits_total``).

``class_step`` launches kernel B3 (csrc/class_step.cu: one persistent CTA
runs a whole segment) for CUDA tensors and runs ``class_step_plain``, the
plain torch version, for CPU tensors. ``ClassCompressedSolver`` speaks the
node-space ``SolveState`` at every boundary, so the action's pause loop,
host step, replay and explain run unchanged; with a mesh the class table
lives on the mesh's first device. ``wrap_solver`` puts the layer over the
action's rungs.

``python -m kube_batch_tpu_torch.ops.class_solve --json`` runs the seeded
self-check on the card (``--device cpu``: on the CPU).
"""

from __future__ import annotations

import contextlib
import ctypes
import logging
import os
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from kube_batch_tpu_torch import faults, metrics, native
from kube_batch_tpu_torch.ops import nvcc
from kube_batch_tpu_torch.ops.carry import arrays_from_numpy
from kube_batch_tpu_torch.ops.kernels import (
    KIND_ALLOCATED,
    KIND_PIPELINED,
    SolveState,
    _le_eps,
    _lex_argmin,
    init_state,
    node_scores,
    select_queue_job,
)
from kube_batch_tpu_torch.ops.nvcc import KernelBuildError

ENV = "KBT_CLASS_COMPRESS"
_ON_WORDS = ("1", "true", "on", "yes")

log = logging.getLogger(__name__)

R8 = 8  # the kernel's largest resource rank
MAX_PORTS = 31  # host ports ride an int32 bitmask per slot in the kernel
SMEM_OPTIN = 232_448  # the most shared memory one H100 CTA may take (227 KB)
SMEM_BUDGET = SMEM_OPTIN - 4_096  # kept back for the kernel's static shared memory
MAX_THREADS = 1024


def enabled() -> bool:
    return os.environ.get(ENV, "").strip().lower() in _ON_WORDS


def _pow2(n: int) -> int:
    return max(8, 1 << (max(int(n), 1) - 1).bit_length())


def _np(x) -> np.ndarray:
    """A host array of a tensor (any device) or an array-like."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- multi-slab row dedup -----------------------------------------------------


def _as_rows(slab) -> np.ndarray:
    """Byte-exact [N, k] uint8 view of one key slab (1-D slabs become one
    column). Views require contiguity; the copy is taken at most once."""
    s = np.ascontiguousarray(slab)
    if s.ndim == 1:
        s = s.reshape(-1, 1)
    return s.view(np.uint8).reshape(s.shape[0], -1)


def dedup_rows(slabs) -> tuple[np.ndarray, np.ndarray]:
    """Dedup rows over the concatenated byte spans of ``slabs`` (each [N]
    or [N, k], equal row counts): returns (first int64 per class, inverse
    int32 per row). The native ``class_dedup`` multi-buffer hash pass when
    the module is there (one O(N) pass, no concatenation), else the
    widened np.unique void-sort. Class *order* differs between the two
    (first occurrence against sorted) and carries no meaning: callers
    derive representatives from member lists, never from ids."""
    mats = [_as_rows(s) for s in slabs]
    n = mats[0].shape[0]
    if any(m.shape[0] != n for m in mats):
        raise ValueError("dedup_rows slabs disagree on row count")
    lib = native.get()
    if lib is not None and not faults.should_fire("native.class_dedup"):
        try:
            first_b, inv_b = lib.class_dedup(mats[0] if len(mats) == 1 else tuple(mats))
        except Exception as e:  # noqa: BLE001 -- np.unique gives an equivalent partition
            native.note_fallback("class_dedup", e)
        else:
            native.note_call("class_dedup")
            return np.frombuffer(first_b, np.int64), np.frombuffer(inv_b, np.int32)
    key = np.ascontiguousarray(np.concatenate(mats, axis=1))
    void = key.view(np.dtype((np.void, key.shape[1])))
    _, first, inv = np.unique(void.ravel(), return_index=True, return_inverse=True)
    return first.astype(np.int64), inv.astype(np.int32).ravel()


# -- cross-cycle static class table -------------------------------------------

_STATIC_KEYS = (
    "node_alloc",
    "node_ok",
    "node_valid",
    "node_max_tasks",
    "node_idle_has_sc",
    "node_rel_has_sc",
    "node_gid",
)


class ClassTable:
    """The persistent half of the compression: static per-node keys
    (capacity, feasibility bits, label/affinity group) deduped once, then
    delta-refreshed: a churned node's changed row is dropped from its class
    and re-keyed through the key dict (re-merging with any class already
    holding that key), without re-hashing the fleet. Class ids are stable
    across cycles; the sticky power-of-two slot bucket lives here so warm
    cycles keep the kernel's slot axis.

    The table lives on the action, and in-process federation runs one
    action object from several scheduling threads: one lock covers each
    method, and ``refresh_static`` returns the ids it computed, not the
    table's (another thread's snapshot may replace them next)."""

    def __init__(self) -> None:
        self.key_bytes: np.ndarray | None = None  #: guarded_by _lock ([N, K] uint8)
        self.class0_of: np.ndarray | None = None  #: guarded_by _lock ([N] int32 stable static ids)
        self.key_to_id: dict[bytes, int] = {}  #: guarded_by _lock
        self.sticky_cpad = 8  #: guarded_by _lock
        self.rekeys_total = 0  #: guarded_by _lock (static-key churn, encode-cache dirty nodes)
        self.splits_total = 0  #: guarded_by _lock (in-solve bind splits)
        self.remerges_total = 0  #: guarded_by _lock
        self.rebuilds = 0  #: guarded_by _lock
        self._prev_singleton: np.ndarray | None = None  #: guarded_by _lock ([N] bool at last solve end)
        self._lock = threading.RLock()

    def _next_id_locked(self, key: bytes) -> int:
        cid = self.key_to_id.get(key)
        if cid is None:
            cid = len(self.key_to_id)
            self.key_to_id[key] = cid
        return cid

    def refresh_static(self, arrays: dict) -> tuple[np.ndarray, int]:
        """Return ([N] stable static class ids, re-keyed row count)."""
        mats = [_as_rows(_np(arrays[k])) for k in _STATIC_KEYS]
        key = np.ascontiguousarray(np.concatenate(mats, axis=1))
        with self._lock:
            if self.key_bytes is None or self.key_bytes.shape != key.shape or self.class0_of is None:
                # cold (or a re-bucketed fleet): one dedup pass, ids minted in
                # class order so a later warm refresh maps changed rows only
                first, inv = dedup_rows([key])
                ids = np.fromiter((self._next_id_locked(key[r].tobytes()) for r in first), np.int32, count=len(first))
                self.class0_of = ids[inv]
                self.key_bytes = key
                self.rebuilds += 1
                self._prev_singleton = None
                return self.class0_of, 0
            changed = np.nonzero(np.any(self.key_bytes != key, axis=1))[0]
            if changed.size:
                out = self.class0_of.copy()
                for r in changed:
                    out[r] = self._next_id_locked(key[r].tobytes())
                self.class0_of = out
                self.key_bytes = key
                self.rekeys_total += int(changed.size)
            return self.class0_of, int(changed.size)

    def note_end(self, slot_of_end: np.ndarray) -> None:
        counts = np.bincount(slot_of_end, minlength=int(slot_of_end.max()) + 1)
        with self._lock:
            self._prev_singleton = counts[slot_of_end] == 1

    def note_regroup(self, slot_of: np.ndarray, counts: np.ndarray) -> int:
        """Re-merge accounting: nodes that sat in singleton slots at the
        last solve end and now share a multi-member class again."""
        with self._lock:
            prev = self._prev_singleton
            if prev is None or prev.shape != slot_of.shape:
                return 0
            merged = int(np.count_nonzero(prev & (counts[slot_of] > 1)))
            self.remerges_total += merged
            return merged

    def grow_cpad(self, cpad: int) -> int:
        """Raise the sticky bucket to at least ``cpad``; returns it."""
        with self._lock:
            self.sticky_cpad = max(self.sticky_cpad, int(cpad))
            return self.sticky_cpad

    def add_splits(self, n: int) -> None:
        with self._lock:
            self.splits_total += int(n)


# -- the class-granularity segment --------------------------------------------


class ClassSolveState(NamedTuple):
    """``SolveState`` with the node axis folded to slot granularity plus
    the split machinery (multiplicity, member cursor, free slot pointer).
    Job, queue and task fields keep their ``SolveState`` names so
    ``select_queue_job`` reads this state unchanged. Tensors, all on one
    device; scalars are 0-d."""

    it: torch.Tensor
    step: torch.Tensor
    cur: torch.Tensor
    ptr: torch.Tensor
    assigned_node: torch.Tensor
    assigned_kind: torch.Tensor
    assign_pos: torch.Tensor
    # slot-granular node state (mutable within a segment)
    cidle: torch.Tensor  # [C, R] float32
    crel: torch.Tensor
    cused: torch.Tensor
    cntasks: torch.Tensor  # [C] int32
    cnports: torch.Tensor  # [C, P] bool
    # slot-granular statics (copied to the child on split)
    calloc: torch.Tensor  # [C, R]
    cok: torch.Tensor  # [C] bool (node_ok & node_valid)
    cmax_tasks: torch.Tensor
    cidle_has_sc: torch.Tensor
    crel_has_sc: torch.Tensor
    cgid: torch.Tensor
    cpod_sc: torch.Tensor  # [GT, C] live InterPodAffinity columns
    # split machinery
    cmult: torch.Tensor  # [C] members remaining (0 = dead slot)
    ctie: torch.Tensor  # [C] lowest member node row (the tie-break key)
    cpos: torch.Tensor  # [C] absolute cursor into members_sorted
    free_ptr: torch.Tensor  # first free slot
    overflow: torch.Tensor  # bool: slot bucket exhausted, host must re-bucket
    seg_it: torch.Tensor  # iterations burned in this segment (re-pack cap)
    # job/queue state, the SolveState layout
    ready_cnt: torch.Tensor
    job_active: torch.Tensor
    q_dropped: torch.Tensor
    job_alloc: torch.Tensor
    q_alloc: torch.Tensor
    q_alloc_has_sc: torch.Tensor
    paused_at: torch.Tensor


# ClassSolveState's slot-axis fields (cpod_sc's slot axis is its second).
SLOT_FIELDS = (
    "cidle", "crel", "cused", "cntasks", "cnports", "calloc", "cok", "cmax_tasks", "cidle_has_sc",
    "crel_has_sc", "cgid", "cpod_sc", "cmult", "ctie", "cpos",
)

# ClassSolveState's dtypes (the kernel's argument block reads these).
_STATE_DTYPES = {
    **{f: torch.int32 for f in (
        "it", "step", "cur", "ptr", "assigned_node", "assigned_kind", "assign_pos", "cntasks",
        "cmax_tasks", "cgid", "cmult", "ctie", "cpos", "free_ptr", "seg_it", "ready_cnt", "paused_at",
    )},
    **{f: torch.float32 for f in ("cidle", "crel", "cused", "calloc", "cpod_sc", "job_alloc", "q_alloc")},
    **{f: torch.bool for f in (
        "cnports", "cok", "cidle_has_sc", "crel_has_sc", "overflow", "job_active", "q_dropped",
        "q_alloc_has_sc",
    )},
}


def _fit_score_block(
    cidle, crel, cused, cntasks, cnports, calloc, cok, cmax_tasks,
    cidle_has_sc, crel_has_sc, cgid, cpod_col,
    req, res, tports, t_has_sc, eps, compat_t, aff_t,
    w_least, w_balanced, w_aff, w_podaff,
):
    """The per-iteration fit and score over the slot axis: the exact
    operations of the uncompressed loop's feasibility and score
    (``ops/kernels.solve_allocate_step``, ``node_scores``), in the
    reference's order. Returns (fits_idle, fits_rel, hard_ok, score)."""
    fits_idle = _le_eps(req, cidle, eps) & ~(t_has_sc & ~cidle_has_sc)
    fits_rel = _le_eps(req, crel, eps) & ~(t_has_sc & ~crel_has_sc)
    gid = cgid.long()
    static_ok = cok & compat_t[gid]
    room = cntasks < cmax_tasks
    port_ok = ~(tports[None, :] & cnports).any(dim=1)
    least, balanced = node_scores(cused, calloc, res)
    fdtype = cidle.dtype
    score = (
        least.to(fdtype) * w_least
        + balanced.to(fdtype) * w_balanced
        + aff_t[gid] * w_aff
        + cpod_col * w_podaff
    )
    return fits_idle, fits_rel, static_ok & room & port_ok, score


def max_iterations(ca: dict) -> int:
    """The loop's iteration bound: T + J + Q + 1 plus one paused iteration
    per host-only task."""
    return (
        ca["task_req"].shape[0] + ca["job_min"].shape[0] + ca["queue_rank"].shape[0] + 1
        + int(ca["task_host_only"].sum())
    )


def class_step_plain(
    ca: dict, cs: ClassSolveState, enable_drf: bool, enable_proportion: bool, seg_budget: int,
    work: dict | None = None,
) -> ClassSolveState:
    """Plain version of kernel B3: one segment at class granularity, as a
    host loop over torch ops on CPU tensors. Runs until every job is
    retired, a host-only task pauses it, the slot bucket overflows, or
    ``seg_budget`` iterations elapse. The budget bounds split-driven
    fragmentation: each bind to a fresh node splits a singleton, so a long
    segment degenerates toward node granularity; capping the segment
    forces a host re-pack that re-merges equivalent occupied nodes. An
    overflowing iteration commits nothing. The JAX package's blocked mesh
    form does the same elementwise operations block by block, so it is
    this flat one. The caller's tensors are not modified.

    ``work``, when given, accumulates what the segment needs of the slot
    axis: ``fit_slots`` (live slots whose fit had to be tested: statically
    compatible, with pod room and free ports) and ``scored_slots``
    (candidates that had to be scored), summed over the popped tasks, and
    ``selections``, the iterations that selected a queue and job."""
    T = ca["task_req"].shape[0]
    C = cs.cmult.shape[0]
    N = ca["members_sorted"].shape[0]
    task_req, task_res = ca["task_req"], ca["task_res"]
    task_gid, task_has_sc = ca["task_gid"], ca["task_has_sc"]
    task_res_has_sc, task_ports = ca["task_res_has_sc"], ca["task_ports"]
    task_host_only = ca["task_host_only"]
    compat, aff_sc = ca["compat"], ca["aff_sc"]
    members_sorted = ca["members_sorted"]
    job_end, job_min, job_queue = ca["job_end"], ca["job_min"], ca["job_queue"]
    eps = ca["eps"]
    fdtype = task_req.dtype
    w_least, w_balanced, w_aff, w_podaff = (
        torch.tensor(float(ca[k]), dtype=fdtype) for k in ("w_least", "w_balanced", "w_aff", "w_podaff")
    )
    max_iter = max_iterations(ca)

    s = ClassSolveState(*(x.clone() for x in cs))
    it, step, cur = int(s.it), int(s.step), int(s.cur)
    free_ptr, seg_it, paused, overflow = int(s.free_ptr), 0, -1, False
    job_active = s.job_active

    while (cur >= 0 or bool(job_active.any())) and it < max_iter and seg_it < seg_budget and paused < 0:
        new_cur = cur
        if cur < 0:
            if work is not None:
                work["selections"] = work.get("selections", 0) + 1
            qsel, q_any, overused, jsel, j_any = select_queue_job(ca, s, enable_drf, enable_proportion)
            if q_any and overused:
                # The overused queue retires all its jobs for the cycle. A
                # dropped queue leaves no current job, so this iteration
                # cannot overflow and the drop always commits.
                job_active &= job_queue != qsel
                s.q_dropped[qsel] = True
            new_cur = jsel if (q_any and not overused and j_any) else -1

        cur_c = max(new_cur, 0)
        t = int(s.ptr[cur_c])
        t_any = new_cur >= 0 and t < int(job_end[cur_c])
        t = min(t, T - 1)
        drop = new_cur >= 0 and not t_any
        pause = t_any and bool(task_host_only[t])
        proc = t_any and not pause
        assign = abandon = False

        if proc:
            gid = int(task_gid[t])
            res = task_res[t]
            fits_idle, fits_rel, hard_ok, score = _fit_score_block(
                s.cidle, s.crel, s.cused, s.cntasks, s.cnports, s.calloc, s.cok, s.cmax_tasks,
                s.cidle_has_sc, s.crel_has_sc, s.cgid, s.cpod_sc[gid],
                task_req[t], res, task_ports[t], bool(task_has_sc[t]), eps, compat[gid], aff_sc[gid],
                w_least, w_balanced, w_aff, w_podaff,
            )
            cand = (s.cmult > 0) & hard_ok & (fits_idle | fits_rel)
            if work is not None:
                work["fit_slots"] = work.get("fit_slots", 0) + int(((s.cmult > 0) & hard_ok).sum())
                work["scored_slots"] = work.get("scored_slots", 0) + int(cand.sum())
            any_cand = bool(cand.any())
            abandon = not any_cand
            if any_cand:
                # max score, then lowest member node row: the uncompressed
                # arg-max's first-row tie-break, since every member of a
                # slot shares the score and ctie is the slot's lowest row
                cb, _ = _lex_argmin(cand.numpy(), (-score).numpy(), s.ctie.numpy())
                ns = int(s.cmult[cb]) > 1
                if ns and free_ptr >= C:
                    overflow = True  # the iteration commits nothing
                    break
                assign = True
                do_alloc = bool(fits_idle[cb])
                nb_node = int(s.ctie[cb])  # the concrete node this assignment consumes
                zero = torch.zeros_like(res)
                new_rows = (
                    s.cidle[cb] + (-res if do_alloc else zero),
                    s.crel[cb] + (zero if do_alloc else -res),
                    s.cused[cb] + res,
                    s.cntasks[cb] + 1,
                    s.cnports[cb] | task_ports[t],
                )
                dyn = (s.cidle, s.crel, s.cused, s.cntasks, s.cnports)
                if ns:
                    # the consumed member becomes a fresh singleton slot with
                    # the parent's statics; the parent advances its cursor
                    f = free_ptr
                    for arr, row in zip(dyn, new_rows):
                        arr[f] = row
                    for arr in (s.calloc, s.cok, s.cmax_tasks, s.cidle_has_sc, s.crel_has_sc, s.cgid):
                        arr[f] = arr[cb]
                    s.cpod_sc[:, f] = s.cpod_sc[:, cb]
                    s.cmult[cb] -= 1
                    s.cmult[f] = 1
                    s.ctie[cb] = members_sorted[min(int(s.cpos[cb]) + 1, N - 1)]
                    s.ctie[f] = nb_node
                    s.cpos[cb] += 1
                    free_ptr += 1
                else:  # multiplicity 1: the slot is the node
                    for arr, row in zip(dyn, new_rows):
                        arr[cb] = row
                # -- bookkeeping, as the uncompressed loop's ----------------
                if do_alloc:
                    s.ready_cnt[cur_c] += 1
                s.assigned_node[t] = nb_node
                s.assigned_kind[t] = KIND_ALLOCATED if do_alloc else KIND_PIPELINED
                s.assign_pos[t] = step
                if enable_drf:
                    s.job_alloc[cur_c] += res
                if enable_proportion:
                    qcur = int(job_queue[cur_c])
                    s.q_alloc[qcur] += res
                    if bool(task_res_has_sc[t]):
                        s.q_alloc_has_sc[qcur] = True
            s.ptr[cur_c] += 1

        if drop or abandon:
            job_active[cur_c] = False
            new_cur = -1
        elif proc and int(s.ready_cnt[cur_c]) >= int(job_min[cur_c]):
            new_cur = -1
        cur = new_cur
        paused = t if pause else -1
        it += 1
        seg_it += 1
        step += int(assign)

    def scalar(v: int) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.int32)

    return s._replace(
        it=scalar(it), step=scalar(step), cur=scalar(cur), free_ptr=scalar(free_ptr),
        overflow=torch.tensor(overflow), seg_it=scalar(seg_it), paused_at=scalar(paused),
    )


# -- kernel B3: build, bind, launch -------------------------------------------

# ca's fields, in the kernel's argument order, with the dtype each is read as.
_CA_FIELDS = (
    ("task_req", torch.float32), ("task_res", torch.float32), ("task_gid", torch.int32),
    ("task_has_sc", torch.bool), ("task_res_has_sc", torch.bool), ("task_host_only", torch.bool),
    ("task_ports", torch.bool), ("job_end", torch.int32), ("job_min", torch.int32),
    ("job_queue", torch.int32), ("job_prio", torch.int32), ("job_rank", torch.int32),
    ("queue_rank", torch.int32), ("q_deserved", torch.float32), ("q_dims", torch.bool),
    ("drf_total", torch.float32), ("drf_dims", torch.bool), ("compat", torch.bool),
    ("aff_sc", torch.float32), ("eps", torch.float32), ("members_sorted", torch.int32),
)
_DIM_FIELDS = (
    "T", "N", "J", "Q", "C", "GT", "GN", "R", "P", "max_iter", "drf", "proportion", "seg_budget",
    "in_smem", "smem_bytes", "nthreads",
)


class _Args(ctypes.Structure):
    """Mirror of ``struct ClassArgs`` in csrc/class_step.cu (same order)."""

    _fields_ = (
        [(f, ctypes.c_int) for f in _DIM_FIELDS]
        + [(f, ctypes.c_float) for f in ("w_least", "w_balanced", "w_aff", "w_podaff")]
        + [(f, ctypes.c_void_p) for f, _ in _CA_FIELDS]
        + [(f, ctypes.c_void_p) for f in ClassSolveState._fields]
        + [("scratch", ctypes.c_void_p)]
    )


def _bind(lib) -> None:
    lib.kbt_class_step.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_void_p]
    lib.kbt_class_step.restype = ctypes.c_int


_library = nvcc.Library("class_step", _bind)


def slot_words(R: int) -> int:
    """32-bit words of the kernel's working state per slot: idle, releasing
    and used rows, pod count, port mask, multiplicity, tie row and member
    cursor, and the statics the sweep reads (the two capacity columns, the
    feasibility bit, the pod cap, the two scalar-map flags, the group)."""
    return 3 * R + 11


def geometry(C: int, Q: int, R: int) -> tuple[int, int, bool]:
    """(threads, working-state bytes, in shared memory): one CTA of one
    thread per slot, at least 128 and at most 1,024 (a stride past that);
    the working state of every slot and the per-queue active-job counts in
    shared memory where they fit, else in a global scratch buffer."""
    threads = min(MAX_THREADS, max(128, -(-C // 32) * 32))
    nbytes = 4 * (slot_words(R) * C + Q)
    return threads, nbytes, nbytes <= SMEM_BUDGET


class ClassKernelError(RuntimeError):
    """Kernel B3 refused its inputs or failed on a card (a refused launch
    or an error at the state fetch). Not a class-table failure: the action
    raises it as its ``DeviceSolveError`` instead of degrading."""


class ClassTableError(RuntimeError):
    """A host-side failure of the class table, the row dedup, the numpy
    re-pack or the expansion: the one organic failure ``wrap_solver``
    degrades to the uncompressed rung."""


@contextlib.contextmanager
def _host_side(what: str):
    """Re-raise a failure of the host-side step ``what`` as
    ``ClassTableError``; device work stays outside such a block."""
    try:
        yield
    except ClassTableError:
        raise
    except Exception as e:
        raise ClassTableError(f"{what}: {type(e).__name__}: {e}") from e


def class_step(
    ca: dict, cs: ClassSolveState, enable_drf: bool, enable_proportion: bool, seg_budget: int,
    max_iter: int,
) -> ClassSolveState:
    """One class-compressed segment. CUDA tensors launch kernel B3 on their
    device's current stream and return a new state on that device (the
    input is not modified); CPU tensors run ``class_step_plain``. A build
    failure raises ``KernelBuildError``; any other device, inputs the
    kernel refuses and a launch failure raise ``ClassKernelError``.
    ``max_iter`` is ``max_iterations`` of the snapshot, computed by the
    caller on the host: the launch itself reads nothing back from the
    card (the plain version computes its own)."""
    device = cs.cmult.device
    if device.type == "cpu":
        return class_step_plain(ca, cs, enable_drf, enable_proportion, seg_budget)
    if device.type != "cuda":
        raise ClassKernelError(f"class_step runs on cuda or cpu, not {device.type}")
    lib = _library.load()
    T, R = ca["task_req"].shape
    P = ca["task_ports"].shape[1]
    C = cs.cmult.shape[0]
    Q = ca["queue_rank"].shape[0]
    if R > R8:
        raise ClassKernelError(f"resource rank {R} exceeds the class kernel's limit of {R8}")
    if P > MAX_PORTS:
        raise ClassKernelError(f"{P} host ports exceed the class kernel's limit of {MAX_PORTS}")
    threads, nbytes, in_smem = geometry(C, Q, R)
    def ptr(x: torch.Tensor, dtype) -> int:
        if x.device != device or x.dtype != dtype or not x.is_contiguous():
            raise ClassKernelError(
                f"class_step: a {x.dtype} tensor on {x.device} (contiguous: {x.is_contiguous()}), "
                f"expected a contiguous {dtype} tensor on {device}"
            )
        return x.data_ptr()

    # the kernel updates the state in place: a copy, so the caller's is kept
    out = ClassSolveState(*(x.clone(memory_format=torch.contiguous_format) for x in cs))
    args = _Args(
        T=T, N=ca["members_sorted"].shape[0], J=ca["job_min"].shape[0], Q=Q, C=C,
        GT=ca["compat"].shape[0], GN=ca["compat"].shape[1], R=R, P=P,
        max_iter=int(max_iter),
        drf=int(bool(enable_drf)), proportion=int(bool(enable_proportion)), seg_budget=int(seg_budget),
        in_smem=int(in_smem), smem_bytes=nbytes, nthreads=threads,
        w_least=float(ca["w_least"]), w_balanced=float(ca["w_balanced"]),
        w_aff=float(ca["w_aff"]), w_podaff=float(ca["w_podaff"]),
    )
    for name, dtype in _CA_FIELDS:
        setattr(args, name, ptr(ca[name], dtype))
    for name in ClassSolveState._fields:
        setattr(args, name, ptr(getattr(out, name), _STATE_DTYPES[name]))
    if not in_smem:
        # freed on return: the caching allocator hands it out again only to
        # work queued on this stream after the kernel
        scratch = torch.empty(nbytes // 4, dtype=torch.int32, device=device)
        args.scratch = scratch.data_ptr()
    index = torch.cuda.current_device() if device.index is None else device.index
    stream = torch.cuda.current_stream(index).cuda_stream
    err = lib.kbt_class_step(ctypes.byref(args), index, stream)
    if err != 0:
        raise ClassKernelError(f"class_step launch failed: {_library.error(err)}")
    class_step.launches += 1
    return out


class_step.launches = 0


def grow_slots(cs: ClassSolveState, cpad: int) -> ClassSolveState:
    """``cs`` with its slot axis padded to ``cpad`` slots on its device, the
    new slots dead (multiplicity 0, the largest tie row) and the overflow
    flag cleared: the re-bucket's layout."""
    old = int(cs.cmult.shape[0])

    def grow(x, fill=0):
        out = torch.full((cpad,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
        out[:old] = x
        return out

    imax = int(np.iinfo(np.int32).max)
    pod = torch.zeros((cs.cpod_sc.shape[0], cpad), dtype=cs.cpod_sc.dtype, device=cs.cpod_sc.device)
    pod[:, :old] = cs.cpod_sc
    return cs._replace(
        cidle=grow(cs.cidle), crel=grow(cs.crel), cused=grow(cs.cused), cntasks=grow(cs.cntasks),
        cnports=grow(cs.cnports), calloc=grow(cs.calloc), cok=grow(cs.cok), cmax_tasks=grow(cs.cmax_tasks),
        cidle_has_sc=grow(cs.cidle_has_sc), crel_has_sc=grow(cs.crel_has_sc), cgid=grow(cs.cgid),
        cpod_sc=pod, cmult=grow(cs.cmult), ctie=grow(cs.ctie, fill=imax), cpos=grow(cs.cpos),
        overflow=torch.tensor(False, device=cs.overflow.device),
    )


# -- the wrapping solver ------------------------------------------------------

_CA_KEYS = (
    "task_req", "task_res", "task_gid", "task_has_sc", "task_res_has_sc",
    "task_ports", "task_host_only", "job_end", "job_min", "job_queue",
    "job_prio", "job_rank", "queue_rank", "q_deserved", "q_dims",
    "drf_total", "drf_dims", "compat", "aff_sc", "eps",
    "w_least", "w_balanced", "w_aff", "w_podaff",
)
_TASK_FIELDS = ("assigned_node", "assigned_kind", "assign_pos")


class ClassCompressedSolver:
    """The ``solve`` layer over a rung: takes and returns node-space
    ``SolveState`` (CPU tensors), compressing on entry and expanding on
    exit, so the action's pause loop, host step, replay and explain run
    unchanged. Regrouping happens only at segment boundaries; within a
    segment the kernel splits incrementally.

    ``rung`` is ``fused`` (the solve's device) or, with a mesh, ``sharded``:
    the class table on the mesh's first device. On a card the slot state
    stays on the device for the whole segment, and the task-axis fields
    for the whole solve. Host-side failures (the table, the dedup, the
    numpy re-pack and expansion) raise ``ClassTableError``; device work
    raises as it failed."""

    def __init__(
        self, table: ClassTable, arrays: dict, enable_drf: bool, enable_proportion: bool, mesh=None, device=None,
    ) -> None:
        self.table = table
        self.arrays = arrays
        self.enable_drf = bool(enable_drf)
        self.enable_proportion = bool(enable_proportion)
        self.mesh = tuple(mesh) if mesh is not None else None
        self.rung = "fused"
        if self.mesh is not None:
            self.rung = "sharded"
            device = self.mesh[0]
        self.device = torch.device("cpu" if device is None else device)
        # per-solve stats (the bench and metrics surface)
        self.class_count = 0
        self.classes_valid = 0
        self.compression_ratio = 0.0
        self.splits = 0
        self.remerges = 0
        self.rekeys = 0
        self.segments = 0
        self.group_s = 0.0
        self.kernel_s = 0.0
        self.c_pad = 0
        self.launches = 0  # B3 launches (or plain segments on the CPU)
        self.kernel_ms = 0.0  # B3's device time summed over segments (CUDA events)
        self._slot_of: np.ndarray | None = None
        self._entry_C = 0
        self._members_sorted: np.ndarray | None = None
        self._ca_base: dict | None = None
        self._max_iter: int | None = None  # the solve's iteration bound, on the host

    # -- node-space <-> class-space -----------------------------------------

    def _init_node_state(self) -> SolveState:
        """The fresh-solve entry, ``kernels.init_state`` over the arrays."""
        return init_state(arrays_from_numpy(self.arrays), self.enable_drf, self.enable_proportion)

    def _pack(self, st) -> ClassSolveState:
        """Regroup the current node-space state into slots and build the
        segment's state on the solver's device. Runs at segment boundaries
        only."""
        t0 = time.perf_counter()
        rows = tuple(_np(x) for x in (st.idle, st.rel, st.used, st.ntasks, st.nports))  # the device fetch
        with _host_side("the class re-pack"):
            slots, scalars = self._regroup(st, rows)
        dev = self.device
        fields = {}
        for name in ClassSolveState._fields:
            dtype = _STATE_DTYPES[name]
            if name in slots:
                fields[name] = torch.from_numpy(slots[name]).to(dev)
            elif name in scalars:
                fields[name] = torch.tensor(scalars[name], dtype=dtype, device=dev)
            elif name == "overflow":
                fields[name] = torch.tensor(False, device=dev)
            else:  # the job, queue and task fields, as they are
                x = getattr(st, name)
                x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
                fields[name] = x.to(device=dev, dtype=dtype).contiguous()
        self.group_s += time.perf_counter() - t0
        return ClassSolveState(**fields)

    def _regroup(self, st, rows: tuple) -> tuple[dict, dict]:
        """The re-pack's host side: re-key the table, dedup the node rows
        (``rows``: idle, releasing, used, pod count, ports; numpy) into
        slots and lay out the slot arrays (numpy) and the scalars."""
        a = self.arrays
        class0_of, rekeys = self.table.refresh_static(a)
        self.rekeys += rekeys
        idle, rel, used, ntasks, nports = rows
        pod_sc = _np(a["pod_sc"])
        N = idle.shape[0]
        first, inv = dedup_rows([
            class0_of.astype(np.int32), idle, rel, used, ntasks.astype(np.int32), nports,
            np.ascontiguousarray(pod_sc.T),
        ])
        C = int(len(first))
        slot_of = inv.astype(np.int32)
        counts = np.bincount(slot_of, minlength=C)
        self.remerges += self.table.note_regroup(slot_of, counts)
        order = np.argsort(slot_of, kind="stable").astype(np.int32)
        off = np.zeros(C, counts.dtype)
        np.cumsum(counts[:-1], out=off[1:])
        rep = order[off]  # lowest member row per slot (stable sort)

        cpad = min(_pow2(max(2 * C, C + 64, self.table.sticky_cpad)), _pow2(N))
        # N-scaled floor, as in the reference: the segment budget is
        # cpad // 2, so a large fleet gets long-enough segments; capped at
        # 1,024 slots
        cpad = max(cpad, _pow2(C), min(_pow2(N) // 16, 1024))
        cpad = self.table.grow_cpad(cpad)
        if self.segments == 0:
            self.class_count = C
            valid = _np(a["node_valid"]).astype(bool)
            self.classes_valid = int(valid[rep].sum())
            n_valid = int(valid.sum())
            self.compression_ratio = float(n_valid) / float(self.classes_valid) if self.classes_valid else 1.0
        self.c_pad = int(cpad)
        self._slot_of = slot_of
        self._entry_C = C
        self._members_sorted = order

        def pad1(x, fill=0):
            out = np.full((cpad,) + x.shape[1:], fill, x.dtype)
            out[:C] = x
            return out

        node_ok = _np(a["node_ok"]).astype(bool) & _np(a["node_valid"]).astype(bool)
        imax = np.iinfo(np.int32).max
        slots = dict(
            cidle=pad1(idle[rep]),
            crel=pad1(rel[rep]),
            cused=pad1(used[rep]),
            cntasks=pad1(ntasks[rep].astype(np.int32)),
            cnports=pad1(nports[rep].astype(bool)),
            calloc=pad1(_np(a["node_alloc"])[rep]),
            cok=pad1(node_ok[rep]),
            cmax_tasks=pad1(_np(a["node_max_tasks"]).astype(np.int32)[rep]),
            cidle_has_sc=pad1(_np(a["node_idle_has_sc"]).astype(bool)[rep]),
            crel_has_sc=pad1(_np(a["node_rel_has_sc"]).astype(bool)[rep]),
            cgid=pad1(_np(a["node_gid"]).astype(np.int32)[rep]),
            cpod_sc=np.ascontiguousarray(np.pad(pod_sc[:, rep], ((0, 0), (0, cpad - C))).astype(idle.dtype)),
            cmult=pad1(counts.astype(np.int32)),
            ctie=pad1(rep.astype(np.int32), fill=imax),
            cpos=pad1(off.astype(np.int32)),
        )
        scalars = dict(
            it=int(st.it), step=int(st.step), cur=int(st.cur), free_ptr=C, seg_it=0, paused_at=int(st.paused_at),
        )
        return slots, scalars

    def _ca(self) -> dict:
        """The segment's read-only inputs on the solver's device: the
        snapshot's task, job and queue arrays (uploaded once a solve) and
        the member list of this segment's grouping."""
        if self._ca_base is None:
            dtypes = dict(_CA_FIELDS)
            base = {}
            for k in _CA_KEYS:
                v = self.arrays[k]
                if k.startswith("w_"):
                    base[k] = float(v)
                    continue
                x = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
                base[k] = x.to(device=self.device, dtype=dtypes[k]).contiguous()
            self._ca_base = base
        ca = dict(self._ca_base)
        ca["members_sorted"] = torch.from_numpy(self._members_sorted).to(self.device)
        return ca

    def _rebucket(self, cs: ClassSolveState) -> ClassSolveState:
        """Slot bucket exhausted mid-solve: grow to the next power of two
        (bounded by the node bucket: slots never outnumber nodes) and
        resume. The kernel takes the slot count as an argument, so nothing
        is rebuilt; the sticky bucket keeps later cycles at the grown size."""
        old = int(cs.cmult.shape[0])
        N = int(self._slot_of.shape[0])
        new = min(_pow2(old * 2), _pow2(N))
        if new <= old:
            raise ClassTableError(f"class slot bucket cannot grow past {old} (nodes={N})")
        self.table.grow_cpad(new)
        log.warning("class slot bucket overflow: re-bucketing %d -> %d slots", old, new)
        return grow_slots(cs, new)

    def _expand(self, cs: ClassSolveState) -> SolveState:
        """Class state back to a node-space ``SolveState``: every node reads
        its slot's row (children first override their split origin). The
        task-axis fields stay where they are (on a card, the device until
        the solve returns)."""
        def host(x):
            return x.detach().cpu().clone()

        # the device fetch, then the host side
        fp = int(cs.free_ptr)
        ctie = _np(cs.ctie)
        rows = {f: _np(getattr(cs, f)) for f in ("cidle", "crel", "cused", "cntasks", "cnports")}
        with _host_side("the class expansion"):
            slot_of = self._slot_of.copy()
            if fp > self._entry_C:
                child = np.arange(self._entry_C, fp)
                slot_of[ctie[child]] = child
            self.splits += fp - self._entry_C
            self.table.add_splits(fp - self._entry_C)
            self.table.note_end(slot_of)
            node = {f: torch.from_numpy(x[slot_of]) for f, x in rows.items()}

        return SolveState(
            it=host(cs.it), step=host(cs.step), cur=host(cs.cur), ptr=host(cs.ptr),
            assigned_node=cs.assigned_node, assigned_kind=cs.assigned_kind, assign_pos=cs.assign_pos,
            idle=node["cidle"], rel=node["crel"], used=node["cused"], ntasks=node["cntasks"],
            nports=node["cnports"], ready_cnt=host(cs.ready_cnt), job_active=host(cs.job_active),
            q_dropped=host(cs.q_dropped), job_alloc=host(cs.job_alloc), q_alloc=host(cs.q_alloc),
            q_alloc_has_sc=host(cs.q_alloc_has_sc), paused_at=host(cs.paused_at),
        )

    # -- the solve surface ----------------------------------------------------

    def _segment(self, ca: dict, cs: ClassSolveState, seg_budget: int) -> ClassSolveState:
        """One B3 launch (or plain segment), its device time on a card."""
        if cs.cmult.device.type != "cuda":
            self.launches += 1
            return class_step(ca, cs, self.enable_drf, self.enable_proportion, seg_budget, self._max_iter)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = class_step(ca, cs, self.enable_drf, self.enable_proportion, seg_budget, self._max_iter)
        end.record()
        try:
            end.synchronize()  # an asynchronous CUDA error surfaces here
        except Exception as e:
            raise ClassKernelError(f"class_step failed on {cs.cmult.device}: {type(e).__name__}: {e}") from e
        self.launches += 1
        self.kernel_ms += start.elapsed_time(end)
        return out

    def solve(self, st=None) -> SolveState:
        if st is None:
            st = self._init_node_state()
        max_iter = self._max_iter = max_iterations(self.arrays)
        self._ca_base = None  # the arrays may differ from the last solve's
        while True:
            cs = self._pack(st)
            ca = self._ca()
            seg_budget = max(int(cs.cmult.shape[0]) // 2, 1)
            self.segments += 1
            t0 = time.perf_counter()
            while True:
                out = self._segment(ca, cs, seg_budget)
                if bool(out.overflow):
                    self.kernel_s += time.perf_counter() - t0
                    cs = self._rebucket(out)
                    seg_budget = max(int(cs.cmult.shape[0]) // 2, 1)
                    t0 = time.perf_counter()
                    continue
                break
            self.kernel_s += time.perf_counter() - t0
            st = self._expand(out)
            if (
                int(st.paused_at) >= 0
                or int(st.it) >= max_iter
                or (int(st.cur) < 0 and not bool(st.job_active.any()))
            ):
                return st._replace(**{f: getattr(st, f).detach().cpu() for f in _TASK_FIELDS})
            # segment budget exhausted mid-solve: loop back through _pack so
            # equivalent occupied nodes re-merge and the slot axis stays small

    def stats(self) -> dict:
        return {
            "class_count": int(self.class_count),
            "classes_valid": int(self.classes_valid),
            "compression_ratio": round(float(self.compression_ratio), 4),
            "splits": int(self.splits),
            "remerges": int(self.remerges),
            "rekeys": int(self.rekeys),
            "segments": int(self.segments),
            "c_pad": int(self.c_pad),
            "group_s": round(self.group_s, 6),
            "kernel_s": round(self.kernel_s, 6),
            "rung": self.rung,
        }


def wrap_solver(action, inner, arrays: dict, enable_drf: bool, enable_proportion: bool, mesh=None, device=None):
    """Wrap a rung's ``solve(state)`` with the class-compressed layer. The
    ``solve.class_table`` fault point (a poisoned or stale table) and a
    host-side failure of the table, the re-pack or the expansion
    (``ClassTableError``) degrade the call to ``inner``, logged and
    metered: the cycle completes and parity holds, since the solve is a
    function of its input state. Anything else raises: a kernel that
    cannot be built (``KernelBuildError``), kernel B3 refusing its inputs
    or failing on a card (``ClassKernelError``), and a device error of the
    uploads, each of which would fail every cycle."""
    table = getattr(action, "_class_table", None)
    if table is None:
        table = ClassTable()
        action._class_table = table
    solver = ClassCompressedSolver(table, arrays, enable_drf, enable_proportion, mesh=mesh, device=device)
    metered = [0]

    def solve_fn(st):
        try:
            if faults.should_fire("solve.class_table"):
                raise ClassTableError("fault point solve.class_table fired")
            out = solver.solve(st)
        except ClassTableError:
            log.exception(
                "class-compressed solve failed; degrading to the uncompressed %s rung for this segment",
                "sharded" if mesh is not None else "fused",
            )
            metrics.register_degraded_cycle("class_solve", "class_table")
            action.last_class_stats = None
            return inner(st)
        action.last_solver_tier = "class_" + solver.rung
        stats = solver.stats()
        stats["launches"] = solver.launches
        stats["kernel_ms"] = solver.kernel_ms
        action.last_class_stats = stats
        metrics.set_class_solve_classes(stats["class_count"])
        metrics.set_class_solve_compression_ratio(stats["compression_ratio"])
        delta = (stats["splits"] + stats["rekeys"]) - metered[0]
        if delta > 0:
            metrics.register_class_table_splits(delta)
        metered[0] = stats["splits"] + stats["rekeys"]
        return out

    solve_fn.solver = solver
    return solve_fn


# -- seeded self-check --------------------------------------------------------

_SMOKE_TIERS = """
actions: "torch_allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: predicates
  - name: nodeorder
"""


def _smoke_world(bound=None, arrivals=0, seed=7):
    """Heterogeneous node pools with heavy intra-pool duplication: four
    pool shapes x 18 identical nodes, a few pre-occupied residents (so
    classes are plural from the start), selector-confined and free gang
    jobs. ``bound`` (pod name -> node name) materializes a previous
    cycle's placements as running residents; ``arrivals`` appends fresh
    gangs so the next cycle has work: together they exercise
    split-then-re-merge across cycles."""
    import random

    from kube_batch_tpu_torch.apis.types import PodPhase
    from kube_batch_tpu_torch.testing import (
        build_cluster,
        build_node,
        build_pod,
        build_pod_group,
        build_queue,
        build_resource_list,
    )

    rng = random.Random(seed)
    pools = {
        "small": build_resource_list(cpu=8, memory="16Gi", pods=32),
        "medium": build_resource_list(cpu=16, memory="32Gi", pods=64),
        "large": build_resource_list(cpu=32, memory="65536Mi", pods=110),
        "tainted": build_resource_list(cpu=16, memory="32Gi", pods=64),
    }
    nodes = []
    for pool, alloc in pools.items():
        for i in range(18):
            nodes.append(build_node(f"{pool}-{i:03d}", dict(alloc), labels={"pool": pool}))
    bound = dict(bound or {})
    pods, pgs = [], []
    for j in range(12):
        name = f"gang-{j:03d}"
        members = rng.choice([3, 4, 6])
        pgs.append(build_pod_group(name, min_member=members))
        pool = rng.choice([None, "small", "medium", "large"])
        cpu = rng.choice(["500m", "1", "2"])
        for m in range(members):
            pod = build_pod(
                name=f"{name}-t{m}",
                group_name=name,
                req=build_resource_list(cpu=cpu, memory="1Gi"),
                node_selector={"pool": pool} if pool else None,
            )
            host = bound.pop(f"default/{name}-t{m}", None)
            if host is not None:
                pod.node_name = host
                pod.phase = PodPhase.RUNNING
            pods.append(pod)
    for j in range(arrivals):
        name = f"arrival-{j:03d}"
        pgs.append(build_pod_group(name, min_member=2))
        for m in range(2):
            pods.append(
                build_pod(name=f"{name}-t{m}", group_name=name, req=build_resource_list(cpu="1", memory="2Gi"))
            )
    # residents diversify the initial classes inside one pool
    for i in range(4):
        pods.append(
            build_pod(
                name=f"resident-{i}",
                node_name=f"medium-{i:03d}",
                phase=PodPhase.RUNNING,
                req=build_resource_list(cpu=2, memory="4Gi"),
            )
        )
    return build_cluster(pods, nodes, pgs, [build_queue("default")])


def _smoke_run(action, cluster, action_arguments=None):
    from kube_batch_tpu_torch.conf import parse_scheduler_conf
    from kube_batch_tpu_torch.framework import close_session, open_session
    from kube_batch_tpu_torch.testing import FakeCache

    tiers = parse_scheduler_conf(_SMOKE_TIERS).tiers
    cache = FakeCache(cluster)
    ssn = open_session(cache, tiers, action_arguments or {})
    try:
        action.execute(ssn)
    finally:
        close_session(ssn)
    return dict(cache.binder.binds)


def smoke(device: str = "cuda") -> dict:
    """Seeded self-check: the heterogeneous-pool world solved serial,
    uncompressed and compressed (torch_allocate on ``device``) with bind
    parity, across two cycles so in-solve splits and re-merges (at the
    segment re-packs and across cycles) both fire."""
    from kube_batch_tpu_torch.actions.allocate import AllocateAction
    from kube_batch_tpu_torch.actions.torch_allocate import TorchAllocateAction
    from kube_batch_tpu_torch.streaming import _check_device

    _check_device(device)
    args = {"torch_allocate": {"device": device, "min_device_pairs": "0"}}
    saved = os.environ.get(ENV)
    os.environ[ENV] = "0"
    try:
        serial_binds = _smoke_run(AllocateAction(), _smoke_world())
        plain = TorchAllocateAction()
        plain_binds = _smoke_run(plain, _smoke_world(), args)
        os.environ[ENV] = "1"
        comp = TorchAllocateAction()
        comp_binds = _smoke_run(comp, _smoke_world(), args)
        stats1 = dict(comp.last_class_stats or {})
        tier1 = comp.last_solver_tier

        # cycle 2: cycle-1 placements become running residents, fresh gangs
        # arrive; identical nodes that split in cycle 1 re-merge
        def world2():
            return _smoke_world(bound=comp_binds, arrivals=6)

        comp_binds2 = _smoke_run(comp, world2(), args)
        stats2 = dict(comp.last_class_stats or {})
        os.environ[ENV] = "0"
        plain_binds2 = _smoke_run(plain, world2(), args)
    finally:
        if saved is None:
            os.environ.pop(ENV, None)
        else:
            os.environ[ENV] = saved

    n_nodes = 4 * 18
    parity1 = serial_binds == plain_binds == comp_binds
    parity2 = plain_binds2 == comp_binds2
    # re-merges fire at the segment re-packs inside a solve and/or across
    # cycles: either is the mechanism working
    remerges = stats1.get("remerges", 0) + stats2.get("remerges", 0)
    ok = bool(
        parity1
        and parity2
        and tier1.startswith("class_")
        and stats1.get("class_count", n_nodes) < n_nodes
        and stats1.get("splits", 0) > 0
        and remerges > 0
    )
    return {
        "ok": ok,
        "binds": len(comp_binds),
        "binds_cycle2": len(comp_binds2),
        "parity_cycle1": parity1,
        "parity_cycle2": parity2,
        "tier": tier1,
        "class_count": stats1.get("class_count"),
        "compression_ratio": stats1.get("compression_ratio"),
        "splits": stats1.get("splits"),
        "remerges": remerges,
        "remerges_cycle2": stats2.get("remerges"),
        "cycle2": stats2,
    }


def main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(
        description="class-compressed solve smoke: heterogeneous pools, "
        "serial/uncompressed/compressed bind parity, split + re-merge"
    )
    parser.add_argument("--json", action="store_true", help="print the result as JSON")
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"), help="where torch_allocate solves (default: the card)",
    )
    args = parser.parse_args(argv)
    result = smoke(device=args.device)
    if args.json:
        print(json.dumps(result, sort_keys=True, default=str))
    else:
        status = "ok" if result["ok"] else "FAILED"
        print(
            f"class_solve smoke: {status} ({result['binds']} binds, "
            f"classes={result['class_count']}, "
            f"ratio={result['compression_ratio']}, "
            f"splits={result['splits']}, "
            f"remerges={result['remerges']})"
        )
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    # re-enter through the canonical module: `python -m` runs this file as
    # __main__, whose kernel counters and table would otherwise be other
    # objects than the ones the action imports
    from kube_batch_tpu_torch.ops.class_solve import main as _canonical_main

    raise SystemExit(_canonical_main())
