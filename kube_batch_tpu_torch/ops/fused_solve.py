"""The whole allocate solve in one CUDA launch: packer, driver, kernel
wrapper and its plain version.

The kernel (csrc/fused_solve.cu) runs the same algorithm, the same policy
and the same float32 arithmetic as the torch twin (ops/kernels.py
``solve_allocate_step``): the entire loop of dependent iterations runs in
one launch of one persistent thread-block cluster, each CTA a shard of the
node axis with its node state in shared memory (``solve_geometry``), so an
iteration costs a sweep and one cluster barrier instead of a host round
trip.

Layout (the kernel's own; the reference's [R8, N/128, 128] folding exists
only for the TPU's lane rules and is not kept):

- tasks dedup into *classes* — unique (req, res, group, flags, ports)
  rows; a 50k-pod snapshot collapses to a handful — so the kernel reads a
  ``[T]`` class id plus ``[R, C]`` class tables;
- node, job and queue vectors are ``[R, X]`` (one row per resource dim, so
  neighbouring threads read neighbouring nodes);
- the static compat verdict and the pre-weighted affinity score are
  expanded per node, ``[GT, N]``;
- all statics live in one int32 and one float32 buffer, all state in one
  int32 and one float32 buffer: two uploads per solve, and two fetches
  at the end.

``fused_solve(packed, state)`` launches the kernel when the buffers lie on
a CUDA device and runs ``fused_solve_plain`` — the twin's loop over the
same packed inputs — when they lie on the CPU.
"""

from __future__ import annotations

import collections
import ctypes
import time
from dataclasses import dataclass

import numpy as np
import torch

from kube_batch_tpu_torch import faults, native
from kube_batch_tpu_torch.ops import encode_cache, nvcc
from kube_batch_tpu_torch.ops.cluster import CTA_WIDTH, ClusterShape, cluster_shape
from kube_batch_tpu_torch.ops.kernels import SolveState, init_state, solve_allocate_step

R8 = 8  # largest resource rank the kernel takes (cpu, memory, <= 6 scalars)
MAX_PORTS = 31  # host ports ride an int32 bitmask per node
_INT32_MAX = np.iinfo(np.int32).max
SMEM_OPTIN = 232_448  # the most shared memory one H100 CTA may take (227 KB)
SMEM_STATIC = 4_096  # kept back for the kernel's static shared memory (1,792 B)
SMEM_BUDGET = SMEM_OPTIN - SMEM_STATIC  # dynamic shared memory per CTA


@dataclass(frozen=True)
class Dims:
    T: int  # task rows (encoder-padded)
    N: int  # node rows
    J: int  # job rows
    Q: int  # queue rows
    C: int  # task classes
    GT: int  # task groups
    R: int  # resource rank
    P: int  # host-port columns of the encoder
    max_iter: int
    drf: bool
    proportion: bool

    def istatic(self) -> list[tuple[str, int]]:
        T, N, J, Q, C, GT, R = self.T, self.N, self.J, self.Q, self.C, self.GT, self.R
        return [
            ("tcls", T), ("cgid", C), ("chs", C), ("crhs", C), ("cho", C), ("cpt", C),
            ("cnode", GT * N), ("nmax", N), ("nihs", N), ("nrhs", N),
            ("jstart", J), ("jend", J), ("jmin", J), ("jprio", J), ("jqueue", J),
            ("qdim", R * Q), ("drfd", R),
        ]

    def fstatic(self) -> list[tuple[str, int]]:
        N, Q, C, GT, R = self.N, self.Q, self.C, self.GT, self.R
        return [
            ("creq", R * C), ("cres", R * C), ("affw", GT * N), ("nalloc", 2 * N),
            ("qdes", R * Q), ("eps", R), ("drft", R), ("wts", 2),
        ]

    def istate(self) -> list[tuple[str, int]]:
        T, N, J, Q = self.T, self.N, self.J, self.Q
        return [
            ("scal", 8), ("tnode", T), ("tkind", T), ("tpos", T),
            ("jptr", J), ("jready", J), ("jactive", J),
            ("ntasks", N), ("nports", N), ("qdropped", Q), ("qcount", Q), ("qahs", Q),
        ]

    def fstate(self) -> list[tuple[str, int]]:
        N, J, Q, R = self.N, self.J, self.Q, self.R
        return [("idle", R * N), ("rel", R * N), ("used", R * N), ("jalloc", R * J), ("qalloc", R * Q)]


def _offsets(spec: list[tuple[str, int]]) -> tuple[dict[str, tuple[int, int]], int]:
    out, off = {}, 0
    for name, n in spec:
        out[name] = (off, n)
        off += n
    return out, off


def _views(buf: torch.Tensor, spec: list[tuple[str, int]]) -> dict[str, torch.Tensor]:
    offs, total = _offsets(spec)
    if buf.shape != (total,):
        raise ValueError(f"buffer of shape {tuple(buf.shape)}, layout needs ({total},)")
    return {name: buf[o : o + n] for name, (o, n) in offs.items()}


def _ports_mask(ports_bool: np.ndarray) -> np.ndarray:
    """[X, P] bool -> int32 bitmask (P <= 31)."""
    P = ports_bool.shape[1]
    bits = (1 << np.arange(P, dtype=np.int64))[None, :]
    return (ports_bool.astype(np.int64) * bits).sum(axis=1).astype(np.int32)


def _ports_bool(mask: torch.Tensor, P: int) -> torch.Tensor:
    bits = 1 << torch.arange(P, dtype=torch.int64, device=mask.device)
    return (mask.long()[:, None] & bits[None, :]) != 0


_CLASS_KEYS = (
    "task_req", "task_res", "task_gid", "task_has_sc",
    "task_res_has_sc", "task_host_only", "task_ports",
)


def _class_inverse(a: dict):
    """Dedup tasks into classes by (req, res, gid, flags, ports): returns
    (tports, first_indices, inverse). Any consistent (first, inverse)
    pairing is equivalent — class order carries no meaning in the packed
    layout. The native ``class_dedup`` (one O(T) hash pass) numbers
    classes in first-occurrence order, ``np.unique`` (its twin, with the
    native module off or the ``native.class_dedup`` fault fired) in
    sorted-key order: the packed class tables differ, the solve's binds
    and SolveState do not."""
    n = {k: np.asarray(a[k]) for k in _CLASS_KEYS}
    tports = _ports_mask(n["task_ports"])
    key = np.ascontiguousarray(
        np.concatenate(
            [
                n["task_req"].astype(np.float64),
                n["task_res"].astype(np.float64),
                n["task_gid"].astype(np.float64)[:, None],
                n["task_has_sc"].astype(np.float64)[:, None],
                n["task_res_has_sc"].astype(np.float64)[:, None],
                n["task_host_only"].astype(np.float64)[:, None],
                tports.astype(np.float64)[:, None],
            ],
            axis=1,
        )
    )
    lib = native.get()
    if lib is not None and not faults.should_fire("native.class_dedup"):
        try:
            first_b, inv_b = lib.class_dedup(key)
        except Exception as e:  # noqa: BLE001 -- np.unique gives an equivalent pairing
            native.note_fallback("class_dedup", e)
        else:
            native.note_call("class_dedup")
            first = np.frombuffer(first_b, np.int64)
            inv = np.frombuffer(inv_b, np.int32).astype(np.int64)
            return tports, first, inv
    void = key.view(np.dtype((np.void, key.dtype.itemsize * key.shape[1])))
    _, first, inv = np.unique(void.ravel(), return_index=True, return_inverse=True)
    return tports, first, inv.reshape(-1)


@dataclass(frozen=True)
class SolveGeometry:
    """The kernel's cluster and each CTA's dynamic shared memory: the node
    slice's mutable state, (3R + 2) words per node, and, where it fits
    beside it, the replicated job, queue and class state (``rep_words``;
    otherwise that lives in the CTA's slice of a global scratch buffer)."""

    shape: ClusterShape
    node_words: int
    rep_words: int
    rep_in_smem: bool

    @property
    def smem_bytes(self) -> int:
        return 4 * (self.node_words + (self.rep_words if self.rep_in_smem else 0))


def _rep_words(J: int, Q: int, C: int, R: int) -> int:
    """Words of one CTA's replicated state (the kernel's ``rep_layout``):
    7 int and R + 1 float vectors over jobs, 3 int and 3R int or float
    over queues, 5 int and 2 x 8 float (request and resource rows padded
    to R8) over classes."""
    return J * (8 + R) + Q * (3 + 3 * R) + C * (5 + 2 * R8)


def solve_geometry(dims: Dims) -> SolveGeometry:
    """One cluster of k = ceil(N / 512) CTAs (at most 16) of 512 threads,
    each owning ceil(N / k) nodes. Raises ValueError when a CTA's node
    slice does not fit its shared memory (``SMEM_BUDGET``): the kernel's
    own limit, which neither plain version nor the block step shares, so
    only the kernel's launch asks for it."""
    shape = cluster_shape(dims.N, threads=CTA_WIDTH)
    node_words = (3 * dims.R + 2) * shape.slice
    if 4 * node_words > SMEM_BUDGET:
        raise ValueError(
            f"{dims.N} nodes over a cluster of {shape.k} CTAs leave {shape.slice} nodes per CTA, "
            f"whose state at resource rank {dims.R} needs {4 * node_words} B of shared memory; "
            f"the fused-solve kernel's limit is {SMEM_BUDGET} B per CTA"
        )
    rep_words = _rep_words(dims.J, dims.Q, dims.C, dims.R)
    return SolveGeometry(shape, node_words, rep_words, 4 * (node_words + rep_words) <= SMEM_BUDGET)


def check_envelope(dims: Dims) -> None:
    """The packed layout's limits, which the kernels and their plain
    versions share: resource rank <= 8 (per-task vectors live in
    registers), <= 31 distinct host ports (an int32 bitmask per node), and
    every packed buffer indexable by int32. Raises ValueError naming the
    limit that does not hold. The fused-solve kernel's shared-memory limit
    is ``solve_geometry``'s."""
    if dims.R > R8:
        raise ValueError(f"resource rank {dims.R} exceeds the kernel's limit of {R8}")
    if dims.P > MAX_PORTS:
        raise ValueError(f"{dims.P} host ports exceed the kernel's limit of {MAX_PORTS}")
    for spec in (dims.istatic(), dims.fstatic(), dims.istate(), dims.fstate()):
        total = _offsets(spec)[1]
        if total > _INT32_MAX:
            raise ValueError(
                f"a packed buffer of {total} elements exceeds the int32 index limit"
            )


def fold_affinity_scores(a: dict) -> np.ndarray:
    """[GT, N] combined static score term: preferred node-affinity plus live
    InterPodAffinity, each pre-weighted (the kernel adds it unscaled).
    Recomputed by FusedSolver.solve when the caller refreshes a["pod_sc"]."""
    f32 = np.float32
    node_gid = np.asarray(a["node_gid"], np.int64)
    full = np.asarray(a["aff_sc"], f32)[:, node_gid] * f32(a["w_aff"])
    pod_sc = np.asarray(a["pod_sc"], f32)
    if pod_sc.ndim == 2 and pod_sc.any():
        full = full + pod_sc * f32(a["w_podaff"])
    return full


@dataclass
class Packed:
    """The kernel's static inputs: one int32 and one float32 buffer."""

    dims: Dims
    istatic: torch.Tensor
    fstatic: torch.Tensor

    def to(self, device) -> "Packed":
        return Packed(self.dims, self.istatic.to(device), self.fstatic.to(device))

    def views(self) -> dict[str, torch.Tensor]:
        return {**_views(self.istatic, self.dims.istatic()), **_views(self.fstatic, self.dims.fstatic())}


@dataclass
class PackedState:
    """The kernel's in/out state: one int32 and one float32 buffer."""

    dims: Dims
    istate: torch.Tensor
    fstate: torch.Tensor

    def views(self) -> dict[str, torch.Tensor]:
        return {**_views(self.istate, self.dims.istate()), **_views(self.fstate, self.dims.fstate())}


def pack(a: dict, enable_drf: bool, enable_proportion: bool) -> Packed:
    """Lay the encoder's SoA snapshot out in the kernel's buffers (CPU);
    raises ValueError out of the kernel's envelope."""
    n = {k: np.asarray(v) for k, v in a.items()}
    T, R = n["task_req"].shape
    N = n["node_idle"].shape[0]
    J = n["job_min"].shape[0]
    Q = n["queue_rank"].shape[0]
    GT = n["compat"].shape[0]
    tports, first, inv = _class_inverse(n)
    dims = Dims(
        T=T, N=N, J=J, Q=Q, C=first.shape[0], GT=GT, R=R, P=n["task_ports"].shape[1],
        max_iter=T + J + Q + 1 + int(n["task_host_only"].sum()),
        drf=bool(enable_drf), proportion=bool(enable_proportion),
    )
    check_envelope(dims)
    p = Packed(
        dims,
        torch.zeros(_offsets(dims.istatic())[1], dtype=torch.int32),
        torch.zeros(_offsets(dims.fstatic())[1], dtype=torch.float32),
    )
    v = {k: t.numpy() for k, t in p.views().items()}
    v["tcls"][:] = inv
    v["creq"][:] = n["task_req"][first].T.ravel()
    v["cres"][:] = n["task_res"][first].T.ravel()
    v["cgid"][:] = n["task_gid"][first]
    v["chs"][:] = n["task_has_sc"][first]
    v["crhs"][:] = n["task_res_has_sc"][first]
    v["cho"][:] = n["task_host_only"][first]
    v["cpt"][:] = tports[first]
    node_gid = n["node_gid"].astype(np.int64)
    okv = n["node_ok"] & n["node_valid"]
    v["cnode"][:] = (n["compat"][:, node_gid] & okv[None, :]).ravel()
    v["affw"][:] = fold_affinity_scores(n).ravel()
    v["nalloc"][:] = n["node_alloc"][:, :2].T.ravel()
    v["nmax"][:] = n["node_max_tasks"]
    v["nihs"][:] = n["node_idle_has_sc"]
    v["nrhs"][:] = n["node_rel_has_sc"]
    for name, key in (("jstart", "job_start"), ("jend", "job_end"), ("jmin", "job_min"),
                      ("jprio", "job_prio"), ("jqueue", "job_queue")):
        v[name][:] = n[key]
    v["qdes"][:] = n["q_deserved"].T.ravel()
    v["qdim"][:] = n["q_dims"].T.ravel()
    v["eps"][:] = n["eps"]
    if enable_drf:
        v["drft"][:] = n["drf_total"]
        v["drfd"][:] = n["drf_dims"]
    v["wts"][0] = n["w_least"].item()
    v["wts"][1] = n["w_balanced"].item()
    return p


def pack_state(dims: Dims, s: SolveState, job_queue: torch.Tensor) -> PackedState:
    """SolveState (CPU tensors) -> the kernel's state buffers (CPU)."""
    ps = PackedState(
        dims,
        torch.zeros(_offsets(dims.istate())[1], dtype=torch.int32),
        torch.zeros(_offsets(dims.fstate())[1], dtype=torch.float32),
    )
    v = ps.views()
    active = s.job_active.bool()
    v["scal"][:5] = torch.tensor([int(s.it), int(s.step), int(s.cur), -1, int(active.sum())])
    v["tnode"].copy_(s.assigned_node)
    v["tkind"].copy_(s.assigned_kind)
    v["tpos"].copy_(s.assign_pos)
    v["jptr"].copy_(s.ptr)
    v["jready"].copy_(s.ready_cnt)
    v["jactive"].copy_(active)
    v["ntasks"].copy_(s.ntasks)
    v["nports"].copy_(torch.from_numpy(_ports_mask(s.nports.numpy())))
    v["qdropped"].copy_(s.q_dropped)
    v["qcount"].copy_(torch.bincount(job_queue.long()[active], minlength=dims.Q)[: dims.Q])
    v["qahs"].copy_(s.q_alloc_has_sc)
    for name, x in (("idle", s.idle), ("rel", s.rel), ("used", s.used),
                    ("jalloc", s.job_alloc), ("qalloc", s.q_alloc)):
        v[name].copy_(x.T.reshape(-1))
    return ps


def _twin_arrays(packed: Packed) -> dict:
    """The twin's arrays dict over the packed statics: class tables gathered
    back to tasks, [R, X] rows transposed, the compat and affinity terms
    already expanded per node (node_gid = identity) with the affinity
    weight folded in (w_aff = 1, pod_sc = 0: adding 0 * 0 leaves every
    score unchanged)."""
    d = packed.dims
    v = packed.views()
    T, N, J, Q, C, GT, R = d.T, d.N, d.J, d.Q, d.C, d.GT, d.R
    cls = v["tcls"].long()
    node_alloc = torch.zeros(N, R, dtype=torch.float32)
    node_alloc[:, :2] = v["nalloc"].view(2, N).T
    ones = torch.ones(N, dtype=torch.bool)
    f32 = torch.float32
    return dict(
        task_req=v["creq"].view(R, C).T[cls],
        task_res=v["cres"].view(R, C).T[cls],
        task_gid=v["cgid"][cls],
        task_has_sc=v["chs"][cls] != 0,
        task_res_has_sc=v["crhs"][cls] != 0,
        task_host_only=v["cho"][cls] != 0,
        task_ports=_ports_bool(v["cpt"][cls], d.P),
        node_alloc=node_alloc,
        node_ok=ones,
        node_valid=ones,
        node_max_tasks=v["nmax"],
        node_idle_has_sc=v["nihs"] != 0,
        node_rel_has_sc=v["nrhs"] != 0,
        node_gid=torch.arange(N, dtype=torch.int32),
        compat=v["cnode"].view(GT, N) != 0,
        aff_sc=v["affw"].view(GT, N),
        pod_sc=torch.zeros(GT, N, dtype=f32),
        job_start=v["jstart"],
        job_end=v["jend"],
        job_min=v["jmin"],
        job_prio=v["jprio"],
        job_rank=torch.arange(J, dtype=torch.int32),
        job_queue=v["jqueue"],
        queue_rank=torch.arange(Q, dtype=torch.int32),
        q_deserved=v["qdes"].view(R, Q).T,
        q_dims=v["qdim"].view(R, Q).T != 0,
        drf_total=v["drft"],
        drf_dims=v["drfd"] != 0,
        eps=v["eps"],
        w_least=v["wts"][0],
        w_balanced=v["wts"][1],
        w_aff=torch.tensor(1.0, dtype=f32),
        w_podaff=torch.tensor(0.0, dtype=f32),
    )


def _state_of(ps: PackedState) -> SolveState:
    """The kernel's state buffers (CPU) -> a SolveState of CPU tensors."""
    d = ps.dims
    v = ps.views()
    R = d.R
    scal = v["scal"]
    return SolveState(
        it=scal[0].clone(),
        step=scal[1].clone(),
        cur=scal[2].clone(),
        ptr=v["jptr"].clone(),
        assigned_node=v["tnode"].clone(),
        assigned_kind=v["tkind"].clone(),
        assign_pos=v["tpos"].clone(),
        idle=v["idle"].view(R, d.N).T.contiguous(),
        rel=v["rel"].view(R, d.N).T.contiguous(),
        used=v["used"].view(R, d.N).T.contiguous(),
        ntasks=v["ntasks"].clone(),
        nports=_ports_bool(v["nports"], d.P),
        ready_cnt=v["jready"].clone(),
        job_active=v["jactive"] != 0,
        q_dropped=v["qdropped"] != 0,
        job_alloc=v["jalloc"].view(R, d.J).T.contiguous(),
        q_alloc=v["qalloc"].view(R, d.Q).T.contiguous(),
        q_alloc_has_sc=v["qahs"] != 0,
        paused_at=scal[3].clone(),
    )


def fused_solve_plain(packed: Packed, state: PackedState, work: dict | None = None) -> PackedState:
    """Plain version of the kernel: the twin's loop over the same packed
    inputs, updating `state` in place as the kernel does. ``work`` is the
    twin's node-axis work counter (see ``solve_allocate_step``)."""
    d = packed.dims
    v = packed.views()
    s = solve_allocate_step(_twin_arrays(packed), _state_of(state), d.drf, d.proportion, work)
    out = pack_state(d, s, v["jqueue"])
    out.views()["scal"][3] = int(s.paused_at)
    state.istate.copy_(out.istate)
    state.fstate.copy_(out.fstate)
    return state


# -- the CUDA kernel: build, bind, launch -----------------------------------

_PTR_FIELDS = (
    "tcls", "cgid", "chs", "crhs", "cho", "cpt", "cnode", "nmax", "nihs", "nrhs",
    "jstart", "jend", "jmin", "jprio", "jqueue", "qdim", "drfd",
    "creq", "cres", "affw", "nalloc", "qdes", "eps", "drft", "wts",
    "scal", "tnode", "tkind", "tpos", "jptr", "jready", "jactive",
    "ntasks", "nports", "qdropped", "qcount", "qahs",
    "idle", "rel", "used", "jalloc", "qalloc",
)
_DIM_FIELDS = ("T", "N", "J", "Q", "C", "GT", "R", "max_iter", "drf", "proportion")
_GEOMETRY_FIELDS = ("k", "S", "smem_bytes", "rep_words", "rep_in_smem")


class _Args(ctypes.Structure):
    """Mirror of `struct SolveArgs` in csrc/fused_solve.cu (same order)."""

    _fields_ = (
        [(f, ctypes.c_int) for f in _DIM_FIELDS + _GEOMETRY_FIELDS]
        + [(f, ctypes.c_void_p) for f in _PTR_FIELDS]
        + [("scratch", ctypes.c_void_p)]
    )


def _bind(lib) -> None:
    lib.kbt_fused_solve.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_void_p]
    lib.kbt_fused_solve.restype = ctypes.c_int
    lib.kbt_fused_solve_max_clusters.argtypes = [
        ctypes.POINTER(_Args), ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    ]
    lib.kbt_fused_solve_max_clusters.restype = ctypes.c_int


_library = nvcc.Library("fused_solve", _bind)
_fits_card: set[tuple[int, int, int]] = set()  # (device, k, shared bytes) checked


def _launch_args(d: Dims) -> tuple[SolveGeometry, _Args]:
    """The launch's geometry and its argument block, pointers unset."""
    geo = solve_geometry(d)
    args = _Args(
        **{f: int(getattr(d, f)) for f in _DIM_FIELDS},
        k=geo.shape.k, S=geo.shape.slice, smem_bytes=geo.smem_bytes,
        rep_words=geo.rep_words, rep_in_smem=int(geo.rep_in_smem),
    )
    return geo, args


def _check_occupancy(index: int, args: _Args) -> None:
    """Raise unless device ``index`` can hold the solve's cluster (asked
    once per device, cluster size and shared-memory size)."""
    key = (index, args.k, args.smem_bytes)
    if key in _fits_card:
        return
    n = ctypes.c_int(0)
    err = _library.load().kbt_fused_solve_max_clusters(ctypes.byref(args), index, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"fused_solve occupancy query failed: {_library.error(err)}")
    if n.value < 1:
        raise RuntimeError(
            f"cuda:{index} cannot hold a cluster of {args.k} CTAs of {CTA_WIDTH} threads "
            f"with {args.smem_bytes} B of shared memory each"
        )
    _fits_card.add(key)


def _check(packed: Packed, state: PackedState) -> str:
    """Validate the buffers; returns the device type they share."""
    bufs = (packed.istatic, packed.fstatic, state.istate, state.fstate)
    dtypes = (torch.int32, torch.float32, torch.int32, torch.float32)
    for b, dt in zip(bufs, dtypes):
        if b.dtype != dt:
            raise TypeError(f"buffer of dtype {b.dtype}, expected {dt}")
        if b.dim() != 1 or not b.is_contiguous():
            raise ValueError("packed buffers must be contiguous 1-d tensors")
    devices = {b.device for b in bufs}
    if len(devices) != 1:
        raise ValueError(f"packed buffers on several devices: {sorted(map(str, devices))}")
    if packed.dims != state.dims:
        raise ValueError("state was packed for other dims than the statics")
    packed.views()  # shape check against the layout
    state.views()
    return bufs[0].device.type


def fused_solve(packed: Packed, state: PackedState) -> PackedState:
    """Run the whole solve, updating `state` in place. CUDA buffers launch
    the kernel on their device's current stream (asynchronously, whatever
    device is current); CPU buffers run the
    plain version. Any other device raises."""
    kind = _check(packed, state)
    if kind == "cpu":
        return fused_solve_plain(packed, state)
    if kind != "cuda":
        raise ValueError(f"fused_solve runs on cuda or cpu, not {kind}")
    lib = _library.load()
    geo, args = _launch_args(packed.dims)
    for name, view in {**packed.views(), **state.views()}.items():
        setattr(args, name, view.data_ptr())
    device = packed.istatic.device
    index = torch.cuda.current_device() if device.index is None else device.index
    if not geo.rep_in_smem:
        # freed on return: the caching allocator hands it out again only to
        # work queued on this stream after the kernel
        scratch = torch.empty(geo.shape.k * geo.rep_words, dtype=torch.int32, device=device)
        args.scratch = scratch.data_ptr()
    _check_occupancy(index, args)
    stream = torch.cuda.current_stream(index).cuda_stream
    err = lib.kbt_fused_solve(ctypes.byref(args), index, stream)
    if err != 0:
        raise RuntimeError(f"fused_solve launch failed: {_library.error(err)}")
    fused_solve.launches += 1
    fused_solve.launches_by_card[index] += 1
    return state


fused_solve.launches = 0
fused_solve.launches_by_card = collections.Counter()  # the same launches by card index


class FusedSolver:
    """Per-solve driver: pack once, then solve / resume.

    Speaks the twin's `SolveState` protocol: `solve(state)` takes and
    returns a SolveState of CPU tensors, with `paused_at >= 0` when the
    solve stopped at a host-only task. The state comes back in two
    fetches, one integer and one float buffer.

    With ``arena`` (an ops/encode_cache ``TensorArena``) the two static
    buffers go up through it as ``fused_istatic`` and ``fused_fstatic``:
    resident across cycles, reused when unchanged and row updated (a row
    is an element) when little changed. The affinity refresh then packs a
    new host ``fstatic`` and uploads it through the arena too, so the
    device buffer and the arena's memo never disagree.
    """

    def __init__(
        self,
        a: dict,
        enable_drf: bool,
        enable_proportion: bool,
        device: str | torch.device | None = None,
        arena=None,
    ) -> None:
        self.a = a
        self.enable_drf = enable_drf
        self.enable_proportion = enable_proportion
        self.device = torch.device("cuda" if device is None else device)
        self.arena = arena
        self._pod_sc = a["pod_sc"]  # identity marker for refresh
        host = pack(a, enable_drf, enable_proportion)
        if arena is None:
            self.packed = host.to(self.device)
        else:
            self._host_fstatic = host.fstatic
            self.packed = Packed(
                host.dims,
                encode_cache.put(arena, "fused_istatic", host.istatic.numpy(), self.device),
                encode_cache.put(arena, "fused_fstatic", host.fstatic.numpy(), self.device),
            )
        if self.device.type == "cuda":
            # the kernel's shared-memory limit and the card's room for its
            # cluster: a snapshot outside them raises here, before any solve
            index = torch.cuda.current_device() if self.device.index is None else self.device.index
            _check_occupancy(index, _launch_args(self.packed.dims)[1])
        self.timings: dict[str, float] = {}  # seconds per phase of the last solve
        # the last solve's state buffers on the solver's device, before
        # the fetch (ops/explain.py's forensics read them in place)
        self.device_state: PackedState | None = None

    def solve(self, state: SolveState | None = None) -> SolveState:
        p = self.packed
        if self.a["pod_sc"] is not self._pod_sc:
            # live InterPodAffinity scores were refreshed between segments:
            # re-fold just the affinity static
            self._pod_sc = self.a["pod_sc"]
            affw = torch.from_numpy(fold_affinity_scores(self.a).ravel())
            if self.arena is None:
                p.views()["affw"].copy_(affw)
            else:
                # a new host buffer (the arena's memo is never written),
                # uploaded through the arena: its changed elements only
                fstatic = self._host_fstatic.clone()
                _views(fstatic, p.dims.fstatic())["affw"].copy_(affw)
                self._host_fstatic = fstatic
                p.fstatic = encode_cache.put(self.arena, "fused_fstatic", fstatic.numpy(), self.device)
        t0 = time.perf_counter()
        if state is None:
            state = init_state(self.a, self.enable_drf, self.enable_proportion)
        host = pack_state(p.dims, state, torch.as_tensor(np.asarray(self.a["job_queue"])))
        ps = PackedState(p.dims, host.istate.to(self.device), host.fstate.to(self.device))
        t1 = time.perf_counter()
        fused_solve(p, ps)
        if ps.istate.is_cuda:
            torch.cuda.synchronize(ps.istate.device)
        t2 = time.perf_counter()
        host.istate.copy_(ps.istate)
        host.fstate.copy_(ps.fstate)
        self.device_state = ps
        out = _state_of(host)
        self.timings = {"state_upload_s": t1 - t0, "fused_solve_s": t2 - t1, "fetch_s": time.perf_counter() - t2}
        return out
