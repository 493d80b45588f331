"""The sharded solve's block step (kernel B2): wrapper and plain version.

One shard's half of one gang iteration: over the shard's node block, each
node's feasibility and score for the popped task, the block-local
first-index arg-max, and the fits-idle bit at the winner. The kernel is
csrc/block_step.cu; its node arithmetic is csrc/node_sweep.cuh, shared
with the fused solve's node sweep.

Layout (the port's; the reference's [R8, Nr_loc, 128] folding exists only
for the TPU's lane rules and is not kept): the block's node vectors are
``[R, N]`` rows for idle/releasing/used, ``[2, N]`` for the cpu and memory
allocatable, ``[GT, N]`` for the static compat verdict and the
pre-weighted affinity score, and ``[N]`` int32 for the pod limit, the
scalar-map flags, the pod count and the host-port bitmask.

The result is one record of four int32 words, written into a caller's
buffer on the block's device: the best score (float32 bits; -inf when no
node is a candidate), the winner's global index (local index + the
block's offset, or the sentinel), the fits-idle bit, and 0.

``block_step(block, task, out)`` (or a prepared ``BlockStep``) launches
the kernel when the block lies on a CUDA device and runs
``block_step_plain`` when it lies on the CPU.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from kube_batch_tpu_torch.ops import nvcc
from kube_batch_tpu_torch.ops.fused_solve import R8
from kube_batch_tpu_torch.ops.kernels import node_scores

RECORD = 4  # int32 words per block-step record


class Task(ctypes.Structure):
    """The popped task as the block step reads it (mirror of the
    ``TaskFields`` struct in csrc/block_step.cu): group id (clamped to the
    block's groups), scalar-request flag, host-port bitmask, and req, res
    and eps padded to R8, plus nodeorder's two weights."""

    _fields_ = [
        ("gid", ctypes.c_int), ("has_sc", ctypes.c_int), ("tports", ctypes.c_int), ("pad0", ctypes.c_int),
        ("req", ctypes.c_float * R8), ("res", ctypes.c_float * R8), ("eps", ctypes.c_float * R8),
        ("w_least", ctypes.c_float), ("w_bal", ctypes.c_float),
    ]


def make_task(gid, has_sc, tports, req, res, eps, w_least, w_bal) -> Task:
    """A Task from plain values; req/res/eps are sequences of R <= 8
    float32 values (pad dims are 0 for req/res and 1 for eps)."""
    R = len(req)
    if R > R8:
        raise ValueError(f"resource rank {R} exceeds the kernel's limit of {R8}")
    pad = R8 - R
    return Task(
        gid=int(gid), has_sc=int(bool(has_sc)), tports=int(tports), pad0=0,
        req=(ctypes.c_float * R8)(*req, *([0.0] * pad)),
        res=(ctypes.c_float * R8)(*res, *([0.0] * pad)),
        eps=(ctypes.c_float * R8)(*eps, *([1.0] * pad)),
        w_least=float(w_least), w_bal=float(w_bal),
    )


@dataclass
class Block:
    """One shard's node block on one device. ``off`` is the global index
    of its first node, ``sent`` the "no candidate" index (the global
    padded node count)."""

    cnode: torch.Tensor  # [GT, N] int32
    affw: torch.Tensor  # [GT, N] float32
    nalloc: torch.Tensor  # [2, N] float32
    nmax: torch.Tensor  # [N] int32
    nihs: torch.Tensor  # [N] int32
    nrhs: torch.Tensor  # [N] int32
    idle: torch.Tensor  # [R, N] float32
    rel: torch.Tensor  # [R, N] float32
    used: torch.Tensor  # [R, N] float32
    ntasks: torch.Tensor  # [N] int32
    nports: torch.Tensor  # [N] int32
    off: int
    sent: int

    _I32 = ("cnode", "nmax", "nihs", "nrhs", "ntasks", "nports")

    def check(self) -> torch.device:
        """Validate dtypes, shapes, contiguity and placement; returns the
        device every tensor shares."""
        GT, N = self.cnode.shape
        R = self.idle.shape[0]
        if not 1 <= R <= R8:
            raise ValueError(f"resource rank {R} outside 1..{R8}")
        shapes = {
            "cnode": (GT, N), "affw": (GT, N), "nalloc": (2, N),
            "idle": (R, N), "rel": (R, N), "used": (R, N),
            **{k: (N,) for k in ("nmax", "nihs", "nrhs", "ntasks", "nports")},
        }
        for name, shape in shapes.items():
            t = getattr(self, name)
            want = torch.int32 if name in self._I32 else torch.float32
            if t.dtype != want:
                raise TypeError(f"block.{name} of dtype {t.dtype}, expected {want}")
            if tuple(t.shape) != shape:
                raise ValueError(f"block.{name} of shape {tuple(t.shape)}, expected {shape}")
            if not t.is_contiguous():
                raise ValueError(f"block.{name} is not contiguous")
        devices = {getattr(self, k).device for k in shapes}
        if len(devices) != 1:
            raise ValueError(f"block tensors on several devices: {sorted(map(str, devices))}")
        if self.off < 0 or self.off + N > self.sent:
            raise ValueError(f"block [{self.off}, {self.off + N}) does not lie below the sentinel {self.sent}")
        return devices.pop()


def block_step_plain(block: Block, task: Task) -> tuple[float, int, int]:
    """Plain version of the kernel, the counterpart of the reference's
    ``block_step_jnp``: (best score or -inf, global index or the
    sentinel, fits-idle bit), in the twin's float32 operations."""
    f32 = torch.float32
    dev = block.idle.device
    R = block.idle.shape[0]
    req = torch.tensor(task.req[:R], dtype=f32, device=dev)[:, None]
    eps = torch.tensor(task.eps[:R], dtype=f32, device=dev)[:, None]
    res = torch.tensor(task.res[:R], dtype=f32, device=dev)
    fits_idle = (req < block.idle + eps).all(dim=0)
    fits_rel = (req < block.rel + eps).all(dim=0)
    if task.has_sc:
        fits_idle = fits_idle & (block.nihs != 0)
        fits_rel = fits_rel & (block.nrhs != 0)
    cand = (
        (block.cnode[task.gid] != 0)
        & (block.ntasks < block.nmax)
        & ((block.nports & task.tports) == 0)
        & (fits_idle | fits_rel)
    )
    least, balanced = node_scores(block.used.T, block.nalloc.T, res)
    score = (
        least.to(f32) * torch.tensor(task.w_least, dtype=f32)
        + balanced.to(f32) * torch.tensor(task.w_bal, dtype=f32)
        + block.affw[task.gid]
    )
    ninf = float("-inf")
    big = torch.where(cand, score, torch.full_like(score, ninf)).max()
    if not bool(big > ninf):
        return ninf, block.sent, 0
    nb = int((cand & (score == big)).to(torch.int8).argmax())
    return float(big), nb + block.off, int(bool(fits_idle[nb]))


def read_record(rec: torch.Tensor) -> tuple[float, int, int]:
    """One record (int32 [4], on the CPU) -> (score, global index, fits)."""
    return float(rec[0:1].view(torch.float32)), int(rec[1]), int(rec[2])


# -- the CUDA kernel: bind, launch ------------------------------------------

_PTR_FIELDS = (
    "cnode", "nmax", "nihs", "nrhs", "affw", "nalloc", "idle", "rel", "used", "ntasks", "nports", "out",
)


class _Args(ctypes.Structure):
    """Mirror of `struct BlockArgs` in csrc/block_step.cu (same order)."""

    _fields_ = [
        ("N", ctypes.c_int), ("R", ctypes.c_int), ("off", ctypes.c_int), ("sent", ctypes.c_int),
        ("task", Task),
    ] + [(f, ctypes.c_void_p) for f in _PTR_FIELDS]


def _bind(lib) -> None:
    lib.kbt_block_step.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_void_p]
    lib.kbt_block_step.restype = ctypes.c_int


_library = nvcc.Library("block_step", _bind)


class BlockStep:
    """A block's step, prepared once: the block is checked and, on a CUDA
    device, the kernel's argument struct is filled with the block's
    pointers, so each call only copies the task in and launches. Calls
    write their record into ``out`` (int32 [4] on the block's device).

    The block's tensors are read in place at every call: the caller may
    update them between calls, but must not replace them. Launches go to
    the stream that is current on the block's device at preparation, with
    that device made current for the launch (a mesh over several cards
    launches on each from one thread)."""

    def __init__(self, block: Block, out: torch.Tensor) -> None:
        device = block.check()
        if out.dtype != torch.int32 or tuple(out.shape) != (RECORD,) or not out.is_contiguous():
            raise ValueError(f"out must be a contiguous int32 tensor of shape ({RECORD},)")
        if out.device != device:
            raise ValueError(f"out on {out.device}, block on {device}")
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"block_step runs on cuda or cpu, not {device.type}")
        self.block = block
        self.out = out
        self.device = device
        self._gt = block.cnode.shape[0]
        self._args = None
        if device.type == "cuda":
            self._lib = _library.load()
            N = block.cnode.shape[1]
            args = _Args(N=N, R=block.idle.shape[0], off=block.off, sent=block.sent)
            for name in _PTR_FIELDS:
                setattr(args, name, (out if name == "out" else getattr(block, name)).data_ptr())
            self._args = args
            self._ref = ctypes.byref(args)
            self._index = torch.cuda.current_device() if device.index is None else device.index
            self._stream = torch.cuda.current_stream(self._index).cuda_stream

    def __call__(self, task: Task) -> torch.Tensor:
        if not 0 <= task.gid < self._gt:
            raise ValueError(f"task group {task.gid} outside the block's {self._gt} groups")
        if self._args is None:
            score, idx, fits = block_step_plain(self.block, task)
            self.out[0:1].view(torch.float32)[0] = score
            self.out[1:] = torch.tensor([idx, fits, 0], dtype=torch.int32)
            return self.out
        self._args.task = task
        err = self._lib.kbt_block_step(self._ref, self._index, self._stream)
        if err != 0:
            raise RuntimeError(f"block_step launch failed: {_library.error(err)}")
        block_step.launches += 1
        return self.out


def block_step(block: Block, task: Task, out: torch.Tensor | None = None) -> torch.Tensor:
    """One block step: launches the kernel (asynchronously, on the current
    stream) when the block lies on a CUDA device, runs the plain version
    when it lies on the CPU, raises on any other device. Returns the
    record buffer (``out``, or a new one on the block's device)."""
    if out is None:
        out = torch.zeros(RECORD, dtype=torch.int32, device=block.idle.device)
    return BlockStep(block, out)(task)


block_step.launches = 0
