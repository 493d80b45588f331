"""Conversions between numpy and torch for the encoded snapshot and the
solve state, so a snapshot encoded elsewhere (or a state produced
elsewhere) enters the port unchanged and the port's results leave it as
plain numpy for comparison."""

from __future__ import annotations

import numpy as np
import torch

from kube_batch_tpu_torch.ops.kernels import SolveState


def _tensor(v, device) -> torch.Tensor:
    arr = np.asarray(v)
    if arr.dtype == np.float64 and arr.ndim == 0:
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def arrays_from_numpy(a: dict, device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """Encoder arrays (numpy, plus the scalar weights) as torch tensors on
    `device`. On the CPU the tensors share memory with the numpy arrays."""
    return {k: _tensor(v, device) for k, v in a.items()}


def state_from_numpy(s, device: str | torch.device = "cpu") -> SolveState:
    """Any SolveState-shaped tuple of array-likes -> the port's SolveState
    of tensors (copies, so the solve may update them in place)."""
    return SolveState(*(_tensor(np.array(getattr(s, f)), device) for f in SolveState._fields))


def state_to_numpy(s: SolveState) -> SolveState:
    """The port's SolveState -> the same tuple of numpy arrays."""
    return SolveState(*(getattr(s, f).detach().cpu().numpy() for f in SolveState._fields))
