"""Comparison-dtype policy: the one place that decides the precision in
which COMPARISON-FEEDING derived quantities (DRF/proportion shares,
balanced-resource fractions, water-filled deserved vectors) are
computed.

Raw resource quantities live on the milli-CPU/byte integer grid and are
exact in every dtype in play. The derived quotients are not on the grid,
so the dtype they are computed in decides how ties break. The port's
solve runs in float32 (the fused CUDA kernel and its plain twin), so the
host computes these quantities in float32 too: numpy scalar ops and the
kernel's division are both correctly rounded, so host == kernel holds
bit for bit at every scale.
"""

from __future__ import annotations

import numpy as np


def comparison_dtype():
    """Always np.float32: the solve's float type."""
    return np.float32


def quantize(value: float, dtype=None) -> float:
    """Round one derived scalar to the comparison dtype (exact no-op for
    on-grid quantities)."""
    return float((dtype or comparison_dtype())(value))
