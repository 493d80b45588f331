"""The port's correctly rounded division (kube_batch_tpu_torch/ops/kernels.py
``ieee_div``, the float32 divide of the plain versions), case for case with
tests/test_ieee_div.py.

The JAX cases pin XLA's divide against numpy's; the port divides with
torch, whose float32 and float64 divides are correctly rounded on the CPU
(and the kernels use ``__fdiv_rn``, held bit for bit against these plain
versions on the card). Each case here divides the JAX case's vectors with
the port's ``ieee_div`` and torch's ``/``, and with the JAX ``ieee_div``
on the same inputs: all three must equal numpy's quotient bit for bit.

- ``test_f32_division_bit_exact_on_default_backend``,
  ``test_least_requested_floor_boundaries``,
  ``test_f64_division_bit_exact_on_cpu_backend`` and
  ``test_share_tie_preserved_in_f32``: the same names. The first two were
  also held in tests/test_torch_solve.py (``test_float32_divide_is_correctly_rounded``,
  ``test_least_requested_floor_boundaries``) against numpy alone.
- ``test_f32_division_bit_exact_on_tpu_backend``: no counterpart; it
  measures the TPU backend the JAX package was built for, which the port
  does not run on. The port's card divide is B1's, B2's and B3's, held
  bit for bit against their plain versions by chip_smoke.py.
"""

from __future__ import annotations

import numpy as np
import torch

import jax

from kube_batch_tpu.ops.kernels import ieee_div as jax_ieee_div
from kube_batch_tpu.testing import x64_enabled

from kube_batch_tpu_torch.ops import kernels as tk


def _all_equal(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    want = x / y
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_array_equal(tk.ieee_div(tx, ty).numpy(), want)
    np.testing.assert_array_equal((tx / ty).numpy(), want)
    with x64_enabled(x.dtype == np.float64):
        np.testing.assert_array_equal(np.asarray(jax.jit(jax_ieee_div)(x, y)), want)
    return want


def test_f32_division_bit_exact_on_default_backend():
    rng = np.random.default_rng(7)
    x = rng.uniform(1e-3, 1e9, 100_000).astype(np.float32)
    y = rng.uniform(1e-3, 1e9, 100_000).astype(np.float32)
    _all_equal(x, y)


def test_least_requested_floor_boundaries():
    """floor((cap - req) * 10 / cap): an empty node scores exactly 10."""
    rng = np.random.default_rng(0)
    cap = rng.integers(1000, 256_000, 50_000).astype(np.float32)
    req = (cap * rng.random(50_000).astype(np.float32)).astype(np.int64).astype(np.float32)
    c, r = torch.from_numpy(cap), torch.from_numpy(req)
    got = torch.floor(tk.ieee_div((c - r) * 10.0, c)).numpy()
    want = np.floor((cap - req) * np.float32(10.0) / cap)
    np.testing.assert_array_equal(got, want)
    with x64_enabled(False):
        ref = np.asarray(jax.jit(lambda v, d: jax.numpy.floor(jax_ieee_div(v * 10.0, d)))(cap - req, cap))
    np.testing.assert_array_equal(got, ref)
    empty = torch.floor(tk.ieee_div(c * 10.0, c)).numpy()
    assert (empty == 10.0).all()
    assert (tk._least_dim(torch.zeros_like(c), c) == 10).all()


def test_f64_division_bit_exact_on_cpu_backend():
    rng = np.random.default_rng(1)
    x = rng.uniform(1e-3, 1e12, 100_000)
    y = rng.uniform(1e-3, 1e12, 100_000)
    _all_equal(x, y)


def test_share_tie_preserved_in_f32():
    """Two queues whose float64 shares differ by 1 ulp collapse to the same
    float32; ieee_div must not reorder them."""
    d1, d2 = np.float32(6651.8848), np.float32(4434.5898)
    a1, a2 = np.float32(6000.0), np.float32(4000.0)
    s1 = _all_equal(np.array([a1]), np.array([d1]))
    s2 = _all_equal(np.array([a2]), np.array([d2]))
    assert s1[0] == a1 / d1 and s2[0] == a2 / d2
