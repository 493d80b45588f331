"""The fused-solve CUDA kernel against its plain version, on the card.

The kernel has no CPU mode, so every test here carries the `cuda` marker
and skips without a GPU. This file imports only the port (no jax), so it
also runs where the JAX package is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel.py

Integer state must match exactly and float state bit for bit: both sides
run the same float32 operations in the same order (the kernel is built
without FMA contraction and divides with correct rounding).
"""

import pytest
import torch

from kube_batch_tpu_torch import models
from kube_batch_tpu_torch.ops import fused_solve as fs
from kube_batch_tpu_torch.ops.carry import arrays_from_numpy
from kube_batch_tpu_torch.ops.kernels import init_state
from kube_batch_tpu_torch.solve import solver_arrays

WORLDS = {
    "synthetic_200_20": lambda: models.synthetic(200, 20),
    "multi_queue_400_40": lambda: models.multi_queue(400, 40, 4, 10),
    "multi_tenant_ml_8_8_3": lambda: models.multi_tenant_ml(8, 8, 3),
    "preempt_mix_2000_40_seed1": lambda: models.preempt_mix(2000, 40, seed=1),
}


def _arrays(cluster) -> dict:
    return arrays_from_numpy(solver_arrays(cluster)[1])


@pytest.mark.cuda
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_kernel_matches_plain_on_card(world):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    a = _arrays(WORLDS[world]())
    p = fs.pack(a, True, True)
    init = fs.pack_state(p.dims, init_state(a, True, True), a["job_queue"])
    plain = fs.fused_solve(p, fs.PackedState(p.dims, init.istate.clone(), init.fstate.clone()))
    launches = fs.fused_solve.launches
    dev = fs.fused_solve(p.to("cuda"), fs.PackedState(p.dims, init.istate.cuda(), init.fstate.cuda()))
    torch.cuda.synchronize()
    assert fs.fused_solve.launches == launches + 1
    assert torch.equal(dev.istate.cpu(), plain.istate)
    assert torch.equal(dev.fstate.cpu(), plain.fstate)
