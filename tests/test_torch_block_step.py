"""The sharded solve's block step (kernel B2) against the JAX package's.

Each case is a random node block made from a numpy seed, in the port's
layout ([R, N] rows, [GT, N] compat and affinity, [N] int32 vectors), and
a task. The same block, folded into the reference's [R8, N/128, 128]
layout, goes through the reference's Pallas block-step kernel in
interpret mode (``_build_block_step(nr_loc, gt, interpret=True)``) and its
plain-XLA oracle ``block_step_jnp``. The port's ``block_step_plain`` must
give the same (score, global index, fits-idle) triple exactly: both sides
run the same float32 operations.

The CUDA kernel itself runs only on the card: the ``cuda``-marked test
holds it against the plain version there. The JAX package is imported
only inside the reference helper, so on a machine without jax

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_block_step.py

runs the card test alone.
"""

import functools

import numpy as np
import pytest
import torch

from kube_batch_tpu_torch.ops import block_step as bs

NR, LANES, GT = 2, 128, 3
N = NR * LANES  # nodes per block


def make_case(case: str):
    """(Block, Task) of one case; all quantities float32."""
    rng = np.random.default_rng(_SEEDS[case])
    R = 4 if case in ("has_sc", "releasing_only") else 2
    f32 = np.float32
    cap = np.stack([
        rng.choice([4000, 8000, 16000, 32000], N), rng.choice([8192, 16384, 32768], N),
        *[rng.choice([0, 4, 8], N) for _ in range(R - 2)],
    ]).astype(f32)
    used = (cap * rng.uniform(0, 0.9, cap.shape)).astype(f32)
    idle = (cap - used).astype(f32)
    rel = (rng.uniform(0, 0.3, cap.shape) * cap).astype(f32)
    cnode = (rng.random((GT, N)) < 0.9).astype(np.int32)
    affw = rng.integers(0, 3, (GT, N)).astype(f32) * f32(rng.choice([1.0, 0.5]))
    nmax = np.full(N, 110, np.int32)
    ntasks = rng.integers(0, 10, N).astype(np.int32)
    nihs = (rng.random(N) < 0.7).astype(np.int32)
    nrhs = (rng.random(N) < 0.7).astype(np.int32)
    nports = np.zeros(N, np.int32)
    req = np.array([rng.choice([250, 500, 1000]), rng.choice([512, 1024])] + [0] * (R - 2), f32)
    has_sc, tports, gid, off, sent = 0, 0, int(rng.integers(0, GT)), 0, N

    if case == "ties":  # identical nodes: the lowest index must win
        for x in (cap, used, idle, rel):
            x[:] = x[:, :1]
        cnode[:] = 1
        affw[:] = 0
        ntasks[:] = 0
    elif case == "no_candidate":
        idle[:] = 0
        rel[:] = 0
    elif case == "has_sc":
        req[2] = 2
        has_sc = 1
    elif case == "port_collision":
        nports[:] = rng.integers(0, 8, N)
        tports = 2
    elif case == "zero_capacity":
        zero = rng.random(N) < 0.3
        cap[:2, zero] = 0
        idle[:, zero] = f32(1e6)  # fits, but scores through the cap == 0 branches
    elif case == "pad_nodes":
        cnode[:, N - 100 :] = 0
        nmax[N - 100 :] = 0
        cap[:, N - 100 :] = idle[:, N - 100 :] = rel[:, N - 100 :] = used[:, N - 100 :] = 0
    elif case == "offset":
        off, sent = 3 * N, 8 * N
    elif case == "releasing_only":
        idle[:] = 0
        rel[:] = cap
        req[2] = 1
        has_sc = 1
    elif case == "room":
        ntasks[:] = nmax
        ntasks[rng.integers(0, N, 5)] = 0
    res = req.copy()

    t = torch.from_numpy
    block = bs.Block(
        cnode=t(cnode), affw=t(affw), nalloc=t(np.ascontiguousarray(cap[:2])),
        nmax=t(nmax), nihs=t(nihs), nrhs=t(nrhs),
        idle=t(idle), rel=t(rel), used=t(used), ntasks=t(ntasks), nports=t(nports),
        off=off, sent=sent,
    )
    eps = [10.0, 1.0] + [10.0] * (R - 2)
    task = bs.make_task(gid, has_sc, tports, req.tolist(), res.tolist(), eps, 1.0, 1.0)
    return block, task


_SEEDS = {
    "random_0": 0, "random_1": 1, "random_2": 2, "ties": 3, "no_candidate": 4, "has_sc": 5,
    "port_collision": 6, "zero_capacity": 7, "pad_nodes": 8, "offset": 9, "releasing_only": 10,
    "room": 11,
}
CASES = sorted(_SEEDS)


def _fold(block: bs.Block, task: bs.Task):
    """The block and task in the reference's folded layout and vectors."""
    R8 = bs.R8

    def rows8(x):
        out = np.zeros((R8, N), np.float32)
        out[: x.shape[0]] = x.numpy()
        return out.reshape(R8, NR, LANES)

    def vec(x):
        return x.numpy().reshape(NR, LANES)

    ivec = np.array([task.gid, task.has_sc, task.tports, block.off, block.sent, 0, 0, 0], np.int32)
    fvec = np.zeros(32, np.float32)
    fvec[0:8], fvec[8:16], fvec[16:24] = task.req[:], task.res[:], task.eps[:]
    fvec[24], fvec[25] = task.w_least, task.w_bal
    blocks = (
        block.cnode.numpy().reshape(GT, NR, LANES), block.affw.numpy().reshape(GT, NR, LANES),
        rows8(block.nalloc), vec(block.nmax), vec(block.nihs), vec(block.nrhs),
        rows8(block.idle), rows8(block.rel), rows8(block.used), vec(block.ntasks), vec(block.nports),
    )
    return ivec, fvec, blocks


@functools.lru_cache(maxsize=None)
def reference(case: str, oracle: str):
    from kube_batch_tpu.ops import pallas_solve
    from kube_batch_tpu.testing import x64_enabled

    ivec, fvec, blocks = _fold(*make_case(case))
    with x64_enabled(False):
        if oracle == "interpret":
            fn = pallas_solve._build_block_step(NR, GT, True)
        else:
            fn = pallas_solve.block_step_jnp
        score, idx, fits = fn(ivec, fvec, *blocks)
        return float(score), int(idx), int(fits)


@pytest.mark.parametrize("oracle", ["jnp", "interpret"])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_reference_block_step(case, oracle):
    block, task = make_case(case)
    got = bs.block_step_plain(block, task)
    assert got == reference(case, oracle)


def test_cases_cover_the_branches():
    """The cases reach what they are named for: ties to the lowest index,
    no candidate, an offset index, a pipelined (releasing-only) winner."""
    assert bs.block_step_plain(*make_case("ties"))[1] == 0
    assert bs.block_step_plain(*make_case("no_candidate")) == (float("-inf"), N, 0)
    score, idx, fits = bs.block_step_plain(*make_case("offset"))
    assert 3 * N <= idx < 4 * N and score > float("-inf")
    score, idx, fits = bs.block_step_plain(*make_case("releasing_only"))
    assert score > float("-inf") and fits == 0
    assert bs.block_step_plain(*make_case("has_sc"))[2] == 1


def test_wrapper_writes_the_record_on_cpu():
    block, task = make_case("random_0")
    launches = bs.block_step.launches
    out = bs.block_step(block, task)
    assert bs.block_step.launches == launches  # CPU tensors never launch
    assert bs.read_record(out) == bs.block_step_plain(block, task)


def test_wrapper_checks_its_inputs():
    block, task = make_case("random_0")
    with pytest.raises(TypeError):
        bs.block_step(bs.Block(**{**block.__dict__, "ntasks": block.ntasks.long()}), task)
    with pytest.raises(ValueError):
        bs.block_step(bs.Block(**{**block.__dict__, "idle": block.idle[:, :-1]}), task)
    with pytest.raises(ValueError):
        bs.block_step(bs.Block(**{**block.__dict__, "idle": block.idle.to("meta")}), task)
    with pytest.raises(ValueError):
        bs.block_step(block, bs.make_task(GT, 0, 0, [1.0, 1.0], [1.0, 1.0], [1.0, 1.0], 1.0, 1.0))
    with pytest.raises(ValueError):
        bs.block_step(bs.Block(**{**block.__dict__, "sent": block.off + N - 1}), task)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    block, task = make_case(case)
    want = bs.block_step_plain(block, task)
    dev = bs.Block(**{
        k: (v.cuda() if isinstance(v, torch.Tensor) else v) for k, v in block.__dict__.items()
    })
    launches = bs.block_step.launches
    out = bs.block_step(dev, task)
    torch.cuda.synchronize()
    assert bs.block_step.launches == launches + 1
    assert bs.read_record(out.cpu()) == want
