"""Kernel B4's K-deep batched exchange (``ops/mesh_solve.py``,
``csrc/mesh_solve.cu``) against the JAX package's own batched program.

The JAX mesh rung's SPMD body (kube_batch_tpu/parallel/sharded_pallas.py
``_blocked_programs``) speculates up to K gang iterations a shard, gathers
every shard's records once and replays them. Under the installed JAX its
``shard_map(..., check_rep=False)`` raises ``TypeError``: this JAX names
the keyword ``check_vma``. ``_blocked_programs`` imports ``shard_map``
from ``jax`` when it builds a program, so the module-scoped fixture
``jax_shard_map_check_vma`` replaces ``jax.shard_map`` for this file's
tests with a wrapper that passes ``check_rep`` on as ``check_vma``. It
touches nothing of the JAX package and lives here, not in a conftest. With
it, ``ShardedPallasSolver(exchange_batch=K)`` runs on ``make_mesh(m)`` of
the 8-device virtual CPU mesh (block implementation ``auto``: ``jnp``
there), x64 off.

On the same float32 snapshot B4's plain version at K = 2, 4 and 8, over
groupings of the mesh's shards into cards (the unit of speculation),
equals field for field the JAX batched program, its ``batched_iters``, B4's
plain version at K = 1 and the port's host loop at K; where every shard is
its own card its exchange rounds equal the host loop's. Then the class
keys of the records, the rule for K (the JAX package's
``_default_exchange_batch``), and the pause and resume at pod-affinity
host tasks through ``torch_allocate`` under ``KBT_PIPELINE=1`` and
``KBT_EXCHANGE_BATCH=4`` against the JAX ``xla_allocate``.

The cases marked ``cuda`` run the kernel and skip without a GPU: B4 at
K = 2, 4 and 8 over four cards of one solve on cuda:0 (one stream each)
against its plain version, over four shards of cuda:0 against B1, and a
round whose peer never runs. They import no jax (the CPU cases import it
inside their helpers), so the card's machine runs them with
``--noconftest``.
"""

from __future__ import annotations

import functools
import logging
import time

import numpy as np
import pytest
import torch

from kube_batch_tpu_torch.ops import carry
from kube_batch_tpu_torch.ops import fused_solve as fs
from kube_batch_tpu_torch.ops import mesh_solve as ms
from kube_batch_tpu_torch.parallel import ShardedBlockSolver
from kube_batch_tpu_torch.parallel.sharded_block import default_exchange_batch

from test_torch_mesh_solve import GROUPINGS, assert_states_equal, reference

FLAGS = "drf_proportion"  # drf and proportion on, as the JAX package's batched tests run
SMALL_WORLDS = ("synthetic_120_24", "multi_queue_96_16", "contended_seed5")
SMALL_GROUPINGS = ("m3_uneven", "m4_contiguous", "m4_interleaved", "m4_one_card")
CASES = (
    [(w, g, k) for w in SMALL_WORLDS for g in SMALL_GROUPINGS for k in (2, 4, 8)]
    + [("multi_queue_96_16", "m2_contiguous", 4)]
    + [("preempt_mix_2000_40_seed1", g, 2) for g in ("m2_contiguous", "m3_uneven", "m4_interleaved")]
)


@pytest.fixture(scope="module")
def jax_shard_map_check_vma():
    """``jax.shard_map`` with ``check_rep`` passed on as ``check_vma`` (the
    installed JAX's name for it), for this module's tests only: the
    programs built under it leave the JAX package's program cache with
    the fixture, so no later test of the same process runs one."""
    import jax

    from kube_batch_tpu.parallel import sharded_pallas

    real = jax.shard_map

    def shard_map(f, *args, check_rep=None, **kwargs):
        if check_rep is not None:
            kwargs["check_vma"] = check_rep
        return real(f, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "shard_map", shard_map)
        try:
            yield
        finally:
            sharded_pallas._blocked_programs.cache_clear()


def _np_state(s):
    return type(s)(*(np.asarray(x) for x in s))


@functools.lru_cache(maxsize=None)
def jax_batched(world: str, m: int, k: int):
    """The JAX package's batched program on ``make_mesh(m)`` at K = ``k``:
    its SolveState and ``batched_iters``."""
    from kube_batch_tpu.parallel import make_mesh
    from kube_batch_tpu.parallel.sharded_pallas import ShardedPallasSolver
    from kube_batch_tpu.testing import x64_enabled

    a, _ = reference(world, FLAGS)
    with x64_enabled(False):
        sp = ShardedPallasSolver(a, make_mesh(m), True, True, exchange_batch=k)
        return _np_state(sp.solve(None)), sp.batched_iters


@functools.lru_cache(maxsize=None)
def plain(world: str, grouping: str, k: int):
    """B4's plain version over the grouping at K = ``k``: its SolveState,
    ``batched_iters``, counts and speculated iterations by card."""
    a, _ = reference(world, FLAGS)
    cards = GROUPINGS[grouping]
    solver = ms.MeshSolve(carry.arrays_from_numpy(a), ["cpu"] * len(cards), True, True, cards=cards,
                          exchange_batch=k)
    got = carry.state_to_numpy(solver.solve())
    return got, solver.batched_iters, dict(solver.counts), list(solver.speculated_by_card)


@functools.lru_cache(maxsize=None)
def host_loop(world: str, m: int, k: int):
    a, _ = reference(world, FLAGS)
    solver = ShardedBlockSolver(carry.arrays_from_numpy(a), ["cpu"] * m, True, True, exchange_batch=k,
                                impl="host_loop")
    return carry.state_to_numpy(solver.solve()), solver.batched_iters, dict(solver.counts)


@pytest.mark.parametrize("world,grouping,k", CASES)
def test_plain_batched_exchange_equals_the_jax_batched_program(jax_shard_map_check_vma, world, grouping, k):
    """B4's plain version at K over a grouping of the shards into cards:
    every SolveState field and ``batched_iters`` the JAX batched program's
    on a mesh of as many shards, its own K = 1 result's and the host
    loop's at K; card per shard, the host loop's exchange rounds."""
    a, twin = reference(world, FLAGS)
    cards = GROUPINGS[grouping]
    m = len(cards)
    got, batched, counts, speculated = plain(world, grouping, k)
    ctx = f"{world} {grouping} K={k}"
    jax_state, jax_iters = jax_batched(world, m, k)
    assert_states_equal(jax_state, got, f"{ctx} vs the JAX batched program")
    assert batched == jax_iters == counts["placing_iterations"] > 0
    assert_states_equal(plain(world, grouping, 1)[0], got, f"{ctx} vs B4's plain version at K = 1")
    host, host_batched, host_counts = host_loop(world, m, k)
    assert_states_equal(host, got, f"{ctx} vs the host loop")
    assert host_batched == batched
    n_cards = len(set(cards))
    assert counts["cards"] == n_cards == len(speculated)
    if n_cards == 1:  # one card exchanges nothing: its K = 1 loop is the batched result
        assert counts["exchange_rounds"] == 0 and speculated == [batched]
    else:
        assert 0 < counts["exchange_rounds"] <= batched
        assert all(s >= counts["placing_iterations"] // n_cards for s in speculated)
    if n_cards == m:  # every shard its own card: the host loop's rounds
        assert counts["exchange_rounds"] == host_counts["exchange_rounds"]
        assert counts["speculated"] == host_counts["speculated"]


def test_class_keys_are_equal_exactly_for_equal_sweep_fields():
    """Two classes that differ only in fields no sweep reads (the resource
    scalar flag, host-only) share a key; a different request, group, flag
    or port mask gives another; -0.0 and 0.0 are one value, as the JAX
    program's float comparison has them."""
    a, _ = reference("synthetic_120_24", FLAGS)
    packed = fs.pack(carry.arrays_from_numpy(a), True, True)
    d, v = packed.dims, packed.views()
    C, R = d.C, d.R
    assert C >= 6
    base = {name: v[name].clone() for name in ("cgid", "chs", "crhs", "cho", "cpt", "creq", "cres")}
    req, res = base["creq"].view(R, C), base["cres"].view(R, C)
    res[1, 0] = 0.0
    for c in range(1, 6):  # classes 1..5 copy class 0's sweep fields
        for name in ("cgid", "chs", "crhs", "cho", "cpt"):
            base[name][c] = base[name][0]
        req[:, c], res[:, c] = req[:, 0], res[:, 0]
    base["crhs"][1] = 1 - base["crhs"][0]  # fields no sweep reads
    base["cho"][2] = 1 - base["cho"][0]
    base["cpt"][3] = base["cpt"][0] ^ 1  # fields a sweep reads
    req[0, 4] = req[0, 0] + 1.0
    res[1, 5] = -0.0
    for name, x in base.items():
        v[name].copy_(x)
    assert torch.signbit(v["cres"].view(R, C)[1, 5]) and not torch.signbit(v["cres"].view(R, C)[1, 0])
    keys = ms.class_keys(packed)
    assert keys.dtype == torch.int32 and keys.shape == (C,)
    assert keys[0] == keys[1] == keys[2] == keys[5]
    assert len({int(keys[0]), int(keys[3]), int(keys[4])}) == 3


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("raw", ["", "1", "0", "-3", "4", "64", "65", "x", None])
def test_the_rule_for_k_equals_the_jax_packages(monkeypatch, caplog, pipelined, raw):
    """``default_exchange_batch`` against the JAX package's
    ``_default_exchange_batch`` on the same environment (``None``: the
    variable unset); a value that is not an integer logs the JAX error."""
    from kube_batch_tpu.parallel.sharded_pallas import _default_exchange_batch

    if pipelined:
        monkeypatch.setenv("KBT_PIPELINE", "1")
    else:
        monkeypatch.delenv("KBT_PIPELINE", raising=False)
    if raw is None:
        monkeypatch.delenv("KBT_EXCHANGE_BATCH", raising=False)
    else:
        monkeypatch.setenv("KBT_EXCHANGE_BATCH", raw)
    with caplog.at_level(logging.ERROR, logger="kube_batch_tpu_torch"):
        k = default_exchange_batch()
    assert k == _default_exchange_batch()
    want = {"": 4, "1": 1, "0": 1, "-3": 1, "4": 4, "64": 64, "65": 64, "x": 4, None: 4}[raw] if pipelined else 1
    assert k == want
    errors = [r.getMessage() for r in caplog.records if r.name.startswith("kube_batch_tpu_torch")]
    assert errors == (["bad KBT_EXCHANGE_BATCH='x'; using 4"] if pipelined and raw == "x" else [])


TIERS_YAML = """
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""


def test_batched_exchange_pause_resume_through_torch_allocate(jax_shard_map_check_vma, monkeypatch):
    """The twin of the JAX package's
    ``test_batched_exchange_pause_resume_through_action``: ``KBT_PIPELINE=1``
    and ``KBT_EXCHANGE_BATCH=4`` through ``torch_allocate`` on ``mesh:
    cpu:4``, two pod-affinity host tasks pausing and resuming B4's plain
    batched exchange. The binds and the batched iterations equal the JAX
    ``xla_allocate``'s on its 4-device mesh (its batched program), and
    ``exchange_batched_iters_total`` moves by ``last_batched_iters``."""
    import kube_batch_tpu.testing as jax_testing
    from kube_batch_tpu import pipeline as jax_pipeline
    from kube_batch_tpu.actions.xla_allocate import XlaAllocateAction
    from kube_batch_tpu.conf import parse_scheduler_conf as jax_parse
    from kube_batch_tpu.framework import close_session as jax_close
    from kube_batch_tpu.framework import open_session as jax_open
    from kube_batch_tpu.testing import x64_enabled

    import kube_batch_tpu_torch.actions.torch_allocate as TA
    import kube_batch_tpu_torch.testing as tt
    from kube_batch_tpu_torch import metrics, pipeline
    from kube_batch_tpu_torch.conf import parse_scheduler_conf
    from kube_batch_tpu_torch.framework import close_session, get_action, open_session
    from test_torch_parallel import _affinity_world

    seen = []

    class Spy(TA.ShardedBlockSolver):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen.append((self.exchange_batch, self.impl))

    monkeypatch.setattr(TA, "ShardedBlockSolver", Spy)
    monkeypatch.setenv("KBT_PIPELINE", "1")
    monkeypatch.setenv("KBT_EXCHANGE_BATCH", "4")
    pipeline.reset()
    jax_pipeline.reset()
    try:
        cache = tt.FakeCache(_affinity_world(tt))
        ssn = open_session(cache, parse_scheduler_conf(TIERS_YAML).tiers,
                           {"torch_allocate": {"device": "cpu", "mesh": "cpu:4"}})
        action = get_action("torch_allocate")
        before = metrics.exchange_batched_iters_total.value()
        action.execute(ssn)
        close_session(ssn)
        binds = dict(cache.binder.binds)
        assert action.last_mesh_size == 4 and action.last_solver_tier == "sharded"
        assert action.last_batched_iters > 0
        assert metrics.exchange_batched_iters_total.value() - before == action.last_batched_iters
        assert seen and set(seen) == {(4, "mesh_kernel")}

        with x64_enabled(False):
            jcache = jax_testing.FakeCache(_affinity_world(jax_testing))
            jssn = jax_open(jcache, jax_parse(TIERS_YAML).tiers, {"xla_allocate": {"mesh": "cpu:4"}})
            jaction = XlaAllocateAction(dtype=np.float32)
            jaction.execute(jssn)
            jax_close(jssn)
        assert jaction.last_mesh_size == 4 and jaction.last_solver_tier == "mesh_pallas"
        assert binds == dict(jcache.binder.binds) and len(binds) == 12
        assert action.last_batched_iters == jaction.last_batched_iters
    finally:
        pipeline.reset()
        jax_pipeline.reset()


# -- the kernel, on a card -----------------------------------------------------


def _card_world(small: bool = False):
    """``preempt_mix(2000, 40, seed=1)``, or with ``small`` the JAX
    tables' ``multi_queue(96, 16)`` (three proportion queues: drops of an
    overused queue inside a speculation), encoded by the port."""
    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch.solve import solver_arrays

    world = (models.multi_queue(96, 16, n_queues=3, tasks_per_job=6, seed=7) if small
             else models.preempt_mix(2000, 40, seed=1))
    return carry.arrays_from_numpy(solver_arrays(world)[1])


def _cards_on_the_card(world, m: int, k: int):
    """A CPU mesh solve over ``m`` cards at K = ``k`` with its entry state
    loaded, and the same cards copied to cuda:0 with an exchange buffer and
    the class keys each: ``m`` cards of one solve on one device, for
    launches by hand (one stream each)."""
    cpu = ms.MeshSolve(world, ["cpu"] * m, True, True, cards=list(range(m)), exchange_batch=k)
    cpu._load(None)
    dev = torch.device("cuda", 0)
    cards = [
        ms.Card(c.packed.to(dev), c.gidx.to(dev), fs.PackedState(c.state.dims, c.state.istate.to(dev),
                                                                c.state.fstate.to(dev)),
                torch.zeros(ms.XBUF_WORDS, dtype=torch.int32, device=dev), c.ckey.to(dev))
        for c in cpu.cards
    ]
    return cpu, cards


def _launch_on_streams(cards, k: int, timeout_ms: int = ms.TIMEOUT_MS, only: int | None = None) -> None:
    lib, prepared, index = ms._prepare(cards, 0, timeout_ms=timeout_ms, exchange_batch=k)
    prepared = [(args, scratch, torch.cuda.Stream(device=0)) for args, scratch, _ in prepared]
    torch.cuda.synchronize()  # the cards' copies have landed
    n = len(prepared) if only is None else only
    ms._launch_cards(lib, prepared[:n], index[:n], None)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 4, 8])
def test_kernel_batched_exchange_equals_its_plain_version(k):
    """Four cards of one solve on cuda:0, one stream each, at K: every
    card's state buffers (with ``scal[5:8]``: no abort, the rounds and the
    card's speculated iterations) equal the plain version's on the same
    cards, and the solve equals B1's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    a = _card_world(small=True)
    cpu, cards = _cards_on_the_card(a, 4, k)
    _launch_on_streams(cards, k)
    ms.mesh_solve(cpu.cards, exchange_batch=k)
    for c, want in zip(cards, cpu.cards):
        assert int(c.state.istate[5]) == 0
        assert torch.equal(c.state.istate.cpu(), want.state.istate)
        assert torch.equal(c.state.fstate.cpu(), want.state.fstate)
    assert int(cards[0].state.istate[6]) > 0 and int(cards[0].state.istate[7]) > 0
    b1 = fs.FusedSolver(a, True, True, device="cuda:0").solve()
    got = fs._state_of(fs.PackedState(cards[0].state.dims, cards[0].state.istate.cpu(),
                                      cards[0].state.fstate.cpu()))
    for f in ("it", "step", "assigned_node", "assigned_kind", "assign_pos", "ready_cnt"):
        assert torch.equal(getattr(got, f), getattr(b1, f).cpu()), f


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 4, 8])
def test_kernel_at_k_on_one_card_equals_b1(k):
    """Four shards of cuda:0 at K: one card, one launch of the K = 1 loop,
    every placing iteration batched; equal to B1 field for field."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    a = _card_world()
    b1 = fs.FusedSolver(a, True, True, device="cuda:0").solve()
    launches = ms.mesh_solve.launches
    solver = ShardedBlockSolver(a, ["cuda:0"] * 4, True, True, exchange_batch=k)
    got = solver.solve()
    assert solver.impl == "mesh_kernel" and ms.mesh_solve.launches - launches == 1
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(b1, f)), f
    assert solver.batched_iters == solver.counts["placing_iterations"] > 0
    assert solver.counts["exchange_rounds"] == 0


@pytest.mark.cuda
def test_kernel_round_gives_up_on_a_peer_that_never_runs():
    """Card 0 of a two-card batched solve launched alone, with a 100 ms
    bound: it speculates its first round, restores the true state, waits
    for card 1's records, gives up, sets its abort word to the round's
    number (1) and ends with the entry state written back; the card runs
    the next kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    a = _card_world()
    cpu, cards = _cards_on_the_card(a, 2, 4)
    entry_i, entry_f = cards[0].state.istate.clone(), cards[0].state.fstate.clone()
    t0 = time.perf_counter()
    _launch_on_streams(cards, 4, timeout_ms=100, only=1)
    waited = time.perf_counter() - t0
    got_i = cards[0].state.istate
    assert got_i[5:7].tolist() == [1, 1] and waited >= 0.1
    assert 0 < int(got_i[7]) <= 4  # the round's speculated iterations
    assert int(cards[0].xbuf[-ms.REC]) == 1  # the abort word
    assert torch.equal(got_i[:5], entry_i[:5]) and torch.equal(got_i[8:], entry_i[8:])
    assert torch.equal(cards[0].state.fstate, entry_f)
    b1 = fs.FusedSolver(a, True, True, device="cuda:0").solve()
    assert int(b1.step) > 0
