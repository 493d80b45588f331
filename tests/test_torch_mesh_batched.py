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
plain version at K = 1 and the port's host loop at K, in no more exchange
rounds than the host loop (which keeps the JAX program's round: a card
answers only from its chain). On a hand-built world of alternating keys,
where the JAX rule commits one iteration a round, the port's rule (exact
round-start records for the cards that have won nothing) takes strictly
fewer rounds, and exactly the count derived by hand. Then a chain's end
before its second overused-queue drop (the kernel saves one drop's runs a
chain), on the card tests' drops world and on a hand-built world of two
drops at a count derived by hand, the batched exchange's layouts against
the kernel's sources, the class keys of the records, the rule for K (the
JAX package's ``_default_exchange_batch``),
and the pause and resume at pod-affinity host tasks through
``torch_allocate`` under ``KBT_PIPELINE=1`` and ``KBT_EXCHANGE_BATCH=4``
against the JAX ``xla_allocate``.

The cases marked ``cuda`` run the kernel and skip without a GPU: B4 at
K = 2, 4 and 8 over four cards of one solve on cuda:0 (one stream each)
against its plain version, the alternating world over two cards of one
solve against its plain version (rounds included), a four-queue world at
K = 8 and the two-drops world at K = 16 against their plain versions,
over four shards of cuda:0 against B1, and a round whose peer never runs
(on the two-drops world too, its chain through a drop). They import no
jax (the CPU cases import it inside their helpers), so the card's machine
runs them with ``--noconftest``.
"""

from __future__ import annotations

import functools
import logging
import re
import time

import numpy as np
import pytest
import torch

from kube_batch_tpu_torch.ops import carry, nvcc
from kube_batch_tpu_torch.ops import fused_solve as fs
from kube_batch_tpu_torch.ops import mesh_solve as ms
from kube_batch_tpu_torch.ops.kernels import init_state
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


ALTERNATING_NODES, ALTERNATING_TASKS = 128, 72


def alternating_world(testing):
    """One gang of ALTERNATING_TASKS tasks (minimum 1) whose requests
    alternate between two shapes (1 and 2 cpu: two record keys) over
    ALTERNATING_NODES equal nodes of one pod each, built with ``testing``'s
    builders (the JAX package's or the port's). The encoded node axis is
    ALTERNATING_NODES wide, so two cards hold 64 nodes each. Every free node
    scores the same for a task, so the lowest free row wins: card 0 takes
    tasks 0-63, card 1 tasks 64-71."""
    nodes = [testing.build_node(f"n{i:03d}", testing.build_resource_list(cpu=8, memory="16Gi", pods=1))
             for i in range(ALTERNATING_NODES)]
    pods = [testing.build_pod(name=f"j-t{t:02d}", group_name="j",
                              req=testing.build_resource_list(cpu="1000m" if t % 2 == 0 else "2000m", memory="1Gi"))
            for t in range(ALTERNATING_TASKS)]
    return testing.build_cluster(pods, nodes, [testing.build_pod_group("j", min_member=1)],
                                 [testing.build_queue("default")])


@functools.lru_cache(maxsize=None)
def alternating_arrays():
    """The alternating world encoded by the JAX package (x64 off)."""
    import kube_batch_tpu.testing as jax_testing
    from test_torch_encode import jax_encode, solver_arrays

    return solver_arrays(jax_encode(alternating_world(jax_testing)))


def two_drops_world():
    """Two queues of equal weight over 8 nodes of 8 cpu, 16 Gi (the
    encoded axis 128 wide: card 0 of two holds n0-n3, card 1 n4-n7), built
    with the port's builders. Each queue runs 12 pods of 2 cpu, 4 Gi
    (card 1's nodes full, two on each of card 0's) and has two pending
    gangs of 4 such pods; each deserves half the cluster, 32 cpu, so one
    gang takes it there. The solve places a0 and b0 on card 0, then drops
    queue a (retiring a1) and queue b: two drops, and from the entry state
    one chain reaches both at K = 16."""
    import kube_batch_tpu_torch.testing as t
    from kube_batch_tpu_torch.apis.types import PodPhase

    rl = t.build_resource_list
    nodes = [t.build_node(f"n{i}", rl(cpu=8, memory="16Gi", pods=110)) for i in range(8)]
    pods, groups, r = [], [], 0
    for q in ("a", "b"):
        groups.append(t.build_pod_group(f"{q}-run", queue=q, min_member=1))
        for i in range(12):
            node = f"n{4 + r // 4}" if r < 16 else f"n{(r - 16) // 2}"
            pods.append(t.build_pod(name=f"{q}-run-{i:02d}", node_name=node, phase=PodPhase.RUNNING,
                                    req=rl(cpu=2, memory="4Gi"), group_name=f"{q}-run"))
            r += 1
        for j in range(2):
            groups.append(t.build_pod_group(f"{q}{j}", queue=q, min_member=4))
            pods += [t.build_pod(name=f"{q}{j}-{i}", req=rl(cpu=2, memory="4Gi"), group_name=f"{q}{j}")
                     for i in range(4)]
    return t.build_cluster(pods, nodes, groups, [t.build_queue("a"), t.build_queue("b")])


def _two_drops_arrays():
    from kube_batch_tpu_torch.solve import solver_arrays

    return carry.arrays_from_numpy(solver_arrays(two_drops_world())[1])


def _reference(world: str):
    if world == "alternating":
        return alternating_arrays(), None
    return reference(world, FLAGS)


@functools.lru_cache(maxsize=None)
def jax_batched(world: str, m: int, k: int):
    """The JAX package's batched program on ``make_mesh(m)`` at K = ``k``:
    its SolveState and ``batched_iters``."""
    from kube_batch_tpu.parallel import make_mesh
    from kube_batch_tpu.parallel.sharded_pallas import ShardedPallasSolver
    from kube_batch_tpu.testing import x64_enabled

    a, _ = _reference(world)
    with x64_enabled(False):
        sp = ShardedPallasSolver(a, make_mesh(m), True, True, exchange_batch=k)
        return _np_state(sp.solve(None)), sp.batched_iters


@functools.lru_cache(maxsize=None)
def plain(world: str, grouping: str, k: int):
    """B4's plain version over the grouping at K = ``k``: its SolveState,
    ``batched_iters``, counts and speculated iterations by card."""
    a, _ = _reference(world)
    cards = GROUPINGS[grouping]
    solver = ms.MeshSolve(carry.arrays_from_numpy(a), ["cpu"] * len(cards), True, True, cards=cards,
                          exchange_batch=k)
    got = carry.state_to_numpy(solver.solve())
    return got, solver.batched_iters, dict(solver.counts), list(solver.speculated_by_card)


@functools.lru_cache(maxsize=None)
def host_loop(world: str, m: int, k: int):
    a, _ = _reference(world)
    solver = ShardedBlockSolver(carry.arrays_from_numpy(a), ["cpu"] * m, True, True, exchange_batch=k,
                                impl="host_loop")
    return carry.state_to_numpy(solver.solve()), solver.batched_iters, dict(solver.counts)


@pytest.mark.parametrize("world,grouping,k", CASES)
def test_plain_batched_exchange_equals_the_jax_batched_program(jax_shard_map_check_vma, world, grouping, k):
    """B4's plain version at K over a grouping of the shards into cards:
    every SolveState field and ``batched_iters`` the JAX batched program's
    on a mesh of as many shards, its own K = 1 result's and the host
    loop's at K, in no more exchange rounds than the host loop's (the JAX
    program's round structure)."""
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
        assert counts["exchange_rounds"] <= host_counts["exchange_rounds"]


@pytest.mark.parametrize("k", [2, 4, 8])
def test_alternating_keys_take_fewer_rounds_than_the_jax_rule(jax_shard_map_check_vma, k):
    """Two cards, tasks of alternating keys: the card that loses the first
    iteration keeps a chain record of the first task's key when the second
    task (the other key) comes, so the JAX rule (the host loop's rounds)
    stops after one iteration every round. The port's rule answers for it
    from its round-start record of the second key: the same SolveState and
    ``batched_iters`` as the JAX batched program on two shards, K = 1 and
    the host loop, in strictly fewer rounds."""
    got, batched, counts, speculated = plain("alternating", "m2_contiguous", k)
    jax_state, jax_iters = jax_batched("alternating", 2, k)
    assert_states_equal(jax_state, got, f"alternating K={k} vs the JAX batched program")
    assert batched == jax_iters == counts["placing_iterations"] == ALTERNATING_TASKS
    assert_states_equal(plain("alternating", "m2_contiguous", 1)[0], got, f"alternating K={k} vs K = 1")
    host, host_batched, host_counts = host_loop("alternating", 2, k)
    assert_states_equal(host, got, f"alternating K={k} vs the host loop")
    assert host_batched == batched
    assert host_counts["exchange_rounds"] == ALTERNATING_TASKS  # the JAX rule: one iteration a round
    assert counts["cards"] == 2 and counts["exchange_rounds"] < host_counts["exchange_rounds"]


def test_alternating_keys_round_count_at_k4():
    """The rounds and speculated iterations the port's rule gives at K = 4
    on the alternating world, derived by hand. While card 0 has free nodes
    it wins every task through its chain (rows below card 1's), and card 1,
    which has won nothing, answers from its round-start records of both
    keys: a round commits K = 4 tasks, 16 rounds for tasks 0-63, card 0
    speculating 4 and card 1 4 a round. Then card 0 is full: its chain is
    one -inf record (the job abandoned on its block), of the task's key
    only, so each round commits one task (card 1 wins it; the next task's
    key is the other one): 8 rounds for tasks 64-71, card 0 speculating 1
    a round and card 1 min(4, tasks left) = 4, 4, 4, 4, 4, 3, 2, 1. The
    last round replays the job's drop as well. Rounds 16 + 8 = 24;
    speculated 64 + 8 = 72 and 64 + 26 = 90."""
    got, batched, counts, speculated = plain("alternating", "m2_contiguous", 4)
    assert counts["exchange_rounds"] == 24
    assert speculated == [72, 90]
    assert counts["iterations"] == ALTERNATING_TASKS + 1 and batched == ALTERNATING_TASKS
    assert got.assigned_node[:ALTERNATING_TASKS].tolist() == list(range(ALTERNATING_TASKS))


@pytest.mark.parametrize("k", [2, 4, 8])
def test_a_chain_ends_before_its_second_queue_drop(monkeypatch, k):
    """The kernel saves the runs an overused queue's drop retires once a
    chain, so a chain ends before a second drop, as at a pause; the plain
    version's chains (``_speculate``) end there too, and the card tests'
    drops world (``_card_world(small=True)``, three proportion queues) over
    four cards meets such chains at every K (so the card tests hold the
    kernel's stop there to the plain version's speculated counts). The
    result is still the K = 1 loop's (B1's plain version) field for
    field."""
    a = _card_world(small=True)
    real, cut = ms._speculate, []

    def spy(*args):
        rc, tasks, stopped = real(*args)
        if stopped:
            cut.append(len(rc))
        return rc, tasks, stopped

    monkeypatch.setattr(ms, "_speculate", spy)
    solver = ms.MeshSolve(a, ["cpu"] * 4, True, True, cards=[0, 1, 2, 3], exchange_batch=k)
    got = solver.solve()
    assert cut and solver.counts["exchange_rounds"] > 0
    want = fs.FusedSolver(a, True, True, device="cpu").solve()
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_two_drops_world_round_count_at_k16(monkeypatch):
    """The two-drops world over two cards at K = 16, derived by hand. Card
    0's chain places a0 and b0 (8 records), drops queue a (the chain's
    first drop, retiring a1), then meets queue b's drop and ends before
    it; card 1, full, has a -inf record for each of a0's four tasks and
    then its chain's job is abandoned (4 records). One round commits all 8
    placing iterations and both drops: rounds 1, speculated [8, 4], equal
    to the K = 1 loop (B1's plain version) field for field."""
    real, chains = ms._speculate, []

    def spy(*args):
        out = real(*args)
        chains.append((len(out[0]), out[2]))
        return out

    monkeypatch.setattr(ms, "_speculate", spy)
    a = _two_drops_arrays()
    solver = ms.MeshSolve(a, ["cpu"] * 2, True, True, cards=[0, 1], exchange_batch=16)
    got = solver.solve()
    assert chains == [(8, True), (4, False)]
    assert solver.counts["exchange_rounds"] == 1 and list(solver.speculated_by_card) == [8, 4]
    assert got.q_dropped.tolist() == [True, True] and int((got.assigned_node >= 0).sum()) == 8
    want = fs.FusedSolver(a, True, True, device="cpu").solve()
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_batched_plain_at_k1_and_on_one_card_is_the_k1_loop():
    """``_batched_plain`` at K = 1 over two cards and at K = 4 over one
    card gives the K = 1 loop's state (B1's plain version): at K = 1 one
    round a placing iteration, each card speculating one record a round;
    on one card the chain is the true chain, so every record is replayed
    once."""
    a, _ = reference("synthetic_120_24", FLAGS)
    a = carry.arrays_from_numpy(a)
    packed = fs.pack(a, True, True)
    init = fs.pack_state(packed.dims, init_state(a, True, True), a["job_queue"])
    want = fs.PackedState(packed.dims, init.istate.clone(), init.fstate.clone())
    fs.fused_solve_plain(packed, want)
    placing = int((want.views()["jptr"] - init.views()["jptr"]).sum())
    n = packed.dims.N
    for rows, k in (([torch.arange(0, n // 2), torch.arange(n // 2, n)], 1), ([torch.arange(n)], 4)):
        got = fs.PackedState(packed.dims, init.istate.clone(), init.fstate.clone())
        rounds, speculated = ms._batched_plain(packed, got, rows, k)
        assert torch.equal(got.istate[:5], want.istate[:5]) and torch.equal(got.istate[8:], want.istate[8:])
        assert torch.equal(got.fstate, want.fstate)
        if k == 1:
            assert rounds == placing and speculated == [placing, placing]
        else:  # the one card's chain is the true chain: each record replayed once
            assert -(-placing // k) <= rounds <= placing and speculated == [placing]


def _source_text(name: str) -> str:
    with open(f"{nvcc.CSRC_DIR}/{name}") as f:
        return f.read()


def _eval_strides(body: str, env: dict) -> int:
    return sum(eval(e, {}, env) for e in re.findall(r"\bw \+= ([^;]+);", body))


@pytest.mark.parametrize("k, cards", [(2, 2), (4, 4), (8, 4), (64, 8)])
def test_batched_layouts_match_the_kernels(k, cards):
    """``batch_words`` sizes the batched exchange's shared scratch, which
    csrc/mesh_solve.cu lays out in ``batch_layout`` (and traps on a launch
    whose size disagrees); ``spec_words`` its global slice, the saved
    runs (``spec_words_of``); SLOT one card's records of a round, in B4 and in
    the probe csrc/mesh_floor.cu alike."""
    with open(f"{nvcc.CSRC_DIR}/mesh_solve.cu") as f:
        text = f.read()
    body = re.search(r"BatchShared batch_layout\(.*?\{(.*?)\n\}", text, re.S).group(1)
    env = {"K": k, "m": cards, "KEY_CHUNK": ms.KEY_CHUNK, "NWARPS": ms.NWARPS, "MAX_CLUSTER": ms.MAX_CLUSTER,
           "TASK_WORDS": ms.TASK_WORDS, "LOG0_WORDS": ms.LOG0_WORDS, "LOG_ROW_WORDS": ms.LOG_ROW_WORDS,
           "SPEC_ITERS": ms.spec_iterations, "PLOG_WORDS": ms.PLOG_WORDS, "UNDO_WORDS": ms.UNDO_WORDS}
    assert len(re.findall(r"\bw \+= ", body)) == 13  # one per array of BatchShared
    assert _eval_strides(body, env) == ms.batch_words(k, cards)
    plog = re.search(r"#define PLOG_WORDS \(7 \+ sizeof\(Scalars\) / 4\)", text)
    fields = re.search(r"struct Scalars \{\s*int ([^;]+);", _source_text("solve_loop.cuh")).group(1).split(",")
    assert plog and ms.PLOG_WORDS == 7 + len(fields) == 14
    spec = re.search(r"int spec_words_of\(int J, int Q\) \{\s*return ([^;]+);", text).group(1)
    dims = fs.pack(carry.arrays_from_numpy(reference("synthetic_120_24", FLAGS)[0]), True, True).dims
    round4 = lambda n: (n + 3) & ~3  # noqa: E731
    assert eval(spec, {}, {"J": dims.J, "Q": dims.Q, "round4": round4}) == ms.spec_words(dims)
    assert re.search(r"#define SPEC_ITERS\(K\) \(4 \* \(K\)\)", text) and ms.spec_iterations(k) == 4 * k
    for name in ("mesh_solve.cu", "mesh_floor.cu"):
        with open(f"{nvcc.CSRC_DIR}/{name}") as f:
            slot = re.search(r"#define SLOT \(([^)]*)\)", f.read()).group(1)
        assert eval(slot, {}, {"REC": ms.REC, "BATCH_MAX": ms.BATCH_MAX}) == ms.SLOT, name


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
    cards, and the solve equals B1's. The world's chains meet overused-queue
    drops, some two (``test_a_chain_ends_before_its_second_queue_drop``)."""
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
def test_kernel_on_four_queues_equals_its_plain_version():
    """``multi_queue(200, 16, n_queues=4)`` over four cards of one solve on
    cuda:0 at K = 8, where chains meet two overused-queue drops (16 chains
    end before their second, see
    ``test_a_chain_ends_before_its_second_queue_drop``): every card's state
    buffers, with the rounds and speculated iterations, equal the plain
    version's, and the solve equals B1's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch.solve import solver_arrays

    a = carry.arrays_from_numpy(solver_arrays(models.multi_queue(200, 16, n_queues=4, tasks_per_job=4, seed=3))[1])
    cpu, cards = _cards_on_the_card(a, 4, 8)
    _launch_on_streams(cards, 8)
    ms.mesh_solve(cpu.cards, exchange_batch=8)
    for c, want in zip(cards, cpu.cards):
        assert int(c.state.istate[5]) == 0
        assert torch.equal(c.state.istate.cpu(), want.state.istate)
        assert torch.equal(c.state.fstate.cpu(), want.state.fstate)
    b1 = fs.FusedSolver(a, True, True, device="cuda:0").solve()
    got = fs._state_of(fs.PackedState(cards[0].state.dims, cards[0].state.istate.cpu(),
                                      cards[0].state.fstate.cpu()))
    for f in ("it", "step", "assigned_node", "assigned_kind", "assign_pos", "ready_cnt"):
        assert torch.equal(getattr(got, f), getattr(b1, f).cpu()), f


@pytest.mark.cuda
def test_kernel_on_the_two_drops_world_equals_its_plain_version():
    """The two-drops world over two cards of one solve on cuda:0 at
    K = 16: card 0's chain saves the runs of its first drop and ends
    before its second; every card's state buffers, with the rounds and
    speculated iterations (1; 8 and 4), equal the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    cpu, cards = _cards_on_the_card(_two_drops_arrays(), 2, 16)
    _launch_on_streams(cards, 16)
    ms.mesh_solve(cpu.cards, exchange_batch=16)
    for c, want in zip(cards, cpu.cards):
        assert torch.equal(c.state.istate.cpu(), want.state.istate)
        assert torch.equal(c.state.fstate.cpu(), want.state.fstate)
    assert [int(c.state.istate[i]) for c in cards for i in (5, 6, 7)] == [0, 1, 8, 0, 1, 4]


@pytest.mark.cuda
def test_kernel_round_gives_up_after_a_queue_drop_with_the_entry_state():
    """Card 0 of the two-drops world's two-card solve at K = 16, launched
    alone with a 100 ms bound: its chain places 8 tasks, drops queue a
    (its runs saved first) and ends before queue b's drop; the round gives
    up and the journal, the saved runs and the node undo bring every word
    of the state back to the entry state's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    cpu, cards = _cards_on_the_card(_two_drops_arrays(), 2, 16)
    entry_i, entry_f = cards[0].state.istate.clone(), cards[0].state.fstate.clone()
    _launch_on_streams(cards, 16, timeout_ms=100, only=1)
    got_i = cards[0].state.istate
    assert got_i[5:8].tolist() == [1, 1, 8]  # the abort (round 1), one round, its 8 speculated
    assert torch.equal(got_i[:5], entry_i[:5]) and torch.equal(got_i[8:], entry_i[8:])
    assert torch.equal(cards[0].state.fstate, entry_f)


@pytest.mark.cuda
def test_kernel_on_the_alternating_world_equals_its_plain_version():
    """The alternating world (encoded by the port) over two cards of one
    solve on cuda:0 at K = 4: every card's state buffers, with the rounds
    and speculated iterations (24; 72 and 90), equal the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    import kube_batch_tpu_torch.testing as testing
    from kube_batch_tpu_torch.solve import solver_arrays

    a = carry.arrays_from_numpy(solver_arrays(alternating_world(testing))[1])
    cpu, cards = _cards_on_the_card(a, 2, 4)
    _launch_on_streams(cards, 4)
    ms.mesh_solve(cpu.cards, exchange_batch=4)
    for c, want in zip(cards, cpu.cards):
        assert torch.equal(c.state.istate.cpu(), want.state.istate)
        assert torch.equal(c.state.fstate.cpu(), want.state.fstate)
    assert [int(c.state.istate[i]) for c in cards for i in (5, 6, 7)] == [0, 24, 72, 0, 24, 90]


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
