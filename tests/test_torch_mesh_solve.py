"""Kernel B4, the mesh rung's whole gang loop (``ops/mesh_solve.py``,
``csrc/mesh_solve.cu``), against the JAX package and the port's other
solves.

On the CPU, B4's plain version (B1's plain version over the cards' nodes
gathered at their rows) runs over explicit groupings of a mesh's shards
into cards (``MeshSolve(..., cards=...)`` on a mesh of CPU devices):
contiguous, interleaved, all on one card and uneven. On the same float32
snapshot, encoded by the JAX package with x64 off, every ``SolveState``
field must equal exactly

- the port's host loop (``impl="host_loop"``: the K = 1 exchange over the
  block step's plain version, one shard at a time),
- the JAX package's GSPMD-sharded solve on ``make_mesh(m)``
  (``ShardedSolver``, and ``sharded_solve_allocate``'s result), where the
  mesh divides the encoded node bucket, and
- the JAX single-chip solve (the twin ``solve_allocate_state``).

Then the pause and resume at pod-affinity host tasks through
``torch_allocate`` on a CPU mesh, the routing rules (B4 runs every K, the
host loop only by name; the device decides kernel or plain; a CUDA mesh
with no card raises), the card plan, the peer-access check (refused, never
switched) and a card that waited past the poll bound (the solve raises
and the solver refuses later solves). The cases marked ``cuda`` run the
kernel and skip without a GPU, among them the bound itself: one card of
a two-card solve launched alone gives up, and a peer launched late is
waited for; this module imports jax only inside the CPU cases' helpers, so the
card's machine (which has no jax) runs them with ``--noconftest``.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from kube_batch_tpu_torch.ops import carry
from kube_batch_tpu_torch.ops import fused_solve as fs
from kube_batch_tpu_torch.ops import mesh_solve as ms
from kube_batch_tpu_torch.parallel import ShardedBlockSolver

# (shards, grouping of the shards into cards)
GROUPINGS = {
    "m1": [0],
    "m2_contiguous": [0, 1],
    "m2_one_card": [0, 0],
    "m3_uneven": [0, 0, 1],
    "m3_contiguous": [0, 1, 2],
    "m4_interleaved": [0, 1, 0, 1],
    "m4_contiguous": [0, 1, 2, 3],
    "m4_one_card": [0, 0, 0, 0],
    "m8_contiguous": list(range(8)),
    "m8_interleaved": [0, 1, 2, 3, 0, 1, 2, 3],
}
SMALL_WORLDS = ("synthetic_120_24", "multi_queue_96_16", "contended_seed5")
FLAGS = {"drf_proportion": (True, True), "plain": (False, False)}
# the larger world over fewer groupings, for the file's clock
CASES = [(w, g, f) for w in SMALL_WORLDS for g in GROUPINGS for f in FLAGS] + [
    ("preempt_mix_2000_40_seed1", g, "drf_proportion") for g in ("m1", "m3_uneven", "m4_interleaved")
]


def _world(name: str):
    from kube_batch_tpu import models as jax_models

    if name == "contended_seed5":
        import test_xla_preempt as jax_preempt_tests

        return jax_preempt_tests.gen_contended_cluster(5)
    return {
        "synthetic_120_24": lambda: jax_models.synthetic(120, 24, seed=3),
        "multi_queue_96_16": lambda: jax_models.multi_queue(96, 16, n_queues=3, tasks_per_job=6, seed=7),
        "preempt_mix_2000_40_seed1": lambda: jax_models.preempt_mix(2000, 40, seed=1),
    }[name]()


def _np_state(s):
    return type(s)(*(np.asarray(x) for x in s))


@functools.lru_cache(maxsize=None)
def reference(world: str, flags: str):
    """(solver arrays, the JAX single-chip solve's SolveState)."""
    from kube_batch_tpu.ops.kernels import solve_allocate_state
    from kube_batch_tpu.testing import x64_enabled
    from test_torch_encode import jax_encode, solver_arrays

    drf, prop = FLAGS[flags]
    a = solver_arrays(jax_encode(_world(world), drf=drf, proportion=prop))
    with x64_enabled(False):
        twin = _np_state(solve_allocate_state(a, None, enable_drf=drf, enable_proportion=prop))
    return a, twin


@functools.lru_cache(maxsize=None)
def host_loop(world: str, flags: str, m: int):
    a, _ = reference(world, flags)
    solver = ShardedBlockSolver(carry.arrays_from_numpy(a), ["cpu"] * m, *FLAGS[flags], impl="host_loop")
    return carry.state_to_numpy(solver.solve())


@functools.lru_cache(maxsize=None)
def jax_sharded(world: str, flags: str, m: int):
    """The JAX GSPMD solve's SolveState and ``sharded_solve_allocate``'s
    result on ``make_mesh(m)``, or None where m does not divide the
    encoded node bucket (the JAX surface refuses it)."""
    from kube_batch_tpu.parallel import make_mesh as jax_make_mesh
    from kube_batch_tpu.parallel import sharded_solve_allocate as jax_sharded_solve_allocate
    from kube_batch_tpu.parallel.sharded import ShardedSolver
    from kube_batch_tpu.testing import x64_enabled

    a, _ = reference(world, flags)
    if a["node_idle"].shape[0] % m:
        return None
    drf, prop = FLAGS[flags]
    with x64_enabled(False):
        state = _np_state(ShardedSolver(a, jax_make_mesh(m), drf, prop).solve(None))
        result = jax_sharded_solve_allocate(a, jax_make_mesh(m), enable_drf=drf, enable_proportion=prop)
    return state, type(result)(*(np.asarray(x) for x in result))


def assert_states_equal(ref, got, ctx: str) -> None:
    for f in ref._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)), np.asarray(getattr(got, f)), err_msg=f"{ctx}: {f}")


@pytest.mark.parametrize("world,grouping,flags", CASES)
def test_plain_version_equals_host_loop_jax_sharded_and_single_chip(world, grouping, flags):
    """B4's plain version on every grouping of the mesh's shards into
    cards: field for field the host loop's, the JAX sharded solve's and
    the JAX single-chip solve's SolveState."""
    a, twin = reference(world, flags)
    cards = GROUPINGS[grouping]
    m = len(cards)
    launches = ms.mesh_solve.launches
    solver = ms.MeshSolve(carry.arrays_from_numpy(a), ["cpu"] * m, *FLAGS[flags], cards=cards)
    got = carry.state_to_numpy(solver.solve())
    assert ms.mesh_solve.launches == launches  # the CPU never launches
    ctx = f"{world} {grouping} {flags}"
    assert_states_equal(twin, got, f"{ctx} vs the JAX single-chip solve")
    assert_states_equal(host_loop(world, flags, m), got, f"{ctx} vs the host loop")
    jax = jax_sharded(world, flags, m)
    if jax is not None:
        state, result = jax
        assert_states_equal(state, got, f"{ctx} vs the JAX ShardedSolver")
        for f in ("assigned_node", "assigned_kind", "assign_pos", "ready_cnt"):
            np.testing.assert_array_equal(getattr(result, f), getattr(got, f), err_msg=f"{ctx}: {f}")
        assert int(result.n_assigned) == int(got.step)
    n_real = sum(1 for r in solver.plan.rows if r.size)
    assert solver.counts["cards"] == n_real == len(solver.plan.devices)
    assert solver.counts["placing_iterations"] == int((got.ptr - a["job_start"]).sum())
    assert solver.counts["iterations"] == int(got.it)


def test_plain_version_over_hand_built_cards_updates_them_in_place():
    """``mesh_solve`` on CPU cards built by hand from one packed snapshot
    (``take_nodes`` at each card's rows) runs the plain version: card 0
    ends with B1's replicated state, every card with B1's state of its own
    nodes, ``scal[5]`` 0 and ``scal[6]`` the placing iterations; the other
    cards' replicated state is left as it came, as the kernel leaves it."""
    a, _ = reference("multi_queue_96_16", "drf_proportion")
    ta = carry.arrays_from_numpy(a)
    packed = fs.pack(ta, True, True)
    from kube_batch_tpu_torch.ops.kernels import init_state

    full = fs.pack_state(packed.dims, init_state(ta, True, True), ta["job_queue"])
    want = fs.PackedState(packed.dims, full.istate.clone(), full.fstate.clone())
    fs.fused_solve_plain(packed, want)
    n = packed.dims.N
    rows = [torch.arange(1, n, 3), torch.arange(0, n, 3), torch.arange(2, n, 3)]  # each ascending
    cards = []
    for r in rows:
        d = ms.card_dims(packed.dims, r.numel())
        cards.append(ms.Card(
            fs.Packed(d, ms.take_nodes(packed.istatic, packed.dims.istatic(), d.istatic(), r),
                      ms.take_nodes(packed.fstatic, packed.dims.fstatic(), d.fstatic(), r)),
            r.to(torch.int32),
            fs.PackedState(d, ms.take_nodes(full.istate, packed.dims.istate(), d.istate(), r),
                           ms.take_nodes(full.fstate, packed.dims.fstate(), d.fstate(), r)),
        ))
    ms.mesh_solve(cards)
    got = fs.PackedState(packed.dims, full.istate.clone(), full.fstate.clone())
    for c, r in zip(cards, rows):
        ms.put_nodes(got.istate, c.state.istate, packed.dims.istate(), c.state.dims.istate(), r)
        ms.put_nodes(got.fstate, c.state.fstate, packed.dims.fstate(), c.state.dims.fstate(), r)
    ms._replicated_into(got, cards[0].state)
    for c in cards[1:]:
        assert torch.equal(c.state.views()["jptr"], full.views()["jptr"])
    placing = int((want.views()["jptr"] - full.views()["jptr"]).sum())
    for c in cards:
        assert c.state.views()["scal"][5:7].tolist() == [0, placing]
    got.views()["scal"][5:7] = 0
    for name, view in want.views().items():
        assert torch.equal(view, got.views()[name]), name


# -- pause and resume through the action on a CPU mesh -------------------------


@pytest.mark.parametrize("grouping", ["by_device", "card_per_shard"])
def test_pause_resume_through_torch_allocate_matches_jax_xla_allocate(monkeypatch, grouping):
    """Two pod-affinity host tasks: torch_allocate on ``mesh: cpu:4`` pauses
    B4's plain version at each, steps the task on the host, refreshes the
    affinity scores and resumes; the binds equal the JAX ``xla_allocate``'s
    on its 4-device mesh and the fused rung's. ``card_per_shard`` plans a
    card for every shard, as a mesh over four cards does, so each resume
    gathers and scatters every card's nodes."""
    import kube_batch_tpu.testing as jax_testing

    import kube_batch_tpu_torch.testing as tt
    from test_torch_parallel import TIERS_YAML, _affinity_world, _jax_action, _port_action

    if grouping == "card_per_shard":
        real = ms.plan_cards
        monkeypatch.setattr(ms, "plan_cards", lambda mesh, n, cards=None: real(mesh, n, list(range(len(mesh)))))
    seen = []
    real_solve = ms.MeshSolve.solve

    def solve(self, state=None):
        out = real_solve(self, state)
        seen.append((len(self.cards), int(out.paused_at)))
        return out

    monkeypatch.setattr(ms.MeshSolve, "solve", solve)
    sharded, mesh_n, tier = _port_action(_affinity_world(tt), TIERS_YAML, "cpu:4")
    assert mesh_n == 4 and tier == "sharded"
    cards = 4 if grouping == "card_per_shard" else 1
    assert len(seen) == 3 and {c for c, _ in seen} == {cards}
    assert [p >= 0 for _, p in seen] == [True, True, False]
    single, _, _ = _port_action(_affinity_world(tt), TIERS_YAML, "off")
    ref, _ = _jax_action(_affinity_world(jax_testing), TIERS_YAML, {"xla_allocate": {"mesh": "cpu:4"}})
    assert sharded == single == ref and len(sharded) == 12


# -- routing ---------------------------------------------------------------------


def _small():
    a, _ = reference("synthetic_120_24", "drf_proportion")
    return carry.arrays_from_numpy(a)


@pytest.mark.parametrize("k,impl,want", [
    (1, None, "mesh_kernel"), (2, None, "mesh_kernel"), (4, None, "mesh_kernel"),
    (1, "host_loop", "host_loop"), (4, "host_loop", "host_loop"), (1, "mesh_kernel", "mesh_kernel"),
    (2, "mesh_kernel", "mesh_kernel"), (1, "nccl", ValueError), (65, None, ValueError),
])
def test_exchange_batch_alone_picks_the_implementation(k, impl, want):
    """B4 runs every K (its plain version on the CPU; K = 1 to 64); the
    host loop, at any K, is only asked for by name (``impl``, which no conf
    reaches)."""
    if want is ValueError:
        with pytest.raises(ValueError):
            ShardedBlockSolver(_small(), ["cpu"] * 2, True, True, exchange_batch=k, impl=impl)
        return
    solver = ShardedBlockSolver(_small(), ["cpu"] * 2, True, True, exchange_batch=k, impl=impl)
    assert solver.impl == want
    assert_states_equal(reference("synthetic_120_24", "drf_proportion")[1], carry.state_to_numpy(solver.solve()),
                        f"K={k} {impl}")
    if want == "host_loop":
        assert len(solver.blocks) == 2 and solver.counts["placing_iterations"] > 0
    assert (solver.batched_iters > 0) == (k > 1)


@pytest.mark.parametrize("k,want", [("1", "mesh_kernel"), ("2", "mesh_kernel")])
def test_torch_allocate_records_the_sharded_implementation(k, want):
    """``last_timings["sharded_impl"]`` names what the sharded rung ran."""
    import kube_batch_tpu_torch.testing as tt
    from kube_batch_tpu_torch.conf import parse_scheduler_conf
    from kube_batch_tpu_torch.framework import close_session, get_action, open_session
    from kube_batch_tpu_torch import models
    from test_torch_parallel import TIERS_YAML

    cache = tt.FakeCache(models.synthetic(48, 8, seed=5))
    ssn = open_session(cache, parse_scheduler_conf(TIERS_YAML).tiers,
                       {"torch_allocate": {"device": "cpu", "mesh": "cpu:2", "exchange_batch": k}})
    action = get_action("torch_allocate")
    action.execute(ssn)
    close_session(ssn)
    assert action.last_solver_tier == "sharded" and action.last_timings["sharded_impl"] == want
    assert cache.binder.binds


def test_the_device_decides_kernel_or_plain():
    """A CPU mesh runs the plain version and launches nothing; a mixed
    mesh, a mesh solve over cards of two device types, or two cards on one
    device raise; a CUDA mesh with no card visible raises and never falls
    back to the CPU."""
    a = _small()
    solver = ms.MeshSolve(a, ["cpu"] * 4, True, True, cards=[0, 1, 0, 1])
    assert all(c.xbuf is None and c.device.type == "cpu" for c in solver.cards)
    with pytest.raises(ValueError, match="all cuda or all cpu"):
        ShardedBlockSolver(a, ["cpu", "cuda:0"], True, True)
    cards = solver.cards
    meta = ms.Card(cards[0].packed, cards[0].gidx, cards[0].state, None)
    with pytest.raises(ValueError):
        ms.mesh_solve([meta, ms.Card(fs.Packed(cards[1].packed.dims, cards[1].packed.istatic.to("meta"),
                                               cards[1].packed.fstatic.to("meta")),
                                      cards[1].gidx, cards[1].state)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedBlockSolver(a, ["cuda:0"] * 2, True, True)


@pytest.mark.parametrize("missing", [[(0, 1), (1, 0)], [(1, 0)], [(2, 3)]])
def test_a_mesh_without_peer_access_is_refused(missing):
    """Every ordered pair of distinct cards needs peer access: a pair
    without it makes building the solver raise (the ladder then degrades
    the cycle to the fused rung, logged and counted); the host loop never
    takes over quietly. The check runs before anything touches a card."""
    n = 1 + max(max(p) for p in missing)
    mesh = [f"cuda:{i}" for i in range(n)]
    asked = []

    def can_access(i, j):
        asked.append((i, j))
        return (i, j) not in missing

    with pytest.raises(RuntimeError, match="peer access") as err:
        ms.MeshSolve(_small(), mesh, True, True, can_access=can_access)
    for i, j in missing:
        assert f"cuda:{i}->cuda:{j}" in str(err.value)
    assert sorted(asked) == sorted((i, j) for i in range(n) for j in range(n) if i != j)
    ms.check_peer_access([torch.device("cuda", i) for i in range(n)], lambda i, j: True)  # all pairs: no error


@pytest.mark.parametrize("card", [0, 1])
def test_a_card_that_waited_past_the_bound_fails_the_solve_and_the_solver(monkeypatch, card):
    """A card whose abort word (``scal[5]``) comes back set, as a kernel
    whose peer never answered leaves it: the solve raises, naming the card
    and the exchange, and the solver refuses every later solve (its cards'
    state is no longer one solve's)."""
    real = ms.mesh_solve_plain

    def gave_up(cards, exchange_batch=1):
        real(cards, exchange_batch)
        cards[card].state.views()["scal"][5] = 3

    solver = ms.MeshSolve(_small(), ["cpu"] * 2, True, True, cards=[0, 1])
    want = carry.state_to_numpy(solver.solve())
    monkeypatch.setattr(ms, "mesh_solve_plain", gave_up)
    with pytest.raises(RuntimeError, match="waited past") as err:
        solver.solve()
    assert "{'cpu': 3}" in str(err.value) and solver.broken
    monkeypatch.setattr(ms, "mesh_solve_plain", real)
    with pytest.raises(RuntimeError, match="cannot resume"):
        solver.solve()
    fresh = ms.MeshSolve(_small(), ["cpu"] * 2, True, True, cards=[0, 1])
    assert_states_equal(want, carry.state_to_numpy(fresh.solve()), "a fresh solver")


# -- the card plan ---------------------------------------------------------------


@pytest.mark.parametrize("n,cards,rows,of", [
    (10, None, [list(range(10))], [0, 0, 0, 0]),
    (10, [0, 1, 0, 1], [[0, 1, 2, 6, 7, 8], [3, 4, 5, 9]], [0, 1, 0, 1]),
    (10, [5, 5, 2], [[0, 1, 2, 3, 4, 5, 6, 7], [8, 9]], [0, 0, 1]),
    (3, [0, 1, 2, 3], [[0], [1], [2]], [0, 1, 2, -1]),
    (1, [0, 1, 2, 3], [[0]], [0, -1, -1, -1]),
])
def test_card_plan(n, cards, rows, of):
    """A card holds the blocks of its shards in row order; cards are
    numbered by their first shard (card 0 holds shard 0); a card of pad
    nodes only is left out."""
    m = len(cards) if cards is not None else 4
    plan = ms.plan_cards(["cpu"] * m, n, cards)
    assert [r.tolist() for r in plan.rows] == rows
    assert list(plan.card_of_shard) == of
    assert len(plan.devices) == len(rows)


def test_card_plan_on_a_cuda_mesh_is_its_devices():
    """On a CUDA mesh the cards are the devices: a grouping that splits a
    device or joins two is refused; repeated and interleaved devices
    group by device, card 0 holding shard 0."""
    mesh = ["cuda:1", "cuda:0", "cuda:1", "cuda:0"]
    plan = ms.plan_cards(mesh, 100, None)
    assert [str(d) for d in plan.devices] == ["cuda:1", "cuda:0"]
    assert [r[:3].tolist() for r in plan.rows] == [[0, 1, 2], [25, 26, 27]]
    assert ms.plan_cards(mesh, 100, [7, 3, 7, 3]).rows[0].tolist() == plan.rows[0].tolist()
    for bad in ([0, 1, 2, 3], [0, 0, 0, 0]):
        with pytest.raises(ValueError, match="cards are its devices"):
            ms.plan_cards(mesh, 100, bad)
    with pytest.raises(ValueError, match="limit of 8"):
        ms.plan_cards(["cpu"] * 9, 100, list(range(9)))


def test_take_and_put_nodes_round_trip():
    """A card's buffer holds the node fields at its rows and the rest
    whole; putting it back restores the full buffer."""
    a = _small()
    packed = fs.pack(a, True, True)
    rows = torch.tensor([0, 3, 4, 9, 100])
    d = ms.card_dims(packed.dims, rows.numel())
    card = ms.take_nodes(packed.fstatic, packed.dims.fstatic(), d.fstatic(), rows)
    cv, fv = fs._views(card, d.fstatic()), packed.views()
    n = packed.dims.N
    assert torch.equal(cv["affw"].view(-1, 5), fv["affw"].view(-1, n)[:, rows])
    assert torch.equal(cv["creq"], fv["creq"])
    back = torch.zeros_like(packed.fstatic)
    ms.put_nodes(back, card, packed.dims.fstatic(), d.fstatic(), rows)
    assert torch.equal(fs._views(back, packed.dims.fstatic())["nalloc"].view(2, n)[:, rows],
                       fv["nalloc"].view(2, n)[:, rows])


# -- the kernel, on a card ---------------------------------------------------------


def _card_world():
    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch.solve import solver_arrays

    return carry.arrays_from_numpy(solver_arrays(models.preempt_mix(2000, 40, seed=1))[1])


@pytest.mark.cuda
@pytest.mark.parametrize("grouping", ["one_card_4", "one_card_1", "cards", "interleaved"])
def test_kernel_equals_its_plain_version_and_b1(grouping):
    """B4 on the card, field for field its plain version on the CPU (the
    same grouping of cards), B1's and the host loop's over B2."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    n = torch.cuda.device_count()
    if grouping in ("cards", "interleaved") and n < 2:
        pytest.skip("needs two or more NVIDIA GPUs: the exchange between cards")
    mesh = {
        "one_card_4": ["cuda:0"] * 4, "one_card_1": ["cuda:0"],
        "cards": [f"cuda:{i}" for i in range(n)], "interleaved": [f"cuda:{i % 2}" for i in range(4)],
    }[grouping]
    a = _card_world()
    b1 = fs.FusedSolver(a, True, True, device="cuda:0").solve()
    launches = ms.mesh_solve.launches
    solver = ShardedBlockSolver(a, mesh, True, True)
    got = solver.solve()
    assert ms.mesh_solve.launches - launches == len(set(mesh))
    cards = ms.plan_cards(mesh, a["node_idle"].shape[0]).card_of_shard
    plain = ms.MeshSolve(a, ["cpu"] * len(mesh), True, True, cards=list(cards)).solve()
    host = ShardedBlockSolver(a, ["cuda:0"] * 4, True, True, impl="host_loop").solve()
    for f in got._fields:
        for name, ref in (("plain", plain), ("B1", b1), ("host loop", host)):
            assert torch.equal(getattr(got, f), getattr(ref, f)), f"{grouping}: {f} differs from {name}"
    assert solver.counts["placing_iterations"] == int((got.ptr - a["job_start"]).sum())


@pytest.mark.cuda
def test_kernel_pauses_and_resumes_over_the_cards():
    """A host-only task mid-solve: B4 pauses at it on every card, and a
    resume from the paused state (the task stepped on the host by hand)
    runs on with a new epoch over the same exchange buffers, equal to B1
    segment for segment."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    a = _card_world()
    t = int(a["job_start"][7])
    a["task_host_only"] = a["task_host_only"].clone()
    a["task_host_only"][t] = True
    mesh = [f"cuda:{i % torch.cuda.device_count()}" for i in range(4)]
    b1 = fs.FusedSolver(a, True, True, device="cuda:0")
    b4 = ShardedBlockSolver(a, mesh, True, True)
    want, got = b1.solve(), b4.solve()
    assert int(got.paused_at) == t
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    state = got._replace(paused_at=torch.tensor(-1, dtype=torch.int32), ptr=got.ptr.clone())
    state.ptr[int(got.cur)] += 1  # the host "steps" the task by skipping it
    want, got = b1.solve(state), b4.solve(state)
    assert int(got.paused_at) == -1
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def _cards_on_the_card(world, m: int = 2):
    """A CPU mesh solve over ``m`` cards with its entry state loaded, and
    the same cards copied to cuda:0 with an exchange buffer each: ``m``
    cards of one solve on one device, for launches by hand."""
    cpu = ms.MeshSolve(world, ["cpu"] * m, True, True, cards=list(range(m)))
    cpu._load(None)
    dev = torch.device("cuda", 0)
    cards = [
        ms.Card(c.packed.to(dev), c.gidx.to(dev), fs.PackedState(c.state.dims, c.state.istate.to(dev),
                                                                c.state.fstate.to(dev)),
                torch.zeros(ms.XBUF_WORDS, dtype=torch.int32, device=dev))
        for c in cpu.cards
    ]
    return cpu, cards


@pytest.mark.cuda
@pytest.mark.parametrize("nodes", [40, 2200])
def test_kernel_gives_up_on_a_peer_that_never_runs(nodes):
    """Card 0 of a two-card solve launched alone, with a 100 ms bound: it
    waits for card 1's record of the first placing iteration, gives up,
    sets its abort word to that exchange's number (1) and ends; every CTA
    of its cluster leaves (1,100 nodes a card: a cluster of several CTAs),
    and the card runs the next kernel."""
    import time

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from kube_batch_tpu_torch import models
    from kube_batch_tpu_torch.solve import solver_arrays

    a = carry.arrays_from_numpy(solver_arrays(models.preempt_mix(2000 if nodes == 40 else 5000, nodes, seed=1))[1])
    _, cards = _cards_on_the_card(a)
    lib, prepared, index = ms._prepare(cards, 0, timeout_ms=100)
    assert (prepared[0][0].s.k > 1) == (nodes > 40)
    t0 = time.perf_counter()
    ms._launch_cards(lib, prepared[:1], index[:1], None)
    torch.cuda.synchronize()
    waited = time.perf_counter() - t0
    assert cards[0].state.istate[5:7].tolist() == [1, 1] and waited >= 0.1
    assert int(cards[0].xbuf[-ms.REC]) == 1  # the abort word
    b1 = fs.FusedSolver(a, True, True, device="cuda:0").solve()
    assert int(b1.step) > 0


@pytest.mark.cuda
def test_kernel_waits_for_a_late_peer():
    """Two cards of one solve on two streams of cuda:0, the second
    launched 300 ms after the first, within the poll bound: the first
    waits, both finish with no abort, and every card's buffers equal the
    plain version's on the same cards."""
    import time

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    cpu, cards = _cards_on_the_card(_card_world())
    lib, prepared, index = ms._prepare(cards, 0)
    # a stream of its own for each card (torch's are non-blocking), after
    # the cards' copies have landed
    prepared = [(args, scratch, torch.cuda.Stream(device=0)) for args, scratch, _ in prepared]
    torch.cuda.synchronize()
    ms._launch_cards(lib, prepared[:1], index[:1], None)
    time.sleep(0.3)
    ms._launch_cards(lib, prepared[1:], index[1:], None)
    torch.cuda.synchronize()
    ms.mesh_solve(cpu.cards)
    for c, want in zip(cards, cpu.cards):
        assert int(c.state.istate[5]) == 0
        assert torch.equal(c.state.istate.cpu(), want.state.istate)
        assert torch.equal(c.state.fstate.cpu(), want.state.fstate)
