"""The mesh rung's whole gang loop on the cards (kernel B4): card plan,
per-card packing, plain version, kernel wrapper and per-solve runner.

The counterpart of the SPMD program of the JAX package's mesh rung
(kube_batch_tpu/parallel/sharded_pallas.py ``_blocked_programs``, its
per-shard body ``local``): every shard runs the whole gang loop, selects
and pops replicated, sweeps its own node block, exchanges one (score,
row, fits-idle) record per placing iteration with every other shard and
applies the winner. Here the unit is the card, not the shard: one launch
per card covers the node blocks of every shard of the mesh that lies on
that card (``plan_cards``), so four shards on one card are one launch
that exchanges nothing, and four shards on four cards are four launches
that exchange through peer memory inside the kernel (csrc/mesh_solve.cu,
built on B1's loop, csrc/solve_loop.cuh).

Layout: each card gets B1's packed buffers (``ops.fused_solve``) over its
own nodes, the union of its shards' blocks minus the pad nodes (which
never fit), in ascending row order, plus ``gidx``, each node's row. Its
state buffers carry the whole replicated state; at exit every card holds
its own nodes' state, and card 0 (the primary card, which holds shard 0)
the replicated state. ``scal[5]`` is the card's abort word (0 when every
peer answered), ``scal[6]`` the launch's placing iterations.

With ``exchange_batch = K > 1`` over two or more cards the launches run
the JAX program's K-deep batched exchange instead (sharded_pallas.py
:495-621), the card the unit of speculation: each card speculates up to K
placing iterations with its own best winning and writes a record of each
(score, row, local index and fits-idle bit, the task class's key,
``class_keys``) into every card's buffer, with a round-start record for
each other key its chain met (its best over its unchanged nodes); one
exchange a round; then every card replays the true iterations from the
records, a card that has won nothing in the round answering from its
round-start records (``_batched_plain``'s rule; csrc/mesh_solve.cu's
header). ``scal[6]`` is then the rounds and ``scal[7]`` the card's
speculated placing iterations. One card exchanges nothing and runs its
K = 1 loop at any K.

``mesh_solve(cards, ...)`` launches B4 on every card when the buffers lie
on CUDA devices and runs ``mesh_solve_plain`` when they lie on the CPU:
B1's plain version over the cards' nodes gathered at their rows, since
the winner over any grouping is the single-card arg-max over rows, or at
K > 1 the batched exchange over the same gathered buffers
(``_batched_plain``). ``MeshSolve`` runs each solve behind
``ShardedBlockSolver`` on a mesh, at every K: it speaks the twin's
``SolveState`` protocol (pause at a host-only task, resume, re-fold the
affinity scores when the caller replaced ``a["pod_sc"]``).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import threading
import time
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from kube_batch_tpu_torch.ops import encode_cache, nvcc
from kube_batch_tpu_torch.ops import fused_solve as fs
from kube_batch_tpu_torch.ops.cluster import CTA_WIDTH
from kube_batch_tpu_torch.ops.kernels import GangLoop, SolveState, init_state
from kube_batch_tpu_torch.parallel.sharded import node_blocks

MAX_CARDS = 8  # csrc/mesh_solve.cu MAX_CARDS: the most cards one host joins all to all
REC = 4  # int32 words of one exchange record
BATCH_MAX = 64  # the deepest batched exchange (csrc/mesh_solve.cu BATCH_MAX; the K rule's clamp)
# one card's records of a round: a header (stamp, chain records, round-start
# records, pad), BATCH_MAX chain records, then BATCH_MAX round-start records
SLOT = REC + 2 * BATCH_MAX * REC
# K = 1's records for both parities, the rounds' slots for both parities,
# then the abort word and pad (the last REC words)
XBUF_WORDS = 2 * MAX_CARDS * REC + 2 * MAX_CARDS * SLOT + REC
UNDO_WORDS = 3 + 3 * fs.R8  # csrc/solve_loop.cuh UNDO_WORDS: one node's old values
# csrc/solve_loop.cuh: the region journal's entries (thread 0's; threads 32
# and 64's), the multi-key sweep's chunk and its staged task rows
LOG0_WORDS = 5
LOG_ROW_WORDS = 2 + fs.R8
KEY_CHUNK = 8
TASK_WORDS = 32
PLOG_WORDS = 14  # csrc/mesh_solve.cu: one chain iteration's log (7 words, then its 7 scalars)
NWARPS = CTA_WIDTH // 32
MAX_CLUSTER = 16
TIMEOUT_MS = 5_000  # a poll's bound: a live peer answers in microseconds

# The packed fields that run over the node axis, [X, N] with X rows: the
# rest (tasks, classes, jobs, queues, scalars) every card carries whole.
NODE_FIELDS = frozenset({"cnode", "affw", "nalloc", "nmax", "nihs", "nrhs", "ntasks", "nports", "idle", "rel", "used"})


@dataclass(frozen=True)
class CardPlan:
    """Which card holds which nodes. ``devices`` has one entry per card,
    card 0 holding shard 0 (the primary card, which writes the replicated
    state back); ``card_of_shard`` maps each shard of the mesh to its card;
    ``rows`` are each card's nodes, ascending, pad nodes left out."""

    devices: tuple[torch.device, ...]
    card_of_shard: tuple[int, ...]
    rows: tuple[np.ndarray, ...]


def plan_cards(mesh: Sequence, n_nodes: int, cards: Sequence[int] | None = None) -> CardPlan:
    """Group the mesh's shards into cards: by device (the default), or by
    ``cards``, one card label per shard, which a CPU mesh may set freely
    (to test groupings) and a CUDA mesh only as its devices group (one
    launch per card: two cards on one device would wait on each other).
    Cards are numbered by their first shard; a card whose shards hold only
    pad nodes is left out (nothing of it can win)."""
    mesh = tuple(torch.device(d) for d in mesh)
    m = len(mesh)
    if m < 1:
        raise ValueError("a mesh needs at least one device")
    by_device = [list(dict.fromkeys(mesh)).index(d) for d in mesh]
    if cards is None:
        labels = by_device
    else:
        labels = list(cards)
        if len(labels) != m:
            raise ValueError(f"cards names {len(labels)} cards for a mesh of {m} shards")
        if mesh[0].type == "cuda":
            same = all((labels[i] == labels[j]) == (mesh[i] == mesh[j]) for i in range(m) for j in range(m))
            if not same:
                raise ValueError(f"on a CUDA mesh the cards are its devices: cards={labels} for {list(map(str, mesh))}")
    blocks = node_blocks(n_nodes, m)
    order = list(dict.fromkeys(labels))
    rows, devices, card_of = [], [], []
    kept: dict = {}
    for label in order:
        shards = [k for k in range(m) if labels[k] == label]
        r = np.concatenate([np.arange(lo, min(hi, n_nodes)) for lo, hi in (blocks[k] for k in shards)])
        if r.size == 0:
            continue
        kept[label] = len(rows)
        rows.append(np.sort(r).astype(np.int64))
        devices.append(mesh[shards[0]])
    if len(devices) > MAX_CARDS:
        raise ValueError(f"{len(devices)} cards exceed the mesh solve's limit of {MAX_CARDS}")
    for k in range(m):
        card_of.append(kept.get(labels[k], -1))  # -1: a card of pad nodes only
    return CardPlan(tuple(devices), tuple(card_of), tuple(rows))


def card_dims(dims: fs.Dims, n: int) -> fs.Dims:
    return dataclasses.replace(dims, N=n)


def take_nodes(full: torch.Tensor, spec_full, spec_card, rows: torch.Tensor, out: torch.Tensor | None = None,
               replicated: bool = True):
    """A card's buffer from a full-width one (both 1-d, in the layouts of
    ``spec_full`` and ``spec_card``): node fields at ``rows``, the rest
    copied unless ``replicated`` is false. Into ``out`` when given."""
    n_full = dict(spec_full)
    if out is None:
        out = torch.empty(fs._offsets(spec_card)[1], dtype=full.dtype)
    fv, cv = fs._views(full, spec_full), fs._views(out, spec_card)
    nc = rows.numel()
    for name, n in spec_card:
        if name not in NODE_FIELDS:
            if replicated:
                cv[name].copy_(fv[name])
        elif n:
            x = n // nc
            cv[name].view(x, nc).copy_(fv[name].view(x, n_full[name] // x)[:, rows])
    return out


def put_nodes(full: torch.Tensor, card: torch.Tensor, spec_full, spec_card, rows: torch.Tensor) -> None:
    """The node fields of a card's buffer into a full-width one, at
    ``rows``."""
    n_full = dict(spec_full)
    fv, cv = fs._views(full, spec_full), fs._views(card, spec_card)
    nc = rows.numel()
    for name, n in spec_card:
        if name in NODE_FIELDS and n:
            x = n // nc
            fv[name].view(x, n_full[name] // x)[:, rows] = cv[name].view(x, nc)


@dataclass
class Card:
    """One card's launch of a mesh solve: B1's packed statics and state
    over the card's own nodes, ``gidx`` (int32 [N], each node's row,
    ascending), on a CUDA card of a solve over several cards its exchange
    buffer (int32 [XBUF_WORDS], zeroed once) and, for the batched exchange
    on the cards, ``ckey`` (``class_keys``, int32 [C], on the card)."""

    packed: fs.Packed
    gidx: torch.Tensor
    state: fs.PackedState
    xbuf: torch.Tensor | None = None
    ckey: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.state.istate.device


def class_keys(packed: fs.Packed) -> torch.Tensor:
    """int32 [C]: each task class's key in the batched exchange's records,
    equal for classes whose sweep fields are equal (group, scalar flag,
    host ports, request and resource rows: the JAX program's validity test,
    sharded_pallas.py:560-567, compares exactly these). Classes differing
    only in fields no sweep reads (the resource scalar flag, host-only)
    share a key."""
    d, v = packed.dims, packed.views()
    C, R = d.C, d.R
    fields = np.concatenate([
        np.stack([v["cgid"].numpy(), v["chs"].numpy(), v["cpt"].numpy()], axis=1).astype(np.float64),
        v["creq"].view(R, C).T.numpy().astype(np.float64) + 0.0,  # -0.0 and 0.0 are one value
        v["cres"].view(R, C).T.numpy().astype(np.float64) + 0.0,
    ], axis=1)
    _, inv = np.unique(fields, axis=0, return_inverse=True)
    return torch.from_numpy(inv.reshape(-1).astype(np.int32))


def spec_iterations(exchange_batch: int) -> int:
    """The most iterations, placing or not, one card speculates in a round
    of the batched exchange (csrc/mesh_solve.cu SPEC_ITERS): 4 K, the
    capacity of the round's journal of the replicated region. A chain that
    reaches it stops, as at a pause; the replay runs on through iterations
    that need no record."""
    return 4 * exchange_batch


def _speculate(g: GangLoop, s, mask: torch.Tensor, key: list[int], it: int, step: int, cur: int, paused: int,
               K: int) -> tuple[list, list[int], bool]:
    """One card's chain of a round: up to K placing iterations (at most
    ``spec_iterations(K)`` iterations) from the true state ``s`` on a copy
    of it, this card's best (over ``mask``) always winning. Returns the
    records (score, row or None, fits-idle, key), their tasks, and whether
    the chain stopped before a second overused-queue drop: the kernel saves
    the runs a drop retires once a chain, so a chain meets at most one drop
    and ends before the next, as at a pause."""
    sc = type(s)(*(x.clone() for x in s))
    rc, tasks, n, dropped = [], [], 0, int(sc.q_dropped.sum())
    while len(rc) < K and n < spec_iterations(K) and g.cond(sc, cur, it, paused):
        cur = g.select(sc, cur)  # drops at most one queue
        if int(sc.q_dropped.sum()) > dropped + 1:  # the chain's second drop (the copy is thrown away)
            return rc, tasks, True
        t, drop, pause, proc = g.pop(sc, cur)
        any_cand, nb, fits = False, 0, False
        if proc:
            any_cand, nb, fits, score = g.sweep(sc, t, mask)
            rc.append((score, nb if any_cand else None, fits, key[t]))
            tasks.append(t)
        cur, paused, assign = g.commit(sc, cur, t, drop, pause, proc, any_cand, nb, fits, step)
        it += 1
        step += int(assign)
        n += 1
    return rc, tasks, False


def _batched_plain(packed: fs.Packed, state: fs.PackedState, rows: list[torch.Tensor], K: int) -> tuple[int, list]:
    """The JAX program's K-deep batched exchange (sharded_pallas.py
    :495-621) over full-width buffers, a card (``rows``) the unit of
    speculation, with exact records past a mismatch. A round:

    - each card speculates up to K placing iterations on a copy of the
      state with its own best always winning, and records (score, row,
      fits-idle, key) for each (the chain, ``_speculate``); then, over its
      round-start block, one round-start record for each distinct key
      among the chain's records after the first (the first is the
      round-start record of its own key);
    - the replay runs the true iterations. Card c answers a placing
      iteration of key k from its chain record at its pointer when it has
      won only through its chain so far and that record's key is k (the
      JAX rule), else, while it has won nothing this round, from its
      round-start record of key k; a card that can answer neither way
      stops the replay before the iteration (the next round speculates it
      again). The winner is the highest score, then the lowest row. A
      winner that answered from its chain advances its pointer; one that
      answered from a round-start record leaves its chain (its block is
      no longer any of the chain's). A global abandon (no candidate on any
      card) changes no block: the cards that answered from their chains
      advance their pointers.

    Every record the replay reads is a card's best over its block as it
    truly stands, so the result is the JAX program's (and K = 1's) bit for
    bit; a round commits at least what the JAX rule commits from the same
    state. Updates ``state`` in place; returns the rounds and each card's
    speculated placing iterations."""
    d = packed.dims
    g = GangLoop(fs._twin_arrays(packed), d.drf, d.proportion)
    s = fs._state_of(state)
    masks = []
    for r in rows:
        mask = torch.zeros(d.N, dtype=torch.bool)
        mask[r] = True
        masks.append(mask)
    key = class_keys(packed)[packed.views()["tcls"].long()].tolist()
    it, step, cur, paused = int(s.it), int(s.step), int(s.cur), int(s.paused_at)
    rounds, speculated = 0, [0] * len(rows)
    while True:
        # the iterations before the next placing one place nothing: every
        # card's chain and the replay would run them alike, so they commit
        proc = False
        while g.cond(s, cur, it, paused):
            cur = g.select(s, cur)
            t, drop, pause, proc = g.pop(s, cur)
            if proc:
                break
            cur, paused, _ = g.commit(s, cur, t, drop, pause, proc, False, 0, False, step)
            it += 1
        if not proc:
            break
        chains, starts = [], []
        for c, mask in enumerate(masks):
            rc, tasks, _ = _speculate(g, s, mask, key, it, step, cur, paused, K)
            start = {}
            if rc:  # the round-start records: the chain's first, then one sweep for every other key
                start[rc[0][3]] = rc[0]
                for t in tasks[1:]:
                    if key[t] not in start:
                        any_cand, nb, fits, score = g.sweep(s, t, mask)
                        start[key[t]] = (score, nb if any_cand else None, fits, key[t])
            chains.append(rc)
            starts.append(start)
            speculated[c] += len(rc)
        rounds += 1
        m = len(rows)
        depth, fresh, chained, it0 = [0] * m, [True] * m, [True] * m, it
        while g.cond(s, cur, it, paused):
            cur0 = cur
            cur = g.select(s, cur)  # a placing iteration's selection changes no state
            t, drop, pause, proc = g.pop(s, cur)
            any_cand, nb, fits = False, 0, False
            if proc:
                k, now, from_chain = key[t], [], []
                for c in range(m):
                    p, rc = depth[c], chains[c]
                    if chained[c] and p < len(rc) and rc[p][3] == k:
                        now.append(rc[p])
                        from_chain.append(True)
                    elif fresh[c] and k in starts[c]:
                        now.append(starts[c][k])
                        from_chain.append(False)
                    else:
                        break
                if len(now) < m:
                    cur = cur0
                    break
                top = max(r[0] for r in now)
                any_cand = top > float("-inf")
                if any_cand:
                    nb = min(r[1] for r in now if r[0] == top)
                    win = next(c for c, r in enumerate(now) if r[1] == nb)
                    fits = now[win][2]
                    fresh[win] = False
                    if from_chain[win]:
                        depth[win] += 1
                    else:
                        chained[win] = False
                else:  # a global abandon: every card's record was -inf
                    depth = [p + int(f) for p, f in zip(depth, from_chain)]
            cur, paused, assign = g.commit(s, cur, t, drop, pause, proc, any_cand, nb, fits, step)
            it += 1
            step += int(assign)
        if it == it0:
            raise RuntimeError("the batched exchange's replay committed no iteration")
    s = s._replace(it=torch.tensor(it, dtype=torch.int32), step=torch.tensor(step, dtype=torch.int32),
                   cur=torch.tensor(cur, dtype=torch.int32), paused_at=torch.tensor(paused, dtype=torch.int32))
    out = fs.pack_state(d, s, packed.views()["jqueue"])
    out.views()["scal"][3] = paused
    state.istate.copy_(out.istate)
    state.fstate.copy_(out.fstate)
    return rounds, speculated


def mesh_solve_plain(cards: Sequence[Card], exchange_batch: int = 1) -> None:
    """Plain version of the kernel, over the same per-card buffers and
    updating them in place as the kernel does. At K = 1, or on one card:
    B1's plain version (``fused_solve_plain``) over the cards' nodes
    gathered at their rows. The cards hold every real node of the mesh
    once, and the kernel's winner over cards (highest score, then lowest
    row, the fits-idle bit from the owner) is the single-card arg-max over
    rows, so one loop is the reference for every grouping. At K =
    ``exchange_batch`` > 1 over two or more cards: the JAX program's
    batched exchange with the card as the unit of speculation
    (``_batched_plain``), whose result is the same. At exit every card
    holds its nodes' state, ``scal[5]`` 0, ``scal[6]`` the placing
    iterations (K = 1, or one card) or the rounds, and ``scal[7]`` its
    speculated placing iterations (0 at K = 1, or on one card); card 0 the
    replicated state."""
    p = cards[0]
    rows = [c.gidx.long() for c in cards]
    n = sum(r.numel() for r in rows)
    if not torch.equal(torch.cat(rows).sort().values, torch.arange(n)):
        raise ValueError(f"the cards' rows are not the nodes 0..{n - 1}, each once")
    d = card_dims(p.packed.dims, n)
    specs = (d.istatic(), d.fstatic(), d.istate(), d.fstate())
    full = [torch.zeros(fs._offsets(spec)[1], dtype=torch.int32 if i % 2 == 0 else torch.float32)
            for i, spec in enumerate(specs)]
    for i, c in enumerate(cards):
        bufs = (c.packed.istatic, c.packed.fstatic, c.state.istate, c.state.fstate)
        card_specs = (c.packed.dims.istatic(), c.packed.dims.fstatic(), c.state.dims.istate(), c.state.dims.fstate())
        for f, buf, spec, card_spec in zip(full, bufs, specs, card_specs):
            if i == 0:
                _copy_replicated(f, buf, spec, card_spec)
            put_nodes(f, buf, spec, card_spec, rows[i])
    packed, state = fs.Packed(d, full[0], full[1]), fs.PackedState(d, full[2], full[3])
    jptr = state.views()["jptr"].clone()
    if exchange_batch > 1 and len(cards) > 1:
        rounds, speculated = _batched_plain(packed, state, rows, exchange_batch)
    else:
        fs.fused_solve_plain(packed, state)
        rounds, speculated = int((state.views()["jptr"] - jptr).sum()), [0] * len(cards)
    for i, (c, r) in enumerate(zip(cards, rows)):
        take_nodes(state.istate, d.istate(), c.state.dims.istate(), r, out=c.state.istate, replicated=i == 0)
        take_nodes(state.fstate, d.fstate(), c.state.dims.fstate(), r, out=c.state.fstate, replicated=i == 0)
        c.state.views()["scal"][5:8] = torch.tensor([0, rounds, speculated[i]], dtype=torch.int32)


# -- the CUDA kernel: build, bind, launch ------------------------------------


class _Args(ctypes.Structure):
    """Mirror of `struct MeshArgs` in csrc/mesh_solve.cu (same order)."""

    _fields_ = [
        ("s", fs._Args), ("gidx", ctypes.c_void_p), ("xbuf", ctypes.c_void_p * MAX_CARDS),
        ("card", ctypes.c_int), ("m", ctypes.c_int), ("timeout_ms", ctypes.c_int), ("epoch", ctypes.c_uint),
        ("K", ctypes.c_int), ("spec_words", ctypes.c_int), ("batch_words", ctypes.c_int), ("ckey", ctypes.c_void_p),
        ("spec", ctypes.c_void_p), ("split", ctypes.c_void_p),
    ]


# The parts of a round of the batched exchange that the kernel's timed
# instantiation stamps (csrc/mesh_solve.cu SplitPart, same order), then the
# rounds timed: ``launch_timed`` returns them by card.
SPLIT_PARTS = ("chain", "save", "node_undo", "restore", "top_barrier", "multikey", "exchange", "replay")


def _round4(n: int) -> int:
    return (n + 3) & ~3


def spec_words(dims: fs.Dims) -> int:
    """Words of one CTA's slice of the batched exchange's ``spec`` buffer
    (csrc/mesh_solve.cu spec_words_of): the runs an overused queue's drop
    writes (jactive [J], qdropped and qcount [Q], with up to 3 words to
    match the region's alignment), 16-byte aligned."""
    return _round4(4 + dims.J + 2 * dims.Q)


def batch_words(exchange_batch: int, cards: int) -> int:
    """Shared words of the batched exchange's scratch a CTA
    (csrc/mesh_solve.cu batch_layout): the round's staged records [m][2K]
    (int4), the multi-key sweep's warp bests and cluster slots, CTA 0's
    round-start bests [K], the sweep's task rows and groups, the
    round-start classes [K], the chain's log [K][PLOG_WORDS], the region
    journal, the node undo log [K][UNDO_WORDS] and the round-start key
    count."""
    k = exchange_batch
    return (4 * cards * 2 * k + 4 * KEY_CHUNK * NWARPS + 4 * 2 * KEY_CHUNK * MAX_CLUSTER + 4 * k
            + KEY_CHUNK * TASK_WORDS + KEY_CHUNK + k + k * PLOG_WORDS + spec_iterations(k) * LOG0_WORDS
            + 2 * k * LOG_ROW_WORDS + k * UNDO_WORDS + 4)


def _card_args(dims: fs.Dims, cards: int, exchange_batch: int) -> tuple[bool, int, int, _Args]:
    """One card's launch: whether its replicated region lies in shared
    memory, its words, the cluster's CTAs, and the argument block
    (pointers unset). The batched exchange (K > 1 over two or more cards)
    adds its shared scratch after B1's layout, 16-byte aligned; where the
    region no longer fits beside it, the region moves to the global
    scratch (a ValueError where even the node slice does not fit)."""
    geo, sargs = fs._launch_args(dims)
    rep_in_smem = geo.rep_in_smem
    args = _Args(s=sargs, m=cards, K=exchange_batch)
    if exchange_batch > 1 and cards > 1:
        words = batch_words(exchange_batch, cards)
        extra = 4 * words
        if rep_in_smem and (geo.smem_bytes + 15) // 16 * 16 + extra > fs.SMEM_BUDGET:
            rep_in_smem = False
            sargs.rep_in_smem, sargs.smem_bytes = 0, 4 * geo.node_words
            args.s = sargs
        if (sargs.smem_bytes + 15) // 16 * 16 + extra > fs.SMEM_BUDGET:
            raise ValueError(f"the batched exchange at K = {exchange_batch} over {cards} cards needs {extra} B of "
                             f"shared memory beside the node slice's {sargs.smem_bytes} B; the limit is "
                             f"{fs.SMEM_BUDGET} B per CTA")
        args.spec_words, args.batch_words = spec_words(dims), words
    return rep_in_smem, geo.rep_words, geo.shape.k, args


def _bind(lib) -> None:
    lib.kbt_mesh_solve.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_void_p]
    lib.kbt_mesh_solve.restype = ctypes.c_int
    lib.kbt_mesh_solve_timed.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_void_p]
    lib.kbt_mesh_solve_timed.restype = ctypes.c_int
    lib.kbt_mesh_solve_max_clusters.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.kbt_mesh_solve_max_clusters.restype = ctypes.c_int
    lib.kbt_mesh_enable_peer.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.kbt_mesh_enable_peer.restype = ctypes.c_int


_library = nvcc.Library("mesh_solve", _bind)
_fits_card: set[tuple[int, int, int, bool]] = set()  # (device, k, shared bytes, batched) checked
_peers: set[tuple[int, int]] = set()  # (device, peer) with access enabled
# one solve's launches on its cards go out together: two solves launching
# interleaved over the same cards' streams could each wait on the other
_LAUNCH_LOCK = threading.Lock()


def check_peer_access(devices: Sequence[torch.device], can_access: Callable[[int, int], bool] | None = None) -> None:
    """Raise unless every ordered pair of distinct cards has peer access
    (``can_access(i, j)``, by default ``torch.cuda.can_device_access_peer``):
    B4 writes each card's record into every other card's memory. A mesh
    without it is refused, never solved another way."""
    can = torch.cuda.can_device_access_peer if can_access is None else can_access
    idx = [d.index for d in devices]
    missing = [(i, j) for i in idx for j in idx if i != j and not can(i, j)]
    if missing:
        pairs = ", ".join(f"cuda:{i}->cuda:{j}" for i, j in missing)
        raise RuntimeError(f"the mesh solve (kernel B4) needs peer access between its cards; missing: {pairs}")


def enable_peer_access(devices: Sequence[torch.device]) -> None:
    """Let every card's kernels write every other card's memory (once per
    ordered pair and process)."""
    idx = [d.index for d in devices]
    for i in idx:
        for j in idx:
            if i == j or (i, j) in _peers:
                continue
            err = _library.load().kbt_mesh_enable_peer(i, j)
            if err != 0:
                raise RuntimeError(f"mesh_solve: peer access cuda:{i}->cuda:{j} failed: {_library.error(err)}")
            _peers.add((i, j))


def _check_occupancy(index: int, args: _Args) -> None:
    key = (index, args.s.k, args.s.smem_bytes, args.batch_words if args.K > 1 and args.m > 1 else -1)
    if key in _fits_card:
        return
    n = ctypes.c_int(0)
    err = _library.load().kbt_mesh_solve_max_clusters(ctypes.byref(args), index, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"mesh_solve occupancy query failed on cuda:{index}: {_library.error(err)}")
    if n.value < 1:
        raise RuntimeError(
            f"cuda:{index} cannot hold the mesh solve's cluster of {args.s.k} CTAs of {CTA_WIDTH} threads "
            f"with {args.s.smem_bytes} B of shared memory each"
        )
    _fits_card.add(key)


def _check(cards: Sequence[Card]) -> str:
    """Validate every card's buffers; returns the device type they share."""
    if not cards:
        raise ValueError("a mesh solve needs at least one card")
    if len(cards) > MAX_CARDS:
        raise ValueError(f"{len(cards)} cards exceed the mesh solve's limit of {MAX_CARDS}")
    kinds = set()
    for c in cards:
        kind = fs._check(c.packed, c.state)
        n = c.packed.dims.N
        if c.gidx.dtype != torch.int32 or tuple(c.gidx.shape) != (n,) or c.gidx.device != c.device:
            raise ValueError(f"gidx must be int32 [{n}] on {c.device}")
        if n < 1:
            raise ValueError("a card of a mesh solve holds at least one node")
        kinds.add(kind)
    if len(kinds) != 1:
        raise ValueError(f"a mesh solve's cards are all cuda or all cpu, not {sorted(kinds)}")
    return kinds.pop()


def mesh_solve(cards: Sequence[Card], epoch: int = 0, timers: list | None = None, exchange_batch: int = 1) -> None:
    """Run one solve over the cards, updating each card's state in place.
    CUDA buffers launch the kernel once per card, each on its card's current
    stream with that card current, all of them before any is waited on
    (asynchronously; the caller waits on every card); ``epoch`` is the
    solve's stamp base, the same for every card, which the caller advances
    past ``max_iter`` before reusing the buffers. With ``timers``, a pair of
    CUDA events around each card's launch, on its stream, is appended to
    it. ``exchange_batch`` is the K of the batched exchange (1 to
    BATCH_MAX). CPU buffers run the plain version. Any other device
    raises."""
    kind = _check(cards)
    if not 1 <= int(exchange_batch) <= BATCH_MAX:
        raise ValueError(f"exchange_batch must be 1 to {BATCH_MAX}, got {exchange_batch}")
    if kind == "cpu":
        mesh_solve_plain(cards, int(exchange_batch))
        return
    if kind != "cuda":
        raise ValueError(f"mesh_solve runs on cuda or cpu, not {kind}")
    lib, prepared, index = _prepare(cards, epoch, exchange_batch=int(exchange_batch))
    if len(set(index)) != len(cards):
        raise ValueError(f"one launch per card: the cards lie on {index}")
    _launch_cards(lib, prepared, index, timers)


def _prepare(cards: Sequence[Card], epoch: int, timeout_ms: int = TIMEOUT_MS, exchange_batch: int = 1) -> tuple:
    """Each CUDA card's launch arguments, scratch and stream, and the
    cards' device indices; ``timeout_ms`` bounds each poll."""
    m = len(cards)
    index = [torch.cuda.current_device() if c.device.index is None else c.device.index for c in cards]
    if m > 1 and any(c.xbuf is None or c.xbuf.numel() != XBUF_WORDS or c.xbuf.dtype != torch.int32 for c in cards):
        raise ValueError(f"a solve over {m} cards needs each card's int32 [{XBUF_WORDS}] exchange buffer")
    batched = exchange_batch > 1 and m > 1
    if batched and any(c.ckey is None or c.ckey.dtype != torch.int32 or c.ckey.device != c.device
                       or c.ckey.numel() != c.packed.dims.C for c in cards):
        raise ValueError("the batched exchange needs each card's class keys (class_keys) on the card")
    lib = _library.load()
    xbuf = (ctypes.c_void_p * MAX_CARDS)(*[c.xbuf.data_ptr() if c.xbuf is not None else 0 for c in cards])
    prepared = []
    for i, c in enumerate(cards):
        rep_in_smem, rep_words, k, args = _card_args(c.packed.dims, m, int(exchange_batch))
        for name, view in {**c.packed.views(), **c.state.views()}.items():
            setattr(args.s, name, view.data_ptr())
        # freed on return: handed out again only to work queued on this
        # card's stream after the kernel
        scratch = []
        if not rep_in_smem:
            scratch.append(torch.empty(k * rep_words, dtype=torch.int32, device=c.device))
            args.s.scratch = scratch[-1].data_ptr()
        args.gidx, args.xbuf, args.card = c.gidx.data_ptr(), xbuf, i
        args.timeout_ms, args.epoch = int(timeout_ms), int(epoch) & 0xFFFFFFFF
        if batched:
            scratch.append(torch.empty(k * args.spec_words, dtype=torch.int32, device=c.device))
            args.spec, args.ckey = scratch[-1].data_ptr(), c.ckey.data_ptr()
        _check_occupancy(index[i], args)
        prepared.append((args, scratch, torch.cuda.current_stream(index[i])))
    return lib, prepared, index


def _launch_cards(lib, prepared: list, index: list[int], timers: list | None) -> None:
    """Every card's launch, in card order, under the module's launch lock,
    each counted where it launches."""
    with _LAUNCH_LOCK:
        for i, (args, _, stream) in enumerate(prepared):
            with torch.cuda.device(index[i]):
                if timers is not None:
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record(stream)
                err = lib.kbt_mesh_solve(ctypes.byref(args), index[i], stream.cuda_stream)
                if err != 0:
                    raise RuntimeError(f"mesh_solve launch on cuda:{index[i]} failed: {_library.error(err)}")
                if timers is not None:
                    end.record(stream)
                    timers.append((index[i], start, end))
            mesh_solve.launches += 1
            mesh_solve.launches_by_card[index[i]] += 1


def launch_timed(lib, prepared: list, index: list[int], timers: list | None = None) -> list[torch.Tensor]:
    """The batched exchange's timed instantiation on every card, as
    ``_launch_cards`` launches the kernel (K > 1, two or more cards): each
    card's thread 0 of CTA 0 stamps every part of every round. Returns each
    card's int64 [len(SPLIT_PARTS) + 1] (nanoseconds a part, then the
    rounds), filled when the card's stream has run. A measurement for
    chip_smoke.py, not a solve: no wrapper count moves."""
    out = []
    with _LAUNCH_LOCK:
        for i, (args, scratch, stream) in enumerate(prepared):
            # every word written by the kernel at exit; held with the
            # launch's scratch until the caller has waited on the card
            split = torch.empty(len(SPLIT_PARTS) + 1, dtype=torch.int64, device=torch.device("cuda", index[i]))
            scratch.append(split)
            args.split = split.data_ptr()
            with torch.cuda.device(index[i]):
                if timers is not None:
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record(stream)
                err = lib.kbt_mesh_solve_timed(ctypes.byref(args), index[i], stream.cuda_stream)
                if err != 0:
                    raise RuntimeError(f"mesh_solve (timed) launch on cuda:{index[i]} failed: {_library.error(err)}")
                if timers is not None:
                    end.record(stream)
                    timers.append((index[i], start, end))
            out.append(split)
    return out


mesh_solve.launches = 0
mesh_solve.launches_by_card = collections.Counter()  # the same launches by card index
mesh_solve.device_ms_by_card = collections.Counter()  # MeshSolve's kernel time (CUDA events) by card index


def _stack(parts: list[np.ndarray]) -> np.ndarray:
    """Per-card 1-d arrays as one [cards, longest] array (zero padded): a
    mesh slab of the tensor arena, one row a card."""
    out = np.zeros((len(parts), max(p.size for p in parts)), parts[0].dtype)
    for i, p in enumerate(parts):
        out[i, : p.size] = p
    return out


class MeshSolve:
    """Kernel B4's solves over a mesh: plan the cards, pack each
    card's statics once, then solve / resume.

    ``a`` are the encoder's arrays as CPU tensors (float32), ``mesh`` the
    mesh's devices (repeats allowed), ``cards`` an explicit grouping of its
    shards (``plan_cards``). A CUDA mesh over several cards checks peer
    access between them first (``can_access`` replaces the check, for
    tests) and raises without it. With ``arena`` the cards' statics go
    through it as the mesh slabs ``mesh_istatic``, ``mesh_fstatic`` and
    ``mesh_gidx`` (one row a card, the cards' placement): reused when
    their content equals the last upload's, put whole otherwise.
    ``exchange_batch`` is the K of the batched exchange (1 to BATCH_MAX):
    K > 1 over two or more cards runs the K-deep batched exchange, on one
    card the K = 1 loop, whose placing iterations all count as batched, as
    the JAX program's do (``batched_iters``, accumulated over solves).

    A solve packs the state once at full width, hands each card its slice,
    launches every card and waits on each once; the state comes back in
    two reads a card, into one SolveState. A card that ran past the poll
    bound raises, and the solver refuses later solves."""

    def __init__(self, a: dict, mesh, enable_drf: bool, enable_proportion: bool, arena=None,
                 cards: Sequence[int] | None = None, can_access=None, exchange_batch: int = 1) -> None:
        if not 1 <= int(exchange_batch) <= BATCH_MAX:
            raise ValueError(f"exchange_batch must be 1 to {BATCH_MAX}, got {exchange_batch}")
        self.exchange_batch = int(exchange_batch)
        self.batched_iters = 0  # placing iterations committed by a batched exchange (K > 1)
        self.a = a
        self.enable_drf, self.enable_proportion = enable_drf, enable_proportion
        n_nodes = a["node_idle"].shape[0]
        self.plan = plan_cards(mesh, n_nodes, cards)
        devices = self.plan.devices
        self.on_card = devices[0].type == "cuda"
        if self.on_card:
            if len(devices) > 1:
                check_peer_access(devices, can_access)
            if not torch.cuda.is_available():
                raise RuntimeError(f"the mesh solve was asked for {list(map(str, devices))} but no CUDA device is visible")
        self.arena = arena
        self.timings: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.device_ms: dict[int, float] = {}  # the last solve's kernel time (CUDA events) by card index
        self.speculated_by_card: list[int] = []  # the last batched solve's speculated placing iterations
        self.broken: str | None = None
        self._epoch = 0
        host = fs.pack(a, enable_drf, enable_proportion)
        self.dims = host.dims
        self._host_istatic = host.istatic
        self._rows = [torch.from_numpy(r) for r in self.plan.rows]
        self._dims = [card_dims(self.dims, r.numel()) for r in self._rows]
        self._job_queue = torch.as_tensor(np.asarray(a["job_queue"]))
        istatic = [take_nodes(host.istatic, self.dims.istatic(), d.istatic(), r).numpy()
                   for d, r in zip(self._dims, self._rows)]
        gidx = [r.astype(np.int32) for r in self.plan.rows]
        self._istatic = self._put("istatic", istatic)
        self._gidx = self._put("gidx", gidx)
        ckey = class_keys(host)
        self._ckey = [ckey.to(d) for d in devices]
        self._pod_sc = None
        self._fstatic = None
        self._refold_affinity(host.fstatic)
        self.cards: list[Card] = []
        self._host_states = []
        for i, (d, dev) in enumerate(zip(self._dims, devices)):
            ni, nf = fs._offsets(d.istate())[1], fs._offsets(d.fstate())[1]
            pin = self.on_card
            host_state = fs.PackedState(d, torch.zeros(ni, dtype=torch.int32, pin_memory=pin),
                                        torch.zeros(nf, dtype=torch.float32, pin_memory=pin))
            self._host_states.append(host_state)
            state = host_state if not self.on_card else fs.PackedState(
                d, torch.zeros(ni, dtype=torch.int32, device=dev), torch.zeros(nf, dtype=torch.float32, device=dev))
            xbuf = torch.zeros(XBUF_WORDS, dtype=torch.int32, device=dev) if self.on_card and len(devices) > 1 else None
            self.cards.append(Card(fs.Packed(d, self._istatic[i], self._fstatic[i]), self._gidx[i], state, xbuf,
                                   self._ckey[i]))
        if self.on_card:
            if len(devices) > 1:
                enable_peer_access(devices)
            for c in self.cards:
                # each card's cluster (solve_geometry at its node count) and
                # the card's room for it, before any solve
                try:
                    args = _card_args(c.packed.dims, len(devices), self.exchange_batch)[3]
                except ValueError as e:
                    raise ValueError(f"{c.device}: {e}") from e
                _check_occupancy(c.device.index, args)
            if len(devices) > 1:
                for dev in devices:
                    # the exchange buffers' zeros land before any card's
                    # first launch can write a peer's buffer: once per solver
                    torch.cuda.current_stream(dev).synchronize()

    def _put(self, name: str, parts: list[np.ndarray]) -> list[torch.Tensor]:
        """Per-card 1-d arrays on their cards, through the arena's mesh
        slab ``mesh_<name>`` (or a plain copy): each card's row."""
        rows = encode_cache.put(self.arena, f"mesh_{name}", _stack(parts), None, mesh=self.plan.devices)
        return [r.view(-1)[: p.size] for r, p in zip(rows, parts)]

    def _refold_affinity(self, fstatic: torch.Tensor | None = None) -> None:
        """The cards' float statics with the pre-weighted affinity scores
        (node affinity plus live InterPodAffinity) folded in: a new host
        buffer, uploaded whole (the arena's memo is never written)."""
        self._pod_sc = self.a["pod_sc"]
        if fstatic is None:
            fstatic = fs.pack(self.a, self.enable_drf, self.enable_proportion).fstatic
        parts = [take_nodes(fstatic, self.dims.fstatic(), d.fstatic(), r).numpy()
                 for d, r in zip(self._dims, self._rows)]
        self._fstatic = self._put("fstatic", parts)
        for c, f in zip(getattr(self, "cards", []), self._fstatic):
            c.packed = fs.Packed(c.packed.dims, c.packed.istatic, f)

    def _load(self, state: SolveState | None) -> fs.PackedState:
        """Pack ``state`` (the entry state when None) at full width and
        hand each card its slice (queued on the card's stream); returns the
        full-width state."""
        if state is None:
            state = init_state(self.a, self.enable_drf, self.enable_proportion)
        full = fs.pack_state(self.dims, state, self._job_queue)
        for c, host, rows in zip(self.cards, self._host_states, self._rows):
            take_nodes(full.istate, self.dims.istate(), host.dims.istate(), rows, out=host.istate)
            take_nodes(full.fstate, self.dims.fstate(), host.dims.fstate(), rows, out=host.fstate)
            if c.state is not host:
                c.state.istate.copy_(host.istate, non_blocking=True)
                c.state.fstate.copy_(host.fstate, non_blocking=True)
        return full

    def solve(self, state: SolveState | None = None) -> SolveState:
        if self.broken is not None:
            raise RuntimeError(f"the mesh solve cannot resume after a failed launch: {self.broken}")
        if self.a["pod_sc"] is not self._pod_sc:
            # live InterPodAffinity scores were refreshed between segments
            self._refold_affinity()
        t0 = time.perf_counter()
        full = self._load(state)
        it0 = int(full.istate[0])
        jptr0 = full.views()["jptr"].clone()
        t1 = time.perf_counter()
        timers = [] if self.on_card else None
        launches = mesh_solve.launches
        try:
            mesh_solve(self.cards, self._epoch, timers, self.exchange_batch)
        except Exception as e:
            self.broken = f"{type(e).__name__}: {e}"
            raise
        finally:
            self._epoch = (self._epoch + self.dims.max_iter + 1) & 0xFFFFFFFF
        if self.on_card:
            for c, host in zip(self.cards, self._host_states):
                host.istate.copy_(c.state.istate, non_blocking=True)
                host.fstate.copy_(c.state.fstate, non_blocking=True)
            for dev in self.plan.devices:
                torch.cuda.synchronize(dev)  # the barrier: every card's kernel and its state's copy
            self.device_ms = {i: s.elapsed_time(e) for i, s, e in timers}
            for i, ms in self.device_ms.items():
                mesh_solve.device_ms_by_card[i] += ms
        t2 = time.perf_counter()
        aborted = {str(c.device): int(h.istate[5]) for c, h in zip(self.cards, self._host_states) if int(h.istate[5])}
        if any(v < 0 for v in aborted.values()):
            self.broken = f"a round of the batched exchange committed no iteration: {aborted}"
            raise RuntimeError(f"mesh_solve: {self.broken}")
        if aborted:
            self.broken = f"a card waited past {TIMEOUT_MS} ms for a peer's record: {aborted} (exchange number)"
            raise RuntimeError(f"mesh_solve: {self.broken}")
        for host, rows in zip(self._host_states, self._rows):
            put_nodes(full.istate, host.istate, self.dims.istate(), host.dims.istate(), rows)
            put_nodes(full.fstate, host.fstate, self.dims.fstate(), host.dims.fstate(), rows)
        _replicated_into(full, self._host_states[0])
        out = fs._state_of(full)
        placing = int((full.views()["jptr"] - jptr0).sum())
        m = len(self.cards)
        batched = self.exchange_batch > 1 and m > 1
        self.counts = {
            "iterations": int(out.it) - it0, "placing_iterations": placing,
            "launches": mesh_solve.launches - launches, "cards": m, "record_reads": 0,
            # exchanges between cards: one a placing iteration at K = 1, one
            # a round of the batched exchange; none on one card
            "exchange_rounds": int(self._host_states[0].istate[6]) if batched else (placing if m > 1 else 0),
        }
        if self.exchange_batch > 1:
            self.batched_iters += placing
            self.speculated_by_card = [int(h.istate[7]) if batched else placing for h in self._host_states]
            self.counts["speculated"] = sum(self.speculated_by_card)
        self.timings = {"state_upload_s": t1 - t0, "loop_s": t2 - t1, "fetch_s": time.perf_counter() - t2}
        return out


def _copy_replicated(full: torch.Tensor, card: torch.Tensor, spec_full, spec_card) -> None:
    """The replicated fields (all but the node fields) of a card's buffer
    into a full-width one."""
    fv, cv = fs._views(full, spec_full), fs._views(card, spec_card)
    for name, _ in spec_card:
        if name not in NODE_FIELDS:
            fv[name].copy_(cv[name])


def _replicated_into(full: fs.PackedState, primary: fs.PackedState) -> None:
    """The replicated fields of the primary card's state into a full-width
    state (the node fields are the cards')."""
    _copy_replicated(full.istate, primary.istate, full.dims.istate(), primary.dims.istate())
    _copy_replicated(full.fstate, primary.fstate, full.dims.fstate(), primary.dims.fstate())
