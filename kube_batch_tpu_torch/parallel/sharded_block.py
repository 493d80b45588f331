"""The node-sharded blocked allocate solve: the block step (kernel B2) on
each shard's node block, one exchange of the shards' records per gang
iteration.

The counterpart of the reference's ``ShardedPallasSolver``
(kube_batch_tpu/parallel/sharded_pallas.py). Each shard of the mesh keeps
its node block (statics and node state) on its own device. Every gang
iteration

1. runs queue and job selection and the task pop, replicated, on the host
   (``ops.kernels.select_queue_job``, shared with the twin);
2. when the popped task is to be placed, launches the block step once per
   shard, on that shard's device, over that shard's block;
3. reads the shards' (best score, global index, fits-idle) records — the
   exchange — and picks the winner as the reference's ``winner()`` does:
   the highest score, the lowest global index on ties, the fits-idle bit
   from the shard that owns the winner;
4. applies the capacity update (idle or releasing, used, pod count, host
   ports) on the owning shard's device only, and the task/job/queue
   bookkeeping of the reference's ``commit()`` on the host.

The replicated half of the state lives on the host, not on the mesh's
first device: every iteration's control flow (is a job current, does the
task pause, did any node fit) is a host decision anyway, and the winner
has to be read back to make it, so the small job and queue vectors are
cheapest where the decisions are made. Every node-axis tensor and every
block-step launch stays on its shard's device.

``exchange_batch = K > 1`` runs the reference's K-deep batched exchange:
each shard speculates up to K gang iterations on a throwaway copy of the
state, assuming its own candidate wins every round, and records each
placing iteration's result with the task fields that determine it; the
records of all shards are then gathered at once and a replay re-runs the
true bookkeeping, taking each shard's candidate from its record at a
per-shard depth pointer that advances when that shard wins (or on a global
abandon). A record is used only while its task fields equal the true
task's; the first mismatch ends the replay, and the next round
re-speculates from the true state. Replay iteration 0 always commits, so
the result is the per-iteration exchange's, iteration for iteration.

Speaks the twin's ``SolveState`` protocol: ``solve(state)`` takes and
returns CPU tensors, pauses at a host-only task (``paused_at``), and
re-folds the affinity scores when the caller replaced ``a["pod_sc"]``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from kube_batch_tpu_torch.ops import block_step as bs
from kube_batch_tpu_torch.ops import fused_solve as fs
from kube_batch_tpu_torch.ops.kernels import KIND_ALLOCATED, KIND_PIPELINED, SolveState, init_state, select_queue_job
from kube_batch_tpu_torch.parallel.sharded import node_blocks

# The replicated half of SolveState (everything but the node axis and the
# loop scalars).
_REP_FIELDS = (
    "ptr", "assigned_node", "assigned_kind", "assign_pos", "ready_cnt",
    "job_active", "q_dropped", "job_alloc", "q_alloc", "q_alloc_has_sc",
)
_NODE_STATE = ("idle", "rel", "used", "ntasks", "nports")


class _Rep:
    """The replicated state on the host: torch tensors (read by
    ``select_queue_job``) and numpy views of the same memory (written by
    the loop's scalar updates), plus the loop scalars."""

    def __init__(self, tensors: dict[str, torch.Tensor], it: int, step: int, cur: int, paused: int) -> None:
        for f in _REP_FIELDS:
            setattr(self, f, tensors[f])
        self.v = {f: tensors[f].numpy() for f in _REP_FIELDS}
        self.it, self.step, self.cur, self.paused = it, step, cur, paused

    @classmethod
    def of(cls, s: SolveState) -> "_Rep":
        return cls(
            {f: getattr(s, f).detach().cpu().clone().contiguous() for f in _REP_FIELDS},
            int(s.it), int(s.step), int(s.cur), -1,
        )

    def copy(self) -> "_Rep":
        return _Rep({f: getattr(self, f).clone() for f in _REP_FIELDS}, self.it, self.step, self.cur, self.paused)


class _Pop:
    """One iteration's selection and task pop (computed, not applied)."""

    __slots__ = ("cur", "drop_q", "t", "drop", "pause", "proc")

    def __init__(self, cur, drop_q, t, drop, pause, proc) -> None:
        self.cur, self.drop_q, self.t, self.drop, self.pause, self.proc = cur, drop_q, t, drop, pause, proc


class ShardedBlockSolver:
    """One blocked sharded solve, per snapshot: fold the node statics
    once per shard onto its device, then solve / resume.

    ``arrays`` are the encoder's arrays as CPU tensors (float32 only),
    ``mesh`` a sequence of devices (``parallel.make_mesh``), one shard
    each, all CUDA or all CPU: the block step launches its CUDA kernel on a
    CUDA shard and runs its plain version on a CPU shard
    (``ops.block_step``'s own dispatch). ``exchange_batch`` is the K of the
    K-deep batched exchange (1: one exchange per gang iteration).
    """

    def __init__(
        self,
        arrays: dict,
        mesh,
        enable_drf: bool = False,
        enable_proportion: bool = False,
        exchange_batch: int = 1,
    ) -> None:
        # a bare "cuda" is the current card: blocks and their per-device
        # tables key on the indexed device the tensors report
        mesh = tuple(
            torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d
            for d in map(torch.device, mesh)
        )
        if not mesh:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in mesh}
        if kinds not in ({"cuda"}, {"cpu"}):
            raise ValueError(f"a mesh is all cuda or all cpu devices; this one has {sorted(kinds)}")
        if int(exchange_batch) < 1:
            raise ValueError(f"exchange_batch must be >= 1, got {exchange_batch}")
        if arrays["task_req"].dtype != torch.float32:
            raise ValueError("the blocked sharded solve is float32-only; encode with dtype=float32")
        self.a = arrays
        self.mesh = mesh
        self.enable_drf = enable_drf
        self.enable_proportion = enable_proportion
        self.exchange_batch = int(exchange_batch)
        self.batched_iters = 0  # gang iterations committed from a batched exchange
        self.timings: dict[str, float] = {}  # seconds per phase of the last solve
        # the last solve's iterations, placing iterations, launches and,
        # with a batched exchange, the speculated placing iterations
        self.counts: dict[str, int] = {}

        n = {k: np.asarray(v) for k, v in arrays.items()}
        T, R = n["task_req"].shape
        N = n["node_idle"].shape[0]
        GT = n["compat"].shape[0]
        m = len(mesh)
        self.blocks_idx = node_blocks(N, m)
        self.n_loc = self.blocks_idx[0][1]
        self.n_pad = self.n_loc * m  # the sentinel: global padded node count
        self.N, self.T = N, T
        self.P = n["task_ports"].shape[1]
        J, Q = n["job_min"].shape[0], n["queue_rank"].shape[0]
        self.max_iter = T + J + Q + 1 + int(n["task_host_only"].sum())
        # the packed layout's envelope at one shard's size (every shard has
        # it); the block step reads no class table and keeps no node state
        # in shared memory, so the fused-solve kernel's limit is not its
        fs.check_envelope(fs.Dims(
            T=T, N=self.n_loc, J=J, Q=Q, C=1, GT=GT, R=R, P=self.P, max_iter=self.max_iter,
            drf=bool(enable_drf), proportion=bool(enable_proportion),
        ))

        # -- tasks: one block-step Task per class, host lists for the loop --
        tports, first, inv = fs._class_inverse(n)
        eps = [float(x) for x in n["eps"]]
        wl, wb = n["w_least"].item(), n["w_balanced"].item()
        gids = np.clip(n["task_gid"], 0, GT - 1)
        self._tasks = [
            bs.make_task(gids[f], n["task_has_sc"][f], tports[f], n["task_req"][f].tolist(),
                         n["task_res"][f].tolist(), eps, wl, wb)
            for f in first
        ]
        # the speculative records' validity key: the fields that fully
        # determine a block step (group, scalar flag, ports, req, res)
        keys = [
            (int(gids[f]), bool(n["task_has_sc"][f]), int(tports[f]),
             tuple(n["task_req"][f].tolist()), tuple(n["task_res"][f].tolist()))
            for f in first
        ]
        key_id = {k: i for i, k in enumerate(dict.fromkeys(keys))}
        self._bkey = [key_id[k] for k in keys]
        self._tcls = inv.tolist()
        self._host_only = n["task_host_only"].astype(bool).tolist()
        self._res_has_sc = n["task_res_has_sc"].astype(bool).tolist()
        self._res = np.ascontiguousarray(n["task_res"], np.float32)
        self._job_end = n["job_end"].tolist()
        self._job_min = n["job_min"].tolist()
        self._job_queue = n["job_queue"].tolist()
        self._job_queue_np = np.asarray(n["job_queue"])
        res_cls = torch.from_numpy(np.ascontiguousarray(n["task_res"][first], np.float32))
        self._res_dev = {d: res_cls.to(d) for d in dict.fromkeys(mesh)}

        # -- node statics, folded once and placed per shard ------------------
        node_gid = n["node_gid"].astype(np.int64)
        okv = n["node_ok"] & n["node_valid"]
        cnode = np.zeros((GT, self.n_pad), np.int32)
        cnode[:, :N] = n["compat"][:, node_gid] & okv[None, :]
        nalloc = np.zeros((2, self.n_pad), np.float32)
        nalloc[:, :N] = n["node_alloc"][:, :2].T
        vec = {}
        for name, key in (("nmax", "node_max_tasks"), ("nihs", "node_idle_has_sc"), ("nrhs", "node_rel_has_sc")):
            vec[name] = np.zeros(self.n_pad, np.int32)
            vec[name][:N] = n[key]
        self.blocks: list[bs.Block] = []
        for (lo, hi), dev in zip(self.blocks_idx, mesh):
            def put(x):
                return torch.from_numpy(np.ascontiguousarray(x[..., lo:hi])).to(dev)

            self.blocks.append(bs.Block(
                cnode=put(cnode), affw=torch.zeros(GT, self.n_loc, dtype=torch.float32, device=dev),
                nalloc=put(nalloc), nmax=put(vec["nmax"]), nihs=put(vec["nihs"]), nrhs=put(vec["nrhs"]),
                idle=torch.zeros(R, self.n_loc, dtype=torch.float32, device=dev),
                rel=torch.zeros(R, self.n_loc, dtype=torch.float32, device=dev),
                used=torch.zeros(R, self.n_loc, dtype=torch.float32, device=dev),
                ntasks=torch.zeros(self.n_loc, dtype=torch.int32, device=dev),
                nports=torch.zeros(self.n_loc, dtype=torch.int32, device=dev),
                off=lo, sent=self.n_pad,
            ))
        self._pod_sc = None
        self._refold_affinity()

        # -- the exchange: one record buffer per device, a host copy --------
        self._groups = []  # (device buffer, host buffer, its numpy view, shard ids)
        outs: list[torch.Tensor | None] = [None] * m
        for dev in dict.fromkeys(mesh):
            ids = [k for k in range(m) if mesh[k] == dev]
            buf = torch.zeros(len(ids), bs.RECORD, dtype=torch.int32, device=dev)
            host = buf if dev.type == "cpu" else torch.zeros_like(buf, device="cpu").pin_memory()
            self._groups.append((buf, host, host.numpy(), ids))
            for i, k in enumerate(ids):
                outs[k] = buf[i]
        self._rec = np.zeros((m, bs.RECORD), np.int32)
        self._steps = [bs.BlockStep(b, out) for b, out in zip(self.blocks, outs)]
        if self.exchange_batch > 1:
            # each shard's throwaway copy of its block state for speculation
            self._spec_blocks = [
                bs.Block(**{
                    **{f: getattr(b, f) for f in ("cnode", "affw", "nalloc", "nmax", "nihs", "nrhs", "off", "sent")},
                    **{f: torch.empty_like(getattr(b, f)) for f in _NODE_STATE},
                })
                for b in self.blocks
            ]
            self._spec_steps = [bs.BlockStep(b, out) for b, out in zip(self._spec_blocks, outs)]

    # -- statics and state in and out ---------------------------------------

    def _refold_affinity(self) -> None:
        """Fold the pre-weighted affinity scores (node affinity plus live
        InterPodAffinity) into every shard's block, in place."""
        self._pod_sc = self.a["pod_sc"]
        full = np.zeros((self.blocks[0].affw.shape[0], self.n_pad), np.float32)
        full[:, : self.N] = fs.fold_affinity_scores(self.a)
        for (lo, hi), b in zip(self.blocks_idx, self.blocks):
            b.affw.copy_(torch.from_numpy(np.ascontiguousarray(full[:, lo:hi])))

    def _upload(self, s: SolveState) -> None:
        """The state's node axis into the shards' blocks (pad nodes zero)."""
        rows = {
            "idle": s.idle.T, "rel": s.rel.T, "used": s.used.T,
            "ntasks": s.ntasks.to(torch.int32),
            "nports": torch.from_numpy(fs._ports_mask(s.nports.numpy())),
        }
        for name, x in rows.items():
            full = torch.zeros(*x.shape[:-1], self.n_pad, dtype=x.dtype)
            full[..., : self.N] = x
            for (lo, hi), b in zip(self.blocks_idx, self.blocks):
                getattr(b, name).copy_(full[..., lo:hi])

    def _fetch(self) -> dict[str, torch.Tensor]:
        """The shards' node state, gathered to CPU tensors in SolveState's
        layout (pad nodes dropped)."""
        N = self.N
        cat = {
            name: torch.cat([getattr(b, name).cpu() for b in self.blocks], dim=-1)[..., :N]
            for name in _NODE_STATE
        }
        return {
            "idle": cat["idle"].T.contiguous(),
            "rel": cat["rel"].T.contiguous(),
            "used": cat["used"].T.contiguous(),
            "ntasks": cat["ntasks"].contiguous(),
            "nports": fs._ports_bool(cat["nports"], self.P),
        }

    # -- one gang iteration, in parts shared by both exchanges --------------

    def _cond(self, rep: _Rep) -> bool:
        return (rep.cur >= 0 or bool(rep.v["job_active"].any())) and rep.it < self.max_iter and rep.paused < 0

    def _pop(self, rep: _Rep) -> _Pop:
        """Replicated selection and task pop; changes nothing."""
        cur, drop_q = rep.cur, -1
        if cur < 0:
            qsel, q_any, overused, jsel, j_any = select_queue_job(
                self.a, rep, self.enable_drf, self.enable_proportion
            )
            if q_any and overused:
                drop_q = qsel
            cur = jsel if (q_any and not overused and j_any) else -1
        t = int(rep.v["ptr"][max(cur, 0)])
        t_any = cur >= 0 and t < self._job_end[cur]
        t = min(t, self.T - 1)
        pause = t_any and self._host_only[t]
        return _Pop(cur, drop_q, t, cur >= 0 and not t_any, pause, t_any and not pause)

    def _exchange(self, steps, shards, task) -> np.ndarray:
        """Launch the block step on the given shards and read their
        records back ([m, 4] int32; rows of other shards are stale)."""
        for k in shards:
            steps[k](task)
        rec = self._rec
        for buf, host, host_np, ids in self._groups:
            if not any(k in shards for k in ids):
                continue
            if host is not buf:
                host.copy_(buf)  # waits for this device's launches
            rec[ids] = host_np
        return rec

    @staticmethod
    def _winner(scores: np.ndarray, idxs: np.ndarray, fits: np.ndarray, sent: int) -> tuple[bool, int, bool]:
        """The reference's winner(): max score, min global index on ties;
        the fits-idle bit from the shard that owns the winner."""
        big = scores.max()
        top = scores == big
        nb = min(int(idxs[top].min()), sent - 1)
        return bool(big > -np.inf), nb, bool(fits[top & (idxs == nb)].any())

    def _commit(self, rep: _Rep, p: _Pop, any_cand: bool, nb: int, fits: bool, blocks) -> bool:
        """Everything after the winner is known: the capacity update on the
        owning shard's block, then the replicated bookkeeping. Returns
        whether a task was placed."""
        v, cur, t = rep.v, p.cur, p.t
        if p.drop_q >= 0:
            # the overused queue retires all its jobs for the cycle
            v["job_active"] &= self._job_queue_np != p.drop_q
            v["q_dropped"][p.drop_q] = True
        assign = p.proc and any_cand
        if assign:
            cls = self._tcls[t]
            k = nb // self.n_loc
            j = nb - k * self.n_loc
            b = blocks[k]
            res = self._res_dev[b.idle.device][cls]
            (b.idle if fits else b.rel)[:, j].sub_(res)  # releasing: the predicate guarantees a fit
            b.used[:, j].add_(res)
            b.ntasks[j : j + 1].add_(1)
            tp = self._tasks[cls].tports
            if tp:
                b.nports[j : j + 1].bitwise_or_(tp)
            if fits:
                v["ready_cnt"][cur] += 1
            v["assigned_node"][t] = nb
            v["assigned_kind"][t] = KIND_ALLOCATED if fits else KIND_PIPELINED
            v["assign_pos"][t] = rep.step
            if self.enable_drf:
                v["job_alloc"][cur] += self._res[t]
            if self.enable_proportion:
                q = self._job_queue[cur]
                v["q_alloc"][q] += self._res[t]
                if self._res_has_sc[t]:
                    v["q_alloc_has_sc"][q] = True
        if p.proc:
            v["ptr"][cur] += 1
        if p.drop or (p.proc and not any_cand):
            v["job_active"][cur] = False
            cur = -1
        elif p.proc and v["ready_cnt"][cur] >= self._job_min[cur]:
            cur = -1  # gang barrier: the job re-queues
        rep.cur = cur
        rep.paused = t if p.pause else -1
        rep.it += 1
        rep.step += int(assign)
        return assign

    # -- the loops ------------------------------------------------------------

    def _run_exchange(self, rep: _Rep, tm: dict) -> None:
        """One exchange per gang iteration."""
        m = len(self.blocks)
        shards = range(m)
        sent = self.n_pad
        while self._cond(rep):
            t0 = time.perf_counter()
            p = self._pop(rep)
            t1 = time.perf_counter()
            any_cand, nb, fits = False, sent - 1, False
            if p.proc:
                rec = self._exchange(self._steps, shards, self._tasks[self._tcls[p.t]])
                any_cand, nb, fits = self._winner(rec[:, 0].view(np.float32), rec[:, 1], rec[:, 2], sent)
                self.counts["placing_iterations"] += 1
            t2 = time.perf_counter()
            self._commit(rep, p, any_cand, nb, fits, self.blocks)
            tm["select_s"] += t1 - t0
            tm["exchange_s"] += t2 - t1
            tm["update_s"] += time.perf_counter() - t2

    def _speculate(self, rep: _Rep, k: int) -> list[tuple]:
        """Shard k's speculative chain: up to K placing iterations on a
        throwaway state in which its own candidate always wins. Returns
        its records (score, global index, fits, validity key)."""
        K, sent = self.exchange_batch, self.n_pad
        spec = rep.copy()
        sb = self._spec_blocks[k]
        for f in _NODE_STATE:
            getattr(sb, f).copy_(getattr(self.blocks[k], f))
        blocks = [None] * len(self.blocks)
        blocks[k] = sb
        records = []
        while len(records) < K and self._cond(spec):
            p = self._pop(spec)
            any_cand, nb, fits = False, sent - 1, False
            if p.proc:
                cls = self._tcls[p.t]
                rec = self._exchange(self._spec_steps, (k,), self._tasks[cls])[k]
                score = float(rec[0:1].view(np.float32)[0])
                any_cand, nb, fits = score > -np.inf, min(int(rec[1]), sent - 1), bool(rec[2])
                records.append((score, int(rec[1]), int(rec[2]), self._bkey[cls]))
                self.counts["speculated"] += 1
            self._commit(spec, p, any_cand, nb, fits, blocks)
        return records

    def _run_batched(self, rep: _Rep, tm: dict) -> None:
        """The K-deep batched exchange: speculate per shard, one gather of
        all records, then a replay with no launches."""
        m, K, sent = len(self.blocks), self.exchange_batch, self.n_pad
        while self._cond(rep):
            t0 = time.perf_counter()
            recs = [self._speculate(rep, k) for k in range(m)]
            t1 = time.perf_counter()
            d = [0] * m
            committed, it_before = 0, rep.it
            while self._cond(rep):
                p = self._pop(rep)
                any_cand, nb, fits = False, sent - 1, False
                if p.proc:
                    key = self._bkey[self._tcls[p.t]]
                    if not all(d[k] < len(recs[k]) and recs[k][d[k]][3] == key for k in range(m)):
                        break  # this iteration is re-speculated from the true state
                    rows = [recs[k][d[k]] for k in range(m)]
                    any_cand, nb, fits = self._winner(
                        np.array([r[0] for r in rows], np.float32),
                        np.array([r[1] for r in rows], np.int64),
                        np.array([r[2] for r in rows], np.int32), sent,
                    )
                    if any_cand:
                        d[nb // self.n_loc] += 1
                    else:  # a global abandon: every shard's record was -inf
                        d = [x + 1 for x in d]
                    committed += 1
                    self.counts["placing_iterations"] += 1
                self._commit(rep, p, any_cand, nb, fits, self.blocks)
            if rep.it == it_before:
                raise RuntimeError("batched exchange: the replay committed no iteration")
            self.batched_iters += committed
            tm["exchange_s"] += t1 - t0
            tm["update_s"] += time.perf_counter() - t1

    def solve(self, state: SolveState | None = None) -> SolveState:
        if self.a["pod_sc"] is not self._pod_sc:
            # live InterPodAffinity scores were refreshed between segments:
            # re-fold just the affinity static
            self._refold_affinity()
        t0 = time.perf_counter()
        if state is None:
            state = init_state(self.a, self.enable_drf, self.enable_proportion)
        rep = _Rep.of(state)
        self._upload(state)
        t1 = time.perf_counter()
        launches = bs.block_step.launches
        self.counts = {"placing_iterations": 0, **({"speculated": 0} if self.exchange_batch > 1 else {})}
        it0 = rep.it
        tm = {"select_s": 0.0, "exchange_s": 0.0, "update_s": 0.0}
        if self.exchange_batch > 1:
            self._run_batched(rep, tm)
        else:
            self._run_exchange(rep, tm)
        for d in dict.fromkeys(self.mesh):
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        t2 = time.perf_counter()
        node = self._fetch()
        out = SolveState(
            it=torch.tensor(rep.it, dtype=torch.int32),
            step=torch.tensor(rep.step, dtype=torch.int32),
            cur=torch.tensor(rep.cur, dtype=torch.int32),
            **{f: getattr(rep, f) for f in _REP_FIELDS},
            **node,
            paused_at=torch.tensor(rep.paused, dtype=torch.int32),
        )
        self.counts.update(iterations=rep.it - it0, launches=bs.block_step.launches - launches)
        self.timings = {
            "state_upload_s": t1 - t0, "loop_s": t2 - t1, **tm, "fetch_s": time.perf_counter() - t2,
        }
        return out
