// The mesh rung's whole gang loop, one persistent launch per card, with
// the winner exchanged between cards inside the kernel, for Hopper
// (sm_90a). Kernel B4.
//
// Replaces kube_batch_tpu/parallel/sharded_pallas.py::_blocked_programs's
// SPMD body `local` (:267), both its loops: the K = 1 path (:469-495), a
// device lax.while_loop whose every iteration selects and pops replicated
// on every chip, runs the Pallas block step over the chip's node block,
// does one lax.all_gather of the (score, global index, fits-idle) records,
// picks the winner the same way everywhere and updates capacity on the
// owning chip only; and the K-deep batched exchange (:495-621, below).
// Plain version: ops/mesh_solve.py mesh_solve_plain, over the same
// per-card buffers. Caller: ops/mesh_solve.py MeshSolve, for
// parallel/sharded_block.py ShardedBlockSolver on a CUDA mesh, at every K.
//
// What it computes: kernel B1's loop (solve_loop.cuh) over one card's
// nodes, the union of the node blocks of every shard of the mesh that lies
// on that card, in ascending row order; `gidx` maps each of the card's
// nodes to its row, which the winner and the placements carry. The card's
// cluster arg-max (highest score, then lowest index) is that card's best;
// because the card's nodes are in row order, its lowest index is its
// lowest row, so the winner over the cards' records (highest score, then
// lowest row, the fits-idle bit from the owner) is the reference's
// winner() over any grouping of the nodes into cards. Pad nodes never
// fit, so no card holds them.
//
// What bounds it: B1's per-iteration latency at the card's node count
// (its sweep, its cluster barrier, the selection's reductions), plus, on
// every placing iteration, one exchange between cards: a store of a
// 16-byte record into every card's memory over NVLink, a system-scope
// fence, the stamps, the wait until every peer's stamp has arrived, and
// the cluster barrier that makes the exit uniform (below). Bytes and
// operations are far below what the cards can do in the time.
// csrc/mesh_floor.cu measures the exchange's latency alone (no barrier).
//
// What the design does about it: one launch per card for the whole solve
// (the JAX program's all_gather sits inside its device loop, and so does
// this exchange), so no iteration costs a launch or a host round trip.
//   - Each card holds an exchange buffer of [2 parities][MAX_CARDS]
//     records of four words (score bits, row, fits-idle, stamp) and one
//     abort word after them (XBUF_WORDS). After its cluster arg-max,
//     thread 0 of CTA 0 on each card writes its record into its own slot
//     of every card's buffer (the peer's memory, through peer access),
//     then __threadfence_system(), then each stamp with a relaxed
//     system-scope store: the fence makes the records visible to any
//     thread that reads the stamp.
//   - Every warp of every CTA then polls its own card's slots with
//     system-scope acquire loads (never a plain load that L1 may hold)
//     until all m stamps read this exchange's stamp, and reads the
//     records. One cluster barrier follows, then every thread reads the
//     card's abort word (below): the only barrier the exchange adds, and
//     it makes the decision to go on the same in every thread. Every
//     thread then reduces the records with node_sweep.cuh's warp arg-max
//     and derives the same winner.
//   - Only the card that owns the winner updates the winning node; the
//     replicated bookkeeping runs on every card (solve_loop.cuh).
//   - One card (m = 1: every shard of the mesh on one card) exchanges
//     nothing and is B1 with row indices.
//
// Stamps and parities. A stamp is the launch's epoch plus the exchange's
// number in the launch plus one. The host gives every card of a solve the
// same epoch and advances it past the solve's largest exchange count
// before the next launch, so a stamp never repeats across the segments,
// resumes and solves that reuse the buffers, and buffers zeroed once when
// the solver is built never need zeroing again (a buffer zeroed on one
// card's stream before a launch could race a peer's kernel already
// writing into it). Exchange n uses parity n & 1. Invariant: a card writes
// exchange n + 2 into parity n & 1 only after it has read every card's
// stamp of exchange n + 1; a card publishes that stamp only after every
// CTA of it has passed the cluster barrier of exchange n, and each thread
// reaches that barrier only after it has read exchange n's records. So no
// record is overwritten before every CTA of every card has read it.
//
// Hangs. The host launches every card's kernel before it waits on any. A
// poll is bounded by %globaltimer: past `timeout_ms` without every stamp,
// lane 0 of the warp sets its card's abort word (the exchange's number)
// and the warp stops polling; a warp that reads the abort word set stops
// too. Warps decide on their own, and a late peer's stamp can land
// between one warp's decision and another's next look, so no thread acts
// on its own decision: after the exchange's cluster barrier every thread
// reads the abort word, which nothing writes until the next exchange's
// poll, and all of them go on or all of them end the loop (a warp that
// ended it alone would leave the others at a barrier it never reaches).
// CTA 0 writes the word into scal[5] at exit, where the host reads it with
// the state and raises. The bound is seconds, so a peer that is alive
// always answers within it; it is there for a peer that never runs.
//
// Numerics: as fused_solve.cu (-fmad=false, round-to-nearest intrinsics,
// __fdiv_rn). Every card computes the selection, the drf shares and the
// pause decision itself; nothing in solve_loop.cuh depends on the
// cluster's size k, so cards of different node counts agree bit for bit.
//
// The K-deep batched exchange (K > 1 over two or more cards; one card
// exchanges nothing, so its K = 1 loop is already the batched program's
// result, and the host reports its placing iterations as batched). The
// card is the unit of speculation, as it is the unit of the record at
// K = 1. A round:
//   - Speculate: from the true state, up to K placing iterations with this
//     card's best always winning (solve_loop.cuh's select_job, pop_task,
//     sweep and commit, placements not recorded). Each placing iteration's
//     record (score, row, local index and fits-idle bit, the task class's
//     key, ops/mesh_solve.py class_keys: equal for classes whose sweep
//     fields are equal) goes straight into this card's slot on every card.
//     A pause, max_iter or the loop's end stops it early, so cards may
//     write different counts.
//   - Back to the true state. Nodes: each CTA logs, before a speculative
//     update of one of its nodes, the node's old values (UNDO_WORDS: pod
//     count, ports, idle, releasing and used rows) in its slice of `spec`;
//     the owner threads restore them newest first (an update is never
//     undone by adding back: __fsub_rn then __fadd_rn does not return the
//     old float). The replicated region: a copy, not a journal. A
//     speculation writes jptr, jready, jactive, qcount, qdropped, jalloc,
//     jshare, qalloc and qahs, and an overused queue's drop retires every
//     job of the queue (up to J words of jactive in one iteration), which a
//     journal would have to log whole; the copy saves the written runs,
//     J (4 + R) + Q (3 + R) words (save_region), once before and once after
//     the speculation. At 50k x 5k (preempt_mix: J 2,048, Q 2, R 2) and at
//     config 7 (uniform_pool 400k x 40k: J 2,048, Q 2, R 2) that is 12,298
//     words, 49,192 B a CTA, of a replicated region of 20,498 words plus
//     21 a task class.
//     It lies in the CTA's slice of the global buffer `spec`, whether the
//     region is in shared memory or in `scratch`, so one layout serves
//     both; its two passes are coalesced and bounded by L2.
//   - Exchange: thread c < m of CTA 0 writes this card's count into its
//     slot on card c, fences and stamps (the same protocol as K = 1, on a
//     slot of BATCH_MAX records a card and parity); every warp polls its
//     own buffer's stamps; the abort word and the cluster barrier as at
//     K = 1.
//   - Replay, no sweep: the true iterations, lane c of every warp holding
//     card c's depth pointer and reading its record there. A placing
//     iteration needs every card to have a record left whose key is the
//     task's; else the replay stops before it (nothing of it committed)
//     and the next round speculates it again. The winner is winner()'s
//     (highest score, then lowest row); the card that owns it commits the
//     node update with the local index its record carries; the winning
//     card's pointer advances, every card's on a global abandon.
//     Speculated iterations never count toward `it`. A round whose replay
//     commits nothing (iteration 0 of a replay always can) sets scal[5]
//     to -1 and ends the launch.
// A round costs K sweeps, the two region copies, one exchange and up to K
// replayed selections and commits, against K exchanges at K = 1.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "solve_loop.cuh"

#define MAX_CARDS 8  // the most cards one host joins all to all
#define REC 4        // int32 words of one record: score bits, row, fits-idle, stamp
#define BATCH_MAX 64  // the deepest batched exchange (the JAX package's clamp of K)
// One card's records of one round of the batched exchange: a header (stamp,
// count, pad) and BATCH_MAX records (score bits, row, local index << 1 |
// fits-idle, key).
#define SLOT (REC + BATCH_MAX * REC)
#define BATCH_OFF (2 * MAX_CARDS * REC)               // the rounds' slots, [2 parities][MAX_CARDS]
#define ABORT_OFF (BATCH_OFF + 2 * MAX_CARDS * SLOT)  // the abort word, then pad
#define XBUF_WORDS (ABORT_OFF + REC)

extern "C" {

// Mirror of ops/mesh_solve.py::_Args (same field order).
struct MeshArgs {
  SolveArgs s;           // the card's solve over its own nodes (s.N of them)
  const int* gidx;       // [s.N] each node's row, ascending
  int* xbuf[MAX_CARDS];  // each card's exchange buffer, in card order
  int card, m, timeout_ms;  // card 0 is the primary card (the card of shard 0)
  unsigned epoch;
  int K;             // the batched exchange's depth; 1: one exchange a placing iteration
  int spec_words;    // words of one CTA's slice of `spec` (K > 1)
  const int* ckey;   // [s.C] each class's record key (K > 1)
  int* spec;         // [s.k][spec_words] each CTA's saved region and node undo log (K > 1)
};

}  // extern "C"

__device__ __forceinline__ unsigned ld_acquire_sys(const int* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int ld_relaxed_sys(const int* p) {
  int v;
  asm volatile("ld.relaxed.sys.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed_sys(int* p, int v) {
  asm volatile("st.relaxed.sys.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// B4's exchange between the cards of one solve (see the header).
struct MeshExchange {
  const MeshArgs& a;
  int rank;
  unsigned n = 0;       // exchanges (K = 1) or rounds (K > 1) of this launch so far
  int nrec = 0;         // lane c: card c's records in the last round
  int speculated = 0;   // this card's speculated placing iterations (K > 1)
  int fault = 0;        // -1: a round's replay committed nothing (K > 1)

  __device__ MeshExchange(const MeshArgs& args, int r) : a(args), rank(r) {}

  __device__ __forceinline__ bool primary() const { return a.card == 0; }

  __device__ __forceinline__ int* abort_word() const { return a.xbuf[a.card] + ABORT_OFF; }

  // Every warp polls the stamps of its own card's buffer, lane c the word
  // `stamp_word` of card c, until all m read `stamp`; lane 0 gives up past
  // the bound (the abort word) and a warp stops once the word is set.
  // Returns whether every stamp arrived.
  __device__ __forceinline__ bool poll(const int* stamp_word, unsigned stamp) const {
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    unsigned long long t0 = 0;  // lane 0's clock
    for (unsigned spins = 1;; ++spins) {
      const unsigned s = lane < a.m ? ld_acquire_sys(stamp_word) : stamp;
      if (__all_sync(full, s == stamp)) return true;
      if ((spins & 255u) == 0) {
        int stop = 0;  // lane 0 decides for its warp
        if (lane == 0) {
          const unsigned long long now = global_ns();
          if (t0 == 0) {
            t0 = now;
          } else if (now - t0 > 1000000ull * (unsigned long long)a.timeout_ms) {
            atomicCAS(abort_word(), 0, (int)n);
          }
          stop = ld_relaxed_sys(abort_word()) != 0;
        }
        if (__shfl_sync(full, stop, 0)) return false;
      }
    }
  }

  // After every warp's poll: one cluster barrier, then every thread reads
  // the abort word, which is final for this exchange; true: go on.
  __device__ __forceinline__ bool settle() const {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    return ld_relaxed_sys(abort_word()) == 0;
  }

  __device__ __forceinline__ bool exchange(const Best& b, Won* w) {
    const int row = b.idx == NONE ? NONE : __ldg(a.gidx + b.idx);
    const unsigned stamp = a.epoch + n + 1u;
    const int par = (int)(n & 1u);
    n += 1;
    if (a.m == 1) {
      *w = Won{row, b.idx, b.fits};
      return true;
    }
    if (rank == 0 && threadIdx.x == 0) {
      const int off = (par * MAX_CARDS + a.card) * REC;
      for (int c = 0; c < a.m; ++c) {
        int* r = a.xbuf[c] + off;
        r[0] = __float_as_int(b.score);
        r[1] = row;
        r[2] = b.fits;
      }
      __threadfence_system();  // the records before any stamp, on every card
      for (int c = 0; c < a.m; ++c) st_relaxed_sys(a.xbuf[c] + off + 3, (int)stamp);
    }
    const int lane = threadIdx.x & 31;
    const int* slot = a.xbuf[a.card] + (par * MAX_CARDS + lane) * REC;
    const bool arrived = poll(slot + 3, stamp);
    Best rec = {-INFINITY, NONE, 0, 0};
    if (arrived && lane < a.m) {
      rec.idx = ld_relaxed_sys(slot + 1);
      if (rec.idx != NONE) {
        rec.score = __int_as_float(ld_relaxed_sys(slot));
        rec.fits = ld_relaxed_sys(slot + 2);
      }
    }
    // every warp of the cluster is past its poll: the abort word is final
    // for this exchange, and every thread reads the same value
    if (!settle()) return false;
    const Best top = warp_max_best(rec);
    // rows are unique across cards: this card owns the winner iff its row
    // is this card's best
    *w = Won{top.idx, top.idx != NONE && top.idx == row ? b.idx : NONE, top.fits};
    return true;
  }

  // -- the K-deep batched exchange (K > 1, m > 1) --------------------------

  // Card c's slot of round parity `par` in card `owner`'s buffer.
  __device__ __forceinline__ int* slot_of(int owner, int par, int c) const {
    return a.xbuf[owner] + BATCH_OFF + (par * MAX_CARDS + c) * SLOT;
  }

  // This card's record d of the current round, written by thread c < m of
  // CTA 0 into this card's slot on card c (a 16-byte store over NVLink).
  __device__ __forceinline__ void record(int d, const Best& b, int row, int key) const {
    if (rank == 0 && threadIdx.x < a.m) {
      const int4 v = make_int4(__float_as_int(b.score), row, b.idx == NONE ? 0 : (b.idx << 1) | b.fits, key);
      *reinterpret_cast<int4*>(slot_of(threadIdx.x, (int)(n & 1u), a.card) + REC + d * REC) = v;
    }
  }

  // The round's exchange: thread c < m of CTA 0 writes this card's count
  // `w` into its slot on card c, fences (its records and the count before
  // the stamp) and stamps; every warp polls its own buffer's stamps, lane c
  // then reads card c's count. False: a peer never answered.
  __device__ __forceinline__ bool round(int w) {
    const unsigned stamp = a.epoch + n + 1u;
    const int par = (int)(n & 1u);
    n += 1;
    if (rank == 0 && threadIdx.x < a.m) {
      int* s = slot_of(threadIdx.x, par, a.card);
      s[1] = w;
      __threadfence_system();
      st_relaxed_sys(s, (int)stamp);
    }
    const int lane = threadIdx.x & 31;
    const int* slot = slot_of(a.card, par, lane);
    const bool arrived = poll(slot, stamp);
    nrec = arrived && lane < a.m ? ld_relaxed_sys(slot + 1) : 0;
    return settle();
  }

  // Lane c < m: card c's record d of the last round (its key and, for this
  // card's records, the local index); no candidate past its count.
  __device__ __forceinline__ Best read(int d, int* key, int* local) const {
    const int lane = threadIdx.x & 31;
    Best rec = {-INFINITY, NONE, 0, 0};
    *key = -1;
    *local = NONE;
    if (lane < a.m && d < nrec) {
      const int* r = slot_of(a.card, (int)((n - 1u) & 1u), lane) + REC + d * REC;
      *key = ld_relaxed_sys(r + 3);
      rec.idx = ld_relaxed_sys(r + 1);
      const int lf = ld_relaxed_sys(r + 2);
      if (rec.idx != NONE) {
        rec.score = __int_as_float(ld_relaxed_sys(r));
        rec.fits = lf & 1;
        *local = lf >> 1;
      }
    }
    return rec;
  }

  // CTA 0 records the launch's abort word (or the fault), its exchanges or
  // rounds and its speculated iterations (scal[5], scal[6], scal[7]);
  // every card's host copy is read.
  __device__ __forceinline__ void finish(const SolveArgs& s, int r) const {
    if (r == 0 && threadIdx.x == 0) {
      const int abort = a.m == 1 ? 0 : ld_relaxed_sys(abort_word());
      s.scal[5] = abort != 0 ? abort : fault;
      s.scal[6] = (int)n;
      s.scal[7] = speculated;
    }
  }
};

// The words of the replicated region a speculation writes, in three runs:
// jptr, jready, jactive [J]; qdropped, qcount, qahs [Q]; jshare, jalloc
// [J, R + 1], qalloc [R, Q] (rep_layout's order). Saved into `saved`, or
// restored from it.
__device__ __forceinline__ int saved_words(int J, int Q, int R) { return J * (4 + R) + Q * (3 + R); }

__device__ __forceinline__ void save_region(const Rep& rep, int* saved, int J, int Q, int R, bool restore) {
  int* runs[3] = {rep.jptr, rep.qdropped, reinterpret_cast<int*>(rep.jshare)};
  const int len[3] = {3 * J, 3 * Q, J * (1 + R) + R * Q};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (restore)
      copy_words(runs[i], saved, len[i]);
    else
      copy_words(saved, runs[i], len[i]);
    saved += len[i];
  }
}

// The K-deep batched exchange: the JAX program's outer_body (:601-621),
// with the card as the unit of speculation (see the header).
template <bool kRepInSmem>
__device__ __forceinline__ void batched_loop(const MeshArgs& m, MeshExchange& x) {
  __shared__ LoopShared sh;
  namespace cg = cooperative_groups;
  const SolveArgs& a = m.s;
  const unsigned full = 0xffffffffu;
  const int tid = threadIdx.x, lane = tid & 31, rank = (int)cg::this_cluster().block_rank();
  const int J = a.J, Q = a.Q, R = a.R;
  float eps[R8];
#pragma unroll
  for (int r = 0; r < R8; ++r) eps[r] = r < R ? a.eps[r] : 0.0f;
  Slice sl;
  Rep rep;
  Scalars L = solve_begin<kRepInSmem>(a, &sl, &rep);
  Phases ph = {0, 0, -1, 0};
  const bool place = rank == 0 && x.primary();
  const float w_least = a.wts[0], w_bal = a.wts[1];
  if (m.K > BATCH_MAX || m.spec_words != saved_words(J, Q, R) + m.K * UNDO_WORDS) __trap();
  int* saved = m.spec + (size_t)rank * m.spec_words;
  int* undo_log = saved + saved_words(J, Q, R);
  TaskView task;
  task.R = R;
  task.w_least = w_least;
  task.w_bal = w_bal;

  while (loop_cond(a, L)) {
    // -- speculate: up to K placing iterations from the true state, this
    // card's best always winning. The barrier: every CTA is past the last
    // round's replay (its records may be written again two rounds on) and
    // every update of it is visible.
    cg::this_cluster().sync();
    save_region(rep, saved, J, Q, R, false);
    __syncthreads();
    const Scalars L0 = L;
    int w = 0, n_undo = 0;
    unsigned long long own = 0;  // the undo entries of nodes this thread owns
    while (w < m.K && loop_cond(a, L)) {
      select_job(a, rep, L, sh, ph);
      const Pop p = pop_task(a, rep, L, ph);
      Won won = {NONE, NONE, 0};
      int* undo = nullptr;
      task.has_sc = false;
      task.tports = 0;
      if (p.proc) {
        load_task(task, rep, p.cls, eps);
        const Best best = sweep(a, rep, sl, task, p.cls, sh, ph);
        const int row = best.idx == NONE ? NONE : __ldg(m.gidx + best.idx);
        x.record(w, best, row, __ldg(m.ckey + p.cls));
        won = Won{row, best.idx, best.fits};
        w += 1;
        const int ln = best.idx - sl.lo;
        if (best.idx != NONE && ln >= 0 && ln < sl.n) {  // this CTA's node changes: log it
          if (ln % NT == tid) {
            own |= 1ull << n_undo;
            undo = undo_log + n_undo * UNDO_WORDS;
          }
          n_undo += 1;
        }
      }
      commit(a, rep, sl, L, p, task, won, false, undo);
    }
    x.speculated += w;

    // -- back to the true state: each node by its owner, newest entry
    // first (old values, never an update added back), then the region
    __syncthreads();
    while (own != 0) {
      const int e = 63 - __clzll((long long)own);
      own &= ~(1ull << e);
      const int* u = undo_log + e * UNDO_WORDS;
      const int ln = u[0];
      const float* f = reinterpret_cast<const float*>(u + 3);
      sl.ntasks[ln] = u[1];
      sl.nports[ln] = u[2];
      for (int r = 0; r < R; ++r) {
        sl.idle[r * sl.S + ln] = f[r];
        sl.rel[r * sl.S + ln] = f[R8 + r];
        sl.used[r * sl.S + ln] = f[2 * R8 + r];
      }
    }
    save_region(rep, saved, J, Q, R, true);
    __syncthreads();
    L = L0;

    // -- the round's exchange: every card's records at once
    if (!x.round(w)) break;

    // -- replay: the true iterations, no sweep; lane c holds card c's
    // depth pointer
    int d = 0;
    const int it0 = L.it;
    while (loop_cond(a, L)) {
      const Scalars before = L;
      select_job(a, rep, L, sh, ph);
      const Pop p = pop_task(a, rep, L, ph);
      Won won = {NONE, NONE, 0};
      task.has_sc = false;
      task.tports = 0;
      if (p.proc) {
        int key, local;
        const Best rec = x.read(d, &key, &local);
        const int want = __ldg(m.ckey + p.cls);
        // a record is usable while every card has one and each swept this
        // task's fields; else this iteration is speculated again
        if (!__all_sync(full, lane >= m.m || (d < x.nrec && key == want))) {
          L = before;
          break;
        }
        load_task(task, rep, p.cls, eps);
        const Best top = warp_max_best(rec);
        const int mine = __shfl_sync(full, rec.idx, m.card);
        const int mine_local = __shfl_sync(full, local, m.card);
        won = Won{top.idx, top.idx != NONE && top.idx == mine ? mine_local : NONE, top.fits};
        // the winning card consumed its record; a global abandon, every card's
        d += top.idx == NONE || rec.idx == top.idx ? 1 : 0;
      }
      commit(a, rep, sl, L, p, task, won, place, nullptr);
    }
    if (L.it == it0) {  // iteration 0 of a replay always commits
      x.fault = -1;
      break;
    }
  }
  solve_end(a, sl, rep, L, rank, x.primary());
  x.finish(a, rank);
}

template <bool kRepInSmem, bool kBatched>
__global__ void __launch_bounds__(NT, 1) mesh_solve_kernel(const MeshArgs a) {
  namespace cg = cooperative_groups;
  MeshExchange x(a, (int)cg::this_cluster().block_rank());
  if constexpr (kBatched)
    batched_loop<kRepInSmem>(a, x);
  else
    solve_loop<kRepInSmem>(a.s, x);
}

static cudaLaunchConfig_t launch_config(const MeshArgs& a, void* stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.s.k, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = a.s.smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = a.s.k;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

static bool batched(const MeshArgs& a) { return a.K > 1 && a.m > 1; }

static const void* kernel_of(const MeshArgs& a) {
  if (batched(a))
    return a.s.rep_in_smem ? (const void*)mesh_solve_kernel<true, true> : (const void*)mesh_solve_kernel<false, true>;
  return a.s.rep_in_smem ? (const void*)mesh_solve_kernel<true, false> : (const void*)mesh_solve_kernel<false, false>;
}

// The launch's shared-memory size, and clusters past the portable 8 CTAs.
static cudaError_t set_attributes(const MeshArgs& a) {
  const void* fn = kernel_of(a);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, a.s.smem_bytes);
  if (err == cudaSuccess && a.s.k > PORTABLE_CLUSTER)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

extern "C" {

// Launch one card's cluster on `stream` of `device`; returns the first
// failing call's cudaError_t (0 on success). The caller launches every
// card of the solve before it waits on any.
int kbt_mesh_solve(const MeshArgs* args, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaError_t err = set_attributes(*args);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(*args, stream, &attr);
  if (batched(*args))
    err = args->s.rep_in_smem ? cudaLaunchKernelEx(&cfg, mesh_solve_kernel<true, true>, *args)
                              : cudaLaunchKernelEx(&cfg, mesh_solve_kernel<false, true>, *args);
  else
    err = args->s.rep_in_smem ? cudaLaunchKernelEx(&cfg, mesh_solve_kernel<true, false>, *args)
                              : cudaLaunchKernelEx(&cfg, mesh_solve_kernel<false, false>, *args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many of one card's clusters `device` can hold at once, into *out;
// returns the first failing call's cudaError_t.
int kbt_mesh_solve_max_clusters(const MeshArgs* args, int device, int* out) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const cudaError_t err = set_attributes(*args);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(*args, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, kernel_of(*args), &cfg);
}

// Let `device`'s kernels write `peer`'s memory. Access already enabled is
// success (the sticky error it leaves is cleared).
int kbt_mesh_enable_peer(int device, int peer) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const cudaError_t err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    return 0;
  }
  return (int)err;
}

const char* kbt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
