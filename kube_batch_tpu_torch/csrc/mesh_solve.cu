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
// reaches that barrier only after it has read exchange n's records (in the
// batched exchange, a warp stages every record it reads before it arrives
// there). So no record is overwritten before every CTA of every card has
// read it.
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
//   - The iterations before the next placing one place nothing and read
//     no record: they commit first (every card alike), and the round
//     starts at a placing iteration, whose record every chain holds.
//   - Speculate (the chain): from the true state, up to K placing
//     iterations (at most SPEC_ITERS iterations) with this card's best
//     always winning (solve_loop.cuh's select_job, pop_task, sweep and
//     commit, placements not recorded). Each placing iteration's record
//     (score, row, local index and fits-idle bit, the task class's key,
//     ops/mesh_solve.py class_keys: equal for classes whose sweep fields
//     are equal) goes straight into this card's slot on every card. A
//     pause, max_iter, SPEC_ITERS, a second overused-queue drop (below) or
//     the loop's end stops it early, so cards may write different counts.
//   - The nodes back to the round's start. Each CTA logs, before a
//     speculative update of one of its nodes, the node's old values
//     (UNDO_WORDS: pod count, ports, idle, releasing and used rows) in
//     shared memory; the owner threads restore them newest first (an
//     update is never undone by adding back: __fsub_rn then __fadd_rn does
//     not return the old float). The replicated region is journaled in
//     shared memory instead (solve_loop.cuh RegionLog): each writer of a
//     replicated word in commit logs its old value first, O(R) words an
//     iteration (the job's jptr, jready, jactive, jshare and jalloc
//     column, its queue's qcount, qahs and qalloc column). An overused
//     queue's drop (select_job) retires up to J jobs at once: the chain's
//     first such drop saves the runs it writes, jactive [J] (int4 where
//     aligned), qdropped and qcount [Q], into `spec` first (save_runs),
//     and the chain ends before a second one (its hook refuses it, so
//     select_job writes nothing): the one saved copy and the journal
//     bring the region back to before any of the chain's iterations.
//     The region stays as the chain left it until the replay (below).
//   - Round-start records. A card that has won nothing in a round still
//     holds its round-start block, so its best for any task class over that
//     block is exact for the true chain. With the nodes back, each CTA takes
//     the distinct keys of its chain's records after the first (the first
//     record is the round-start record of its own key) and runs one
//     multi-key sweep over its slice (solve_loop.cuh sweep_keys: each node
//     read once and scored for every key, one cluster barrier for up to
//     KEY_CHUNK keys); CTA 0 writes the bests into the slot's second half.
//   - Exchange: thread c < m of CTA 0 writes the round-start records and
//     this card's two counts into its slot on card c, fences and stamps
//     (the same protocol as K = 1, on a slot of 2 BATCH_MAX records a card
//     and parity); every warp polls its own buffer's stamps, then copies
//     its share of every card's records into shared memory (`stage`) with
//     16-byte system-scope loads; the abort word and the cluster barrier as
//     at K = 1. That barrier is the round's only one outside the sweeps:
//     every record of the round is read before it (see Stamps and
//     parities), and the replay reads shared memory.
//   - Replay, no sweep: the true iterations, lane c of every warp holding
//     card c's chain pointer and standing. Card c answers a placing
//     iteration of key k from its chain record at its pointer when all its
//     wins this round came from its chain in order and that record's key
//     is k (the JAX program's rule); else, while it has won nothing this
//     round, from its round-start record of key k. If any card can answer
//     neither way, the replay stops before the iteration (nothing of it
//     committed) and the next round speculates it again. The winner is
//     winner()'s (highest score, then lowest row). A winner that answered
//     from its chain advances its pointer; one that answered from a
//     round-start record leaves its chain. A global abandon changes no
//     block: every card that answered from its chain advances. Every
//     record read is the card's best over its block as it truly stands, so
//     the result is K = 1's bit for bit, and a round commits at least what
//     the JAX rule would from the same state.
//     The region evolves with each iteration's task, whether it found a
//     node and that node's fits-idle bit, never with which node. So while
//     the truth agrees with this card's chain on those (the tasks agree
//     then too), the chain's region and scalars are the truth's: the
//     replay only decides each winner and applies this card's true wins to
//     its nodes (and, on the primary card, records the placements). At the
//     first iteration where they part, the journal rolls the region back
//     to before it (around the saved runs when the drop came after it),
//     and from there the replay selects, pops and commits as the chain
//     did. Speculated iterations never count toward `it`. A round whose
//     replay commits nothing (iteration 0 of a replay always can) sets
//     scal[5] to -1 and ends the launch.
// A round costs up to K chain sweeps and one multi-key sweep, the journal
// and the node undo, one exchange and the replay's decisions (selections
// and commits only past the chain's agreement), against one exchange a
// placing iteration at K = 1.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "solve_loop.cuh"

#define MAX_CARDS 8  // the most cards one host joins all to all
#define REC 4        // int32 words of one record: score bits, row, fits-idle, stamp
#define BATCH_MAX 64  // the deepest batched exchange (the JAX package's clamp of K)
// One card's records of one round of the batched exchange: a header (stamp,
// chain records, round-start records, pad), BATCH_MAX chain records, then
// BATCH_MAX round-start records (each: score bits, row, local index << 1 |
// fits-idle, key).
#define SLOT (REC + 2 * BATCH_MAX * REC)
#define SPEC_ITERS(K) (4 * (K))  // the most iterations a chain runs: its journal's capacity
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
  int spec_words;    // words of one CTA's slice of `spec` (K > 1): spec_words_of
  int batch_words;   // shared words of the batched exchange's scratch (K > 1): batch_layout
  const int* ckey;   // [s.C] each class's record key (K > 1)
  int* spec;         // [s.k][spec_words] each CTA's saved runs (K > 1)
  unsigned long long* split;  // [SPLIT_WORDS] the round's parts (the timed instantiation only)
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

__device__ __forceinline__ int4 ld_relaxed_sys_v4(const int* p) {
  int4 v;
  asm volatile("ld.relaxed.sys.global.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
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

// The parts of a round of the batched exchange, in the order of
// ops/mesh_solve.py SPLIT_PARTS; SPLIT_WORDS adds the rounds timed.
enum SplitPart {
  SPLIT_CHAIN,
  SPLIT_SAVE,
  SPLIT_NODE_UNDO,
  SPLIT_RESTORE,
  SPLIT_TOP_BARRIER,
  SPLIT_MULTIKEY,
  SPLIT_EXCHANGE,
  SPLIT_REPLAY,
  SPLIT_PARTS
};
#define SPLIT_WORDS (SPLIT_PARTS + 1)

// A round's time by part, on the %globaltimer clock of thread 0 of CTA 0
// (a part ends where that thread marks it): only the timed instantiation
// (kTimed, launched by kbt_mesh_solve_timed, which chip_smoke.py alone
// calls) reads the clock; otherwise every member compiles to nothing.
template <bool kTimed>
struct RoundSplit {
  bool on = false;
  unsigned long long last = 0, ns[SPLIT_PARTS] = {};
  unsigned long long rounds = 0;

  __device__ explicit RoundSplit(bool stamps) {
    if constexpr (kTimed) {
      on = stamps;
      if (on) last = global_ns();
    }
  }

  __device__ __forceinline__ void mark(SplitPart part) {
    if constexpr (kTimed) {
      if (on) {
        const unsigned long long now = global_ns();
        ns[part] += now - last;
        last = now;
      }
    }
  }

  __device__ __forceinline__ void round() {
    if constexpr (kTimed) rounds += 1;
  }

  __device__ __forceinline__ void write(unsigned long long* out) const {
    if constexpr (kTimed) {
      if (on) {
#pragma unroll
        for (int i = 0; i < SPLIT_PARTS; ++i) out[i] = ns[i];
        out[SPLIT_PARTS] = rounds;
      }
    }
  }
};

// The batched exchange's shared scratch, after the launch's node slice and
// replicated region (16-byte aligned), in words: the staged records of the
// round [m][2K] (int4: chain records, then round-start records), the
// multi-key sweep's warp bests [KEY_CHUNK][NWARPS] and cluster slots
// [2][KEY_CHUNK][MAX_CLUSTER] (Best), CTA 0's round-start bests [K], the
// sweep's task rows [KEY_CHUNK][TASK_WORDS] and groups [KEY_CHUNK], the
// round-start classes [K], the chain's log [K][PLOG_WORDS] (a placing
// iteration's class, task, iteration number, outcome, journal counts and
// scalars before it), the region journal (RegionLog: SPEC_ITERS(K)
// entries of thread 0, K of threads 32 and 64), the node undo log [K]
// [UNDO_WORDS] and the round-start key count. The total is ops/mesh_solve.py batch_words (the kernel traps on a
// launch whose size disagrees).
#define PLOG_WORDS (7 + sizeof(Scalars) / 4)
static_assert(sizeof(Scalars) == 28, "ops/mesh_solve.py PLOG_WORDS counts 7 scalars");
struct BatchShared {
  int4* stage;
  Best *warps, *slots, *kres;
  int *tasks, *group, *kcls, *plog, *j0, *j32, *j64, *undo, *nk;
  int* end;
};

__device__ __forceinline__ BatchShared batch_layout(int* w, int K, int m) {
  BatchShared b;
  b.stage = reinterpret_cast<int4*>(w); w += 4 * m * 2 * K;
  b.warps = reinterpret_cast<Best*>(w); w += 4 * KEY_CHUNK * NWARPS;
  b.slots = reinterpret_cast<Best*>(w); w += 4 * 2 * KEY_CHUNK * MAX_CLUSTER;
  b.kres = reinterpret_cast<Best*>(w); w += 4 * K;
  b.tasks = w; w += KEY_CHUNK * TASK_WORDS;
  b.group = w; w += KEY_CHUNK;
  b.kcls = w; w += K;
  b.plog = w; w += K * PLOG_WORDS;
  b.j0 = w; w += SPEC_ITERS(K) * LOG0_WORDS;
  b.j32 = w; w += K * LOG_ROW_WORDS;
  b.j64 = w; w += K * LOG_ROW_WORDS;
  b.undo = w; w += K * UNDO_WORDS;
  b.nk = w; w += 4;
  b.end = w;
  return b;
}

// Words of one CTA's slice of `spec`: the runs an overused queue's drop
// writes (save_runs), with up to 3 words to match the region's alignment.
__device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }
__device__ __forceinline__ int spec_words_of(int J, int Q) { return round4(4 + J + 2 * Q); }

// B4's exchange between the cards of one solve (see the header).
struct MeshExchange {
  const MeshArgs& a;
  int rank;
  unsigned n = 0;       // exchanges (K = 1) or rounds (K > 1) of this launch so far
  int nrec = 0;         // lane c: card c's chain records in the last round
  int nstart = 0;       // lane c: card c's round-start records in the last round
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

  // This card's chain record d of the current round, written by thread
  // c < m of CTA 0 into this card's slot on card c (a 16-byte store over
  // NVLink).
  __device__ __forceinline__ void record(int d, const Best& b, int row, int key) const {
    if (rank == 0 && threadIdx.x < a.m) {
      const int4 v = make_int4(__float_as_int(b.score), row, b.idx == NONE ? 0 : (b.idx << 1) | b.fits, key);
      *reinterpret_cast<int4*>(slot_of(threadIdx.x, (int)(n & 1u), a.card) + REC + d * REC) = v;
    }
  }

  // The round's exchange: thread c < m of CTA 0 writes this card's nk
  // round-start records (CTA 0's `bs.kres`, keyed by `bs.kcls`) and its
  // counts `w` and nk into its slot on card c, fences (its records and the
  // counts before the stamp) and stamps; every warp polls its own buffer's
  // stamps, then stages its share of every card's 2K record words (chain
  // records, then round-start records) into `bs.stage`, lane c reading
  // card c's counts. The cluster barrier of settle() follows. False: a peer
  // never answered.
  __device__ __forceinline__ bool round(int w, int nk, const BatchShared& bs) {
    const unsigned stamp = a.epoch + n + 1u;
    const int par = (int)(n & 1u);
    n += 1;
    if (rank == 0 && threadIdx.x < a.m) {
      int* s = slot_of(threadIdx.x, par, a.card);
      for (int j = 0; j < nk; ++j) {
        const Best b = bs.kres[j];
        const int row = b.idx == NONE ? NONE : __ldg(a.gidx + b.idx);
        *reinterpret_cast<int4*>(s + REC + (BATCH_MAX + j) * REC) = make_int4(
            __float_as_int(b.score), row, b.idx == NONE ? 0 : (b.idx << 1) | b.fits, __ldg(a.ckey + bs.kcls[j]));
      }
      s[1] = w;
      s[2] = nk;
      __threadfence_system();
      st_relaxed_sys(s, (int)stamp);
    }
    const int lane = threadIdx.x & 31;
    const int* slot = slot_of(a.card, par, lane);
    const bool arrived = poll(slot, stamp);
    nrec = nstart = 0;
    if (arrived) {
      __syncwarp();  // every lane's acquire of its card's stamp before any lane reads that card's records
      const int per_card = 2 * a.K;
      for (int e = threadIdx.x; e < a.m * per_card; e += NT) {
        const int c = e / per_card, j = e - c * per_card;
        bs.stage[e] = ld_relaxed_sys_v4(slot_of(a.card, par, c) + REC + (j < a.K ? j : BATCH_MAX + j - a.K) * REC);
      }
      if (lane < a.m) {
        nrec = ld_relaxed_sys(slot + 1);
        nstart = ld_relaxed_sys(slot + 2);
      }
    }
    return settle();
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

// Copies n words from src to dst, 16 bytes at a time where both allow
// (dst and src must lie at the same offset within 16 bytes); every thread
// of the CTA takes part.
__device__ __forceinline__ void copy_vec(int* dst, const int* src, int n) {
  const int head = min(n, (int)((4 - ((reinterpret_cast<uintptr_t>(src) >> 2) & 3)) & 3));
  for (int i = threadIdx.x; i < head; i += NT) dst[i] = src[i];
  const int n4 = (n - head) >> 2;
  int4* d4 = reinterpret_cast<int4*>(dst + head);
  const int4* s4 = reinterpret_cast<const int4*>(src + head);
  for (int i = threadIdx.x; i < n4; i += NT) d4[i] = s4[i];
  for (int i = head + 4 * n4 + threadIdx.x; i < n; i += NT) dst[i] = src[i];
}

// The runs an overused queue's drop writes: jactive [J] (at the same
// offset within 16 bytes as the region's, so copy_vec moves it 16 bytes at
// a time), then qdropped and qcount [Q], saved into `snap` (16-byte
// aligned) or restored from it.
__device__ __forceinline__ void save_runs(const Rep& rep, int* snap, int J, int Q, bool restore) {
  int* ja = snap + ((reinterpret_cast<uintptr_t>(rep.jactive) >> 2) & 3);
  int* qd = ja + J;
  int* qc = qd + Q;
  if (restore) {
    copy_vec(rep.jactive, ja, J);
    copy_words(rep.qdropped, qd, Q);
    copy_words(rep.qcount, qc, Q);
  } else {
    copy_vec(ja, rep.jactive, J);
    copy_words(qd, rep.qdropped, Q);
    copy_words(qc, rep.qcount, Q);
  }
}

// Undoes the journal's newest entries, newest first: thread 0's from its
// count down to lo0, thread 32's down to lo32, thread 64's down to lo64
// (each the words that thread alone writes).
__device__ __forceinline__ void unlog(const Rep& rep, const RegionLog& log, int lo0, int hi0, int lo32, int lo64,
                                      int J, int Q, int R) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int e = hi0 - 1; e >= lo0; --e) {
      const int* x = log.j0 + e * LOG0_WORDS;
      const int j = x[0];
      rep.jptr[j] = x[1];
      rep.jready[j] = x[2];
      rep.jactive[j] = x[3];
      rep.qcount[rep.jqueue[j]] = x[4];
    }
  }
  if (tid == 32) {
    for (int e = log.n32 - 1; e >= lo32; --e) {
      const int* x = log.j32 + e * LOG_ROW_WORDS;
      const int j = x[0];
      rep.jshare[j] = __int_as_float(x[1]);
      for (int r = 0; r < R; ++r) rep.jalloc[r * J + j] = __int_as_float(x[2 + r]);
    }
  }
  if (tid == 64) {
    for (int e = log.n64 - 1; e >= lo64; --e) {
      const int* x = log.j64 + e * LOG_ROW_WORDS;
      const int q = x[0];
      rep.qahs[q] = x[1];
      for (int r = 0; r < R; ++r) rep.qalloc[r * Q + q] = __int_as_float(x[2 + r]);
    }
  }
}

// The owner thread's update of a node this card won, as commit() makes it
// (the same operations in the same order): local index `local` on the
// launch's node axis, the task's resource row (R8) and ports.
__device__ __forceinline__ void apply_win(const Slice& sl, int local, const float* res, int tports, bool fits_idle,
                                          int R) {
  const int ln = local - sl.lo, S = sl.S;
  if (local == NONE || ln < 0 || ln >= sl.n || ln % NT != (int)threadIdx.x) return;
#pragma unroll
  for (int r = 0; r < R8; ++r) {
    if (r >= R) break;
    if (fits_idle)
      sl.idle[r * S + ln] = __fsub_rn(sl.idle[r * S + ln], res[r]);
    else
      sl.rel[r * S + ln] = __fsub_rn(sl.rel[r * S + ln], res[r]);
    sl.used[r * S + ln] = __fadd_rn(sl.used[r * S + ln], res[r]);
  }
  sl.ntasks[ln] += 1;
  sl.nports[ln] |= tports;
}

// Lane c's answer for card c to a placing iteration of key `want` (the
// replay's rule, see the header), then the winner over every card.
// Returns false when some card cannot answer (the round stops before the
// iteration). Else *won is the winner as commit() takes it and lane c's
// standing (pointer, fresh, chained) is updated.
struct ReplayLane {
  int d = 0;             // card c's chain pointer
  bool fresh = true;     // card c has won nothing this round
  bool chained = true;   // card c's wins came from its chain, in order
};

__device__ __forceinline__ bool answer(const MeshArgs& m, const MeshExchange& x, const int4* stage, int K, int want,
                                       ReplayLane& ln, Won* won) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int via = 0;  // 1: the chain record at the pointer; 2: a round-start record
  int4 r = make_int4(0, NONE, 0, -1);
  if (lane < m.m) {
    if (ln.chained && ln.d < x.nrec) {
      const int4 c = stage[ln.d];
      if (c.w == want) {
        r = c;
        via = 1;
      }
    }
    if (via == 0 && ln.fresh) {
      if (x.nrec > 0 && stage[0].w == want) {
        r = stage[0];
        via = 2;
      }
      for (int j = 0; via == 0 && j < x.nstart; ++j) {
        const int4 c = stage[K + j];
        if (c.w == want) {
          r = c;
          via = 2;
        }
      }
    }
  }
  // every card must answer exactly; else this iteration is speculated again
  if (!__all_sync(full, lane >= m.m || via != 0)) return false;
  Best rec = {-INFINITY, NONE, 0, 0};
  if (via != 0 && r.y != NONE) {
    rec.score = __int_as_float(r.x);
    rec.idx = r.y;
    rec.fits = r.z & 1;
  }
  const int local = rec.idx != NONE ? r.z >> 1 : NONE;
  const Best top = warp_max_best(rec);
  const int mine = __shfl_sync(full, rec.idx, m.card);
  const int mine_local = __shfl_sync(full, local, m.card);
  *won = Won{top.idx, top.idx != NONE && top.idx == mine ? mine_local : NONE, top.fits};
  if (top.idx == NONE) {  // a global abandon changes no block
    ln.d += via == 1 ? 1 : 0;
  } else if (rec.idx == top.idx) {  // this lane's card won
    ln.fresh = false;
    if (via == 1)
      ln.d += 1;
    else
      ln.chained = false;
  }
  return true;
}

// Whether every card could still answer some placing iteration: a card
// that has won and cannot answer from its chain answers none, whatever
// its key. The replay stops there, before the next selection; the
// iterations that place nothing up to the next placing one then commit
// at the next round's start, as they would have here.
__device__ __forceinline__ bool can_answer(const MeshArgs& m, const MeshExchange& x, const ReplayLane& ln) {
  const int lane = threadIdx.x & 31;
  return __all_sync(0xffffffffu, lane >= m.m || ln.fresh || (ln.chained && ln.d < x.nrec));
}

// The K-deep batched exchange: the JAX program's outer_body (:601-621),
// with the card as the unit of speculation and exact records past a
// mismatch (see the header).
template <bool kRepInSmem, bool kTimed>
__device__ __forceinline__ void batched_loop(const MeshArgs& m, MeshExchange& x) {
  __shared__ LoopShared sh;
  extern __shared__ __align__(16) int smem[];
  namespace cg = cooperative_groups;
  const SolveArgs& a = m.s;
  const unsigned full = 0xffffffffu;
  const int tid = threadIdx.x, lane = tid & 31, rank = (int)cg::this_cluster().block_rank();
  const int J = a.J, Q = a.Q, R = a.R, K = m.K;
  float eps[R8];
#pragma unroll
  for (int r = 0; r < R8; ++r) eps[r] = r < R ? a.eps[r] : 0.0f;
  Slice sl;
  Rep rep;
  Scalars L = solve_begin<kRepInSmem>(a, &sl, &rep);
  Phases ph = {0, 0, -1, 0};
  const bool place = rank == 0 && x.primary();
  const float w_least = a.wts[0], w_bal = a.wts[1];
  int* const bs_base = smem + round4(a.smem_bytes / 4);
  const BatchShared bs = batch_layout(bs_base, K, m.m);
  if (K > BATCH_MAX || m.spec_words != spec_words_of(J, Q) || bs.end - bs_base != m.batch_words) __trap();
  int* const undo_log = bs.undo;
  int* const snap = m.spec + (size_t)rank * m.spec_words;
  TaskView task;
  task.R = R;
  task.w_least = w_least;
  task.w_bal = w_bal;
  RoundSplit<kTimed> split(rank == 0 && tid == 0);

  while (true) {
    // -- the iterations before the next placing one place nothing and
    // read no record: every card's chain and the replay would run them
    // alike, so they commit; a round starts at a placing iteration
    bool placing = false;
    Scalars at_round = L;  // before the selection of the round's first iteration
    while (loop_cond(a, L)) {
      at_round = L;
      select_job(a, rep, L, sh, ph);
      const Pop p = pop_task(a, rep, L, ph);
      if (p.proc) {
        placing = true;
        break;
      }
      commit(a, rep, sl, L, p, task, Won{NONE, NONE, 0}, place, nullptr);
    }
    if (!placing) break;
    split.mark(SPLIT_REPLAY);
    split.round();
    // -- speculate (the chain): up to K placing iterations from the true
    // state (this one's selection made), this card's best always winning,
    // every write of the region journaled. Thread 0 logs each placing
    // iteration: its class, task, scalars and journal counts before it,
    // its iteration number and its outcome (a candidate, its fits-idle bit)
    RegionLog log = {bs.j0, bs.j32, bs.j64, 0, 0, 0};
    int w = 0, iters = 0, n_undo = 0, snap_at = -1, snap_iter = -1;
    bool second_drop = false;
    unsigned long long own = 0;  // the undo entries of nodes this thread owns
    // an overused queue's drop in the chain: the first saves the runs it
    // writes; a second is refused (nothing saves its runs) and ends the
    // chain before it, as a pause does
    auto before_drop = [&]() -> bool {
      if (snap_at >= 0) {
        second_drop = true;
        return false;
      }
      split.mark(SPLIT_CHAIN);
      save_runs(rep, snap, J, Q, false);
      __syncthreads();
      snap_at = log.n0;
      snap_iter = iters;
      split.mark(SPLIT_SAVE);
      return true;
    };
    while (w < K && iters < SPEC_ITERS(K) && loop_cond(a, L)) {
      const Scalars before = L;
      const int n0 = log.n0, n32 = log.n32, n64 = log.n64;
      select_job(a, rep, L, sh, ph, before_drop);
      if (second_drop) break;  // select_job wrote nothing
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
        if (tid == 0) {
          int* e = bs.plog + w * PLOG_WORDS;
          e[0] = p.cls;
          e[1] = p.t;
          e[2] = iters;
          e[3] = (best.idx != NONE ? 1 : 0) | (best.fits << 1);
          e[4] = n0;
          e[5] = n32;
          e[6] = n64;
          *reinterpret_cast<Scalars*>(e + 7) = before;
        }
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
      commit(a, rep, sl, L, p, task, won, false, undo, &log);
      iters += 1;
    }
    x.speculated += w;

    // -- the nodes back to the round's start: each by its owner, newest
    // entry first (old values, never an update added back). The region
    // stays as the chain left it: the replay keeps what the truth shares.
    __syncthreads();
    split.mark(SPLIT_CHAIN);
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
    split.mark(SPLIT_NODE_UNDO);
    // The region and the scalars back to before the chain's placing
    // iteration i (i < w): the journal newest first down to that
    // iteration's counts, around the saved runs when the drop that saved
    // them came after it.
    auto rollback = [&](int i) {
      split.mark(SPLIT_REPLAY);
      const int* e = bs.plog + i * PLOG_WORDS;
      const int c0 = e[4], c32 = e[5], c64 = e[6];
      if (snap_at >= 0 && snap_iter > e[2]) {
        unlog(rep, log, snap_at, log.n0, c32, c64, J, Q, R);
        __syncthreads();
        save_runs(rep, snap, J, Q, true);
        __syncthreads();
        unlog(rep, log, c0, snap_at, log.n32, log.n64, J, Q, R);
      } else {
        unlog(rep, log, c0, log.n0, c32, c64, J, Q, R);
      }
      L = *reinterpret_cast<const Scalars*>(e + 7);
      __syncthreads();
      split.mark(SPLIT_RESTORE);
    };
    // the round-start keys: the chain's record keys after the first that
    // differ from it and from each other, found by warp 0 (the chain's
    // classes are in every CTA alike)
    if (tid < 32) {
      const int k0 = w > 0 ? __ldg(m.ckey + bs.plog[0]) : -1;
      int count = 0;
      for (int base = 1; base < w; base += 32) {
        const int j = base + lane;
        int c = 0;
        bool keep = false;
        if (j < w) {
          c = bs.plog[j * PLOG_WORDS];
          const int kj = __ldg(m.ckey + c);
          keep = kj != k0;
          for (int i = 1; keep && i < j; ++i) keep = __ldg(m.ckey + bs.plog[i * PLOG_WORDS]) != kj;
        }
        const unsigned kept = __ballot_sync(full, keep);
        if (keep) bs.kcls[count + __popc(kept & ((1u << lane) - 1u))] = c;
        count += __popc(kept);
      }
      if (lane == 0) *bs.nk = count;
    }
    __syncthreads();
    // -- the round-start records: one multi-key sweep over the round-start
    // block (the nodes are back; the class rows it reads are static)
    const int nk = *bs.nk;
    if (nk > 0) {
      sweep_keys(a, rep, sl, bs.kcls, nk, eps, w_least, w_bal, bs.tasks, bs.group, bs.warps, bs.slots, bs.kres);
      __syncthreads();  // CTA 0's bests before its record writers read them
    }
    split.mark(SPLIT_MULTIKEY);

    // -- the round's exchange: every card's records at once, staged
    const bool go_on = x.round(w, nk, bs);
    split.mark(SPLIT_EXCHANGE);
    if (!go_on) {  // a peer never answered: the state as the round found it
      rollback(0);
      L = at_round;
      break;
    }

    // -- replay: the true iterations from the staged records, no sweep;
    // lane c holds card c's standing. While this card's chain agrees with
    // the truth (the same task, a candidate or none alike, the same
    // fits-idle bit: the region evolves alike), the chain's region and
    // scalars are the truth's: the replay decides the winner and applies
    // this card's true wins to its nodes, no selection and no commit.
    // From the first iteration where they part (or past the chain), the
    // region rolls back to before it and the replay selects and commits.
    ReplayLane standing;
    const int4* stage = bs.stage + (lane < m.m ? lane : 0) * 2 * K;
    const int it0 = at_round.it;
    bool stopped = false;
    int i = 0;
    for (; i < w; ++i) {
      const int* e = bs.plog + i * PLOG_WORDS;
      const int cls = e[0];
      Won won;
      if (!answer(m, x, stage, K, __ldg(m.ckey + cls), standing, &won)) {
        rollback(i);  // the round stops before this iteration
        stopped = true;
        break;
      }
      const bool chain_any = (e[3] & 1) != 0, chain_fits = (e[3] & 2) != 0;
      const bool agree = chain_any == (won.idx != NONE) && (!chain_any || chain_fits == (won.fits != 0));
      if (!agree) {
        // the region parts from the chain here: back to before it, then
        // commit this iteration with the winner already decided
        rollback(i);
        select_job(a, rep, L, sh, ph);
        const Pop p = pop_task(a, rep, L, ph);
        task.has_sc = false;
        task.tports = 0;
        load_task(task, rep, p.cls, eps);
        commit(a, rep, sl, L, p, task, won, place, nullptr);
        ++i;
        break;
      }
      if (won.idx != NONE) {
        const int t = e[1];
        apply_win(sl, won.local, rep.cres + cls * R8, rep.cpt[cls], won.fits != 0, R);
        if (place && tid == 0) {
          a.tnode[t] = won.idx;
          a.tkind[t] = won.fits != 0 ? 1 : 2;
          a.tpos[t] = reinterpret_cast<const Scalars*>(e + 7)->step;
        }
      }
    }
    if (!stopped) {
      // past the chain's agreement: the scalars stand where the region
      // does (after the chain's last iteration, or after the iteration
      // just committed); select and commit from the records
      while (loop_cond(a, L) && can_answer(m, x, standing)) {
        const Scalars before = L;
        select_job(a, rep, L, sh, ph);
        const Pop p = pop_task(a, rep, L, ph);
        Won won = {NONE, NONE, 0};
        task.has_sc = false;
        task.tports = 0;
        if (p.proc) {
          if (!answer(m, x, stage, K, __ldg(m.ckey + p.cls), standing, &won)) {
            L = before;
            break;
          }
          load_task(task, rep, p.cls, eps);
        }
        commit(a, rep, sl, L, p, task, won, place, nullptr);
      }
    }
    split.mark(SPLIT_REPLAY);
    if (L.it == it0) {  // a round commits at least its first iteration
      x.fault = -1;
      break;
    }
  }
  solve_end(a, sl, rep, L, rank, x.primary());
  x.finish(a, rank);
  split.write(m.split);
}

template <bool kRepInSmem, bool kBatched, bool kTimed = false>
__global__ void __launch_bounds__(NT, 1) mesh_solve_kernel(const MeshArgs a) {
  namespace cg = cooperative_groups;
  MeshExchange x(a, (int)cg::this_cluster().block_rank());
  if constexpr (kBatched)
    batched_loop<kRepInSmem, kTimed>(a, x);
  else
    solve_loop<kRepInSmem>(a.s, x);
}

static bool batched(const MeshArgs& a) { return a.K > 1 && a.m > 1; }

// The launch's dynamic shared memory: B1's layout (s.smem_bytes), and for
// the batched exchange its scratch after it, 16-byte aligned.
static size_t dynamic_smem(const MeshArgs& a) {
  if (!batched(a)) return (size_t)a.s.smem_bytes;
  return (size_t)((a.s.smem_bytes + 15) & ~15) + 4 * (size_t)a.batch_words;
}

static cudaLaunchConfig_t launch_config(const MeshArgs& a, void* stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.s.k, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = dynamic_smem(a);
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = a.s.k;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

static const void* kernel_of(const MeshArgs& a, bool timed = false) {
  if (timed)
    return a.s.rep_in_smem ? (const void*)mesh_solve_kernel<true, true, true>
                           : (const void*)mesh_solve_kernel<false, true, true>;
  if (batched(a))
    return a.s.rep_in_smem ? (const void*)mesh_solve_kernel<true, true> : (const void*)mesh_solve_kernel<false, true>;
  return a.s.rep_in_smem ? (const void*)mesh_solve_kernel<true, false> : (const void*)mesh_solve_kernel<false, false>;
}

// The launch's shared-memory size, and clusters past the portable 8 CTAs.
static cudaError_t set_attributes(const MeshArgs& a, bool timed = false) {
  const void* fn = kernel_of(a, timed);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dynamic_smem(a));
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

// The batched exchange's timed instantiation (K > 1 over two or more
// cards): the same launch as kbt_mesh_solve's, with thread 0 of CTA 0
// stamping each part of every round into args->split at exit. Only
// chip_smoke.py calls it, for the round's split; no solve reaches it.
int kbt_mesh_solve_timed(const MeshArgs* args, int device, void* stream) {
  if (!batched(*args) || args->split == nullptr) return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaError_t err = set_attributes(*args, true);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(*args, stream, &attr);
  err = args->s.rep_in_smem ? cudaLaunchKernelEx(&cfg, mesh_solve_kernel<true, true, true>, *args)
                            : cudaLaunchKernelEx(&cfg, mesh_solve_kernel<false, true, true>, *args);
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
