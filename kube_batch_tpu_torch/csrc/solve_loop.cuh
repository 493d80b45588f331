// The gang loop that kernels B1 (csrc/fused_solve.cu) and B4
// (csrc/mesh_solve.cu) share: queue and job selection, the task pop, the
// node sweep with its cluster arg-max, and the commit, over one launch's
// node axis held in shared memory, with the replicated job, queue and
// class state in every CTA (fused_solve.cu's header describes the design).
// The two kernels differ only in the exchange after the cluster arg-max:
// B1's cluster holds every node, so its best is the winner; B4 runs one
// cluster per card over that card's nodes and exchanges the cards'
// records through peer memory, once a placing iteration (solve_loop) or
// once a round of K speculated iterations (mesh_solve.cu's batched loop,
// built from the same parts below). Keeping the loop here keeps them from
// drifting: B4 must equal B1 bit for bit, over any grouping of the nodes
// into cards and at any K.
//
// Numerics: as node_sweep.cuh (-fmad=false, round-to-nearest intrinsics,
// __fdiv_rn).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "node_sweep.cuh"

#define NT 512  // threads per CTA: ops/cluster.py CTA_WIDTH
#define NWARPS (NT / 32)
static_assert(NT >= 96 && NT % 32 == 0, "the update uses threads 0, 32 and 64");

extern "C" {

// Mirror of ops/fused_solve.py::_Args (same field order).
struct SolveArgs {
  int T, N, J, Q, C, GT, R, max_iter, drf, proportion;
  // the cluster's geometry (solve_geometry): k CTAs, S nodes per CTA,
  // dynamic shared memory per CTA, words of replicated state per CTA, kept
  // in shared memory (1) or in the CTA's slice of `scratch` (0)
  int k, S, smem_bytes, rep_words, rep_in_smem;
  // int32 statics
  const int *tcls, *cgid, *chs, *crhs, *cho, *cpt, *cnode, *nmax, *nihs, *nrhs;
  const int *jstart, *jend, *jmin, *jprio, *jqueue, *qdim, *drfd;
  // float32 statics
  const float *creq, *cres, *affw, *nalloc, *qdes, *eps, *drft, *wts;
  // int32 state: scal = it, step, cur, paused, n_active
  int *scal, *tnode, *tkind, *tpos, *jptr, *jready, *jactive;
  int *ntasks, *nports, *qdropped, *qcount, *qahs;
  // float32 state
  float *idle, *rel, *used, *jalloc, *qalloc;
  // k x rep_words 32-bit words when rep_in_smem == 0
  int* scratch;
};

}  // extern "C"

// The replicated region of one CTA, in 32-bit words, in this order (the
// total is ops/fused_solve.py _rep_words): int jptr, jready, jactive,
// jend, jmin, jprio, jqueue [J]; qdropped, qcount, qahs [Q]; qdim [R, Q];
// cgid, chs, crhs, cho, cpt [C]; float jshare [J], jalloc [R, J]; qalloc,
// qdes [R, Q]; creq, cres [C, R8]; `end` is one past the region (the
// kernel checks it against SolveArgs.rep_words, and a CPU test parses this
// function against _rep_words). jshare is each job's drf share, kept
// up to date as jalloc changes (one job per assignment), so a job
// selection reads it instead of dividing for every job. A class's R8
// request (and resource) values lie in a row, 0 past R, so the pop reads
// them without a test per dim.
struct Rep {
  int *jptr, *jready, *jactive, *jend, *jmin, *jprio, *jqueue;
  int *qdropped, *qcount, *qahs, *qdim;
  int *cgid, *chs, *crhs, *cho, *cpt;
  float *jshare, *jalloc, *qalloc, *qdes, *creq, *cres;
  int* end;
};

__device__ __forceinline__ Rep rep_layout(int* w, int J, int Q, int C, int R) {
  Rep p;
  p.jptr = w; w += J;
  p.jready = w; w += J;
  p.jactive = w; w += J;
  p.jend = w; w += J;
  p.jmin = w; w += J;
  p.jprio = w; w += J;
  p.jqueue = w; w += J;
  p.qdropped = w; w += Q;
  p.qcount = w; w += Q;
  p.qahs = w; w += Q;
  p.qdim = w; w += R * Q;
  p.cgid = w; w += C;
  p.chs = w; w += C;
  p.crhs = w; w += C;
  p.cho = w; w += C;
  p.cpt = w; w += C;
  float* f = reinterpret_cast<float*>(w);
  p.jshare = f; f += J;
  p.jalloc = f; f += R * J;
  p.qalloc = f; f += R * Q;
  p.qdes = f; f += R * Q;
  p.creq = f; f += C * R8;
  p.cres = f; f += C * R8;
  p.end = reinterpret_cast<int*>(f);
  return p;
}

template <typename T>
__device__ __forceinline__ void copy_words(T* dst, const T* src, int n) {
  for (int i = threadIdx.x; i < n; i += NT) dst[i] = src[i];
}

// share(alloc, denom): 0/0 -> 0, x/0 -> 1 (helpers.go:43-60).
__device__ __forceinline__ float share_of(float alloc, float denom) {
  if (denom == 0.0f) return alloc != 0.0f ? 1.0f : 0.0f;
  return __fdiv_rn(alloc, denom);
}

// Job j's drf share: the largest share of its allocation over the drf
// dims, at least 0.
__device__ __forceinline__ float drf_share(const SolveArgs& a, const float* jalloc, int j) {
  float s = -INFINITY;
  for (int r = 0; r < a.R; ++r)
    if (a.drfd[r] != 0) s = fmaxf(s, share_of(jalloc[r * a.J + j], a.drft[r]));
  return fmaxf(s, 0.0f);
}

// Lexicographic key for the queue and job arg-mins: (k0, k1, share, idx),
// idx == NONE for "no element". Every valid idx is distinct, so the order
// is total and the lowest index wins ties on the other keys.
struct Key {
  int k0, k1;
  float share;
  int idx;
};

__device__ __forceinline__ bool key_less(const Key& a, const Key& b) {
  if (a.idx == NONE) return false;
  if (b.idx == NONE) return true;
  if (a.k0 != b.k0) return a.k0 < b.k0;
  if (a.k1 != b.k1) return a.k1 < b.k1;
  if (a.share != b.share) return a.share < b.share;
  return a.idx < b.idx;
}

// Warp arg-min in key_less's order, returned to every lane: one warp
// reduction (redux.sync) per key, each over the lanes that tie on the keys
// before it. A share is never negative, so its bits order as unsigned
// (-0.0 taken as +0.0: they tie).
__device__ __forceinline__ Key warp_min_key(const Key& k) {
  const unsigned full = 0xffffffffu;
  const unsigned share = k.share == 0.0f ? 0u : __float_as_uint(k.share);
  bool tie = k.idx != NONE;
  const int k0 = __reduce_min_sync(full, tie ? k.k0 : INT_MAX);
  tie = tie && k.k0 == k0;
  const int k1 = __reduce_min_sync(full, tie ? k.k1 : INT_MAX);
  tie = tie && k.k1 == k1;
  const unsigned sh = __reduce_min_sync(full, tie ? share : UINT_MAX);
  tie = tie && share == sh;
  const unsigned idx = __reduce_min_sync(full, tie ? (unsigned)k.idx : (unsigned)NONE);
  return Key{k0, k1, __uint_as_float(sh), (int)idx};
}

// Block-wide arg-min, returned to every thread, with one __syncthreads:
// each warp's minimum goes to scratch[phase & 1], then every warp reduces
// the NWARPS records itself. A reduction writes scratch[p & 1] only after the
// barrier of reduction p - 1, which each thread passes only after reading
// scratch[p & 1] in reduction p - 2.
__device__ __forceinline__ Key block_min_key(Key k, Key (*scratch)[NWARPS], unsigned phase) {
  k = warp_min_key(k);
  Key* buf = scratch[phase & 1];
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = k;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  return warp_min_key(lane < NWARPS ? buf[lane] : Key{0, 0, 0.0f, NONE});
}

// What one placing iteration's exchange leaves: the winning node as the
// replicated state records it (NONE: no candidate on any card), its index
// on this launch's node axis when this launch owns it (else NONE), and its
// fits-idle bit, from its owner.
struct Won {
  int idx, local, fits;
};

// The loop is built from four parts, the reference's closures (the JAX mesh
// program's prefix, block step and commit): select_job, pop_task, sweep and
// commit. solve_loop runs them in order with one exchange a placing
// iteration (B1, and B4 at K = 1); mesh_solve.cu's K-deep batched loop runs
// the same parts speculated on a saved state and replayed from the cards'
// records, so every kernel shares one selection and one commit.

// One CTA's slice of the launch's node axis in shared memory: nodes
// [lo, lo + n) of the axis, its [R, S] rows.
struct Slice {
  float *idle, *rel, *used;
  int *ntasks, *nports;
  int lo, n, S;
};

// The loop's scalars, the same in every thread: it, step, the current job,
// the active jobs, the paused task, and the current job's next task and
// ready count (mirrors of its rep.jptr and rep.jready entries).
struct Scalars {
  int it, step, cur, n_active, paused, tptr, ready;
};

// The loop's static shared memory: the arg-min and arg-max scratch, their
// phase counters, and a task's class loaded an iteration ahead.
struct LoopShared {
  Key key_scratch[2][NWARPS];
  Best best_scratch[2][32];
  Best slots[2][MAX_CLUSTER];
};

struct Phases {
  unsigned best, key;
  int pf_t, pf_cls;  // a task and its class, loaded an iteration ahead
};

// What pop_task found: the task, its class, whether the job's tasks are
// exhausted (drop), whether the task is host-only (pause), and whether it
// is placed (proc).
struct Pop {
  int t, cls;
  bool drop, pause, proc;
};

__device__ __forceinline__ bool loop_cond(const SolveArgs& a, const Scalars& L) {
  return (L.cur >= 0 || L.n_active > 0) && L.it < a.max_iter && L.paused < 0;
}

// What select_job calls before an overused queue's drop writes anything,
// in every thread alike: whether the drop goes ahead. Always, in B1 and at
// K = 1; mesh_solve.cu's speculation saves the runs the drop retires, and
// refuses a second drop in one chain (select_job then writes nothing).
struct NoDropHook {
  __device__ __forceinline__ bool operator()() const { return true; }
};

// Queue and job selection, when no job is current.
template <class OnDrop = NoDropHook>
__device__ __forceinline__ void select_job(const SolveArgs& a, const Rep& rep, Scalars& L, LoopShared& sh,
                                           Phases& ph, OnDrop on_drop = OnDrop()) {
  if (L.cur >= 0) return;
  const int tid = threadIdx.x, J = a.J, Q = a.Q, R = a.R;
  __syncthreads();  // the updates of earlier iterations are visible
  // -- queue: lex arg-min of (proportion share, rank) over live queues,
  // by every warp on its own (lanes stride over the queues): no barrier
  Key kq = {0, 0, 0.0f, NONE};
  for (int q = tid & 31; q < Q; q += 32) {
    if (rep.qcount[q] <= 0 || rep.qdropped[q] != 0) continue;
    Key k = {0, 0, 0.0f, q};
    if (a.proportion) {
      float s = -INFINITY;
      for (int r = 0; r < R; ++r)
        if (rep.qdim[r * Q + q] != 0) s = fmaxf(s, share_of(rep.qalloc[r * Q + q], rep.qdes[r * Q + q]));
      k.share = fmaxf(s, 0.0f);
    }
    if (key_less(k, kq)) kq = k;
  }
  kq = warp_min_key(kq);
  const bool q_any = kq.idx != NONE;
  const int qsel = q_any ? kq.idx : 0;

  // -- overused gate: deserved <= allocated with the Go nil-scalar-map
  // branch (proportion.go:188-199), same verdict in every thread
  bool overused = false;
  if (a.proportion && q_any) {
    overused = true;
    const bool has_sc = rep.qahs[qsel] != 0;
    for (int r = 0; r < R; ++r) {
      if (rep.qdim[r * Q + qsel] == 0) continue;
      const float d = rep.qdes[r * Q + qsel], al = rep.qalloc[r * Q + qsel];
      bool ok = (d < al) || (fabsf(__fsub_rn(al, d)) < a.eps[r]);
      if (r >= 2) ok = ok && has_sc;
      overused = overused && ok;
    }
  }

  if (q_any && overused) {
    // the overused queue retires all its jobs for the cycle
    if (!on_drop()) return;
    for (int j = tid; j < J; j += NT)
      if (rep.jqueue[j] == qsel) rep.jactive[j] = 0;
    L.n_active -= rep.qcount[qsel];
    __syncthreads();  // every thread has read qcount[qsel]
    if (tid == 0) {
      rep.qdropped[qsel] = 1;
      rep.qcount[qsel] = 0;
    }
  } else if (q_any) {
    // -- job: lex arg-min of (-priority, gang-ready, drf share, rank)
    Key kj = {0, 0, 0.0f, NONE};
#pragma unroll 4
    for (int j = tid; j < J; j += NT) {
      if (rep.jactive[j] == 0 || rep.jqueue[j] != qsel) continue;
      Key k = {-rep.jprio[j], rep.jready[j] >= rep.jmin[j] ? 1 : 0, 0.0f, j};
      if (a.drf) k.share = rep.jshare[j];
      if (key_less(k, kj)) kj = k;
    }
    kj = block_min_key(kj, sh.key_scratch, ph.key++);
    if (kj.idx != NONE) {
      L.cur = kj.idx;
      L.tptr = rep.jptr[L.cur];
      L.ready = rep.jready[L.cur];
    }
  }
}

// Pop the current job's next pending task (every thread, O(1)).
__device__ __forceinline__ Pop pop_task(const SolveArgs& a, const Rep& rep, const Scalars& L, Phases& ph) {
  int t = 0;
  bool t_any = false;
  if (L.cur >= 0) {
    t = L.tptr;
    t_any = t < rep.jend[L.cur];
  }
  t = min(t, a.T - 1);
  const int cls = t == ph.pf_t ? ph.pf_cls : __ldg(a.tcls + t);
  ph.pf_t = min(t + 1, a.T - 1);  // the job's next task: its class load overlaps this iteration
  ph.pf_cls = __ldg(a.tcls + ph.pf_t);
  const bool pause = t_any && rep.cho[cls] != 0;
  return Pop{t, cls, L.cur >= 0 && !t_any, pause, t_any && !pause};
}

// The popped task's view: its class's rows, flags and ports.
__device__ __forceinline__ void load_task(TaskView& task, const Rep& rep, int cls, const float* eps) {
#pragma unroll
  for (int r = 0; r < R8; ++r) {
    task.req[r] = rep.creq[cls * R8 + r];
    task.res[r] = rep.cres[cls * R8 + r];
    task.eps[r] = eps[r];
  }
  task.has_sc = rep.chs[cls] != 0;
  task.tports = rep.cpt[cls];
}

// Feasibility + score over the CTA's slice, then the cluster arg-max: this
// launch's best node for the task (index on the launch's node axis).
__device__ __forceinline__ Best sweep(const SolveArgs& a, const Rep& rep, const Slice& sl, const TaskView& task,
                                      int cls, LoopShared& sh, Phases& ph) {
  const int N = a.N, lo = sl.lo;
  const int gid = rep.cgid[cls];
  const NodeAxis nodes = {N,         sl.S,      a.cnode + (size_t)gid * N + lo,
                          a.nmax + lo, a.nihs + lo, a.nrhs + lo,
                          sl.ntasks, sl.nports, a.affw + (size_t)gid * N + lo,
                          a.nalloc + lo, sl.idle, sl.rel,
                          sl.used};
  return cluster_max_best(thread_best(nodes, sl.n, lo, task), sh.best_scratch, sh.slots, ph.best++);
}

// The multi-key sweep's task rows a chunk (mesh_solve.cu's round-start
// records): at most KEY_CHUNK keys a cluster barrier, one warp a key for
// the CTA's reduction.
#define KEY_CHUNK 8
static_assert(KEY_CHUNK <= NWARPS, "a warp reduces each key of a chunk");
#define TASK_WORDS 32  // shared words kept for each staged TaskView
static_assert(sizeof(TaskView) <= 4 * TASK_WORDS, "KEY_CHUNK TaskViews fit their staged rows");

// The best node of this launch's slice, over the whole cluster, for each of
// nk task classes `cls` (every CTA passes the same list), into out[0, nk)
// of CTA 0: one sweep that reads each node of the CTA's slice once and
// scores it for up to KEY_CHUNK classes (thread_best_keys), a warp
// reduction of each class's (score, index) pairs, one warp a class for the
// CTA's, then every CTA's bests into CTA 0's `slots` through distributed
// shared memory behind one cluster barrier, and CTA 0 reduces them; past
// KEY_CHUNK classes, one such pass a chunk. The arithmetic and the order
// are sweep()'s, so each result is the single-class sweep's bit for bit.
// Shared scratch: `tasks` [KEY_CHUNK][TASK_WORDS], `group` [KEY_CHUNK],
// `warps` [KEY_CHUNK][NWARPS], `slots` [2][KEY_CHUNK][MAX_CLUSTER] (a
// chunk writes slots[chunk & 1] only after the barrier of the chunk before,
// which CTA 0 passes only after reading the chunk before that). The
// caller orders `out` for CTA 0's readers (a __syncthreads) and the
// slice's state before the call.
__device__ __forceinline__ void sweep_keys(const SolveArgs& a, const Rep& rep, const Slice& sl, const int* cls, int nk,
                                           const float* eps, float w_least, float w_bal, int* tasks_words,
                                           int* group, Best* warps, Best* slots, Best* out) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, N = a.N, lo = sl.lo;
  TaskView* tasks = reinterpret_cast<TaskView*>(tasks_words);
  const Best none = {-INFINITY, NONE, 0, 0};
  for (int base = 0, chunk = 0; base < nk; base += KEY_CHUNK, ++chunk) {
    const int n = min(KEY_CHUNK, nk - base);
    if (tid < n) {
      TaskView t;
      t.R = a.R;
      t.w_least = w_least;
      t.w_bal = w_bal;
      load_task(t, rep, cls[base + tid], eps);
      tasks[tid] = t;
      group[tid] = rep.cgid[cls[base + tid]];
    }
    __syncthreads();
    const int g0 = group[0];
    const NodeAxis nodes = {N,         sl.S,      a.cnode + (size_t)g0 * N + lo,
                            a.nmax + lo, a.nihs + lo, a.nrhs + lo,
                            sl.ntasks, sl.nports, a.affw + (size_t)g0 * N + lo,
                            a.nalloc + lo, sl.idle, sl.rel,
                            sl.used};
    Best best[KEY_CHUNK];
    thread_best_keys<KEY_CHUNK>(nodes, a.cnode + lo, a.affw + lo, sl.n, lo, tasks, group, n, best);
#pragma unroll
    for (int j = 0; j < KEY_CHUNK; ++j) {
      if (j >= n) break;
      const Best b = warp_max_best(best[j]);
      if (lane == 0) warps[j * NWARPS + warp] = b;
    }
    __syncthreads();
    Best* slot = slots + (chunk & 1) * KEY_CHUNK * MAX_CLUSTER;
    if (warp < n) {
      const Best b = warp_max_best(lane < NWARPS ? warps[warp * NWARPS + lane] : none);
      if (lane == 0) {
        if (k == 1)
          out[base + warp] = b;
        else
          *cluster.map_shared_rank(&slot[warp * MAX_CLUSTER + rank], 0) = b;
      }
    }
    if (k > 1) {
      cluster_arrive_release();
      cluster_wait();
      if (rank == 0 && warp < n) {
        const Best b = warp_max_best(lane < k ? slot[warp * MAX_CLUSTER + lane] : none);
        if (lane == 0) out[base + warp] = b;
      }
    }
  }
}

// Words of one entry of a speculation's node undo log (mesh_solve.cu): the
// node's slice index, pod count and port mask, then its idle, releasing and
// used rows (R8 each).
#define UNDO_WORDS (3 + 3 * R8)

// A speculation's journal of the replicated region (mesh_solve.cu's
// batched exchange): before commit writes a word of the region, the thread
// that writes it logs the word's old value, one entry an iteration and
// writer. Thread 0: the job, then its jptr, jready, jactive and its
// queue's qcount (LOG0_WORDS); thread 32: the job, its jshare and its
// jalloc column (LOG_ROW_WORDS); thread 64: the queue, its qahs and its
// qalloc column. The counts advance in every thread alike (the decisions
// are replicated), so every thread knows how far each log runs.
#define LOG0_WORDS 5
#define LOG_ROW_WORDS (2 + R8)

struct RegionLog {
  int *j0, *j32, *j64;
  int n0, n32, n64;
};

// The state update of one iteration: the winner's owner thread updates its
// node, three lanes the replicated vectors, every thread the scalars.
// `place`: this thread records the placement (CTA 0 of the primary launch,
// outside speculation). `undo`, when not null, is where the node's owner
// thread saves the node's old values before it changes them; `log`, when
// not null, the region journal the writers of the replicated words log
// their old values in first.
__device__ __forceinline__ void commit(const SolveArgs& a, const Rep& rep, const Slice& sl, Scalars& L, const Pop& p,
                                       const TaskView& task, const Won& won, bool place, int* undo,
                                       RegionLog* log = nullptr) {
  const int tid = threadIdx.x, R = a.R, J = a.J, Q = a.Q, S = sl.S;
  const int cur = L.cur;
  const bool assign = p.proc && won.idx != NONE;
  const bool abandon = p.proc && won.idx == NONE;  // serial `break`
  const bool fits_idle = assign && won.fits != 0;
  if (log != nullptr) {
    if (p.proc || p.drop) {  // a current job: its words may change
      if (tid == 0) {
        int* e = log->j0 + log->n0 * LOG0_WORDS;
        e[0] = cur;
        e[1] = rep.jptr[cur];
        e[2] = rep.jready[cur];
        e[3] = rep.jactive[cur];
        e[4] = rep.qcount[rep.jqueue[cur]];
      }
      log->n0 += 1;
    }
    if (assign && a.drf) {
      if (tid == 32) {
        int* e = log->j32 + log->n32 * LOG_ROW_WORDS;
        e[0] = cur;
        e[1] = __float_as_int(rep.jshare[cur]);
        for (int r = 0; r < R; ++r) e[2 + r] = __float_as_int(rep.jalloc[r * J + cur]);
      }
      log->n32 += 1;
    }
    if (assign && a.proportion) {
      if (tid == 64) {
        const int qc = rep.jqueue[cur];
        int* e = log->j64 + log->n64 * LOG_ROW_WORDS;
        e[0] = qc;
        e[1] = rep.qahs[qc];
        for (int r = 0; r < R; ++r) e[2 + r] = __float_as_int(rep.qalloc[r * Q + qc]);
      }
      log->n64 += 1;
    }
  }
  if (assign) {
    const int nb = won.idx, ln = won.local - sl.lo;
    if (won.local != NONE && ln >= 0 && ln < sl.n && ln % NT == tid) {  // this thread swept the winner
      if (undo != nullptr) {
        undo[0] = ln;
        undo[1] = sl.ntasks[ln];
        undo[2] = sl.nports[ln];
        float* u = reinterpret_cast<float*>(undo + 3);
#pragma unroll
        for (int r = 0; r < R8; ++r) {
          if (r >= R) break;
          u[r] = sl.idle[r * S + ln];
          u[R8 + r] = sl.rel[r * S + ln];
          u[2 * R8 + r] = sl.used[r * S + ln];
        }
      }
#pragma unroll
      for (int r = 0; r < R8; ++r) {
        if (r >= R) break;
        if (fits_idle)
          sl.idle[r * S + ln] = __fsub_rn(sl.idle[r * S + ln], task.res[r]);
        else  // the predicate guarantees a fit on releasing
          sl.rel[r * S + ln] = __fsub_rn(sl.rel[r * S + ln], task.res[r]);
        sl.used[r * S + ln] = __fadd_rn(sl.used[r * S + ln], task.res[r]);
      }
      sl.ntasks[ln] += 1;
      sl.nports[ln] |= task.tports;
    }
    // the replicated vectors, by one lane in each of three warps (they
    // touch disjoint arrays, so their chains of loads run side by side)
    if (tid == 0 && place) {
      a.tnode[p.t] = nb;
      a.tkind[p.t] = fits_idle ? 1 : 2;
      a.tpos[p.t] = L.step;
    }
    if (tid == 32 && a.drf) {
#pragma unroll
      for (int r = 0; r < R8; ++r)
        if (r < R) rep.jalloc[r * J + cur] = __fadd_rn(rep.jalloc[r * J + cur], task.res[r]);
      rep.jshare[cur] = drf_share(a, rep.jalloc, cur);
    }
    if (tid == 64 && a.proportion) {
      const int qc = rep.jqueue[cur];
#pragma unroll
      for (int r = 0; r < R8; ++r)
        if (r < R) rep.qalloc[r * Q + qc] = __fadd_rn(rep.qalloc[r * Q + qc], task.res[r]);
      if (rep.crhs[p.cls] != 0) rep.qahs[qc] = 1;
    }
  }
  if (fits_idle) L.ready += 1;
  if (p.proc) {
    L.tptr += 1;
    if (tid == 0) {
      rep.jptr[cur] = L.tptr;
      rep.jready[cur] = L.ready;
    }
  }
  int cur_next = cur;
  if (p.drop || abandon) {
    if (tid == 0) {
      rep.jactive[cur] = 0;
      rep.qcount[rep.jqueue[cur]] -= 1;
    }
    L.n_active -= 1;
    cur_next = -1;
  } else if (p.proc && L.ready >= rep.jmin[cur]) {
    cur_next = -1;  // gang barrier: the job re-queues
  }
  L.it += 1;
  L.step += assign ? 1 : 0;
  L.cur = cur_next;
  L.paused = p.pause ? p.t : -1;
}

// The start of a solve: the CTA's node slice into shared memory, its copy
// of the replicated state, the loop's scalars; returns the scalars, with
// the slice and the region in *sl and *rep. Ends with a cluster barrier
// (every CTA has started; DSMEM may be written).
template <bool kRepInSmem>
__device__ __forceinline__ Scalars solve_begin(const SolveArgs& a, Slice* sl, Rep* rep) {
  extern __shared__ __align__(16) int smem[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, rank = (int)cluster.block_rank();
  const int N = a.N, J = a.J, Q = a.Q, C = a.C, R = a.R, S = a.S;
  const int lo = rank * S, n_loc = max(0, min(S, N - lo));

  // -- the CTA's node slice, in shared memory ---------------------------
  float* s_idle = reinterpret_cast<float*>(smem);
  float* s_rel = s_idle + R * S;
  float* s_used = s_rel + R * S;
  int* s_ntasks = reinterpret_cast<int*>(s_used + R * S);
  int* s_nports = s_ntasks + S;
  for (int r = 0; r < R; ++r) {
    copy_words(s_idle + r * S, a.idle + r * N + lo, n_loc);
    copy_words(s_rel + r * S, a.rel + r * N + lo, n_loc);
    copy_words(s_used + r * S, a.used + r * N + lo, n_loc);
  }
  copy_words(s_ntasks, a.ntasks + lo, n_loc);
  copy_words(s_nports, a.nports + lo, n_loc);
  *sl = Slice{s_idle, s_rel, s_used, s_ntasks, s_nports, lo, n_loc, S};

  // -- the CTA's copy of the replicated state ---------------------------
  int* rep_base = kRepInSmem ? s_nports + S : a.scratch + (size_t)rank * a.rep_words;
  const Rep p = rep_layout(rep_base, J, Q, C, R);
  // the layout's extent against the sizes the launch was given
  // (solve_geometry): a mismatch would overrun shared memory or the
  // scratch slice, so it stops the kernel instead
  if (p.end - rep_base != a.rep_words ||
      (s_nports + S - smem) + (kRepInSmem ? a.rep_words : 0) != a.smem_bytes / 4)
    __trap();
  copy_words(p.jptr, a.jptr, J);
  copy_words(p.jready, a.jready, J);
  copy_words(p.jactive, a.jactive, J);
  copy_words(p.jend, a.jend, J);
  copy_words(p.jmin, a.jmin, J);
  copy_words(p.jprio, a.jprio, J);
  copy_words(p.jqueue, a.jqueue, J);
  copy_words(p.qdropped, a.qdropped, Q);
  copy_words(p.qcount, a.qcount, Q);
  copy_words(p.qahs, a.qahs, Q);
  copy_words(p.qdim, a.qdim, R * Q);
  copy_words(p.cgid, a.cgid, C);
  copy_words(p.chs, a.chs, C);
  copy_words(p.crhs, a.crhs, C);
  copy_words(p.cho, a.cho, C);
  copy_words(p.cpt, a.cpt, C);
  copy_words(p.jalloc, a.jalloc, R * J);
  if (a.drf)
    for (int j = tid; j < J; j += NT) p.jshare[j] = drf_share(a, a.jalloc, j);
  copy_words(p.qalloc, a.qalloc, R * Q);
  copy_words(p.qdes, a.qdes, R * Q);
  for (int i = tid; i < C * R8; i += NT) {
    const int c = i / R8, r = i % R8;
    p.creq[i] = r < R ? a.creq[r * C + c] : 0.0f;
    p.cres[i] = r < R ? a.cres[r * C + c] : 0.0f;
  }
  *rep = p;

  // the loop's scalars, in every thread's registers
  Scalars L = {a.scal[0], a.scal[1], a.scal[2], a.scal[4], -1, 0, 0};
  cluster.sync();  // copies visible; every CTA has started (DSMEM may be written)
  L.tptr = L.cur >= 0 ? p.jptr[L.cur] : 0;
  L.ready = L.cur >= 0 ? p.jready[L.cur] : 0;
  return L;
}

// The end of a solve: each CTA writes its node slice back, CTA 0 of the
// primary launch the replicated state and the scalars.
__device__ __forceinline__ void solve_end(const SolveArgs& a, const Slice& sl, const Rep& rep, const Scalars& L,
                                          int rank, bool primary) {
  const int tid = threadIdx.x, N = a.N, J = a.J, Q = a.Q, R = a.R, S = sl.S, lo = sl.lo;
  __syncthreads();
  for (int r = 0; r < R; ++r) {
    copy_words(a.idle + r * N + lo, sl.idle + r * S, sl.n);
    copy_words(a.rel + r * N + lo, sl.rel + r * S, sl.n);
    copy_words(a.used + r * N + lo, sl.used + r * S, sl.n);
  }
  copy_words(a.ntasks + lo, sl.ntasks, sl.n);
  copy_words(a.nports + lo, sl.nports, sl.n);
  if (rank == 0 && primary) {
    copy_words(a.jptr, rep.jptr, J);
    copy_words(a.jready, rep.jready, J);
    copy_words(a.jactive, rep.jactive, J);
    copy_words(a.qdropped, rep.qdropped, Q);
    copy_words(a.qcount, rep.qcount, Q);
    copy_words(a.qahs, rep.qahs, Q);
    copy_words(a.jalloc, rep.jalloc, R * J);
    copy_words(a.qalloc, rep.qalloc, R * Q);
    if (tid == 0) {
      a.scal[0] = L.it;
      a.scal[1] = L.step;
      a.scal[2] = L.cur;
      a.scal[3] = L.paused;
      a.scal[4] = L.n_active;
    }
  }
}

// The whole gang loop over one launch's node axis, every CTA of the
// cluster running it, one exchange a placing iteration. `x` is the
// exchange between launches: after each placing iteration's cluster
// arg-max, x.exchange(best, &won) turns this cluster's best into the
// winner over every launch of the solve (B1's OneCard: its own best; B4's
// MeshExchange: every card's, through peer memory) and returns false when
// the solve must end (a peer never answered). Only the launch with
// x.primary() records the placements and writes the replicated state back;
// x.finish(a, rank) writes the exchange's own words at exit. Nothing in the
// loop depends on the cluster's size k or on a CTA's rank except which
// nodes it sweeps and which CTA writes back, so launches of different k
// replicate the same decisions bit for bit.
//
// kRepInSmem: the replicated state lies in shared memory (a.rep_in_smem),
// so its accesses compile to shared-memory loads and stores rather than
// generic ones.
template <bool kRepInSmem, class Exchange>
__device__ __forceinline__ void solve_loop(const SolveArgs& a, Exchange& x) {
  __shared__ LoopShared sh;
  namespace cg = cooperative_groups;
  const int rank = (int)cg::this_cluster().block_rank();
  float eps[R8];  // the per-dim tolerances, in registers for the whole solve
#pragma unroll
  for (int r = 0; r < R8; ++r) eps[r] = r < a.R ? a.eps[r] : 0.0f;
  Slice sl;
  Rep rep;
  Scalars L = solve_begin<kRepInSmem>(a, &sl, &rep);
  Phases ph = {0, 0, -1, 0};
  const bool place = rank == 0 && x.primary();
  const float w_least = a.wts[0], w_bal = a.wts[1];

  while (loop_cond(a, L)) {
    select_job(a, rep, L, sh, ph);
    const Pop p = pop_task(a, rep, L, ph);
    Won won = {NONE, NONE, 0};
    TaskView task;
    task.R = a.R;
    task.has_sc = false;
    task.tports = 0;
    task.w_least = w_least;
    task.w_bal = w_bal;
    if (p.proc) {
      load_task(task, rep, p.cls, eps);
      const Best best = sweep(a, rep, sl, task, p.cls, sh, ph);
      // the winner over every card (B1: this cluster's); false: a peer's
      // record never came, the launch ends with its error word set
      if (!x.exchange(best, &won)) break;
    }
    commit(a, rep, sl, L, p, task, won, place, nullptr);
  }
  solve_end(a, sl, rep, L, rank, x.primary());
  x.finish(a, rank);
}
