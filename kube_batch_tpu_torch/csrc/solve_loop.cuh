// The gang loop that kernels B1 (csrc/fused_solve.cu) and B4
// (csrc/mesh_solve.cu) share: queue and job selection, the task pop, the
// node sweep with its cluster arg-max, and the commit, over one launch's
// node axis held in shared memory, with the replicated job, queue and
// class state in every CTA (fused_solve.cu's header describes the design).
// The two kernels differ only in the exchange after the cluster arg-max:
// B1's cluster holds every node, so its best is the winner; B4 runs one
// cluster per card over that card's nodes and exchanges the cards'
// records through peer memory. Keeping the loop here keeps them from
// drifting: B4 must equal B1 bit for bit, over any grouping of the nodes
// into cards.
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

// The whole gang loop over one launch's node axis, every CTA of the
// cluster running it. `x` is the exchange between launches: after each
// placing iteration's cluster arg-max, x.exchange(best, &won) turns this
// cluster's best into the winner over every launch of the solve (B1's
// OneCard: its own best; B4's MeshExchange: every card's, through peer
// memory) and returns false when the solve must end (a peer never
// answered). Only the launch with x.primary() records the placements and
// writes the replicated state back; x.finish(a, rank) writes the
// exchange's own words at exit. Nothing in the loop depends on the
// cluster's size k or on a CTA's rank except which nodes it sweeps and
// which CTA writes back, so launches of different k replicate the same
// decisions bit for bit.
//
// kRepInSmem: the replicated state lies in shared memory (a.rep_in_smem),
// so its accesses compile to shared-memory loads and stores rather than
// generic ones.
template <bool kRepInSmem, class Exchange>
__device__ __forceinline__ void solve_loop(const SolveArgs& a, Exchange& x) {
  __shared__ Key key_scratch[2][NWARPS];
  __shared__ Best best_scratch[2][32];
  __shared__ Best slots[2][MAX_CLUSTER];
  extern __shared__ __align__(16) int smem[];

  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, rank = (int)cluster.block_rank();
  const int T = a.T, N = a.N, J = a.J, Q = a.Q, C = a.C, R = a.R, S = a.S;
  const int lo = rank * S, n_loc = max(0, min(S, N - lo));
  const float w_least = a.wts[0], w_bal = a.wts[1];
  float eps[R8];  // the per-dim tolerances, in registers for the whole solve
#pragma unroll
  for (int r = 0; r < R8; ++r) eps[r] = r < R ? a.eps[r] : 0.0f;

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

  // -- the CTA's copy of the replicated state ---------------------------
  int* rep_base = kRepInSmem ? s_nports + S : a.scratch + (size_t)rank * a.rep_words;
  const Rep rep = rep_layout(rep_base, J, Q, C, R);
  // the layout's extent against the sizes the launch was given
  // (solve_geometry): a mismatch would overrun shared memory or the
  // scratch slice, so it stops the kernel instead
  if (rep.end - rep_base != a.rep_words ||
      (s_nports + S - smem) + (kRepInSmem ? a.rep_words : 0) != a.smem_bytes / 4)
    __trap();
  copy_words(rep.jptr, a.jptr, J);
  copy_words(rep.jready, a.jready, J);
  copy_words(rep.jactive, a.jactive, J);
  copy_words(rep.jend, a.jend, J);
  copy_words(rep.jmin, a.jmin, J);
  copy_words(rep.jprio, a.jprio, J);
  copy_words(rep.jqueue, a.jqueue, J);
  copy_words(rep.qdropped, a.qdropped, Q);
  copy_words(rep.qcount, a.qcount, Q);
  copy_words(rep.qahs, a.qahs, Q);
  copy_words(rep.qdim, a.qdim, R * Q);
  copy_words(rep.cgid, a.cgid, C);
  copy_words(rep.chs, a.chs, C);
  copy_words(rep.crhs, a.crhs, C);
  copy_words(rep.cho, a.cho, C);
  copy_words(rep.cpt, a.cpt, C);
  copy_words(rep.jalloc, a.jalloc, R * J);
  if (a.drf)
    for (int j = tid; j < J; j += NT) rep.jshare[j] = drf_share(a, a.jalloc, j);
  copy_words(rep.qalloc, a.qalloc, R * Q);
  copy_words(rep.qdes, a.qdes, R * Q);
  for (int i = tid; i < C * R8; i += NT) {
    const int c = i / R8, r = i % R8;
    rep.creq[i] = r < R ? a.creq[r * C + c] : 0.0f;
    rep.cres[i] = r < R ? a.cres[r * C + c] : 0.0f;
  }

  // the loop's scalars, in every thread's registers
  int it = a.scal[0], step = a.scal[1], cur = a.scal[2], n_active = a.scal[4], paused = -1;
  cluster.sync();  // copies visible; every CTA has started (DSMEM may be written)
  int tptr = cur >= 0 ? rep.jptr[cur] : 0, ready = cur >= 0 ? rep.jready[cur] : 0;
  unsigned best_phase = 0, key_phase = 0;
  int pf_t = -1, pf_cls = 0;  // a task and its class, loaded an iteration ahead

  while ((cur >= 0 || n_active > 0) && it < a.max_iter && paused < 0) {
    if (cur < 0) {
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
        for (int j = tid; j < J; j += NT)
          if (rep.jqueue[j] == qsel) rep.jactive[j] = 0;
        n_active -= rep.qcount[qsel];
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
        kj = block_min_key(kj, key_scratch, key_phase++);
        if (kj.idx != NONE) {
          cur = kj.idx;
          tptr = rep.jptr[cur];
          ready = rep.jready[cur];
        }
      }
    }

    // -- pop the current job's next pending task (every thread, O(1)) ----
    int t = 0;
    bool t_any = false;
    if (cur >= 0) {
      t = tptr;
      t_any = t < rep.jend[cur];
    }
    t = min(t, T - 1);
    const bool drop = cur >= 0 && !t_any;
    const int cls = t == pf_t ? pf_cls : __ldg(a.tcls + t);
    pf_t = min(t + 1, T - 1);  // the job's next task: its class load overlaps this iteration
    pf_cls = __ldg(a.tcls + pf_t);
    const bool pause = t_any && rep.cho[cls] != 0;
    const bool proc = t_any && !pause;

    Best best = {-INFINITY, NONE, 0, 0};
    Won won = {NONE, NONE, 0};
    TaskView task;
    task.R = R;
    task.has_sc = false;
    task.tports = 0;
    task.w_least = w_least;
    task.w_bal = w_bal;
    if (proc) {
#pragma unroll
      for (int r = 0; r < R8; ++r) {
        task.req[r] = rep.creq[cls * R8 + r];
        task.res[r] = rep.cres[cls * R8 + r];
        task.eps[r] = eps[r];
      }
      task.has_sc = rep.chs[cls] != 0;
      task.tports = rep.cpt[cls];
      const int gid = rep.cgid[cls];
      // -- feasibility + score over the slice, cluster arg-max -----------
      const NodeAxis nodes = {N,        S,         a.cnode + (size_t)gid * N + lo,
                              a.nmax + lo, a.nihs + lo, a.nrhs + lo,
                              s_ntasks, s_nports, a.affw + (size_t)gid * N + lo,
                              a.nalloc + lo, s_idle, s_rel,
                              s_used};
      best = cluster_max_best(thread_best(nodes, n_loc, lo, task), best_scratch, slots, best_phase++);
      // the winner over every card (B1: this cluster's); false: a peer's
      // record never came, the launch ends with its error word set
      if (!x.exchange(best, &won)) break;
    }

    // -- state update: the winner's owner thread, three lanes, registers --
    const bool assign = proc && won.idx != NONE;
    const bool abandon = proc && won.idx == NONE;  // serial `break`
    const bool fits_idle = assign && won.fits != 0;
    if (assign) {
      const int nb = won.idx, ln = won.local - lo;
      if (won.local != NONE && ln >= 0 && ln < n_loc && ln % NT == tid) {  // this thread swept the winner
#pragma unroll
        for (int r = 0; r < R8; ++r) {
          if (r >= R) break;
          if (fits_idle)
            s_idle[r * S + ln] = __fsub_rn(s_idle[r * S + ln], task.res[r]);
          else  // the predicate guarantees a fit on releasing
            s_rel[r * S + ln] = __fsub_rn(s_rel[r * S + ln], task.res[r]);
          s_used[r * S + ln] = __fadd_rn(s_used[r * S + ln], task.res[r]);
        }
        s_ntasks[ln] += 1;
        s_nports[ln] |= task.tports;
      }
      // the replicated vectors, by one lane in each of three warps (they
      // touch disjoint arrays, so their chains of loads run side by side)
      if (tid == 0 && rank == 0 && x.primary()) {
        a.tnode[t] = nb;
        a.tkind[t] = fits_idle ? 1 : 2;
        a.tpos[t] = step;
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
        if (rep.crhs[cls] != 0) rep.qahs[qc] = 1;
      }
    }
    if (fits_idle) ready += 1;
    if (proc) {
      tptr += 1;
      if (tid == 0) {
        rep.jptr[cur] = tptr;
        rep.jready[cur] = ready;
      }
    }
    int cur_next = cur;
    if (drop || abandon) {
      if (tid == 0) {
        rep.jactive[cur] = 0;
        rep.qcount[rep.jqueue[cur]] -= 1;
      }
      n_active -= 1;
      cur_next = -1;
    } else if (proc && ready >= rep.jmin[cur]) {
      cur_next = -1;  // gang barrier: the job re-queues
    }
    it += 1;
    step += assign ? 1 : 0;
    cur = cur_next;
    paused = pause ? t : -1;
  }

  // -- write the state back: each CTA its node slice, CTA 0 the rest ----
  __syncthreads();
  for (int r = 0; r < R; ++r) {
    copy_words(a.idle + r * N + lo, s_idle + r * S, n_loc);
    copy_words(a.rel + r * N + lo, s_rel + r * S, n_loc);
    copy_words(a.used + r * N + lo, s_used + r * S, n_loc);
  }
  copy_words(a.ntasks + lo, s_ntasks, n_loc);
  copy_words(a.nports + lo, s_nports, n_loc);
  if (rank == 0 && x.primary()) {
    copy_words(a.jptr, rep.jptr, J);
    copy_words(a.jready, rep.jready, J);
    copy_words(a.jactive, rep.jactive, J);
    copy_words(a.qdropped, rep.qdropped, Q);
    copy_words(a.qcount, rep.qcount, Q);
    copy_words(a.qahs, rep.qahs, Q);
    copy_words(a.jalloc, rep.jalloc, R * J);
    copy_words(a.qalloc, rep.qalloc, R * Q);
    if (tid == 0) {
      a.scal[0] = it;
      a.scal[1] = step;
      a.scal[2] = cur;
      a.scal[3] = paused;
      a.scal[4] = n_active;
    }
  }
  x.finish(a, rank);
}
