// The whole gang-aware allocate solve in one launch, for Hopper (sm_90a).
//
// Replaces kube_batch_tpu/ops/pallas_solve.py::_build (the fused Pallas
// TPU kernel). Spec: kube_batch_tpu_torch/ops/kernels.py
// solve_allocate_step; plain version: ops/fused_solve.py
// fused_solve_plain, which runs that loop over the same packed buffers.
//
// What bounds it: the solve is a chain of up to T+J+Q+1 dependent
// iterations (each assignment changes the node state the next decision
// reads), and each iteration touches only the node axis (a few bytes per
// node and resource dim) plus, when no job is current, the job and queue
// vectors. At the headline size that is about 2 MB of state, which stays
// in the 50 MB L2, so an iteration costs a node sweep from L2 plus a
// handful of block barriers — latency, not bandwidth or arithmetic.
//
// What the design does about it: one persistent thread block of 1024
// threads runs every iteration, so there is no launch or host round trip
// per iteration. Each iteration is
//   1. (only when no job is current) queue and job selection as block-wide
//      lexicographic arg-min reductions, plus the overused-queue drop;
//   2. the task pop, computed redundantly by every thread (O(1) reads);
//   3. the node sweep: feasibility and score for a strided slice of nodes
//      per thread, then a block-wide arg-max (lowest index on ties);
//   4. the scalar state update by thread 0, then a barrier.
// Spreading the node axis over several blocks (a cluster with distributed
// shared memory, or a cooperative grid) is later work.
//
// Numerics: built with -fmad=false and without fast math; the score
// arithmetic also uses the explicit round-to-nearest intrinsics, so every
// float32 operation rounds exactly as the plain version's does. Division
// is __fdiv_rn (correctly rounded). Float comparisons, not bit patterns,
// pick the arg-max, so -0.0 and +0.0 tie and the lower index wins. The
// node sweep (feasibility, score, arg-max, fits-idle) lives in
// node_sweep.cuh, shared with the sharded block step (block_step.cu).

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "node_sweep.cuh"

#define NT 1024
#define NWARPS (NT / 32)

extern "C" {

// Mirror of ops/fused_solve.py::_Args (same field order).
struct SolveArgs {
  int T, N, J, Q, C, GT, R, max_iter, drf, proportion;
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
};

}  // extern "C"

// share(alloc, denom): 0/0 -> 0, x/0 -> 1 (helpers.go:43-60).
__device__ __forceinline__ float share_of(float alloc, float denom) {
  if (denom == 0.0f) return alloc != 0.0f ? 1.0f : 0.0f;
  return __fdiv_rn(alloc, denom);
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

__device__ Key block_min_key(Key k, Key* scratch) {
  const unsigned full = 0xffffffffu;
  for (int off = 16; off > 0; off >>= 1) {
    Key o;
    o.k0 = __shfl_down_sync(full, k.k0, off);
    o.k1 = __shfl_down_sync(full, k.k1, off);
    o.share = __shfl_down_sync(full, k.share, off);
    o.idx = __shfl_down_sync(full, k.idx, off);
    if (key_less(o, k)) k = o;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = k;
  __syncthreads();
  if (warp == 0) {
    k = scratch[lane];
    for (int off = 16; off > 0; off >>= 1) {
      Key o;
      o.k0 = __shfl_down_sync(full, k.k0, off);
      o.k1 = __shfl_down_sync(full, k.k1, off);
      o.share = __shfl_down_sync(full, k.share, off);
      o.idx = __shfl_down_sync(full, k.idx, off);
      if (key_less(o, k)) k = o;
    }
    if (lane == 0) scratch[NWARPS] = k;
  }
  __syncthreads();
  Key out = scratch[NWARPS];
  __syncthreads();  // scratch is free for the next reduction
  return out;
}

__global__ void __launch_bounds__(NT, 1) fused_solve_kernel(const SolveArgs a) {
  __shared__ Key key_scratch[NWARPS + 1];
  __shared__ Best best_scratch[NWARPS + 1];
  __shared__ int ctl[5];  // it, step, cur, paused, n_active (thread 0 writes)

  const int tid = threadIdx.x;
  const int T = a.T, N = a.N, J = a.J, Q = a.Q, R = a.R;
  const float w_least = a.wts[0], w_bal = a.wts[1];

  if (tid == 0) {
    ctl[0] = a.scal[0];
    ctl[1] = a.scal[1];
    ctl[2] = a.scal[2];
    ctl[3] = -1;
    ctl[4] = a.scal[4];
  }
  __syncthreads();

  while (true) {
    const int it = ctl[0], step = ctl[1], paused = ctl[3], n_active = ctl[4];
    int cur = ctl[2];
    __syncthreads();  // everyone has read ctl before thread 0 rewrites it
    if (!((cur >= 0 || n_active > 0) && it < a.max_iter && paused < 0)) break;

    int drop_q = -1;
    if (cur < 0) {
      // -- queue: lex arg-min of (proportion share, rank) over live queues
      Key kq = {0, 0, 0.0f, NONE};
      for (int q = tid; q < Q; q += NT) {
        if (a.qcount[q] <= 0 || a.qdropped[q] != 0) continue;
        Key k = {0, 0, 0.0f, q};
        if (a.proportion) {
          float s = -INFINITY;
          for (int r = 0; r < R; ++r)
            if (a.qdim[r * Q + q] != 0) s = fmaxf(s, share_of(a.qalloc[r * Q + q], a.qdes[r * Q + q]));
          k.share = fmaxf(s, 0.0f);
        }
        if (key_less(k, kq)) kq = k;
      }
      kq = block_min_key(kq, key_scratch);
      const bool q_any = kq.idx != NONE;
      const int qsel = q_any ? kq.idx : 0;

      // -- overused gate: deserved <= allocated with the Go nil-scalar-map
      // branch (proportion.go:188-199), same verdict in every thread
      bool overused = false;
      if (a.proportion && q_any) {
        overused = true;
        const bool has_sc = a.qahs[qsel] != 0;
        for (int r = 0; r < R; ++r) {
          if (a.qdim[r * Q + qsel] == 0) continue;
          const float d = a.qdes[r * Q + qsel], al = a.qalloc[r * Q + qsel];
          bool ok = (d < al) || (fabsf(__fsub_rn(al, d)) < a.eps[r]);
          if (r >= 2) ok = ok && has_sc;
          overused = overused && ok;
        }
      }

      if (q_any && overused) {
        // the overused queue retires all its jobs for the cycle
        for (int j = tid; j < J; j += NT)
          if (a.jqueue[j] == qsel) a.jactive[j] = 0;
        drop_q = qsel;
      } else if (q_any) {
        // -- job: lex arg-min of (-priority, gang-ready, drf share, rank)
        Key kj = {0, 0, 0.0f, NONE};
        for (int j = tid; j < J; j += NT) {
          if (a.jactive[j] == 0 || a.jqueue[j] != qsel) continue;
          Key k = {-a.jprio[j], a.jready[j] >= a.jmin[j] ? 1 : 0, 0.0f, j};
          if (a.drf) {
            float s = -INFINITY;
            for (int r = 0; r < R; ++r)
              if (a.drfd[r] != 0) s = fmaxf(s, share_of(a.jalloc[r * J + j], a.drft[r]));
            k.share = fmaxf(s, 0.0f);
          }
          if (key_less(k, kj)) kj = k;
        }
        kj = block_min_key(kj, key_scratch);
        if (kj.idx != NONE) cur = kj.idx;
      }
    }

    // -- pop the current job's next pending task (every thread, O(1)) ----
    int t = 0;
    bool t_any = false;
    if (cur >= 0) {
      t = a.jptr[cur];
      t_any = t < a.jend[cur];
    }
    t = min(t, T - 1);
    const bool drop = cur >= 0 && !t_any;
    const int cls = a.tcls[t];
    const bool pause = t_any && a.cho[cls] != 0;
    const bool proc = t_any && !pause;

    Best best = {-INFINITY, NONE};
    TaskView task;
    task.R = R;
    task.has_sc = false;
    task.tports = 0;
    task.eps = a.eps;
    task.w_least = w_least;
    task.w_bal = w_bal;
    if (proc) {
#pragma unroll
      for (int r = 0; r < R8; ++r) {
        task.req[r] = r < R ? a.creq[r * a.C + cls] : 0.0f;
        task.res[r] = r < R ? a.cres[r * a.C + cls] : 0.0f;
      }
      task.has_sc = a.chs[cls] != 0;
      task.tports = a.cpt[cls];
      const int gid = a.cgid[cls];
      // -- feasibility + score over the node axis, block arg-max ----------
      const NodeAxis nodes = {N, a.cnode + (size_t)gid * N, a.nmax, a.nihs, a.nrhs, a.ntasks, a.nports,
                              a.affw + (size_t)gid * N, a.nalloc, a.idle, a.rel, a.used};
      best = sweep_best<NT>(nodes, task, best_scratch);
    }

    // -- scalar state update (thread 0) ----------------------------------
    if (tid == 0) {
      int n_act = n_active;
      if (drop_q >= 0) {
        a.qdropped[drop_q] = 1;
        n_act -= a.qcount[drop_q];
        a.qcount[drop_q] = 0;
      }
      const bool assign = proc && best.idx != NONE;
      const bool abandon = proc && best.idx == NONE;  // serial `break`
      if (assign) {
        const int nb = best.idx;
        const bool fits_idle = fits_idle_at(a.nihs, a.idle, N, nb, task);
        const float* res = task.res;
#pragma unroll
        for (int r = 0; r < R8; ++r) {
          if (r >= R) break;
          if (fits_idle)
            a.idle[r * N + nb] = __fsub_rn(a.idle[r * N + nb], res[r]);
          else  // the predicate guarantees a fit on releasing
            a.rel[r * N + nb] = __fsub_rn(a.rel[r * N + nb], res[r]);
          a.used[r * N + nb] = __fadd_rn(a.used[r * N + nb], res[r]);
        }
        a.ntasks[nb] += 1;
        a.nports[nb] |= task.tports;
        a.tnode[t] = nb;
        a.tkind[t] = fits_idle ? 1 : 2;
        a.tpos[t] = step;
        if (fits_idle) a.jready[cur] += 1;
        if (a.drf) {
#pragma unroll
          for (int r = 0; r < R8; ++r)
            if (r < R) a.jalloc[r * J + cur] = __fadd_rn(a.jalloc[r * J + cur], res[r]);
        }
        if (a.proportion) {
          const int qc = a.jqueue[cur];
#pragma unroll
          for (int r = 0; r < R8; ++r)
            if (r < R) a.qalloc[r * Q + qc] = __fadd_rn(a.qalloc[r * Q + qc], res[r]);
          if (a.crhs[cls] != 0) a.qahs[qc] = 1;
        }
      }
      if (proc) a.jptr[cur] += 1;
      int cur_next = cur;
      if (drop || abandon) {
        a.jactive[cur] = 0;
        a.qcount[a.jqueue[cur]] -= 1;
        n_act -= 1;
        cur_next = -1;
      } else if (proc && a.jready[cur] >= a.jmin[cur]) {
        cur_next = -1;  // gang barrier: the job re-queues
      }
      ctl[0] = it + 1;
      ctl[1] = step + (assign ? 1 : 0);
      ctl[2] = cur_next;
      ctl[3] = pause ? t : -1;
      ctl[4] = n_act;
    }
    __syncthreads();
  }

  if (tid == 0) {
    a.scal[0] = ctl[0];
    a.scal[1] = ctl[1];
    a.scal[2] = ctl[2];
    a.scal[3] = ctl[3];
    a.scal[4] = ctl[4];
  }
}

extern "C" {

// Launch on `stream` of `device`; returns the launch's cudaError_t (0 on
// success).
int kbt_fused_solve(const SolveArgs* args, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  fused_solve_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

const char* kbt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
