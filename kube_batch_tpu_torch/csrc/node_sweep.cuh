// The float32 node arithmetic that both kernels share: feasibility, the
// LeastRequested + BalancedResource + affinity score, the first-index
// arg-max and the fits-idle bit at the winner.
//
// fused_solve.cu (the whole solve, B1) and block_step.cu (one shard's node
// block, B2) both sweep a node axis laid out as [R, N] rows (one row per
// resource dim) plus [GT, N] for the static compat verdict and the
// pre-weighted affinity score. Keeping the sweep here keeps the two
// kernels from drifting: the sharded solve must equal the fused one bit
// for bit.
//
// Numerics: every score operation is an explicit round-to-nearest
// intrinsic (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn), and the sources
// are built with -fmad=false, so nothing is contracted into an FMA and
// every float32 result rounds as the plain versions' do. The arg-max
// compares floats, so -0.0 and +0.0 tie and the lower index wins.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define R8 8
#define MAX_PRIORITY 10.0f
#define NONE 0x7fffffff

// One node axis: [GT, N] statics already offset to the task's group,
// [R, N] float state, [N] int state.
struct NodeAxis {
  int N;
  const int *cnode, *nmax, *nihs, *nrhs, *ntasks, *nports;
  const float *affw, *nalloc, *idle, *rel, *used;
};

// The popped task, as the sweep reads it (req/res padded to R8; eps
// points at R per-dim tolerances in global or shared memory).
struct TaskView {
  int R;
  bool has_sc;
  int tports;
  float req[R8], res[R8];
  const float* eps;
  float w_least, w_bal;
};

// Node candidate: higher score wins, the lower index on equal scores.
struct Best {
  float score;
  int idx;
};

__device__ __forceinline__ bool best_better(const Best& a, const Best& b) {
  if (a.idx == NONE) return false;
  if (b.idx == NONE) return true;
  if (a.score != b.score) return a.score > b.score;
  return a.idx < b.idx;
}

// Block-wide arg-max of `b` over NT threads; `scratch` holds NT/32 + 1.
template <int NT>
__device__ __forceinline__ Best block_max_best(Best b, Best* scratch) {
  const unsigned full = 0xffffffffu;
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.score = __shfl_down_sync(full, b.score, off);
    o.idx = __shfl_down_sync(full, b.idx, off);
    if (best_better(o, b)) b = o;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = b;
  __syncthreads();
  if (warp == 0) {
    b = lane < NT / 32 ? scratch[lane] : Best{-INFINITY, NONE};
    for (int off = 16; off > 0; off >>= 1) {
      Best o;
      o.score = __shfl_down_sync(full, b.score, off);
      o.idx = __shfl_down_sync(full, b.idx, off);
      if (best_better(o, b)) b = o;
    }
    if (lane == 0) scratch[NT / 32] = b;
  }
  __syncthreads();
  Best out = scratch[NT / 32];
  __syncthreads();  // scratch is free for the next reduction
  return out;
}

// k8s LeastRequested per dimension: floor((cap - req) * 10 / cap), 0 when
// cap == 0 or req > cap.
__device__ __forceinline__ int least_dim(float rq, float cp) {
  if (cp == 0.0f || rq > cp) return 0;
  return (int)floorf(__fdiv_rn(__fmul_rn(__fsub_rn(cp, rq), MAX_PRIORITY), cp));
}

// k8s BalancedResourceAllocation: 10 - |cpu_fraction - mem_fraction| * 10,
// 0 when either fraction reaches 1 (a zero capacity counts as full).
__device__ __forceinline__ int balanced_score(float req_c, float req_m, float cap_c, float cap_m) {
  const float cpu_f = cap_c != 0.0f ? __fdiv_rn(req_c, cap_c) : 1.0f;
  const float mem_f = cap_m != 0.0f ? __fdiv_rn(req_m, cap_m) : 1.0f;
  if (cpu_f >= 1.0f || mem_f >= 1.0f) return 0;
  return (int)__fsub_rn(MAX_PRIORITY, __fmul_rn(fabsf(__fsub_rn(cpu_f, mem_f)), MAX_PRIORITY));
}

// The score sum, in the reference's order: (least*w_least + bal*w_bal) + affw.
__device__ __forceinline__ float score_sum(int least, int bal, float w_least, float w_bal, float affw) {
  return __fadd_rn(__fadd_rn(__fmul_rn((float)least, w_least), __fmul_rn((float)bal, w_bal)), affw);
}

// Does the task fit `pool` (idle or releasing) + eps in every dim of node n?
__device__ __forceinline__ bool fits_pool(const float* pool, int N, int n, const TaskView& t) {
  bool ok = true;
#pragma unroll
  for (int r = 0; r < R8; ++r) {
    if (r >= t.R) break;
    ok = ok && t.req[r] < __fadd_rn(pool[r * N + n], t.eps[r]);
  }
  return ok;
}

// The fits-idle bit at node n of an N-node axis: idle capacity + eps in
// every dim, and the node's idle scalar map present when the task asks
// for scalars.
__device__ __forceinline__ bool fits_idle_at(const int* nihs, const float* idle, int N, int n,
                                             const TaskView& t) {
  return !(t.has_sc && nihs[n] == 0) && fits_pool(idle, N, n, t);
}

// Feasibility and score of node n; false when n is no candidate (static
// compat, pod room, host ports, fit on idle or releasing capacity).
__device__ __forceinline__ bool node_score(const NodeAxis& v, int n, const TaskView& t, float* score) {
  const int N = v.N;
  if (v.cnode[n] == 0 || v.ntasks[n] >= v.nmax[n] || (v.nports[n] & t.tports) != 0) return false;
  // both pools in one pass over the dims, so their loads overlap
  bool fi = !(t.has_sc && v.nihs[n] == 0);
  bool fr = !(t.has_sc && v.nrhs[n] == 0);
#pragma unroll
  for (int r = 0; r < R8; ++r) {
    if (r >= t.R) break;
    fi = fi && t.req[r] < __fadd_rn(v.idle[r * N + n], t.eps[r]);
    fr = fr && t.req[r] < __fadd_rn(v.rel[r * N + n], t.eps[r]);
  }
  if (!(fi || fr)) return false;
  const float req_c = __fadd_rn(v.used[n], t.res[0]);
  const float req_m = __fadd_rn(v.used[N + n], t.res[1]);
  const float cap_c = v.nalloc[n], cap_m = v.nalloc[N + n];
  const int least = (least_dim(req_c, cap_c) + least_dim(req_m, cap_m)) / 2;
  const int bal = balanced_score(req_c, req_m, cap_c, cap_m);
  *score = score_sum(least, bal, t.w_least, t.w_bal, v.affw[n]);
  return true;
}

// The block's best candidate over the node axis: a strided sweep (each
// thread keeps its first best, scanning upward) and a block arg-max.
template <int NT>
__device__ __forceinline__ Best sweep_best(const NodeAxis& v, const TaskView& t, Best* scratch) {
  Best best = {-INFINITY, NONE};
  for (int n = threadIdx.x; n < v.N; n += NT) {
    float score;
    if (!node_score(v, n, t, &score)) continue;
    if (score > best.score || best.idx == NONE) best = {score, n};
  }
  return block_max_best<NT>(best, scratch);
}
