// The float32 node arithmetic that both kernels share: feasibility, the
// LeastRequested + BalancedResource + affinity score, the fits-idle bit,
// and the first-index arg-max across a thread-block cluster.
//
// fused_solve.cu (the whole solve, B1) and block_step.cu (one shard's node
// block, B2) both sweep a node axis laid out as [R, X] rows (one row per
// resource dim) plus [GT, N] for the static compat verdict and the
// pre-weighted affinity score. Both run it as a cluster of k CTAs, each
// owning a contiguous slice of the axis, one node per thread. Keeping the
// sweep here keeps the two kernels from drifting: the sharded solve must
// equal the fused one bit for bit.
//
// Numerics: every score operation is an explicit round-to-nearest
// intrinsic (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn), and the sources
// are built with -fmad=false, so nothing is contracted into an FMA and
// every float32 result rounds as the plain versions' do. The arg-max
// compares floats, so -0.0 and +0.0 tie and the lower index wins; that
// order is total, so the result does not depend on how the reduction is
// grouped across warps and CTAs.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#define R8 8
#define MAX_PRIORITY 10.0f
#define NONE 0x7fffffff
#define PORTABLE_CLUSTER 8  // the largest cluster every sm_90 card launches
#define MAX_CLUSTER 16  // the largest an H100 launches (non-portable past 8)

// One CTA's slice of a node axis, indexed by the node's local index n:
// the statics ([GT, N] rows already offset to the task's group, nalloc
// [2, N]) step rows by N; the node state ([R, S] rows) by S. Pointers may
// point into global or shared memory.
struct NodeAxis {
  int N, S;
  const int *cnode, *nmax, *nihs, *nrhs, *ntasks, *nports;
  const float *affw, *nalloc, *idle, *rel, *used;
};

// The popped task, as the sweep reads it (req/res/eps padded to R8; only
// the first R dims are read).
struct TaskView {
  int R;
  bool has_sc;
  int tports;
  float req[R8], res[R8], eps[R8];
  float w_least, w_bal;
};

// Node candidate: higher score wins, the lower index on equal scores.
// `fits` is the fits-idle bit of node `idx`, computed in the sweep.
struct __align__(16) Best {
  float score;
  int idx;
  int fits;
  int pad;
};

__device__ __forceinline__ bool best_better(const Best& a, const Best& b) {
  if (a.idx == NONE) return false;
  if (b.idx == NONE) return true;
  if (a.score != b.score) return a.score > b.score;
  return a.idx < b.idx;
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

// Feasibility, score and fits-idle bit of local node n; false when n is no
// candidate (static compat, pod room, host ports, fit on idle or releasing
// capacity). Every load is issued before any test, so a node costs one
// round of loads, not a chain; the result equals the short-circuit test.
// *fits_idle is the task's fit on the node's idle capacity + eps in every
// dim, with the idle scalar map present when the task asks for scalars.
__device__ __forceinline__ bool node_score(const NodeAxis& v, int n, const TaskView& t, float* score,
                                           bool* fits_idle) {
  const int N = v.N, S = v.S;
  const int cnode = v.cnode[n], ntasks = v.ntasks[n], nmax = v.nmax[n], nports = v.nports[n];
  const int nihs = v.nihs[n], nrhs = v.nrhs[n];
  const float used_c = v.used[n], used_m = v.used[S + n];
  const float cap_c = v.nalloc[n], cap_m = v.nalloc[N + n], affw = v.affw[n];
  bool fi = !(t.has_sc && nihs == 0);
  bool fr = !(t.has_sc && nrhs == 0);
#pragma unroll
  for (int r = 0; r < R8; ++r) {
    if (r >= t.R) break;
    const float idle = v.idle[r * S + n], rel = v.rel[r * S + n];
    fi = fi & (t.req[r] < __fadd_rn(idle, t.eps[r]));
    fr = fr & (t.req[r] < __fadd_rn(rel, t.eps[r]));
  }
  *fits_idle = fi;
  if (cnode == 0 || ntasks >= nmax || (nports & t.tports) != 0 || !(fi || fr)) return false;
  const float req_c = __fadd_rn(used_c, t.res[0]);
  const float req_m = __fadd_rn(used_m, t.res[1]);
  const int least = (least_dim(req_c, cap_c) + least_dim(req_m, cap_m)) / 2;
  const int bal = balanced_score(req_c, req_m, cap_c, cap_m);
  *score = score_sum(least, bal, t.w_least, t.w_bal, affw);
  return true;
}

// This thread's best over the slice's local nodes [0, n_local): node
// threadIdx.x, then upward with a stride of blockDim.x (only past 1,024
// nodes per CTA), keeping the first best. `base` turns a local index into
// the record's index.
__device__ __forceinline__ Best thread_best(const NodeAxis& v, int n_local, int base, const TaskView& t) {
  Best best = {-INFINITY, NONE, 0, 0};
  for (int n = threadIdx.x; n < n_local; n += blockDim.x) {
    float score;
    bool fits;
    if (!node_score(v, n, t, &score, &fits)) continue;
    const Best cand = {score, base + n, fits ? 1 : 0, 0};
    if (best_better(cand, best)) best = cand;
  }
  return best;
}

// One node's fields as node_score reads them: its static verdict and
// affinity score for the task's group, its room, ports, scalar-map flags,
// used rows and capacity, and its idle and releasing rows (the first R).
struct NodeView {
  int cnode, ntasks, nmax, nports, nihs, nrhs;
  float used_c, used_m, cap_c, cap_m, affw;
  float idle[R8], rel[R8];
};

// Local node n's fields, loaded at once.
__device__ __forceinline__ NodeView load_node(const NodeAxis& v, int n, int R) {
  const int N = v.N, S = v.S;
  NodeView x;
  x.cnode = v.cnode[n];
  x.ntasks = v.ntasks[n];
  x.nmax = v.nmax[n];
  x.nports = v.nports[n];
  x.nihs = v.nihs[n];
  x.nrhs = v.nrhs[n];
  x.used_c = v.used[n];
  x.used_m = v.used[S + n];
  x.cap_c = v.nalloc[n];
  x.cap_m = v.nalloc[N + n];
  x.affw = v.affw[n];
#pragma unroll
  for (int r = 0; r < R8; ++r) {
    if (r >= R) break;
    x.idle[r] = v.idle[r * S + n];
    x.rel[r] = v.rel[r * S + n];
  }
  return x;
}

// node_score's verdict, score and fits-idle bit for a node whose fields
// are loaded (the multi-key sweep scores one NodeView for several tasks):
// the same operations in the same order, so the same bits. node_score
// keeps its own copy: written as score_node(load_node(...)), it took B1 to
// 112 registers and 212.36-212.38 ms at 50k x 5k, from 105 and 203-206 ms
// (H100, chip_smoke.py --b4), as every row load then precedes every test.
__device__ __forceinline__ bool score_node(const NodeView& x, const TaskView& t, float* score, bool* fits_idle) {
  bool fi = !(t.has_sc && x.nihs == 0);
  bool fr = !(t.has_sc && x.nrhs == 0);
#pragma unroll
  for (int r = 0; r < R8; ++r) {
    if (r >= t.R) break;
    fi = fi & (t.req[r] < __fadd_rn(x.idle[r], t.eps[r]));
    fr = fr & (t.req[r] < __fadd_rn(x.rel[r], t.eps[r]));
  }
  *fits_idle = fi;
  if (x.cnode == 0 || x.ntasks >= x.nmax || (x.nports & t.tports) != 0 || !(fi || fr)) return false;
  const float req_c = __fadd_rn(x.used_c, t.res[0]);
  const float req_m = __fadd_rn(x.used_m, t.res[1]);
  const int least = (least_dim(req_c, x.cap_c) + least_dim(req_m, x.cap_m)) / 2;
  const int bal = balanced_score(req_c, req_m, x.cap_c, x.cap_m);
  *score = score_sum(least, bal, t.w_least, t.w_bal, x.affw);
  return true;
}

// The multi-key sweep's per-thread part: this thread's best for each of
// the first nk (<= KC) tasks of `tasks`, over the same nodes as
// thread_best, each node read once and scored for every task. The static
// verdict and the affinity score are the task's group's row (`group[j]`),
// so they are loaded for each task from `cnode` and `affw`, the [GT, N]
// statics at the slice's first node; every other field once a node.
template <int KC>
__device__ __forceinline__ void thread_best_keys(const NodeAxis& v, const int* cnode, const float* affw, int n_local,
                                                 int base, const TaskView* tasks, const int* group, int nk,
                                                 Best (&best)[KC]) {
#pragma unroll
  for (int j = 0; j < KC; ++j) best[j] = Best{-INFINITY, NONE, 0, 0};
  for (int n = threadIdx.x; n < n_local; n += blockDim.x) {
    NodeView x = load_node(v, n, tasks[0].R);
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      if (j >= nk) break;
      const size_t row = (size_t)group[j] * v.N;
      x.cnode = cnode[row + n];
      x.affw = affw[row + n];
      float score;
      bool fits;
      if (!score_node(x, tasks[j], &score, &fits)) continue;
      const Best cand = {score, base + n, fits ? 1 : 0, 0};
      if (best_better(cand, best[j])) best[j] = cand;
    }
  }
}

// An int whose order is the float order of `s` (not NaN), with -0.0 and
// +0.0 on one key, as they tie.
__device__ __forceinline__ int score_key(float s) {
  const int i = __float_as_int(s);
  return s == 0.0f ? 0 : (i >= 0 ? i : i ^ 0x7fffffff);
}

// Warp arg-max in best_better's order, returned to every lane: the warp
// reductions (redux.sync) take the largest score key, then the lowest
// index among the lanes that hold it; score and fits come from that lane.
__device__ __forceinline__ Best warp_max_best(const Best& b) {
  const unsigned full = 0xffffffffu;
  const int key = b.idx == NONE ? INT_MIN : score_key(b.score);
  const int top = __reduce_max_sync(full, key);
  const int idx = (int)__reduce_min_sync(full, key == top ? (unsigned)b.idx : (unsigned)NONE);
  const int src = __ffs(__ballot_sync(full, key == top && b.idx == idx)) - 1;
  Best o;
  o.score = __shfl_sync(full, b.score, src);
  o.idx = idx;
  o.fits = __shfl_sync(full, b.fits, src);
  o.pad = 0;
  return o;
}

// Split cluster barrier: arrive, then wait (with acquire semantics). Every
// thread of every CTA calls one arrive and then the wait, in turn. A
// relaxed arrive orders no memory; a releasing one makes the thread's
// earlier writes (to peers' shared memory too) visible to every thread
// past the wait, and costs a GPU-wide memory barrier (MEMBAR.ALL.GPU) in
// its warp, so only the warp that wrote takes it.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }

// The cluster-wide arg-max of every thread's `b`, returned to every thread
// of every CTA. Each CTA reduces its threads: a warp reduction, one
// __syncthreads, then every warp reduces the warps' records itself. A
// cluster of one CTA is done there. Otherwise warp 0 of each CTA pushes
// its record into slot [rank] of every CTA's `slots[phase & 1]` through
// distributed shared memory; one cluster barrier makes the k records
// visible (warp 0 arrives with release semantics, the other warps, which
// wrote nothing a peer reads, relaxed; every thread waits with acquire),
// and every warp reduces them from its own CTA.
//
// `scratch` is a [2][32] array of warp records and `slots` a
// [2][MAX_CLUSTER] array at the same offset in every CTA; the caller
// passes phase = 0, 1, 2, ... on its successive calls. Call p writes
// scratch[p & 1] and slots[p & 1] only after the barrier of call p - 1,
// which every thread (and every peer CTA) passes only after reading them
// in call p - 2, so the double buffers need no second barrier. Before its
// first call every CTA of the cluster must have started (a cluster
// barrier, or cluster_arrive_relaxed at entry and cluster_wait before
// this call).
__device__ __forceinline__ Best cluster_max_best(Best b, Best (*scratch)[32], Best (*slots)[MAX_CLUSTER],
                                                 unsigned phase) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned k = cluster.num_blocks(), rank = cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Best* warps = scratch[phase & 1];
  b = warp_max_best(b);
  if (lane == 0) warps[warp] = b;
  __syncthreads();
  b = warp_max_best(lane < (int)(blockDim.x >> 5) ? warps[lane] : Best{-INFINITY, NONE, 0, 0});
  if (k == 1) return b;
  Best* slot = slots[phase & 1];
  if (warp == 0) {
    if (lane < (int)k) *cluster.map_shared_rank(&slot[rank], lane) = b;
    cluster_arrive_release();
  } else {
    // Relaxed: these warps wrote nothing a peer reads. What a peer's next
    // write to `slot` (two calls on) must follow is their read of it
    // below; that write comes after this warp's next arrive, which the
    // warp reaches only once the read's value has fed warp_max_best. The
    // order rests on that data dependence in program order, not on a
    // release in the PTX memory model.
    cluster_arrive_relaxed();
  }
  cluster_wait();
  return warp_max_best(lane < (int)k ? slot[lane] : Best{-INFINITY, NONE, 0, 0});
}
