// One shard's half of one gang iteration of the sharded allocate solve,
// for Hopper (sm_90a).
//
// Replaces kube_batch_tpu/ops/pallas_solve.py::_build_block_step (the
// Pallas TPU block-step kernel; its oracle there is block_step_jnp).
// Plain version: kube_batch_tpu_torch/ops/block_step.py block_step_plain.
// Caller: parallel/sharded_block.py ShardedBlockSolver, once per shard per
// gang iteration that places a task.
//
// What it computes: over the shard's node block (N nodes, [R, N] rows,
// [GT, N] compat and affinity), each node's feasibility and score for the
// popped task, the block-local first-index arg-max, and the fits-idle bit
// at the winner. It writes one record of four int32 words: the best score
// (float bits; -inf when no node is a candidate), the winner's global
// index (local index + the block's offset, or the sentinel), the
// fits-idle bit, and 0.
//
// What bounds it: the block's bytes are about 50 B per node at R = 2
// (0.26 MB for a 5,120-node block, 0.08 us at 3.35 TB/s) and its float32
// work is a few dozen operations per node, so on paper it is bandwidth
// bound at a tenth of a microsecond. In practice a call is latency: the
// launch, one round of loads per node, and the reduction's barriers. The
// caller's loop adds one launch per shard and one read of the record per
// iteration.
//
// What the design does about it: one launch of a thread-block cluster of
// k CTAs (ops/cluster.py cluster_shape: k = ceil(N / 512), at most 16),
// each CTA owning a contiguous slice of the block with one node per
// thread (a strided walk only past 16 x 512 nodes). A thread issues all
// of its node's loads at once and computes the fits-idle bit from the idle
// values it loaded, so nothing is loaded after the arg-max. Each CTA
// reduces its slice with warp reductions (redux.sync) and pushes its
// record into every CTA's shared memory (DSMEM, the arg-max B1 shares);
// one cluster barrier later rank 0 picks the winner and writes the record
// (a cluster of one CTA needs no cluster barrier). The CTAs arrive on a relaxed cluster barrier
// at entry and wait on it just before the push, so the "every CTA has
// started" guarantee that DSMEM needs costs no wait on the critical path.
// No CTA touches a peer's shared memory after the last barrier, so the
// CTAs exit without a final one. The launch itself (a few microseconds
// from Python) now costs more than the kernel; only a loop resident on
// the card would remove it.
//
// Numerics: as fused_solve.cu (-fmad=false, round-to-nearest intrinsics,
// __fdiv_rn); the arg-max compares floats, so -0.0 and +0.0 tie and the
// lower index wins, in whichever CTA each lies.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "node_sweep.cuh"

extern "C" {

// Mirror of ops/block_step.py::Task (same field order): the popped task.
struct TaskFields {
  int gid, has_sc, tports, pad0;
  float req[R8], res[R8], eps[R8];  // padded: req/res 0, eps 1
  float w_least, w_bal;
};

// Mirror of ops/block_step.py::_Args (same field order).
struct BlockArgs {
  int N, R, off, sent;
  int k, threads, slice, pad0;  // the cluster's geometry (cluster_shape)
  TaskFields task;
  const int *cnode, *nmax, *nihs, *nrhs;  // cnode [GT, N]
  const float *affw, *nalloc;             // affw [GT, N], nalloc [2, N]
  const float *idle, *rel, *used;         // [R, N]
  const int *ntasks, *nports;             // [N]
  int* out;                               // [4]
};

}  // extern "C"

__global__ void __launch_bounds__(512, 1) block_step_kernel(const BlockArgs a) {
  __shared__ Best scratch[2][32];
  __shared__ Best slots[2][MAX_CLUSTER];

  cluster_arrive_relaxed();  // this CTA has started
  namespace cg = cooperative_groups;
  const int rank = (int)cg::this_cluster().block_rank();
  TaskView task;
  task.R = a.R;
  task.has_sc = a.task.has_sc != 0;
  task.tports = a.task.tports;
  task.w_least = a.task.w_least;
  task.w_bal = a.task.w_bal;
#pragma unroll
  for (int r = 0; r < R8; ++r) {
    task.req[r] = a.task.req[r];
    task.res[r] = a.task.res[r];
    task.eps[r] = a.task.eps[r];
  }
  const int N = a.N, gid = a.task.gid;
  const int lo = rank * a.slice, n_local = max(0, min(a.slice, N - lo));
  const NodeAxis nodes = {N,          N,          a.cnode + (size_t)gid * N + lo,
                          a.nmax + lo, a.nihs + lo, a.nrhs + lo,
                          a.ntasks + lo, a.nports + lo, a.affw + (size_t)gid * N + lo,
                          a.nalloc + lo, a.idle + lo, a.rel + lo,
                          a.used + lo};

  const Best mine = thread_best(nodes, n_local, lo, task);
  cluster_wait();  // every CTA has started: their shared memory may be written
  const Best best = cluster_max_best(mine, scratch, slots, 0);

  if (rank == 0 && threadIdx.x == 0) {
    const bool any = best.idx != NONE;
    a.out[0] = __float_as_int(any ? best.score : -INFINITY);
    a.out[1] = any ? best.idx + a.off : a.sent;
    a.out[2] = any ? best.fits : 0;
    a.out[3] = 0;
  }
}

static cudaLaunchConfig_t launch_config(int k, int threads, void* stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = k;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

extern "C" {

// Launch one cluster on `stream` of `device`; returns the launch's
// cudaError_t (0 on success).
int kbt_block_step(const BlockArgs* args, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(args->k, args->threads, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, block_step_kernel, *args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of k CTAs of `threads` threads `device` can hold at
// once, into *out; returns the first failing call's cudaError_t. Past 8
// CTAs it first allows the kernel non-portable clusters on `device`, so
// call it before the first launch of such a cluster there.
int kbt_block_step_max_clusters(int k, int threads, int device, int* out) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaLaunchAttribute attr;
  if (k > PORTABLE_CLUSTER) {
    const cudaError_t err =
        cudaFuncSetAttribute(block_step_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaLaunchConfig_t cfg = launch_config(k, threads, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, (void*)block_step_kernel, &cfg);
}

const char* kbt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
