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
// What bounds it: the block's bytes are about 60 B per node at R = 2
// (0.3 MB for a 5,000-node block, 0.1 us at 3.35 TB/s) and its float32
// work is a few dozen operations per node, so on paper it is bandwidth
// bound at a tenth of a microsecond. In practice one call costs a launch
// and a block reduction, several microseconds: the caller's loop is
// launch- and sync-bound by construction (one launch per shard and one
// read of the record per iteration).
//
// What the design does about it: nothing yet, by intent. One CTA of 1024
// threads sweeps the block with a stride and reduces with warp shuffles
// (the same node_sweep.cuh code as the fused kernel's node sweep, so the
// two cannot drift), then thread 0 writes the record. A resident
// multi-CTA design or CUDA graphs over the iteration are later work.
//
// Numerics: as fused_solve.cu (-fmad=false, round-to-nearest intrinsics,
// __fdiv_rn); the arg-max compares floats, so -0.0 and +0.0 tie.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "node_sweep.cuh"

#define NT 1024

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
  TaskFields task;
  const int *cnode, *nmax, *nihs, *nrhs;  // cnode [GT, N]
  const float *affw, *nalloc;             // affw [GT, N], nalloc [2, N]
  const float *idle, *rel, *used;         // [R, N]
  const int *ntasks, *nports;             // [N]
  int* out;                               // [4]
};

}  // extern "C"

__global__ void __launch_bounds__(NT, 1) block_step_kernel(const BlockArgs a) {
  __shared__ Best scratch[NT / 32 + 1];
  __shared__ float eps[R8];

  if (threadIdx.x < R8) eps[threadIdx.x] = a.task.eps[threadIdx.x];
  __syncthreads();
  TaskView task;
  task.R = a.R;
  task.has_sc = a.task.has_sc != 0;
  task.tports = a.task.tports;
  task.w_least = a.task.w_least;
  task.w_bal = a.task.w_bal;
  task.eps = eps;
#pragma unroll
  for (int r = 0; r < R8; ++r) {
    task.req[r] = a.task.req[r];
    task.res[r] = a.task.res[r];
  }
  const int N = a.N, gid = a.task.gid;
  const NodeAxis nodes = {N, a.cnode + (size_t)gid * N, a.nmax, a.nihs, a.nrhs, a.ntasks, a.nports,
                          a.affw + (size_t)gid * N, a.nalloc, a.idle, a.rel, a.used};

  const Best best = sweep_best<NT>(nodes, task, scratch);

  if (threadIdx.x == 0) {
    const bool any = best.idx != NONE;
    a.out[0] = __float_as_int(any ? best.score : -INFINITY);
    a.out[1] = any ? best.idx + a.off : a.sent;
    a.out[2] = any && fits_idle_at(a.nihs, a.idle, N, best.idx, task) ? 1 : 0;
    a.out[3] = 0;
  }
}

extern "C" {

// Launch on `stream` of `device`; returns the launch's cudaError_t (0 on
// success).
int kbt_block_step(const BlockArgs* args, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  block_step_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

const char* kbt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
