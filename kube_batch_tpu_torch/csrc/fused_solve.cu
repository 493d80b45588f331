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
// vectors. Its bytes and operations are far below what the card can do
// in the time, so an iteration costs its latency: the sweep over the
// node axis, the arg-max's barriers, the selection's reductions and the
// dependent loads of the pop and of the state update. With every CTA
// running the same control code, that latency is the instruction count
// of one warp's chain times the warps sharing a scheduler.
//
// What the design does about it: the node-sharded solve's design inside
// one cluster. One persistent cluster of k CTAs of 512 threads
// (ops/fused_solve.py solve_geometry: k = ceil(N / 512), at most 16) runs
// every iteration; each CTA is one shard of the node axis.
//   - Node state in shared memory. Each CTA owns a contiguous slice of
//     the nodes, one node per thread (a strided walk only past 16 x 512
//     nodes), and keeps the slice's mutable state (idle, releasing, used
//     rows, pod count, port mask) in shared memory for the whole solve.
//     The read-only statics (compat and affinity rows, pod limit, scalar
//     flags, allocatable) stay in global memory, read through L1.
//   - Replicated state per CTA. The job and queue vectors and the class
//     table are copied into each CTA's shared memory (or, when they do not
//     fit beside the node slice, into the CTA's own slice of a global
//     scratch buffer: a second instantiation of the kernel), and every CTA
//     runs the same selection, pop and update on its copy, as the sharded
//     rung replicates them on the host. The loop's scalars (iteration,
//     step, current job, its task pointer and ready count, active-job
//     count) live in every thread's registers, computed redundantly, so an
//     iteration that keeps its job needs no barrier to publish them.
//   - One cluster barrier per iteration, inside the cluster arg-max
//     (node_sweep.cuh cluster_max_best): each CTA pushes its best record,
//     with the fits-idle bit its owner thread computed in the sweep, to
//     every peer through DSMEM; the record slots are double-buffered by
//     the arg-max's parity, so they need no second barrier. A cluster of
//     one CTA needs no cluster barrier at all. The thread that owns the
//     winning node updates its row; one lane in each of three warps
//     updates the replicated vectors.
//   - Short chains: warp reductions are redux.sync instructions, not
//     shuffle trees; the queue pick runs in every warp on its own (no
//     barrier); each job's drf share is kept up to date instead of being
//     divided out at every selection; a class's request row is read
//     without a test per dim; the tolerances live in registers; the next
//     task's class is loaded an iteration ahead.
// An iteration that keeps its job costs the sweep, one __syncthreads and
// one cluster barrier; one that selects a job adds two __syncthreads (one
// before, one in the job arg-min). At exit every CTA writes its node
// slice back and CTA 0 writes the replicated state back, so a pause at a
// host-only task, max_iter, or the end leave the state buffers as the
// plain version does. No CTA touches a peer's shared memory after the
// last barrier, so the CTAs exit without a final one.
//
// Numerics: built with -fmad=false and without fast math; the score
// arithmetic also uses the explicit round-to-nearest intrinsics, so every
// float32 operation rounds exactly as the plain version's does. Division
// is __fdiv_rn (correctly rounded). The arg-max orders scores as floats
// (an order-preserving integer key with -0.0 and +0.0 on one value), so
// -0.0 and +0.0 tie and the lower index wins. The node sweep
// (feasibility, score, fits-idle, the cluster arg-max) lives in
// node_sweep.cuh, shared with the sharded block step (block_step.cu); the
// loop itself (selection, pop, sweep, commit, write-back) lives in
// solve_loop.cuh, shared with the mesh solve (mesh_solve.cu, B4), which
// runs it on every card over that card's nodes. B1 instantiates it with
// OneCard, the exchange that keeps its cluster's arg-max.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "solve_loop.cuh"

// B1's exchange: the cluster holds the whole node axis, so its arg-max is
// the winner, and its index is the node's row.
struct OneCard {
  __device__ __forceinline__ bool exchange(const Best& b, Won* w) const {
    *w = Won{b.idx, b.idx, b.fits};
    return true;
  }
  __device__ __forceinline__ bool primary() const { return true; }
  __device__ __forceinline__ void finish(const SolveArgs&, int) const {}
};

template <bool kRepInSmem>
__global__ void __launch_bounds__(NT, 1) fused_solve_kernel(const SolveArgs a) {
  OneCard x;
  solve_loop<kRepInSmem>(a, x);
}

static cudaLaunchConfig_t launch_config(const SolveArgs& a, void* stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.k, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = a.smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = a.k;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

static const void* kernel_of(const SolveArgs& a) {
  return a.rep_in_smem ? (const void*)fused_solve_kernel<true> : (const void*)fused_solve_kernel<false>;
}

// The launch's shared-memory size, and clusters past the portable 8 CTAs.
static cudaError_t set_attributes(const SolveArgs& a) {
  const void* fn = kernel_of(a);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
  if (err == cudaSuccess && a.k > PORTABLE_CLUSTER)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

extern "C" {

// Launch the solve's cluster on `stream` of `device`; returns the first
// failing call's cudaError_t (0 on success).
int kbt_fused_solve(const SolveArgs* args, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaError_t err = set_attributes(*args);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(*args, stream, &attr);
  err = args->rep_in_smem ? cudaLaunchKernelEx(&cfg, fused_solve_kernel<true>, *args)
                          : cudaLaunchKernelEx(&cfg, fused_solve_kernel<false>, *args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many of the solve's clusters (args->k CTAs of NT threads with
// args->smem_bytes of dynamic shared memory each) `device` can hold at
// once, into *out; returns the first failing call's cudaError_t.
int kbt_fused_solve_max_clusters(const SolveArgs* args, int device, int* out) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const cudaError_t err = set_attributes(*args);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(*args, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, kernel_of(*args), &cfg);
}

const char* kbt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
