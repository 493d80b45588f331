// A probe, not a kernel of the port: the latency floor of kernel B3
// (csrc/class_step.cu), launched only by chip_smoke.py, which reports its
// time as B3's latency bound.
//
// A class-compressed segment is a chain of dependent iterations: each
// assignment changes the slot state the next decision reads, so no design
// that keeps the segment in one CTA can overlap two iterations. What every
// such design must pay on each iteration, and all this probe does:
//   - one shared-memory read of the popped task's row;
//   - one fit-and-score read of each slot's row from shared memory (every
//     slot, as the sweep reads it, with no early exit);
//   - one block-wide arg-max over the C candidates, as one 64-bit key a
//     thread (the score's order in the high word, the slot inverted in the
//     low word): a warp reduction, one barrier over a double-buffered
//     scratch, a warp reduction;
//   - one owner write: the winning slot's row, by the thread that owns it,
//     so the next iteration needs no second barrier.
// It runs at B3's slot count and thread count, for the segment's iteration
// count, on the segment's own slot rows and task rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "node_sweep.cuh"

#define FLOOR_MAX_THREADS 1024

extern "C" {

// Mirror of chip_smoke.py's FloorArgs (same order).
struct FloorArgs {
  int C, R, iterations, rows, nthreads, smem_bytes;
  const float *slot_idle, *slot_used;  // [C, R]
  const float *task_req, *task_res;  // [rows, R]
  int* out;  // [2]: the last winner, the sum of the winners
};

}  // extern "C"

__global__ void __launch_bounds__(FLOOR_MAX_THREADS, 1) class_floor_kernel(const FloorArgs a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ unsigned long long red[2][FLOOR_MAX_THREADS / 32];
  const unsigned full = 0xffffffffu;
  const int tid = threadIdx.x, nt = blockDim.x, C = a.C, R = a.R;
  float* idle = sm;
  float* used = sm + R * C;
  float* rows = sm + 2 * R * C;
  for (int c = tid; c < C; c += nt) {
    for (int r = 0; r < R; ++r) {
      idle[r * C + c] = a.slot_idle[c * R + r];
      used[r * C + c] = a.slot_used[c * R + r];
    }
  }
  for (int i = tid; i < a.rows * R; i += nt) {
    rows[(i / R) * 2 * R + i % R] = a.task_req[i];
    rows[(i / R) * 2 * R + R + i % R] = a.task_res[i];
  }
  __syncthreads();

  unsigned sum = 0;
  int last = -1;
  for (int it = 0; it < a.iterations; ++it) {
    const float* row = rows + (it % a.rows) * 2 * R;
    float req[R8], res[R8];
#pragma unroll
    for (int r = 0; r < R8; ++r) {
      req[r] = r < R ? row[r] : 0.0f;
      res[r] = r < R ? row[R + r] : 0.0f;
    }
    unsigned long long best = 0;
    for (int c = tid; c < C; c += nt) {
      bool fit = true;
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < R8; ++r) {
        if (r >= R) break;
        const float id = idle[r * C + c], us = used[r * C + c];
        fit = fit & (req[r] < id);
        s = __fadd_rn(s, __fsub_rn(id, __fadd_rn(us, res[r])));
      }
      const unsigned long long key =
          ((unsigned long long)((unsigned)score_key(s) ^ 0x80000000u) << 32) | (unsigned)(~c);
      if (fit && key > best) best = key;
    }
    unsigned hi = __reduce_max_sync(full, (unsigned)(best >> 32));
    unsigned lo = __reduce_max_sync(full, (unsigned)(best >> 32) == hi ? (unsigned)best : 0u);
    if ((tid & 31) == 0) red[it & 1][tid >> 5] = ((unsigned long long)hi << 32) | lo;
    __syncthreads();
    const int lane = tid & 31;
    const unsigned long long v = lane < (nt >> 5) ? red[it & 1][lane] : 0ull;
    hi = __reduce_max_sync(full, (unsigned)(v >> 32));
    lo = __reduce_max_sync(full, (unsigned)(v >> 32) == hi ? (unsigned)v : 0u);
    if (lo == 0u) continue;  // no slot fits: nothing to write
    const int cb = (int)(~lo);
    if (cb % nt == tid) {
#pragma unroll
      for (int r = 0; r < R8; ++r) {
        if (r >= R) break;
        idle[r * C + cb] = __fsub_rn(idle[r * C + cb], res[r]);
        used[r * C + cb] = __fadd_rn(used[r * C + cb], res[r]);
      }
    }
    sum += (unsigned)cb;
    last = cb;
  }
  if (tid == 0) {
    a.out[0] = last;
    a.out[1] = (int)sum;
  }
}

extern "C" {

int kbt_class_floor(const FloorArgs* args, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (args->nthreads < 32 || args->nthreads > FLOOR_MAX_THREADS || args->nthreads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(class_floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, args->smem_bytes);
  if (err != cudaSuccess) return (int)err;
  class_floor_kernel<<<1, args->nthreads, args->smem_bytes, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

const char* kbt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
