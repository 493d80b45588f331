// Kernel B3's own helpers (csrc/class_step.cu): the packed task row, the
// slot arg-max as one 64-bit key with its payload, and the cp.async copies
// of the task-row ring and of a split's next member row.

#pragma once

#include <cuda_runtime.h>

#include "node_sweep.cuh"

// The flags word of a packed task row (ops/class_solve.py pack_tasks).
#define TASK_HAS_SC 1
#define TASK_RES_HAS_SC 2
#define TASK_HOST_ONLY 4

// The popped task, as the sweep reads it (req and res padded to R8).
struct Task {
  float req[R8], res[R8];
  int gid, flags, tports;
};

// One packed row [req[R], res[R] (float bits), gid, flags, port mask] into
// registers.
__device__ __forceinline__ void read_row(Task& t, const int* row, int R) {
#pragma unroll
  for (int r = 0; r < R8; ++r) {
    t.req[r] = r < R ? __int_as_float(row[r]) : 0.0f;
    t.res[r] = r < R ? __int_as_float(row[R + r]) : 0.0f;
  }
  t.gid = row[2 * R];
  t.flags = row[2 * R + 1];
  t.tports = row[2 * R + 2];
}

// A slot candidate: the 64-bit key (hi: the score's order, -0.0 and +0.0
// on one key; lo: the tie row inverted, so a larger key is the higher
// score, then the lower tie row; lo == 0 for no candidate) and the payload
// (the slot and its two bits).
#define PICK_SLOT 0x1fffffff
#define PICK_SPLITS (1 << 29)  // multiplicity above 1: the assignment splits the slot
#define PICK_FITS_IDLE (1 << 30)

struct __align__(16) SlotPick {
  unsigned hi, lo;
  int pay, pad;
};

__device__ __forceinline__ SlotPick slot_pick(float score, int tie, int c, bool fits_idle, bool splits) {
  return SlotPick{(unsigned)score_key(score) ^ 0x80000000u, ~(unsigned)tie,
                  c | (fits_idle ? PICK_FITS_IDLE : 0) | (splits ? PICK_SPLITS : 0), 0};
}

// Strictly better; on an equal key the first one stays (the lower slot of
// a thread's ascending walk). Live slots' tie rows are distinct, so two
// live candidates never share a key.
__device__ __forceinline__ bool pick_better(const SlotPick& a, const SlotPick& b) {
  return a.hi > b.hi || (a.hi == b.hi && a.lo > b.lo);
}

// Warp arg-max, returned to every lane: the largest high word, the largest
// low word among the lanes that hold it, the payload from the lowest such
// lane.
__device__ __forceinline__ SlotPick warp_max_pick(const SlotPick& p) {
  const unsigned full = 0xffffffffu;
  const unsigned hi = __reduce_max_sync(full, p.hi);
  const unsigned lo = __reduce_max_sync(full, p.hi == hi ? p.lo : 0u);
  const int src = __ffs(__ballot_sync(full, p.hi == hi && p.lo == lo)) - 1;
  return SlotPick{hi, lo, __shfl_sync(full, p.pay, src), 0};
}

// Block arg-max, returned to every thread, with one __syncthreads: each
// warp's record into `buf` (double-buffered by the caller's phase), then
// the warp level over the records.
__device__ __forceinline__ SlotPick block_max_pick(SlotPick p, SlotPick* buf) {
  p = warp_max_pick(p);
  const int lane = threadIdx.x & 31;
  if (lane == 0) buf[threadIdx.x >> 5] = p;
  __syncthreads();
  return warp_max_pick(lane < (int)(blockDim.x >> 5) ? buf[lane] : SlotPick{0u, 0u, 0, 0});
}

// cp.async: global to shared memory without the registers; a thread's
// copies complete at its own wait and reach the other threads through the
// barrier after it.
__device__ __forceinline__ void cp_async_16(void* smem_dst, const void* gmem_src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(gmem_src) : "memory");
}

__device__ __forceinline__ void cp_async_4(void* smem_dst, const void* gmem_src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(gmem_src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// 16-byte chunk `chunk` of packed task row `row` into `dst`.
__device__ __forceinline__ void ring_copy(int* dst, const int* pack, int words, int row, int chunk) {
  cp_async_16(dst, pack + (size_t)row * words + 4 * chunk);
}
