// One class-compressed solve segment in one launch, for Hopper (sm_90a).
//
// Replaces kube_batch_tpu/ops/class_solve.py::_class_step (an XLA
// lax.while_loop over node-equivalence classes, not a Pallas kernel).
// Plain version: ops/class_solve.py class_step_plain, which follows the
// reference body for body; this kernel reproduces it field for field.
//
// What bounds it: a segment is a chain of up to cpad / 2 dependent
// iterations (each assignment changes the slot state the next decision
// reads); an iteration touches only the slot axis (cpad slots, 1,024 on a
// large uniform fleet) plus, when no job is current, the job and queue
// vectors. The bytes and operations are far below the card's rates, so an
// iteration costs its latency. Its floor is what any single-CTA design
// pays an iteration (the probe csrc/class_floor.cu): a task row read from
// shared memory, each slot's row read and scored from shared memory, a
// block arg-max with one barrier, an owner write. Above the floor are the
// dependent loads from global memory (L2 round trips of about 0.4 us),
// the sweep's arithmetic, the reductions' instruction chains and, on a
// gang's second half (every assignment past its minimum re-queues the
// job), a job selection every iteration.
//
// What the design does about it:
//   - One persistent CTA runs every iteration of the segment, so an
//     iteration costs a sweep and one __syncthreads instead of a host
//     round trip. The segment budget and the slot count are arguments: a
//     re-bucket or a new budget never rebuilds the kernel.
//   - The sweep reads only shared memory. The slots' working state (idle,
//     releasing and used rows, pod count, port mask, multiplicity, tie
//     row, member cursor, the next member's row, the statics the sweep
//     reads, the slot it split from) and, per slot and task group, the
//     compat bit, the affinity score and the InterPodAffinity column are
//     staged at the prologue, (3R + 11 + 3GT) words a slot
//     (ops/class_solve.py slot_words). A slot's group is fixed within a
//     segment (a split copies it), so the per-slot gathers of compat,
//     affinity and pod-affinity rows leave global memory; a split writes
//     the child's staged entries from the parent's. The full statics of a
//     split's child (allocatable rows, flags, group, pod-affinity column)
//     are copied in global memory at the epilogue, from the original slot
//     it came from, off the iteration's path.
//   - The job and queue tables in shared memory too: per job its active
//     bit, queue, priority, ready count, gang minimum, rank, task pointer
//     and end, drf row and drf share, per queue its counts, rows, share
//     and overused verdict. The shares and the verdict are computed once
//     per selection, for the one job and queue whose rows changed, by the
//     lanes that add to the rows, not divided out for every job at every
//     selection. A selection reads no global memory, nor does the
//     update; the epilogue writes the tables back. Past the shared-memory
//     budget the whole working state lives in a global scratch buffer
//     (the second instantiation).
//   - Task rows prefetched. The wrapper packs each task's row once (its
//     request and resource rows, group, flags and port bitmask, 16-byte
//     aligned, ops/class_solve.py pack_tasks). Between gang barriers the
//     current job's pending tasks are contiguous, so the first threads of
//     the last warp keep the next RING - 1 rows in flight into a
//     shared-memory ring with cp.async: row t + RING - 1 is issued while
//     row t sweeps, and the pop reads shared memory. A job selection fills
//     the ring (one round trip). A split's next member row is prefetched
//     the same way (cp.async into the slot's staged next row), so the
//     parent's new tie row is a shared-memory read.
//   - Geometry without spills: 128 or 256 threads, four slots a thread up
//     to 1,024 slots (256 threads there; more a thread past it), under
//     __launch_bounds__(256, 1), so the compiler has 255 registers a
//     thread; the arg-max crosses 8 warps, not 32.
//   - A cheaper arg-max that stays exact: the order (largest score, -0.0
//     equal to +0.0, then the lowest tie row) is one 64-bit key, the score's
//     order in the high word and the tie row inverted in the low word;
//     live slots' tie rows are distinct (each is the lowest row of a
//     disjoint member set), so the key decides alone, and the winner's
//     slot and its two bits (fits idle, splits) ride beside it. A warp
//     level is two redux ops, a ballot and a shuffle; the block level one
//     16-byte store a warp into a double-buffered scratch, the barrier, and
//     the same warp level over the warps' records.
//   - Owner-thread updates: slot c is swept by thread c % blockDim.x
//     alone, and only that thread writes it, so the writes of one
//     iteration reach the next sweep without a second barrier. A split
//     writes the child slot from the owner of the child (reading the
//     parent's row, which nothing writes in that iteration) and the
//     parent's multiplicity, tie row and cursor from the owner of the
//     parent. The loop's scalars, and the current job's end, gang minimum
//     and queue, live in every thread's registers, computed redundantly, as
//     in kernel B1. Queue and job selection are B1's (csrc/fused_solve.cu),
//     with the job and queue ranks as explicit keys.
//   - The launch updates the state in place, and the host sets the
//     kernel's shared-memory attribute once per size and card.
// An overflowing iteration (a split with no free slot) commits nothing:
// the kernel stops with `overflow` set and the host re-buckets the state
// the kernel left.
//
// Numerics: built with -fmad=false and without fast math, with explicit
// round-to-nearest intrinsics, so every float32 operation rounds as the
// plain version's does; the score is summed in the reference's order,
// ((least * w_least + balanced * w_balanced) + affinity * w_aff) +
// pod_affinity * w_podaff. Selection is the largest score (-0.0 and +0.0
// tie), then the lowest tie row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "class_step.cuh"
#include "device_guard.cuh"
#include "node_sweep.cuh"

#define MAX_THREADS 256
#define MAX_WARPS (MAX_THREADS / 32)
#define RING 8  // task rows in the prefetch ring, a power of two
#define ROW_WORDS 20  // the largest packed task row: 2 * R8 + 3, rounded up to 16 bytes

typedef unsigned char u8;

extern "C" {

// Mirror of ops/class_solve.py::_Args (same field order). Every array is
// row-major as ClassSolveState and the encoder lay it out; bool arrays
// are one byte per element.
struct ClassArgs {
  int T, N, J, Q, C, GT, GN, R, P, max_iter, drf, proportion, seg_budget;
  // the working state's bytes, in shared memory (in_smem 1) or in `scratch`
  int in_smem, smem_bytes, nthreads, task_words;
  float w_least, w_balanced, w_aff, w_podaff;
  // the segment's read-only inputs
  const int* task_pack;  // [T, task_words]: ops/class_solve.py pack_tasks
  const int *job_end, *job_min, *job_queue, *job_prio, *job_rank, *queue_rank;
  const float* q_deserved;  // [Q, R]
  const u8* q_dims;  // [Q, R]
  const float* drf_total;  // [R]
  const u8* drf_dims;  // [R]
  const u8* compat;  // [GT, GN]
  const float *aff_sc, *eps;  // [GT, GN], [R]
  const int* members_sorted;  // [N]
  // ClassSolveState, in its field order
  int *it, *step, *cur, *ptr, *assigned_node, *assigned_kind, *assign_pos;
  float *cidle, *crel, *cused;  // [C, R]
  int* cntasks;
  u8* cnports;  // [C, P]
  float* calloc;  // [C, R]
  u8* cok;
  int* cmax_tasks;
  u8 *cidle_has_sc, *crel_has_sc;
  int* cgid;
  float* cpod_sc;  // [GT, C]
  int *cmult, *ctie, *cpos, *free_ptr;
  u8* overflow;
  int *seg_it, *ready_cnt;
  u8 *job_active, *q_dropped;
  float *job_alloc, *q_alloc;  // [J, R], [Q, R]
  u8* q_alloc_has_sc;
  int* paused_at;
  // smem_bytes of working state when in_smem == 0
  int* scratch;
};

}  // extern "C"

// The working state, slot-major rows ([R][C] for the resource rows,
// [GT][C] for the group tables), in this order; `end` is one past it
// (checked against the launch's size).
struct Work {
  float *idle, *rel, *used;
  int *ntasks, *nports, *mult, *tie, *pos, *next_tie;
  float *cap0, *cap1;
  int *flags, *nmax, *src;  // flags: bit 0 idle scalar map, bit 1 releasing, bit 2 static ok
  int* gcompat;  // [GT][C]: compat[g][gid[c]]
  float *gaff, *gpod;  // [GT][C]: aff_sc[g][gid[c]], cpod_sc[g][c]
  int* qcount;
  // the job table [J]: active, queue, -priority, ready count, gang minimum,
  // rank, task pointer, task end, drf share, and the drf rows [J][R]
  int *jact, *jq, *jk0, *jready, *jmin, *jrank, *jptr, *jend;
  float *jshare, *jalloc;
  // the queue table [Q]: rank, dropped, scalar-map flag, proportion share,
  // overused verdict, and the allocated, deserved and dims rows [Q][R]
  int *qrank, *qdropped, *qhas_sc, *qover;
  float* qshare;
  float *qalloc, *qdes;
  int* qdims;
  int* end;
};

__device__ __forceinline__ Work work_layout(int* w, int C, int Q, int R, int GT, int J) {
  Work p;
  float* f = reinterpret_cast<float*>(w);
  p.idle = f; f += R * C;
  p.rel = f; f += R * C;
  p.used = f; f += R * C;
  int* i = reinterpret_cast<int*>(f);
  p.ntasks = i; i += C;
  p.nports = i; i += C;
  p.mult = i; i += C;
  p.tie = i; i += C;
  p.pos = i; i += C;
  p.next_tie = i; i += C;
  p.cap0 = reinterpret_cast<float*>(i); i += C;
  p.cap1 = reinterpret_cast<float*>(i); i += C;
  p.flags = i; i += C;
  p.nmax = i; i += C;
  p.src = i; i += C;
  p.gcompat = i; i += GT * C;
  p.gaff = reinterpret_cast<float*>(i); i += GT * C;
  p.gpod = reinterpret_cast<float*>(i); i += GT * C;
  p.qcount = i; i += Q;
  p.jact = i; i += J;
  p.jq = i; i += J;
  p.jk0 = i; i += J;
  p.jready = i; i += J;
  p.jmin = i; i += J;
  p.jrank = i; i += J;
  p.jptr = i; i += J;
  p.jend = i; i += J;
  p.jshare = reinterpret_cast<float*>(i); i += J;
  p.jalloc = reinterpret_cast<float*>(i); i += J * R;
  p.qrank = i; i += Q;
  p.qdropped = i; i += Q;
  p.qhas_sc = i; i += Q;
  p.qover = i; i += Q;
  p.qshare = reinterpret_cast<float*>(i); i += Q;
  p.qalloc = reinterpret_cast<float*>(i); i += Q * R;
  p.qdes = reinterpret_cast<float*>(i); i += Q * R;
  p.qdims = i; i += Q * R;
  p.end = i;
  return p;
}

// share(alloc, denom): 0/0 -> 0, x/0 -> 1 (helpers.go:43-60).
__device__ __forceinline__ float share_of(float alloc, float denom) {
  if (denom == 0.0f) return alloc != 0.0f ? 1.0f : 0.0f;
  return __fdiv_rn(alloc, denom);
}

// The largest share over the masked dims of one [R] row, at least 0.
template <typename D>
__device__ __forceinline__ float row_share(const float* alloc, const float* denom, const D* dims, int R) {
  float s = -INFINITY;
  for (int r = 0; r < R; ++r)
    if (dims[r] != 0) s = fmaxf(s, share_of(alloc[r], denom[r]));
  return fmaxf(s, 0.0f);
}

// The proportion plugin's overused verdict for queue q: deserved <=
// allocated in every masked dim (within eps), with the Go nil-scalar-map
// branch (proportion.go:188-199).
__device__ __forceinline__ bool queue_overused(const Work& w, int q, const float* eps, int R) {
  bool overused = true;
  const bool has_sc = w.qhas_sc[q] != 0;
  for (int r = 0; r < R; ++r) {
    if (w.qdims[q * R + r] == 0) continue;
    const float d = w.qdes[q * R + r], al = w.qalloc[q * R + r];
    bool ok = (d < al) || (fabsf(__fsub_rn(al, d)) < eps[r]);
    if (r >= 2) ok = ok && has_sc;
    overused = overused && ok;
  }
  return overused;
}

// Lexicographic key for the queue and job arg-mins: (k0, k1, share, k3,
// idx), idx == NONE for "no element". Every valid idx is distinct, so the
// order is total and the lowest index wins ties on the other keys.
struct Key {
  int k0, k1;
  float share;
  int k3, idx;
};

__device__ __forceinline__ bool key_less(const Key& a, const Key& b) {
  if (a.idx == NONE) return false;
  if (b.idx == NONE) return true;
  if (a.k0 != b.k0) return a.k0 < b.k0;
  if (a.k1 != b.k1) return a.k1 < b.k1;
  if (a.share != b.share) return a.share < b.share;
  if (a.k3 != b.k3) return a.k3 < b.k3;
  return a.idx < b.idx;
}

// Warp arg-min in key_less's order, returned to every lane: one warp
// reduction per key over the lanes that tie on the keys before it. A share
// is never negative, so its bits order as unsigned (-0.0 taken as +0.0).
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
  const int k3 = __reduce_min_sync(full, tie ? k.k3 : INT_MAX);
  tie = tie && k.k3 == k3;
  const unsigned idx = __reduce_min_sync(full, tie ? (unsigned)k.idx : (unsigned)NONE);
  return Key{k0, k1, __uint_as_float(sh), k3, (int)idx};
}

// Block-wide arg-min, returned to every thread, with one __syncthreads; the
// scratch is double-buffered by the caller's phase (as B1's).
__device__ __forceinline__ Key block_min_key(Key k, Key (*scratch)[MAX_WARPS], unsigned phase) {
  k = warp_min_key(k);
  Key* buf = scratch[phase & 1];
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = k;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  return warp_min_key(lane < (int)(blockDim.x >> 5) ? buf[lane] : Key{0, 0, 0.0f, 0, NONE});
}

template <bool kSmem>
__global__ void __launch_bounds__(MAX_THREADS, 1) class_step_kernel(const ClassArgs a) {
  __shared__ Key key_scratch[2][MAX_WARPS];
  __shared__ SlotPick pick_scratch[2][MAX_WARPS];
  __shared__ __align__(16) int ring[RING][ROW_WORDS];
  __shared__ float s_drf_total[R8], s_eps[R8];
  __shared__ int s_drf_dims[R8];
  extern __shared__ __align__(16) int smem[];

  const int tid = threadIdx.x, nt = blockDim.x;
  const int N = a.N, J = a.J, Q = a.Q, C = a.C, GT = a.GT, GN = a.GN, R = a.R, P = a.P, TW = a.task_words;
  int* base = kSmem ? smem : a.scratch;
  const Work w = work_layout(base, C, Q, R, GT, J);
  // the layout's extent against the size the launch was given
  if ((w.end - base) * 4 != a.smem_bytes) __trap();
  // the producers of the task ring, one 16-byte chunk of a row each: the
  // first threads of the last warp (whose slots are rarely a split's
  // parent: a parent's owner waits for its own copies)
  const int producer = tid - (nt - 32);
  const bool is_producer = producer >= 0 && producer < TW / 4;

  // -- stage the slots' working state and group tables --------------------
  for (int c = tid; c < C; c += nt) {
    for (int r = 0; r < R; ++r) {
      w.idle[r * C + c] = a.cidle[c * R + r];
      w.rel[r * C + c] = a.crel[c * R + r];
      w.used[r * C + c] = a.cused[c * R + r];
    }
    int mask = 0;
    for (int p = 0; p < P; ++p)
      if (a.cnports[c * P + p] != 0) mask |= 1 << p;
    const int mult = a.cmult[c], pos = a.cpos[c], gid = a.cgid[c];
    w.ntasks[c] = a.cntasks[c];
    w.nports[c] = mask;
    w.mult[c] = mult;
    w.tie[c] = a.ctie[c];
    w.pos[c] = pos;
    w.next_tie[c] = mult > 1 ? a.members_sorted[min(pos + 1, N - 1)] : 0;
    w.cap0[c] = a.calloc[c * R];
    w.cap1[c] = a.calloc[c * R + 1];
    w.flags[c] = (a.cidle_has_sc[c] != 0 ? 1 : 0) | (a.crel_has_sc[c] != 0 ? 2 : 0) | (a.cok[c] != 0 ? 4 : 0);
    w.nmax[c] = a.cmax_tasks[c];
    w.src[c] = c;
    for (int g = 0; g < GT; ++g) {
      w.gcompat[g * C + c] = a.compat[(size_t)g * GN + gid];
      w.gaff[g * C + c] = a.aff_sc[(size_t)g * GN + gid];
      w.gpod[g * C + c] = a.cpod_sc[(size_t)g * C + c];
    }
  }
  // the job and queue tables, each job's drf share kept up to date from here
  for (int r = tid; r < R; r += nt) {
    s_drf_total[r] = a.drf_total[r];
    s_drf_dims[r] = a.drf_dims[r];
    s_eps[r] = a.eps[r];
  }
  for (int j = tid; j < J; j += nt) {
    w.jact[j] = a.job_active[j];
    w.jq[j] = a.job_queue[j];
    w.jk0[j] = -a.job_prio[j];
    w.jready[j] = a.ready_cnt[j];
    w.jmin[j] = a.job_min[j];
    w.jrank[j] = a.job_rank[j];
    w.jptr[j] = a.ptr[j];
    w.jend[j] = a.job_end[j];
    for (int r = 0; r < R; ++r) w.jalloc[j * R + r] = a.job_alloc[j * R + r];
    w.jshare[j] = a.drf ? row_share(a.job_alloc + j * R, a.drf_total, a.drf_dims, R) : 0.0f;
  }
  for (int q = tid; q < Q; q += nt) {
    w.qcount[q] = 0;
    w.qrank[q] = a.queue_rank[q];
    w.qdropped[q] = a.q_dropped[q];
    w.qhas_sc[q] = a.q_alloc_has_sc[q];
    for (int r = 0; r < R; ++r) {
      w.qalloc[q * R + r] = a.q_alloc[q * R + r];
      w.qdes[q * R + r] = a.q_deserved[q * R + r];
      w.qdims[q * R + r] = a.q_dims[q * R + r];
    }
  }
  __syncthreads();
  // each queue's share and overused verdict, from here on computed again
  // before a selection by the lane that adds to the queue's row
  for (int q = tid; q < Q; q += nt) {
    w.qshare[q] = row_share(w.qalloc + q * R, w.qdes + q * R, w.qdims + q * R, R);
    w.qover[q] = queue_overused(w, q, s_eps, R) ? 1 : 0;
  }
  __syncthreads();
  int n_active = 0;
  for (int j0 = 0; j0 < J; j0 += nt) {
    const int j = j0 + tid;
    const bool act = j < J && w.jact[j] != 0;
    if (act) atomicAdd(&w.qcount[w.jq[j]], 1);
    n_active += __syncthreads_count(act);
  }
  float eps[R8];  // the per-dim tolerances, in registers for the whole segment
#pragma unroll
  for (int r = 0; r < R8; ++r) eps[r] = r < R ? a.eps[r] : 0.0f;

  // the loop's scalars, in every thread's registers
  int it = a.it[0], step = a.step[0], cur = a.cur[0], free_ptr = a.free_ptr[0];
  const int free0 = free_ptr;
  int seg_it = 0, paused = -1;
  bool overflow = false;
  int tptr = 0, ready = 0, jend = 0, jmin = 0, jq = 0;
  unsigned key_phase = 0, pick_phase = 0;

  // The current job's scalars, and its next RING - 1 task rows in the ring,
  // visible to every thread on return (the rows' one round trip).
  auto take_job = [&]() {
    tptr = w.jptr[cur];
    ready = w.jready[cur];
    jend = w.jend[cur];
    jmin = w.jmin[cur];
    jq = w.jq[cur];
    if (is_producer) {
      cp_async_wait_all();  // the last job's copy in flight lands before its slot is written again
      for (int k = 0; k < RING - 1; ++k)
        if (tptr + k < jend) ring_copy(&ring[(tptr + k) & (RING - 1)][4 * producer], a.task_pack, TW, tptr + k, producer);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();
  };
  if (cur >= 0) take_job();

  while ((cur >= 0 || n_active > 0) && it < a.max_iter && seg_it < a.seg_budget && paused < 0) {
    const int cur0 = cur;  // an overflowing iteration leaves it as it was
    if (cur < 0) {
      __syncthreads();  // the job and queue writes of earlier iterations are visible
      // -- queue: lex arg-min of (proportion share, rank) over live queues,
      // by every warp on its own (lanes stride over the queues)
      Key kq = {0, 0, 0.0f, 0, NONE};
      for (int q = tid & 31; q < Q; q += 32) {
        const int count = w.qcount[q], dropped = w.qdropped[q], rank = w.qrank[q];
        const float share = w.qshare[q];
        if (count <= 0 || dropped != 0) continue;
        const Key k = {0, 0, a.proportion ? share : 0.0f, rank, q};
        if (key_less(k, kq)) kq = k;
      }
      kq = warp_min_key(kq);
      const bool q_any = kq.idx != NONE;
      const int qsel = q_any ? kq.idx : 0;

      // -- overused gate: deserved <= allocated with the Go nil-scalar-map
      // branch (proportion.go:188-199), the same verdict in every thread
      const bool overused = a.proportion && q_any && w.qover[qsel] != 0;

      if (q_any && overused) {
        // the overused queue retires all its jobs for the cycle (no job is
        // current after it, so this iteration cannot overflow)
        for (int j = tid; j < J; j += nt)
          if (w.jq[j] == qsel) w.jact[j] = 0;
        n_active -= w.qcount[qsel];
        __syncthreads();  // every thread has read qcount[qsel]
        if (tid == 0) {
          w.qdropped[qsel] = 1;
          w.qcount[qsel] = 0;
        }
      } else if (q_any) {
        // -- job: lex arg-min of (-priority, gang-ready, drf share, rank)
        Key kj = {0, 0, 0.0f, 0, NONE};
#pragma unroll 2
        for (int j = tid; j < J; j += nt) {
          // every field loaded before any test: one round of loads a job
          const int act = w.jact[j], q = w.jq[j], k0 = w.jk0[j], ready_j = w.jready[j], min_j = w.jmin[j];
          const int rank = w.jrank[j];
          const float share = w.jshare[j];
          if (act == 0 || q != qsel) continue;
          const Key k = {k0, ready_j >= min_j ? 1 : 0, a.drf ? share : 0.0f, rank, j};
          if (key_less(k, kj)) kj = k;
        }
        kj = block_min_key(kj, key_scratch, key_phase++);
        if (kj.idx != NONE) {
          cur = kj.idx;
          take_job();
        }
      }
    }

    // -- pop the current job's next pending task from the ring ------------
    const bool t_any = cur >= 0 && tptr < jend;
    const int t = min(tptr, a.T - 1);
    Task task;
    task.flags = 0;
    if (t_any) read_row(task, ring[tptr & (RING - 1)], R);
    const bool drop = cur >= 0 && !t_any;
    const bool pause = t_any && (task.flags & TASK_HOST_ONLY) != 0;
    const bool proc = t_any && !pause;

    SlotPick best = {0u, 0u, 0, 0};
    if (proc) {
      // keep the ring RING - 1 rows ahead: row t + RING - 1 goes into the
      // slot row t - 1 left, which every thread read before the last barrier
      if (is_producer) {
        if (tptr + RING - 1 < jend)
          ring_copy(&ring[(tptr + RING - 1) & (RING - 1)][4 * producer], a.task_pack, TW, tptr + RING - 1, producer);
        cp_async_commit();
      }
      const bool t_sc = (task.flags & TASK_HAS_SC) != 0;
      const int* gcompat = w.gcompat + task.gid * C;
      const float* gaff = w.gaff + task.gid * C;
      const float* gpod = w.gpod + task.gid * C;
      // -- fit + score over this thread's slots, shared memory only ----
      for (int c = tid; c < C; c += nt) {
        const int mult = w.mult[c];
        if (mult <= 0) continue;
        const int flags = w.flags[c], ntasks = w.ntasks[c], nmax = w.nmax[c], nports = w.nports[c];
        const int compat = gcompat[c];
        const float used_c = w.used[c], used_m = w.used[C + c], cap_c = w.cap0[c], cap_m = w.cap1[c];
        const float aff = gaff[c], pod = gpod[c];
        bool fi = !(t_sc && (flags & 1) == 0);
        bool fr = !(t_sc && (flags & 2) == 0);
#pragma unroll
        for (int r = 0; r < R8; ++r) {
          if (r >= R) break;
          fi = fi & (task.req[r] < __fadd_rn(w.idle[r * C + c], eps[r]));
          fr = fr & (task.req[r] < __fadd_rn(w.rel[r * C + c], eps[r]));
        }
        if ((flags & 4) == 0 || compat == 0 || ntasks >= nmax || (nports & task.tports) != 0 || !(fi || fr))
          continue;
        const float req_c = __fadd_rn(used_c, task.res[0]);
        const float req_m = __fadd_rn(used_m, task.res[1]);
        const int least = (least_dim(req_c, cap_c) + least_dim(req_m, cap_m)) / 2;
        const int bal = balanced_score(req_c, req_m, cap_c, cap_m);
        const float s = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn((float)least, a.w_least), __fmul_rn((float)bal, a.w_balanced)),
                      __fmul_rn(aff, a.w_aff)),
            __fmul_rn(pod, a.w_podaff));
        const SlotPick cand = slot_pick(s, w.tie[c], c, fi, mult > 1);
        if (pick_better(cand, best)) best = cand;
      }
      // the next row has landed (its copy was issued RING - 2 iterations ago)
      // before the barrier publishes it
      if (is_producer) cp_async_wait_group<RING - 2>();
      best = block_max_pick(best, pick_scratch[pick_phase++ & 1]);
    }

    const bool any_cand = best.lo != 0u;
    const bool abandon = proc && !any_cand;  // serial `break`
    const bool ns = proc && any_cand && (best.pay & PICK_SPLITS) != 0;  // the assignment splits its slot
    if (ns && free_ptr >= C) {
      overflow = true;  // no free slot: stop without committing the iteration
      cur = cur0;
      break;
    }
    const bool assign = proc && any_cand;
    const bool do_alloc = assign && (best.pay & PICK_FITS_IDLE) != 0;
    if (assign) {
      const int cb = best.pay & PICK_SLOT, nb = (int)~best.lo;
      if (!ns) {
        if (cb % nt == tid) {  // multiplicity 1: the slot is the node
          // every load before any store: the stores may alias, so a load
          // after one would wait for it
          float idle[R8], rel[R8], used[R8];
#pragma unroll
          for (int r = 0; r < R8; ++r) {
            if (r >= R) break;
            idle[r] = w.idle[r * C + cb];
            rel[r] = w.rel[r * C + cb];
            used[r] = w.used[r * C + cb];
          }
          const int ntasks = w.ntasks[cb], nports = w.nports[cb];
#pragma unroll
          for (int r = 0; r < R8; ++r) {
            if (r >= R) break;
            w.idle[r * C + cb] = __fadd_rn(idle[r], do_alloc ? -task.res[r] : 0.0f);
            w.rel[r * C + cb] = __fadd_rn(rel[r], do_alloc ? 0.0f : -task.res[r]);
            w.used[r * C + cb] = __fadd_rn(used[r], task.res[r]);
          }
          w.ntasks[cb] = ntasks + 1;
          w.nports[cb] = nports | task.tports;
        }
      } else {
        const int f = free_ptr;
        if (f % nt == tid) {  // the child: the parent's row with the task applied
          float idle[R8], rel[R8], used[R8];
#pragma unroll
          for (int r = 0; r < R8; ++r) {
            if (r >= R) break;
            idle[r] = w.idle[r * C + cb];
            rel[r] = w.rel[r * C + cb];
            used[r] = w.used[r * C + cb];
          }
          const int ntasks = w.ntasks[cb], nports = w.nports[cb], flags = w.flags[cb], nmax = w.nmax[cb];
          const int src = w.src[cb];
          const float cap0 = w.cap0[cb], cap1 = w.cap1[cb];
#pragma unroll
          for (int r = 0; r < R8; ++r) {
            if (r >= R) break;
            w.idle[r * C + f] = __fadd_rn(idle[r], do_alloc ? -task.res[r] : 0.0f);
            w.rel[r * C + f] = __fadd_rn(rel[r], do_alloc ? 0.0f : -task.res[r]);
            w.used[r * C + f] = __fadd_rn(used[r], task.res[r]);
          }
          w.ntasks[f] = ntasks + 1;
          w.nports[f] = nports | task.tports;
          w.cap0[f] = cap0;
          w.cap1[f] = cap1;
          w.flags[f] = flags;
          w.nmax[f] = nmax;
          w.src[f] = src;
          w.mult[f] = 1;
          w.tie[f] = nb;
          for (int g = 0; g < GT; ++g) {
            const int compat = w.gcompat[g * C + cb];
            const float aff = w.gaff[g * C + cb], pod = w.gpod[g * C + cb];
            w.gcompat[g * C + f] = compat;
            w.gaff[g * C + f] = aff;
            w.gpod[g * C + f] = pod;
          }
        }
        if (cb % nt == tid) {  // the parent: one member fewer, the next lowest row
          if (kSmem) cp_async_wait_all();  // this slot's next row, prefetched at its last split
          const int mult = w.mult[cb] - 1, pos = w.pos[cb] + 1, tie = w.next_tie[cb];
          w.mult[cb] = mult;
          w.tie[cb] = tie;
          w.pos[cb] = pos;
          if (mult > 1) {
            const int* next = a.members_sorted + min(pos + 1, N - 1);
            if (kSmem) {
              cp_async_4(&w.next_tie[cb], next);
              cp_async_commit();
            } else {
              w.next_tie[cb] = *next;
            }
          }
        }
        free_ptr += 1;
      }
      // the job, queue and task vectors, by one lane in each of three warps
      if (tid == 0) {
        a.assigned_node[t] = nb;
        a.assigned_kind[t] = do_alloc ? 1 : 2;
        a.assign_pos[t] = step;
      }
      if (tid == 32 && a.drf)
        for (int r = 0; r < R; ++r) w.jalloc[cur * R + r] = __fadd_rn(w.jalloc[cur * R + r], task.res[r]);
      if (tid == 64 && a.proportion) {
        for (int r = 0; r < R; ++r) w.qalloc[jq * R + r] = __fadd_rn(w.qalloc[jq * R + r], task.res[r]);
        if ((task.flags & TASK_RES_HAS_SC) != 0) w.qhas_sc[jq] = 1;
      }
    }
    if (do_alloc) ready += 1;
    if (proc) {
      tptr += 1;
      if (tid == 0) {
        w.jptr[cur] = tptr;
        w.jready[cur] = ready;
      }
    }
    int cur_next = cur;
    if (drop || abandon) {
      if (tid == 0) {
        w.jact[cur] = 0;
        w.qcount[jq] -= 1;
      }
      n_active -= 1;
      cur_next = -1;
    } else if (proc && ready >= jmin) {
      cur_next = -1;  // gang barrier: the job re-queues
    }
    if (cur >= 0 && cur_next < 0) {
      // a selection comes next: the job's drf share and its queue's share
      // and overused verdict, from the rows as they now stand (only the
      // current job's and queue's rows change between two selections)
      if (tid == 32 && a.drf) w.jshare[cur] = row_share(w.jalloc + cur * R, s_drf_total, s_drf_dims, R);
      if (tid == 64 && a.proportion) {
        w.qshare[jq] = row_share(w.qalloc + jq * R, w.qdes + jq * R, w.qdims + jq * R, R);
        w.qover[jq] = queue_overused(w, jq, s_eps, R) ? 1 : 0;
      }
    }
    it += 1;
    seg_it += 1;
    step += assign ? 1 : 0;
    cur = cur_next;
    paused = pause ? t : -1;
  }

  // -- write the working state back ---------------------------------------
  cp_async_wait_all();  // no copy lands in shared memory after the block exits
  __syncthreads();
  for (int c = tid; c < C; c += nt) {
    for (int r = 0; r < R; ++r) {
      a.cidle[c * R + r] = w.idle[r * C + c];
      a.crel[c * R + r] = w.rel[r * C + c];
      a.cused[c * R + r] = w.used[r * C + c];
    }
    const int mask = w.nports[c];
    for (int p = 0; p < P; ++p) a.cnports[c * P + p] = (mask >> p) & 1;
    a.cntasks[c] = w.ntasks[c];
    a.cmult[c] = w.mult[c];
    a.ctie[c] = w.tie[c];
    a.cpos[c] = w.pos[c];
  }
  // the statics of the segment's new children, from the original slot each
  // split off (which no iteration writes)
  for (int f = free0 + tid; f < free_ptr; f += nt) {
    const int s = w.src[f];
    for (int r = 0; r < R; ++r) a.calloc[f * R + r] = a.calloc[s * R + r];
    a.cok[f] = a.cok[s];
    a.cmax_tasks[f] = a.cmax_tasks[s];
    a.cidle_has_sc[f] = a.cidle_has_sc[s];
    a.crel_has_sc[f] = a.crel_has_sc[s];
    a.cgid[f] = a.cgid[s];
    for (int g = 0; g < GT; ++g) a.cpod_sc[(size_t)g * C + f] = a.cpod_sc[(size_t)g * C + s];
  }
  for (int j = tid; j < J; j += nt) {
    a.job_active[j] = (u8)w.jact[j];
    a.ready_cnt[j] = w.jready[j];
    a.ptr[j] = w.jptr[j];
    for (int r = 0; r < R; ++r) a.job_alloc[j * R + r] = w.jalloc[j * R + r];
  }
  for (int q = tid; q < Q; q += nt) {
    a.q_dropped[q] = (u8)w.qdropped[q];
    a.q_alloc_has_sc[q] = (u8)w.qhas_sc[q];
    for (int r = 0; r < R; ++r) a.q_alloc[q * R + r] = w.qalloc[q * R + r];
  }
  if (tid == 0) {
    a.it[0] = it;
    a.step[0] = step;
    a.cur[0] = cur;
    a.free_ptr[0] = free_ptr;
    a.overflow[0] = overflow ? 1 : 0;
    a.seg_it[0] = seg_it;
    a.paused_at[0] = paused;
  }
}

extern "C" {

// The largest dynamic shared memory B3 has been allowed on each card: the
// attribute is set once per larger size, not on every launch (a race
// between two launching threads sets it twice, which is harmless).
static int g_smem_allowed[64];

// Launch one segment on `stream` of `device`; returns the first failing
// call's cudaError_t (0 on success).
int kbt_class_step(const ClassArgs* args, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (args->nthreads < 128 || args->nthreads > MAX_THREADS || args->nthreads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (args->R > R8 || args->task_words < 2 * args->R + 3 || args->task_words > ROW_WORDS ||
      args->task_words % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (args->in_smem) {
    if (device < 0 || device >= 64 || g_smem_allowed[device] < args->smem_bytes) {
      const cudaError_t err = cudaFuncSetAttribute(
          class_step_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, args->smem_bytes);
      if (err != cudaSuccess) return (int)err;
      if (device >= 0 && device < 64) g_smem_allowed[device] = args->smem_bytes;
    }
    class_step_kernel<true><<<1, args->nthreads, args->smem_bytes, (cudaStream_t)stream>>>(*args);
  } else {
    class_step_kernel<false><<<1, args->nthreads, 0, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

const char* kbt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
