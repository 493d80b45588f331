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
// iteration costs its latency: the sweep over the slots, the arg-max's
// reductions and barrier, and the dependent loads of the pop and the
// update.
//
// What the design does about it:
//   - One persistent CTA of one thread per slot (128 to 1,024 threads, a
//     stride past 1,024 slots) runs every iteration of the segment, so an
//     iteration costs a sweep and one __syncthreads instead of a host
//     round trip. The segment budget and the slot count are arguments: a
//     re-bucket or a new budget never rebuilds the kernel.
//   - The slots' working state (idle, releasing and used rows, pod count,
//     port mask, multiplicity, tie row, member cursor, and the statics the
//     sweep reads) lives in shared memory where it fits, (3R + 11) words a
//     slot (ops/class_solve.py slot_words), else in a global scratch
//     buffer (the second instantiation). The full statics (allocatable
//     rows, the InterPodAffinity columns, flags) stay in the state's
//     global arrays, written there when a slot splits.
//   - Owner-thread updates: slot c is swept by thread c % blockDim.x
//     alone, and only that thread writes it, so the writes of one
//     iteration reach the next sweep without a second barrier. A split
//     writes the child slot from the owner of the child (reading the
//     parent's row, which nothing writes in that iteration) and the
//     parent's multiplicity, tie row and cursor from the owner of the
//     parent. The arg-max's records carry the winner's tie row and its
//     fits-idle and multiplicity bits, so every thread takes the same
//     decision from registers.
//   - The loop's scalars (iteration, step, current job, its task pointer
//     and ready count, free slot, active-job count) live in every
//     thread's registers, computed redundantly, as in kernel B1. Queue and
//     job selection are B1's (csrc/fused_solve.cu), with the job and queue
//     ranks as explicit keys; the job and queue vectors stay in the
//     state's global arrays, written by one thread each, read after the
//     selection's barrier.
// An overflowing iteration (a split with no free slot) commits nothing:
// the kernel stops with `overflow` set and the host re-buckets.
//
// Numerics: built with -fmad=false and without fast math, with explicit
// round-to-nearest intrinsics, so every float32 operation rounds as the
// plain version's does; the score is summed in the reference's order,
// ((least * w_least + balanced * w_balanced) + affinity * w_aff) +
// pod_affinity * w_podaff. Selection is the largest score (-0.0 and +0.0
// tie), then the lowest tie row, then the lowest slot.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "node_sweep.cuh"

#define MAX_THREADS 1024
#define MAX_WARPS (MAX_THREADS / 32)

typedef unsigned char u8;

extern "C" {

// Mirror of ops/class_solve.py::_Args (same field order). Every array is
// row-major as ClassSolveState and the encoder lay it out; bool arrays
// are one byte per element.
struct ClassArgs {
  int T, N, J, Q, C, GT, GN, R, P, max_iter, drf, proportion, seg_budget;
  // the working state's bytes, in shared memory (in_smem 1) or in `scratch`
  int in_smem, smem_bytes, nthreads;
  float w_least, w_balanced, w_aff, w_podaff;
  // the segment's read-only inputs
  const float *task_req, *task_res;  // [T, R]
  const int* task_gid;
  const u8 *task_has_sc, *task_res_has_sc, *task_host_only, *task_ports;  // task_ports [T, P]
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

// The working state, slot-major rows ([R][C] for the resource rows), in
// this order; `end` is one past it (checked against the launch's size).
struct Work {
  float *idle, *rel, *used;
  int *ntasks, *nports, *mult, *tie, *pos;
  float *cap0, *cap1;
  int *ok, *nmax, *flags, *gid;  // flags: bit 0 idle scalar map, bit 1 releasing
  int* qcount;
  int* end;
};

__device__ __forceinline__ Work work_layout(int* w, int C, int Q, int R) {
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
  p.cap0 = reinterpret_cast<float*>(i); i += C;
  p.cap1 = reinterpret_cast<float*>(i); i += C;
  p.ok = i; i += C;
  p.nmax = i; i += C;
  p.flags = i; i += C;
  p.gid = i; i += C;
  p.qcount = i; i += Q;
  p.end = i;
  return p;
}

// share(alloc, denom): 0/0 -> 0, x/0 -> 1 (helpers.go:43-60).
__device__ __forceinline__ float share_of(float alloc, float denom) {
  if (denom == 0.0f) return alloc != 0.0f ? 1.0f : 0.0f;
  return __fdiv_rn(alloc, denom);
}

// The largest share over the masked dims of one [R] row, at least 0.
__device__ __forceinline__ float row_share(const float* alloc, const float* denom, const u8* dims, int R) {
  float s = -INFINITY;
  for (int r = 0; r < R; ++r)
    if (dims[r] != 0) s = fmaxf(s, share_of(alloc[r], denom[r]));
  return fmaxf(s, 0.0f);
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

// Slot candidate: higher score wins, then the lower tie row, then the
// lower slot. `bits`: bit 0 the slot fits on idle capacity, bit 1 it holds
// more than one member (an assignment splits it).
struct __align__(16) Rec {
  float score;
  int tie, idx, bits;
};

__device__ __forceinline__ bool rec_better(const Rec& a, const Rec& b) {
  if (a.idx == NONE) return false;
  if (b.idx == NONE) return true;
  if (a.score != b.score) return a.score > b.score;
  if (a.tie != b.tie) return a.tie < b.tie;
  return a.idx < b.idx;
}

__device__ __forceinline__ Rec warp_max_rec(const Rec& b) {
  const unsigned full = 0xffffffffu;
  const Rec none = {-INFINITY, INT_MAX, NONE, 0};
  const bool valid = b.idx != NONE;
  const int key = valid ? score_key(b.score) : INT_MIN;
  const int top = __reduce_max_sync(full, key);
  bool m = valid && key == top;
  const unsigned tie = __reduce_min_sync(full, m ? (unsigned)b.tie : UINT_MAX);
  m = m && (unsigned)b.tie == tie;
  const unsigned idx = __reduce_min_sync(full, m ? (unsigned)b.idx : (unsigned)NONE);
  if (idx == (unsigned)NONE) return none;
  const int src = __ffs(__ballot_sync(full, m && (unsigned)b.idx == idx)) - 1;
  Rec o;
  o.score = __shfl_sync(full, b.score, src);
  o.tie = (int)tie;
  o.idx = (int)idx;
  o.bits = __shfl_sync(full, b.bits, src);
  return o;
}

__device__ __forceinline__ Rec block_max_rec(Rec r, Rec (*scratch)[MAX_WARPS], unsigned phase) {
  r = warp_max_rec(r);
  Rec* buf = scratch[phase & 1];
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = r;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  return warp_max_rec(lane < (int)(blockDim.x >> 5) ? buf[lane] : Rec{-INFINITY, INT_MAX, NONE, 0});
}

// The popped task, as the sweep reads it.
struct Task {
  float req[R8], res[R8];
  bool has_sc;
  int tports, gid;
};

template <bool kSmem>
__global__ void __launch_bounds__(MAX_THREADS, 1) class_step_kernel(const ClassArgs a) {
  __shared__ Key key_scratch[2][MAX_WARPS];
  __shared__ Rec rec_scratch[2][MAX_WARPS];
  extern __shared__ __align__(16) int smem[];

  const int tid = threadIdx.x, nt = blockDim.x;
  const int T = a.T, N = a.N, J = a.J, Q = a.Q, C = a.C, GN = a.GN, R = a.R, P = a.P;
  int* base = kSmem ? smem : a.scratch;
  const Work w = work_layout(base, C, Q, R);
  // the layout's extent against the size the launch was given
  if ((w.end - base) * 4 != a.smem_bytes) __trap();

  // -- load the slots' working state -------------------------------------
  for (int c = tid; c < C; c += nt) {
    for (int r = 0; r < R; ++r) {
      w.idle[r * C + c] = a.cidle[c * R + r];
      w.rel[r * C + c] = a.crel[c * R + r];
      w.used[r * C + c] = a.cused[c * R + r];
    }
    int mask = 0;
    for (int p = 0; p < P; ++p)
      if (a.cnports[c * P + p] != 0) mask |= 1 << p;
    w.ntasks[c] = a.cntasks[c];
    w.nports[c] = mask;
    w.mult[c] = a.cmult[c];
    w.tie[c] = a.ctie[c];
    w.pos[c] = a.cpos[c];
    w.cap0[c] = a.calloc[c * R];
    w.cap1[c] = a.calloc[c * R + 1];
    w.ok[c] = a.cok[c];
    w.nmax[c] = a.cmax_tasks[c];
    w.flags[c] = (a.cidle_has_sc[c] != 0 ? 1 : 0) | (a.crel_has_sc[c] != 0 ? 2 : 0);
    w.gid[c] = a.cgid[c];
  }
  for (int q = tid; q < Q; q += nt) w.qcount[q] = 0;
  __syncthreads();
  int n_active = 0;
  for (int j0 = 0; j0 < J; j0 += nt) {
    const int j = j0 + tid;
    const bool act = j < J && a.job_active[j] != 0;
    if (act) atomicAdd(&w.qcount[a.job_queue[j]], 1);
    n_active += __syncthreads_count(act);
  }
  float eps[R8];  // the per-dim tolerances, in registers for the whole segment
#pragma unroll
  for (int r = 0; r < R8; ++r) eps[r] = r < R ? a.eps[r] : 0.0f;

  // the loop's scalars, in every thread's registers
  int it = a.it[0], step = a.step[0], cur = a.cur[0], free_ptr = a.free_ptr[0];
  int seg_it = 0, paused = -1;
  bool overflow = false;
  int tptr = cur >= 0 ? a.ptr[cur] : 0, ready = cur >= 0 ? a.ready_cnt[cur] : 0;
  unsigned key_phase = 0, rec_phase = 0;

  while ((cur >= 0 || n_active > 0) && it < a.max_iter && seg_it < a.seg_budget && paused < 0) {
    const int cur0 = cur;  // an overflowing iteration leaves it as it was
    if (cur < 0) {
      __syncthreads();  // the job and queue writes of earlier iterations are visible
      // -- queue: lex arg-min of (proportion share, rank) over live queues,
      // by every warp on its own (lanes stride over the queues)
      Key kq = {0, 0, 0.0f, 0, NONE};
      for (int q = tid & 31; q < Q; q += 32) {
        if (w.qcount[q] <= 0 || a.q_dropped[q] != 0) continue;
        Key k = {0, 0, 0.0f, a.queue_rank[q], q};
        if (a.proportion) k.share = row_share(a.q_alloc + q * R, a.q_deserved + q * R, a.q_dims + q * R, R);
        if (key_less(k, kq)) kq = k;
      }
      kq = warp_min_key(kq);
      const bool q_any = kq.idx != NONE;
      const int qsel = q_any ? kq.idx : 0;

      // -- overused gate: deserved <= allocated with the Go nil-scalar-map
      // branch (proportion.go:188-199), the same verdict in every thread
      bool overused = false;
      if (a.proportion && q_any) {
        overused = true;
        const bool has_sc = a.q_alloc_has_sc[qsel] != 0;
        for (int r = 0; r < R; ++r) {
          if (a.q_dims[qsel * R + r] == 0) continue;
          const float d = a.q_deserved[qsel * R + r], al = a.q_alloc[qsel * R + r];
          bool ok = (d < al) || (fabsf(__fsub_rn(al, d)) < eps[r]);
          if (r >= 2) ok = ok && has_sc;
          overused = overused && ok;
        }
      }

      if (q_any && overused) {
        // the overused queue retires all its jobs for the cycle (no job is
        // current after it, so this iteration cannot overflow)
        for (int j = tid; j < J; j += nt)
          if (a.job_queue[j] == qsel) a.job_active[j] = 0;
        n_active -= w.qcount[qsel];
        __syncthreads();  // every thread has read qcount[qsel]
        if (tid == 0) {
          a.q_dropped[qsel] = 1;
          w.qcount[qsel] = 0;
        }
      } else if (q_any) {
        // -- job: lex arg-min of (-priority, gang-ready, drf share, rank)
        Key kj = {0, 0, 0.0f, 0, NONE};
        for (int j = tid; j < J; j += nt) {
          if (a.job_active[j] == 0 || a.job_queue[j] != qsel) continue;
          Key k = {-a.job_prio[j], a.ready_cnt[j] >= a.job_min[j] ? 1 : 0, 0.0f, a.job_rank[j], j};
          if (a.drf) k.share = row_share(a.job_alloc + j * R, a.drf_total, a.drf_dims, R);
          if (key_less(k, kj)) kj = k;
        }
        kj = block_min_key(kj, key_scratch, key_phase++);
        if (kj.idx != NONE) {
          cur = kj.idx;
          tptr = a.ptr[cur];
          ready = a.ready_cnt[cur];
        }
      }
    }

    // -- pop the current job's next pending task (every thread, O(1)) ----
    int t = 0;
    bool t_any = false;
    if (cur >= 0) {
      t = tptr;
      t_any = t < a.job_end[cur];
    }
    t = min(t, T - 1);
    const bool drop = cur >= 0 && !t_any;
    const bool pause = t_any && a.task_host_only[t] != 0;
    const bool proc = t_any && !pause;

    Task task;
    Rec best = {-INFINITY, INT_MAX, NONE, 0};
    if (proc) {
#pragma unroll
      for (int r = 0; r < R8; ++r) {
        task.req[r] = r < R ? a.task_req[t * R + r] : 0.0f;
        task.res[r] = r < R ? a.task_res[t * R + r] : 0.0f;
      }
      task.has_sc = a.task_has_sc[t] != 0;
      task.gid = a.task_gid[t];
      task.tports = 0;
      for (int p = 0; p < P; ++p)
        if (a.task_ports[t * P + p] != 0) task.tports |= 1 << p;
      const u8* compat_t = a.compat + (size_t)task.gid * GN;
      const float* aff_t = a.aff_sc + (size_t)task.gid * GN;
      const float* pod_t = a.cpod_sc + (size_t)task.gid * C;
      // -- fit + score over this thread's slots -------------------------
      for (int c = tid; c < C; c += nt) {
        if (w.mult[c] <= 0) continue;
        const int flags = w.flags[c];
        bool fi = !(task.has_sc && (flags & 1) == 0);
        bool fr = !(task.has_sc && (flags & 2) == 0);
#pragma unroll
        for (int r = 0; r < R8; ++r) {
          if (r >= R) break;
          fi = fi & (task.req[r] < __fadd_rn(w.idle[r * C + c], eps[r]));
          fr = fr & (task.req[r] < __fadd_rn(w.rel[r * C + c], eps[r]));
        }
        const int g = w.gid[c];
        if (w.ok[c] == 0 || compat_t[g] == 0 || w.ntasks[c] >= w.nmax[c] || (w.nports[c] & task.tports) != 0 ||
            !(fi || fr))
          continue;
        const float req_c = __fadd_rn(w.used[c], task.res[0]);
        const float req_m = __fadd_rn(w.used[C + c], task.res[1]);
        const float cap_c = w.cap0[c], cap_m = w.cap1[c];
        const int least = (least_dim(req_c, cap_c) + least_dim(req_m, cap_m)) / 2;
        const int bal = balanced_score(req_c, req_m, cap_c, cap_m);
        const float s = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn((float)least, a.w_least), __fmul_rn((float)bal, a.w_balanced)),
                      __fmul_rn(aff_t[g], a.w_aff)),
            __fmul_rn(pod_t[c], a.w_podaff));
        const Rec cand = {s, w.tie[c], c, (fi ? 1 : 0) | (w.mult[c] > 1 ? 2 : 0)};
        if (rec_better(cand, best)) best = cand;
      }
      best = block_max_rec(best, rec_scratch, rec_phase++);
    }

    const bool any_cand = best.idx != NONE;
    const bool abandon = proc && !any_cand;  // serial `break`
    const bool ns = proc && any_cand && (best.bits & 2) != 0;  // the assignment splits its slot
    if (ns && free_ptr >= C) {
      overflow = true;  // no free slot: stop without committing the iteration
      cur = cur0;
      break;
    }
    const bool assign = proc && any_cand;
    const bool do_alloc = assign && (best.bits & 1) != 0;
    if (assign) {
      const int cb = best.idx, nb = best.tie;
      if (!ns) {
        if (cb % nt == tid) {  // multiplicity 1: the slot is the node
#pragma unroll
          for (int r = 0; r < R8; ++r) {
            if (r >= R) break;
            w.idle[r * C + cb] = __fadd_rn(w.idle[r * C + cb], do_alloc ? -task.res[r] : 0.0f);
            w.rel[r * C + cb] = __fadd_rn(w.rel[r * C + cb], do_alloc ? 0.0f : -task.res[r]);
            w.used[r * C + cb] = __fadd_rn(w.used[r * C + cb], task.res[r]);
          }
          w.ntasks[cb] += 1;
          w.nports[cb] |= task.tports;
        }
      } else {
        const int f = free_ptr;
        if (f % nt == tid) {  // the child: the parent's row with the task applied
#pragma unroll
          for (int r = 0; r < R8; ++r) {
            if (r >= R) break;
            w.idle[r * C + f] = __fadd_rn(w.idle[r * C + cb], do_alloc ? -task.res[r] : 0.0f);
            w.rel[r * C + f] = __fadd_rn(w.rel[r * C + cb], do_alloc ? 0.0f : -task.res[r]);
            w.used[r * C + f] = __fadd_rn(w.used[r * C + cb], task.res[r]);
          }
          w.ntasks[f] = w.ntasks[cb] + 1;
          w.nports[f] = w.nports[cb] | task.tports;
          w.cap0[f] = w.cap0[cb];
          w.cap1[f] = w.cap1[cb];
          w.ok[f] = w.ok[cb];
          w.nmax[f] = w.nmax[cb];
          w.flags[f] = w.flags[cb];
          w.gid[f] = w.gid[cb];
          w.mult[f] = 1;
          w.tie[f] = nb;
          for (int r = 0; r < R; ++r) a.calloc[f * R + r] = a.calloc[cb * R + r];
          a.cok[f] = a.cok[cb];
          a.cmax_tasks[f] = a.cmax_tasks[cb];
          a.cidle_has_sc[f] = a.cidle_has_sc[cb];
          a.crel_has_sc[f] = a.crel_has_sc[cb];
          a.cgid[f] = a.cgid[cb];
          for (int g = 0; g < a.GT; ++g) a.cpod_sc[g * C + f] = a.cpod_sc[g * C + cb];
        }
        if (cb % nt == tid) {  // the parent: one member fewer, the next lowest row
          w.mult[cb] -= 1;
          w.tie[cb] = a.members_sorted[min(w.pos[cb] + 1, N - 1)];
          w.pos[cb] += 1;
        }
        free_ptr += 1;
      }
      // the job, queue and task vectors, by one lane in each of three warps
      if (tid == 0) {
        a.assigned_node[t] = nb;
        a.assigned_kind[t] = do_alloc ? 1 : 2;
        a.assign_pos[t] = step;
      }
      if (tid == 32 && a.drf) {
        for (int r = 0; r < R; ++r) a.job_alloc[cur * R + r] = __fadd_rn(a.job_alloc[cur * R + r], task.res[r]);
      }
      if (tid == 64 && a.proportion) {
        const int qc = a.job_queue[cur];
        for (int r = 0; r < R; ++r) a.q_alloc[qc * R + r] = __fadd_rn(a.q_alloc[qc * R + r], task.res[r]);
        if (a.task_res_has_sc[t] != 0) a.q_alloc_has_sc[qc] = 1;
      }
    }
    if (do_alloc) ready += 1;
    if (proc) {
      tptr += 1;
      if (tid == 0) {
        a.ptr[cur] = tptr;
        a.ready_cnt[cur] = ready;
      }
    }
    int cur_next = cur;
    if (drop || abandon) {
      if (tid == 0) {
        a.job_active[cur] = 0;
        w.qcount[a.job_queue[cur]] -= 1;
      }
      n_active -= 1;
      cur_next = -1;
    } else if (proc && ready >= a.job_min[cur]) {
      cur_next = -1;  // gang barrier: the job re-queues
    }
    it += 1;
    seg_it += 1;
    step += assign ? 1 : 0;
    cur = cur_next;
    paused = pause ? t : -1;
  }

  // -- write the working state back ---------------------------------------
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

// Launch one segment on `stream` of `device`; returns the first failing
// call's cudaError_t (0 on success).
int kbt_class_step(const ClassArgs* args, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (args->nthreads < 128 || args->nthreads > MAX_THREADS || args->nthreads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (args->in_smem) {
    err = cudaFuncSetAttribute(class_step_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               args->smem_bytes);
    if (err != cudaSuccess) return (int)err;
    class_step_kernel<true><<<1, args->nthreads, args->smem_bytes, (cudaStream_t)stream>>>(*args);
  } else {
    class_step_kernel<false><<<1, args->nthreads, 0, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

const char* kbt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
