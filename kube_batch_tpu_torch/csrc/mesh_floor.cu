// A probe, not a kernel of the port: the latency of kernel B4's exchange
// between cards (csrc/mesh_solve.cu), launched only by chip_smoke.py,
// which adds it to B1's per-iteration floor to make B4's bound.
//
// Every placing iteration of B4 ends with one exchange: each card writes
// its 16-byte record into its slot on every card's buffer over NVLink, a
// system-scope fence, the stamps, then every warp polls its own card's
// stamps until all m have arrived and reduces the records. Nothing of a
// later iteration can start before that, so no design that keeps the
// exchange inside the kernel can pay less per iteration than this probe:
// the same writes, fence, stamps, polls and warp reduction, repeated
// `iterations` times with nothing else in the loop, one CTA of NT threads
// on each card, launched on every card before any is waited on. It uses
// B4's buffer layout and stamp protocol, with its own epoch; the caller
// enables peer access between the cards first (ops/mesh_solve.py
// enable_peer_access).
//
// With K > 0 it times one round of B4's K-deep batched exchange instead:
// thread c < m writes K 16-byte records and the count into this card's
// slot on card c, fences and stamps; every warp polls its own buffer's
// stamps, then copies its share of every card's 2K record slots into
// shared memory with 16-byte system-scope loads, as B4 stages a round's
// records; after a barrier lane c reads card c's count and its K records
// from shared memory, one after another, as a replay that consumes every
// record would.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "node_sweep.cuh"

#define NT 512
#define MAX_CARDS 8
#define REC 4
#define BATCH_MAX 64                     // as csrc/mesh_solve.cu
#define SLOT (REC + 2 * BATCH_MAX * REC)  // one card's records of a round: chain, then round-start
#define BATCH_OFF (2 * MAX_CARDS * REC)  // the rounds' slots

extern "C" {

// Mirror of chip_smoke.py's MeshFloorArgs (same order).
struct MeshFloorArgs {
  int m, card, iterations, timeout_ms;
  unsigned epoch;
  int K;                 // 0: B4's exchange at K = 1; 1..BATCH_MAX: a round of K records
  int* xbuf[MAX_CARDS];  // each card's exchange buffer (ops/mesh_solve.py XBUF_WORDS words)
  int* out;              // [2]: exchanges completed, the sum of the winners' rows
};

}  // extern "C"

__device__ __forceinline__ unsigned floor_ld_acquire(const int* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int floor_ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.sys.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int4 floor_ld_relaxed_v4(const int* p) {
  int4 v;
  asm volatile("ld.relaxed.sys.global.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

__global__ void __launch_bounds__(NT, 1) mesh_floor_kernel(const MeshFloorArgs a) {
  __shared__ int4 stage[MAX_CARDS * 2 * BATCH_MAX];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int* mine = a.xbuf[a.card];
  int sum = 0, done = 0;
  bool late = false;  // this warp's poll ran past the bound
  for (int n = 0; n < a.iterations; ++n) {
    const unsigned stamp = a.epoch + (unsigned)n + 1u;
    const int par = n & 1;
    // as B4's cluster arg-max, a barrier before the card's record is
    // known; every warp leaves together once any ran past the bound
    if (__syncthreads_or(late)) break;
    if (a.K > 0) {  // one round of K-deep records
      if (threadIdx.x < a.m) {
        int* s = a.xbuf[threadIdx.x] + BATCH_OFF + (par * MAX_CARDS + a.card) * SLOT;
        for (int d = 0; d < a.K; ++d)
          *reinterpret_cast<int4*>(s + REC + d * REC) =
              make_int4(__float_as_int((float)((n * 7 + d + a.card) % 11)), a.card * 1000 + (n + d) % 1000, 0, d);
        s[1] = a.K;
        __threadfence_system();
        asm volatile("st.relaxed.sys.global.s32 [%0], %1;\n" ::"l"(s), "r"((int)stamp) : "memory");
      }
      const int* slot = mine + BATCH_OFF + (par * MAX_CARDS + lane) * SLOT;
      unsigned long long t0 = 0;
      for (unsigned spins = 1;; ++spins) {
        const unsigned s = lane < a.m ? floor_ld_acquire(slot) : stamp;
        if (__all_sync(full, s == stamp)) break;
        if ((spins & 255u) == 0) {
          unsigned long long now;
          asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
          if (t0 == 0) {
            t0 = now;
          } else if (now - t0 > 1000000ull * (unsigned long long)a.timeout_ms) {
            late = true;
            break;
          }
        }
      }
      if (!late) {
        __syncwarp();
        const int per_card = 2 * a.K;
        for (int e = threadIdx.x; e < a.m * per_card; e += NT) {
          const int c = e / per_card, j = e - c * per_card;
          stage[e] = floor_ld_relaxed_v4(mine + BATCH_OFF + (par * MAX_CARDS + c) * SLOT + REC +
                                         (j < a.K ? j : BATCH_MAX + j - a.K) * REC);
        }
      }
      const int nrec = !late && lane < a.m ? floor_ld_relaxed(slot + 1) : 0;
      if (__syncthreads_or(late)) break;  // the staged records, as B4's settle barrier orders them
      for (int d = 0; d < a.K; ++d) {
        Best rec = {-INFINITY, NONE, 0, 0};
        if (d < nrec) {
          const int4 r = stage[lane * 2 * a.K + d];
          rec.idx = r.y;
          rec.score = __int_as_float(r.x);
          rec.fits = r.z;
          sum += r.w;  // the key, read as a replay reads it
        }
        sum += warp_max_best(rec).idx;
      }
      done = n + 1;
      continue;
    }
    if (threadIdx.x == 0) {
      const int off = (par * MAX_CARDS + a.card) * REC;
      for (int c = 0; c < a.m; ++c) {
        int* r = a.xbuf[c] + off;
        r[0] = __float_as_int((float)((n * 7 + a.card) % 11));
        r[1] = a.card * 1000 + (n % 1000);
        r[2] = n & 1;
      }
      __threadfence_system();
      for (int c = 0; c < a.m; ++c)
        asm volatile("st.relaxed.sys.global.s32 [%0], %1;\n" ::"l"(a.xbuf[c] + off + 3), "r"((int)stamp)
                     : "memory");
    }
    const int* slot = mine + (par * MAX_CARDS + lane) * REC;
    unsigned long long t0 = 0;
    for (unsigned spins = 1;; ++spins) {
      const unsigned s = lane < a.m ? floor_ld_acquire(slot + 3) : stamp;
      if (__all_sync(full, s == stamp)) break;
      if ((spins & 255u) == 0) {
        unsigned long long now;
        asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
        if (t0 == 0) {
          t0 = now;
        } else if (now - t0 > 1000000ull * (unsigned long long)a.timeout_ms) {
          late = true;
          break;
        }
      }
    }
    if (late) continue;
    Best rec = {-INFINITY, NONE, 0, 0};
    if (lane < a.m) {
      rec.idx = floor_ld_relaxed(slot + 1);
      rec.score = __int_as_float(floor_ld_relaxed(slot));
      rec.fits = floor_ld_relaxed(slot + 2);
    }
    sum += warp_max_best(rec).idx;
    done = n + 1;
  }
  if (threadIdx.x == 0) {
    a.out[0] = done;
    a.out[1] = sum;
  }
}

extern "C" {

// Launch the probe's CTA on `stream` of `device`; returns the launch's
// cudaError_t (0 on success).
int kbt_mesh_floor(const MeshFloorArgs* args, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  mesh_floor_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

const char* kbt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
