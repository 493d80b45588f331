// The mesh rung's whole gang loop, one persistent launch per card, with
// the winner exchanged between cards inside the kernel, for Hopper
// (sm_90a). Kernel B4.
//
// Replaces kube_batch_tpu/parallel/sharded_pallas.py::_blocked_programs's
// SPMD body `local` (:267), its K = 1 path (:469-495): a device
// lax.while_loop whose every iteration selects and pops replicated on
// every chip, runs the Pallas block step over the chip's node block, does
// one lax.all_gather of the (score, global index, fits-idle) records, picks
// the winner the same way everywhere and updates capacity on the owning
// chip only. Plain version: ops/mesh_solve.py mesh_solve_plain, over the
// same per-card buffers. Caller: ops/mesh_solve.py MeshSolve, for
// parallel/sharded_block.py ShardedBlockSolver on a CUDA mesh with
// exchange_batch = 1.
//
// What it computes: kernel B1's loop (solve_loop.cuh) over one card's
// nodes, the union of the node blocks of every shard of the mesh that lies
// on that card, in ascending row order; `gidx` maps each of the card's
// nodes to its row, which the winner and the placements carry. The card's
// cluster arg-max (highest score, then lowest index) is that card's best;
// because the card's nodes are in row order, its lowest index is its
// lowest row, so the winner over the cards' records (highest score, then
// lowest row, the fits-idle bit from the owner) is the reference's
// winner() over any grouping of the nodes into cards. Pad nodes never
// fit, so no card holds them.
//
// What bounds it: B1's per-iteration latency at the card's node count
// (its sweep, its cluster barrier, the selection's reductions), plus, on
// every placing iteration, one exchange between cards: a store of a
// 16-byte record into every card's memory over NVLink, a system-scope
// fence, the stamps, the wait until every peer's stamp has arrived, and
// the cluster barrier that makes the exit uniform (below). Bytes and
// operations are far below what the cards can do in the time.
// csrc/mesh_floor.cu measures the exchange's latency alone (no barrier).
//
// What the design does about it: one launch per card for the whole solve
// (the JAX program's all_gather sits inside its device loop, and so does
// this exchange), so no iteration costs a launch or a host round trip.
//   - Each card holds an exchange buffer of [2 parities][MAX_CARDS]
//     records of four words (score bits, row, fits-idle, stamp) and one
//     abort word after them (XBUF_WORDS). After its cluster arg-max,
//     thread 0 of CTA 0 on each card writes its record into its own slot
//     of every card's buffer (the peer's memory, through peer access),
//     then __threadfence_system(), then each stamp with a relaxed
//     system-scope store: the fence makes the records visible to any
//     thread that reads the stamp.
//   - Every warp of every CTA then polls its own card's slots with
//     system-scope acquire loads (never a plain load that L1 may hold)
//     until all m stamps read this exchange's stamp, and reads the
//     records. One cluster barrier follows, then every thread reads the
//     card's abort word (below): the only barrier the exchange adds, and
//     it makes the decision to go on the same in every thread. Every
//     thread then reduces the records with node_sweep.cuh's warp arg-max
//     and derives the same winner.
//   - Only the card that owns the winner updates the winning node; the
//     replicated bookkeeping runs on every card (solve_loop.cuh).
//   - One card (m = 1: every shard of the mesh on one card) exchanges
//     nothing and is B1 with row indices.
//
// Stamps and parities. A stamp is the launch's epoch plus the exchange's
// number in the launch plus one. The host gives every card of a solve the
// same epoch and advances it past the solve's largest exchange count
// before the next launch, so a stamp never repeats across the segments,
// resumes and solves that reuse the buffers, and buffers zeroed once when
// the solver is built never need zeroing again (a buffer zeroed on one
// card's stream before a launch could race a peer's kernel already
// writing into it). Exchange n uses parity n & 1. Invariant: a card writes
// exchange n + 2 into parity n & 1 only after it has read every card's
// stamp of exchange n + 1; a card publishes that stamp only after every
// CTA of it has passed the cluster barrier of exchange n, and each thread
// reaches that barrier only after it has read exchange n's records. So no
// record is overwritten before every CTA of every card has read it.
//
// Hangs. The host launches every card's kernel before it waits on any. A
// poll is bounded by %globaltimer: past `timeout_ms` without every stamp,
// lane 0 of the warp sets its card's abort word (the exchange's number)
// and the warp stops polling; a warp that reads the abort word set stops
// too. Warps decide on their own, and a late peer's stamp can land
// between one warp's decision and another's next look, so no thread acts
// on its own decision: after the exchange's cluster barrier every thread
// reads the abort word, which nothing writes until the next exchange's
// poll, and all of them go on or all of them end the loop (a warp that
// ended it alone would leave the others at a barrier it never reaches).
// CTA 0 writes the word into scal[5] at exit, where the host reads it with
// the state and raises. The bound is seconds, so a peer that is alive
// always answers within it; it is there for a peer that never runs.
//
// Numerics: as fused_solve.cu (-fmad=false, round-to-nearest intrinsics,
// __fdiv_rn). Every card computes the selection, the drf shares and the
// pause decision itself; nothing in solve_loop.cuh depends on the
// cluster's size k, so cards of different node counts agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "solve_loop.cuh"

#define MAX_CARDS 8  // the most cards one host joins all to all
#define REC 4        // int32 words of one record: score bits, row, fits-idle, stamp
#define XBUF_WORDS (2 * MAX_CARDS * REC + REC)  // both parities' records, the abort word and pad

extern "C" {

// Mirror of ops/mesh_solve.py::_Args (same field order).
struct MeshArgs {
  SolveArgs s;           // the card's solve over its own nodes (s.N of them)
  const int* gidx;       // [s.N] each node's row, ascending
  int* xbuf[MAX_CARDS];  // each card's exchange buffer, in card order
  int card, m, timeout_ms;  // card 0 is the primary card (the card of shard 0)
  unsigned epoch;
};

}  // extern "C"

__device__ __forceinline__ unsigned ld_acquire_sys(const int* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int ld_relaxed_sys(const int* p) {
  int v;
  asm volatile("ld.relaxed.sys.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed_sys(int* p, int v) {
  asm volatile("st.relaxed.sys.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// B4's exchange between the cards of one solve (see the header).
struct MeshExchange {
  const MeshArgs& a;
  int rank;
  unsigned n = 0;  // exchanges of this launch so far

  __device__ MeshExchange(const MeshArgs& args, int r) : a(args), rank(r) {}

  __device__ __forceinline__ bool primary() const { return a.card == 0; }

  __device__ __forceinline__ bool exchange(const Best& b, Won* w) {
    const int row = b.idx == NONE ? NONE : __ldg(a.gidx + b.idx);
    const unsigned stamp = a.epoch + n + 1u;
    const int par = (int)(n & 1u);
    n += 1;
    if (a.m == 1) {
      *w = Won{row, b.idx, b.fits};
      return true;
    }
    if (rank == 0 && threadIdx.x == 0) {
      const int off = (par * MAX_CARDS + a.card) * REC;
      for (int c = 0; c < a.m; ++c) {
        int* r = a.xbuf[c] + off;
        r[0] = __float_as_int(b.score);
        r[1] = row;
        r[2] = b.fits;
      }
      __threadfence_system();  // the records before any stamp, on every card
      for (int c = 0; c < a.m; ++c) st_relaxed_sys(a.xbuf[c] + off + 3, (int)stamp);
    }
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const int* mine = a.xbuf[a.card];
    const int* slot = mine + (par * MAX_CARDS + lane) * REC;
    int* abort_word = const_cast<int*>(mine) + 2 * MAX_CARDS * REC;
    unsigned long long t0 = 0;  // lane 0's clock
    bool arrived = true;
    for (unsigned spins = 1;; ++spins) {
      const unsigned s = lane < a.m ? ld_acquire_sys(slot + 3) : stamp;
      if (__all_sync(full, s == stamp)) break;
      if ((spins & 255u) == 0) {
        int stop = 0;  // lane 0 decides for its warp
        if (lane == 0) {
          const unsigned long long now = global_ns();
          if (t0 == 0) {
            t0 = now;
          } else if (now - t0 > 1000000ull * (unsigned long long)a.timeout_ms) {
            atomicCAS(abort_word, 0, (int)n);
          }
          stop = ld_relaxed_sys(abort_word) != 0;
        }
        if (__shfl_sync(full, stop, 0)) {
          arrived = false;
          break;
        }
      }
    }
    Best rec = {-INFINITY, NONE, 0, 0};
    if (arrived && lane < a.m) {
      rec.idx = ld_relaxed_sys(slot + 1);
      if (rec.idx != NONE) {
        rec.score = __int_as_float(ld_relaxed_sys(slot));
        rec.fits = ld_relaxed_sys(slot + 2);
      }
    }
    // every warp of the cluster is past its poll: the abort word is final
    // for this exchange, and every thread reads the same value
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    if (ld_relaxed_sys(abort_word) != 0) return false;
    const Best top = warp_max_best(rec);
    // rows are unique across cards: this card owns the winner iff its row
    // is this card's best
    *w = Won{top.idx, top.idx != NONE && top.idx == row ? b.idx : NONE, top.fits};
    return true;
  }

  // CTA 0 records the launch's abort word and exchange count (scal[5],
  // scal[6]); every card's host copy is read.
  __device__ __forceinline__ void finish(const SolveArgs& s, int r) const {
    if (r == 0 && threadIdx.x == 0) {
      s.scal[5] = a.m == 1 ? 0 : ld_relaxed_sys(a.xbuf[a.card] + 2 * MAX_CARDS * REC);
      s.scal[6] = (int)n;
    }
  }
};

template <bool kRepInSmem>
__global__ void __launch_bounds__(NT, 1) mesh_solve_kernel(const MeshArgs a) {
  namespace cg = cooperative_groups;
  MeshExchange x(a, (int)cg::this_cluster().block_rank());
  solve_loop<kRepInSmem>(a.s, x);
}

static cudaLaunchConfig_t launch_config(const MeshArgs& a, void* stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.s.k, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = a.s.smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = a.s.k;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

static const void* kernel_of(const MeshArgs& a) {
  return a.s.rep_in_smem ? (const void*)mesh_solve_kernel<true> : (const void*)mesh_solve_kernel<false>;
}

// The launch's shared-memory size, and clusters past the portable 8 CTAs.
static cudaError_t set_attributes(const MeshArgs& a) {
  const void* fn = kernel_of(a);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, a.s.smem_bytes);
  if (err == cudaSuccess && a.s.k > PORTABLE_CLUSTER)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

extern "C" {

// Launch one card's cluster on `stream` of `device`; returns the first
// failing call's cudaError_t (0 on success). The caller launches every
// card of the solve before it waits on any.
int kbt_mesh_solve(const MeshArgs* args, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaError_t err = set_attributes(*args);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(*args, stream, &attr);
  err = args->s.rep_in_smem ? cudaLaunchKernelEx(&cfg, mesh_solve_kernel<true>, *args)
                            : cudaLaunchKernelEx(&cfg, mesh_solve_kernel<false>, *args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many of one card's clusters `device` can hold at once, into *out;
// returns the first failing call's cudaError_t.
int kbt_mesh_solve_max_clusters(const MeshArgs* args, int device, int* out) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const cudaError_t err = set_attributes(*args);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(*args, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, kernel_of(*args), &cfg);
}

// Let `device`'s kernels write `peer`'s memory. Access already enabled is
// success (the sticky error it leaves is cleared).
int kbt_mesh_enable_peer(int device, int peer) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const cudaError_t err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    return 0;
  }
  return (int)err;
}

const char* kbt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
