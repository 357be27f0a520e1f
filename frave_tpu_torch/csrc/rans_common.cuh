// Device code shared by the rANS decode kernels for Hopper (sm_90a): the
// whole-wave decode of grid mode (rans_decode.cu, kernel 3), the
// step-tensor decode of every mode (rans_step_decode.cu, kernel D) and the
// tp-sharded decode steps (rans_tp_decode.cu, kernels 3T and DT; D and
// DT take the TMA bulk copies below, 3T and DT the split cluster barrier).
//
// Both run one thread-block cluster of S blocks of kThreads threads per
// image, block k owning a contiguous range of the flat rank index
// i = c * NL + n, and per decode row (kernel 3) or step (kernel D):
//   * the symbol: the last index whose cdf <= slot, by a 10-step
//     branch-free upper-bound search over the u16 cdf staircases each
//     block holds in shared memory (padded against bank conflicts, see
//     kWinStride), which resolves runs of equal cdfs (zero-frequency
//     symbols) to the last one and gives 0 where no entry is <= slot;
//     freq = min(cdf[s + 1], 2^bits) - cdf[s]; u32 integer arithmetic;
//   * the rank of each renorm word: a block scan of the renorm counts
//     (warp shuffles, one __syncthreads) and a cross-block exchange of
//     the block totals through distributed shared memory after one
//     cluster barrier, slots chosen by row parity;
//   * the words, from the stream at the clamped index gptr + rank.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

// an unnamed namespace: each source that includes this gets its own copy
// (device_room's cache in particular)
namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
// lanes a block aims at under the launch rules (measured on an H100:
// 2048 lanes a block at 1 or 2 lanes a thread beat larger blocks; PERF.md)
constexpr int kBlockLanes = 2048;
constexpr int kAlphabet = 1024;
// shared-memory layout of a cdf staircase: 32 windows of 32 u16 entries,
// each window padded to 34 slots and each row to 32 * 34 + 2, so that
// window starts (the coarse search levels) and rows (the contexts) fall in
// different banks — unpadded, every level-1..5 probe of every context
// lands in banks 0 and 16 and the search serialises on bank conflicts
constexpr int kWin = 32;
constexpr int kWinStride = kWin + 2;
constexpr int kRowStride = kAlphabet / kWin * kWinStride + 2;
constexpr int kMaxBits = 14;
constexpr uint32_t kRansL = 1u << 16;
constexpr unsigned kFull = 0xFFFFFFFFu;
static_assert(kWarps == 32, "the second scan level is one warp wide");
static_assert(kMaxCluster <= 32, "the block totals are scanned by one warp");

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Shared bytes of the bits and the padded cdf staircases of nctx contexts.
__host__ __device__ constexpr size_t table_bytes(int nctx) {
  return align16(static_cast<size_t>(nctx) * 4) +
         align16(static_cast<size_t>(nctx) * kRowStride * 2);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ int cdf_slot(int e) {
  return (e / kWin) * kWinStride + e % kWin;
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += y;
  }
  return v;
}

// Load the clamped tables of nctx contexts into shared memory (s_bits
// [nctx], s_cdf [nctx * kRowStride]); the clamps repeat decode_tables'
// (bits <= 14, cdf <= 2^14): no shift past 31 and no u16 truncation,
// whatever the caller passes.
__device__ __forceinline__ void load_tables(const int32_t* cdf, const int32_t* bits, int nctx,
                                            uint32_t* s_bits, uint16_t* s_cdf) {
  for (int k = threadIdx.x; k < nctx; k += kThreads)
    s_bits[k] = static_cast<uint32_t>(min(max(bits[k], 0), kMaxBits));
  for (int k = threadIdx.x; k < nctx * kAlphabet; k += kThreads)
    s_cdf[k / kAlphabet * kRowStride + cdf_slot(k % kAlphabet)] =
        static_cast<uint16_t>(min(max(cdf[k], 0), 1 << kMaxBits));
}

// One symbol of context ctx from state x: the symbol into *sym, the
// pre-renorm state x' = freq * (x >> bits) + slot - cdf (mod 2^32) out.
__device__ __forceinline__ uint32_t decode_symbol(const uint32_t* s_bits, const uint16_t* s_cdf,
                                                  int ctx, uint32_t x, uint32_t* sym) {
  const uint32_t bi = s_bits[ctx];
  const uint32_t top = 1u << bi;
  const uint32_t slot = x & (top - 1u);
  const uint16_t* row = s_cdf + ctx * kRowStride;
  int s = 0;
#pragma unroll
  for (int step = kAlphabet / 2; step > 0; step >>= 1)
    if (row[cdf_slot(s + step)] <= slot) s += step;
  const uint32_t cd = row[cdf_slot(s)];
  const uint32_t nx =
      min(s + 1 < kAlphabet ? static_cast<uint32_t>(row[cdf_slot(s + 1)]) : top, top);
  *sym = static_cast<uint32_t>(s);
  return (nx - cd) * (x >> bi) + slot - cd;
}

// The words of the thread's renorming lanes (`need_m` of P) are
// consecutive from `rank`: the loads go out together, each index clamped
// to [0, len - 1], and shift into the states.
template <int P>
__device__ __forceinline__ void take_words(const int32_t* stream, int64_t len, int64_t rank,
                                           uint32_t need_m, uint32_t (&xv)[P]) {
  uint32_t wv[P];
#pragma unroll
  for (int v = 0; v < P; ++v) {
    const int64_t idx = rank < 0 ? 0 : (rank >= len ? len - 1 : rank);
    wv[v] = (need_m >> v & 1u) ? static_cast<uint32_t>(stream[idx]) : 0u;
    rank += need_m >> v & 1u;
  }
#pragma unroll
  for (int v = 0; v < P; ++v)
    if (need_m >> v & 1u) xv[v] = (xv[v] << 16) | wv[v];
}

// The cluster barrier with its memory order spelled out: every write a
// thread of the cluster made before it (shared or global memory) is
// visible to every thread of the cluster after it.
__device__ __forceinline__ void cluster_barrier_release_acquire() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Arrive on `bar` expecting `bytes` more of bulk copies before its phase
// completes.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// TMA's 1-D form: `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The two halves of a cluster barrier, for a thread that arrives early and
// waits late: every write a thread of the cluster made before its arrive
// is visible to every thread of the cluster after its wait. Each thread
// waits once between two arrives.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The row's cross-block exchange: every block's total `btot` in, this
// block's base rank and the row total out (S = 1: 0 and btot). The parity
// slots make one cluster barrier per row enough: a block can overwrite a
// slot only after the next barrier, which every reader of that slot has
// passed. kOrdered: the barrier is cluster_barrier_release_acquire (the
// caller's global writes before it are read by other blocks after it);
// otherwise cooperative groups' cluster.sync().
template <bool kOrdered>
__device__ __forceinline__ void exchange(int* s_tot, int par, int btot, int lane,
                                         int64_t* base, int64_t* rowtot) {
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  if (S == 1) {
    *base = 0;
    *rowtot = btot;
    return;
  }
  if (threadIdx.x == 0) s_tot[par] = btot;
  if constexpr (kOrdered) {
    cluster_barrier_release_acquire();
  } else {
    cluster.sync();
  }
  int v = 0;
  if (lane < S) v = *cluster.map_shared_rank(s_tot + par, lane);
  const int vincl = warp_incl_scan(v, lane);
  const int rb = static_cast<int>(cluster.block_rank());
  const int before = __shfl_sync(kFull, vincl, (rb + 31) & 31);
  *base = rb ? before : 0;
  *rowtot = __shfl_sync(kFull, vincl, 31);
}

// The block's exclusive rank of this thread's count `cnt` (its warp's
// inclusive scan is `incl`) and the block total, from s_warp[buf].
__device__ __forceinline__ int block_scan(int (*s_warp)[kWarps], int buf, int cnt, int incl,
                                          int lane, int warp, int* total) {
  if (lane == 31) s_warp[buf][warp] = incl;
  __syncthreads();
  const int w = warp_incl_scan(s_warp[buf][lane], lane);
  const int before = __shfl_sync(kFull, w, (warp + 31) & 31);
  *total = __shfl_sync(kFull, w, 31);
  return (warp ? before : 0) + incl - cnt;
}

inline cudaLaunchConfig_t launch_config(int cluster, int images, size_t dyn,
                                        cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, images, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Whether `cluster` blocks of `fn` with `dyn` bytes can be resident at once.
inline cudaError_t cluster_fits(const void* fn, int cluster, size_t dyn, bool* fits) {
  if (cluster == 1) {
    *fits = true;
    return cudaSuccess;
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(cluster, 1, dyn, nullptr, &attr);
  int n = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  if (err == cudaErrorInvalidClusterSize || err == cudaErrorInvalidConfiguration) {
    cudaGetLastError();  // a refused size is an answer, not a fault
    *fits = false;
    return cudaSuccess;
  }
  *fits = n > 0;
  return err;
}

// The device's shared-memory room for the dynamic part of the kernels
// `fns` (the opt-in maximum less their largest static part), after
// setting it and the non-portable cluster sizes on each; once a device
// for the translation unit that calls it (each passes its own kernels).
inline cudaError_t device_room(const void* const* fns, int nfns, size_t* room) {
  static std::mutex mu;
  static size_t rooms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (rooms[dev] == 0) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    size_t stat = 0;
    for (int k = 0; err == cudaSuccess && k < nfns; ++k) {
      cudaFuncAttributes fa;
      err = cudaFuncGetAttributes(&fa, fns[k]);
      if (err == cudaSuccess && fa.sharedSizeBytes > stat) stat = fa.sharedSizeBytes;
    }
    if (err != cudaSuccess) return err;
    const size_t r = static_cast<size_t>(optin) - stat;
    for (int k = 0; err == cudaSuccess && k < nfns; ++k) {
      err = cudaFuncSetAttribute(fns[k], cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(r));
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(fns[k], cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) return err;
    rooms[dev] = r;
  }
  *room = rooms[dev];
  return cudaSuccess;
}

}  // namespace
