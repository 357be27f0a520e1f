// Whole-wave interleaved-lane rANS decode for Hopper (sm_90a), plain C
// interface.
//
// Replaces frave_tpu/ops/pallas_rans.py decode_scan_wave (_decode_kernel):
// every decode row of one grid wave in one launch. The rows of a wave
// depend on each other only through the lane states x and the stream
// position gptr; the buckets of a wave depend only on earlier waves, so
// nothing crosses the launch but (x, gptr), and both stay on the device.
//
// Design: one block of 1024 threads per wave. Each row is walked in tiles
// of 8192 lanes (flat index i = c * NL + n, the stream's rank order);
// thread t owns lanes 8t .. 8t + 7 of every tile, in every row, so a lane's
// state is only ever touched by one thread.
//   * symbol: the u16 cdf staircases of all (channel, context) pairs sit
//     in shared memory (32 KB a channel, padded against bank conflicts, see
//     kWinStride). The symbol s is the last index whose cdf <= slot, found
//     by a 10-step branch-free upper-bound search, which resolves runs of
//     equal cdfs (zero-frequency symbols) to the last one and gives 0 where
//     no entry is <= slot; freq = min(cdf[s + 1], 2^bits) - cdf[s]. All
//     arithmetic is u32, integer only (the TPU kernel's f32 MXU staircases
//     are not carried over).
//   * rank: the words a row takes are contiguous in the stream, in lane
//     order, so a lane's word is stream[gptr + rank]. Per tile, each
//     thread counts its renorming lanes, a warp-shuffle + shared-memory
//     block scan gives each thread its exclusive rank and the tile total,
//     and gptr advances by the total. Every stream index is clamped to
//     [0, W - 1], so a corrupt container decodes to garbage, never out of
//     bounds.
//   * states: in shared memory beside the tables when they fit (up to
//     ~33k lanes at C = 3 on an H100's 227 KB); beyond that in the
//     caller's `xwork` buffer in device memory (frave_rans_decode_states_fit
//     says which), where each thread reads and writes its own lanes once
//     per row (192 KB at 2048x2048 RGB, L2-sized). Shared memory is ~8%
//     faster at C = 3, NL = 2048 and the same at C = 1.
//     The tables keep shared memory because every lane reads them 12 times
//     a row at random addresses, its state only twice (the other way round
//     measured 2.4x slower at 2048x2048 RGB's largest wave).
//
// Bound: one SM does the whole wave, so the shared-memory symbol search
// (10 dependent loads per lane and row) and the per-tile block scans set
// the time; the card's other SMs idle. Spreading a row over a cluster or a
// cooperative grid is the next step, not this kernel's.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;
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
static_assert(kWarps == 32, "the block scan's second level is one warp");

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

__device__ __forceinline__ int cdf_slot(int e) {
  return (e / kWin) * kWinStride + e % kWin;
}

// 8 consecutive u32 from p[i0 ..]: two 16-byte loads where the run is
// whole and aligned, guarded scalar loads (0 past n) otherwise.
__device__ __forceinline__ void load8(const uint32_t* p, int64_t i0, int64_t n,
                                      uint32_t (&out)[kPerThread]) {
  if (i0 + kPerThread <= n && (reinterpret_cast<uintptr_t>(p + i0) & 15) == 0) {
    const uint4 a = *reinterpret_cast<const uint4*>(p + i0);
    const uint4 b = *reinterpret_cast<const uint4*>(p + i0 + 4);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else {
#pragma unroll
    for (int v = 0; v < kPerThread; ++v) out[v] = i0 + v < n ? p[i0 + v] : 0u;
  }
}

// Store the lanes of `mask` among 8 consecutive u32 at p[i0 ..]: two
// 16-byte stores where all 8 are stored and aligned, scalar otherwise.
__device__ __forceinline__ void store8(uint32_t* p, int64_t i0, uint32_t mask,
                                       const uint32_t (&in)[kPerThread]) {
  if (mask == 0xFFu && (reinterpret_cast<uintptr_t>(p + i0) & 15) == 0) {
    *reinterpret_cast<uint4*>(p + i0) = make_uint4(in[0], in[1], in[2], in[3]);
    *reinterpret_cast<uint4*>(p + i0 + 4) = make_uint4(in[4], in[5], in[6], in[7]);
  } else {
#pragma unroll
    for (int v = 0; v < kPerThread; ++v)
      if (mask >> v & 1u) p[i0 + v] = in[v];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
rans_decode_wave_kernel(const int64_t* __restrict__ x_in,
                        const int64_t* __restrict__ gptr_in,
                        const uint32_t* __restrict__ bkt,
                        const uint8_t* __restrict__ active,
                        const int32_t* __restrict__ stream, int stream_len,
                        const int32_t* __restrict__ cdf,
                        const int32_t* __restrict__ bits,
                        uint32_t* __restrict__ syms,
                        int64_t* __restrict__ x_out,
                        int64_t* __restrict__ gptr_out, uint32_t* xwork,
                        int rows, int channels, int lanes, int contexts,
                        int states_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp[2][kWarps];
  const int nctx = channels * contexts;
  const size_t bits_bytes = align16(static_cast<size_t>(nctx) * 4);
  const size_t tab_bytes = bits_bytes + align16(static_cast<size_t>(nctx) * kRowStride * 2);
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(smem);
  uint16_t* s_cdf = reinterpret_cast<uint16_t*>(smem + bits_bytes);
  uint32_t* xs = states_in_smem ? reinterpret_cast<uint32_t*>(smem + tab_bytes) : xwork;

  const int64_t cnl = static_cast<int64_t>(channels) * lanes;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  // the clamps repeat decode_tables' (bits <= 14, cdf <= 2^14): no shift
  // past 31 and no u16 truncation, whatever the caller passes
  for (int k = t; k < nctx; k += kThreads)
    s_bits[k] = static_cast<uint32_t>(min(max(bits[k], 0), kMaxBits));
  for (int k = t; k < nctx * kAlphabet; k += kThreads)
    s_cdf[k / kAlphabet * kRowStride + cdf_slot(k % kAlphabet)] =
        static_cast<uint16_t>(min(max(cdf[k], 0), 1 << kMaxBits));
  for (int64_t i = static_cast<int64_t>(t) * kPerThread; i < cnl; i += kTile) {
    uint32_t x0[kPerThread];
    uint32_t mask = 0;
#pragma unroll
    for (int v = 0; v < kPerThread; ++v) {
      x0[v] = i + v < cnl ? static_cast<uint32_t>(x_in[i + v]) : 0u;
      if (i + v < cnl) mask |= 1u << v;
    }
    store8(xs, i, mask, x0);
  }
  __syncthreads();

  int64_t g = *gptr_in;
  int buf = 0;
  for (int r = 0; r < rows; ++r) {
    const uint32_t* bk_r = bkt + static_cast<int64_t>(r) * cnl;
    const uint8_t* act_r = active + static_cast<int64_t>(r) * lanes;
    uint32_t* sym_r = syms + static_cast<int64_t>(r) * cnl;
    for (int64_t base = 0; base < cnl; base += kTile) {
      const int64_t i0 = base + static_cast<int64_t>(t) * kPerThread;
      uint32_t xv[kPerThread] = {}, bk[kPerThread] = {}, sv[kPerThread];
      uint32_t live = 0, act_m = 0, need_m = 0;
      // every global load of the tile goes out before any result is
      // used, so the thread waits for device memory once, not per lane
      if (i0 < cnl) {
        load8(xs, i0, cnl, xv);
        load8(bk_r, i0, cnl, bk);
      }
      int c = static_cast<int>(i0 / lanes);
      int n = static_cast<int>(i0 - static_cast<int64_t>(c) * lanes);
      int cv[kPerThread];
#pragma unroll
      for (int v = 0; v < kPerThread; ++v) {
        cv[v] = c;
        if (i0 + v < cnl) {
          live |= 1u << v;
          if (act_r[n]) act_m |= 1u << v;
        }
        if (++n == lanes) {
          n = 0;
          ++c;
        }
      }
#pragma unroll
      for (int v = 0; v < kPerThread && live; ++v) {
        const uint32_t x = xv[v];
        const int b = min(max(static_cast<int>(bk[v]), 0), contexts - 1);
        const int ctx = min(cv[v], channels - 1) * contexts + b;
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
        const uint32_t x2 = (nx - cd) * (x >> bi) + slot - cd;
        sv[v] = static_cast<uint32_t>(s);
        if (act_m >> v & 1u) {
          xv[v] = x2;
          if (x2 < kRansL) need_m |= 1u << v;
        }
      }
      if (live) store8(sym_r, i0, live, sv);

      // block-wide exclusive scan of the per-thread word counts
      const int cnt = __popc(need_m);
      int incl = cnt;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
        if (lane >= d) incl += y;
      }
      if (lane == 31) s_warp[buf][warp] = incl;
      __syncthreads();
      if (warp == 0) {
        int w = s_warp[buf][lane];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(0xFFFFFFFFu, w, d);
          if (lane >= d) w += y;
        }
        s_warp[buf][lane] = w;
      }
      __syncthreads();
      // s_warp[buf] is read below while the next tile fills s_warp[buf ^ 1];
      // the tile after that writes buf again only past two more barriers
      int64_t rank = g + (warp ? s_warp[buf][warp - 1] : 0) + incl - cnt;
      const int total = s_warp[buf][kWarps - 1];
      // the words of the thread's renorming lanes are consecutive: all 8
      // loads go out together, clamped; a lane that takes no word drops its
      uint32_t wv[kPerThread];
#pragma unroll
      for (int v = 0; v < kPerThread; ++v) {
        const int64_t idx = rank < 0 ? 0 : (rank >= stream_len ? stream_len - 1 : rank);
        wv[v] = static_cast<uint32_t>(stream[idx]);
        rank += need_m >> v & 1u;
      }
#pragma unroll
      for (int v = 0; v < kPerThread; ++v)
        if (need_m >> v & 1u) xv[v] = (xv[v] << 16) | wv[v];
      if (act_m) store8(xs, i0, act_m, xv);  // inactive lanes keep x
      g += total;
      buf ^= 1;
    }
  }

  for (int64_t i = static_cast<int64_t>(t) * kPerThread; i < cnl; i += kTile) {
#pragma unroll
    for (int v = 0; v < kPerThread; ++v)
      if (i + v < cnl) x_out[i + v] = static_cast<int64_t>(xs[i + v]);
  }
  if (t == 0) *gptr_out = g;
}

// The launch's shared-memory plan: the opt-in room, the dynamic bytes,
// and whether the lane states fit there beside the tables.
cudaError_t smem_plan(int channels, int lanes, int contexts, size_t* room,
                      size_t* dyn, int* in_smem) {
  if (channels < 1 || lanes < 1 || contexts < 1) return cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, rans_decode_wave_kernel);
  if (err != cudaSuccess) return err;
  const size_t nctx = static_cast<size_t>(channels) * contexts;
  const size_t tab = align16(nctx * 4) + align16(nctx * kRowStride * 2);
  const size_t states = static_cast<size_t>(channels) * lanes * 4;
  *room = static_cast<size_t>(optin) - attr.sharedSizeBytes;
  if (tab > *room) return cudaErrorInvalidValue;
  *in_smem = tab + states <= *room ? 1 : 0;
  *dyn = tab + (*in_smem ? states : 0);
  return cudaSuccess;
}

}  // namespace

// 1 in *fits where the states of channels x lanes sit in shared memory,
// so that frave_rans_decode_wave needs no xwork buffer; 0 where they need
// one of channels * lanes u32.
extern "C" int frave_rans_decode_states_fit(int channels, int lanes, int contexts,
                                            int* fits) {
  size_t room = 0, dyn = 0;
  return static_cast<int>(smem_plan(channels, lanes, contexts, &room, &dyn, fits));
}

extern "C" int frave_rans_decode_wave(const void* x_in, const void* gptr_in,
                                      const void* bkt, const void* active,
                                      const void* stream, const void* cdf,
                                      const void* bits, void* syms,
                                      void* x_out, void* gptr_out, void* xwork,
                                      int rows, int channels, int lanes,
                                      int contexts, int stream_len,
                                      void* cuda_stream) {
  if (rows < 0 || stream_len < 1) return static_cast<int>(cudaErrorInvalidValue);
  size_t room = 0, dyn = 0;
  int in_smem = 0;
  cudaError_t err = smem_plan(channels, lanes, contexts, &room, &dyn, &in_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!in_smem && xwork == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  // always the same value (the whole opt-in room), so concurrent callers
  // cannot lower it between another caller's set and launch
  err = cudaFuncSetAttribute(rans_decode_wave_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(room));
  if (err != cudaSuccess) return static_cast<int>(err);
  rans_decode_wave_kernel<<<1, kThreads, dyn, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const int64_t*>(x_in), static_cast<const int64_t*>(gptr_in),
      static_cast<const uint32_t*>(bkt), static_cast<const uint8_t*>(active),
      static_cast<const int32_t*>(stream), stream_len,
      static_cast<const int32_t*>(cdf), static_cast<const int32_t*>(bits),
      static_cast<uint32_t*>(syms), static_cast<int64_t*>(x_out),
      static_cast<int64_t*>(gptr_out), static_cast<uint32_t*>(xwork), rows,
      channels, lanes, contexts, in_smem);
  return static_cast<int>(cudaGetLastError());
}
