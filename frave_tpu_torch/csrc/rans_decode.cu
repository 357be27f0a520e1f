// Whole-wave interleaved-lane rANS decode for Hopper (sm_90a) over one
// thread-block cluster, plain C interface.
//
// Replaces frave_tpu/ops/pallas_rans.py decode_scan_wave (_decode_kernel):
// every decode row of one grid wave in one launch. The rows of a wave
// depend on each other only through the lane states x and the stream
// position gptr; the buckets of a wave depend only on earlier waves, so
// nothing crosses the launch but (x, gptr), and both stay on the device.
//
// Bound on this card. Bytes: each lane-row reads a 4-byte bucket and
// writes a 4-byte symbol, each row one activity byte per lane, and the
// wave reads the words it consumes (13.07 M lane-rows, ~0.035 ms at
// 3.35 TB/s for a whole 2048x2048 RGB decode). Dependencies: row r + 1
// needs row r's states and its stream position gptr + (words row r took),
// an exclusive prefix over all C * NL lanes, so a wave costs at least R
// cross-SM exchanges one after another, whatever the bandwidth
// (chip_smoke.py times an empty exchange loop at each cluster size).
//
// Design (the symbol search, the rank exchange and the launch helpers are
// rans_common.cuh's, shared with kernel D, rans_step_decode.cu): one
// cluster of S blocks of 1024 threads (S = 1, 2, 4, 8, 16)
// per wave, launched with cudaLaunchKernelEx. Block k owns a contiguous
// range of the flat rank index i = c * NL + n (the stream's rank order),
// so its renorm words are contiguous in the stream; thread t owns lanes
// Pt .. Pt + P - 1 of it, P = 1, 2, 4 or 8 the fewest that cover the
// range with 1024 threads (fewer lanes a thread: shorter dependent search
// chains per thread, more warps to hide them).
//   * symbol: every block holds the u16 cdf staircases of all (channel,
//     context) pairs in its shared memory (32 KB a channel, padded against
//     bank conflicts, see kWinStride). The symbol s is the last index
//     whose cdf <= slot, found by a 10-step branch-free upper-bound
//     search, which resolves runs of equal cdfs (zero-frequency symbols)
//     to the last one and gives 0 where no entry is <= slot;
//     freq = min(cdf[s + 1], 2^bits) - cdf[s]. All arithmetic is u32,
//     integer only.
//   * rank: per row, each block scans its own renorm counts (warp shuffles,
//     one __syncthreads, every warp then scans the 32 warp sums itself),
//     writes its block total into a shared-memory slot chosen by row
//     parity and arrives at the cluster barrier; after it, lanes 0..S-1 of
//     every warp read the S block totals through distributed shared memory
//     (cluster.map_shared_rank) and scan them, which gives the block's base
//     rank and the row total that advances gptr. The parity slots make one
//     cluster barrier per row enough: a block can overwrite a slot only
//     after the next barrier, which every reader of that slot has passed.
//     Every stream index is clamped to [0, W - 1], so a corrupt container
//     decodes to garbage, never out of bounds.
//   * one tile per block (C * NL <= 8192 S, every launch-rule choice up to
//     131,072 lanes): the thread's P lane states stay in registers for the
//     whole wave, and the next row's buckets and activity (independent of
//     the current row) are loaded before the current row's scan and
//     barrier, so the per-row chain is the search, the scan, the exchange
//     and the dependent stream load, without a device-memory load of
//     buckets on it.
//   * several tiles per block (a cluster size forced below the rule, or
//     C * NL > 131,072): 8 lanes a thread in tiles of 8192; per row, pass A
//     decodes every tile, stores the states in the caller's `xwork` buffer
//     in device memory (C * NL u32; they do not fit beside the tables at
//     S = 1 and 2048x2048 RGB) and each thread's (block-local rank, renorm
//     mask) in shared memory; after the exchange pass B takes the words.
//
// A same-shape batch of B images runs in one launch of B clusters (grid
// (S, B), the JAX program's vmap over B): cluster b decodes image b's wave
// from its own states, stream position, stream, buckets and tables (every
// operand but the row activity has an image axis, and the kernel offsets
// each by blockIdx.y). Word ranks never run across images, and clusters
// share nothing, so they may run in any order and need not be resident at
// once (at 2048x2048 RGB, 16 blocks a cluster and one block an SM, more
// than 8 images queue behind the first clusters).
//
// The launch rule (frave_rans_decode_plan with cluster = 0): the smallest
// S with at most kBlockLanes = 2048 lanes a block, capped at 16 and
// lowered while cudaOccupancyMaxActiveClusters says S blocks cannot be
// resident at once. On an H100 (PERF.md) it gives S = 1 up to 2048 lanes,
// where a cluster barrier costs more than the search it splits, and 4 at
// 768x512 RGB (6,144 lanes), 16 at 2048x2048 RGB (49,152).

#include "rans_common.cuh"

namespace {

constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;

struct WaveArgs {
  const int64_t* x_in;
  const int64_t* gptr_in;
  const uint32_t* bkt;
  const uint8_t* active;
  const int32_t* stream;
  const int32_t* cdf;
  const int32_t* bits;
  uint32_t* syms;
  int64_t* x_out;
  int64_t* gptr_out;
  uint32_t* xwork;  // [B, C * NL] lane states of several-tile blocks
  int rows, channels, lanes, contexts, stream_len;
  int64_t chunk;  // lanes a block owns (a multiple of 8)
};

// The operands of image `img`: x, gptr, buckets, stream, tables, symbols
// and the state buffer are [B, ...] with one image's worth a stride; the
// row activity is shared.
__device__ __forceinline__ WaveArgs image_args(const WaveArgs& a, int64_t img) {
  WaveArgs o = a;
  const int64_t cnl = static_cast<int64_t>(a.channels) * a.lanes;
  const int64_t grid = cnl * a.rows;
  const int64_t tab = static_cast<int64_t>(a.channels) * a.contexts;
  o.x_in += img * cnl;
  o.gptr_in += img;
  o.bkt += img * grid;
  o.stream += img * a.stream_len;
  o.cdf += img * tab * kAlphabet;
  o.bits += img * tab;
  o.syms += img * grid;
  o.x_out += img * cnl;
  o.gptr_out += img;
  if (o.xwork != nullptr) o.xwork += img * cnl;
  return o;
}

// P consecutive u32 from p[i0 ..]: 16-byte loads where the run is whole
// and aligned (P >= 4), guarded scalar loads (0 past n) otherwise.
template <int P>
__device__ __forceinline__ void loadp(const uint32_t* p, int64_t i0, int64_t n,
                                      uint32_t (&out)[P]) {
  if (P >= 4 && i0 + P <= n && (reinterpret_cast<uintptr_t>(p + i0) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < P / 4; ++q) {
      const uint4 a = *reinterpret_cast<const uint4*>(p + i0 + 4 * q);
      out[4 * q] = a.x; out[4 * q + 1] = a.y; out[4 * q + 2] = a.z; out[4 * q + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int v = 0; v < P; ++v) out[v] = i0 + v < n ? p[i0 + v] : 0u;
  }
}

// Store the lanes of `mask` among P consecutive u32 at p[i0 ..]: 16-byte
// stores where all P are stored and aligned (P >= 4), scalar otherwise.
template <int P>
__device__ __forceinline__ void storep(uint32_t* p, int64_t i0, uint32_t mask,
                                       const uint32_t (&in)[P]) {
  if (P >= 4 && mask == (1u << P) - 1u && (reinterpret_cast<uintptr_t>(p + i0) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < P / 4; ++q)
      *reinterpret_cast<uint4*>(p + i0 + 4 * q) =
          make_uint4(in[4 * q], in[4 * q + 1], in[4 * q + 2], in[4 * q + 3]);
  } else {
#pragma unroll
    for (int v = 0; v < P; ++v)
      if (mask >> v & 1u) p[i0 + v] = in[v];
  }
}

// Bits of the P lanes from flat index i0 (limited to `live`) that the
// row's activity act_r [NL] marks active.
template <int P>
__device__ __forceinline__ uint32_t load_act(const uint8_t* act_r, int64_t i0,
                                             int lanes, uint32_t live) {
  if (!live) return 0u;
  int n = static_cast<int>(i0 % lanes);
  uint32_t m = 0;
#pragma unroll
  for (int v = 0; v < P; ++v) {
    if ((live >> v & 1u) && act_r[n]) m |= 1u << v;
    if (++n == lanes) n = 0;
  }
  return m;
}

// One row of the P lanes from flat index i0: symbols into sv, the states
// of the active lanes advanced; returns the mask of those that renorm.
template <int P>
__device__ __forceinline__ uint32_t decodep(const uint32_t* s_bits, const uint16_t* s_cdf,
                                            const WaveArgs& a, int64_t i0,
                                            const uint32_t (&bk)[P], uint32_t act_m,
                                            uint32_t (&xv)[P], uint32_t (&sv)[P]) {
  int c = static_cast<int>(i0 / a.lanes);
  int n = static_cast<int>(i0 - static_cast<int64_t>(c) * a.lanes);
  uint32_t need_m = 0;
#pragma unroll
  for (int v = 0; v < P; ++v) {
    const int b = min(max(static_cast<int>(bk[v]), 0), a.contexts - 1);
    const int ctx = min(c, a.channels - 1) * a.contexts + b;
    uint32_t sym;
    const uint32_t x2 = decode_symbol(s_bits, s_cdf, ctx, xv[v], &sym);
    sv[v] = sym;
    if (act_m >> v & 1u) {
      xv[v] = x2;
      if (x2 < kRansL) need_m |= 1u << v;
    }
    if (++n == a.lanes) {
      n = 0;
      ++c;
    }
  }
  return need_m;
}

// P > 0: one tile of kThreads * P lanes a block, P lanes a thread with
// their states in registers; P == 0: several tiles of kTile lanes.
template <int P>
__global__ void __launch_bounds__(kThreads, 1) rans_decode_wave_kernel(const WaveArgs batch) {
  const WaveArgs a = image_args(batch, blockIdx.y);  // this cluster's image
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp[2][kWarps];
  __shared__ int s_tot[2];
  const int nctx = a.channels * a.contexts;
  const size_t tab = table_bytes(nctx);
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(smem);
  uint16_t* s_cdf = reinterpret_cast<uint16_t*>(smem + align16(static_cast<size_t>(nctx) * 4));
  load_tables(a.cdf, a.bits, nctx, s_bits, s_cdf);

  const int64_t cnl = static_cast<int64_t>(a.channels) * a.lanes;
  const int blk = static_cast<int>(cg::this_cluster().block_rank());
  const int64_t lo = min64(cnl, blk * a.chunk);
  const int64_t hi = min64(cnl, lo + a.chunk);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  int64_t g = *a.gptr_in;

  if constexpr (P > 0) {
    const int64_t i0 = lo + static_cast<int64_t>(t) * P;
    uint32_t live = 0;
#pragma unroll
    for (int v = 0; v < P; ++v)
      if (i0 + v < hi) live |= 1u << v;
    uint32_t xv[P], bk[P] = {};
#pragma unroll
    for (int v = 0; v < P; ++v)
      xv[v] = live >> v & 1u ? static_cast<uint32_t>(a.x_in[i0 + v]) : 0u;
    uint32_t act_m = 0;
    if (live && a.rows > 0) {
      loadp<P>(a.bkt, i0, hi, bk);
      act_m = load_act<P>(a.active, i0, a.lanes, live);
    }
    __syncthreads();  // the tables
    for (int r = 0; r < a.rows; ++r) {
      const int par = r & 1;
      uint32_t need_m = 0;
      if (live) {
        uint32_t sv[P];
        need_m = decodep<P>(s_bits, s_cdf, a, i0, bk, act_m, xv, sv);
        storep<P>(a.syms + static_cast<int64_t>(r) * cnl, i0, live, sv);
        // the next row's buckets and activity do not depend on this row:
        // their loads go out before this row's scan and exchange
        if (r + 1 < a.rows) {
          loadp<P>(a.bkt + static_cast<int64_t>(r + 1) * cnl, i0, hi, bk);
          act_m = load_act<P>(a.active + static_cast<int64_t>(r + 1) * a.lanes, i0, a.lanes, live);
        }
      }
      const int cnt = __popc(need_m);
      const int incl = warp_incl_scan(cnt, lane);
      int btot = 0;
      const int local = block_scan(s_warp, par, cnt, incl, lane, warp, &btot);
      int64_t base = 0, rowtot = 0;
      exchange<false>(s_tot, par, btot, lane, &base, &rowtot);
      if (need_m) take_words<P>(a.stream, a.stream_len, g + base + local, need_m, xv);
      g += rowtot;
    }
#pragma unroll
    for (int v = 0; v < P; ++v)
      if (live >> v & 1u) a.x_out[i0 + v] = static_cast<int64_t>(xv[v]);
  } else {
    constexpr int Q = kPerThread;
    uint32_t* stage = reinterpret_cast<uint32_t*>(smem + tab);
    uint32_t* xs = a.xwork + lo;  // xs[i - lo] is lane i's state
    for (int64_t i = lo + static_cast<int64_t>(t) * Q; i < hi; i += kTile) {
      uint32_t x0[Q];
      uint32_t mask = 0;
#pragma unroll
      for (int v = 0; v < Q; ++v) {
        x0[v] = i + v < hi ? static_cast<uint32_t>(a.x_in[i + v]) : 0u;
        if (i + v < hi) mask |= 1u << v;
      }
      storep<Q>(xs, i - lo, mask, x0);
    }
    __syncthreads();  // the tables
    int buf = 0;
    for (int r = 0; r < a.rows; ++r) {
      const uint32_t* bk_r = a.bkt + static_cast<int64_t>(r) * cnl;
      const uint8_t* act_r = a.active + static_cast<int64_t>(r) * a.lanes;
      uint32_t* sym_r = a.syms + static_cast<int64_t>(r) * cnl;
      // pass A: symbols and states of every tile, block-local ranks
      int local = 0;
      int tile = 0;
      for (int64_t b0 = lo; b0 < hi; b0 += kTile, ++tile) {
        const int64_t i0 = b0 + static_cast<int64_t>(t) * Q;
        uint32_t live = 0;
#pragma unroll
        for (int v = 0; v < Q; ++v)
          if (i0 + v < hi) live |= 1u << v;
        uint32_t need_m = 0;
        if (live) {
          uint32_t xv[Q], bk[Q], sv[Q];
          loadp<Q>(xs, i0 - lo, hi - lo, xv);
          loadp<Q>(bk_r, i0, hi, bk);
          const uint32_t act_m = load_act<Q>(act_r, i0, a.lanes, live);
          need_m = decodep<Q>(s_bits, s_cdf, a, i0, bk, act_m, xv, sv);
          storep<Q>(sym_r, i0, live, sv);
          if (act_m) storep<Q>(xs, i0 - lo, act_m, xv);  // inactive lanes keep x
        }
        const int cnt = __popc(need_m);
        const int incl = warp_incl_scan(cnt, lane);
        int ttot = 0;
        const int rank = block_scan(s_warp, buf, cnt, incl, lane, warp, &ttot);
        // s_warp[buf] was read above while the next tile fills buf ^ 1;
        // buf is written again only past the next tile's barrier
        stage[tile * kThreads + t] = static_cast<uint32_t>(local + rank) << 8 | need_m;
        local += ttot;
        buf ^= 1;
      }
      int64_t base = 0, rowtot = 0;
      exchange<false>(s_tot, r & 1, local, lane, &base, &rowtot);
      // pass B: the words, each thread on its own lanes only
      tile = 0;
      for (int64_t b0 = lo; b0 < hi; b0 += kTile, ++tile) {
        const uint32_t st = stage[tile * kThreads + t];
        const uint32_t need_m = st & 0xFFu;
        if (!need_m) continue;
        const int64_t i0 = b0 + static_cast<int64_t>(t) * Q;
        uint32_t xv[Q];
        loadp<Q>(xs, i0 - lo, hi - lo, xv);
        take_words<Q>(a.stream, a.stream_len, g + base + (st >> 8), need_m, xv);
        storep<Q>(xs, i0 - lo, need_m, xv);
      }
      g += rowtot;
    }
    for (int64_t i = lo + static_cast<int64_t>(t) * Q; i < hi; i += kTile) {
#pragma unroll
      for (int v = 0; v < Q; ++v)
        if (i + v < hi) a.x_out[i + v] = static_cast<int64_t>(xs[i - lo + v]);
    }
  }
  // no block leaves while another may still read its s_tot
  if (cg::this_cluster().num_blocks() > 1) cg::this_cluster().sync();
  if (blk == 0 && t == 0) *a.gptr_out = g;
}

// An empty exchange loop: `iters` rows of nothing but the cross-block
// exchange of the decode kernel (a slot write, the cluster barrier, the
// remote reads and their scan), the dependency floor of a wave.
__global__ void __launch_bounds__(kThreads, 1) exchange_loop_kernel(int iters, int* sink) {
  __shared__ int s_tot[2];
  const int lane = threadIdx.x & 31;
  int64_t acc = 0;
  for (int r = 0; r < iters; ++r) {
    int64_t base = 0, rowtot = 0;
    exchange<false>(s_tot, r & 1, r + lane, lane, &base, &rowtot);
    acc += base + rowtot;
  }
  if (cg::this_cluster().num_blocks() > 1) cg::this_cluster().sync();
  if (threadIdx.x == 0 && acc == -1) *sink = 1;  // keeps the loop
}

// The kernel variants by lanes a thread (0: several tiles a block).
constexpr int kVariants[] = {1, 2, 4, 8, 0};
constexpr int kNumVariants = 5;

const void* kernel_of(int per) {
  switch (per) {
    case 1: return reinterpret_cast<const void*>(rans_decode_wave_kernel<1>);
    case 2: return reinterpret_cast<const void*>(rans_decode_wave_kernel<2>);
    case 4: return reinterpret_cast<const void*>(rans_decode_wave_kernel<4>);
    case 8: return reinterpret_cast<const void*>(rans_decode_wave_kernel<8>);
    default: return reinterpret_cast<const void*>(rans_decode_wave_kernel<0>);
  }
}

struct Plan {
  int cluster;
  int per;  // lanes a thread of the one-tile variant, 0: several tiles
  int64_t chunk;
  size_t dyn;  // dynamic shared memory of a block
};

// The launch plan of a wave: the cluster size (`want`, or the rule's at
// 0), the lanes of a block and of a thread. With check_fit, the size is
// lowered (rule) or refused (`want`) while cudaOccupancyMaxActiveClusters
// says its blocks cannot be resident at once; without it, a size that
// cannot be resident is refused by the launch.
cudaError_t make_plan(int channels, int lanes, int contexts, int want, bool check_fit,
                      Plan* p) {
  if (channels < 1 || lanes < 1 || contexts < 1) return cudaErrorInvalidValue;
  const int64_t cnl = static_cast<int64_t>(channels) * lanes;
  if (cnl >= (int64_t{1} << 24)) return cudaErrorInvalidValue;  // ranks fit 24 bits
  if (want < 0 || want > kMaxCluster || (want & (want - 1)) != 0) return cudaErrorInvalidValue;
  const void* fns[kNumVariants];
  for (int k = 0; k < kNumVariants; ++k) fns[k] = kernel_of(kVariants[k]);
  size_t room = 0;
  cudaError_t err = device_room(fns, kNumVariants, &room);
  if (err != cudaSuccess) return err;
  const size_t tab = table_bytes(channels * contexts);
  int s = want;
  if (s == 0) {
    s = 1;
    while (s < kMaxCluster && (cnl + s - 1) / s > kBlockLanes) s *= 2;
  }
  for (;; s /= 2) {
    const int64_t chunk = ((cnl + s - 1) / s + kPerThread - 1) / kPerThread * kPerThread;
    int per = 0;
    for (int k = 0; k < kNumVariants - 1 && per == 0; ++k)
      if (chunk <= static_cast<int64_t>(kThreads) * kVariants[k]) per = kVariants[k];
    // several tiles: one staged (rank, mask) word a thread and tile
    const size_t dyn =
        tab + (per ? 0 : align16(static_cast<size_t>((chunk + kTile - 1) / kTile) * kThreads * 4));
    if (dyn > room) return cudaErrorInvalidValue;
    bool fits = true;
    if (check_fit) {
      err = cluster_fits(kernel_of(per), s, dyn, &fits);
      if (err != cudaSuccess) return err;
    }
    if (fits) {
      *p = Plan{s, per, chunk, dyn};
      return cudaSuccess;
    }
    if (want != 0 || s == 1) return cudaErrorInvalidClusterSize;
  }
}

template <int P>
cudaError_t launch(const cudaLaunchConfig_t& cfg, const WaveArgs& a) {
  return cudaLaunchKernelEx(&cfg, rans_decode_wave_kernel<P>, a);
}

}  // namespace

// The launch plan of frave_rans_decode_wave for channels x lanes with
// `contexts` contexts: *cluster the blocks it runs (`want`, a power of two
// up to 16 that must be resident at once, or 0 for the launch rule),
// *xwork_words the u32 state buffer it needs (0: none).
extern "C" int frave_rans_decode_plan(int channels, int lanes, int contexts, int want,
                                      int* cluster, int* xwork_words) {
  Plan p;
  const cudaError_t err = make_plan(channels, lanes, contexts, want, true, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  *cluster = p.cluster;
  *xwork_words = p.per ? 0 : channels * lanes;
  return 0;
}

// One wave of `images` same-shape images, one cluster of `cluster` blocks
// each: x_in / x_out [images, channels, lanes] int64, gptr_in / gptr_out
// [images] int64, bkt / syms [images, rows, channels, lanes] int32, active
// [rows, lanes] u8 (shared), stream [images, stream_len] int32, cdf
// [images, channels, contexts, 1024] and bits [images, channels, contexts]
// int32, xwork [images, xwork_words of the plan] or null where the plan
// needs none.
extern "C" int frave_rans_decode_wave(const void* x_in, const void* gptr_in,
                                      const void* bkt, const void* active,
                                      const void* stream, const void* cdf,
                                      const void* bits, void* syms,
                                      void* x_out, void* gptr_out, void* xwork,
                                      int rows, int channels, int lanes,
                                      int contexts, int stream_len, int images,
                                      int cluster, void* cuda_stream) {
  if (rows < 0 || stream_len < 1 || cluster < 1 || images < 1 || images > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  cudaError_t err = make_plan(channels, lanes, contexts, cluster, false, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.per == 0 && xwork == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  WaveArgs a;
  a.x_in = static_cast<const int64_t*>(x_in);
  a.gptr_in = static_cast<const int64_t*>(gptr_in);
  a.bkt = static_cast<const uint32_t*>(bkt);
  a.active = static_cast<const uint8_t*>(active);
  a.stream = static_cast<const int32_t*>(stream);
  a.cdf = static_cast<const int32_t*>(cdf);
  a.bits = static_cast<const int32_t*>(bits);
  a.syms = static_cast<uint32_t*>(syms);
  a.x_out = static_cast<int64_t*>(x_out);
  a.gptr_out = static_cast<int64_t*>(gptr_out);
  a.xwork = static_cast<uint32_t*>(xwork);
  a.rows = rows;
  a.channels = channels;
  a.lanes = lanes;
  a.contexts = contexts;
  a.stream_len = stream_len;
  a.chunk = p.chunk;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(p.cluster, images, p.dyn, static_cast<cudaStream_t>(cuda_stream), &attr);
  switch (p.per) {
    case 1: err = launch<1>(cfg, a); break;
    case 2: err = launch<2>(cfg, a); break;
    case 4: err = launch<4>(cfg, a); break;
    case 8: err = launch<8>(cfg, a); break;
    default: err = launch<0>(cfg, a); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// `iters` rows of the decode kernel's cross-block exchange alone, on one
// cluster of `cluster` blocks of 1024 threads (the dependency floor's
// measurement; `sink` is one int the kernel never writes in practice).
extern "C" int frave_exchange_loop(int iters, int cluster, void* sink, void* cuda_stream) {
  if (iters < 0 || cluster < 1 || cluster > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = reinterpret_cast<const void*>(exchange_loop_kernel);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(cluster, 1, 0, static_cast<cudaStream_t>(cuda_stream), &attr);
  err = cudaLaunchKernelEx(&cfg, exchange_loop_kernel, iters, static_cast<int*>(sink));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
