// The grid wave chain and the encode statistics for Hopper (sm_90a), plain
// C interface: kernels W (frave_wave_contexts) and V (frave_wave_finish).
//
// Replace the device work that XLA fused around the rANS rows in
// frave_tpu/codec/grid_decode.py decode_fused_grid (:326; the tap planes,
// contexts and packing of ctx_of, to_grid and scatter_coefs, :403-471),
// build_grid_encode.stats (:598) and frave_tpu/codec/pipeline_jax.py
// step_stats (:469). The JAX package computed a wave's six context taps as
// unit shifts of dense lattice grids, because gathers were costly on the
// TPU. Every tap is a coefficient slot the schedule already names
// (sched_nbr), so here each symbol reads its own record (ops/wave_ctx.py):
// one 32-byte record a schedule symbol, [K, 8] int32 — the coefficient
// slot, the six tap slots (an absent tap names the plane's zero slot
// n_slots) and lf | group << 8 | fbkt << 16 (int8 fields).
//
// W, per symbol of the launch and (image, channel) row of the batch:
//   1. the six tap values from the row of the plane [images * channels,
//      row] int32 at the record's slots;
//   2. contexts with rans_context.cuh's lane_context (torch_ops.contexts:
//      the LF or HF form, every f32 product and sum rounded on its own,
//      left to right, so nothing contracts into an FMA), the group's
//      vparams / wparams row; a fixed bucket (fbkt >= 0) replaces the
//      computed one;
//   decode mode, one wave [k0, k0 + kw) of a decode batch:
//   3. the bucket straight into kernel 3's [images, rows, channels, lanes]
//      layout (symbol k0 + j on row j / nl, lane j % nl; the lanes of a
//      window [lane_lo, lane_lo + lanes_w) for the tp decoder, every lane
//      otherwise), zero in the pad lanes past kw; the clamped prediction
//      into [images * channels, kw];
//   encode mode, every symbol of an encode batch:
//   3. the bucket and the zig-zag symbol pack_signed(plane[slot] - pred),
//      both [images * channels, K] in schedule order (what the histogram
//      and kernel C read).
// V, per symbol of a wave and (image, channel) row: unpack_signed(sym) +
// pred stored at the symbol's slot, sym read from kernel 3's [parts,
// images, rows, channels, lanes_p] output through its strides (one part
// on one card; the tp decoder's gathered [ranks, rows, channels, lanes a
// rank] as ranks parts).
//
// Bound: bytes, and the latency of the scattered tap loads and stores.
// W moves the records, six 4-byte taps a symbol and row and its outputs;
// V the slots, the symbols, the predictions and its stores. The taps of a
// warp's 32 consecutive symbols fall in 14-20 distinct 32-byte sectors of
// a plane row in the large waves and span far more than shared memory
// holds, so they are left to L2; what the design does is read each
// record once for the batch and keep many loads in flight:
//   * a tile of kBlock / groups consecutive symbols a block, every image
//     of the batch inside the block: `groups` image groups of threads
//     (1, 2, 4 or 8; the host plan picks the most up to the batch size),
//     thread t taking symbol t % tile of the images t / tile, + groups,
//     ...; a thread reads its symbol's record with two 16-byte __ldg, the
//     next tile's while this one computes, and reuses it from registers
//     for all its images and channels (the groups threads of one symbol
//     sit in one block, so L1 serves the repeats); V reads its 4-byte
//     slot likewise, once a thread for all its images;
//   * a persistent grid: the plan's blocks (a few resident on each SM,
//     from the occupancy the card reports) walk the tiles with no block
//     barrier between them, each warp at its own pace, so the launch
//     costs what a small grid costs whatever the wave (a TMA ring of the
//     tiles' records in shared memory, refilled behind a block barrier a
//     tile, ran 5-11% slower at 2048x2048 RGB: PERF.md §6);
//   * the channel count a template parameter (1, 3, and any other count
//     channel by channel), every pointer __restrict__, and each image's
//     C x 6 tap loads (and the encode targets; V's C symbol and prediction
//     loads) written before its arithmetic, so that they are in flight
//     together;
//   * the parameters through __ldg, three float2 loads a row each: a
//     warp's symbols mostly share a group row (groups occupy contiguous
//     schedule ranges), so the loads are L1 broadcasts; staging them would
//     copy B * C * F * 48 bytes into every block, more than the whole
//     launch's bound at B = 64. The bucket edges sit in shared memory,
//     copied once a block.
//   * V walks each wave in slot order through a per-wave permutation
//     built once a program (ops/wave_ctx.py slot_order_host) where the
//     wrapper's rule asks for it (a non-null `order`): a warp's 32 stores
//     touch ~4-5 sectors of a plane row instead of ~16, its symbol and
//     prediction loads scatter instead, and loads cost less than partly
//     written sectors on large waves; on small ones the permutation's load,
//     which the others wait for, costs more (PERF.md §6).
// Garbage streams cannot send W out of bounds: it reads only the slots of
// the records, which CodecProgram.from_host checks against the plane; V
// stores whatever value kernel 3 decoded.

#include <cuda_runtime.h>

#include <cstdint>

#include "rans_context.cuh"

namespace {

constexpr int kBlock = 256;       // threads a block of W and V (2^8: tile_log2_of)
constexpr int kMaxGroups = 8;     // image groups a block (tile >= 32 symbols)
constexpr int kMaxEdges = 64;
constexpr int kModeDecode = 0;
constexpr int kModeEncode = 1;

struct WaveGeom {
  long long row;  // the plane's row stride (int32 words)
  int k0, kw, nl, lane_lo, lanes_w, rows_w;
  int channels, images, fine, nedges, span, tiles, groups, tile_log2;
};

// The fields of a record's last word: lf, the group row (clamped to the
// fits) and the fixed bucket (< 0: none).
struct Meta {
  bool lf;
  int grp, fb;
};

__device__ __forceinline__ Meta unpack_meta(int meta, int fine) {
  Meta m;
  m.lf = (meta & 0xFF) != 0;
  m.grp = min(max(static_cast<int>(static_cast<int8_t>((meta >> 8) & 0xFF)), 0), fine - 1);
  m.fb = static_cast<int8_t>((meta >> 16) & 0xFF);
  return m;
}

// kN channels of one image from channel c0 on: every tap load (and the
// encode target) first, then each channel's parameters, contexts and
// stores.
template <int kN, int kMode>
__device__ __forceinline__ void image_contexts(
    const int32_t* __restrict__ plane, const float* __restrict__ vparams,
    const float* __restrict__ wparams, const float* s_edges, int32_t* __restrict__ out0,
    int32_t* __restrict__ out1, const WaveGeom& g, int img, int c0, int C,
    const int (&taps)[kTaps], int slot, const Meta& m, int j, int r, int l) {
  int v[kN][kTaps];
  int tgt[kN];
#pragma unroll
  for (int c = 0; c < kN; ++c) {
    const long long row = static_cast<long long>(img) * C + c0 + c;
    const int32_t* base = plane + row * g.row;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) v[c][t] = __ldg(base + taps[t]);
    if (kMode == kModeEncode) tgt[c] = __ldg(base + slot);
  }
#pragma unroll
  for (int c = 0; c < kN; ++c) {
    const long long row = static_cast<long long>(img) * C + c0 + c;
    float vp[kTaps], wp[kTaps];  // the group row, an L1 broadcast mostly
    const long long prow = (row * g.fine + m.grp) * kTaps;
#pragma unroll
    for (int t = 0; t < kTaps / 2; ++t) {  // rows of 24 bytes: three float2 each
      const float2 a = __ldg(reinterpret_cast<const float2*>(vparams + prow) + t);
      const float2 b = __ldg(reinterpret_cast<const float2*>(wparams + prow) + t);
      vp[2 * t] = a.x;
      vp[2 * t + 1] = a.y;
      wp[2 * t] = b.x;
      wp[2 * t + 1] = b.y;
    }
    int bucket, pred;
    lane_context(v[c], m.lf, vp, wp, s_edges, g.nedges, &bucket, &pred);
    if (m.fb >= 0) bucket = m.fb;
    const long long o = row * g.kw + j;
    if (kMode == kModeDecode) {
      out1[o] = pred;
      if (l >= 0 && l < g.lanes_w)
        out0[((static_cast<long long>(img) * g.rows_w + r) * C + c0 + c) * g.lanes_w + l] =
            bucket;
    } else {
      // pack_signed in 32-bit two's complement, wrapping as torch's int32
      // ops do: d >= 0 -> 2d, else -2d - 1 = ~(2d)
      const unsigned d = static_cast<unsigned>(tgt[c]) - static_cast<unsigned>(pred);
      out0[o] = bucket;
      out1[o] = static_cast<int>(static_cast<int>(d) >= 0 ? 2u * d : ~(2u * d));
    }
  }
}

// Kernel W: kC channels (0: any count, channel by channel), kMode decode
// or encode. The block walks tiles blockIdx.x, + gridDim.x, ...; each
// thread loads its record of tile n + gridDim.x while it computes tile n.
// Three channels are held to 80 registers and one to 64, so that three
// and four blocks fit an SM (at ~97 registers only two did, and the
// 2048x2048 RGB wave ran 10% slower; at 70 the B = 64 batch ran 12%
// slower).
template <int kC, int kMode>
__global__ void __launch_bounds__(kBlock, kC == 3 ? 3 : 4) wave_contexts_kernel(
    const int32_t* __restrict__ plane, const int4* __restrict__ rec,
    const float* __restrict__ vparams, const float* __restrict__ wparams,
    const float* __restrict__ edges, int32_t* __restrict__ out0, int32_t* __restrict__ out1,
    const WaveGeom g) {
  __shared__ float s_edges[kMaxEdges];
  const int t = threadIdx.x;
  const int tile = 1 << g.tile_log2;
  const int s = t & (tile - 1);
  const int grp0 = t >> g.tile_log2;
  const int C = kC > 0 ? kC : g.channels;
  for (int i = t; i < g.nedges; i += kBlock) s_edges[i] = edges[i];
  __syncthreads();  // the edges
  const int step = gridDim.x;
  // this thread's record of tile n into (n0, n1), if it has one
  int4 n0 = make_int4(0, 0, 0, 0), n1 = n0;
  auto fetch = [&](int n) {
    const long long jj = (static_cast<long long>(n) << g.tile_log2) + s;
    if (n < g.tiles && jj < g.kw) {
      n0 = __ldg(rec + 2 * (g.k0 + jj));
      n1 = __ldg(rec + 2 * (g.k0 + jj) + 1);
    }
  };
  fetch(blockIdx.x);
  for (int n = blockIdx.x; n < g.tiles; n += step) {
    const int4 r0 = n0, r1 = n1;
    fetch(n + step);
    const int j = (n << g.tile_log2) + s;
    int r = 0, l = 0;
    if (kMode == kModeDecode) {
      r = j / g.nl;
      l = j - r * g.nl - g.lane_lo;
    }
    if (j < g.kw) {
      const int taps[kTaps] = {r0.y, r0.z, r0.w, r1.x, r1.y, r1.z};
      const Meta m = unpack_meta(r1.w, g.fine);
      if constexpr (kC == 1) {
        // one channel: two images a step, so that the next image's loads
        // go out before this one's arithmetic (more registers than three
        // channels can afford; one image each is what they hold)
#pragma unroll 2
        for (int img = grp0; img < g.images; img += g.groups)
          image_contexts<1, kMode>(plane, vparams, wparams, s_edges, out0, out1, g, img, 0, 1,
                                   taps, r0.x, m, j, r, l);
      } else if constexpr (kC > 1) {
        for (int img = grp0; img < g.images; img += g.groups)
          image_contexts<kC, kMode>(plane, vparams, wparams, s_edges, out0, out1, g, img, 0, C,
                                    taps, r0.x, m, j, r, l);
      } else {
        for (int img = grp0; img < g.images; img += g.groups)
          for (int c = 0; c < C; ++c)
            image_contexts<1, kMode>(plane, vparams, wparams, s_edges, out0, out1, g, img, c, C,
                                     taps, r0.x, m, j, r, l);
      }
    } else if (kMode == kModeDecode && j < g.span && l >= 0 && l < g.lanes_w) {
      // a pad lane of the wave's last row
      for (int img = grp0; img < g.images; img += g.groups)
        for (int c = 0; c < C; ++c)
          out0[((static_cast<long long>(img) * g.rows_w + r) * C + c) * g.lanes_w + l] = 0;
    }
  }
}

struct FinishGeom {
  long long sp, sb, sr, sc, row;
  int k0, kw, nl, lanes_p, channels, images, tiles, groups, tile_log2;
};

// Kernel V: kC channels (0: any count). A thread's slot (and, in slot
// order, its position in the wave) is read once for all its images; each
// image's C symbol and prediction loads go out before its stores.
template <int kC, bool kSlot>
__global__ void __launch_bounds__(kBlock) wave_finish_kernel(
    const int32_t* __restrict__ syms, const int32_t* __restrict__ preds,
    const int32_t* __restrict__ slots, const int2* __restrict__ order,
    int32_t* __restrict__ plane, const FinishGeom g) {
  const int t = threadIdx.x;
  const int tile = 1 << g.tile_log2;
  const int s = t & (tile - 1);
  const int grp0 = t >> g.tile_log2;
  const int C = kC > 0 ? kC : g.channels;
  constexpr int kN = kC > 0 ? kC : 1;
  for (int n = blockIdx.x; n < g.tiles; n += gridDim.x) {
    const int j = (n << g.tile_log2) + s;
    if (j >= g.kw) continue;
    int q = j, slot;
    if constexpr (kSlot) {
      const int2 o = __ldg(order + g.k0 + j);  // (position in the wave, slot)
      q = o.x;
      slot = o.y;
    } else {
      slot = __ldg(slots + g.k0 + j);
    }
    const int r = q / g.nl;
    const int l = q - r * g.nl;
    const int p = l / g.lanes_p;
    const long long s0 = p * g.sp + r * g.sr + (l - p * g.lanes_p);
    for (int img = grp0; img < g.images; img += g.groups) {
      for (int c0 = 0; c0 < C; c0 += kN) {
        int sym[kN], pr[kN];
#pragma unroll
        for (int c = 0; c < kN; ++c) {
          const long long row = static_cast<long long>(img) * C + c0 + c;
          sym[c] = __ldg(syms + s0 + img * g.sb + (c0 + c) * g.sc);
          pr[c] = __ldg(preds + row * g.kw + q);
        }
#pragma unroll
        for (int c = 0; c < kN; ++c) {
          const int y = sym[c];
          plane[(static_cast<long long>(img) * C + c0 + c) * g.row + slot] =
              ((y & 1) ? -((y + 1) >> 1) : (y >> 1)) + pr[c];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kBlock) wave_empty_kernel() {}

template <int kC>
const void* contexts_fn(int mode) {
  return mode == kModeDecode
             ? reinterpret_cast<const void*>(wave_contexts_kernel<kC, kModeDecode>)
             : reinterpret_cast<const void*>(wave_contexts_kernel<kC, kModeEncode>);
}

// Kernel W at channels (1, 3, any other) and mode.
template <int kMode>
void launch_contexts(int channels, dim3 grid, cudaStream_t st, const int32_t* p, const int4* r,
                     const float* vp, const float* wp, const float* e, int32_t* o0, int32_t* o1,
                     const WaveGeom& g) {
#define FRAVE_W(KC) wave_contexts_kernel<KC, kMode><<<grid, kBlock, 0, st>>>(p, r, vp, wp, e, o0, o1, g)
  if (channels == 1) FRAVE_W(1);
  else if (channels == 3) FRAVE_W(3);
  else FRAVE_W(0);
#undef FRAVE_W
}

// The kernel of a launch: 0 W's decode, 1 W's encode, 2 V; the
// instantiation for `channels` (1, 3, any other).
const void* kernel_of(int kernel, int channels) {
  if (kernel == 2)
    return channels == 1   ? reinterpret_cast<const void*>(wave_finish_kernel<1, true>)
           : channels == 3 ? reinterpret_cast<const void*>(wave_finish_kernel<3, true>)
                           : reinterpret_cast<const void*>(wave_finish_kernel<0, true>);
  return channels == 1 ? contexts_fn<1>(kernel) : channels == 3 ? contexts_fn<3>(kernel)
                                                                : contexts_fn<0>(kernel);
}

// log2 of a tile's symbols: kBlock / groups
int tile_log2_of(int groups) {
  int lg = 0;
  while ((1 << lg) < groups) ++lg;
  return 8 - lg;
}

bool valid_plan(int groups, int blocks) {
  return (groups == 1 || groups == 2 || groups == 4 || groups == kMaxGroups) && blocks >= 1;
}

}  // namespace

// The launch plan's inputs for kernel `kernel` (0 W decode, 1 W encode, 2
// V) at `channels`: the card's SM count and the blocks of the
// instantiation resident on one SM.
extern "C" int frave_wave_occupancy(int kernel, int channels, int* sms, int* per_sm) {
  if (kernel < 0 || kernel > 2 || channels < 1) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel_of(kernel, channels),
                                                        kBlock, 0);
  return static_cast<int>(err);
}

// Kernel W over `images` images of `channels` channels: plane [images *
// channels, row] int32 (the zero slot at n_slots), rec [K, 8] int32
// (16-byte aligned), vparams / wparams [images * channels, fine, 6] f32,
// edges [contexts - 1] f32. mode 0 (decode): the wave [k0, k0 + kw) on
// rows_w rows of nl lanes, out0 buckets [images, rows_w, channels, lanes_w]
// for the lanes [lane_lo, lane_lo + lanes_w), out1 predictions [images *
// channels, kw]; mode 1 (encode): k0 0 and kw K, out0 buckets and out1
// symbols [images * channels, K]. groups (1, 2, 4, 8) image groups a block
// of kBlock / groups symbols, blocks the persistent grid (the wrapper's
// plan).
extern "C" int frave_wave_contexts(const void* plane, long long row, const void* rec,
                                   const void* vparams, const void* wparams, const void* edges,
                                   void* out0, void* out1, int k0, int kw, int nl, int lane_lo,
                                   int lanes_w, int rows_w, int channels, int images, int fine,
                                   int contexts, int mode, int groups, int blocks,
                                   void* cuda_stream) {
  if (images < 1 || channels < 1 || fine < 1 || contexts < 2 || contexts - 1 > kMaxEdges ||
      kw < 1 || k0 < 0 || row < 1 || (mode != kModeDecode && mode != kModeEncode) ||
      !valid_plan(groups, blocks) ||
      (reinterpret_cast<uintptr_t>(rec) & 15) != 0 ||
      ((reinterpret_cast<uintptr_t>(vparams) | reinterpret_cast<uintptr_t>(wparams)) & 7) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  long long span = kw;
  if (mode == kModeDecode) {
    if (nl < 1 || rows_w < 1 || static_cast<long long>(rows_w) * nl < kw ||
        static_cast<long long>(rows_w - 1) * nl >= kw || lane_lo < 0 || lanes_w < 1 ||
        lane_lo + lanes_w > nl)
      return static_cast<int>(cudaErrorInvalidValue);
    span = static_cast<long long>(rows_w) * nl;
  }
  if (span + kBlock >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  WaveGeom g;
  g.row = row;
  g.k0 = k0;
  g.kw = kw;
  g.nl = nl;
  g.lane_lo = lane_lo;
  g.lanes_w = lanes_w;
  g.rows_w = rows_w;
  g.channels = channels;
  g.images = images;
  g.fine = fine;
  g.nedges = contexts - 1;
  g.span = static_cast<int>(span);
  g.groups = groups;
  g.tile_log2 = tile_log2_of(groups);
  g.tiles = static_cast<int>((span + (1 << g.tile_log2) - 1) >> g.tile_log2);
  const dim3 grid(static_cast<unsigned>(blocks < g.tiles ? blocks : g.tiles));
  const auto st = static_cast<cudaStream_t>(cuda_stream);
  const auto* p = static_cast<const int32_t*>(plane);
  const auto* r = static_cast<const int4*>(rec);
  const auto* vp = static_cast<const float*>(vparams);
  const auto* wp = static_cast<const float*>(wparams);
  const auto* e = static_cast<const float*>(edges);
  auto* o0 = static_cast<int32_t*>(out0);
  auto* o1 = static_cast<int32_t*>(out1);
  if (mode == kModeDecode)
    launch_contexts<kModeDecode>(channels, grid, st, p, r, vp, wp, e, o0, o1, g);
  else
    launch_contexts<kModeEncode>(channels, grid, st, p, r, vp, wp, e, o0, o1, g);
  return static_cast<int>(cudaGetLastError());
}

// Kernel V: the wave [k0, k0 + kw) of `images` images, syms int32 read at
// the strides (sp, sb, sr, sc) of its [parts, images, rows, channels,
// lanes_p] view (parts * lanes_p = nl), preds [images * channels, kw],
// slots [K] int32, plane [images * channels, row] int32 (written in place).
// order [K] int2 (position in its wave, slot) of each wave in slot order:
// the wave walked through it, or in schedule order where it is null;
// groups and blocks as W's.
extern "C" int frave_wave_finish(const void* syms, long long sp, long long sb, long long sr,
                                 long long sc, int lanes_p, const void* preds, const void* slots,
                                 const void* order, void* plane, long long row, int k0, int kw,
                                 int nl, int channels, int images, int groups, int blocks,
                                 void* cuda_stream) {
  if (images < 1 || channels < 1 || kw < 1 || k0 < 0 || nl < 1 || lanes_p < 1 ||
      nl % lanes_p != 0 || row < 1 || !valid_plan(groups, blocks) ||
      static_cast<long long>(kw) + kBlock >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  FinishGeom g;
  g.sp = sp;
  g.sb = sb;
  g.sr = sr;
  g.sc = sc;
  g.row = row;
  g.k0 = k0;
  g.kw = kw;
  g.nl = nl;
  g.lanes_p = lanes_p;
  g.channels = channels;
  g.images = images;
  g.groups = groups;
  g.tile_log2 = tile_log2_of(groups);
  g.tiles = (kw + (1 << g.tile_log2) - 1) >> g.tile_log2;
  const dim3 grid(static_cast<unsigned>(blocks < g.tiles ? blocks : g.tiles));
  const auto st = static_cast<cudaStream_t>(cuda_stream);
  const auto* y = static_cast<const int32_t*>(syms);
  const auto* pr = static_cast<const int32_t*>(preds);
  const auto* sl = static_cast<const int32_t*>(slots);
  const auto* od = static_cast<const int2*>(order);
  auto* pl = static_cast<int32_t*>(plane);
#define FRAVE_V(KC, KS) wave_finish_kernel<KC, KS><<<grid, kBlock, 0, st>>>(y, pr, sl, od, pl, g)
  if (od != nullptr) {
    if (channels == 1) FRAVE_V(1, true);
    else if (channels == 3) FRAVE_V(3, true);
    else FRAVE_V(0, true);
  } else {
    if (channels == 1) FRAVE_V(1, false);
    else if (channels == 3) FRAVE_V(3, false);
    else FRAVE_V(0, false);
  }
#undef FRAVE_V
  return static_cast<int>(cudaGetLastError());
}

// An empty launch of the grid of kernel `kernel` (0 W decode, 1 W encode,
// 2 V) at `channels`: `blocks` blocks of kBlock threads with the kernel's
// shared memory (the floor of a launch on the plan's grid).
extern "C" int frave_wave_empty(int kernel, int channels, int blocks, void* cuda_stream) {
  if (kernel < 0 || kernel > 2 || channels < 1 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel_of(kernel, channels));
  if (err != cudaSuccess) return static_cast<int>(err);
  wave_empty_kernel<<<blocks, kBlock, attr.sharedSizeBytes,
                      static_cast<cudaStream_t>(cuda_stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
