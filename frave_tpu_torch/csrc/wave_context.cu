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
// W, one thread a symbol of an image (grid (symbols / 256, images)), the
// image's channels in a loop so that the record is read once:
//   1. the six tap values from each (image, channel) row of the plane
//      [images * channels, row] int32 at the record's slots;
//   2. contexts with rans_context.cuh's lane_context (torch_ops.contexts:
//      the LF or HF form, every f32 product and sum rounded on its own,
//      left to right, so nothing contracts into an FMA), the group's
//      vparams / wparams row from shared memory; a fixed bucket (fbkt >= 0)
//      replaces the computed one;
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
// V, one thread a symbol of a wave of an image: unpack_signed(sym) + pred
// stored at the symbol's slot of each (image, channel) row, sym read from
// kernel 3's [parts, images, rows, channels, lanes_p] output through its
// strides (one part on one card; the tp decoder's gathered [ranks, rows,
// channels, lanes a rank] as ranks parts).
//
// Bound: bytes. W moves the records, six 4-byte taps a symbol and row and
// its outputs; V the slots, the symbols, the predictions and its stores.
// Design: a warp reads 32 consecutive records (two 16-byte loads a thread,
// coalesced) and writes 32 consecutive buckets and predictions; the taps
// and V's stores scatter over the plane, whose rows the neighbouring
// symbols share in L2. A symbol's record is read once for all channels;
// the parameters (a few hundred floats an image) and the bucket edges sit
// in shared memory. Garbage streams cannot send W out of bounds: it reads
// only the slots of the records, which CodecProgram.from_host checks
// against the plane; V stores whatever value kernel 3 decoded.

#include <cuda_runtime.h>

#include <cstdint>

#include "rans_context.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kModeDecode = 0;
constexpr int kModeEncode = 1;

struct ContextArgs {
  const int32_t* plane;   // [images * channels, row]
  const int4* rec;        // [K, 8] int32, two int4 a symbol
  const float* vparams;   // [images * channels, fine, 6]
  const float* wparams;
  const float* edges;     // [contexts - 1]
  int32_t* out0;          // decode: buckets [images, rows_w, channels, lanes_w]; encode: buckets
  int32_t* out1;          // decode: predictions [images * channels, kw]; encode: symbols
  long long row;          // the plane's row stride (int32 words)
  int k0, kw, nl, lane_lo, lanes_w, rows_w;
  int channels, fine, contexts, mode, span;
};

__global__ void __launch_bounds__(kThreads) wave_contexts_kernel(const ContextArgs a) {
  extern __shared__ float smem[];
  const int img = blockIdx.y;
  const int par = a.channels * a.fine * kTaps;
  float* s_vp = smem;
  float* s_wp = smem + par;
  float* s_edges = smem + 2 * par;
  for (int i = threadIdx.x; i < par; i += kThreads) {
    s_vp[i] = a.vparams[static_cast<long long>(img) * par + i];
    s_wp[i] = a.wparams[static_cast<long long>(img) * par + i];
  }
  for (int i = threadIdx.x; i < a.contexts - 1; i += kThreads) s_edges[i] = a.edges[i];
  __syncthreads();
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= a.span) return;
  const int C = a.channels;
  if (j >= a.kw) {  // decode mode: a pad lane of the wave's last row
    const int r = j / a.nl;
    const int l = j - r * a.nl - a.lane_lo;
    if (l >= 0 && l < a.lanes_w)
      for (int c = 0; c < C; ++c)
        a.out0[((static_cast<long long>(img) * a.rows_w + r) * C + c) * a.lanes_w + l] = 0;
    return;
  }
  const long long k = static_cast<long long>(a.k0) + j;
  const int4 r0 = __ldg(a.rec + 2 * k);
  const int4 r1 = __ldg(a.rec + 2 * k + 1);
  const int slot = r0.x;
  const int taps[kTaps] = {r0.y, r0.z, r0.w, r1.x, r1.y, r1.z};
  const int meta = r1.w;
  const bool lf = (meta & 0xFF) != 0;
  const int grp = min(max(static_cast<int>(static_cast<int8_t>((meta >> 8) & 0xFF)), 0),
                      a.fine - 1);
  const int fb = static_cast<int8_t>((meta >> 16) & 0xFF);
  int r = 0, l = 0;
  if (a.mode == kModeDecode) {
    r = j / a.nl;
    l = j - r * a.nl - a.lane_lo;
  }
  for (int c = 0; c < C; ++c) {
    const long long row = static_cast<long long>(img) * C + c;
    const int32_t* base = a.plane + row * a.row;
    int v[kTaps];
#pragma unroll
    for (int t = 0; t < kTaps; ++t) v[t] = __ldg(base + taps[t]);
    const int prow = (c * a.fine + grp) * kTaps;
    int bucket, pred;
    lane_context(v, lf, s_vp + prow, s_wp + prow, s_edges, a.contexts - 1, &bucket, &pred);
    if (fb >= 0) bucket = fb;
    const long long o = row * a.kw + j;
    if (a.mode == kModeDecode) {
      a.out1[o] = pred;
      if (l >= 0 && l < a.lanes_w)
        a.out0[((static_cast<long long>(img) * a.rows_w + r) * C + c) * a.lanes_w + l] = bucket;
    } else {
      // pack_signed in 32-bit two's complement, wrapping as torch's int32
      // ops do: d >= 0 -> 2d, else -2d - 1 = ~(2d)
      const unsigned d = static_cast<unsigned>(__ldg(base + slot)) - static_cast<unsigned>(pred);
      a.out0[o] = bucket;
      a.out1[o] = static_cast<int>(static_cast<int>(d) >= 0 ? 2u * d : ~(2u * d));
    }
  }
}

struct FinishArgs {
  const int32_t* syms;   // element (p, b, r, c, lp) at p*sp + b*sb + r*sr + c*sc + lp
  const int32_t* preds;  // [images * channels, kw]
  const int32_t* slots;  // [K] the coefficient slot of each schedule symbol
  int32_t* plane;        // [images * channels, row]
  long long sp, sb, sr, sc, row;
  int k0, kw, nl, lanes_p, channels;
};

__global__ void __launch_bounds__(kThreads) wave_finish_kernel(const FinishArgs a) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= a.kw) return;
  const int img = blockIdx.y;
  const int slot = __ldg(a.slots + a.k0 + j);
  const int r = j / a.nl;
  const int l = j - r * a.nl;
  const int p = l / a.lanes_p;
  const long long s0 = p * a.sp + img * a.sb + r * a.sr + (l - p * a.lanes_p);
  for (int c = 0; c < a.channels; ++c) {
    const long long row = static_cast<long long>(img) * a.channels + c;
    const int sym = __ldg(a.syms + s0 + c * a.sc);
    const int val = ((sym & 1) ? -((sym + 1) >> 1) : (sym >> 1)) + __ldg(a.preds + row * a.kw + j);
    a.plane[row * a.row + slot] = val;
  }
}

__global__ void wave_empty_kernel() {}

// Dynamic shared memory of W: the image's vparams and wparams, the edges.
size_t context_smem(int channels, int fine, int contexts) {
  return (2 * static_cast<size_t>(channels) * fine * kTaps + contexts) * sizeof(float);
}

dim3 grid_of(long long span, int images) {
  return dim3(static_cast<unsigned>((span + kThreads - 1) / kThreads), images, 1);
}

}  // namespace

// Kernel W over `images` images of `channels` channels: plane [images *
// channels, row] int32 (the zero slot at n_slots), rec [K, 8] int32
// (16-byte aligned), vparams / wparams [images * channels, fine, 6] f32,
// edges [contexts - 1] f32. mode 0 (decode): the wave [k0, k0 + kw) on
// rows_w rows of nl lanes, out0 buckets [images, rows_w, channels, lanes_w]
// for the lanes [lane_lo, lane_lo + lanes_w), out1 predictions [images *
// channels, kw]; mode 1 (encode): k0 0 and kw K, out0 buckets and out1
// symbols [images * channels, K].
extern "C" int frave_wave_contexts(const void* plane, long long row, const void* rec,
                                   const void* vparams, const void* wparams, const void* edges,
                                   void* out0, void* out1, int k0, int kw, int nl, int lane_lo,
                                   int lanes_w, int rows_w, int channels, int images, int fine,
                                   int contexts, int mode, void* cuda_stream) {
  if (images < 1 || images > 65535 || channels < 1 || fine < 1 || contexts < 2 ||
      kw < 1 || k0 < 0 || row < 1 || (mode != kModeDecode && mode != kModeEncode) ||
      (reinterpret_cast<uintptr_t>(rec) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  long long span = kw;
  if (mode == kModeDecode) {
    if (nl < 1 || rows_w < 1 || static_cast<long long>(rows_w) * nl < kw ||
        static_cast<long long>(rows_w - 1) * nl >= kw || lane_lo < 0 || lanes_w < 1 ||
        lane_lo + lanes_w > nl)
      return static_cast<int>(cudaErrorInvalidValue);
    span = static_cast<long long>(rows_w) * nl;
  }
  if (span >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t dyn = context_smem(channels, fine, contexts);
  if (dyn > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  ContextArgs a;
  a.plane = static_cast<const int32_t*>(plane);
  a.rec = static_cast<const int4*>(rec);
  a.vparams = static_cast<const float*>(vparams);
  a.wparams = static_cast<const float*>(wparams);
  a.edges = static_cast<const float*>(edges);
  a.out0 = static_cast<int32_t*>(out0);
  a.out1 = static_cast<int32_t*>(out1);
  a.row = row;
  a.k0 = k0;
  a.kw = kw;
  a.nl = nl;
  a.lane_lo = lane_lo;
  a.lanes_w = lanes_w;
  a.rows_w = rows_w;
  a.channels = channels;
  a.fine = fine;
  a.contexts = contexts;
  a.mode = mode;
  a.span = static_cast<int>(span);
  wave_contexts_kernel<<<grid_of(span, images), kThreads, dyn,
                         static_cast<cudaStream_t>(cuda_stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Kernel V: the wave [k0, k0 + kw) of `images` images, syms int32 read at
// the strides (sp, sb, sr, sc) of its [parts, images, rows, channels,
// lanes_p] view (parts * lanes_p = nl), preds [images * channels, kw],
// slots [K] int32, plane [images * channels, row] int32 (written in place).
extern "C" int frave_wave_finish(const void* syms, long long sp, long long sb, long long sr,
                                 long long sc, int lanes_p, const void* preds, const void* slots,
                                 void* plane, long long row, int k0, int kw, int nl,
                                 int channels, int images, void* cuda_stream) {
  if (images < 1 || images > 65535 || channels < 1 || kw < 1 || k0 < 0 || nl < 1 ||
      lanes_p < 1 || nl % lanes_p != 0 || row < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  FinishArgs a;
  a.syms = static_cast<const int32_t*>(syms);
  a.preds = static_cast<const int32_t*>(preds);
  a.slots = static_cast<const int32_t*>(slots);
  a.plane = static_cast<int32_t*>(plane);
  a.sp = sp;
  a.sb = sb;
  a.sr = sr;
  a.sc = sc;
  a.row = row;
  a.k0 = k0;
  a.kw = kw;
  a.nl = nl;
  a.lanes_p = lanes_p;
  a.channels = channels;
  wave_finish_kernel<<<grid_of(kw, images), kThreads, 0,
                       static_cast<cudaStream_t>(cuda_stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// An empty launch of `symbols` threads an image over `images` images with
// `dyn` bytes of dynamic shared memory (the floor of W or V at a shape).
extern "C" int frave_wave_empty(long long symbols, int images, long long dyn,
                                void* cuda_stream) {
  if (symbols < 1 || symbols >= (1LL << 31) || images < 1 || images > 65535 || dyn < 0 ||
      dyn > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  wave_empty_kernel<<<grid_of(symbols, images), kThreads, static_cast<size_t>(dyn),
                      static_cast<cudaStream_t>(cuda_stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
