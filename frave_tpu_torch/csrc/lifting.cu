// Per-tile Haar lifting kernels for Hopper (sm_90a), plain C interface,
// depth 9 (512 leaves a tile) only.
//
// frave_fwd_lift_pixels (kernel A) is the whole encode head: it replaces
// frave_tpu/ops/pallas_lifting.py forward_lift_quantize (_fwd_kernel)
// together with what frave_tpu/codec/pipeline_jax.py:423-428 runs before
// it (pixels.T, the channel transform _transform_device and the leaf
// gather under leaf_mask) and the trailing zero slot that the statistics
// read as the missing neighbour, for a whole same-shape batch in one
// launch (the JAX program's vmap over B). It reads the [B, H*W, C] u8
// images through the pixel map leaf_pix and writes the [B, C, >= T*512 + 1]
// int32 coefficient planes the statistics read; image b takes transform
// tids[b] (read on the device) and the grid's y index. Bound: device
// memory, and only what the head needs, per image: the pixels once
// (12.6 MB at 2048x2048 RGB; read
// through L2, which holds all of them), leaf_pix once (17.3 MB) and the
// plane once (51.9 MB), about 82 MB or 0.024 ms at 3.35 TB/s. The
// previous design took eight torch launches around a lifting kernel (the
// transpose and cast, up to eight transform passes, an int64 gather of
// the leaves, a masked select, a copy, the kernel and a concatenation for
// the zero slot: well over 400 MB at 2048x2048 RGB), and its kernel
// spent one block of 256 threads per channel row, 18 barriers a row with
// the top levels on 128, 64, ... 1 threads, a scalar global qdiv read and
// a divide an element. Design:
//   * a block of 512 threads takes `tpb` tiles (the wrapper's launch rule;
//     at most 16 / C) and stages qdiv in shared memory once;
//   * phase 1, one thread a leaf: thread k takes leaf k of each of the
//     block's tiles (so a warp takes 32 consecutive leaves, a compact patch
//     of pixels), loads its leaf_pix entries first, then the C bytes of
//     each in-bounds pixel, applies the forward transform `tid` in
//     registers and stages the C coding bytes and the in-bounds flag in
//     shared memory (0 and 0 out of bounds); one __syncthreads;
//   * phase 2, a warp lifts one channel row of one tile in registers
//     (kernel B's layout, run upwards): lane i reads the bytes and flags of
//     the 16 leaves under level-5 node i as one 16-byte load each and lifts
//     levels 8-5 in registers, which gives the coefficient runs
//     256+8i..+7, 128+4i..+3, 64+2i..+1 and 32+i; levels 4-0 go through
//     __shfl_down_sync with the masks, and one shuffle a level hands lane k
//     haar index k of the top 32;
//   * the truncated quantize (C++ `/`, skipped where q is 1) and vector
//     stores straight into the plane: every lane's runs as int4 / int2
//     stores, the warp's 2 KB row coalesced;
//   * block 0 of each image writes the zero slot of every channel row of
//     that image, and the padding columns after it, on every call (the
//     plane comes from torch.empty).
// A node whose leaves are all out of bounds is 0 (out-of-bounds leaves
// stage 0), and a missing child contributes 0, which is the reference's
// masked lifting.
//
// frave_inv_lift_pixels (kernel B) replaces dequantize_inverse_lift
// (_inv_kernel) together with the decode tail after it
// (frave_tpu/codec/grid_decode.py:511-514: the pix_inv gather, the clamp
// to [0, 255] and the inverse channel transform), for a whole same-shape
// batch in one launch: image b (the grid's y index) reads its own plane,
// qdiv row and transform tids[b]. Bound: device memory,
// and only what the decode needs: the coefficient plane is read where it
// lies (no [C*T, 512] copy), the masks once a tile for all C channels,
// leaf_pix once, and the pixels written once as bytes (about 90 MB, 0.027
// ms at 3.35 TB/s, at 2048x2048 RGB). The previous design spent one block
// of 256 threads per channel row with 9 levels between barriers (the top
// levels with 1, 2, 4, ... threads working), read every mask byte once
// per channel, and wrote int32 leaves that three more launches read back.
// Design:
//   * a warp lifts one channel row of one tile in registers, with no
//     block barrier: lane i owns the subtree under level-5 node i (16
//     leaves), whose coefficients at levels 5-8 are the runs 32+i,
//     64+2i..+1, 128+4i..+3 and 256+8i..+7 and whose mask bytes are
//     contiguous too, so every load is a vector load and the warp's
//     loads are coalesced; levels 0-4 take the top 32 coefficients, one a
//     lane, through __shfl_sync;
//   * a block holds the C warps of floor(16 / C) tiles; it stages the
//     tiles' masks and qdiv in shared memory, and one __syncthreads
//     exchanges the C clamped bytes of every leaf, after which a thread
//     runs the inverse transform of a leaf and scatters its bytes to the
//     pixel (out[c, leaf_pix[leaf]]); a warp takes 32 consecutive leaves,
//     a compact patch of the tile, so a store instruction touches few
//     sectors, and the 12.6 MB output of 2048x2048 RGB stays in the 50 MB
//     L2, which merges the partial sectors.
// The scatter equals the reference's gather because leaf_pix is a
// bijection of in-bounds leaves onto pixels (CodecProgram.from_host
// checks it). All arithmetic is int32; C++ `/` truncates toward zero,
// which is the reference's (Rust) division semantics.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLeaves = 512;      // nodes of a depth-9 tile
constexpr int kMaxTilesBlock = 16;
constexpr int kWarpsBlock = 16;   // a block: floor(16 / C) tiles of C warps
constexpr unsigned kFull = 0xFFFFFFFFu;

// int32 arithmetic that wraps as the plain version's (through u32)
__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

__device__ __forceinline__ int sgn8(int x) { return ((x + 128) & 255) - 128; }

// forward channel transform `tid` of raw (r, g, b): the coding values
__device__ __forceinline__ void forward_transform(int tid, int r, int g, int b,
                                                  int& a0, int& a1, int& a2) {
  switch (tid) {
    case 1:
      a0 = (r - g) & 255; a1 = g; a2 = (b - g) & 255;
      break;
    case 2:
      a0 = min(max(r - g + 128, 0), 255); a1 = g;
      a2 = min(max(b - g + 128, 0), 255);
      break;
    case 3: {  // -> (y, co, cg)
      const int co = (r - b) & 255;
      const int t = (b + (sgn8(co) >> 1)) & 255;
      const int cg = (g - t) & 255;
      a0 = (t + (sgn8(cg) >> 1)) & 255; a1 = co; a2 = cg;
      break;
    }
    default:
      a0 = r; a1 = g; a2 = b;
  }
}

// ---- kernel A: the encode head (transform, leaf gather, forward lifting,
// quantize, zero slot), depth 9

constexpr int kHeadThreads = 512;  // one a leaf in phase 1, 16 warps
static_assert(kHeadThreads == kLeaves && kHeadThreads == 32 * kWarpsBlock,
              "phase 1 takes one leaf a thread, phase 2 one row a warp");

// one forward lifting step over a child pair: coefficient c, parent value
// v and mask m (an absent child contributes 0)
__device__ __forceinline__ void fwd_step(int32_t lv, bool lm, int32_t rv, bool rm,
                                         int32_t& c, int32_t& v, bool& m) {
  const int32_t l0 = lm ? lv : 0, r0 = rm ? rv : 0;
  const bool both = lm && rm;
  c = both ? l0 - r0 : 0;
  v = both ? r0 + c / 2 : l0 + r0;
  m = lm || rm;
}

__device__ __forceinline__ int32_t quant(int32_t c, int32_t q) {
  return q == 1 ? c : c / q;
}

__device__ __forceinline__ int byte_of(const uint32_t* w, int e) {
  return static_cast<int>((w[e >> 2] >> (8 * (e & 3))) & 0xFFu);
}

// three blocks an SM (at most 40 registers a thread): a block's loads sit
// behind its one barrier, so the SM overlaps them with other blocks' lifting
template <int CH>
__global__ void __launch_bounds__(kHeadThreads, 3)
fwd_lift_pixels_kernel(const uint8_t* __restrict__ pixels,
                       const int32_t* __restrict__ leaf_pix,
                       const int32_t* __restrict__ qdiv,
                       const int32_t* __restrict__ tids, int32_t* __restrict__ out,
                       int64_t qstride, int64_t hw, int tiles, int tpb) {
  constexpr int kMaxT = kWarpsBlock / CH;
  __shared__ __align__(16) uint8_t s_px[kMaxT][CH][kLeaves];
  __shared__ __align__(16) uint8_t s_in[kMaxT][kLeaves];
  __shared__ __align__(16) int32_t s_q[kLeaves];
  const int tile0 = blockIdx.x * tpb;
  const int leaf = threadIdx.x;
  s_q[leaf] = __ldg(qdiv + leaf);
  // the block's image is blockIdx.y: its pixels, planes and transform are
  // offset where they are used, so that no image pointer stays live in a
  // register (three blocks an SM leave 40 a thread)

  if (blockIdx.x == 0) {  // the image's zero slot and the padding after it
    const int64_t n = static_cast<int64_t>(tiles) * kLeaves;
    const int pad = static_cast<int>(qstride - n);
    int32_t* rows = out + static_cast<int64_t>(blockIdx.y) * CH * qstride;
    for (int k = threadIdx.x; k < CH * pad; k += blockDim.x)
      rows[(k / pad) * qstride + n + k % pad] = 0;
  }

  // phase 1: leaf `leaf` of each of the block's tiles. Straight-line
  // predicated loads: every leaf_pix load goes out, then every pixel load,
  // before the first byte is used
  int p[kMaxT];
#pragma unroll
  for (int j = 0; j < kMaxT; ++j)
    p[j] = j < tpb && tile0 + j < tiles
               ? __ldg(leaf_pix + static_cast<int64_t>(tile0 + j) * kLeaves + leaf)
               : -1;
  int raw[kMaxT][CH];
#pragma unroll
  for (int j = 0; j < kMaxT; ++j) {
    const bool in = p[j] >= 0 && p[j] < hw;
    const uint8_t* px =
        pixels + CH * (static_cast<int64_t>(blockIdx.y) * hw + (in ? p[j] : 0));
#pragma unroll
    for (int c = 0; c < CH; ++c) raw[j][c] = in ? __ldg(px + c) : 0;
  }
  const int tid = CH == 3 ? __ldg(tids + blockIdx.y) : 0;
#pragma unroll
  for (int j = 0; j < kMaxT; ++j) {
    if (j < tpb) {
      int a[CH];
      if constexpr (CH == 3)
        forward_transform(tid, raw[j][0], raw[j][1], raw[j][2], a[0], a[1], a[2]);
      else
        a[0] = raw[j][0];
      // an out-of-bounds leaf stages 0 (a transform may map 0 elsewhere)
      const bool in = p[j] >= 0 && p[j] < hw;
#pragma unroll
      for (int c = 0; c < CH; ++c) s_px[j][c][leaf] = static_cast<uint8_t>(in ? a[c] : 0);
      s_in[j][leaf] = in;
    }
  }
  __syncthreads();

  // phase 2: warp (tile tl, channel c) lifts its row; no barrier below
  const int warp = threadIdx.x >> 5, i = threadIdx.x & 31;
  const int tl = warp / CH, c = warp % CH;
  if (tl >= tpb || tile0 + tl >= tiles) return;
  const uint4 pv = reinterpret_cast<const uint4*>(s_px[tl][c])[i];
  const uint4 mv = reinterpret_cast<const uint4*>(s_in[tl])[i];
  const uint32_t pw[4] = {pv.x, pv.y, pv.z, pv.w};
  const uint32_t mw[4] = {mv.x, mv.y, mv.z, mv.w};
  // levels 8-5 over the lane's 16 leaves 16i..16i+15
  int32_t c8[8], v8[8], c7[4], v7[4], c6[2], v6[2], c5, v5;
  bool m8[8], m7[4], m6[2], m5;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    fwd_step(byte_of(pw, 2 * j), byte_of(mw, 2 * j) != 0, byte_of(pw, 2 * j + 1),
             byte_of(mw, 2 * j + 1) != 0, c8[j], v8[j], m8[j]);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    fwd_step(v8[2 * j], m8[2 * j], v8[2 * j + 1], m8[2 * j + 1], c7[j], v7[j], m7[j]);
#pragma unroll
  for (int j = 0; j < 2; ++j)
    fwd_step(v7[2 * j], m7[2 * j], v7[2 * j + 1], m7[2 * j + 1], c6[j], v6[j], m6[j]);
  fwd_step(v6[0], m6[0], v6[1], m6[1], c5, v5, m5);
  // levels 4-0 across lanes: after level l, lane k with k % 2^(5-l) == 0
  // holds node k >> (5-l) of level l, and ct[l] its coefficient, haar
  // index 2^l + (k >> (5-l))
  int32_t v = v5, ct[5];
  bool m = m5;
#pragma unroll
  for (int l = 4; l >= 0; --l) {
    const int d = 1 << (4 - l);
    const int32_t rv = __shfl_down_sync(kFull, v, d);
    const bool rm = __shfl_down_sync(kFull, static_cast<int>(m), d) != 0;
    fwd_step(v, m, rv, rm, ct[l], v, m);
  }
  // lane k takes haar index k: the DC (lane 0's root) or coefficient
  // 2^l + p of level l = floor(log2 k), held by lane p << (5-l)
  int32_t top = __shfl_sync(kFull, m ? v : 0, 0);
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    const int32_t x = __shfl_sync(kFull, ct[l], ((i - (1 << l)) << (5 - l)) & 31);
    if (i >> l == 1) top = x;
  }
  // quantize with qdiv read as the same runs, and store
  const int4 q8a = reinterpret_cast<const int4*>(s_q + 256)[2 * i];
  const int4 q8b = reinterpret_cast<const int4*>(s_q + 256)[2 * i + 1];
  const int4 q7 = reinterpret_cast<const int4*>(s_q + 128)[i];
  const int2 q6 = reinterpret_cast<const int2*>(s_q + 64)[i];
  int32_t* base = out + (static_cast<int64_t>(blockIdx.y) * CH + c) * qstride +
                  static_cast<int64_t>(tile0 + tl) * kLeaves;
  base[i] = quant(top, s_q[i]);
  base[32 + i] = quant(c5, s_q[32 + i]);
  reinterpret_cast<int2*>(base + 64)[i] = make_int2(quant(c6[0], q6.x), quant(c6[1], q6.y));
  reinterpret_cast<int4*>(base + 128)[i] =
      make_int4(quant(c7[0], q7.x), quant(c7[1], q7.y), quant(c7[2], q7.z), quant(c7[3], q7.w));
  reinterpret_cast<int4*>(base + 256)[2 * i] =
      make_int4(quant(c8[0], q8a.x), quant(c8[1], q8a.y), quant(c8[2], q8a.z), quant(c8[3], q8a.w));
  reinterpret_cast<int4*>(base + 256)[2 * i + 1] =
      make_int4(quant(c8[4], q8b.x), quant(c8[5], q8b.y), quant(c8[6], q8b.z), quant(c8[7], q8b.w));
}

// ---- kernel B: dequantize + inverse lifting + pixel write, depth 9

__device__ __forceinline__ int32_t dequant(int32_t c, int32_t q) {
  // midpoint dequantize c*q + sign(c)*floor((q-1)/2)
  const int32_t sgn = (c > 0) - (c < 0);
  return wadd(wmul(c, q), sgn * (wadd(q, -1) >> 1));
}

// one inverse lifting step: parent value v, coefficient c, both children
// present -> (left, right)
__device__ __forceinline__ void inv_step(int32_t v, int32_t c, bool both,
                                         int32_t& left, int32_t& right) {
  right = both ? wadd(v, -(c / 2)) : v;
  left = both ? wadd(c, right) : v;
}

// both mask bytes of child pair `half` (0 or 1) of a 32-bit mask word
__device__ __forceinline__ bool pair_both(uint32_t w, int half) {
  return ((w >> (16 * half)) & 0xFFu) && ((w >> (16 * half + 8)) & 0xFFu);
}

// inverse channel transform `tid` of clamped coding values (a, g, c)
__device__ __forceinline__ void inverse_transform(int tid, int a, int g, int c,
                                                  int& r0, int& r1, int& r2) {
  switch (tid) {
    case 1:
      r0 = (a + g) & 255; r1 = g; r2 = (c + g) & 255;
      break;
    case 2:
      r0 = min(max(a + g - 128, 0), 255); r1 = g;
      r2 = min(max(c + g - 128, 0), 255);
      break;
    case 3: {  // (a, g, c) = (y, co, cg)
      const int t = (a - (sgn8(c) >> 1)) & 255;
      r1 = (c + t) & 255;
      r2 = (t - (sgn8(g) >> 1)) & 255;
      r0 = (g + r2) & 255;
      break;
    }
    default:
      r0 = a; r1 = g; r2 = c;
  }
}

__global__ void __launch_bounds__(512)
inv_lift_pixels_kernel(const int32_t* __restrict__ qplane, int64_t istride,
                       int64_t qstride, const uint8_t* __restrict__ node_mask,
                       const uint8_t* __restrict__ leaf_mask,
                       const int32_t* __restrict__ qdiv,
                       const int32_t* __restrict__ tids,
                       const int32_t* __restrict__ leaf_pix,
                       uint8_t* __restrict__ out, int64_t hw, int tiles,
                       int channels) {
  __shared__ __align__(16) uint8_t s_nm[kMaxTilesBlock][kLeaves];
  __shared__ __align__(16) uint8_t s_lm[kMaxTilesBlock][kLeaves];
  __shared__ __align__(16) uint8_t s_px[kMaxTilesBlock][3][kLeaves];
  __shared__ int32_t s_q[kLeaves];
  const int tpb = blockDim.x / (32 * channels);
  const int tile0 = blockIdx.x * tpb;
  const int warp = threadIdx.x >> 5, i = threadIdx.x & 31;
  const int tl = warp / channels, c = warp % channels;
  const int t = tile0 + tl;
  const bool live = t < tiles;
  // this block's image: its plane, qdiv row, transform and pixels
  const int64_t img = blockIdx.y;
  qplane += img * istride;
  qdiv += img * kLeaves;
  out += img * channels * hw;
  const int tid = channels == 3 ? __ldg(tids + img) : 0;

  // this warp's channel row of tile t: lane i takes coefficient i (the
  // top levels) and the runs of its level-5 subtree, 32+i, 64+2i..+1,
  // 128+4i..+3 and 256+8i..+7, issued before the masks are staged
  int32_t q0 = 0, q5 = 0, q6[2] = {}, q7[4] = {}, q8[8] = {};
  if (live) {
    const int32_t* cp = qplane + c * qstride + static_cast<int64_t>(t) * kLeaves;
    q0 = __ldg(cp + i);
    q5 = __ldg(cp + 32 + i);
    const int2 a = __ldg(reinterpret_cast<const int2*>(cp + 64) + i);
    const int4 b = __ldg(reinterpret_cast<const int4*>(cp + 128) + i);
    const int4 d0 = __ldg(reinterpret_cast<const int4*>(cp + 256) + 2 * i);
    const int4 d1 = __ldg(reinterpret_cast<const int4*>(cp + 256) + 2 * i + 1);
    q6[0] = a.x; q6[1] = a.y;
    q7[0] = b.x; q7[1] = b.y; q7[2] = b.z; q7[3] = b.w;
    q8[0] = d0.x; q8[1] = d0.y; q8[2] = d0.z; q8[3] = d0.w;
    q8[4] = d1.x; q8[5] = d1.y; q8[6] = d1.z; q8[7] = d1.w;
  }
  // the block's masks, read once for all C channels, and qdiv
  for (int k = threadIdx.x; k < tpb * kLeaves / 16; k += blockDim.x) {
    const int kt = k / (kLeaves / 16), o = k % (kLeaves / 16);
    if (tile0 + kt < tiles) {
      const int64_t base = static_cast<int64_t>(tile0 + kt) * kLeaves;
      reinterpret_cast<uint4*>(s_nm[kt])[o] =
          __ldg(reinterpret_cast<const uint4*>(node_mask + base) + o);
      reinterpret_cast<uint4*>(s_lm[kt])[o] =
          __ldg(reinterpret_cast<const uint4*>(leaf_mask + base) + o);
    }
  }
  for (int k = threadIdx.x; k < kLeaves; k += blockDim.x) s_q[k] = __ldg(qdiv + k);
  __syncthreads();

  if (live) {
    const uint8_t* nm = s_nm[tl];
    const uint8_t* lm = s_lm[tl];
    // levels 0-4: lane k holds coefficient k and the mask pair of its
    // children (haar 2k, 2k+1); each lane walks the path from the root to
    // its level-5 node i
    const int32_t ctop = dequant(q0, s_q[i]);
    const uint32_t mtop = *reinterpret_cast<const uint16_t*>(nm + 2 * i);
    int32_t v = __shfl_sync(kFull, ctop, 0);
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      const int k = (1 << l) + (i >> (5 - l));
      const int32_t cc = __shfl_sync(kFull, ctop, k);
      const uint32_t m = __shfl_sync(kFull, mtop, k);
      int32_t left, right;
      inv_step(v, cc, pair_both(m, 0), left, right);
      v = ((i >> (4 - l)) & 1) ? right : left;
    }
    // levels 5-8 in registers: node masks 64+2i.., 128+4i.., 256+8i..,
    // leaf masks 16i..16i+15
    int32_t a5[2], a6[4], a7[8], a8[16];
    {
      const uint32_t m = *reinterpret_cast<const uint16_t*>(nm + 64 + 2 * i);
      inv_step(v, dequant(q5, s_q[32 + i]), pair_both(m, 0), a5[0], a5[1]);
    }
    {
      const uint32_t m = *reinterpret_cast<const uint32_t*>(nm + 128 + 4 * i);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        inv_step(a5[j], dequant(q6[j], s_q[64 + 2 * i + j]), pair_both(m, j),
                 a6[2 * j], a6[2 * j + 1]);
    }
    {
      const uint2 m = *reinterpret_cast<const uint2*>(nm + 256 + 8 * i);
      const uint32_t mw[2] = {m.x, m.y};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        inv_step(a6[j], dequant(q7[j], s_q[128 + 4 * i + j]),
                 pair_both(mw[j >> 1], j & 1), a7[2 * j], a7[2 * j + 1]);
    }
    {
      const uint4 m = *reinterpret_cast<const uint4*>(lm + 16 * i);
      const uint32_t mw[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        inv_step(a7[j], dequant(q8[j], s_q[256 + 8 * i + j]),
                 pair_both(mw[j >> 1], j & 1), a8[2 * j], a8[2 * j + 1]);
    }
    // clamp to [0, 255]: the channel's 16 leaves as 16 bytes
    uint32_t px[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      px[w] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        px[w] |= static_cast<uint32_t>(min(max(a8[4 * w + e], 0), 255)) << (8 * e);
    }
    reinterpret_cast<uint4*>(s_px[tl][c])[i] = make_uint4(px[0], px[1], px[2], px[3]);
  }
  __syncthreads();

  // every leaf of the block's tiles: the C clamped values, the inverse
  // transform, one byte a channel at the leaf's pixel (-1: out of
  // bounds). A warp takes 32 consecutive leaves, a compact patch of
  // pixels, so each store instruction touches few sectors
  for (int k = threadIdx.x; k < tpb * kLeaves; k += blockDim.x) {
    const int kt = k / kLeaves, leaf = k % kLeaves;
    if (tile0 + kt >= tiles) continue;
    const int p = __ldg(leaf_pix + static_cast<int64_t>(tile0 + kt) * kLeaves + leaf);
    if (p < 0 || p >= hw) continue;
    const int a = s_px[kt][0][leaf];
    if (channels == 1) {
      out[p] = static_cast<uint8_t>(a);
      continue;
    }
    int r0, r1, r2;
    inverse_transform(tid, a, s_px[kt][1][leaf], s_px[kt][2][leaf], r0, r1, r2);
    out[p] = static_cast<uint8_t>(r0);
    out[hw + p] = static_cast<uint8_t>(r1);
    out[2 * hw + p] = static_cast<uint8_t>(r2);
  }
}

}  // namespace

// pixels [images, hw, channels] u8 (HWC images back to back), leaf_pix
// [tiles * 512] int32 (-1 out of bounds), qdiv [512] int32 (>= 1), tids
// [images] int32 (the transform of each image, 0-3, read at channels = 3;
// any other value runs as 0), hw >= 1 (pixel 0 is read in place of an
// out-of-bounds leaf's, and the bytes dropped); out: images x channels rows
// of row stride qstride int32 (>= tiles * 512 + 1, a multiple of 4),
// 16-byte aligned. Writes columns 0 .. tiles * 512 - 1 of every row (the
// plane) and zeros from tiles * 512 up to the stride. channels 1 or 3; tpb
// tiles a block, 1 .. 16 / channels; images 1 .. 65535.
extern "C" int frave_fwd_lift_pixels(const void* pixels, const void* leaf_pix,
                                     const void* qdiv, const void* tids, void* out,
                                     long long qstride, long long hw, int tiles,
                                     int channels, int images, int tpb, void* stream) {
  if ((channels != 1 && channels != 3) || tiles < 0 || hw < 0 || images < 1 ||
      images > 65535 || qstride < static_cast<long long>(tiles) * kLeaves + 1 ||
      qstride % 4 || tpb < 1 || tpb > kWarpsBlock / channels || (tiles > 0 && hw < 1) ||
      (channels == 3 && tids == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // >= 1 block an image: the zero slot
  const dim3 grid(tiles > 0 ? (tiles + tpb - 1) / tpb : 1, images);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* px = static_cast<const uint8_t*>(pixels);
  const auto* lp = static_cast<const int32_t*>(leaf_pix);
  const auto* q = static_cast<const int32_t*>(qdiv);
  const auto* td = static_cast<const int32_t*>(tids);
  auto* o = static_cast<int32_t*>(out);
  if (channels == 1)
    fwd_lift_pixels_kernel<1><<<grid, kHeadThreads, 0, st>>>(px, lp, q, td, o, qstride, hw,
                                                             tiles, tpb);
  else
    fwd_lift_pixels_kernel<3><<<grid, kHeadThreads, 0, st>>>(px, lp, q, td, o, qstride, hw,
                                                             tiles, tpb);
  return static_cast<int>(cudaGetLastError());
}

// qplane: images x C rows of the coefficient planes, image stride istride
// and row stride qstride int32 (tile t of channel c of image b at qplane +
// b * istride + c * qstride + 512 t), 16-byte aligned rows; qdiv [images,
// 512] int32, tids [images] int32 (the inverse transform of each image, 0-3,
// read at channels = 3; any other value runs as 0); out [images, C, hw] u8;
// masks and leaf_pix 16-byte aligned (the wrapper checks). channels 1 or
// 3; images 1 .. 65535.
extern "C" int frave_inv_lift_pixels(const void* qplane, long long istride,
                                     long long qstride, const void* node_mask,
                                     const void* leaf_mask, const void* qdiv,
                                     const void* tids, const void* leaf_pix, void* out,
                                     long long hw, int tiles, int channels, int images,
                                     void* stream) {
  if ((channels != 1 && channels != 3) || tiles < 0 || hw < 0 || images < 1 ||
      images > 65535 || qstride < static_cast<long long>(tiles) * kLeaves || qstride % 4 ||
      istride < qstride * channels || istride % 4 || (channels == 3 && tids == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tiles == 0) return 0;
  const int tpb = kWarpsBlock / channels;
  const dim3 grid((tiles + tpb - 1) / tpb, images);
  inv_lift_pixels_kernel<<<grid, tpb * channels * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qplane), istride, qstride,
      static_cast<const uint8_t*>(node_mask), static_cast<const uint8_t*>(leaf_mask),
      static_cast<const int32_t*>(qdiv), static_cast<const int32_t*>(tids),
      static_cast<const int32_t*>(leaf_pix), static_cast<uint8_t*>(out), hw, tiles, channels);
  return static_cast<int>(cudaGetLastError());
}
