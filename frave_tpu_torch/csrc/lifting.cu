// Per-tile Haar lifting kernels for Hopper (sm_90a), plain C interface.
//
// frave_fwd_lift_quant (kernel A) replaces frave_tpu/ops/pallas_lifting.py
// forward_lift_quantize (_fwd_kernel): the TPU kernel walked 128 tiles at
// once in an [N, T] nodes-on-sublanes layout; here the layout is [rows, N]
// (one tile's 2^depth nodes contiguous, the layout of
// ops/jax_ops.forward_lifting), and one block of 256 threads walks one
// tile's tree in shared memory, one lifting level per __syncthreads().
// Bound: device memory (4 B in, 4 B out, 1 B of mask an element).
//
// frave_inv_lift_pixels (kernel B) replaces dequantize_inverse_lift
// (_inv_kernel) together with the decode tail after it
// (frave_tpu/codec/grid_decode.py:511-514: the pix_inv gather, the clamp
// to [0, 255] and the inverse channel transform), depth 9 only. Bound:
// device memory, and only what the decode needs: the coefficient plane is
// read where it lies (no [C*T, 512] copy), the masks once a tile for all
// C channels, leaf_pix once, and the pixels written once as bytes (about
// 90 MB, 0.027 ms at 3.35 TB/s, at 2048x2048 RGB). The previous design
// spent one block of 256 threads per channel row with 9 levels between
// barriers (the top levels with 1, 2, 4, ... threads working), read every
// mask byte once per channel, and wrote int32 leaves that three more
// launches read back. Design:
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

constexpr int kThreads = 256;  // one pair per thread at the widest level
constexpr int kMaxDepth = 9;   // 512 nodes per tile

__global__ void fwd_lift_quant_kernel(const int32_t* __restrict__ leaves,
                                      const uint8_t* __restrict__ mask,
                                      int mask_rows,
                                      const int32_t* __restrict__ qdiv,
                                      int32_t* __restrict__ out, int depth) {
  __shared__ int32_t vals[1 << kMaxDepth];
  __shared__ int32_t coef[1 << kMaxDepth];
  __shared__ uint8_t msk[1 << kMaxDepth];
  const int n = 1 << depth;
  const int64_t row = blockIdx.x;
  const int32_t* src = leaves + row * n;
  const uint8_t* msrc = mask + (row % mask_rows) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    vals[i] = src[i];
    msk[i] = msrc[i] != 0;
  }
  __syncthreads();
  for (int level = depth - 1; level >= 0; --level) {
    const int pairs = 1 << level;
    const int p = threadIdx.x;
    int32_t low = 0;
    uint8_t m = 0;
    if (p < pairs) {
      const bool lm = msk[2 * p], rm = msk[2 * p + 1];
      const int32_t l0 = lm ? vals[2 * p] : 0;
      const int32_t r0 = rm ? vals[2 * p + 1] : 0;
      const bool both = lm && rm;
      const int32_t c = both ? l0 - r0 : 0;
      coef[pairs + p] = c;  // haar indices [2^level, 2^(level+1))
      low = both ? r0 + c / 2 : l0 + r0;
      m = lm || rm;
    }
    __syncthreads();  // every pair is read before any low is written
    if (p < pairs) {
      vals[p] = low;
      msk[p] = m;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) coef[0] = msk[0] ? vals[0] : 0;
  __syncthreads();
  int32_t* dst = out + row * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = coef[i] / qdiv[i];
}

// ---- kernel B: dequantize + inverse lifting + pixel write, depth 9

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

__device__ __forceinline__ int sgn8(int x) { return ((x + 128) & 255) - 128; }

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
inv_lift_pixels_kernel(const int32_t* __restrict__ qplane, int64_t qstride,
                       const uint8_t* __restrict__ node_mask,
                       const uint8_t* __restrict__ leaf_mask,
                       const int32_t* __restrict__ qdiv,
                       const int32_t* __restrict__ leaf_pix,
                       uint8_t* __restrict__ out, int64_t hw, int tiles,
                       int channels, int tid) {
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

extern "C" int frave_fwd_lift_quant(const void* leaves, const void* mask,
                                    int mask_rows, const void* qdiv, void* out,
                                    int rows, int depth, void* stream) {
  if (depth < 1 || depth > kMaxDepth || rows < 0 || mask_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  fwd_lift_quant_kernel<<<rows, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(leaves), static_cast<const uint8_t*>(mask),
      mask_rows, static_cast<const int32_t*>(qdiv),
      static_cast<int32_t*>(out), depth);
  return static_cast<int>(cudaGetLastError());
}

// qplane: C rows of the coefficient plane, row stride qstride int32
// (tile t of channel c at qplane + c * qstride + 512 t), 16-byte aligned
// rows; masks and leaf_pix 16-byte aligned (the wrapper checks). channels
// 1 or 3 (the inverse transform `tid`, 0-3, runs at 3).
extern "C" int frave_inv_lift_pixels(const void* qplane, long long qstride,
                                     const void* node_mask,
                                     const void* leaf_mask, const void* qdiv,
                                     const void* leaf_pix, void* out,
                                     long long hw, int tiles, int channels,
                                     int tid, void* stream) {
  if ((channels != 1 && channels != 3) || tiles < 0 || hw < 0 || tid < 0 ||
      tid > 3 || qstride < static_cast<long long>(tiles) * kLeaves || qstride % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tiles == 0) return 0;
  const int tpb = kWarpsBlock / channels;
  const int blocks = (tiles + tpb - 1) / tpb;
  inv_lift_pixels_kernel<<<blocks, tpb * channels * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qplane), qstride, static_cast<const uint8_t*>(node_mask),
      static_cast<const uint8_t*>(leaf_mask), static_cast<const int32_t*>(qdiv),
      static_cast<const int32_t*>(leaf_pix), static_cast<uint8_t*>(out), hw, tiles, channels,
      tid);
  return static_cast<int>(cudaGetLastError());
}
