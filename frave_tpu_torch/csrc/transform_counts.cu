// The gradient counts of the RGB transform choice, for Hopper (sm_90a),
// plain C interface.
//
// frave_transform_counts replaces no TPU kernel: the JAX package chooses
// each RGB image's channel transform on the host, in NumPy
// (frave_tpu/codec/channel_transform.py select_transform), and the port
// counted on the host too (codec/channel_transform.py _gradient_counts:
// two torch.bincount passes a plane, sixteen an image, each after its
// own maximum, minimum and subtraction passes), while the card, which
// already held the image for kernel A, waited. It was added because that
// count was the largest idle gap of every RGB encode. For a same-shape
// batch of [B, H*W, 3] u8 images it writes [B, N, 256] int32: entry
// [b, p, k] counts |dx| = k plus |dy| = k of coding plane p of image b on
// the transform proxy's subsample (rows and columns 0, s, 2s, ...), the
// planes of _candidate_planes in its order and with its uint8 wraps:
// N = 8 lossless (R, G, B, R-G, B-G and YCoCg's Y, Co, Cg, whose
// half-steps shift the int8 view), N = 5 lossy (R, G, B and the two
// differences clamped to [0, 255] around 128). The counts are integers,
// so they equal the host's bit for bit, whatever the order of the adds.
//
// Bound: not the bytes. The subsample's pixels are 1.18 MB at 768x512
// (stride 1) and 0.79 MB at 2048x2048 (stride 4), 0.35 and 0.24 us at
// 3.35 TB/s; what costs is 2N histogram increments a pixel (6.3 M at
// 768x512, lossless), and on photographs most gradients are 0 or 1, so
// the increments pile onto the same few bins. Design:
//   * a block of 4 warps takes a band of kBandRows subsample rows by a
//     chunk of kCols subsample columns of one image (grid (chunks x
//     bands, B)); a warp takes 32 consecutive columns, the first of them
//     the column left of the warp's 31, so each lane loads one pixel a
//     row (3 bytes; a warp's loads hit consecutive bytes at stride 1) and
//     gets its left neighbour's planes from the lane below
//     (__shfl_up_sync) for dx;
//   * a thread walks its column down the band from the row above it,
//     keeps the row above's planes in registers for dy, and loads the
//     next row's pixel before it counts the current one;
//   * the N planes ride packed, four bytes a word, and __vabsdiffu4
//     takes the four |d| of a word at once;
//   * |d| = 0 and 1 are counted in registers (2N a thread) and summed
//     over the warp by __reduce_add_sync at the end; larger ones go to
//     the warp's own histogram in shared memory ([N][256] u32, 8 KB
//     lossless), so no two warps contend for a bin;
//   * after one __syncthreads each thread sums its bins over the 4 warps
//     and adds those that are not 0 to the zeroed output with one global
//     atomicAdd each.
// The last band and chunk are short: lanes past the last column load and
// count nothing, and a walk stops at the last row.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = kWarps * 31;  // subsample columns a block counts: 31 a warp
constexpr int kBandRows = 32;       // subsample rows a block walks
constexpr int kBins = 256;

__device__ __forceinline__ uint32_t load_rgb(const uint8_t* p) {
  return static_cast<uint32_t>(__ldg(p)) | static_cast<uint32_t>(__ldg(p + 1)) << 8 |
         static_cast<uint32_t>(__ldg(p + 2)) << 16;
}

__device__ __forceinline__ uint32_t half_step(int x) {
  return static_cast<uint32_t>(static_cast<int>(static_cast<int8_t>(x)) >> 1);
}

// the coding planes of one pixel (rgb: R | G << 8 | B << 16), four a
// word: x = R, G, B, plane 3; y = plane 4 and, lossless, Y, Co, Cg
template <bool kLossless>
__device__ __forceinline__ uint2 coding_planes(uint32_t rgb) {
  const int r = rgb & 255, g = (rgb >> 8) & 255, b = (rgb >> 16) & 255;
  if (!kLossless) {
    const uint32_t p3 = min(max(r - g + 128, 0), 255), p4 = min(max(b - g + 128, 0), 255);
    return make_uint2(rgb | p3 << 24, p4);
  }
  const uint32_t co = (r - b) & 255;
  const uint32_t t = (b + half_step(co)) & 255;
  const uint32_t cg = (g - t) & 255;
  const uint32_t y = (t + half_step(cg)) & 255;
  return make_uint2(rgb | ((r - g) & 255u) << 24, ((b - g) & 255u) | y << 8 | co << 16 | cg << 24);
}

// counts the |d| of the N planes in the words d (x: planes 0-3, y: 4-7):
// 0 and 1 in the thread's registers, the rest in the warp's histogram
template <int N>
__device__ __forceinline__ void tally(uint2 d, uint32_t* hist, uint32_t (&zero)[N],
                                      uint32_t (&one)[N]) {
#pragma unroll
  for (int p = 0; p < N; ++p) {
    const uint32_t k = ((p < 4 ? d.x : d.y) >> (8 * (p & 3))) & 255;
    zero[p] += k == 0;
    one[p] += k == 1;
    if (k > 1) atomicAdd(hist + p * kBins + k, 1u);
  }
}

template <bool kLossless>
__global__ void __launch_bounds__(kThreads)
    transform_counts_kernel(const uint8_t* __restrict__ pixels, int32_t* __restrict__ out,
                            int h, int w, int s, int hs, int ws, int chunks) {
  constexpr int N = kLossless ? 8 : 5;
  __shared__ uint32_t hist[kWarps][N * kBins];
  for (int i = threadIdx.x; i < kWarps * N * kBins; i += kThreads) (&hist[0][0])[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunk = blockIdx.x % chunks, band = blockIdx.x / chunks;
  // lane 0 takes the column left of the warp's (-1 left of the image)
  const int col = chunk * kCols + warp * 31 + lane - 1;
  const bool loads = col >= 0 && col < ws;
  const bool counts = loads && lane > 0;
  const int r0 = band * kBandRows, r1 = min(r0 + kBandRows, hs);
  const int first = max(r0 - 1, 0);
  const long long row_bytes = 3LL * s * w;
  const uint8_t* p = pixels + 3LL * blockIdx.y * h * w + first * row_bytes +
                     3LL * s * max(col, 0);
  uint32_t* own = hist[warp];
  uint32_t zero[N], one[N];
#pragma unroll
  for (int q = 0; q < N; ++q) zero[q] = one[q] = 0;

  uint32_t next = loads ? load_rgb(p) : 0;
  uint2 above = make_uint2(0, 0);
  for (int i = first; i < r1; ++i) {
    const uint32_t rgb = next;
    p += row_bytes;
    next = loads && i + 1 < r1 ? load_rgb(p) : 0;
    const uint2 v = coding_planes<kLossless>(rgb);
    const uint2 left = make_uint2(__shfl_up_sync(0xffffffffu, v.x, 1),
                                  __shfl_up_sync(0xffffffffu, v.y, 1));
    if (counts && i >= r0) {
      if (col > 0)
        tally<N>(make_uint2(__vabsdiffu4(v.x, left.x), __vabsdiffu4(v.y, left.y)), own, zero,
                 one);
      if (i > 0)
        tally<N>(make_uint2(__vabsdiffu4(v.x, above.x), __vabsdiffu4(v.y, above.y)), own,
                 zero, one);
    }
    above = v;
  }
  // bins 0 and 1 take no atomics: the warp's sums are stored by lane 0
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const uint32_t z = __reduce_add_sync(0xffffffffu, zero[q]);
    const uint32_t o = __reduce_add_sync(0xffffffffu, one[q]);
    if (lane == 0) {
      own[q * kBins] = z;
      own[q * kBins + 1] = o;
    }
  }
  __syncthreads();

  int32_t* dst = out + static_cast<long long>(blockIdx.y) * N * kBins;
  for (int k = threadIdx.x; k < N * kBins; k += kThreads) {
    uint32_t sum = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) sum += hist[v][k];
    if (sum) atomicAdd(dst + k, static_cast<int32_t>(sum));
  }
}

}  // namespace

// pixels [images, h * w, 3] u8 (HWC images back to back); out [images, N,
// 256] int32, zeroed (the kernel adds into it), N = 8 where lossless is
// 1, 5 where it is 0; s >= 1 the proxy's stride (the subsample is rows
// and columns 0, s, 2s, ...); h, w >= 1; images 1 .. 65535; a plane's
// 2 * ceil(h / s) * ceil(w / s) gradients fit an int32.
extern "C" int frave_transform_counts(const void* pixels, void* out, int h, int w, int s,
                                      int images, int lossless, void* stream) {
  if (h < 1 || w < 1 || s < 1 || images < 1 || images > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hs = (h + s - 1) / s, ws = (w + s - 1) / s;
  if (2LL * hs * ws > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (ws + kCols - 1) / kCols;
  const dim3 grid(chunks * ((hs + kBandRows - 1) / kBandRows), images);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* px = static_cast<const uint8_t*>(pixels);
  auto* o = static_cast<int32_t*>(out);
  if (lossless)
    transform_counts_kernel<true><<<grid, kThreads, 0, st>>>(px, o, h, w, s, hs, ws, chunks);
  else
    transform_counts_kernel<false><<<grid, kThreads, 0, st>>>(px, o, h, w, s, hs, ws, chunks);
  return static_cast<int>(cudaGetLastError());
}
