// The encode's predictor fits, for Hopper (sm_90a), plain C interface.
//
// Replaces the XLA einsum fits of frave_tpu/codec/grid_decode.py:646-676
// (build_grid_encode's strided fits) and frave_tpu/codec/pipeline_jax.py
// :496-530 (step_stats' fits) with _gram_solve (:100): no Pallas kernel.
// The port ran them as a torch chain (ops/fit_stats.py fit_predictors):
// per predictor group two casts to float64, two or three einsums, the
// width features and the stacks, then batched cholesky_ex and two
// triangular solves, some hundred launches an encode batch, and cuBLAS
// ran each [rows, k, 6] x [rows, k, 6] Gram as a few tiles walking the
// whole k axis. Here an encode batch's fits are four launches, whatever
// the batch size and the groups' sizes:
//
//   frave_fit_pass (value)  the value normal equations of every (row,
//                           chunk): sum x_i x_j (21 upper entries) and
//                           sum x_i y (6), int64;
//   frave_fit_solve (value) each (row, group)'s sums, its regularised
//                           Cholesky solve in float64, rounded to the f16
//                           wire values (vparams);
//   frave_fit_pass (width)  pred = sum x_i v_i in float64 over the wire
//                           vparams, rg = |y - pred|, the width features
//                           f (bias and five |tap differences|): sum f_i
//                           f_j (21, int64) and sum f_i rg (6, float64);
//   frave_fit_solve (width) the same solve -> wparams.
//
// A sample is one fit symbol: the int32 [7, n] table holds its six tap
// slots and its target slot (a row a slot, so a warp's loads of one slot
// are consecutive), the samples of each group contiguous in group order.
// A group of n_g samples is cut into min(32, ceil(n_g / 1024)) chunks of
// equal size (the last shorter; the host's table, fit_stats.chunk_table):
// the cut depends on n_g alone, never on the batch. Block (chunk, row)
// walks its chunk of one plane row: thread t takes samples t, t + 256, ...
// in order, gathers the seven values straight from the row (no [rows, n,
// 6] copy, no float64 copy) and accumulates in registers; the block
// reduces by a fixed shuffle tree and the warps in order, and writes one
// partial [27] of int64 (the width pass's last six: float64 bits). No
// atomics and no zeroed buffer. The solve takes a warp per (row, group),
// lane l the group's chunk l, and adds the chunks by a fixed tree.
//
// The taps and targets are integers (|q| <= 511 for 8-bit pixels), so
// the int64 sums are exact and equal the float64 einsums' (which are
// exact too) bit for bit, in any order. pred is exact in float64 (an
// integer tap times an f16 value's 11-bit significand, six of them), so
// rg is too; only the width b is rounded, and its order is fixed by the
// chunking alone: an image's fit is the same alone and in any batch. The
// solve is _gram_solve's: eps = trace * 1e-6 / 6 + 1e-12, Cholesky of
// G + eps I (a pivot that is not > 0, NaN included, makes all six NaN,
// as cholesky_ex's info does), forward then back substitution, float64
// -> float32 (RNE) -> the f16 wire value (torch_ops.f16_wire_round's
// integer twin, NaN bits passed through).
//
// Bound: bytes. A pass reads each sample's 28 B of slots once for the
// batch (the other rows find them in L2) and gathers 28 B of values a
// sample and row: ~33 MB a pass at 768x512 RGB (~10 us at 3.35 TB/s),
// ~71 MB at 2048x2048 RGB, ~121 MB for 64 256x256 gray images; the
// arithmetic (27 IMAD.WIDE a sample, and 13 float64 operations in the
// width pass) is far below the card's rates. The gathers hit the rows
// that kernel A just wrote; a thread loads its next sample's slots
// before it gathers the current one's values.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTaps = 6;
constexpr int kSlots = kTaps + 1;     // six taps and the target
constexpr int kGram = 21;             // upper entries of a 6x6 Gram
constexpr int kEq = kGram + kTaps;    // a partial: Gram, then b
constexpr int kSolveThreads = 128;

// the f16 wire value of x, as f32 (torch_ops.f16_wire_round): RNE to
// binary16, overflow to inf, subnormals on the 2^-24 grid, NaN unchanged,
// the sign kept (-0 survives)
__device__ __forceinline__ float f16_wire_round(float x) {
  const uint32_t bits = __float_as_uint(x);
  const uint32_t sign = bits & 0x80000000u, absb = bits & 0x7FFFFFFFu;
  if (absb > 0x7F800000u) return x;
  uint32_t out;
  if (absb >= 0x38800000u) {
    const uint32_t lsb = (absb >> 13) & 1u;
    const uint32_t r = (absb + 0xFFFu + lsb) & 0xFFFFE000u;
    out = r >= 0x47800000u ? 0x7F800000u : r;
  } else {
    const int e = static_cast<int>(absb >> 23);
    const uint32_t m = (absb & 0x7FFFFFu) | 0x800000u;
    const int shift = min(max(126 - e, 1), 31);
    const uint32_t half = 1u << (shift - 1);
    uint32_t q = (m + half - 1u + ((m >> shift) & 1u)) >> shift;
    if (e == 0) q = 0;
    out = __float_as_uint(__fmul_rn(static_cast<float>(q), 5.9604644775390625e-8f));
  }
  return __uint_as_float(sign | out);
}

struct Sample {
  int slot[kSlots];
};

__device__ __forceinline__ Sample load_sample(const int32_t* __restrict__ samples, long long n,
                                              int s) {
  Sample a;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) a.slot[i] = __ldg(samples + i * n + s);
  return a;
}

// adds the upper entries of v v^T to g (int64: IMAD.WIDE)
__device__ __forceinline__ void gram_add(long long (&g)[kGram], const int (&v)[kTaps]) {
  int e = 0;
#pragma unroll
  for (int i = 0; i < kTaps; ++i)
#pragma unroll
    for (int j = i; j < kTaps; ++j) g[e++] += static_cast<long long>(v[i]) * v[j];
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  return v;
}

// value pass (kWidth false) or width pass over block (chunk, row)'s
// samples; part [rows, chunks, 27] int64
template <bool kWidth>
__global__ void __launch_bounds__(kThreads)
    fit_pass_kernel(const int32_t* __restrict__ plane, long long stride,
                    const int32_t* __restrict__ samples, long long n,
                    const int32_t* __restrict__ chunk_start,
                    const int32_t* __restrict__ chunk_group, int chunks,
                    const float* __restrict__ vparams, int groups, long long* __restrict__ part) {
  __shared__ long long red[kWarps][kEq];
  const int c = blockIdx.x, row = blockIdx.y;
  if (c >= chunks) return;  // a program without fit samples: one empty block a row
  const int lo = __ldg(chunk_start + c), hi = __ldg(chunk_start + c + 1);
  const int32_t* __restrict__ p = plane + row * stride;
  double v[kTaps];
  if (kWidth) {
    const float* vp = vparams + (static_cast<long long>(row) * groups + __ldg(chunk_group + c)) *
                                    kTaps;
#pragma unroll
    for (int i = 0; i < kTaps; ++i) v[i] = static_cast<double>(__ldg(vp + i));
  }
  long long g[kGram];
#pragma unroll
  for (int e = 0; e < kGram; ++e) g[e] = 0;
  long long bi[kTaps];
  double bf[kTaps];
#pragma unroll
  for (int i = 0; i < kTaps; ++i) {
    bi[i] = 0;
    bf[i] = 0.0;
  }

  int s = lo + threadIdx.x;
  Sample cur;
  if (s < hi) cur = load_sample(samples, n, s);
  for (; s < hi; s += kThreads) {
    Sample nxt;
    if (s + kThreads < hi) nxt = load_sample(samples, n, s + kThreads);
    int x[kTaps];
#pragma unroll
    for (int i = 0; i < kTaps; ++i) x[i] = __ldg(p + cur.slot[i]);
    const int y = __ldg(p + cur.slot[kTaps]);
    if (!kWidth) {
      gram_add(g, x);
#pragma unroll
      for (int i = 0; i < kTaps; ++i) bi[i] += static_cast<long long>(x[i]) * y;
    } else {
      double pred = 0.0;
#pragma unroll
      for (int i = 0; i < kTaps; ++i) pred = __dadd_rn(pred, __dmul_rn(x[i], v[i]));
      const double rg = fabs(__dsub_rn(static_cast<double>(y), pred));
      const int f[kTaps] = {1, abs(x[0] - x[3]), abs(x[1] - x[2]), abs(x[4] - x[5]),
                            abs(x[1] - x[5]), abs(x[2] - x[4])};
      gram_add(g, f);
#pragma unroll
      for (int i = 0; i < kTaps; ++i) bf[i] = __dadd_rn(bf[i], __dmul_rn(f[i], rg));
    }
    cur = nxt;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < kGram; ++e) {
    const long long t = warp_sum(g[e]);
    if (lane == 0) red[warp][e] = t;
  }
#pragma unroll
  for (int i = 0; i < kTaps; ++i) {
    if (kWidth) {
      const double t = warp_sum(bf[i]);
      if (lane == 0) red[warp][kGram + i] = __double_as_longlong(t);
    } else {
      const long long t = warp_sum(bi[i]);
      if (lane == 0) red[warp][kGram + i] = t;
    }
  }
  __syncthreads();
  if (threadIdx.x < kEq) {
    const int e = threadIdx.x;
    long long* dst = part + (static_cast<long long>(row) * chunks + c) * kEq + e;
    if (kWidth && e >= kGram) {
      double t = 0.0;
      for (int w = 0; w < kWarps; ++w) t = __dadd_rn(t, __longlong_as_double(red[w][e]));
      *dst = __double_as_longlong(t);
    } else {
      long long t = 0;
      for (int w = 0; w < kWarps; ++w) t += red[w][e];
      *dst = t;
    }
  }
}

// one warp per (row, group): the group's chunk partials added (lane l
// chunk l, a fixed tree), then lane 0 solves; out [rows, groups, 6] f32
template <bool kWidth>
__global__ void __launch_bounds__(kSolveThreads)
    fit_solve_kernel(const long long* __restrict__ part, const int32_t* __restrict__ chunk_off,
                     int rows, int groups, int chunks, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * (kSolveThreads / 32) + (threadIdx.x >> 5);
  if (w >= rows * groups) return;
  const int row = w / groups, grp = w % groups;
  const int c0 = __ldg(chunk_off + grp), nc = __ldg(chunk_off + grp + 1) - c0;
  long long q[kEq];
  const long long* src = part + (static_cast<long long>(row) * chunks + c0 + lane) * kEq;
#pragma unroll
  for (int e = 0; e < kEq; ++e) q[e] = lane < nc ? __ldg(src + e) : 0;  // 0: +0.0 as well
  double b[kTaps];
#pragma unroll
  for (int e = 0; e < kGram; ++e) q[e] = warp_sum(q[e]);
#pragma unroll
  for (int i = 0; i < kTaps; ++i) {
    if (kWidth) {
      b[i] = warp_sum(__longlong_as_double(q[kGram + i]));
    } else {
      b[i] = static_cast<double>(warp_sum(q[kGram + i]));
    }
  }
  if (lane != 0) return;

  double a[kTaps][kTaps];
  int e = 0;
#pragma unroll
  for (int i = 0; i < kTaps; ++i)
#pragma unroll
    for (int j = i; j < kTaps; ++j) {
      a[i][j] = static_cast<double>(q[e++]);
      a[j][i] = a[i][j];
    }
  double tr = 0.0;
#pragma unroll
  for (int i = 0; i < kTaps; ++i) tr = __dadd_rn(tr, a[i][i]);
  const double eps = __dadd_rn(__ddiv_rn(__dmul_rn(tr, 1e-6), 6.0), 1e-12);
#pragma unroll
  for (int i = 0; i < kTaps; ++i) a[i][i] = __dadd_rn(a[i][i], eps);

  // Cholesky, lower factor in a's lower triangle
  bool ok = true;
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    double d = a[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) d = __dsub_rn(d, __dmul_rn(a[j][k], a[j][k]));
    ok = ok && d > 0.0;
    const double ljj = sqrt(d);
    a[j][j] = ljj;
#pragma unroll
    for (int i = j + 1; i < kTaps; ++i) {
      double t = a[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t = __dsub_rn(t, __dmul_rn(a[i][k], a[j][k]));
      a[i][j] = __ddiv_rn(t, ljj);
    }
  }
  double y[kTaps], x[kTaps];
#pragma unroll
  for (int i = 0; i < kTaps; ++i) {
    double t = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) t = __dsub_rn(t, __dmul_rn(a[i][k], y[k]));
    y[i] = __ddiv_rn(t, a[i][i]);
  }
#pragma unroll
  for (int i = kTaps - 1; i >= 0; --i) {
    double t = y[i];
#pragma unroll
    for (int k = i + 1; k < kTaps; ++k) t = __dsub_rn(t, __dmul_rn(a[k][i], x[k]));
    x[i] = __ddiv_rn(t, a[i][i]);
  }
  float* dst = out + (static_cast<long long>(row) * groups + grp) * kTaps;
#pragma unroll
  for (int i = 0; i < kTaps; ++i)
    dst[i] = ok ? f16_wire_round(__double2float_rn(x[i])) : __uint_as_float(0x7FC00000u);
}

}  // namespace

// plane [rows, >= max slot + 1] int32 rows `stride` apart; samples [7, n]
// int32 (tap slots, then the target slot); chunk_start [chunks + 1],
// chunk_group [chunks] int32 (fit_stats.chunk_table); vparams [rows,
// groups, 6] f32 for the width pass, null for the value pass; part
// [rows, chunks, 27] int64, every entry written. rows 1 .. 65535;
// chunks may be 0 (no samples: nothing is read or written).
extern "C" int frave_fit_pass(const void* plane, long long stride, int rows, const void* samples,
                              long long n, const void* chunk_start, const void* chunk_group,
                              int chunks, const void* vparams, int groups, void* part,
                              void* stream) {
  if (rows < 1 || rows > 65535 || chunks < 0 || groups < 1 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(chunks > 0 ? chunks : 1, rows);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* pl = static_cast<const int32_t*>(plane);
  const auto* sm = static_cast<const int32_t*>(samples);
  const auto* cs = static_cast<const int32_t*>(chunk_start);
  const auto* cg = static_cast<const int32_t*>(chunk_group);
  auto* pt = static_cast<long long*>(part);
  if (vparams)
    fit_pass_kernel<true><<<grid, kThreads, 0, st>>>(pl, stride, sm, n, cs, cg, chunks,
                                                     static_cast<const float*>(vparams), groups,
                                                     pt);
  else
    fit_pass_kernel<false><<<grid, kThreads, 0, st>>>(pl, stride, sm, n, cs, cg, chunks, nullptr,
                                                      groups, pt);
  return static_cast<int>(cudaGetLastError());
}

// part as frave_fit_pass wrote it; chunk_off [groups + 1] int32 (group
// g's chunks are [chunk_off[g], chunk_off[g + 1]), at most 32); width 1
// where part holds the width pass's sums; out [rows, groups, 6] f32.
extern "C" int frave_fit_solve(const void* part, const void* chunk_off, int rows, int groups,
                               int chunks, int width, void* out, void* stream) {
  if (rows < 1 || groups < 1 || chunks < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long warps = static_cast<long long>(rows) * groups;
  const int per = kSolveThreads / 32;
  const unsigned blocks = static_cast<unsigned>((warps + per - 1) / per);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* pt = static_cast<const long long*>(part);
  const auto* co = static_cast<const int32_t*>(chunk_off);
  auto* o = static_cast<float*>(out);
  if (width)
    fit_solve_kernel<true><<<blocks, kSolveThreads, 0, st>>>(pt, co, rows, groups, chunks, o);
  else
    fit_solve_kernel<false><<<blocks, kSolveThreads, 0, st>>>(pt, co, rows, groups, chunks, o);
  return static_cast<int>(cudaGetLastError());
}
