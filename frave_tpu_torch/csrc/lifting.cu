// Per-tile Haar lifting kernels for Hopper (sm_90a), plain C interface.
//
// frave_fwd_lift_quant replaces frave_tpu/ops/pallas_lifting.py
// forward_lift_quantize (_fwd_kernel); frave_inv_lift replaces
// dequantize_inverse_lift (_inv_kernel). The TPU kernels walked 128 tiles
// at once in an [N, T] nodes-on-sublanes layout; here the layout is
// [rows, N] (one tile's 2^depth nodes contiguous, the layout of
// ops/jax_ops.forward_lifting), and one block of 256 threads walks one
// tile's tree in shared memory, one lifting level per __syncthreads().
//
// Bound: device memory. Each element is read once and written once
// (4 B in, 4 B out, 1 B of mask); the 9 levels of integer arithmetic stay
// in shared memory. All arithmetic is int32; C++ `/` truncates toward
// zero, which is the reference's (Rust) division semantics.

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

__global__ void inv_lift_kernel(const int32_t* __restrict__ qcoef,
                                const uint8_t* __restrict__ node_mask,
                                const uint8_t* __restrict__ leaf_mask,
                                int mask_rows,
                                const int32_t* __restrict__ qdiv,
                                int32_t* __restrict__ out, int depth) {
  __shared__ int32_t vals[1 << kMaxDepth];
  __shared__ int32_t coef[1 << kMaxDepth];
  const int n = 1 << depth;
  const int64_t row = blockIdx.x;
  const int32_t* src = qcoef + row * n;
  const uint8_t* nm = node_mask + (row % mask_rows) * n;
  const uint8_t* lm = leaf_mask + (row % mask_rows) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    // midpoint dequantize: c*q + sign(c)*((q-1)/2)
    const int32_t c = src[i], q = qdiv[i];
    const int32_t sgn = (c > 0) - (c < 0);
    coef[i] = c * q + sgn * ((q - 1) / 2);
  }
  __syncthreads();
  if (threadIdx.x == 0) vals[0] = coef[0];
  __syncthreads();
  for (int level = 0; level < depth; ++level) {
    const int lo = 1 << level;
    const int p = threadIdx.x;
    int32_t left = 0, right = 0;
    if (p < lo) {
      bool lmask, rmask;
      if (level == depth - 1) {
        lmask = lm[2 * p] != 0;
        rmask = lm[2 * p + 1] != 0;
      } else {
        lmask = nm[2 * lo + 2 * p] != 0;
        rmask = nm[2 * lo + 2 * p + 1] != 0;
      }
      const int32_t v = vals[p];
      const int32_t c = coef[lo + p];
      const bool both = lmask && rmask;
      right = both ? v - c / 2 : v;
      left = both ? c + right : v;
    }
    __syncthreads();  // every parent is read before children overwrite it
    if (p < lo) {
      vals[2 * p] = left;
      vals[2 * p + 1] = right;
    }
    __syncthreads();
  }
  int32_t* dst = out + row * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = vals[i];
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

extern "C" int frave_inv_lift(const void* qcoef, const void* node_mask,
                              const void* leaf_mask, int mask_rows,
                              const void* qdiv, void* out, int rows, int depth,
                              void* stream) {
  if (depth < 1 || depth > kMaxDepth || rows < 0 || mask_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  inv_lift_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qcoef),
      static_cast<const uint8_t*>(node_mask),
      static_cast<const uint8_t*>(leaf_mask), mask_rows,
      static_cast<const int32_t*>(qdiv), static_cast<int32_t*>(out), depth);
  return static_cast<int>(cudaGetLastError());
}
