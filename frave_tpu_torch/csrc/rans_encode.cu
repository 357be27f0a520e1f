// Reverse-scan interleaved-lane rANS encode for Hopper (sm_90a), plain C
// interface.
//
// Replaces the XLA lax.scan of frave_tpu/ops/rans_jax.py encode_scan
// (the reverse scan over the [R, C, NL] symbol grid). Lanes are
// independent, so one thread owns one (channel, lane) and walks rows
// r = R-1 .. 0 with its 32-bit state in a register; no block-level
// cooperation is needed. The TPU version selected (freq, cdf, bits) with
// bf16 one-hot contractions; here they are plain loads from the
// [C, CA, 1024] tables in global memory (L2-resident: 3 x 15 x 1024 x 4 B
// per table).
//
// Bound: the serial dependence through x along R, with C*NL threads in
// flight (512 at 256x256 gray, 6144 at 768x512 RGB) — far fewer than the
// card holds, so latency of the dependent table loads, not bandwidth,
// sets the time. Each grid element is read once (symbol, bucket, valid)
// and written once (word, flag), in row-major order so neighbouring
// threads touch neighbouring addresses.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kAlphabet = 1024;
constexpr uint32_t kRansL = 1u << 16;

__global__ void rans_encode_kernel(const int32_t* __restrict__ sym,
                                   const int32_t* __restrict__ bkt,
                                   const uint8_t* __restrict__ valid,
                                   const int32_t* __restrict__ freq,
                                   const int32_t* __restrict__ cdf,
                                   const int32_t* __restrict__ bits,
                                   uint16_t* __restrict__ words,
                                   uint8_t* __restrict__ flags,
                                   uint32_t* __restrict__ states, int rows,
                                   int channels, int lanes, int contexts) {
  const int64_t lanes_total = static_cast<int64_t>(channels) * lanes;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= lanes_total) return;
  const int c = static_cast<int>(idx / lanes);
  uint32_t x = kRansL;
  for (int r = rows - 1; r >= 0; --r) {
    const int64_t off = static_cast<int64_t>(r) * lanes_total + idx;
    const bool v = valid[off] != 0;
    uint32_t fr = 1, cd = 0, bi = 8;  // invalid slots emit nothing
    if (v) {
      const int s = min(max(sym[off], 0), kAlphabet - 1);
      const int k = min(max(bkt[off], 0), contexts - 1);
      const int64_t t = (static_cast<int64_t>(c) * contexts + k) * kAlphabet + s;
      fr = static_cast<uint32_t>(freq[t]);
      cd = static_cast<uint32_t>(cdf[t]);
      bi = static_cast<uint32_t>(bits[c * contexts + k]);
    }
    // renorm: emit the low 16 bits iff x >= fr << (32 - bi), computed
    // overflow-free as (x >> (32 - bi)) >= fr
    const bool emit = v && ((x >> (32u - bi)) >= fr);
    words[off] = static_cast<uint16_t>(x & 0xFFFFu);
    flags[off] = emit ? 1 : 0;
    const uint32_t x1 = emit ? (x >> 16) : x;
    const uint32_t q = x1 / fr;
    const uint32_t rem = x1 - q * fr;
    const uint32_t x2 = (q << bi) + rem + cd;
    x = v ? x2 : x1;
  }
  states[idx] = x;
}

}  // namespace

extern "C" int frave_rans_encode(const void* sym, const void* bkt,
                                 const void* valid, const void* freq,
                                 const void* cdf, const void* bits,
                                 void* words, void* flags, void* states,
                                 int rows, int channels, int lanes,
                                 int contexts, void* stream) {
  if (rows < 0 || channels < 1 || lanes < 1 || contexts < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(channels) * lanes;
  const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
  rans_encode_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sym), static_cast<const int32_t*>(bkt),
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(freq),
      static_cast<const int32_t*>(cdf), static_cast<const int32_t*>(bits),
      static_cast<uint16_t*>(words), static_cast<uint8_t*>(flags),
      static_cast<uint32_t*>(states), rows, channels, lanes, contexts);
  return static_cast<int>(cudaGetLastError());
}
