// Reverse-scan interleaved-lane rANS encode for Hopper (sm_90a), plain C
// interface.
//
// Replaces the XLA lax.scan of frave_tpu/ops/rans_jax.py encode_scan
// (the reverse scan over the [R, C, NL] symbol grid). The operands stay
// in schedule order: symbols and buckets [C, K], and a row map. Each
// wave's symbols fill grid rows of NL lanes back to back, so grid row r
// holds schedule positions row_k0[r] .. row_k0[r] + row_len[r] - 1 in
// lanes 0 .. row_len[r] - 1, and lane l of row r reads
// symbols[c, row_k0[r] + l]: coalesced, and no [R, C, NL] grid is built.
// Lanes at or past row_len[r] act as the padding slots of the grid: they
// emit nothing, write word x & 0xFFFF and flag 0, and keep x.
//
// A same-shape batch of B images runs in one launch over B * C lane sets
// (the JAX program's vmap over B): symbols, buckets and tables are
// [B * C, ...] rows, the row map is shared, and the emission grid is written
// [B, R, C, NL], so each image's words lie contiguous in its own decode
// order and compact with a prefix sum per image.
//
// Bound on this card: device memory. Every lane-row reads 8 bytes
// (symbol, bucket) and writes 3 (word, flag): 0.043 ms at 3.35 TB/s for
// a 2048x2048 RGB grid [266, 3, 16384]. Lanes are independent, but each
// lane's rows form a chain through its 32-bit state x, and one thread a
// lane gives few warps (12 an SM at 2048x2048 RGB, 16 in all at 256x256
// gray) to hide latency with: a row's instructions cost their latency,
// not their issue slot. The previous design loaded each row's operands
// and then its tables from L2 at the head of the row, a device-memory
// round trip plus an L2 round trip a row (~1 us).
//
// Design (PERF.md has the measurements behind each point):
//   * one block = 128 lanes of one (image, channel) row (blockIdx.y); its
//     tables sit in dynamic shared memory, one u32 freq | cdf << 16 per
//     (context, symbol) (15 x 1024 x 4 = 61,440 B; freq and cdf are at most
//     2^14, and both are read mod 2^16), filled with 16-byte loads at block
//     start, beside the scale bits;
//   * the rows go in chunks of CH (the rows loaded ahead): while chunk n is
//     encoded, cp.async copies each thread's (symbol, bucket) of every row
//     of chunk n + 1 into a second shared-memory stage, and the row map of
//     chunk n + 2 into a third slot of a 3-slot ring (the addresses of a
//     chunk's copies need its map). A thread reads back only its own
//     lane's entries, so the one __syncthreads a chunk is for the shared
//     row map; cp.async.wait_all before it waits for copies issued a whole
//     chunk earlier;
//   * a chunk's table entries are read before its rows are encoded, and
//     the chunk's code is straight-line (selects, not a branch a row), so
//     the compiler overlaps the rows' independent work with the
//     loop-carried chain: the emit test, the exact 32-bit divide and two
//     coalesced stores;
//   * the launch rule takes the longest chunk (16, 8, 4) at which every
//     block is resident at once: a block's tables and stages take 68-92 KB,
//     so 8 or 16 rows ahead cost a second wave of blocks at 2048x2048 RGB.
// Symbols and buckets are clamped to the tables, and every position read
// to [0, K), so corrupt input cannot read outside them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // lanes a block (the launch rule's)
constexpr int kChunks[] = {16, 8, 4};  // rows loaded ahead, longest first
constexpr int kAlphabet = 1024;
constexpr int kFill = 8;       // table loads in flight a thread
constexpr uint32_t kRansL = 1u << 16;

// 4-byte copy global -> shared, or 4 zero bytes where !read (no branch)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool read = true) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(read ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// dynamic shared memory of one block: tables, scale bits, the row-map
// ring (3 chunks of k0 and len) and the operand stages (2 chunks of
// symbol and bucket a lane)
__host__ __device__ constexpr size_t table_bytes(int contexts) {
  return static_cast<size_t>(contexts) * kAlphabet * 4 +
         (static_cast<size_t>(contexts) * 4 + 15) / 16 * 16;
}
template <int CH>
__host__ __device__ constexpr size_t smem_bytes(int contexts, int threads) {
  return table_bytes(contexts) + 3 * CH * 2 * 4 +
         static_cast<size_t>(2) * CH * 2 * threads * 4;
}

template <int CH>
__global__ void __launch_bounds__(512)
rans_encode_kernel(const int32_t* __restrict__ sym,
                   const int32_t* __restrict__ bkt,
                   const int32_t* __restrict__ row_k0,
                   const int32_t* __restrict__ row_len,
                   const int32_t* __restrict__ freq,
                   const int32_t* __restrict__ cdf,
                   const int32_t* __restrict__ bits,
                   uint16_t* __restrict__ words, uint8_t* __restrict__ flags,
                   int64_t* __restrict__ states, int rows, int channels,
                   int lanes, int contexts, int k_total, int lane0) {
  // blockIdx.y = b * channels + c: the lane set of channel c of image b
  extern __shared__ uint4 smem[];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  int32_t* sbits = reinterpret_cast<int32_t*>(tab + contexts * kAlphabet);
  // meta[slot][0][i] = row_k0, meta[slot][1][i] = row_len of row i of a chunk
  int32_t* meta = reinterpret_cast<int32_t*>(reinterpret_cast<char*>(smem) + table_bytes(contexts));
  // stage[buf][i][0 / 1][t] = symbol / bucket of thread t's lane, chunk row i
  int32_t* stage = meta + 3 * CH * 2;
  const int nt = blockDim.x, t = threadIdx.x;
  const int c = blockIdx.y;  // the (image, channel) row of the operands
  const int lane = blockIdx.x * nt + t;  // of the window [lane0, lane0 + lanes)
  const bool live = lane < lanes;  // threads past the window keep to the barriers
  const int chunks = (rows + CH - 1) / CH;
  const int32_t* sc = sym + static_cast<int64_t>(c) * k_total;
  const int32_t* bc = bkt + static_cast<int64_t>(c) * k_total;

  // row map of chunk n into ring slot n % 3 (threads 0 .. 2 CH - 1)
  auto copy_meta = [&](int n) {
    if (n < chunks && t < 2 * CH) {
      const int i = t % CH, r = rows - 1 - n * CH - i;
      if (r >= 0) cp_async4(meta + ((n % 3) * 2 + t / CH) * CH + i, (t < CH ? row_k0 : row_len) + r);
    }
  };
  // this thread's operands of every row of chunk n into stage n % 2 (its
  // row map must be visible); padding slots and rows past the last take
  // zeros. Straight-line code, as below: a branch a row would keep the
  // compiler from overlapping the rows' independent work
  auto copy_rows = [&](int n) {
    if (n >= chunks || !live) return;
    const int32_t* m = meta + (n % 3) * 2 * CH;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const bool read = rows - 1 - n * CH - i >= 0 && lane0 + lane < m[CH + i];
      const int k = min(max(m[i] + lane0 + lane, 0), k_total - 1);
      int32_t* s = stage + (((n % 2) * CH + i) * 2) * nt + t;
      cp_async4(s, sc + k, read);
      cp_async4(s + nt, bc + k, read);
    }
  };

  copy_meta(0);
  copy_meta(1);
  cp_async_commit();
  {
    const int n4 = contexts * kAlphabet / 4;
    const int4* f4 = reinterpret_cast<const int4*>(freq) + static_cast<int64_t>(c) * n4;
    const int4* d4 = reinterpret_cast<const int4*>(cdf) + static_cast<int64_t>(c) * n4;
    uint4* t4 = reinterpret_cast<uint4*>(tab);
    // kFill 16-byte loads of each table in flight before their stores
    for (int i0 = t; i0 < n4; i0 += kFill * nt) {
      int4 f[kFill], d[kFill];
#pragma unroll
      for (int u = 0; u < kFill; ++u) {
        const int i = min(i0 + u * nt, n4 - 1);
        f[u] = __ldg(f4 + i);
        d[u] = __ldg(d4 + i);
      }
#pragma unroll
      for (int u = 0; u < kFill; ++u) {
        const int i = i0 + u * nt;
        if (i < n4)
          t4[i] = make_uint4((f[u].x & 0xFFFFu) | (static_cast<uint32_t>(d[u].x) << 16),
                             (f[u].y & 0xFFFFu) | (static_cast<uint32_t>(d[u].y) << 16),
                             (f[u].z & 0xFFFFu) | (static_cast<uint32_t>(d[u].z) << 16),
                             (f[u].w & 0xFFFFu) | (static_cast<uint32_t>(d[u].w) << 16));
      }
    }
    for (int i = t; i < contexts; i += nt) sbits[i] = __ldg(bits + c * contexts + i);
  }
  cp_async_wait_all();
  __syncthreads();  // tables and the row maps of chunks 0 and 1
  copy_rows(0);
  cp_async_commit();

  // words and flags [B, R, C, NL]: image b's grid starts at b * rows * plane
  const int64_t plane = static_cast<int64_t>(channels) * lanes;
  const int64_t col = static_cast<int64_t>(c / channels) * rows * plane +
                      static_cast<int64_t>(c % channels) * lanes + lane;
  uint32_t x = kRansL;
  for (int n = 0; n < chunks; ++n) {
    cp_async_wait_all();
    __syncthreads();  // chunk n's operands, chunk n + 1's row map
    copy_rows(n + 1);
    copy_meta(n + 2);
    cp_async_commit();
    if (!live) continue;
    // the chunk's table entries first: none of them depends on x (a
    // padding slot reads entry (0, 0) and ignores it)
    const int32_t* m = meta + (n % 3) * 2 * CH;
    uint32_t ent[CH], sb[CH];
    bool valid[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      valid[i] = rows - 1 - n * CH - i >= 0 && lane0 + lane < m[CH + i];
      const int32_t* s = stage + (((n % 2) * CH + i) * 2) * nt + t;
      const int sy = min(max(s[0], 0), kAlphabet - 1);
      const int k = min(max(s[nt], 0), contexts - 1);
      ent[i] = tab[k * kAlphabet + sy];
      sb[i] = static_cast<uint32_t>(sbits[k]);
    }
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int r = rows - 1 - n * CH - i;
      // padding slots emit nothing and keep x (so do rows past the last,
      // which store nothing)
      const uint32_t fr = valid[i] ? ent[i] & 0xFFFFu : 1u;
      const uint32_t cd = valid[i] ? ent[i] >> 16 : 0u;
      const uint32_t bi = valid[i] ? sb[i] : 8u;
      // renorm: emit the low 16 bits iff x >= fr << (32 - bi), computed
      // overflow-free as (x >> (32 - bi)) >= fr
      const bool emit = valid[i] && ((x >> (32u - bi)) >= fr);
      if (r >= 0) {
        const int64_t off = static_cast<int64_t>(r) * plane + col;
        words[off] = static_cast<uint16_t>(x & 0xFFFFu);
        flags[off] = emit ? 1 : 0;
      }
      const uint32_t x1 = emit ? (x >> 16) : x;
      const uint32_t q = x1 / fr;
      const uint32_t x2 = (q << bi) + (x1 - q * fr) + cd;
      x = valid[i] ? x2 : x1;
    }
  }
  if (live) states[static_cast<int64_t>(c) * lanes + lane] = x;  // u32, zero-extended
}

template <int CH>
const void* kernel_of() {
  return reinterpret_cast<const void*>(rans_encode_kernel<CH>);
}

const void* kernel_for(int chunk) {
  switch (chunk) {
    case 4: return kernel_of<4>();
    case 8: return kernel_of<8>();
    case 16: return kernel_of<16>();
    default: return nullptr;
  }
}

size_t smem_for(int chunk, int contexts, int threads) {
  switch (chunk) {
    case 4: return smem_bytes<4>(contexts, threads);
    case 8: return smem_bytes<8>(contexts, threads);
    default: return smem_bytes<16>(contexts, threads);
  }
}

// the launch rule: kThreads lanes a block, and the longest chunk at which
// every block of the grid is resident at once (the tables and stages of a
// block take 68-92 KB, so a longer chunk can cost a second wave of blocks);
// the shortest chunk where none is
cudaError_t plan(int channels, int lanes, int contexts, int* chunk, int* threads) {
  *threads = kThreads;
  const int64_t blocks = static_cast<int64_t>(channels) * ((lanes + kThreads - 1) / kThreads);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  for (int ch : kChunks) {
    const size_t smem = smem_for(ch, contexts, kThreads);
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel_for(ch), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_for(ch), kThreads, smem);
    if (err != cudaSuccess) return err;
    *chunk = ch;
    if (static_cast<int64_t>(per_sm) * sms >= blocks) break;
  }
  return cudaSuccess;
}

// sym / bkt [images * channels, k_total] int32, freq / cdf [images *
// channels, contexts, 1024] int32, bits [images * channels, contexts] int32;
// words / flags [images, rows, channels, lanes], states [images, channels,
// lanes], of the lanes [lane0, lane0 + lanes) of each row (lane0 = 0: the
// whole grid). ahead / threads: rows loaded ahead, the chunk (4, 8 or 16),
// and lanes a block (a multiple of 32 up to 512); 0 and 0 take the launch
// rule (plan). freq, cdf and bits must be 16-byte aligned, and k_total at
// least 1 (the wrapper sees to both).
int encode_lanes(const void* sym, const void* bkt, const void* row_k0, const void* row_len,
                 const void* freq, const void* cdf, const void* bits, void* words,
                 void* flags, void* states, int rows, int channels, int images, int lanes,
                 int contexts, int k_total, int lane0, int ahead, int threads, void* stream) {
  if (rows < 0 || channels < 1 || images < 1 ||
      static_cast<int64_t>(channels) * images > 65535 || lanes < 1 || contexts < 1 ||
      k_total < 1 || lane0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ahead == 0 && threads == 0) {
    const cudaError_t err = plan(channels * images, lanes, contexts, &ahead, &threads);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const void* fn = kernel_for(ahead);
  if (fn == nullptr || threads < 32 || threads > 512 || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_for(ahead, contexts, threads);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((lanes + threads - 1) / threads, channels * images);
  const int32_t* sy = static_cast<const int32_t*>(sym);
  const int32_t* bk = static_cast<const int32_t*>(bkt);
  const int32_t* k0 = static_cast<const int32_t*>(row_k0);
  const int32_t* ln = static_cast<const int32_t*>(row_len);
  const int32_t* fq = static_cast<const int32_t*>(freq);
  const int32_t* cd = static_cast<const int32_t*>(cdf);
  const int32_t* bt = static_cast<const int32_t*>(bits);
  uint16_t* wd = static_cast<uint16_t*>(words);
  uint8_t* fl = static_cast<uint8_t*>(flags);
  int64_t* st = static_cast<int64_t*>(states);
  void* args[] = {&sy, &bk, &k0, &ln, &fq, &cd, &bt, &wd, &fl, &st,
                  &rows, &channels, &lanes, &contexts, &k_total, &lane0};
  err = cudaLaunchKernel(fn, grid, dim3(threads), args, smem, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// The launch rule's design point (plan): rows loaded ahead and lanes a
// block for a grid of `channels` x `lanes` lanes (channels: the lane sets
// of the whole batch, images x channels).
extern "C" int frave_rans_encode_plan(int channels, int lanes, int contexts,
                                      int* ahead, int* threads) {
  if (channels < 1 || lanes < 1 || contexts < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(plan(channels, lanes, contexts, ahead, threads));
}

// The whole lane grid (encode_lanes at lane0 = 0).
extern "C" int frave_rans_encode(const void* sym, const void* bkt,
                                 const void* row_k0, const void* row_len,
                                 const void* freq, const void* cdf,
                                 const void* bits, void* words, void* flags,
                                 void* states, int rows, int channels, int images,
                                 int lanes, int contexts, int k_total,
                                 int ahead, int threads, void* stream) {
  return encode_lanes(sym, bkt, row_k0, row_len, freq, cdf, bits, words, flags, states, rows,
                      channels, images, lanes, contexts, k_total, 0, ahead, threads, stream);
}

// The lanes [lane0, lane0 + lanes) of every row: one rank's window of a
// tp-sharded encode (encode_lanes).
extern "C" int frave_rans_encode_lanes(const void* sym, const void* bkt,
                                       const void* row_k0, const void* row_len,
                                       const void* freq, const void* cdf,
                                       const void* bits, void* words, void* flags,
                                       void* states, int rows, int channels, int images,
                                       int lanes, int contexts, int k_total, int lane0,
                                       int ahead, int threads, void* stream) {
  return encode_lanes(sym, bkt, row_k0, row_len, freq, cdf, bits, words, flags, states, rows,
                      channels, images, lanes, contexts, k_total, lane0, ahead, threads, stream);
}
