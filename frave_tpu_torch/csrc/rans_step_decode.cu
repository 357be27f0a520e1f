// Step-tensor rANS decode for Hopper (sm_90a), plain C interface:
// kernel D.
//
// Replaces the lax.scan body of frave_tpu/codec/pipeline_jax.py
// decode_fused (:820-868, with ops/rans_jax.py decode_step_merged): every
// wavefront step of a decode in one launch. The decode of the parallel and
// parity modes, and of grid-mode shapes too small for a dense lattice,
// runs step by step (fractal/schedule.py LaneSteps). A step is a run of
// consecutive schedule indices [k0, k0 + len) on the lanes (lane0 + o) mod
// NL, o < len, so the kernel reads its work from schedule-order operands
// (ops/step_decode.py): the step map [S] (k0, lane0, len, wrapped) and one
// 32-byte record a schedule symbol (the coefficient slot, the six taps as
// schedule indices, lf | group << 8 | fbkt << 16). Per step, image and
// (channel, lane) of the step:
//   1. gather the 6 taps from the image's plane in schedule order [C, K],
//      which the kernel writes as it decodes (tap -1 reads 0);
//   2. contexts (ops/torch_ops.py contexts): an LF symbol takes the MED
//      prediction and bucket(|v0 - v2|); an HF symbol the width
//      wp0 + wp1*g1 + ... + wp5*g5 and the prediction v0*vp0 + ... +
//      v5*vp5, each product and sum rounded to f32 on its own, left to
//      right (__fmul_rn / __fadd_rn, so nothing contracts into an FMA);
//      the width is 0 where g1 + ... + g5 == 0, the bucket the count of
//      f32 edges <= width (NaN and negative widths: 0), the prediction
//      truncated after a clamp to +-1e9 (NaN: 0);
//   3. a fixed bucket (fbkt >= 0) replaces the computed one; the
//      prediction is clamped to +-255;
//   4. kernel 3's symbol and renorm step (rans_common.cuh), the words
//      ranked channel-major, lane-minor within the image (a band that
//      wraps past NL ranks its tail lanes [0, wrapped) first), every
//      stream index clamped;
//   5. the state advances and unpack_signed(sym) + prediction is stored
//      at k in the schedule-order plane and at the coefficient slot in the
//      [C, n_slots] plane that kernel B reads.
//
// Two variants, chosen by the host's plan (make_plan):
//   * one block an image (grid (1, B)), where a step's C * len pairs fit
//     one block at one or two pairs a thread (the launch rule: at most
//     kBlockPairs) and the image's C * NL lane states fit in shared memory
//     beside the tables. Thread t takes the step's pairs t and t + 1024 in
//     rank order, their renorm ranks within the warp by ballot and across
//     warps by one scan of the warps' counts, each round's in a 16-bit
//     field; the lane states live in shared memory. The block barrier
//     after the plane stores orders them before the next step's taps, and
//     the state stores before the next step's state loads where the two
//     steps' lane bands are apart (consecutive schedule indices on lanes
//     k mod NL: every step of the parallel and parity modes unless two
//     steps together pass NL lanes); where they meet (grid mode's rows,
//     which all start at lane 0) a second barrier closes the step. The
//     block reads its own plane stores after that barrier, so its taps may
//     hit L1 (ld.global.ca, st.global.wb). No cluster, no exchange;
//   * one thread-block cluster an image (grid (S, B), S = 1..16), PR 7's
//     lane ownership: block k owns a contiguous range of the flat rank
//     index i = c * NL + n, thread t its lanes Pt .. Pt + P - 1, the lane
//     states in registers for the whole decode, one cluster exchange a
//     step. The plane stores precede the exchange, whose barrier is
//     barrier.cluster.arrive.release / wait.acquire; the planes are read
//     and written through L2 only (ld.global.cg / st.global.cg), so no
//     block reads a stale L1 line. Only an image's own block or cluster
//     touches its planes. A step never reads what it writes itself: every
//     tap of a step is a schedule index below the step's k0
//     (CodecProgram.from_host checks it), so one ordering barrier a step is
//     enough.
// In both, once a step's barrier is passed, the next step's records and
// taps go out first (the chain) and the step's words after them. With
// prefetch, one thread copies records in bulk (cp.async.bulk, TMA's 1-D
// form, completing on an mbarrier) before the barrier they are needed
// after: one block copies the next step's word window [g, g + C * len)
// (from g rounded down to 16 bytes, where it lies inside the stream) and
// the records of the step after it, into buffers by step parity; a block
// of a cluster its lanes' records of the next step (at most two runs of
// consecutive records), into one buffer, after the block scan. The step
// map is read two steps ahead. The launch rule prefetches only in one
// block with two pairs a thread, where the sweep measured it faster
// (PERF.md).
//
// Design switches (the sweeps; flags): kNoPrefetch loads the records and
// words from global memory when needed, kPrefetch copies them ahead where
// the rule would not; kSlotTaps
// takes records whose taps are coefficient slots and reads them from the
// coefficient plane (PR 7's layout; the schedule-order plane is then not
// written); kPadded takes records laid out [S, NL] by lane (PR 7's padded
// step tensors; no prefetch), a cluster reading every lane's;
// kForceBlock forces the one-block variant.
//
// Bound on this card. Bytes: 32 per active symbol's record, 4 per tap of
// an active (channel, lane), the words consumed, the tables and
// parameters, the plane written once. Dependencies: every step is one
// barrier chain after the previous step's plane stores (a cluster
// exchange, or the block scan), so a decode of S steps costs at least S
// such chains one after another (chip_smoke.py prints both floors).

#include "rans_common.cuh"

namespace {

constexpr int kTaps = 6;
constexpr int kPredClamp = 255;
constexpr int kChunkAlign = 8;  // lanes a block of a cluster owns: a multiple of this
constexpr int kRecVec = 2;  // int4 of a record (32 bytes)
// the launch rule runs one block an image where a step's pairs are at most
// this many (PERF.md: the sweep)
constexpr int kBlockPairs = 2048;

enum : int {
  kNoPrefetch = 1,
  kSlotTaps = 2,
  kPadded = 4,
  kForceBlock = 8,
  kPrefetch = 16,
};
enum : int { kVariantBlock = 0, kVariantCluster = 1 };

struct StepArgs {
  const int64_t* x_in;     // [B, C, NL]
  const int64_t* gptr_in;  // [B]
  const int4* step_map;    // [S] (k0, lane0, len, wrapped)
  const int4* rec;         // [K or S * NL][2] records (shared by the batch)
  const float* vparams;    // [B, C, F, 6]
  const float* wparams;    // [B, C, F, 6]
  const float* edges;      // [contexts - 1]
  const int32_t* stream;   // [B, W]
  const int32_t* cdf;      // [B, C, CA, 1024]
  const int32_t* bits;     // [B, C, CA]
  int32_t* plane;          // [B, C, n_slots], zeroed by the caller
  int32_t* splane;         // [B, C, K], the kernel's scratch
  int64_t* x_out;          // [B, C, NL]
  int64_t* gptr_out;       // [B]
  int steps, channels, lanes, contexts, fine, stream_len, max_len, flags, prefetch;
  int64_t n_slots, num_symbols;
  int64_t chunk;  // pairs a block of a cluster owns
};

// The operands of image `img`; the step map, records and edges are shared.
__device__ __forceinline__ StepArgs image_args(const StepArgs& a, int64_t img) {
  StepArgs o = a;
  const int64_t cnl = static_cast<int64_t>(a.channels) * a.lanes;
  const int64_t tab = static_cast<int64_t>(a.channels) * a.contexts;
  const int64_t par = static_cast<int64_t>(a.channels) * a.fine * kTaps;
  o.x_in += img * cnl;
  o.gptr_in += img;
  o.vparams += img * par;
  o.wparams += img * par;
  o.stream += img * a.stream_len;
  o.cdf += img * tab * kAlphabet;
  o.bits += img * tab;
  o.plane += img * a.channels * a.n_slots;
  o.splane += img * a.channels * a.num_symbols;
  o.x_out += img * cnl;
  o.gptr_out += img;
  return o;
}

// Dynamic shared memory: the tables, vparams and wparams [C, F, 6] f32,
// the edges; then the variant's own part.
__host__ __device__ constexpr size_t params_bytes(int channels, int fine) {
  return align16(static_cast<size_t>(channels) * fine * kTaps * 4);
}

__host__ __device__ constexpr size_t base_bytes(int channels, int contexts, int fine) {
  return table_bytes(channels * contexts) + 2 * params_bytes(channels, fine) +
         align16(static_cast<size_t>(contexts) * 4);
}

// One block's word window: C * max_len words and the 16-byte alignment of
// its start (up to 3 words before g).
__host__ __device__ constexpr size_t window_bytes(int channels, int max_len) {
  return align16((static_cast<size_t>(channels) * max_len + 3) * 4);
}

// One block: the lane states [C, NL] u32; with prefetch two record
// buffers of max_len records and two word windows (by step parity).
__host__ __device__ constexpr size_t block_bytes(int channels, int contexts, int fine,
                                                 int lanes, int max_len, bool prefetch) {
  return base_bytes(channels, contexts, fine) +
         align16(static_cast<size_t>(channels) * lanes * 4) +
         (prefetch ? 2 * (static_cast<size_t>(max_len) * 32 + window_bytes(channels, max_len))
                   : 0);
}

// A block of a cluster: with prefetch, the records of its lanes (at most
// `lanes`).
__host__ __device__ constexpr size_t cluster_bytes(int channels, int contexts, int fine,
                                                   int64_t chunk, int lanes, bool prefetch) {
  return base_bytes(channels, contexts, fine) +
         (prefetch ? static_cast<size_t>(chunk < lanes ? chunk : lanes) * 32 : 0);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Arrive on `bar` expecting `bytes` more of bulk copies before its phase
// completes.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// TMA's 1-D form: `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

struct Shared {
  uint32_t* bits;
  uint16_t* cdf;
  float* vp;
  float* wp;
  float* edges;
  unsigned char* rest;  // the variant's part
};

// Load the image's tables, predictor rows and the edges into shared memory
// (the caller's barrier publishes them).
__device__ __forceinline__ Shared load_shared(const StepArgs& a, unsigned char* smem) {
  const int nctx = a.channels * a.contexts;
  const int npar = a.channels * a.fine * kTaps;
  const size_t tab = table_bytes(nctx);
  const size_t pb = params_bytes(a.channels, a.fine);
  Shared s;
  s.bits = reinterpret_cast<uint32_t*>(smem);
  s.cdf = reinterpret_cast<uint16_t*>(smem + align16(static_cast<size_t>(nctx) * 4));
  s.vp = reinterpret_cast<float*>(smem + tab);
  s.wp = reinterpret_cast<float*>(smem + tab + pb);
  s.edges = reinterpret_cast<float*>(smem + tab + 2 * pb);
  s.rest = smem + base_bytes(a.channels, a.contexts, a.fine);
  load_tables(a.cdf, a.bits, nctx, s.bits, s.cdf);
  for (int k = threadIdx.x; k < npar; k += kThreads) {
    s.vp[k] = a.vparams[k];
    s.wp[k] = a.wparams[k];
  }
  for (int k = threadIdx.x; k < a.contexts - 1; k += kThreads) s.edges[k] = a.edges[k];
  return s;
}

// The count of edges <= w (NaN and negative widths: 0).
__device__ __forceinline__ int bucket_of(float w, const float* s_edges, int nedges) {
  if (isnan(w)) w = 0.0f;
  w = fmaxf(w, 0.0f);
  int b = 0;
  // the first 16 edges unrolled, so that their loads go out together
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (e < nedges) b += w >= s_edges[e] ? 1 : 0;
  for (int e = 16; e < nedges; ++e) b += w >= s_edges[e] ? 1 : 0;
  return b;
}

// Context bucket and clamped prediction of one symbol (torch_ops.contexts):
// both the LF and the HF forms, then one bucket search on the chosen width
// (a warp mixes the two kinds, so branches would run both anyway).
__device__ __forceinline__ void lane_context(const int (&v)[kTaps], bool lf, const float* vp,
                                             const float* wp, const float* s_edges, int nedges,
                                             int* bucket, int* pred) {
  const int mx = max(v[0], v[2]);
  const int mn = min(v[0], v[2]);
  const int p_lf = v[1] >= mx ? mx : (v[1] <= mn ? mn : v[0] + v[2] - v[1]);
  float f[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) f[k] = static_cast<float>(v[k]);
  const float g1 = fabsf(__fsub_rn(f[0], f[3]));
  const float g2 = fabsf(__fsub_rn(f[1], f[2]));
  const float g3 = fabsf(__fsub_rn(f[4], f[5]));
  const float g4 = fabsf(__fsub_rn(f[1], f[5]));
  const float g5 = fabsf(__fsub_rn(f[2], f[4]));
  float w = __fadd_rn(wp[0], __fmul_rn(wp[1], g1));
  w = __fadd_rn(w, __fmul_rn(wp[2], g2));
  w = __fadd_rn(w, __fmul_rn(wp[3], g3));
  w = __fadd_rn(w, __fmul_rn(wp[4], g4));
  w = __fadd_rn(w, __fmul_rn(wp[5], g5));
  const float gsum = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(g1, g2), g3), g4), g5);
  if (gsum == 0.0f) w = 0.0f;
  float pf = __fmul_rn(f[0], vp[0]);
#pragma unroll
  for (int k = 1; k < kTaps; ++k) pf = __fadd_rn(pf, __fmul_rn(f[k], vp[k]));
  if (isnan(pf)) pf = 0.0f;
  pf = fminf(fmaxf(pf, -1e9f), 1e9f);
  *bucket = bucket_of(lf ? static_cast<float>(abs(v[0] - v[2])) : w, s_edges, nedges);
  const int p = lf ? p_lf : __float2int_rz(pf);
  *pred = min(max(p, -kPredClamp), kPredClamp);
}

// The six taps of channel c from a record (r0, r1): from the plane in
// schedule order, or, with kSlotTaps, from the coefficient plane; -1 (or
// an index past the plane) reads 0. The loads go out together. kL1: one block
// reads its own stores after __syncthreads, so its loads may hit L1
// (ld.global.ca); a cluster reads other blocks' stores, through L2 only
// (ld.global.cg). Never ld.global.nc: the planes change during the kernel.
template <bool kL1>
__device__ __forceinline__ void load_taps(const StepArgs& a, int c, const int4& r0,
                                          const int4& r1, int (&tv)[kTaps]) {
  const bool slots = a.flags & kSlotTaps;
  const int32_t* base = slots ? a.plane + c * a.n_slots : a.splane + c * a.num_symbols;
  const int64_t lim = slots ? a.n_slots : a.num_symbols;
  const int tap[kTaps] = {r0.y, r0.z, r0.w, r1.x, r1.y, r1.z};
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    const int tk = tap[k];
    tv[k] = tk < 0 || tk >= lim ? 0 : (kL1 ? __ldca(base + tk) : __ldcg(base + tk));
  }
}

template <bool kL1>
__device__ __forceinline__ void store_plane(int32_t* p, int v) {
  if (kL1) {
    __stwb(p, v);
  } else {
    __stcg(p, v);
  }
}

// One symbol of channel c at schedule index k from state x, its taps tv
// and its record's slot and last word: the contexts, the symbol, the
// stores of its value (the schedule-order plane at k unless kSlotTaps, the
// coefficient plane at coef). Returns the pre-renorm state.
template <bool kL1>
__device__ __forceinline__ uint32_t decode_pair(const StepArgs& a, const Shared& sm, int c,
                                                int k, int coef, int meta,
                                                const int (&tv)[kTaps], uint32_t x) {
  const bool lf = (meta & 0xFF) != 0;
  const int grp = min(max(static_cast<int>(static_cast<int8_t>((meta >> 8) & 0xFF)), 0),
                      a.fine - 1);
  const int fb = static_cast<int8_t>((meta >> 16) & 0xFF);
  const int prow = (c * a.fine + grp) * kTaps;
  int bucket, pred;
  lane_context(tv, lf, sm.vp + prow, sm.wp + prow, sm.edges, a.contexts - 1, &bucket, &pred);
  if (fb >= 0) bucket = fb;
  const int ctx = c * a.contexts + min(max(bucket, 0), a.contexts - 1);
  uint32_t sym;
  const uint32_t x2 = decode_symbol(sm.bits, sm.cdf, ctx, x, &sym);
  const int val =
      ((sym & 1u) ? -static_cast<int>((sym + 1u) >> 1) : static_cast<int>(sym >> 1)) + pred;
  if (!(a.flags & kSlotTaps)) store_plane<kL1>(a.splane + c * a.num_symbols + k, val);
  if (coef >= 0 && coef < a.n_slots) store_plane<kL1>(a.plane + c * a.n_slots + coef, val);
  return x2;
}

// Whether the lane bands of steps m and mn meet (mod NL): then step mn
// reads lane states that step m writes after its block scan.
__device__ __forceinline__ bool bands_meet(const int4& m, const int4& mn, int lanes) {
  if (m.z == 0 || mn.z == 0) return false;
  int d = mn.y - m.y;
  if (d < 0) d += lanes;
  return d < m.z || d + mn.z > lanes;
}

// The records and taps of a step's pairs for thread t of the one-block
// variant (pair t and, at P = 2, t + kThreads, in rank order): the
// channel, band offset, slot and last record word of each, its taps'
// loads issued; `on` the pairs the thread has.
template <int P>
struct BlockPairs {
  int c[P], o[P], coef[P], meta[P], tv[P][kTaps];
  uint32_t on;
};

// Step s's (map m) pairs of this thread; the records from `buf`
// (prefetch) or global memory.
template <int P>
__device__ __forceinline__ void load_block_pairs(const StepArgs& a, int s, const int4& m,
                                                 const int4* buf, bool pf, BlockPairs<P>& q) {
  const int len = m.z;
  const int npairs = a.channels * len;
  q.on = 0;
#pragma unroll
  for (int v = 0; v < P; ++v) {
    const int p = threadIdx.x + v * kThreads;
    q.c[v] = q.o[v] = q.coef[v] = q.meta[v] = 0;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) q.tv[v][k] = 0;
    if (p < npairs) {
      q.on |= 1u << v;
      int c = 0, j = p;
      while (j >= len) {
        j -= len;
        ++c;
      }
      // rank j of the channel's pairs -> offset o in the band: a wrapped
      // band ranks its tail lanes [0, wrapped) first
      const int o = j < m.w ? len - m.w + j : j - m.w;
      q.c[v] = c;
      q.o[v] = o;
      int4 r0, r1;
      if (pf) {
        r0 = buf[o * kRecVec];
        r1 = buf[o * kRecVec + 1];
      } else {
        int n = m.y + o;
        if (n >= a.lanes) n -= a.lanes;
        const int64_t ri =
            (a.flags & kPadded) ? static_cast<int64_t>(s) * a.lanes + n : int64_t{m.x} + o;
        r0 = __ldg(a.rec + ri * kRecVec);
        r1 = __ldg(a.rec + ri * kRecVec + 1);
      }
      q.coef[v] = r0.x;
      q.meta[v] = r1.w;
      load_taps<true>(a, c, r0, r1, q.tv[v]);
    }
  }
}

// One block an image (see the top). Per step s, for thread t's pairs (t
// and, at P = 2, t + kThreads, in rank order): the decode and the plane
// stores, each round's renorm ranks within the warp by ballot; the block
// barrier; then first step s + 1's records and taps (the chain), and only
// then step s's word ranks (a scan of the warps' counts, packed in 16-bit
// fields), words and state stores. With prefetch, one thread copies in
// bulk the next step's word window and the records of the step after it,
// completing on the barrier of the next step's parity.
template <int P>
__global__ void __launch_bounds__(kThreads, 1) step_block_kernel(const StepArgs batch) {
  static_assert(P == 1 || P == 2, "at most two rounds of kThreads pairs");
  const StepArgs a = image_args(batch, blockIdx.y);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp[2][kWarps];
  __shared__ __align__(8) uint64_t s_bar[2];  // the copies each step parity waits for
  const Shared sm = load_shared(a, smem);
  const int C = a.channels;
  const int NL = a.lanes;
  const int cnl = C * NL;
  uint32_t* s_x = reinterpret_cast<uint32_t*>(sm.rest);
  int4* s_rec = reinterpret_cast<int4*>(sm.rest + align16(static_cast<size_t>(cnl) * 4));
  const int rstride = a.max_len * kRecVec;  // int4 a record buffer
  const int wstride = static_cast<int>(window_bytes(C, a.max_len) / 4);
  uint32_t* s_win = reinterpret_cast<uint32_t*>(s_rec + 2 * rstride);
  const bool pf = a.prefetch;
  // a window is copied in bulk where the image's stream row is 16-byte aligned
  const bool row16 = (reinterpret_cast<uintptr_t>(a.stream) & 15) == 0;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const uint32_t lt = (1u << lane) - 1u;
  constexpr int kCopier = kThreads - 1;  // the last warp, idle in most steps
  if (t == kCopier) {
    mbar_init(&s_bar[0], 1);
    mbar_init(&s_bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = t; i < cnl; i += kThreads) s_x[i] = static_cast<uint32_t>(a.x_in[i]);
  int64_t g = *a.gptr_in;
  const int4 zero = make_int4(0, 0, 0, 0);
  // the step map two steps ahead, so that no copy waits for it
  int4 m = a.steps > 0 ? __ldg(a.step_map) : zero;
  int4 mn = a.steps > 1 ? __ldg(a.step_map + 1) : zero;
  if (pf)  // step 0's records
    for (int q = t; q < m.z * kRecVec; q += kThreads)
      s_rec[q] = __ldg(a.rec + static_cast<int64_t>(m.x) * kRecVec + q);
  __syncthreads();  // the tables, parameters, states, barriers and step 0's records

  // The copies step s waits for (on the barrier of its parity, after its
  // block barrier): its word window [g0, g0 + wbytes / 4), g0 = g rounded
  // down to 16 bytes, where that lies inside the stream (else its words
  // are loaded when needed, each index clamped), and step s + 1's records.
  // Their buffers' last readers passed a block barrier before the issue
  // (the generic reads before the async writes: the proxy fence).
  auto issue = [&](int s, int64_t gs, const int4& ms, const int4& mns) -> bool {
    const int64_t g0 = gs & ~int64_t{3};
    const uint32_t wbytes =
        static_cast<uint32_t>(align16(static_cast<size_t>(C * ms.z + (gs - g0)) * 4));
    const bool bulk = pf && row16 && ms.z > 0 && g0 * 4 + wbytes <= int64_t{4} * a.stream_len;
    if (pf && t == kCopier) {
      const uint32_t rbytes = static_cast<uint32_t>(mns.z) * 32u;
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(&s_bar[s & 1], (bulk ? wbytes : 0u) + rbytes);
      if (bulk) bulk_copy(s_win + (s & 1) * wstride, a.stream + g0, wbytes, &s_bar[s & 1]);
      if (rbytes)
        bulk_copy(s_rec + ((s + 1) & 1) * rstride,
                  a.rec + static_cast<int64_t>(mns.x) * kRecVec, rbytes, &s_bar[s & 1]);
    }
    return bulk;
  };
  BlockPairs<P> q;
  q.on = 0;
  if (a.steps > 0) load_block_pairs<P>(a, 0, m, s_rec, pf, q);
  bool wbulk = a.steps > 0 ? issue(0, g, m, mn) : false;

  for (int s = 0; s < a.steps; ++s) {
    const int par = s & 1;
    const int4 mnn = s + 2 < a.steps ? __ldg(a.step_map + s + 2) : zero;
    // the step's decode and plane stores
    uint32_t xs[P];
    int sxs[P], rk[P];
    int wcnt = 0;
#pragma unroll
    for (int v = 0; v < P; ++v) {
      xs[v] = 0u;
      sxs[v] = 0;
      bool need = false;
      if (q.on >> v & 1u) {
        int n = m.y + q.o[v];
        if (n >= NL) n -= NL;
        sxs[v] = q.c[v] * NL + n;
        xs[v] = decode_pair<true>(a, sm, q.c[v], m.x + q.o[v], q.coef[v], q.meta[v], q.tv[v],
                                  s_x[sxs[v]]);
        need = xs[v] < kRansL;
      }
      const uint32_t mask = __ballot_sync(kFull, need);
      rk[v] = need ? __popc(mask & lt) : -1;
      wcnt += __popc(mask) << (16 * v);
    }
    const uint32_t on = q.on;
    if (lane == 0) s_warp[par][warp] = wcnt;
    __syncthreads();  // the plane stores and the warps' counts
    if (pf) mbar_wait(&s_bar[par], (s >> 1) & 1);  // the window, the next records
    // the chain first: the next step's records and taps
    if (s + 1 < a.steps) load_block_pairs<P>(a, s + 1, mn, s_rec + (par ^ 1) * rstride, pf, q);
    // then this step's word ranks, words and states
    const uint32_t* win = s_win + par * wstride;
    const int woff = static_cast<int>(g & 3);
    const int wincl = warp_incl_scan(s_warp[par][lane], lane);
    const int prev = __shfl_sync(kFull, wincl, (warp + 31) & 31);
    const int before = warp ? prev : 0;
    const int btot = __shfl_sync(kFull, wincl, 31);
#pragma unroll
    for (int v = 0; v < P; ++v) {
      if (rk[v] >= 0) {
        const int r = (v ? (btot & 0xFFFF) : 0) + ((before >> (16 * v)) & 0xFFFF) + rk[v];
        const uint32_t w = wbulk ? win[woff + r]
                                 : static_cast<uint32_t>(
                                       a.stream[min64(g + r, a.stream_len - 1)]);
        xs[v] = (xs[v] << 16) | w;
      }
    }
#pragma unroll
    for (int v = 0; v < P; ++v)
      if (on >> v & 1u) s_x[sxs[v]] = xs[v];
    g += (btot & 0xFFFF) + (btot >> 16);
    // the next step reads lane states this step just wrote: order them
    if (bands_meet(m, mn, NL)) __syncthreads();
    if (s + 1 < a.steps) wbulk = issue(s + 1, g, mn, mnn);
    m = mn;
    mn = mnn;
  }
  __syncthreads();  // the last states
  for (int i = t; i < cnl; i += kThreads) a.x_out[i] = static_cast<int64_t>(s_x[i]);
  if (t == 0) *a.gptr_out = g;
}

// The records of step m for the lanes of a block of a cluster, in bulk
// (one thread): the block's lanes are the cyclic interval [n_lo, n_lo +
// nlanes) mod NL, its slot t holding lane n_lo + t's record; the lanes of
// the band are at most two runs of consecutive records.
__device__ __forceinline__ void copy_cluster_records(const StepArgs& a, const int4& m, int n_lo,
                                                     int nlanes, int4* s_rec, uint64_t* bar) {
  int o0 = n_lo - m.y;  // band offset of slot 0
  if (o0 < 0) o0 += a.lanes;
  const int n1 = o0 < m.z ? min(nlanes, m.z - o0) : 0;  // slots [0, n1): offsets from o0
  const int t2 = a.lanes - o0;  // the slot where the offsets wrap to 0
  const int n2 = o0 > 0 && t2 < nlanes ? min(nlanes - t2, m.z) : 0;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect_tx(bar, static_cast<uint32_t>(n1 + n2) * 32u);
  if (n1) bulk_copy(s_rec, a.rec + (static_cast<int64_t>(m.x) + o0) * kRecVec, n1 * 32u, bar);
  if (n2)
    bulk_copy(s_rec + t2 * kRecVec, a.rec + static_cast<int64_t>(m.x) * kRecVec, n2 * 32u, bar);
}

// The records and taps of thread t's lanes of a cluster at step s (map
// m): the schedule index, slot and last record word of each active lane,
// its taps' loads issued. The records come from the block's slots
// (prefetch; lane n at slot n - n_lo mod NL) or from global memory.
template <int P>
struct ClusterLanes {
  int k[P], coef[P], meta[P], tv[P][kTaps];
  uint32_t on;
};

template <int P>
__device__ __forceinline__ void load_cluster_lanes(const StepArgs& a, int s, const int4& m,
                                                   uint32_t live, int c0, int n0, int n_lo,
                                                   const int4* s_rec, ClusterLanes<P>& q) {
  const int NL = a.lanes;
  q.on = 0;
  int c = c0, n = n0;
#pragma unroll
  for (int v = 0; v < P; ++v) {
    q.k[v] = q.coef[v] = q.meta[v] = 0;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) q.tv[v][k] = 0;
    int o = n - m.y;
    if (o < 0) o += NL;
    if ((live >> v & 1u) && o < m.z) {
      q.on |= 1u << v;
      q.k[v] = m.x + o;
      int4 r0, r1;
      if (a.prefetch) {
        int slot = n - n_lo;
        if (slot < 0) slot += NL;
        r0 = s_rec[slot * kRecVec];
        r1 = s_rec[slot * kRecVec + 1];
      } else {
        const int64_t ri = (a.flags & kPadded) ? static_cast<int64_t>(s) * NL + n : q.k[v];
        r0 = __ldg(a.rec + ri * kRecVec);
        r1 = __ldg(a.rec + ri * kRecVec + 1);
      }
      q.coef[v] = r0.x;
      q.meta[v] = r1.w;
      load_taps<false>(a, c, r0, r1, q.tv[v]);
    }
    if (++n == NL) {
      n = 0;
      ++c;
    }
  }
}

// One cluster an image (see the top): thread t owns the lanes
// lo + tP .. lo + tP + P - 1 of the flat rank index for the whole decode.
// Per step s: the decode and plane stores of its active lanes, the block
// scan (after which one thread copies step s + 1's records for the block
// in bulk) and the cluster exchange; then first step s + 1's records and
// taps (the chain), and only then step s's words.
template <int P>
__global__ void __launch_bounds__(kThreads, 1) step_cluster_kernel(const StepArgs batch) {
  const StepArgs a = image_args(batch, blockIdx.y);  // this cluster's image
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp[2][kWarps];
  __shared__ int s_tot[2];
  __shared__ __align__(8) uint64_t s_bar;  // the records' copies, one phase a step
  const Shared sm = load_shared(a, smem);
  int4* s_rec = reinterpret_cast<int4*>(sm.rest);  // the block's lanes' records
  const int NL = a.lanes;
  const int64_t cnl = static_cast<int64_t>(a.channels) * NL;
  const int blk = static_cast<int>(cg::this_cluster().block_rank());
  const int64_t lo = min64(cnl, blk * a.chunk);
  const int64_t hi = min64(cnl, lo + a.chunk);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  constexpr int kCopier = kThreads - 1;
  // the block's lanes: a cyclic interval from n_lo (a chunk is at most NL
  // pairs wherever records are copied)
  const int n_lo = static_cast<int>(lo % NL);
  const int nlanes = static_cast<int>(min64(hi - lo, NL));
  int64_t g = *a.gptr_in;

  const int64_t i0 = lo + static_cast<int64_t>(t) * P;
  uint32_t live = 0;
#pragma unroll
  for (int v = 0; v < P; ++v)
    if (i0 + v < hi) live |= 1u << v;
  uint32_t xv[P];
#pragma unroll
  for (int v = 0; v < P; ++v)
    xv[v] = live >> v & 1u ? static_cast<uint32_t>(a.x_in[i0 + v]) : 0u;
  // channel and lane of the thread's first lane
  const int c0 = static_cast<int>(i0 / NL);
  const int n0 = static_cast<int>(i0 - static_cast<int64_t>(c0) * NL);
  const int4 zero = make_int4(0, 0, 0, 0);
  // the step map two steps ahead, so that no copy waits for it
  int4 m = a.steps > 0 ? __ldg(a.step_map) : zero;
  int4 mn = a.steps > 1 ? __ldg(a.step_map + 1) : zero;
  if (a.prefetch && t == kCopier) {
    mbar_init(&s_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (a.steps > 0) copy_cluster_records(a, m, n_lo, nlanes, s_rec, &s_bar);
  }
  __syncthreads();  // the tables, parameters and barrier
  ClusterLanes<P> q;
  q.on = 0;
  if (a.prefetch && a.steps > 0) mbar_wait(&s_bar, 0);
  if (a.steps > 0 && live) load_cluster_lanes<P>(a, 0, m, live, c0, n0, n_lo, s_rec, q);

  for (int s = 0; s < a.steps; ++s) {
    const int par = s & 1;
    const int4 mnn = s + 2 < a.steps ? __ldg(a.step_map + s + 2) : zero;
    uint32_t need_m = 0;
    int c = c0, n = n0;
#pragma unroll
    for (int v = 0; v < P; ++v) {
      if (q.on >> v & 1u) {
        xv[v] = decode_pair<false>(a, sm, c, q.k[v], q.coef[v], q.meta[v], q.tv[v], xv[v]);
        if (xv[v] < kRansL) need_m |= 1u << v;
      }
      if (++n == NL) {
        n = 0;
        ++c;
      }
    }
    const int cnt = __popc(need_m);
    const int incl = warp_incl_scan(cnt, lane);
    int btot = 0;
    const int local = block_scan(s_warp, par, cnt, incl, lane, warp, &btot);
    // every thread has read this step's records: the next step's in bulk
    if (a.prefetch && t == kCopier && s + 1 < a.steps)
      copy_cluster_records(a, mn, n_lo, nlanes, s_rec, &s_bar);
    int64_t base = 0, rowtot = 0;
    exchange<true>(s_tot, par, btot, lane, &base, &rowtot);
    // the chain first: the next step's records and taps
    if (s + 1 < a.steps) {
      if (a.prefetch) mbar_wait(&s_bar, (s + 1) & 1);
      if (live) load_cluster_lanes<P>(a, s + 1, mn, live, c0, n0, n_lo, s_rec, q);
    }
    if (need_m) take_words<P>(a.stream, a.stream_len, g + base + local, need_m, xv);
    g += rowtot;
    m = mn;
    mn = mnn;
  }
#pragma unroll
  for (int v = 0; v < P; ++v)
    if (live >> v & 1u) a.x_out[i0 + v] = static_cast<int64_t>(xv[v]);
  // no block leaves while another may still read its s_tot
  if (cg::this_cluster().num_blocks() > 1) cg::this_cluster().sync();
  if (blk == 0 && t == 0) *a.gptr_out = g;
}

// The one-block variant's empty step, `steps` times on one block: one
// dependent L2 load, the warp's count by ballot, its store and the block
// barrier a step.
__global__ void __launch_bounds__(kThreads, 1) step_floor_kernel(int steps,
                                                                 const int32_t* scratch,
                                                                 int* sink) {
  __shared__ int s_warp[2][kWarps];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  int v = t;
  int64_t acc = 0;
  for (int s = 0; s < steps; ++s) {
    v = __ldcg(scratch + (v & 1023));
    const uint32_t mask = __ballot_sync(kFull, ((v + s) & 1) != 0);
    if (lane == 0) s_warp[s & 1][warp] = __popc(mask);
    __syncthreads();
    const int other = s_warp[s & 1][(warp + 1) & 31];
    acc += other;
    v += t + other;
  }
  if (t == 0 && acc == -1) *sink = 1;  // keeps the loop
}

// The kernels by variant and pairs a thread (one block: 1 or 2).
constexpr int kPers[] = {1, 2, 4, 8};
constexpr int kNumPers = 4;

const void* kernel_of(int variant, int per) {
  if (variant == kVariantBlock)
    return per == 1 ? reinterpret_cast<const void*>(step_block_kernel<1>)
                    : reinterpret_cast<const void*>(step_block_kernel<2>);
  switch (per) {
    case 1: return reinterpret_cast<const void*>(step_cluster_kernel<1>);
    case 2: return reinterpret_cast<const void*>(step_cluster_kernel<2>);
    case 4: return reinterpret_cast<const void*>(step_cluster_kernel<4>);
    default: return reinterpret_cast<const void*>(step_cluster_kernel<8>);
  }
}

// The fewest pairs a thread (1, 2, 4 or 8) that cover `pairs` with one
// block; 0 where none does.
int per_for(int64_t pairs) {
  for (int k = 0; k < kNumPers; ++k)
    if (pairs <= static_cast<int64_t>(kThreads) * kPers[k]) return kPers[k];
  return 0;
}

struct Plan {
  int variant;
  int cluster;
  int per;  // pairs a thread
  int prefetch;
  int64_t chunk;  // pairs a block of a cluster owns
  size_t dyn;     // dynamic shared memory of a block
};

// The launch plan (see the top). With `want` 0 and C * max_len at most
// kBlockPairs (or kForceBlock): one block an image, if its shared memory
// holds the tables and the lane states; with the record buffers and the
// word windows where a step needs two pairs a thread (or kPrefetch) and
// they fit too (never with kNoPrefetch or kPadded). Else a cluster of
// `want` blocks, or the rule's (the smallest S with at most 2048 lanes a
// block, capped at 16), which copies its records ahead only with
// kPrefetch and where its shared memory holds them. The sweep measured
// prefetch faster in one block with two pairs a thread, slower in one
// block with one and in a cluster (PERF.md). With check_fit, the cluster
// size is lowered (rule) or refused (`want`) while
// cudaOccupancyMaxActiveClusters says its blocks cannot be resident at
// once; without it, a size that cannot be resident is refused by the
// launch. More than 8192 lanes a block (C * NL past 16 * 8192) is refused.
cudaError_t make_plan(int channels, int lanes, int contexts, int fine, int max_len, int want,
                      int flags, bool check_fit, Plan* p) {
  if (channels < 1 || lanes < 1 || contexts < 1 || fine < 1 || max_len < 0 || max_len > lanes)
    return cudaErrorInvalidValue;
  const int64_t cnl = static_cast<int64_t>(channels) * lanes;
  if (cnl >= (int64_t{1} << 24)) return cudaErrorInvalidValue;  // ranks fit 24 bits
  if (want < 0 || want > kMaxCluster || (want & (want - 1)) != 0) return cudaErrorInvalidValue;
  const void* fns[2 + kNumPers];
  fns[0] = kernel_of(kVariantBlock, 1);
  fns[1] = kernel_of(kVariantBlock, 2);
  for (int k = 0; k < kNumPers; ++k) fns[2 + k] = kernel_of(kVariantCluster, kPers[k]);
  size_t room = 0;
  cudaError_t err = device_room(fns, 2 + kNumPers, &room);
  if (err != cudaSuccess) return err;
  const bool pf_off = flags & (kNoPrefetch | kPadded);
  const bool force_block = flags & kForceBlock;
  const int64_t pairs = static_cast<int64_t>(channels) * max_len;
  if (want == 0 && pairs <= (force_block ? 2 * kThreads : kBlockPairs)) {
    const bool want_pf = !pf_off && ((flags & kPrefetch) || per_for(pairs) == 2);
    for (int pf = want_pf ? 1 : 0; pf >= 0; --pf) {
      const size_t dyn = block_bytes(channels, contexts, fine, lanes, max_len, pf != 0);
      if (dyn <= room) {
        *p = Plan{kVariantBlock, 1, per_for(pairs), pf, 0, dyn};
        return cudaSuccess;
      }
    }
  }
  if (force_block) return cudaErrorInvalidValue;
  if (base_bytes(channels, contexts, fine) > room) return cudaErrorInvalidValue;
  int s = want;
  if (s == 0) {
    s = 1;
    while (s < kMaxCluster && (cnl + s - 1) / s > kBlockLanes) s *= 2;
  }
  for (;; s /= 2) {
    const int64_t chunk = ((cnl + s - 1) / s + kChunkAlign - 1) / kChunkAlign * kChunkAlign;
    const int per = per_for(chunk);
    if (per == 0) return cudaErrorInvalidValue;
    const bool pf = !pf_off && (flags & kPrefetch) &&
                    cluster_bytes(channels, contexts, fine, chunk, lanes, true) <= room;
    const size_t dyn = cluster_bytes(channels, contexts, fine, chunk, lanes, pf);
    bool fits = true;
    if (check_fit) {
      err = cluster_fits(kernel_of(kVariantCluster, per), s, dyn, &fits);
      if (err != cudaSuccess) return err;
    }
    if (fits) {
      *p = Plan{kVariantCluster, s, per, pf ? 1 : 0, chunk, dyn};
      return cudaSuccess;
    }
    if (want != 0 || s == 1) return cudaErrorInvalidClusterSize;
  }
}

template <int P>
cudaError_t launch(int variant, const cudaLaunchConfig_t& cfg, const StepArgs& a) {
  if (variant == kVariantBlock)
    return cudaLaunchKernelEx(&cfg, step_block_kernel<P == 1 ? 1 : 2>, a);
  return cudaLaunchKernelEx(&cfg, step_cluster_kernel<P>, a);
}

}  // namespace

// The launch plan of frave_rans_decode_steps for one image of channels x
// lanes whose widest step has max_len lanes, with `contexts` contexts and
// `fine` predictor rows: out[0] the variant (0 one block, 1 a cluster),
// out[1] the blocks, out[2] the pairs a thread, out[3] whether the records
// are copied ahead. `want` a power of two up to 16 forces the cluster
// variant at that size (its blocks must be resident at once), 0 takes the
// launch rule; `flags` the design switches.
extern "C" int frave_rans_decode_steps_plan(int channels, int lanes, int contexts, int fine,
                                            int max_len, int want, int flags, int* out) {
  Plan p;
  const cudaError_t err =
      make_plan(channels, lanes, contexts, fine, max_len, want, flags, true, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = p.variant;
  out[1] = p.cluster;
  out[2] = p.per;
  out[3] = p.prefetch;
  return 0;
}

// Every step of a decode of `images` same-shape images, one block or one
// cluster of `cluster` blocks each (`variant` and `cluster` from the
// plan): x_in / x_out [images, channels, lanes] int64, gptr_in / gptr_out
// [images] int64, step_map [steps, 4] int32, rec [num_symbols, 8] int32
// (kPadded: [steps * lanes, 8]; 16-byte aligned), vparams / wparams
// [images, channels, fine, 6] f32, edges [contexts - 1] f32, stream
// [images, stream_len] int32, cdf [images, channels, contexts, 1024] and
// bits [images, channels, contexts] int32, plane [images, channels,
// n_slots] int32 (zeroed; written in place), splane [images, channels,
// num_symbols] int32 (scratch).
extern "C" int frave_rans_decode_steps(
    const void* x_in, const void* gptr_in, const void* step_map, const void* rec,
    const void* vparams, const void* wparams, const void* edges, const void* stream,
    const void* cdf, const void* bits, void* plane, void* splane, void* x_out, void* gptr_out,
    int steps, int channels, int lanes, int contexts, int fine, int max_len, long long n_slots,
    long long num_symbols, int stream_len, int images, int variant, int cluster, int flags,
    void* cuda_stream) {
  if (steps < 0 || stream_len < 1 || cluster < 1 || images < 1 || images > 65535 ||
      n_slots < 1 || n_slots >= (1LL << 31) || num_symbols < 0 ||
      num_symbols >= (1LL << 31) || (variant != kVariantBlock && variant != kVariantCluster) ||
      (reinterpret_cast<uintptr_t>(rec) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const int want = variant == kVariantBlock ? 0 : cluster;
  const int fl = variant == kVariantBlock ? flags | kForceBlock : flags & ~kForceBlock;
  cudaError_t err = make_plan(channels, lanes, contexts, fine, max_len, want, fl, false, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.variant != variant || p.cluster != cluster) return static_cast<int>(cudaErrorInvalidValue);
  StepArgs a;
  a.x_in = static_cast<const int64_t*>(x_in);
  a.gptr_in = static_cast<const int64_t*>(gptr_in);
  a.step_map = static_cast<const int4*>(step_map);
  a.rec = static_cast<const int4*>(rec);
  a.vparams = static_cast<const float*>(vparams);
  a.wparams = static_cast<const float*>(wparams);
  a.edges = static_cast<const float*>(edges);
  a.stream = static_cast<const int32_t*>(stream);
  a.cdf = static_cast<const int32_t*>(cdf);
  a.bits = static_cast<const int32_t*>(bits);
  a.plane = static_cast<int32_t*>(plane);
  a.splane = static_cast<int32_t*>(splane);
  a.x_out = static_cast<int64_t*>(x_out);
  a.gptr_out = static_cast<int64_t*>(gptr_out);
  a.steps = steps;
  a.channels = channels;
  a.lanes = lanes;
  a.contexts = contexts;
  a.fine = fine;
  a.stream_len = stream_len;
  a.max_len = max_len;
  a.flags = flags & ~kForceBlock;
  a.prefetch = p.prefetch;
  a.n_slots = n_slots;
  a.num_symbols = num_symbols;
  a.chunk = p.chunk;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(p.cluster, images, p.dyn, static_cast<cudaStream_t>(cuda_stream), &attr);
  switch (p.per) {
    case 1: err = launch<1>(p.variant, cfg, a); break;
    case 2: err = launch<2>(p.variant, cfg, a); break;
    case 4: err = launch<4>(p.variant, cfg, a); break;
    default: err = launch<8>(p.variant, cfg, a); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// `steps` empty steps of the one-block variant on one block (the floor of
// its chain; chip_smoke.py times it): scratch [1024] int32 zeros, sink [1].
extern "C" int frave_step_floor_loop(int steps, const void* scratch, void* sink,
                                     void* cuda_stream) {
  if (steps < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(1, 1, 0, static_cast<cudaStream_t>(cuda_stream), &attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, step_floor_kernel, steps,
                                       static_cast<const int32_t*>(scratch),
                                       static_cast<int*>(sink));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
