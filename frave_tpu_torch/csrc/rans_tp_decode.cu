// The tp-sharded rANS decode steps for Hopper (sm_90a), plain C interface:
// kernels 3T and DT.
//
// Replace the lax.scan bodies of frave_tpu/parallel/sharded.py
// TPShardedDecoder: _build_grid's (:926-963, scanned at :965) and _build's
// (:1203-1280, scanned at :1282). One image's lanes are split over the n
// ranks of a world, rank s owning the contiguous lanes [s * NLl, (s + 1) *
// NLl). A decode row or step ranks its renorm words channel-major,
// lane-minor over all NL lanes (schedule.build_stream_perm), so a rank can
// place its words only once it knows what the other ranks' lanes need: a
// collective between two steps, which no kernel can hold. So each kernel
// takes ONE row or step a launch, and finishes the previous one's renorm
// from what the collective gathered before it decodes its own:
//
//   * 3T (frave_tp_decode_row), the grid path: grid (C), one block a
//     channel. From row t-1's gathered renorm counts [n, C] it places the
//     words of the rank's lanes that row t-1 flagged (offset of channel c:
//     the counts of every rank in the channels before c, then of the ranks
//     before s in c; within the rank, a block scan in lane order), then
//     decodes row t's symbols on the rank's lanes with kernel 3's search
//     (rans_common.cuh decode_symbol) and writes the symbols, the renorm
//     flags and the rank's count a channel: the [C] int32 that the next
//     collective gathers, the only thing a row exchanges;
//   * DT (frave_tp_decode_step), the step-tensor path: one block. It
//     stores step t-1's gathered values [C, NL] into the replicated planes
//     (in schedule order and by coefficient slot) and places the rank's
//     renorm words from step t-1's gathered flags [C, NL] (a block scan
//     over the flat rank order); after one block barrier it decodes step t
//     on the rank's lanes: the six taps from the schedule-order plane, the
//     f32 context chain (rans_context.cuh), the fixed bucket, kernel 3's
//     search, and writes [2, C, NLl]: each lane's value and renorm flag,
//     what the next collective gathers.
// A launch with no row (3T) or no step (DT) only finishes the last one.
// The lane states stay in device memory between launches, each rank's
// own; the stream position goes in and out in separate buffers. Every
// stream index is clamped to [0, W - 1], and the tables to bits <= 14.
//
// Bound on this card: device memory, per launch. 3T reads the channel's
// tables (C x 15 x 1024 int32), the row's buckets and states and writes
// the symbols and states; DT the image's tables, the step's records and
// gathered values and flags. Each launch is one short dependent chain,
// latency-bound: a simple, correct kernel first (PERF.md has its times).

#include "rans_common.cuh"
#include "rans_context.cuh"

namespace {

struct RowArgs {
  int64_t* x;             // [C, NLl] the rank's lane states, in place
  uint8_t* need;          // [C, NLl] row t-1's renorm flags in, row t's out
  const int64_t* gptr_in; // [1] the stream position before row t-1's words
  int64_t* gptr_out;      // [1] after them
  const int32_t* counts;  // [n, C] row t-1's gathered renorm counts
  const int32_t* buckets; // [C, NLl] row t's contexts (null: no row t)
  const uint8_t* active;  // [NLl] row t's lane activity
  const int32_t* stream;  // [W]
  const int32_t* cdf;     // [C, CA, 1024]
  const int32_t* bits;    // [C, CA]
  int32_t* syms;          // [C, NLl]
  int32_t* cnt_out;       // [C]
  int channels, lanes, contexts, stream_len, rank, ranks;
};

__device__ __forceinline__ int64_t clamp_idx(int64_t i, int64_t len) {
  return i < 0 ? 0 : (i >= len ? len - 1 : i);
}

__global__ void __launch_bounds__(kThreads) tp_row_kernel(const RowArgs a) {
  extern __shared__ uint4 smem[];
  __shared__ int s_warp[2][kWarps];
  const int c = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(smem);
  uint16_t* s_cdf = reinterpret_cast<uint16_t*>(reinterpret_cast<unsigned char*>(smem) +
                                                align16(static_cast<size_t>(a.contexts) * 4));
  if (a.buckets != nullptr)
    load_tables(a.cdf + static_cast<int64_t>(c) * a.contexts * kAlphabet,
                a.bits + static_cast<int64_t>(c) * a.contexts, a.contexts, s_bits, s_cdf);
  // thread t owns lanes [t * per, min((t + 1) * per, NLl))
  const int per = (a.lanes + kThreads - 1) / kThreads;
  const int n0 = min(t * per, a.lanes), n1 = min(n0 + per, a.lanes);
  int64_t* xc = a.x + static_cast<int64_t>(c) * a.lanes;
  uint8_t* nc = a.need + static_cast<int64_t>(c) * a.lanes;

  // ---- row t-1's renorm: the channel's offset from the gathered counts
  int64_t base = a.gptr_in[0];
  int64_t total = 0;
  for (int s = 0; s < a.ranks; ++s)
    for (int cc = 0; cc < a.channels; ++cc) {
      const int v = a.counts[s * a.channels + cc];
      total += v;
      if (cc < c || (cc == c && s < a.rank)) base += v;
    }
  if (c == 0 && t == 0) a.gptr_out[0] = a.gptr_in[0] + total;
  int cnt = 0;
  for (int n = n0; n < n1; ++n) cnt += nc[n] ? 1 : 0;
  int btot;
  int64_t rank = base + block_scan(s_warp, 0, cnt, warp_incl_scan(cnt, lane), lane, warp, &btot);
  for (int n = n0; n < n1; ++n) {
    if (!nc[n]) continue;
    const uint32_t w = static_cast<uint32_t>(a.stream[clamp_idx(rank++, a.stream_len)]) & 0xFFFFu;
    xc[n] = static_cast<int64_t>((static_cast<uint32_t>(xc[n]) << 16) | w);
  }
  if (a.buckets == nullptr) {
    for (int n = n0; n < n1; ++n) nc[n] = 0;
    if (t == 0) a.cnt_out[c] = 0;
    return;
  }
  __syncthreads();  // the tables

  // ---- row t: the symbols of the rank's lanes (every lane's, as kernel
  // 3 computes them), the states of the active ones
  const int32_t* bc = a.buckets + static_cast<int64_t>(c) * a.lanes;
  int32_t* sc = a.syms + static_cast<int64_t>(c) * a.lanes;
  cnt = 0;
  for (int n = n0; n < n1; ++n) {
    const int ctx = min(max(bc[n], 0), a.contexts - 1);
    uint32_t sym;
    const uint32_t x2 = decode_symbol(s_bits, s_cdf, ctx, static_cast<uint32_t>(xc[n]), &sym);
    sc[n] = static_cast<int32_t>(sym);
    const bool act = a.active[n] != 0;
    const bool nd = act && x2 < kRansL;
    if (act) xc[n] = static_cast<int64_t>(x2);
    nc[n] = nd ? 1 : 0;
    cnt += nd ? 1 : 0;
  }
  const int incl = warp_incl_scan(cnt, lane);
  block_scan(s_warp, 1, cnt, incl, lane, warp, &btot);
  if (t == 0) a.cnt_out[c] = btot;
}

struct StepArgs {
  int64_t* x;               // [C, NLl] the rank's lane states, in place
  const int64_t* gptr_in;   // [1] before step t-1's words
  int64_t* gptr_out;        // [1] after them
  const int4* step_map;     // [S] (k0, lane0, len, wrapped)
  const int4* rec;          // [K][2] records
  const float* vparams;     // [C, F, 6]
  const float* wparams;     // [C, F, 6]
  const float* edges;       // [CA - 1]
  const int32_t* stream;    // [W]
  const int32_t* cdf;       // [C, CA, 1024]
  const int32_t* bits;      // [C, CA]
  int32_t* plane;           // [C, n_slots] replicated, in place
  int32_t* splane;          // [C, K] replicated, in place (schedule order)
  const int32_t* gathered;  // [2, C, NL] step t-1's values and flags (null: none)
  int32_t* out;             // [2, C, NLl] step t's values and flags
  int prev, step;           // step t-1 and step t (-1: none)
  int channels, lanes, lane_lo, local, contexts, fine, stream_len;
  int64_t n_slots, num_symbols;
};

__global__ void __launch_bounds__(kThreads) tp_step_kernel(const StepArgs a) {
  extern __shared__ uint4 smem[];
  __shared__ int s_warp[2][kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nctx = a.channels * a.contexts;
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(smem);
  uint16_t* s_cdf = reinterpret_cast<uint16_t*>(reinterpret_cast<unsigned char*>(smem) +
                                                align16(static_cast<size_t>(nctx) * 4));
  if (a.step >= 0) load_tables(a.cdf, a.bits, nctx, s_bits, s_cdf);
  const int64_t cnl = static_cast<int64_t>(a.channels) * a.lanes;

  if (a.prev >= 0) {
    // ---- step t-1's values into the replicated planes
    const int4 m = a.step_map[a.prev];
    for (int64_t i = t; i < static_cast<int64_t>(a.channels) * m.z; i += kThreads) {
      const int c = static_cast<int>(i / m.z), o = static_cast<int>(i % m.z);
      const int n = (m.y + o) % a.lanes;
      const int64_t k = static_cast<int64_t>(m.x) + o;
      const int v = a.gathered[c * static_cast<int64_t>(a.lanes) + n];
      if (k < a.num_symbols) {
        a.splane[c * a.num_symbols + k] = v;
        const int coef = a.rec[2 * k].x;
        if (coef >= 0 && coef < a.n_slots) a.plane[c * a.n_slots + coef] = v;
      }
    }
    // ---- the rank's words of step t-1: ranks over the flat c * NL + n
    // order of every rank's flags
    const int32_t* need = a.gathered + cnl;
    const int64_t per = (cnl + kThreads - 1) / kThreads;
    const int64_t i0 = min(static_cast<int64_t>(t) * per, cnl), i1 = min(i0 + per, cnl);
    int cnt = 0;
    for (int64_t i = i0; i < i1; ++i) cnt += need[i] ? 1 : 0;
    int btot;
    int64_t rank =
        a.gptr_in[0] + block_scan(s_warp, 0, cnt, warp_incl_scan(cnt, lane), lane, warp, &btot);
    if (t == 0) a.gptr_out[0] = a.gptr_in[0] + btot;
    for (int64_t i = i0; i < i1; ++i) {
      if (!need[i]) continue;
      const int64_t r = rank++;
      const int c = static_cast<int>(i / a.lanes), n = static_cast<int>(i % a.lanes);
      if (n < a.lane_lo || n >= a.lane_lo + a.local) continue;
      int64_t* xp = a.x + static_cast<int64_t>(c) * a.local + (n - a.lane_lo);
      const uint32_t w = static_cast<uint32_t>(a.stream[clamp_idx(r, a.stream_len)]) & 0xFFFFu;
      *xp = static_cast<int64_t>((static_cast<uint32_t>(*xp) << 16) | w);
    }
  } else if (t == 0) {
    a.gptr_out[0] = a.gptr_in[0];
  }
  if (a.step < 0) return;
  __syncthreads();  // the plane stores and the tables

  // ---- step t on the rank's lanes; lanes outside the step write 0, 0
  const int4 m = a.step_map[a.step];
  const int64_t pairs = static_cast<int64_t>(a.channels) * a.local;
  int32_t* vals = a.out;
  int32_t* flags = a.out + pairs;
  for (int64_t i = t; i < pairs; i += kThreads) {
    const int c = static_cast<int>(i / a.local), j = static_cast<int>(i % a.local);
    const int o = ((a.lane_lo + j - m.y) % a.lanes + a.lanes) % a.lanes;
    if (o >= m.z) {
      vals[i] = 0;
      flags[i] = 0;
      continue;
    }
    const int64_t k = static_cast<int64_t>(m.x) + o;
    const int4 r0 = a.rec[2 * k], r1 = a.rec[2 * k + 1];
    const int tap[kTaps] = {r0.y, r0.z, r0.w, r1.x, r1.y, r1.z};
    const int32_t* sp = a.splane + c * a.num_symbols;
    int tv[kTaps];
#pragma unroll
    for (int q = 0; q < kTaps; ++q)
      tv[q] = tap[q] < 0 || tap[q] >= a.num_symbols ? 0 : sp[tap[q]];
    const int meta = r1.w;
    const bool lf = (meta & 0xFF) != 0;
    const int grp =
        min(max(static_cast<int>(static_cast<int8_t>((meta >> 8) & 0xFF)), 0), a.fine - 1);
    const int fb = static_cast<int8_t>((meta >> 16) & 0xFF);
    const int prow = (c * a.fine + grp) * kTaps;
    int bucket, pred;
    lane_context(tv, lf, a.vparams + prow, a.wparams + prow, a.edges, a.contexts - 1, &bucket,
                 &pred);
    if (fb >= 0) bucket = fb;
    const int ctx = c * a.contexts + min(max(bucket, 0), a.contexts - 1);
    int64_t* xp = a.x + i;
    uint32_t sym;
    const uint32_t x2 = decode_symbol(s_bits, s_cdf, ctx, static_cast<uint32_t>(*xp), &sym);
    *xp = static_cast<int64_t>(x2);
    vals[i] = ((sym & 1u) ? -static_cast<int>((sym + 1u) >> 1) : static_cast<int>(sym >> 1)) +
              pred;
    flags[i] = x2 < kRansL ? 1 : 0;
  }
}

// The dynamic shared memory of a launch: the tables of `nctx` contexts.
template <typename K>
cudaError_t room_for(K kernel, size_t dyn) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(dyn));
}

}  // namespace

// One row of the rank's lanes (3T): row t-1's renorm from its gathered
// counts, then row t's symbols (buckets null: the renorm alone). x
// [channels, lanes] int64 and need [channels, lanes] uint8 in place,
// gptr_in / gptr_out [1] int64, counts [ranks, channels] int32, buckets
// [channels, lanes] int32, active [lanes] uint8, stream [stream_len]
// int32, cdf [channels, contexts, 1024] and bits [channels, contexts]
// int32, syms [channels, lanes] int32 and cnt_out [channels] int32 out.
extern "C" int frave_tp_decode_row(void* x, void* need, const void* gptr_in, void* gptr_out,
                                   const void* counts, const void* buckets, const void* active,
                                   const void* stream, const void* cdf, const void* bits,
                                   void* syms, void* cnt_out, int channels, int lanes,
                                   int contexts, int stream_len, int rank, int ranks,
                                   void* cuda_stream) {
  if (channels < 1 || channels > 65535 || lanes < 1 || contexts < 1 || contexts > 64 ||
      stream_len < 1 || ranks < 1 || rank < 0 || rank >= ranks)
    return static_cast<int>(cudaErrorInvalidValue);
  RowArgs a;
  a.x = static_cast<int64_t*>(x);
  a.need = static_cast<uint8_t*>(need);
  a.gptr_in = static_cast<const int64_t*>(gptr_in);
  a.gptr_out = static_cast<int64_t*>(gptr_out);
  a.counts = static_cast<const int32_t*>(counts);
  a.buckets = static_cast<const int32_t*>(buckets);
  a.active = static_cast<const uint8_t*>(active);
  a.stream = static_cast<const int32_t*>(stream);
  a.cdf = static_cast<const int32_t*>(cdf);
  a.bits = static_cast<const int32_t*>(bits);
  a.syms = static_cast<int32_t*>(syms);
  a.cnt_out = static_cast<int32_t*>(cnt_out);
  a.channels = channels;
  a.lanes = lanes;
  a.contexts = contexts;
  a.stream_len = stream_len;
  a.rank = rank;
  a.ranks = ranks;
  const size_t dyn = table_bytes(contexts);
  cudaError_t err = room_for(tp_row_kernel, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  tp_row_kernel<<<channels, kThreads, dyn, static_cast<cudaStream_t>(cuda_stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// One step of the rank's lanes (DT): step `prev`'s gathered values and
// flags into the planes and the rank's renorm (prev -1: none), then step
// `step` on the rank's lanes (-1: none). x [channels, local] int64 in
// place, gptr_in / gptr_out [1] int64, step_map [steps, 4] and rec
// [num_symbols, 8] int32 (16-byte aligned), vparams / wparams [channels,
// fine, 6] f32, edges [contexts - 1] f32, stream [stream_len] int32, cdf /
// bits as 3T's for every channel, plane [channels, n_slots] and splane
// [channels, num_symbols] int32 in place, gathered [2, channels, lanes]
// int32, out [2, channels, local] int32; the rank's lanes are [lane_lo,
// lane_lo + local).
extern "C" int frave_tp_decode_step(
    void* x, const void* gptr_in, void* gptr_out, const void* step_map, const void* rec,
    const void* vparams, const void* wparams, const void* edges, const void* stream,
    const void* cdf, const void* bits, void* plane, void* splane, const void* gathered,
    void* out, int prev, int step, int steps, int channels, int lanes, int lane_lo, int local,
    int contexts, int fine, int stream_len, long long n_slots, long long num_symbols,
    void* cuda_stream) {
  if (channels < 1 || lanes < 1 || local < 1 || lane_lo < 0 || lane_lo + local > lanes ||
      contexts < 1 || channels * contexts > 64 || fine < 1 || stream_len < 1 || n_slots < 1 ||
      num_symbols < 1 || prev >= steps || step >= steps || (prev >= 0 && gathered == nullptr) ||
      (reinterpret_cast<uintptr_t>(rec) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  StepArgs a;
  a.x = static_cast<int64_t*>(x);
  a.gptr_in = static_cast<const int64_t*>(gptr_in);
  a.gptr_out = static_cast<int64_t*>(gptr_out);
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
  a.gathered = static_cast<const int32_t*>(gathered);
  a.out = static_cast<int32_t*>(out);
  a.prev = prev;
  a.step = step;
  a.channels = channels;
  a.lanes = lanes;
  a.lane_lo = lane_lo;
  a.local = local;
  a.contexts = contexts;
  a.fine = fine;
  a.stream_len = stream_len;
  a.n_slots = n_slots;
  a.num_symbols = num_symbols;
  const size_t dyn = table_bytes(channels * contexts);
  cudaError_t err = room_for(tp_step_kernel, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  tp_step_kernel<<<1, kThreads, dyn, static_cast<cudaStream_t>(cuda_stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
