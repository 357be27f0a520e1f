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
//   * 3T (frave_tp_decode_row), the grid path: from row t-1's gathered
//     renorm counts [n, C] it places the words of the rank's lanes that
//     row t-1 flagged (offset of channel c: the counts of every rank in
//     the channels before c, then of the ranks before s in c; within the
//     rank, the lane's rank among its flagged lanes), then decodes row t's
//     symbols on the rank's lanes with kernel 3's search (rans_common.cuh
//     decode_symbol) and writes the symbols, the renorm flags and the
//     rank's count a channel: the [C] int32 that the next collective
//     gathers, the only thing a row exchanges;
//   * DT (frave_tp_decode_step), the step-tensor path: it stores step
//     t-1's gathered values [C, NL] into the replicated planes (in
//     schedule order and by coefficient slot) and places the rank's renorm
//     words from step t-1's gathered flags [C, NL] (ranked over the flat
//     c * NL + n order of every rank's flags); then it decodes step t on
//     the rank's lanes: the six taps from the schedule-order plane, the
//     f32 context chain (rans_context.cuh), the fixed bucket, kernel 3's
//     search, and writes [2, C, NLl]: each lane's value and renorm flag,
//     what the next collective gathers.
// A launch with no row (3T) or no step (DT) only finishes the last one.
// The lane states stay in device memory between launches, each rank's
// own; the stream position goes in and out in separate buffers. Every
// stream index is clamped to [0, W - 1], and the tables to bits <= 14.
//
// Bound on this card: a launch moves well under a megabyte (the row's or
// step's lane states, flags and records, the tables, the gathered flags),
// so it is one short dependent chain, bound by latency, not bytes. The
// design spreads that chain over SMs and cuts what lies on it:
//   * a thread-block cluster of S blocks (S = 1: one block), the host's
//     plan choosing S from the rank's pairs (ops/tp_decode.py plan_rule:
//     one block up to 1024, else blocks of at most 1024 (3T) or 512 (DT),
//     S <= 16; the sweep's fastest): 3T one cluster a channel (grid
//     (S, C)), DT one cluster for the rank. Block k owns a contiguous range
//     of the rank's flat (channel, lane) pairs and thread t the pairs t,
//     t + 1024, ... of it, so neighbouring threads touch neighbouring
//     addresses; each thread's lane states stay in registers through the
//     launch; 32-bit index math;
//   * the word ranks by warp ballots and one scan of the warps' counts
//     (16-bit fields a round). 3T's block offset within the channel is the
//     count of row t-1's flags of the lanes before the block, which every
//     block reads itself (16-byte loads; no exchange before the words); its
//     row total goes to the cluster's first block through distributed
//     shared memory and one cluster barrier. DT's blocks each count a slice
//     of the flat order of every rank's flags below the cut points the
//     rank's words need (the start and end of its window in each channel)
//     and push those counts and their own pairs' total to every block of
//     the cluster: one cluster barrier, release/acquire, which also orders
//     step t-1's plane stores (spread over the blocks, through L2) before
//     step t's taps (read through L2);
//   * the tables: the padded u16 staircases that kernel 3's search reads
//     (table_bytes / cdf_slot), built once a decode on the device as an
//     image [C][table_bytes(CA)] (ops/tp_decode.py table_image); each block
//     copies its channels' images into shared memory with TMA bulk copies
//     completing on an mbarrier, issued first and waited for only before
//     the symbol search (a multicast copy from a cluster's first block into
//     every block, tried, hung on the card: PERF.md), or, in a cluster of
//     16 blocks, where that measured faster, by the block's threads;
//   * launch attributes set once a device (device_room).
// A split cluster barrier (arrive early, wait late) orders what must be:
// distributed shared memory written only into running blocks, and 3T's
// flags of row t-1 read before any block overwrites them with row t's.
//
// Switches (flags): kForceBlock one block (a channel, 3T), kNoTma the
// tables copied by the block's threads from the image (the host's plan
// sets it in a 16-block cluster: ops/tp_decode.py).

#include "rans_common.cuh"
#include "rans_context.cuh"

namespace {

enum : int { kForceBlock = 1, kNoTma = 2 };
enum : int { kRow = 0, kStep = 1 };
constexpr int kMaxPer = 4;       // pairs a thread
constexpr int kMaxChannels = 4;  // DT's channels (its cut counts live in registers)
constexpr int kPub = 2 + 2 * kMaxChannels;  // the counts a DT block publishes
constexpr uint32_t kPiece = 32768;  // bytes a bulk copy

struct RowArgs {
  int64_t* x;             // [C, NLl] the rank's lane states, in place
  uint8_t* need;          // [C, NLl] row t-1's renorm flags in, row t's out
  const int64_t* gptr_in; // [1] the stream position before row t-1's words
  int64_t* gptr_out;      // [1] after them
  const int32_t* counts;  // [n, C] row t-1's gathered renorm counts
  const int32_t* buckets; // [C, NLl] row t's contexts (null: no row t)
  const uint8_t* active;  // [NLl] row t's lane activity
  const int32_t* stream;  // [W]
  const unsigned char* image;  // [C][table_bytes(CA)] the table image
  int32_t* syms;          // [C, NLl]
  int32_t* cnt_out;       // [C]
  int channels, lanes, contexts, stream_len, rank, ranks, chunk, flags;
};

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
  const unsigned char* image;  // [C][table_bytes(CA)] the table image
  int32_t* plane;           // [C, n_slots] replicated, in place
  int32_t* splane;          // [C, K] replicated, in place (schedule order)
  const int32_t* gathered;  // [2, C, NL] step t-1's values and flags (null: none)
  int32_t* out;             // [2, C, NLl] step t's values and flags
  int prev, step;           // step t-1 and step t (-1: none)
  int channels, lanes, lane_lo, local, contexts, fine, stream_len, chunk, flags;
  int64_t n_slots, num_symbols;
};

__device__ __forceinline__ int32_t clamp_idx32(int64_t i, int len) {
  return static_cast<int32_t>(i < 0 ? 0 : (i >= len ? len - 1 : i));
}

// ---------------------------------------------------------------- tables

// `bytes` of the table image from `src` to the block's shared memory `dst`
// in bulk pieces, completing on `bar` (one thread; the waiters pass a
// __syncthreads after it, which publishes the barrier's init).
__device__ __forceinline__ void copy_tables(unsigned char* dst, const unsigned char* src,
                                            uint32_t bytes, uint64_t* bar) {
  mbar_init(bar, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  mbar_expect_tx(bar, bytes);
  for (uint32_t o = 0; o < bytes; o += kPiece)
    bulk_copy(dst + o, src + o, min(kPiece, bytes - o), bar);
}

// The block's threads copy the image (kNoTma; the caller's barrier
// publishes it).
__device__ __forceinline__ void load_image(unsigned char* dst, const unsigned char* src,
                                           uint32_t bytes) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (uint32_t i = threadIdx.x; i < bytes / 16; i += kThreads) d[i] = __ldg(s + i);
}

// Channel c's bits and staircases in a staged image of table_bytes(CA) a
// channel.
__device__ __forceinline__ const uint32_t* chan_bits(const unsigned char* img, int c,
                                                     int contexts) {
  return reinterpret_cast<const uint32_t*>(img + c * table_bytes(contexts));
}

__device__ __forceinline__ const uint16_t* chan_cdf(const unsigned char* img, int c,
                                                    int contexts) {
  return reinterpret_cast<const uint16_t*>(img + c * table_bytes(contexts) +
                                           align16(static_cast<size_t>(contexts) * 4));
}

// ---------------------------------------------------------------- ranks

// The block-exclusive rank of each of the thread's flagged pairs in the
// block's order (round v, thread t) and the block's total: ballots within
// the warp, one scan of the warps' counts packed in 16-bit fields. Holds a
// __syncthreads.
template <int P>
__device__ __forceinline__ int block_ranks(uint32_t flags, int lane, int warp,
                                           unsigned long long* s_w, int (&rk)[P]) {
  const uint32_t lt = (1u << lane) - 1u;
  unsigned long long wc = 0;
  int inw[P];
#pragma unroll
  for (int v = 0; v < P; ++v) {
    const uint32_t m = __ballot_sync(kFull, flags >> v & 1u);
    inw[v] = __popc(m & lt);
    wc |= static_cast<unsigned long long>(__popc(m)) << (16 * v);
  }
  if (lane == 0) s_w[warp] = wc;
  __syncthreads();
  unsigned long long s = s_w[lane];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long y = __shfl_up_sync(kFull, s, d);
    if (lane >= d) s += y;
  }
  const unsigned long long before = warp ? __shfl_sync(kFull, s, warp - 1) : 0ull;
  const unsigned long long tot = __shfl_sync(kFull, s, 31);
  int acc = 0;
#pragma unroll
  for (int v = 0; v < P; ++v) {
    rk[v] = acc + static_cast<int>((before >> (16 * v)) & 0xFFFFu) + inw[v];
    acc += static_cast<int>((tot >> (16 * v)) & 0xFFFFu);
  }
  return acc;
}

// This thread's share of the set bytes of flags [0, n) (0/1 bytes): 16
// bytes a load where p is 16-byte aligned.
__device__ __forceinline__ int count_flags(const uint8_t* p, int n) {
  int cnt = 0;
  int i0 = 0;
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    for (int i = threadIdx.x; i < n / 16; i += kThreads) {
      const uint4 w = q[i];
      cnt += __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
    }
    i0 = n / 16 * 16;
  }
  for (int i = i0 + threadIdx.x; i < n; i += kThreads) cnt += p[i] ? 1 : 0;
  return cnt;
}


// ---------------------------------------------------------------- 3T

// One row of the rank's lanes, one cluster of S = gridDim.x blocks a
// channel (blockIdx.y); block k owns the channel's lanes [k * chunk,
// (k + 1) * chunk), thread t the lanes t + v * kThreads of them, v < P.
template <int P>
__global__ void __launch_bounds__(kThreads, 1) tp_row_kernel(const RowArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long s_w[kWarps];
  __shared__ int s_before[kWarps];
  __shared__ int s_cnt[kWarps];
  __shared__ int s_slot[kMaxCluster];
  __shared__ __align__(8) uint64_t s_bar;
  const int S = gridDim.x;
  const int blk = blockIdx.x;
  const int c = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int NLl = a.lanes;
  const int lo = min(blk * a.chunk, NLl), hi = min(lo + a.chunk, NLl);
  const bool row = a.buckets != nullptr;
  const bool tma = row && !(a.flags & kNoTma);
  const uint32_t tb = static_cast<uint32_t>(table_bytes(a.contexts));
  if (tma && t == 0) copy_tables(smem, a.image + c * tb, tb, &s_bar);
  uint8_t* nc = a.need + c * NLl;
  int64_t* xc = a.x + c * NLl;

  // ---- row t-1's flags: those before the block's lanes, and its own
  const int before = count_flags(nc, lo);
  uint32_t xv[P];
  uint32_t fm = 0;
#pragma unroll
  for (int v = 0; v < P; ++v) {
    const int n = lo + t + v * kThreads;
    xv[v] = 0u;
    if (n < hi) {
      xv[v] = static_cast<uint32_t>(xc[n]);
      if (nc[n]) fm |= 1u << v;
    }
  }
  if (S > 1) cluster_arrive();  // row t-1's flags read
  if (row && !tma) load_image(smem, a.image + c * tb, tb);  // published by block_ranks' barrier
  // the channel's offset: every rank's counts in the channels before c,
  // then the ranks before this one in c
  int64_t base = *a.gptr_in, total = 0;
  for (int s = 0; s < a.ranks; ++s)
    for (int cc = 0; cc < a.channels; ++cc) {
      const int v = a.counts[s * a.channels + cc];
      total += v;
      if (cc < c || (cc == c && s < a.rank)) base += v;
    }
  const int wb = __reduce_add_sync(kFull, before);
  if (lane == 0) s_before[warp] = wb;
  int rk[P];
  block_ranks<P>(fm, lane, warp, s_w, rk);
  base += __reduce_add_sync(kFull, s_before[lane]);
#pragma unroll
  for (int v = 0; v < P; ++v)
    if (fm >> v & 1u) {
      const uint32_t w =
          static_cast<uint32_t>(a.stream[clamp_idx32(base + rk[v], a.stream_len)]) & 0xFFFFu;
      xv[v] = (xv[v] << 16) | w;
    }
  if (blk == 0 && c == 0 && t == 0) *a.gptr_out = *a.gptr_in + total;

  if (!row) {  // the last row's renorm alone
    if (S > 1) cluster_wait();
#pragma unroll
    for (int v = 0; v < P; ++v) {
      const int n = lo + t + v * kThreads;
      if (n < hi) {
        nc[n] = 0;
        xc[n] = static_cast<int64_t>(xv[v]);
      }
    }
    if (blk == 0 && t == 0) a.cnt_out[c] = 0;
    return;
  }

  // ---- row t: every lane's symbol, the active lanes' states
  const int32_t* bc = a.buckets + c * NLl;
  int ctx[P];
  bool act[P];
#pragma unroll
  for (int v = 0; v < P; ++v) {
    const int n = lo + t + v * kThreads;
    ctx[v] = n < hi ? min(max(bc[n], 0), a.contexts - 1) : 0;
    act[v] = n < hi && a.active[n] != 0;
  }
  if (tma) mbar_wait(&s_bar, 0);
  const uint32_t* s_bits = chan_bits(smem, 0, a.contexts);
  const uint16_t* s_cdf = chan_cdf(smem, 0, a.contexts);
  int32_t* sc = a.syms + c * NLl;
  uint32_t nm = 0;
#pragma unroll
  for (int v = 0; v < P; ++v) {
    const int n = lo + t + v * kThreads;
    if (n < hi) {
      uint32_t sym;
      const uint32_t x2 = decode_symbol(s_bits, s_cdf, ctx[v], xv[v], &sym);
      sc[n] = static_cast<int32_t>(sym);
      if (act[v]) {
        xv[v] = x2;
        if (x2 < kRansL) nm |= 1u << v;
      }
    }
  }
  int cnt = 0;
#pragma unroll
  for (int v = 0; v < P; ++v) cnt += __popc(__ballot_sync(kFull, nm >> v & 1u));
  if (lane == 0) s_cnt[warp] = cnt;
  // every block has read row t-1's flags: overwrite them
  if (S > 1) cluster_wait();
#pragma unroll
  for (int v = 0; v < P; ++v) {
    const int n = lo + t + v * kThreads;
    if (n < hi) {
      nc[n] = static_cast<uint8_t>(nm >> v & 1u);
      xc[n] = static_cast<int64_t>(xv[v]);
    }
  }
  __syncthreads();
  const int btot = __reduce_add_sync(kFull, s_cnt[lane]);
  if (S == 1) {
    if (t == 0) a.cnt_out[c] = btot;
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (t == 0) *cluster.map_shared_rank(s_slot + blk, 0) = btot;
  cluster_arrive();
  cluster_wait();
  if (blk == 0 && t == 0) {
    int sum = 0;
    for (int k = 0; k < S; ++k) sum += s_slot[k];
    a.cnt_out[c] = sum;
  }
}

// ---------------------------------------------------------------- DT

// One step of the rank's lanes, one cluster of S = gridDim.x blocks (S =
// 1: one block); block k owns the rank's flat pairs p = c * NLl + j in
// [k * chunk, (k + 1) * chunk), thread t the pairs t + v * kThreads of
// them, v < P.
template <int P>
__global__ void __launch_bounds__(kThreads, 1) tp_step_kernel(const StepArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long s_w[kWarps];
  __shared__ int s_cnt[kWarps][kPub];
  __shared__ int s_pub[kPub];
  __shared__ int s_slot[kMaxCluster][kPub];
  __shared__ int s_sum[kPub + 1 + kMaxChannels];
  __shared__ __align__(8) uint64_t s_bar;
  const int S = gridDim.x;
  const int blk = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int C = a.channels, NL = a.lanes, L = a.local;
  const int K = static_cast<int>(a.num_symbols), NS = static_cast<int>(a.n_slots);
  const int pairs = C * L;
  const int lo = min(blk * a.chunk, pairs), hi = min(lo + a.chunk, pairs);
  const bool dec = a.step >= 0;
  const bool tma = dec && !(a.flags & kNoTma);
  const uint32_t tb = static_cast<uint32_t>(C * table_bytes(a.contexts));
  if (tma && t == 0) copy_tables(smem, a.image, tb, &s_bar);
  if (S > 1) cluster_arrive();  // the blocks running
  if (dec && !tma) load_image(smem, a.image, tb);

  // ---- the thread's pairs: states, step t-1's flags, step t's records
  const int4 zero = make_int4(0, 0, 0, 0);
  const int4 m = dec ? __ldg(a.step_map + a.step) : zero;
  const int32_t* gneed = a.gathered + C * NL;  // [C, NL] flags (prev >= 0)
  uint32_t xv[P], fm = 0;
  int ch[P], kk[P];
  int4 r0[P], r1[P];
#pragma unroll
  for (int v = 0; v < P; ++v) {
    const int p = lo + t + v * kThreads;
    xv[v] = 0u;
    ch[v] = 0;
    kk[v] = -1;
    r0[v] = r1[v] = zero;
    if (p < hi) {
      const int c = p / L, j = p - c * L;
      ch[v] = c;
      xv[v] = static_cast<uint32_t>(a.x[p]);
      if (a.prev >= 0 && gneed[c * NL + a.lane_lo + j]) fm |= 1u << v;
      if (dec) {
        int d = a.lane_lo + j - m.y;
        if (d < 0) d += NL;
        if (d < m.z) {
          kk[v] = m.x + d;
          r0[v] = __ldg(a.rec + 2 * kk[v]);
          r1[v] = __ldg(a.rec + 2 * kk[v] + 1);
        }
      }
    }
  }

  int64_t g = *a.gptr_in;
  if (a.prev >= 0) {
    // ---- step t-1's values into the planes: this block's slice
    const int4 mp = __ldg(a.step_map + a.prev);
    const int items = C * mp.z;
    const int per_blk = (items + S - 1) / S;
    const int i1 = min((blk + 1) * per_blk, items);
    for (int i = blk * per_blk + t; i < i1; i += kThreads) {
      const int c = i / mp.z, o = i - c * mp.z;
      int n = mp.y + o;
      if (n >= NL) n -= NL;
      const int k = mp.x + o;
      const int v = a.gathered[c * NL + n];
      __stcg(a.splane + c * K + k, v);
      const int coef = __ldg(reinterpret_cast<const int*>(a.rec + 2 * k));
      if (coef >= 0 && coef < NS) __stcg(a.plane + c * NS + coef, v);
    }
    // ---- every rank's flags in this block's slice of the flat order,
    // below each cut the rank's words need: [1] all, [2 + c] before
    // channel c's window, [2 + C + c] before its end
    const int cnl = C * NL;
    const int fper = (cnl + S - 1) / S;
    const int f1 = min((blk + 1) * fper, cnl);
    int cnt[kPub];
#pragma unroll
    for (int f = 0; f < kPub; ++f) cnt[f] = 0;
    for (int i = blk * fper + t; i < f1; i += kThreads) {
      if (!gneed[i]) continue;
      ++cnt[1];
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c) {
        const int e = c * NL + a.lane_lo;
        cnt[2 + c] += c < C && i < e ? 1 : 0;
        cnt[2 + kMaxChannels + c] += c < C && i < e + L ? 1 : 0;
      }
    }
#pragma unroll
    for (int f = 1; f < kPub; ++f) {
      const int w = __reduce_add_sync(kFull, cnt[f]);
      if (lane == 0) s_cnt[warp][f] = w;
    }
    int rk[P];
    const int rtot = block_ranks<P>(fm, lane, warp, s_w, rk);
    if (warp == 0) {
#pragma unroll
      for (int f = 1; f < kPub; ++f) {
        const int w = __reduce_add_sync(kFull, s_cnt[lane][f]);
        if (lane == 0) s_pub[f] = w;
      }
      if (lane == 0) s_pub[0] = rtot;
    }
    __syncthreads();
    if (S > 1) {
      cluster_wait();
      cg::cluster_group cluster = cg::this_cluster();
      if (t < S * kPub)  // field t % kPub to block t / kPub
        *cluster.map_shared_rank(&s_slot[blk][t % kPub], t / kPub) = s_pub[t % kPub];
      cluster_arrive();  // also publishes the plane stores to the taps below
      cluster_wait();
    } else {
      if (t < kPub) s_slot[0][t] = s_pub[t];
      __syncthreads();
    }
    if (warp == 0) {
      int sum = 0, mine = 0;
      for (int k = 0; k < S; ++k) {
        const int v = lane < kPub ? s_slot[k][lane] : 0;
        sum += v;
        if (k < blk) mine += s_slot[k][0];
      }
      if (lane < kPub) s_sum[lane] = sum;
      if (lane == 31) s_sum[kPub] = mine;  // the rank's flagged pairs before the block
      __syncwarp();
      if (lane == 0) {
        int acc = 0;  // the rank's flagged pairs before channel c
        for (int c = 0; c < C; ++c) {
          s_sum[kPub + 1 + c] = acc;
          acc += s_sum[2 + kMaxChannels + c] - s_sum[2 + c];
        }
      }
    }
    __syncthreads();
    // ---- the rank's words of step t-1: pair (c, j) takes the word of
    // every flag before c * NL + lane_lo + j
#pragma unroll
    for (int v = 0; v < P; ++v)
      if (fm >> v & 1u) {
        const int c = ch[v];
        const int r = s_sum[2 + c] + s_sum[kPub] + rk[v] - s_sum[kPub + 1 + c];
        const uint32_t w =
            static_cast<uint32_t>(a.stream[clamp_idx32(g + r, a.stream_len)]) & 0xFFFFu;
        xv[v] = (xv[v] << 16) | w;
      }
    if (blk == 0 && t == 0) *a.gptr_out = g + s_sum[1];
  } else {
    if (S > 1) cluster_wait();
    if (blk == 0 && t == 0) *a.gptr_out = g;
    if (dec) __syncthreads();  // the image, or the armed barrier
  }

  if (dec) {
    // ---- step t on the rank's lanes; lanes outside the step write 0, 0
    int tv[P][kTaps];
#pragma unroll
    for (int v = 0; v < P; ++v) {
      const int32_t* sp = a.splane + ch[v] * K;
      const int tap[kTaps] = {r0[v].y, r0[v].z, r0[v].w, r1[v].x, r1[v].y, r1[v].z};
#pragma unroll
      for (int q = 0; q < kTaps; ++q)
        tv[v][q] = kk[v] < 0 || tap[q] < 0 || tap[q] >= K ? 0 : __ldcg(sp + tap[q]);
    }
    if (tma) mbar_wait(&s_bar, 0);
#pragma unroll
    for (int v = 0; v < P; ++v) {
      const int p = lo + t + v * kThreads;
      if (p >= hi) continue;
      int val = 0, flag = 0;
      if (kk[v] >= 0) {
        const int c = ch[v];
        const int meta = r1[v].w;
        const bool lf = (meta & 0xFF) != 0;
        const int grp =
            min(max(static_cast<int>(static_cast<int8_t>((meta >> 8) & 0xFF)), 0), a.fine - 1);
        const int fb = static_cast<int8_t>((meta >> 16) & 0xFF);
        const int prow = (c * a.fine + grp) * kTaps;
        int bucket, pred;
        lane_context(tv[v], lf, a.vparams + prow, a.wparams + prow, a.edges, a.contexts - 1,
                     &bucket, &pred);
        if (fb >= 0) bucket = fb;
        const int ctx = min(max(bucket, 0), a.contexts - 1);
        uint32_t sym;
        const uint32_t x2 = decode_symbol(chan_bits(smem, c, a.contexts),
                                          chan_cdf(smem, c, a.contexts), ctx, xv[v], &sym);
        xv[v] = x2;
        val = ((sym & 1u) ? -static_cast<int>((sym + 1u) >> 1) : static_cast<int>(sym >> 1)) +
              pred;
        flag = x2 < kRansL ? 1 : 0;
      }
      a.out[p] = val;
      a.out[pairs + p] = flag;
    }
  }
#pragma unroll
  for (int v = 0; v < P; ++v) {
    const int p = lo + t + v * kThreads;
    if (p < hi) a.x[p] = static_cast<int64_t>(xv[v]);
  }
}

// An empty launch of a variant's grid, cluster and shared memory (the
// floor of a launch-per-step design; chip_smoke.py times it).
__global__ void __launch_bounds__(kThreads, 1) tp_empty_kernel() {}

// ---------------------------------------------------------------- host

constexpr int kNumFns = 7;

const void* kernel_of(int kind, int per) {
  if (kind == kRow)
    switch (per) {
      case 1: return reinterpret_cast<const void*>(tp_row_kernel<1>);
      case 2: return reinterpret_cast<const void*>(tp_row_kernel<2>);
      default: return reinterpret_cast<const void*>(tp_row_kernel<4>);
    }
  switch (per) {
    case 1: return reinterpret_cast<const void*>(tp_step_kernel<1>);
    case 2: return reinterpret_cast<const void*>(tp_step_kernel<2>);
    default: return reinterpret_cast<const void*>(tp_step_kernel<4>);
  }
}

// The shared-memory room of every kernel here, their attributes set once a
// device.
cudaError_t room(size_t* r) {
  const void* fns[kNumFns] = {
      kernel_of(kRow, 1), kernel_of(kRow, 2), kernel_of(kRow, 4),
      kernel_of(kStep, 1), kernel_of(kStep, 2), kernel_of(kStep, 4),
      reinterpret_cast<const void*>(tp_empty_kernel)};
  return device_room(fns, kNumFns, r);
}

bool per_ok(int per) { return per == 1 || per == 2 || per == 4; }

template <typename A>
cudaError_t launch_tp(int kind, int per, const cudaLaunchConfig_t& cfg, A a) {
  void* args[] = {&a};
  return cudaLaunchKernelExC(&cfg, kernel_of(kind, per), args);
}

}  // namespace

// Whether `cluster` blocks of the 3T (kind 0) or DT (kind 1) kernel at
// `per` pairs a thread with `dyn` bytes of dynamic shared memory can be
// resident at once (*fits 1 or 0); sets the kernels' attributes first.
extern "C" int frave_tp_fits(int kind, int per, int cluster, long long dyn, int* fits) {
  if ((kind != kRow && kind != kStep) || !per_ok(per) || cluster < 1 || cluster > kMaxCluster ||
      dyn < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t r = 0;
  cudaError_t err = room(&r);
  if (err != cudaSuccess) return static_cast<int>(err);
  bool ok = static_cast<size_t>(dyn) <= r;
  if (ok) err = cluster_fits(kernel_of(kind, per), cluster, static_cast<size_t>(dyn), &ok);
  *fits = ok ? 1 : 0;
  return static_cast<int>(err);
}

// One row of the rank's lanes (3T): row t-1's renorm from its gathered
// counts, then row t's symbols (buckets null: the renorm alone). x
// [channels, lanes] int64 and need [channels, lanes] uint8 in place,
// gptr_in / gptr_out [1] int64, counts [ranks, channels] int32, buckets
// [channels, lanes] int32, active [lanes] uint8, stream [stream_len]
// int32, image [channels][table_bytes(contexts)] (16-byte aligned), syms
// [channels, lanes] int32 and cnt_out [channels] int32 out. One cluster of
// `cluster` blocks a channel at `per` lanes a thread (the plan's;
// kForceBlock is cluster 1).
extern "C" int frave_tp_decode_row(void* x, void* need, const void* gptr_in, void* gptr_out,
                                   const void* counts, const void* buckets, const void* active,
                                   const void* stream, const void* image, void* syms,
                                   void* cnt_out, int channels, int lanes, int contexts,
                                   int stream_len, int rank, int ranks, int cluster, int per,
                                   int flags, void* cuda_stream) {
  if (channels < 1 || channels > 65535 || lanes < 1 || contexts < 1 || contexts > 64 ||
      stream_len < 1 || ranks < 1 || rank < 0 || rank >= ranks ||
      static_cast<int64_t>(channels) * lanes >= (int64_t{1} << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t r = 0;
  cudaError_t err = room(&r);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t dyn = table_bytes(contexts);
  if (dyn > r) return static_cast<int>(cudaErrorInvalidValue);
  RowArgs a;
  a.x = static_cast<int64_t*>(x);
  a.need = static_cast<uint8_t*>(need);
  a.gptr_in = static_cast<const int64_t*>(gptr_in);
  a.gptr_out = static_cast<int64_t*>(gptr_out);
  a.counts = static_cast<const int32_t*>(counts);
  a.buckets = static_cast<const int32_t*>(buckets);
  a.active = static_cast<const uint8_t*>(active);
  a.stream = static_cast<const int32_t*>(stream);
  a.image = static_cast<const unsigned char*>(image);
  a.syms = static_cast<int32_t*>(syms);
  a.cnt_out = static_cast<int32_t*>(cnt_out);
  a.channels = channels;
  a.lanes = lanes;
  a.contexts = contexts;
  a.stream_len = stream_len;
  a.rank = rank;
  a.ranks = ranks;
  a.flags = flags;
  const cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  a.chunk = (lanes + cluster - 1) / cluster;
  if (!per_ok(per) || cluster < 1 || cluster > kMaxCluster || a.chunk > per * kThreads ||
      ((flags & kForceBlock) && cluster != 1) ||
      (buckets != nullptr && (flags & kNoTma) == 0 && (reinterpret_cast<uintptr_t>(image) & 15)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(cluster, channels, dyn, st, &attr);
  err = launch_tp(kRow, per, cfg, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// One step of the rank's lanes (DT): step `prev`'s gathered values and
// flags into the planes and the rank's renorm (prev -1: none), then step
// `step` on the rank's lanes (-1: none). x [channels, local] int64 in
// place, gptr_in / gptr_out [1] int64, step_map [steps, 4] and rec
// [num_symbols, 8] int32 (16-byte aligned), vparams / wparams [channels,
// fine, 6] f32, edges [contexts - 1] f32, stream [stream_len] int32, image
// as 3T's for every channel, plane [channels, n_slots] and
// splane [channels, num_symbols] int32 in place, gathered [2, channels,
// lanes] int32, out [2, channels, local] int32; the rank's lanes are
// [lane_lo, lane_lo + local). One cluster of `cluster` blocks at `per`
// pairs a thread (the plan's; kForceBlock is cluster 1).
extern "C" int frave_tp_decode_step(
    void* x, const void* gptr_in, void* gptr_out, const void* step_map, const void* rec,
    const void* vparams, const void* wparams, const void* edges, const void* stream,
    const void* image, void* plane, void* splane,
    const void* gathered, void* out, int prev, int step, int steps, int channels, int lanes,
    int lane_lo, int local, int contexts, int fine, int stream_len, long long n_slots,
    long long num_symbols, int cluster, int per, int flags, void* cuda_stream) {
  if (channels < 1 || lanes < 1 || local < 1 || lane_lo < 0 || lane_lo + local > lanes ||
      contexts < 1 || channels * contexts > 64 || fine < 1 || stream_len < 1 || n_slots < 1 ||
      num_symbols < 1 || prev >= steps || step >= steps || (prev >= 0 && gathered == nullptr) ||
      (reinterpret_cast<uintptr_t>(rec) & 15) != 0 ||
      static_cast<int64_t>(channels) * lanes >= (int64_t{1} << 24) ||
      channels * n_slots >= (1LL << 31) || channels * num_symbols >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t r = 0;
  cudaError_t err = room(&r);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t dyn = channels * table_bytes(contexts);  // the staged image
  if (dyn > r) return static_cast<int>(cudaErrorInvalidValue);
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
  a.image = static_cast<const unsigned char*>(image);
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
  a.flags = flags;
  a.n_slots = n_slots;
  a.num_symbols = num_symbols;
  const cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  a.chunk = (channels * local + cluster - 1) / cluster;
  if (channels > kMaxChannels || !per_ok(per) || cluster < 1 || cluster > kMaxCluster ||
      a.chunk > per * kThreads || ((flags & kForceBlock) && cluster != 1) ||
      (step >= 0 && (flags & kNoTma) == 0 && (reinterpret_cast<uintptr_t>(image) & 15)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(cluster, 1, dyn, st, &attr);
  err = launch_tp(kStep, per, cfg, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// An empty launch of grid (cluster, blocks_y), cluster `cluster` and `dyn`
// bytes of dynamic shared memory (a variant's launch floor).
extern "C" int frave_tp_empty(int cluster, int blocks_y, long long dyn, void* cuda_stream) {
  if (cluster < 1 || cluster > kMaxCluster || blocks_y < 1 || blocks_y > 65535 || dyn < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t r = 0;
  cudaError_t err = room(&r);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<size_t>(dyn) > r) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(cluster, blocks_y, static_cast<size_t>(dyn),
                                               static_cast<cudaStream_t>(cuda_stream), &attr);
  err = cudaLaunchKernelEx(&cfg, tp_empty_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
