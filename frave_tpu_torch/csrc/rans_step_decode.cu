// Step-tensor rANS decode for Hopper (sm_90a) over one thread-block
// cluster per image, plain C interface: kernel D.
//
// Replaces the lax.scan body of frave_tpu/codec/pipeline_jax.py
// decode_fused (:820-868, with ops/rans_jax.py decode_step_merged): every
// wavefront step of a decode in one launch. The decode of the parallel and
// parity modes, and of grid-mode shapes too small for a dense lattice,
// runs over static step tensors [S, NL] (fractal/schedule.py LaneSteps);
// per step and lane, for every image and channel:
//   1. gather the 6 taps from the image's [C, n_slots] int32 coefficient
//      plane (tap -1, or a slot out of range, reads 0);
//   2. contexts (ops/torch_ops.py contexts): an LF lane takes the MED
//      prediction and bucket(|v0 - v2|); an HF lane the width
//      wp0 + wp1*g1 + ... + wp5*g5 and the prediction v0*vp0 + ... +
//      v5*vp5, each product and sum rounded to f32 on its own, left to
//      right (__fmul_rn / __fadd_rn, so nothing contracts into an FMA);
//      the width is 0 where g1 + ... + g5 == 0, the bucket the count of
//      f32 edges <= width (NaN and negative widths: 0), the prediction
//      truncated after a clamp to +-1e9 (NaN: 0);
//   3. a fixed bucket (fbkt >= 0) replaces the computed one; the
//      prediction is clamped to +-255;
//   4. kernel 3's symbol and renorm step (rans_common.cuh), the words
//      ranked channel-major, lane-minor within the image, every stream
//      index clamped;
//   5. on active lanes (step_coef >= 0) only, the state advances and
//      unpack_signed(sym) + prediction is stored at step_coef.
//
// Ordering. Step s + 1 reads plane slots that other blocks of the cluster
// wrote in step s. Each step stores its values before the step's rank
// exchange, whose cluster barrier is barrier.cluster.arrive.release /
// barrier.cluster.wait.acquire (one block: the block scan's
// __syncthreads), and the plane is read and written through L2 only
// (ld.global.cg / st.global.cg), so no block reads a stale L1 line. A
// step never reads a slot that the same step writes (the schedule's taps
// lie in earlier waves; CodecProgram.from_host checks it), so one barrier
// a step is enough. Only an image's own cluster touches its plane.
//
// Bound on this card. Bytes: the step tensors (4 + 24 + 3 bytes a lane a
// step, shared by the channels and images), the taps (6 x 4 bytes an
// active lane and channel), the plane stores, the stream words consumed
// and the tables. Dependencies: every step is one cross-block exchange
// after the previous step's plane stores, so a decode of S steps costs at
// least S exchanges one after another (chip_smoke.py prints that floor).
//
// Design: kernel 3's (one cluster of S = 1..16 blocks of 1024 threads an
// image, grid (S, B), block k owning a contiguous range of the flat rank
// index i = c * NL + n, thread t lanes Pt .. Pt + P - 1, P = 1, 2, 4 or 8
// the fewest that cover the block's range, the lane states in registers
// for the whole decode) and its launch rule (the smallest S with at most
// 2048 lanes a block, capped at 16 and lowered while the blocks cannot be
// resident at once). Each block also holds the image's predictor rows
// [C, F, 6] and the bucket edges in shared memory. A thread first loads
// the step tensors and the taps of all its lanes, then computes them, so
// the P lanes' loads are in flight together. There is no several-tile
// variant: C * NL is at most 16 * 8192 lanes.

#include "rans_common.cuh"

namespace {

constexpr int kTaps = 6;
constexpr int kPredClamp = 255;
constexpr int kChunkAlign = 8;  // lanes a block owns: a multiple of this

struct StepArgs {
  const int64_t* x_in;     // [B, C, NL]
  const int64_t* gptr_in;  // [B]
  const int32_t* coef;     // [S, NL] (shared by the batch)
  const int32_t* nbr;      // [S, NL, 6]
  const uint8_t* lf;       // [S, NL]
  const int8_t* grp;       // [S, NL]
  const int8_t* fbkt;      // [S, NL]
  const float* vparams;    // [B, C, F, 6]
  const float* wparams;    // [B, C, F, 6]
  const float* edges;      // [contexts - 1]
  const int32_t* stream;   // [B, W]
  const int32_t* cdf;      // [B, C, CA, 1024]
  const int32_t* bits;     // [B, C, CA]
  int32_t* plane;          // [B, C, n_slots], zeroed by the caller
  int64_t* x_out;          // [B, C, NL]
  int64_t* gptr_out;       // [B]
  int steps, channels, lanes, contexts, fine, stream_len;
  int64_t n_slots;
  int64_t chunk;  // lanes a block owns
};

// The operands of image `img`; the step tensors and edges are shared.
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
  o.x_out += img * cnl;
  o.gptr_out += img;
  return o;
}

// Dynamic shared memory: the tables, vparams and wparams [C, F, 6] f32,
// the edges.
__host__ __device__ constexpr size_t params_bytes(int channels, int fine) {
  return align16(static_cast<size_t>(channels) * fine * kTaps * 4);
}

__host__ __device__ constexpr size_t dyn_bytes(int channels, int contexts, int fine) {
  return table_bytes(channels * contexts) + 2 * params_bytes(channels, fine) +
         align16(static_cast<size_t>(contexts) * 4);
}

// The count of edges <= w (NaN and negative widths: 0).
__device__ __forceinline__ int bucket_of(float w, const float* s_edges, int nedges) {
  if (isnan(w)) w = 0.0f;
  w = fmaxf(w, 0.0f);
  int b = 0;
  for (int e = 0; e < nedges; ++e) b += w >= s_edges[e] ? 1 : 0;
  return b;
}

// Context bucket and clamped prediction of one lane (torch_ops.contexts).
__device__ __forceinline__ void lane_context(const int (&v)[kTaps], bool lf, const float* vp,
                                             const float* wp, const float* s_edges, int nedges,
                                             int* bucket, int* pred) {
  int p;
  if (lf) {
    const int mx = max(v[0], v[2]);
    const int mn = min(v[0], v[2]);
    p = v[1] >= mx ? mx : (v[1] <= mn ? mn : v[0] + v[2] - v[1]);
    *bucket = bucket_of(static_cast<float>(abs(v[0] - v[2])), s_edges, nedges);
  } else {
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
    *bucket = bucket_of(w, s_edges, nedges);
    float pf = __fmul_rn(f[0], vp[0]);
#pragma unroll
    for (int k = 1; k < kTaps; ++k) pf = __fadd_rn(pf, __fmul_rn(f[k], vp[k]));
    if (isnan(pf)) pf = 0.0f;
    pf = fminf(fmaxf(pf, -1e9f), 1e9f);
    p = __float2int_rz(pf);
  }
  *pred = min(max(p, -kPredClamp), kPredClamp);
}

template <int P>
__global__ void __launch_bounds__(kThreads, 1) rans_decode_steps_kernel(const StepArgs batch) {
  const StepArgs a = image_args(batch, blockIdx.y);  // this cluster's image
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp[2][kWarps];
  __shared__ int s_tot[2];
  const int nctx = a.channels * a.contexts;
  const int npar = a.channels * a.fine * kTaps;
  const int nedges = a.contexts - 1;
  const size_t tab = table_bytes(nctx);
  const size_t pb = params_bytes(a.channels, a.fine);
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(smem);
  uint16_t* s_cdf = reinterpret_cast<uint16_t*>(smem + align16(static_cast<size_t>(nctx) * 4));
  float* s_vp = reinterpret_cast<float*>(smem + tab);
  float* s_wp = reinterpret_cast<float*>(smem + tab + pb);
  float* s_edges = reinterpret_cast<float*>(smem + tab + 2 * pb);
  load_tables(a.cdf, a.bits, nctx, s_bits, s_cdf);
  for (int k = threadIdx.x; k < npar; k += kThreads) {
    s_vp[k] = a.vparams[k];
    s_wp[k] = a.wparams[k];
  }
  for (int k = threadIdx.x; k < nedges; k += kThreads) s_edges[k] = a.edges[k];

  const int64_t cnl = static_cast<int64_t>(a.channels) * a.lanes;
  const int blk = static_cast<int>(cg::this_cluster().block_rank());
  const int64_t lo = min64(cnl, blk * a.chunk);
  const int64_t hi = min64(cnl, lo + a.chunk);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
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
  const int c0 = static_cast<int>(i0 / a.lanes);
  const int n0 = static_cast<int>(i0 - static_cast<int64_t>(c0) * a.lanes);
  __syncthreads();  // the tables and parameters

  for (int s = 0; s < a.steps; ++s) {
    const int par = s & 1;
    uint32_t need_m = 0;
    if (live) {
      // the step tensors and taps of all P lanes first, so that their
      // loads are in flight together
      int cf[P], tv[P][kTaps], grp[P], fb[P];
      bool lfv[P];
      int c = c0, n = n0;
#pragma unroll
      for (int v = 0; v < P; ++v) {
        cf[v] = -1;
        grp[v] = 0;
        fb[v] = -1;
        lfv[v] = false;
#pragma unroll
        for (int k = 0; k < kTaps; ++k) tv[v][k] = 0;
        if (live >> v & 1u) {
          const int64_t sn = static_cast<int64_t>(s) * a.lanes + n;
          const int32_t* pl = a.plane + static_cast<int64_t>(c) * a.n_slots;
          cf[v] = __ldg(a.coef + sn);
          lfv[v] = __ldg(a.lf + sn) != 0;
          grp[v] = min(max(static_cast<int>(__ldg(a.grp + sn)), 0), a.fine - 1);
          fb[v] = __ldg(a.fbkt + sn);
#pragma unroll
          for (int k = 0; k < kTaps; ++k) {
            const int nb = __ldg(a.nbr + sn * kTaps + k);
            if (nb >= 0 && nb < a.n_slots) tv[v][k] = __ldcg(pl + nb);
          }
        }
        if (++n == a.lanes) {
          n = 0;
          ++c;
        }
      }
      c = c0;
      n = n0;
#pragma unroll
      for (int v = 0; v < P; ++v) {
        if (live >> v & 1u) {
          const int prow = (c * a.fine + grp[v]) * kTaps;
          int bucket, pred;
          lane_context(tv[v], lfv[v], s_vp + prow, s_wp + prow, s_edges, nedges, &bucket, &pred);
          if (fb[v] >= 0) bucket = fb[v];
          const int ctx = c * a.contexts + min(max(bucket, 0), a.contexts - 1);
          uint32_t sym;
          const uint32_t x2 = decode_symbol(s_bits, s_cdf, ctx, xv[v], &sym);
          if (cf[v] >= 0) {
            xv[v] = x2;
            if (x2 < kRansL) need_m |= 1u << v;
            if (cf[v] < a.n_slots) {
              const int val = (sym & 1u) ? -static_cast<int>((sym + 1u) >> 1)
                                         : static_cast<int>(sym >> 1);
              __stcg(a.plane + static_cast<int64_t>(c) * a.n_slots + cf[v], val + pred);
            }
          }
        }
        if (++n == a.lanes) {
          n = 0;
          ++c;
        }
      }
    }
    const int cnt = __popc(need_m);
    const int incl = warp_incl_scan(cnt, lane);
    int btot = 0;
    const int local = block_scan(s_warp, par, cnt, incl, lane, warp, &btot);
    int64_t base = 0, rowtot = 0;
    exchange<true>(s_tot, par, btot, lane, &base, &rowtot);
    if (need_m) take_words<P>(a.stream, a.stream_len, g + base + local, need_m, xv);
    g += rowtot;
  }
#pragma unroll
  for (int v = 0; v < P; ++v)
    if (live >> v & 1u) a.x_out[i0 + v] = static_cast<int64_t>(xv[v]);
  // no block leaves while another may still read its s_tot
  if (cg::this_cluster().num_blocks() > 1) cg::this_cluster().sync();
  if (blk == 0 && t == 0) *a.gptr_out = g;
}

// The kernel variants by lanes a thread.
constexpr int kVariants[] = {1, 2, 4, 8};
constexpr int kNumVariants = 4;

const void* kernel_of(int per) {
  switch (per) {
    case 1: return reinterpret_cast<const void*>(rans_decode_steps_kernel<1>);
    case 2: return reinterpret_cast<const void*>(rans_decode_steps_kernel<2>);
    case 4: return reinterpret_cast<const void*>(rans_decode_steps_kernel<4>);
    default: return reinterpret_cast<const void*>(rans_decode_steps_kernel<8>);
  }
}

struct Plan {
  int cluster;
  int per;  // lanes a thread
  int64_t chunk;
  size_t dyn;  // dynamic shared memory of a block
};

// The launch plan: the cluster size (`want`, or the rule's at 0) and the
// lanes of a block and of a thread. With check_fit, the size is lowered
// (rule) or refused (`want`) while cudaOccupancyMaxActiveClusters says its
// blocks cannot be resident at once; without it, a size that cannot be
// resident is refused by the launch. More than 8192 lanes a block (C * NL
// past 16 * 8192) is refused.
cudaError_t make_plan(int channels, int lanes, int contexts, int fine, int want, bool check_fit,
                      Plan* p) {
  if (channels < 1 || lanes < 1 || contexts < 1 || fine < 1) return cudaErrorInvalidValue;
  const int64_t cnl = static_cast<int64_t>(channels) * lanes;
  if (cnl >= (int64_t{1} << 24)) return cudaErrorInvalidValue;  // ranks fit 24 bits
  if (want < 0 || want > kMaxCluster || (want & (want - 1)) != 0) return cudaErrorInvalidValue;
  const void* fns[kNumVariants];
  for (int k = 0; k < kNumVariants; ++k) fns[k] = kernel_of(kVariants[k]);
  size_t room = 0;
  cudaError_t err = device_room(fns, kNumVariants, &room);
  if (err != cudaSuccess) return err;
  const size_t dyn = dyn_bytes(channels, contexts, fine);
  if (dyn > room) return cudaErrorInvalidValue;
  int s = want;
  if (s == 0) {
    s = 1;
    while (s < kMaxCluster && (cnl + s - 1) / s > kBlockLanes) s *= 2;
  }
  for (;; s /= 2) {
    const int64_t chunk = ((cnl + s - 1) / s + kChunkAlign - 1) / kChunkAlign * kChunkAlign;
    int per = 0;
    for (int k = 0; k < kNumVariants && per == 0; ++k)
      if (chunk <= static_cast<int64_t>(kThreads) * kVariants[k]) per = kVariants[k];
    if (per == 0) return cudaErrorInvalidValue;
    bool fits = true;
    if (check_fit) {
      err = cluster_fits(kernel_of(per), s, dyn, &fits);
      if (err != cudaSuccess) return err;
    }
    if (fits) {
      *p = Plan{s, per, chunk, dyn};
      return cudaSuccess;
    }
    if (want != 0 || s == 1) return cudaErrorInvalidClusterSize;
  }
}

template <int P>
cudaError_t launch(const cudaLaunchConfig_t& cfg, const StepArgs& a) {
  return cudaLaunchKernelEx(&cfg, rans_decode_steps_kernel<P>, a);
}

}  // namespace

// The launch plan of frave_rans_decode_steps for channels x lanes with
// `contexts` contexts and `fine` predictor rows: *cluster the blocks it
// runs (`want`, a power of two up to 16 that must be resident at once, or
// 0 for the launch rule), *per the lanes a thread.
extern "C" int frave_rans_decode_steps_plan(int channels, int lanes, int contexts, int fine,
                                            int want, int* cluster, int* per) {
  Plan p;
  const cudaError_t err = make_plan(channels, lanes, contexts, fine, want, true, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  *cluster = p.cluster;
  *per = p.per;
  return 0;
}

// Every step of a decode of `images` same-shape images, one cluster of
// `cluster` blocks each: x_in / x_out [images, channels, lanes] int64,
// gptr_in / gptr_out [images] int64, coef [steps, lanes] int32, nbr
// [steps, lanes, 6] int32, lf [steps, lanes] u8, grp and fbkt [steps,
// lanes] int8 (the step tensors, shared), vparams / wparams [images,
// channels, fine, 6] f32, edges [contexts - 1] f32, stream [images,
// stream_len] int32, cdf [images, channels, contexts, 1024] and bits
// [images, channels, contexts] int32, plane [images, channels, n_slots]
// int32 (zeroed; written in place).
extern "C" int frave_rans_decode_steps(const void* x_in, const void* gptr_in, const void* coef,
                                       const void* nbr, const void* lf, const void* grp,
                                       const void* fbkt, const void* vparams,
                                       const void* wparams, const void* edges,
                                       const void* stream, const void* cdf, const void* bits,
                                       void* plane, void* x_out, void* gptr_out, int steps,
                                       int channels, int lanes, int contexts, int fine,
                                       long long n_slots, int stream_len, int images,
                                       int cluster, void* cuda_stream) {
  if (steps < 0 || stream_len < 1 || cluster < 1 || images < 1 || images > 65535 ||
      n_slots < 1 || n_slots >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  cudaError_t err = make_plan(channels, lanes, contexts, fine, cluster, false, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  StepArgs a;
  a.x_in = static_cast<const int64_t*>(x_in);
  a.gptr_in = static_cast<const int64_t*>(gptr_in);
  a.coef = static_cast<const int32_t*>(coef);
  a.nbr = static_cast<const int32_t*>(nbr);
  a.lf = static_cast<const uint8_t*>(lf);
  a.grp = static_cast<const int8_t*>(grp);
  a.fbkt = static_cast<const int8_t*>(fbkt);
  a.vparams = static_cast<const float*>(vparams);
  a.wparams = static_cast<const float*>(wparams);
  a.edges = static_cast<const float*>(edges);
  a.stream = static_cast<const int32_t*>(stream);
  a.cdf = static_cast<const int32_t*>(cdf);
  a.bits = static_cast<const int32_t*>(bits);
  a.plane = static_cast<int32_t*>(plane);
  a.x_out = static_cast<int64_t*>(x_out);
  a.gptr_out = static_cast<int64_t*>(gptr_out);
  a.steps = steps;
  a.channels = channels;
  a.lanes = lanes;
  a.contexts = contexts;
  a.fine = fine;
  a.stream_len = stream_len;
  a.n_slots = n_slots;
  a.chunk = p.chunk;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(p.cluster, images, p.dyn, static_cast<cudaStream_t>(cuda_stream), &attr);
  switch (p.per) {
    case 1: err = launch<1>(cfg, a); break;
    case 2: err = launch<2>(cfg, a); break;
    case 4: err = launch<4>(cfg, a); break;
    default: err = launch<8>(cfg, a); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
