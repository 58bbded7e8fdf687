// K8: the streaming pool's refill for Hopper (sm_90a), and the start grants
// in lane order that the streaming chunks (K2, K4, K7) take in a chunk
// where the start quota binds.
//
// Replaces the pool regeneration of the JAX streaming super-steps, which
// is XLA, not Pallas: `simulate_channel` and the merge of the consumed
// entries under `jax.lax.cond(do_gen, gen, keep)` with
// do_gen = refill && used >= watermark (libldpc_tpu/ops/streaming_pallas.py
// :134-161 flooding, :526-566 the lanes path; libldpc_tpu/ops/streaming.py
// :176-198).  JAX draws a whole channel batch and keeps it on the consumed
// entries only; here only those entries are drawn, which gives the same
// pool in distribution, and nothing is drawn in a chunk where JAX keeps the
// pool.  ops/kernels/pool_refill.py holds the wrappers and the plain
// versions.
//
// * pool_plan_kernel (one block): used = B - sum(avail), do_gen into ctl[0];
//   and the chunk's start budget remaining = clamp(quota - started -
//   sum(ctr[4]), 0, INT32_SAFE), as the streaming step computed it in
//   PyTorch before.
// * pool_draw_kernel: a block of 32 lanes x 8 warps returns at once unless
//   do_gen.  A lane whose entry is used (avail == 0) draws its info word,
//   encodes it with the generator's columns packed into 32-bit words at
//   table build (c_v = parity(u & column v); the all-zero word without a
//   generator, as encode_batch does), draws its noise (normal) or its
//   uniforms (BSC flips, BEC erasures) and writes its column of the pool's
//   values (float32 LLRs, or u8 BEC symbols) and codewords; then avail = 1
//   on every lane.  The channel's arithmetic is ops/channel.py's and
//   ops/modulation.py's, operation for operation (the BPSK LLR is 2 y times
//   1 / sigma^2, as PyTorch divides a CUDA tensor by a host scalar), so the
//   plain formulas on a lane's codeword and draws give its values: bit for
//   bit, and M-ASK's logsumexps to float32 rounding.
// * stream_grant_kernel (one block): the grants of one pass in lane order
//   over the whole batch, eligible = refill && done && avail, granted iff
//   the inclusive count of eligible lanes is <= remaining; remaining is
//   reduced by the grants.  A chunk's plain version grants so, pass by pass
//   (ops/kernels/decode_fused.py stream_chunk_plain), and so do the JAX
//   kernels (decode_fused.py:464-494).  Blocks of a chunk launch run in no
//   order and not all at once, so a chunk where the quota can bind runs as
//   k one-pass launches, each after a grant launch; elsewhere every wanting
//   lane is granted, and the kernels' atomicSub tickets are exact.
//
// Random numbers: curand's Philox4x32-10 in the kernel, seeded with a key
// the wrapper draws from the step's torch.Generator as a device tensor (no
// host read), subsequence = the lane, outputs [0, kw) the info words and
// from kw rounded up to 4 the item draws, four a call.  Warp w draws its
// own contiguous runs from their offsets, so a lane's numbers depend on the
// key and the lane only, never on the block order.
//
// Bound: the fresh values and codewords of the taken lanes, taken x nc x 5
// bytes (x 2 for the BEC), are written once; the encode is 2 kw integer
// operations a position (AND, XOR; the column words are broadcast loads).
// At the 1152 code the two are of one size (5,760 bytes and 41,472
// operations a lane), so the kernel keeps each lane's info words in shared
// memory and gives each warp a run of positions, writing the planes with
// the lanes of a warp on neighbouring addresses.
#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <stdint.h>

#include "bp_phases.cuh"

namespace {

constexpr int kPoolLanes = 32;   // lanes a block, one per thread of a warp
constexpr int kPoolWarps = 8;    // warps a block, splitting the positions
constexpr int kPlanThreads = 1024;
constexpr int kMaxBits = 8;      // bits a symbol (M <= 256)
constexpr long long kInt32Safe = (1LL << 31) - (1LL << 20);  // ops/streaming.py _INT32_SAFE
constexpr uint8_t kErasedSym = 2;  // ops/channel.py BEC_ERASURE

enum PoolChannel { CH_AWGN = 0, CH_MASK = 1, CH_BSC = 2, CH_BEC = 3 };

// One code's and channel's tables, built once (ops/kernels/pool_refill.py
// pool_tables).  Positions are sorted VN labels.
struct PoolPlan {
  const uint32_t* gcols;       // [nc, kw] bit i of word j: G[32 j + i, v]; null: no generator
  int kw;                      // a multiple of 4, the last words zero
  const int* item_src;         // [n_items, bpi] the positions an item's draw covers
  const int* item_dst;         // [n_items, bpi] where each bit's value goes (-1: nowhere)
  int n_items, bpi;            // items: transmitted bits (bpi 1), or M-ASK symbols
  const int* other_pos;        // [n_other] the positions no item writes
  const uint8_t* other_short;  // [n_other] 1 shortened (known), 0 punctured or unnamed
  int n_other;
  const float* points;         // [M] M-ASK amplitudes, point order
  const float* logp;           // [M] log priors
  const int* label_of;         // [M] label of each point
  const int* point_of;         // [M] point of each label
  int M;
};

struct PoolDraw {
  void* fresh;                     // [nc, B] float32 LLRs, or u8 BEC symbols
  uint8_t* fresh_cw;               // [nc, B]
  int* avail;                      // [B]
  const int* ctl;                  // [1] do_gen, from pool_plan_kernel
  const unsigned long long* key;   // [1] Philox seed
  float* debug;                    // [n_items, B] each item's draw, or null
  int B;
  float sigma;    // AWGN: sqrt(sigma^2)
  float inv_s2;   // BPSK: 1 / sigma^2
  float two_s2;   // M-ASK: 2 sigma^2
  float delta;    // BSC: log((1 - eps) / eps)
  float eps;      // BSC, BEC
  float shorten;  // the LLR of a shortened bit
};

// c_v of lane f: the parity of its info words AND column v.  A column is
// kw words, kw a multiple of 4 (zero words pad it at table build), read as
// 16-byte loads that are all in flight at once: a position costs one trip
// to the L2, not kw of them.
__device__ __forceinline__ int code_bit(const PoolPlan& p, const uint32_t* u, int f, int v) {
  if (!p.gcols) return 0;
  const uint4* g = reinterpret_cast<const uint4*>(p.gcols + (size_t)v * p.kw);
  uint32_t x = 0;
#pragma unroll 8
  for (int q = 0; q < p.kw / 4; ++q) {
    const uint4 w = __ldg(g + q);
    const uint32_t* uq = u + 4 * q * kPoolLanes + f;
    x ^= (w.x & uq[0]) ^ (w.y & uq[kPoolLanes]) ^ (w.z & uq[2 * kPoolLanes]) ^
         (w.w & uq[3 * kPoolLanes]);
  }
  return __popc(x) & 1;
}

// log sum exp of the points' log-weights whose label has bit `bit` (most
// significant first) equal to `one`, in point order, as torch.logsumexp
// computes it: the max, then log of the sum of exp(w - max), plus the max.
__device__ float label_lse(const PoolPlan& p, float y, float two_s2, int shift, int one) {
  const float inf = __int_as_float(0x7f800000);
  float m = -inf;
  for (int j = 0; j < p.M; ++j) {
    if (((__ldg(p.label_of + j) >> shift) & 1) != one) continue;
    const float dj = y - __ldg(p.points + j);
    m = fmaxf(m, -(dj * dj) / two_s2 + __ldg(p.logp + j));
  }
  const float mm = m == inf || m == -inf ? 0.0f : m;
  float s = 0.0f;
  for (int j = 0; j < p.M; ++j) {
    if (((__ldg(p.label_of + j) >> shift) & 1) != one) continue;
    const float dj = y - __ldg(p.points + j);
    s = s + expf((-(dj * dj) / two_s2 + __ldg(p.logp + j)) - mm);
  }
  return logf(s) + mm;
}

// One item of a taken lane: its codeword bits, its channel values.
template <int CH>
__device__ void draw_item(const PoolPlan& p, const PoolDraw& d, const uint32_t* u, int f, size_t b,
                          int t, float r) {
  const size_t B = d.B;
  if (d.debug) d.debug[(size_t)t * B + b] = r;
  if constexpr (CH == CH_MASK) {
    int c[kMaxBits];
    int label = 0;
    for (int k = 0; k < p.bpi; ++k) {
      c[k] = code_bit(p, u, f, __ldg(p.item_src + t * p.bpi + k));
      label = (label << 1) | c[k];
    }
    const float x = __ldg(p.points + __ldg(p.point_of + label));
    const float y = x + r * d.sigma;
    for (int k = 0; k < p.bpi; ++k) {
      const int v = __ldg(p.item_dst + t * p.bpi + k);
      if (v < 0) continue;
      const int shift = p.bpi - 1 - k;
      float llr = label_lse(p, y, d.two_s2, shift, 0) - label_lse(p, y, d.two_s2, shift, 1);
      llr = fminf(fmaxf(llr, -9999.9f), 9999.9f);  // utils/params.py MIN_LLR, MAX_LLR
      ((float*)d.fresh)[v * B + b] = llr;
      d.fresh_cw[v * B + b] = (uint8_t)c[k];
    }
  } else {
    const int v = __ldg(p.item_src + t);
    const int c = code_bit(p, u, f, v);
    if constexpr (CH == CH_AWGN) {
      const float x = 1.0f - 2.0f * (float)c;
      const float y = x + r * d.sigma;
      ((float*)d.fresh)[v * B + b] = (2.0f * y) * d.inv_s2;
    } else if constexpr (CH == CH_BSC) {
      const int yb = c ^ (int)(r < d.eps);
      ((float*)d.fresh)[v * B + b] = d.delta * (1.0f - 2.0f * (float)yb);
    } else {
      ((uint8_t*)d.fresh)[v * B + b] = r < d.eps ? kErasedSym : (uint8_t)c;
    }
    d.fresh_cw[v * B + b] = (uint8_t)c;
  }
}

template <int CH>
__global__ void __launch_bounds__(kPoolLanes * kPoolWarps)
pool_draw_kernel(PoolPlan p, PoolDraw d) {
  if (!*d.ctl) return;  // the pool keeps every entry
  extern __shared__ uint32_t u_s[];  // [kw, 32] the lanes' info words
  const int f = threadIdx.x, w = threadIdx.y;
  const size_t B = d.B;
  const size_t b = (size_t)blockIdx.x * kPoolLanes + f;
  const bool take = b < B && d.avail[b] == 0;
  const unsigned long long seed = *d.key;
  curandStatePhilox4_32_10_t st;
  const int kpw = (p.kw + kPoolWarps - 1) / kPoolWarps;
  const int j0 = w * kpw, j1 = min(p.kw, j0 + kpw);
  if (take && j0 < j1) {
    curand_init(seed, b, (unsigned long long)j0, &st);
    for (int j = j0; j < j1; ++j) u_s[j * kPoolLanes + f] = curand(&st);
  }
  __syncthreads();  // the info words; every warp has read avail
  if (take) {
    const int groups = (p.n_items + 3) / 4;
    const int gpw = (groups + kPoolWarps - 1) / kPoolWarps;
    const int g0 = w * gpw, g1 = min(groups, g0 + gpw);
    if (g0 < g1) curand_init(seed, b, (unsigned long long)((p.kw + 3) / 4 * 4 + 4 * g0), &st);
    for (int g = g0; g < g1; ++g) {
      float4 r;
      if constexpr (CH == CH_AWGN || CH == CH_MASK)
        r = curand_normal4(&st);
      else
        r = curand_uniform4(&st);
      const int t = 4 * g;
      draw_item<CH>(p, d, u_s, f, b, t, r.x);
      if (t + 1 < p.n_items) draw_item<CH>(p, d, u_s, f, b, t + 1, r.y);
      if (t + 2 < p.n_items) draw_item<CH>(p, d, u_s, f, b, t + 2, r.z);
      if (t + 3 < p.n_items) draw_item<CH>(p, d, u_s, f, b, t + 3, r.w);
    }
    for (int i = w; i < p.n_other; i += kPoolWarps) {
      const int v = __ldg(p.other_pos + i);
      const bool shortened = __ldg(p.other_short + i) != 0;
      const int c = code_bit(p, u_s, f, v);
      if constexpr (CH == CH_BEC)
        ((uint8_t*)d.fresh)[v * B + b] = shortened ? (uint8_t)c : kErasedSym;
      else
        ((float*)d.fresh)[v * B + b] = shortened ? d.shorten : 0.0f;
      d.fresh_cw[v * B + b] = (uint8_t)c;
    }
  }
  if (w == 0 && b < B) d.avail[b] = 1;
}

// Sum over the block (1024 threads); the result in thread 0.
__device__ long long block_sum(long long v, long long* sh) {
  for (int o = 16; o; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  v = threadIdx.x < 32 ? sh[threadIdx.x] : 0;
  if (threadIdx.x < 32)
    for (int o = 16; o; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(kPlanThreads)
pool_plan_kernel(const int* __restrict__ avail, const int* __restrict__ ctr4,
                 const long long* __restrict__ started, long long quota,
                 const int* __restrict__ refill, int watermark, int B, int* __restrict__ ctl,
                 int* __restrict__ remaining) {
  __shared__ long long sh[32];
  long long a = 0, s = 0;
  for (int i = threadIdx.x; i < B; i += kPlanThreads) {
    a += avail[i];
    s += ctr4[i];
  }
  a = block_sum(a, sh);
  s = block_sum(s, sh);
  if (threadIdx.x == 0) {
    ctl[0] = *refill > 0 && (long long)B - a >= (long long)watermark;
    long long rem = quota - *started - s;
    rem = rem < 0 ? 0 : rem > kInt32Safe ? kInt32Safe : rem;
    *remaining = (int)rem;
  }
}

__global__ void __launch_bounds__(kPlanThreads)
stream_grant_kernel(const int* __restrict__ done, const int* __restrict__ avail,
                    const int* __restrict__ refill, int* remaining, uint8_t* __restrict__ grant,
                    int B) {
  __shared__ int warp_sum[32];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int per = (B + kPlanThreads - 1) / kPlanThreads;
  const int i0 = min(B, tid * per), i1 = min(B, i0 + per);
  const bool on = *refill != 0;
  const int R = max(*remaining, 0);
  int n = 0;
  for (int i = i0; i < i1; ++i) n += on && done[i] && avail[i];
  int x = n;  // inclusive scan over the warp, then over the warps
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int t = warp_sum[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    warp_sum[lane] = t;
  }
  __syncthreads();
  int before = x - n + (wid ? warp_sum[wid - 1] : 0);  // eligible lanes below i0
  for (int i = i0; i < i1; ++i) {
    const bool e = on && done[i] && avail[i];
    before += e;
    grant[i] = e && before <= R;
  }
  if (tid == kPlanThreads - 1) *remaining = R - min(before, R);  // `before` is the total here
}

}  // namespace

extern "C" {

// Each returns the launch's cudaGetLastError() (0 = launched).

int ldpc_pool_plan(const int* avail, const int* ctr, const long long* started, long long quota,
                   const int* refill, int watermark, int B, int* ctl, int* remaining,
                   void* stream) {
  pool_plan_kernel<<<1, kPlanThreads, 0, (cudaStream_t)stream>>>(
      avail, ctr + (size_t)4 * B, started, quota, refill, watermark, B, ctl, remaining);
  return (int)cudaGetLastError();
}

// `channel`: 0 AWGN (BPSK), 1 AWGN through an M-ASK constellation, 2 BSC,
// 3 BEC.  `fresh` is float32, or u8 for the BEC.  `debug` (or null) takes
// each item's draw, [n_items, B].
int ldpc_pool_draw(int channel, const uint32_t* gcols, int kw, const int* item_src,
                   const int* item_dst, int n_items, int bpi, const int* other_pos,
                   const uint8_t* other_short, int n_other, const float* points,
                   const float* logp, const int* label_of, const int* point_of, int M, void* fresh,
                   uint8_t* fresh_cw, int* avail, const int* ctl, const unsigned long long* key,
                   float* debug, int B, float sigma, float inv_s2, float two_s2, float delta,
                   float eps, float shorten, void* stream) {
  if (bpi < 1 || bpi > kMaxBits) return (int)cudaErrorInvalidValue;
  PoolPlan p{gcols,     kw,          item_src, item_dst, n_items, bpi,      other_pos,
             other_short, n_other,   points,   logp,     label_of, point_of, M};
  PoolDraw d{fresh, fresh_cw, avail, ctl, key, debug, B, sigma, inv_s2, two_s2, delta, eps,
             shorten};
  const unsigned grid = (unsigned)((B + kPoolLanes - 1) / kPoolLanes);
  const dim3 block(kPoolLanes, kPoolWarps);
  const size_t bytes = (size_t)kw * kPoolLanes * 4;
  cudaStream_t st = (cudaStream_t)stream;
  switch (channel) {
    case CH_AWGN:
      return launch_smem(pool_draw_kernel<CH_AWGN>, grid, block, bytes, st, p, d);
    case CH_MASK:
      return launch_smem(pool_draw_kernel<CH_MASK>, grid, block, bytes, st, p, d);
    case CH_BSC:
      return launch_smem(pool_draw_kernel<CH_BSC>, grid, block, bytes, st, p, d);
    case CH_BEC:
      return launch_smem(pool_draw_kernel<CH_BEC>, grid, block, bytes, st, p, d);
  }
  return (int)cudaErrorInvalidValue;
}

int ldpc_stream_grant(const int* done, const int* avail, const int* refill, int* remaining,
                      uint8_t* grant, int B, void* stream) {
  stream_grant_kernel<<<1, kPlanThreads, 0, (cudaStream_t)stream>>>(done, avail, refill,
                                                                     remaining, grant, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
