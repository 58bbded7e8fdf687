// Per-phase cycle stamps of K8's scalar draw (a block of 32
// lanes x 8 warps, each used entry's lane encoding its positions one at a
// time with the generator's columns packed in 32-bit words), kept as the
// reference design that the redesigned draw in ../pool_refill.cu replaces.
// The arithmetic is that kernel's, operation for operation, so a pool drawn
// here from a key equals the library's pool from the same key (the redesign
// keeps the Philox keying).  Built and run only by tests_gpu/pool_stamps.py;
// not part of the kernel library.
//
// Each thread reads clock64() at each phase boundary (its warp's active
// lanes reconverged first) and adds the difference to the phase it leaves;
// at the end the warp's sums are added into stamps[phase].  Shares of the
// summed thread time say where a lane spends its life; they are not device
// time.  Phases: entry (reading avail, the key), the info words, the
// barrier after them, the encode (every codeword bit of a lane), the draws
// (curand's normals or uniforms), the values (the BPSK / BSC / BEC
// formulas, M-ASK's logsumexps) and the stores (values, codewords, avail).
#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <stdint.h>

#include "../bp_phases.cuh"

namespace {

constexpr int kPoolLanes = 32;
constexpr int kPoolWarps = 8;
constexpr int kMaxBits = 8;
constexpr uint8_t kErasedSym = 2;

enum PoolChannel { CH_AWGN = 0, CH_MASK = 1, CH_BSC = 2, CH_BEC = 3 };
enum { S_ENTRY = 0, S_INFO, S_BARRIER, S_ENCODE, S_DRAW, S_VALUES, S_STORE, S_N };

#define STAMP(i)                      \
  {                                   \
    __syncwarp(__activemask());       \
    const long long t_ = clock64();   \
    acc[i] += t_ - t0;                \
    t0 = t_;                          \
  }

struct PoolPlan {
  const uint32_t* gcols;
  int kw;
  const int* item_src;
  const int* item_dst;
  int n_items, bpi;
  const int* other_pos;
  const uint8_t* other_short;
  int n_other;
  const float* points;
  const float* logp;
  const int* label_of;
  const int* point_of;
  int M;
};

struct PoolDraw {
  void* fresh;
  uint8_t* fresh_cw;
  int* avail;
  const int* ctl;
  const unsigned long long* key;
  float* debug;
  int B;
  float sigma, inv_s2, two_s2, delta, eps, shorten;
};

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

// One item, as the scalar draw's draw_item, with its encode, values and stores
// stamped apart.
template <int CH>
__device__ void draw_item(const PoolPlan& p, const PoolDraw& d, const uint32_t* u, int f, size_t b,
                          int t, float r, long long* acc, long long& t0) {
  const size_t B = d.B;
  if constexpr (CH == CH_MASK) {
    int c[kMaxBits];
    int label = 0;
    for (int k = 0; k < p.bpi; ++k) {
      c[k] = code_bit(p, u, f, __ldg(p.item_src + t * p.bpi + k));
      label = (label << 1) | c[k];
    }
    STAMP(S_ENCODE)
    const float x = __ldg(p.points + __ldg(p.point_of + label));
    const float y = x + r * d.sigma;
    float llr[kMaxBits];
    for (int k = 0; k < p.bpi; ++k) {
      const int shift = p.bpi - 1 - k;
      llr[k] = __ldg(p.item_dst + t * p.bpi + k) < 0
                   ? 0.0f
                   : label_lse(p, y, d.two_s2, shift, 0) - label_lse(p, y, d.two_s2, shift, 1);
      llr[k] = fminf(fmaxf(llr[k], -9999.9f), 9999.9f);
    }
    STAMP(S_VALUES)
    if (d.debug) d.debug[(size_t)t * B + b] = r;
    for (int k = 0; k < p.bpi; ++k) {
      const int v = __ldg(p.item_dst + t * p.bpi + k);
      if (v < 0) continue;
      ((float*)d.fresh)[v * B + b] = llr[k];
      d.fresh_cw[v * B + b] = (uint8_t)c[k];
    }
    STAMP(S_STORE)
  } else {
    const int v = __ldg(p.item_src + t);
    const int c = code_bit(p, u, f, v);
    STAMP(S_ENCODE)
    float val = 0.0f;
    uint8_t sym = 0;
    if constexpr (CH == CH_AWGN) {
      const float x = 1.0f - 2.0f * (float)c;
      const float y = x + r * d.sigma;
      val = (2.0f * y) * d.inv_s2;
    } else if constexpr (CH == CH_BSC) {
      const int yb = c ^ (int)(r < d.eps);
      val = d.delta * (1.0f - 2.0f * (float)yb);
    } else {
      sym = r < d.eps ? kErasedSym : (uint8_t)c;
    }
    STAMP(S_VALUES)
    if (d.debug) d.debug[(size_t)t * B + b] = r;
    if constexpr (CH == CH_BEC)
      ((uint8_t*)d.fresh)[v * B + b] = sym;
    else
      ((float*)d.fresh)[v * B + b] = val;
    d.fresh_cw[v * B + b] = (uint8_t)c;
    STAMP(S_STORE)
  }
}

template <int CH>
__global__ void __launch_bounds__(kPoolLanes * kPoolWarps)
stamped_pool_draw(PoolPlan p, PoolDraw d, unsigned long long* stamps) {
  long long acc[S_N] = {0, 0, 0, 0, 0, 0, 0};
  long long t0 = clock64();
  const bool go = *d.ctl != 0;
  extern __shared__ uint32_t u_s[];
  const int f = threadIdx.x, w = threadIdx.y;
  const size_t B = d.B;
  const size_t b = (size_t)blockIdx.x * kPoolLanes + f;
  const bool take = go && b < B && d.avail[b] == 0;
  const unsigned long long seed = *d.key;
  curandStatePhilox4_32_10_t st;
  const int kpw = (p.kw + kPoolWarps - 1) / kPoolWarps;
  const int j0 = w * kpw, j1 = min(p.kw, j0 + kpw);
  STAMP(S_ENTRY)
  if (take && j0 < j1) {
    curand_init(seed, b, (unsigned long long)j0, &st);
    for (int j = j0; j < j1; ++j) u_s[j * kPoolLanes + f] = curand(&st);
  }
  STAMP(S_INFO)
  __syncthreads();
  STAMP(S_BARRIER)
  if (take) {
    const int groups = (p.n_items + 3) / 4;
    const int gpw = (groups + kPoolWarps - 1) / kPoolWarps;
    const int g0 = w * gpw, g1 = min(groups, g0 + gpw);
    if (g0 < g1) curand_init(seed, b, (unsigned long long)((p.kw + 3) / 4 * 4 + 4 * g0), &st);
    STAMP(S_DRAW)
    for (int g = g0; g < g1; ++g) {
      float4 r;
      if constexpr (CH == CH_AWGN || CH == CH_MASK)
        r = curand_normal4(&st);
      else
        r = curand_uniform4(&st);
      STAMP(S_DRAW)
      const int t = 4 * g;
      draw_item<CH>(p, d, u_s, f, b, t, r.x, acc, t0);
      if (t + 1 < p.n_items) draw_item<CH>(p, d, u_s, f, b, t + 1, r.y, acc, t0);
      if (t + 2 < p.n_items) draw_item<CH>(p, d, u_s, f, b, t + 2, r.z, acc, t0);
      if (t + 3 < p.n_items) draw_item<CH>(p, d, u_s, f, b, t + 3, r.w, acc, t0);
    }
    for (int i = w; i < p.n_other; i += kPoolWarps) {
      const int v = __ldg(p.other_pos + i);
      const bool shortened = __ldg(p.other_short + i) != 0;
      const int c = code_bit(p, u_s, f, v);
      STAMP(S_ENCODE)
      if constexpr (CH == CH_BEC)
        ((uint8_t*)d.fresh)[v * B + b] = shortened ? (uint8_t)c : kErasedSym;
      else
        ((float*)d.fresh)[v * B + b] = shortened ? d.shorten : 0.0f;
      d.fresh_cw[v * B + b] = (uint8_t)c;
      STAMP(S_STORE)
    }
  }
  if (go && w == 0 && b < B) d.avail[b] = 1;
  STAMP(S_STORE)
  __syncwarp();
  for (int i = 0; i < S_N; ++i) {
    long long v = acc[i];
    for (int o = 16; o; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (f == 0) atomicAdd(stamps + i, (unsigned long long)v);
  }
}

}  // namespace

extern "C" {

// As the scalar draw's ldpc_pool_draw, plus `stamps` (u64 [7]).
int dev_stamped_pool_draw(int channel, const uint32_t* gcols, int kw, const int* item_src,
                          const int* item_dst, int n_items, int bpi, const int* other_pos,
                          const uint8_t* other_short, int n_other, const float* points,
                          const float* logp, const int* label_of, const int* point_of, int M,
                          void* fresh, uint8_t* fresh_cw, int* avail, const int* ctl,
                          const unsigned long long* key, float* debug, int B, float sigma,
                          float inv_s2, float two_s2, float delta, float eps, float shorten,
                          unsigned long long* stamps, void* stream) {
  if (bpi < 1 || bpi > kMaxBits) return (int)cudaErrorInvalidValue;
  PoolPlan p{gcols,       kw,      item_src, item_dst, n_items,  bpi,      other_pos,
             other_short, n_other, points,   logp,     label_of, point_of, M};
  PoolDraw d{fresh, fresh_cw, avail, ctl, key, debug, B, sigma, inv_s2, two_s2, delta, eps,
             shorten};
  const unsigned grid = (unsigned)((B + kPoolLanes - 1) / kPoolLanes);
  const dim3 block(kPoolLanes, kPoolWarps);
  const size_t bytes = (size_t)kw * kPoolLanes * 4;
  cudaStream_t st = (cudaStream_t)stream;
  switch (channel) {
    case CH_AWGN:
      return launch_smem(stamped_pool_draw<CH_AWGN>, grid, block, bytes, st, p, d, stamps);
    case CH_MASK:
      return launch_smem(stamped_pool_draw<CH_MASK>, grid, block, bytes, st, p, d, stamps);
    case CH_BSC:
      return launch_smem(stamped_pool_draw<CH_BSC>, grid, block, bytes, st, p, d, stamps);
    case CH_BEC:
      return launch_smem(stamped_pool_draw<CH_BEC>, grid, block, bytes, st, p, d, stamps);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
