// K8: the channel draw for Hopper (sm_90a): the streaming pool's refill and
// the full channel batch of a batch step; and the start grants in lane order
// that the streaming chunks (K2, K4, K7) take in a chunk where the start
// quota binds.
//
// Replaces the XLA channel of the JAX package: `simulate_channel` of a batch
// step (libldpc_tpu/parallel/mesh.py:89, ops/channel.py:166), and in the
// streaming super-steps the pool regeneration under
// `jax.lax.cond(do_gen, gen, keep)` with do_gen = refill && used >=
// watermark (libldpc_tpu/ops/streaming_pallas.py :134-161 flooding,
// :526-566 the lanes path; libldpc_tpu/ops/streaming.py :176-198).  JAX
// draws a whole channel batch and keeps it on the consumed entries only;
// here only those entries are drawn, which gives the same pool in
// distribution, and nothing is drawn in a chunk where JAX keeps the pool.
// ops/kernels/pool_refill.py holds the wrappers and the plain versions.
//
// * pool_plan_kernel (one block): used = B - sum(avail), do_gen and the
//   count of lanes to draw into ctl; when do_gen, the used lanes in lane
//   order into `lanes` (a lane-order scan, lane_scan.cuh); and the chunk's
//   start budget remaining = clamp(quota - started - sum(ctr[4]), 0,
//   INT32_SAFE).
// * pool_draw_kernel: a block draws a tile of LT lanes (64 unless shared
//   memory needs fewer) over one slab of the codeword's columns (a run of
//   items, or of the positions no item writes); lanes come from the plan's
//   list (blocks past its count return at once) or, for a full batch, are
//   the batch's lanes in order.  Per block:
//   1. each lane's info words from curand's Philox into shared memory, word
//      major ([words, LT + 8]: the pad keeps a fragment's loads off each
//      other's banks), and the slab's generator tiles from device memory;
//   2. the encode on the tensor cores: codeword bit = parity of popc(info
//      AND column), mma.sync m16n8k256 b1 .and.popc -> s32 (exact: a count
//      is at most kc), the lanes' 32-bit info words as A, G's columns packed
//      in 32-bit words as B, in tiles built at table build in the
//      fragment's own order (8 bytes a thread); a warp holds its m-tile's A
//      fragments for every k-step and runs its n-tiles; the bits to shared
//      memory [columns, LT].  A systematic column (G's column a unit
//      vector, half of a systematic G's) is not encoded: its bit is the
//      info bit, read from the info words;
//   3. each (lane, group of 4 items) draws its 4 normals or uniforms, forms
//      the values (M-ASK: a symbol's M log-weights once, for M <= 16, then
//      each bit's two logsumexps) and stores them: a warp is 32 lanes of one
//      item, so its stores are 32 neighbouring lanes of one position.
//   The values are ops/channel.py's and ops/modulation.py's, operation for
//   operation (the BPSK LLR is 2 y times 1 / sigma^2, as PyTorch divides a
//   CUDA tensor by a host scalar), so the plain formulas on a lane's
//   codeword and draws give its values: bit for bit, and M-ASK's logsumexps
//   to float32 rounding.
// * the reload form (the XLA streaming super-step's per-pass reload,
//   libldpc_tpu/ops/streaming.py :176-209): reload_plan_kernel (one block)
//   lists the idle lanes (done != 0) in lane order, decides do_gen = refill
//   && idle >= gen_threshold on the device, grants the first min(idle,
//   quota - started) of them and adds the grants to `started`; then
//   pool_draw_kernel draws only the granted lanes, with the keying and
//   formulas above, in one of two forms:
//   - staged (StageSink; every pass of a super-step but its last): lane
//     lanes[r] goes to column r of a staging buffer [nc, S] (the LLRs and
//     the codeword), slot[lane] = r, and done = 0, age = 1, iters = 0.  A
//     warp holds 32 consecutive ranks of one position, so its stores fill
//     whole sectors, and no first message is written: K2's next one-pass
//     launch copies the lane's column into the planes and starts it from
//     its prior as an in-chunk reload does (flood_stream.cuh,
//     stream_chunk.cuh), which gives the first messages bit for bit;
//   - into the planes (PlaneSink; a super-step's last pass, so the state
//     between super-steps is the JAX super-step's): the LLRs and the
//     codeword, each edge's first message (the prior at its variable, from
//     the VN-space slot lists vn_ptr / perm_c2v), and done = 0, age = 1,
//     iters = 0.  The granted lanes are the idle ones, spread over the
//     batch: each of a lane's 5 nc + 4 nnz bytes is a 32-byte sector of
//     its own.
//   No host read: a pass where JAX's lax.cond draws nothing draws nothing
//   here.
// * stream_grant_kernel (one block): the grants of one pass in lane order
//   over the whole batch, eligible = refill && done && avail, granted iff
//   the inclusive count of eligible lanes is <= remaining; remaining is
//   reduced by the grants (lane_scan.cuh).  A chunk's plain version grants
//   so, pass by pass (ops/kernels/decode_fused.py stream_chunk_plain), and so
//   do the JAX kernels (decode_fused.py:464-494).  Blocks of a chunk launch
//   run in no order and not all at once, so a chunk where the quota can
//   bind runs as k one-pass launches, each after a grant launch; elsewhere
//   every wanting lane is granted, and the kernels' atomicSub tickets are
//   exact.
//
// Random numbers: curand's Philox4x32-10, seeded with a key the wrapper
// draws from the step's torch.Generator as a device tensor (no host read),
// subsequence = the lane, outputs [0, kw) the info words and from kw the
// item draws, four a call.  A (lane, call) pair initialises its own state at
// its call, so a lane's numbers depend on the key and the lane only, never
// on the block, the slab or the tiling.  The keying is the one of the
// scalar draw this design replaced (csrc/dev/pool_stamps.cu keeps it): the
// same key gives the same pool.
//
// Bound: the values and codewords of the drawn lanes, taken x nc x 5 bytes
// (x 2 for the BEC), are written once.  The scalar draw's stamps (PERF.md
// section 5)
// put 63-82 % of a lane's time in the encode (BPSK, BEC) and 59-74 % in
// M-ASK's logsumexps.  The encode is now a few hundred tensor-core
// instructions a block on packed words (an int8 form, m16n8k32 s8 on
// unpacked bits, moved 8 times the operand bytes and ran slower than the
// scalar draw: PERF.md section 6); each M-ASK weight is computed once; LT-lane x
// slab blocks fill the card.
#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <stdint.h>

#include "bp_phases.cuh"
#include "lane_scan.cuh"

namespace {

constexpr int kDrawThreads = 256;  // 8 warps
constexpr int kDrawWarps = kDrawThreads / 32;
constexpr int kLanePad = 8;        // words past LT in a row of the info words
constexpr int kMaxBits = 8;        // bits a symbol (M <= 256)
constexpr int kCachedPoints = 16;  // M-ASK: weights kept in registers up to this M
constexpr long long kInt32Safe = (1LL << 31) - (1LL << 20);  // ops/streaming.py _INT32_SAFE
constexpr uint8_t kErasedSym = 2;  // ops/channel.py BEC_ERASURE

enum PoolChannel { CH_AWGN = 0, CH_MASK = 1, CH_BSC = 2, CH_BEC = 3 };

// One code's and channel's tables, built once (ops/kernels/pool_refill.py
// pool_tables), and the launch's tiling.  Positions are sorted VN labels;
// a column is an item's bit (column t * bpi + k) or, from other_col0, a
// position no item writes.
struct PoolPlan {
  const uint2* gtiles;         // [n_tiles, ksteps, 32] G in mma B fragments; null: no generator
  const int* slab_tile0;       // [n_slabs + 1] slab y's tiles: [slab_tile0[y], slab_tile0[y + 1])
  const int* col_src;          // [n_cols] place among the slab's encoded columns, or -1 - info bit
  int ksteps;                  // ceil(kc / 256): the encode's k-steps
  int kwords;                  // ceil(kc / 32): the info words a lane draws
  int kw;                      // the info words a lane's keying skips (a multiple of 4)
  const int* item_src;         // [n_items, bpi] the positions an item's draw covers
  const int* item_dst;         // [n_items, bpi] where each bit's value goes (-1: nowhere)
  int n_items, bpi;            // items: transmitted bits (bpi 1), or M-ASK symbols
  const int* other_pos;        // [n_other] the positions no item writes
  const uint8_t* other_short;  // [n_other] 1 shortened (known), 0 punctured or unnamed
  int n_other, other_col0;
  const float* points;         // [M] M-ASK amplitudes, point order
  const float* logp;           // [M] log priors
  const int* label_of;         // [M] label of each point
  const int* point_of;         // [M] point of each label
  int M;
  int lane_tile;               // LT: 16, 32 or 64 lanes a block
  int items_per_slab, item_slabs, others_per_slab, slab_cols;
};

struct PoolDraw {
  const int* lanes;                // [B] the lanes to draw, in order; null: lane i is i
  const int* count;                // [1] how many of `lanes`; null: B
  const unsigned long long* key;   // [1] Philox seed
  float* debug;                    // [n_items, B] each item's draw, or null
  uint32_t* debug_info;            // [kwords, B] each lane's info words, or null
  int B;
  float sigma;    // AWGN: sqrt(sigma^2)
  float inv_s2;   // BPSK: 1 / sigma^2
  float two_s2;   // M-ASK: 2 sigma^2
  float delta;    // BSC: log((1 - eps) / eps)
  float eps;      // BSC, BEC
  float shorten;  // the LLR of a shortened bit
};

// Where a draw's results go.  `lane` is the drawn lane (its Philox
// subsequence), `rank` its place in the plan's list (the lane itself for a
// full batch).
//
// PlaneSink: lane `lane`'s column of [nc, B] planes: the pool, a channel
// batch, or (lv2c set) the reload straight into the stream state, each of
// the variable's edges taking its prior as the first message.
struct PlaneSink {
  static constexpr bool kSymbols = true;  // takes the BEC's u8 symbols
  void* fresh;            // [nc, B] float32 LLRs, or u8 BEC symbols
  uint8_t* fresh_cw;      // [nc, B]
  int* avail;             // [B] set to 1 on every drawn lane; null: not a pool
  size_t B;
  // the reload into the state (null otherwise)
  float* lv2c;            // [nnz, B] a reloaded lane's first messages: its prior at each edge
  const int* vn_ptr;      // [nc + 1] a variable's VN-space slots
  const int* perm_c2v;    // [nnz] the CN-space slot of each VN-space slot
  int* done;              // [B] set to 0 (in flight) on every drawn lane
  int* age;               // [B] set to 1
  int* iters;             // [B] set to 0
  __device__ __forceinline__ void value(int v, size_t lane, int, float x) const {
    ((float*)fresh)[v * B + lane] = x;
    if (lv2c) {
      const int j1 = __ldg(vn_ptr + v + 1);
      for (int j = __ldg(vn_ptr + v); j < j1; ++j) lv2c[(size_t)__ldg(perm_c2v + j) * B + lane] = x;
    }
  }
  __device__ __forceinline__ void symbol(int v, size_t lane, int, uint8_t x) const {
    ((uint8_t*)fresh)[v * B + lane] = x;
  }
  __device__ __forceinline__ void codeword(int v, size_t lane, int, uint8_t c) const {
    fresh_cw[v * B + lane] = c;
  }
  __device__ __forceinline__ void drawn(size_t lane, int) const {
    if (avail) avail[lane] = 1;
    if (done) {
      done[lane] = 0;
      age[lane] = 1;
      iters[lane] = 0;
    }
  }
};

// StageSink: the staged reload.  Column `rank` of the staging buffer [nc,
// S] takes the lane's LLRs and codeword (a warp's 32 consecutive ranks
// fill whole sectors), slot[lane] = rank names it for K2, and the lane is
// in flight from its next pass.  No first message: K2 starts the lane from
// its prior.
struct StageSink {
  static constexpr bool kSymbols = false;  // float values only
  float* llr;             // [nc, S]
  uint8_t* cw;            // [nc, S]
  size_t S;
  int* slot;              // [B] the lane's column, or -1
  int* done;              // [B] set to 0
  int* age;               // [B] set to 1
  int* iters;             // [B] set to 0
  __device__ __forceinline__ void value(int v, size_t, int rank, float x) const {
    llr[v * S + rank] = x;
  }
  __device__ __forceinline__ void symbol(int, size_t, int, uint8_t) const {}
  __device__ __forceinline__ void codeword(int v, size_t, int rank, uint8_t c) const {
    cw[v * S + rank] = c;
  }
  __device__ __forceinline__ void drawn(size_t lane, int rank) const {
    slot[lane] = rank;
    done[lane] = 0;
    age[lane] = 1;
    iters[lane] = 0;
  }
};

// c += popc(a AND b): A 16 x 256 bits (row), B 256 x 8 bits (col), C 16 x 8 s32.
__device__ __forceinline__ void mma_b1(int (&c)[4], const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// log sum exp over the points whose label has bit `bit` (most significant
// first) equal to `one`, in point order, as torch.logsumexp computes it:
// the max, then log of the sum of exp(w - max), plus the max; each weight
// recomputed (M > kCachedPoints).
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

// The same with the symbol's weights w[j] computed once (j < M <= MC): the
// points of the bit's half are the bits of `half` (bit j: point j).
template <int MC>
__device__ __forceinline__ float cached_lse(const float (&w)[MC], uint32_t half, int M) {
  const float inf = __int_as_float(0x7f800000);
  float m = -inf;
#pragma unroll
  for (int j = 0; j < MC; ++j)
    if (j < M && ((half >> j) & 1u)) m = fmaxf(m, w[j]);
  const float mm = m == inf || m == -inf ? 0.0f : m;
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < MC; ++j)
    if (j < M && ((half >> j) & 1u)) s = s + expf(w[j] - mm);
  return logf(s) + mm;
}

// The codeword bit of draw column `col` for the block's lane r: an encoded
// column's from cw_s, a systematic column's info bit from u_s.
__device__ __forceinline__ int column_bit(const PoolPlan& p, const uint8_t* cw_s,
                                          const uint32_t* u_s, int r, int col) {
  if (!p.gtiles) return 0;
  const int s = __ldg(p.col_src + col);
  if (s >= 0) return cw_s[s * p.lane_tile + r];
  const int k = -1 - s;
  return (u_s[(k >> 5) * (p.lane_tile + kLanePad) + r] >> (k & 31)) & 1;
}

// One M-ASK symbol's values: MC > 0 keeps its weights in registers (M <= MC).
template <int MC, class Sink>
__device__ __forceinline__ void symbol_values(const PoolPlan& p, const PoolDraw& d,
                                              const Sink& k_, const uint8_t* cw_s,
                                              const uint32_t* u_s, int r_lane, size_t b, int rank,
                                              int t, int col, float r) {
  int c[kMaxBits];
  int label = 0;
  for (int k = 0; k < p.bpi; ++k) {
    c[k] = column_bit(p, cw_s, u_s, r_lane, col + k);
    label = (label << 1) | c[k];
  }
  const float x = __ldg(p.points + __ldg(p.point_of + label));
  const float y = x + r * d.sigma;
  float w[MC > 0 ? MC : 1];
  if constexpr (MC > 0) {
#pragma unroll
    for (int j = 0; j < MC; ++j) {
      if (j < p.M) {
        const float dj = y - __ldg(p.points + j);
        w[j] = -(dj * dj) / d.two_s2 + __ldg(p.logp + j);
      }
    }
  }
  for (int k = 0; k < p.bpi; ++k) {
    const int v = __ldg(p.item_dst + t * p.bpi + k);
    if (v < 0) continue;
    const int shift = p.bpi - 1 - k;
    float llr;
    if constexpr (MC > 0) {
      uint32_t ones = 0;  // bit j: bit k of point j's label
#pragma unroll
      for (int j = 0; j < MC; ++j)
        if (j < p.M) ones |= (uint32_t)((__ldg(p.label_of + j) >> shift) & 1) << j;
      llr = cached_lse<MC>(w, ~ones, p.M) - cached_lse<MC>(w, ones, p.M);
    } else {
      llr = label_lse(p, y, d.two_s2, shift, 0) - label_lse(p, y, d.two_s2, shift, 1);
    }
    llr = fminf(fmaxf(llr, -9999.9f), 9999.9f);  // utils/params.py MIN_LLR, MAX_LLR
    k_.value(v, b, rank, llr);
    k_.codeword(v, b, rank, (uint8_t)c[k]);
  }
}

// One item of lane b (rank `rank` in the plan's list): its codeword bits
// (draw columns from `col`), its draw r, its values and codewords stored.
template <int CH, int MC, class Sink>
__device__ __forceinline__ void draw_item(const PoolPlan& p, const PoolDraw& d, const Sink& k,
                                          const uint8_t* cw_s, const uint32_t* u_s, int r_lane,
                                          size_t b, int rank, int t, int col, float r) {
  if (d.debug) d.debug[(size_t)t * d.B + b] = r;
  if constexpr (CH == CH_MASK) {
    symbol_values<MC>(p, d, k, cw_s, u_s, r_lane, b, rank, t, col, r);
  } else {
    const int v = __ldg(p.item_src + t);
    const int c = column_bit(p, cw_s, u_s, r_lane, col);
    if constexpr (CH == CH_AWGN) {
      const float x = 1.0f - 2.0f * (float)c;
      const float y = x + r * d.sigma;
      k.value(v, b, rank, (2.0f * y) * d.inv_s2);
    } else if constexpr (CH == CH_BSC) {
      const int yb = c ^ (int)(r < d.eps);
      k.value(v, b, rank, d.delta * (1.0f - 2.0f * (float)yb));
    } else {
      k.symbol(v, b, rank, r < d.eps ? kErasedSym : (uint8_t)c);
    }
    k.codeword(v, b, rank, (uint8_t)c);
  }
}

// Shared memory of a draw block: the info words, the slab's generator
// tiles, its codeword bits.
__host__ __device__ inline size_t draw_smem_bytes(int ksteps, bool has_g, int lane_tile,
                                                  int slab_cols) {
  const size_t g = has_g ? (size_t)8 * ksteps * (lane_tile + kLanePad) * 4 +
                               (size_t)(slab_cols / 8) * ksteps * 256
                         : 0;
  return g + (size_t)slab_cols * lane_tile;
}

template <int CH, int MC, class Sink>
__global__ void __launch_bounds__(kDrawThreads)
pool_draw_kernel(PoolPlan p, PoolDraw d, Sink k) {
  extern __shared__ __align__(16) unsigned char pool_smem[];
  const int LT = p.lane_tile;
  const int n_take = d.count ? *d.count : d.B;
  const int tile0 = blockIdx.x * LT;
  if (tile0 >= n_take) return;  // nothing to draw here (or no refill at all)
  const int tid = threadIdx.x;
  const int row = LT + kLanePad;  // words a row of u_s
  const int nwords = 8 * p.ksteps;
  uint32_t* u_s = reinterpret_cast<uint32_t*>(pool_smem);  // [nwords, row] info words
  uint2* g_s = reinterpret_cast<uint2*>(u_s + (p.gtiles ? (size_t)nwords * row : 0));
  uint8_t* cw_s = reinterpret_cast<uint8_t*>(
      g_s + (p.gtiles ? (size_t)(p.slab_cols / 8) * p.ksteps * 32 : 0));  // [slab_cols, LT]
  const int y = blockIdx.y;
  const int r_lane = tid % LT, part = tid / LT, parts = kDrawThreads / LT;
  const int idx = tile0 + r_lane;
  const int lane = idx < n_take ? (d.lanes ? __ldg(d.lanes + idx) : idx) : -1;
  const unsigned long long seed = *d.key;

  // the slab: items [i0, i1), or the other positions [o0, o1)
  const bool item_slab = y < p.item_slabs;
  int i0 = 0, i1 = 0, o0 = 0, o1 = 0;
  if (item_slab) {
    i0 = y * p.items_per_slab;
    i1 = min(p.n_items, i0 + p.items_per_slab);
  } else {
    o0 = (y - p.item_slabs) * p.others_per_slab;
    o1 = min(p.n_other, o0 + p.others_per_slab);
  }

  if (p.gtiles) {
    // 1. info words (call q of the lane gives words 4q..4q+3; words past
    // kwords are 0: they meet zero rows of G) and the slab's tiles
    const int calls = (nwords + 3) / 4;
    for (int q = part; q < calls; q += parts) {
      uint4 w4 = make_uint4(0u, 0u, 0u, 0u);
      if (lane >= 0 && 4 * q < p.kwords) {
        curandStatePhilox4_32_10_t st;
        curand_init(seed, (unsigned long long)lane, 4ull * q, &st);
        w4 = curand4(&st);
      }
      const uint32_t ws[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * q + i;
        if (j >= nwords) break;
        const uint32_t w = j < p.kwords ? ws[i] : 0u;
        u_s[j * row + r_lane] = w;
        if (d.debug_info && y == 0 && lane >= 0 && j < p.kwords)
          d.debug_info[(size_t)j * d.B + lane] = w;
      }
    }
    const int jt0 = __ldg(p.slab_tile0 + y), jt1 = __ldg(p.slab_tile0 + y + 1);
    {
      const uint4* src = reinterpret_cast<const uint4*>(p.gtiles + (size_t)jt0 * p.ksteps * 32);
      uint4* dst = reinterpret_cast<uint4*>(g_s);
      const int n16 = (jt1 - jt0) * p.ksteps * 16;  // 16-byte pieces: 256 bytes a tile
      for (int i = tid; i < n16; i += kDrawThreads) dst[i] = __ldg(src + i);
    }
    __syncthreads();
    // 2. the encode: warp w holds m-tile w % mt (16 lanes) for every k-step
    // and takes the n-tiles j = w / mt (mod 8 / mt) of the slab
    const int warp = tid >> 5, l = tid & 31;
    const int mt = LT / 16, wpm = kDrawWarps / mt;
    const int m = warp % mt;
    const int g = l >> 2, tq = l & 3;
    for (int j = jt0 + warp / mt; j < jt1; j += wpm) {
      int acc[4] = {0, 0, 0, 0};
      for (int s = 0; s < p.ksteps; ++s) {
        const uint32_t* us = u_s + (size_t)(8 * s + tq) * row + 16 * m + g;
        const uint32_t a[4] = {us[0], us[8], us[4 * row], us[4 * row + 8]};
        mma_b1(acc, a, g_s[((size_t)(j - jt0) * p.ksteps + s) * 32 + l]);
      }
      const int col = (j - jt0) * 8 + 2 * tq;
      const int rw = 16 * m + g;
      cw_s[col * LT + rw] = (uint8_t)(acc[0] & 1);
      cw_s[(col + 1) * LT + rw] = (uint8_t)(acc[1] & 1);
      cw_s[col * LT + rw + 8] = (uint8_t)(acc[2] & 1);
      cw_s[(col + 1) * LT + rw + 8] = (uint8_t)(acc[3] & 1);
    }
    __syncthreads();
  }
  if (lane < 0) return;
  const size_t b = (size_t)lane;
  const int rank = idx;
  // 3. the draws, values and stores: (lane, group of 4 items) units; a warp
  // holds consecutive lanes of one group
  if (item_slab) {
    const int gbase = i0 / 4, ng = (i1 - i0 + 3) / 4;
    for (int gi = part; gi < ng; gi += parts) {
      const int grp = gbase + gi;
      curandStatePhilox4_32_10_t st;
      curand_init(seed, b, (unsigned long long)p.kw + 4ull * grp, &st);
      float4 r4;
      if constexpr (CH == CH_AWGN || CH == CH_MASK)
        r4 = curand_normal4(&st);
      else
        r4 = curand_uniform4(&st);
      const float rs[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 4 * grp + e;
        if (t >= i1) break;
        draw_item<CH, MC>(p, d, k, cw_s, u_s, r_lane, b, rank, t, t * p.bpi, rs[e]);
      }
    }
  } else {
    for (int o = o0 + part; o < o1; o += parts) {
      const int v = __ldg(p.other_pos + o);
      const bool shortened = __ldg(p.other_short + o) != 0;
      const int c = column_bit(p, cw_s, u_s, r_lane, p.other_col0 + o);
      if constexpr (CH == CH_BEC)
        k.symbol(v, b, rank, shortened ? (uint8_t)c : kErasedSym);
      else
        k.value(v, b, rank, shortened ? d.shorten : 0.0f);
      k.codeword(v, b, rank, (uint8_t)c);
    }
  }
  if (y == 0 && part == 0) k.drawn(b, rank);
}

// Sum over the block (kScanThreads threads); the result in every thread.
__device__ long long block_sum(long long v, long long* sh) {
  for (int o = 16; o; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  v = threadIdx.x < 32 ? sh[threadIdx.x] : 0;
  if (threadIdx.x < 32)
    for (int o = 16; o; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (threadIdx.x == 0) sh[0] = v;
  __syncthreads();
  v = sh[0];
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(kScanThreads)
pool_plan_kernel(const int* __restrict__ avail, const int* __restrict__ ctr4,
                 const long long* __restrict__ started, long long quota,
                 const int* __restrict__ refill, int watermark, int B, int* __restrict__ ctl,
                 int* __restrict__ remaining, int* __restrict__ lanes) {
  __shared__ long long sh[32];
  __shared__ int sh_scan[32];
  long long a = 0, s = 0;
  for (int i = threadIdx.x; i < B; i += kScanThreads) {
    a += avail[i];
    s += ctr4[i];
  }
  a = block_sum(a, sh);
  s = block_sum(s, sh);
  const bool do_gen = *refill > 0 && (long long)B - a >= (long long)watermark;
  // the used lanes (avail == 0) in lane order, where the pool is drawn
  int carry = 0;
  for (int base0 = 0; do_gen && base0 < B; base0 += kScanRound) {
    const int base = base0 + kScanRun * threadIdx.x;
    uint32_t m = ~nonzero_mask16(avail, base, B) & valid_mask16(base, B);
    int total;
    int at = carry + block_exclusive_scan(__popc(m), &total, sh_scan);
    while (m) {
      const int i = __ffs(m) - 1;
      m &= m - 1;
      lanes[at++] = base + i;
    }
    carry += total;
  }
  if (threadIdx.x == 0) {
    ctl[0] = do_gen;
    ctl[1] = carry;
    long long rem = quota - *started - s;
    rem = rem < 0 ? 0 : rem > kInt32Safe ? kInt32Safe : rem;
    *remaining = (int)rem;
  }
}

// The reload form's plan: the idle lanes (done != 0) in lane order into
// `lanes` (when refill), and count = the lanes to draw: min(idle, quota -
// started) when refill && idle >= gen_threshold, else 0; started += count.
__global__ void __launch_bounds__(kScanThreads)
reload_plan_kernel(const int* __restrict__ done, const int* __restrict__ refill,
                   int* __restrict__ started, long long quota, int gen_threshold, int B,
                   int* __restrict__ count, int* __restrict__ lanes) {
  __shared__ int sh[32];
  const bool on = *refill != 0;
  int carry = 0;  // idle lanes of the earlier rounds
  for (int base0 = 0; on && base0 < B; base0 += kScanRound) {
    const int base = base0 + kScanRun * threadIdx.x;
    uint32_t m = nonzero_mask16(done, base, B);
    int total;
    int at = carry + block_exclusive_scan(__popc(m), &total, sh);
    while (m) {
      const int i = __ffs(m) - 1;
      m &= m - 1;
      lanes[at++] = base + i;
    }
    carry += total;
  }
  if (threadIdx.x == 0) {
    const long long s = *started;
    const long long left = quota - s < 0 ? 0 : quota - s;
    const int n = on && carry >= gen_threshold ? (int)(carry < left ? carry : left) : 0;
    *count = n;
    *started = (int)(s + n);
  }
}

__global__ void __launch_bounds__(kScanThreads)
stream_grant_kernel(const int* __restrict__ done, const int* __restrict__ avail,
                    const int* __restrict__ refill, int* remaining, uint8_t* __restrict__ grant,
                    int B) {
  __shared__ int sh[32];
  const bool on = *refill != 0;
  const int R = max(*remaining, 0);
  int carry = 0;  // eligible lanes of the earlier rounds
  for (int base0 = 0; base0 < B; base0 += kScanRound) {
    const int base = base0 + kScanRun * threadIdx.x;
    const uint32_t m = on ? nonzero_mask16(done, base, B) & nonzero_mask16(avail, base, B) : 0u;
    const int n = __popc(m);
    int total;
    const int before = carry + block_exclusive_scan(n, &total, sh);  // eligible lanes below base
    // lane i (an eligible one) is granted iff before + its rank + 1 <= R
    store_mask16(grant, lowest_set_bits(m, min(n, max(R - before, 0))), base, B);
    carry += total;
  }
  if (threadIdx.x == 0) *remaining = R - min(carry, R);
}

}  // namespace

extern "C" {

// Each returns the launch's cudaGetLastError() (0 = launched).

// ctl[0] = do_gen, ctl[1] = the lanes to draw (0 unless do_gen); lanes
// [B]: its first ctl[1] entries the used lanes in order.
int ldpc_pool_plan(const int* avail, const int* ctr, const long long* started, long long quota,
                   const int* refill, int watermark, int B, int* ctl, int* remaining, int* lanes,
                   void* stream) {
  pool_plan_kernel<<<1, kScanThreads, 0, (cudaStream_t)stream>>>(
      avail, ctr + (size_t)4 * B, started, quota, refill, watermark, B, ctl, remaining, lanes);
  return (int)cudaGetLastError();
}

// Shared memory of a draw block (its info words, the slab's generator
// tiles, its codeword bits).
long long ldpc_pool_draw_bytes(int ksteps, int has_g, int lane_tile, int slab_cols) {
  return (long long)draw_smem_bytes(ksteps, has_g != 0, lane_tile, slab_cols);
}

}  // extern "C"

namespace {

// One launch of the draw into `sink` (PlaneSink or StageSink).
template <class Sink>
int pool_draw(int channel, const uint2* gtiles, const int* slab_tile0, const int* col_src,
              int ksteps, int kwords, int kw, const int* item_src, const int* item_dst,
              int n_items, int bpi, const int* other_pos, const uint8_t* other_short,
              int n_other, int other_col0, const float* points, const float* logp,
              const int* label_of, const int* point_of, int M, int lane_tile,
              int items_per_slab, int others_per_slab, int slab_cols, const int* lanes,
              const int* count, const unsigned long long* key, float* debug,
              uint32_t* debug_info, int B, float sigma, float inv_s2, float two_s2, float delta,
              float eps, float shorten, const Sink& sink, void* stream) {
  if (bpi < 1 || bpi > kMaxBits || (lane_tile != 16 && lane_tile != 32 && lane_tile != 64) ||
      items_per_slab < 8 || items_per_slab % 8 || others_per_slab < 8 || others_per_slab % 8 ||
      other_col0 != n_items * bpi || B < 1 || kwords > 8 * ksteps || slab_cols % 8 ||
      (gtiles && (!slab_tile0 || !col_src)))
    return (int)cudaErrorInvalidValue;
  const int item_slabs = (n_items + items_per_slab - 1) / items_per_slab;
  const int other_slabs = (n_other + others_per_slab - 1) / others_per_slab;
  PoolPlan p{gtiles,    slab_tile0,  col_src,        ksteps,     kwords,         kw,
             item_src,  item_dst,    n_items,        bpi,        other_pos,      other_short,
             n_other,   other_col0,  points,         logp,       label_of,       point_of,
             M,         lane_tile,   items_per_slab, item_slabs, others_per_slab, slab_cols};
  PoolDraw d{lanes, count, key, debug, debug_info, B, sigma, inv_s2, two_s2, delta, eps, shorten};
  if (channel == CH_BEC && !Sink::kSymbols) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((B + lane_tile - 1) / lane_tile), (unsigned)(item_slabs + other_slabs));
  if (grid.y == 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = draw_smem_bytes(ksteps, gtiles != nullptr, lane_tile, slab_cols);
  const dim3 block(kDrawThreads);
  cudaStream_t st = (cudaStream_t)stream;
  switch (channel) {
    case CH_AWGN:
      return launch_smem(pool_draw_kernel<CH_AWGN, 0, Sink>, grid, block, bytes, st, p, d, sink);
    case CH_MASK:
      if (M <= 4)
        return launch_smem(pool_draw_kernel<CH_MASK, 4, Sink>, grid, block, bytes, st, p, d, sink);
      if (M <= kCachedPoints)
        return launch_smem(pool_draw_kernel<CH_MASK, kCachedPoints, Sink>, grid, block, bytes, st,
                           p, d, sink);
      return launch_smem(pool_draw_kernel<CH_MASK, 0, Sink>, grid, block, bytes, st, p, d, sink);
    case CH_BSC:
      return launch_smem(pool_draw_kernel<CH_BSC, 0, Sink>, grid, block, bytes, st, p, d, sink);
    case CH_BEC:
      if constexpr (Sink::kSymbols)
        return launch_smem(pool_draw_kernel<CH_BEC, 0, Sink>, grid, block, bytes, st, p, d, sink);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// `channel`: 0 AWGN (BPSK), 1 AWGN through an M-ASK constellation, 2 BSC,
// 3 BEC.  `fresh` is float32, or u8 for the BEC.  `lanes`/`count` (or null:
// every lane of the batch), `avail` (or null), `debug` ([n_items, B], or
// null) takes each item's draw, `debug_info` ([kwords, B], or null) each
// lane's info words.  Items and other positions are cut into slabs of
// `items_per_slab` items and `others_per_slab` positions (multiples of 8);
// `slab_tile0` and `col_src` (pool_refill.py draw_slabs) give each slab's
// encoded columns, at most `slab_cols` a slab.
int ldpc_pool_draw(int channel, const uint2* gtiles, const int* slab_tile0, const int* col_src,
                   int ksteps, int kwords, int kw, const int* item_src, const int* item_dst,
                   int n_items, int bpi, const int* other_pos, const uint8_t* other_short,
                   int n_other, int other_col0, const float* points, const float* logp,
                   const int* label_of, const int* point_of, int M, int lane_tile,
                   int items_per_slab, int others_per_slab, int slab_cols, void* fresh,
                   uint8_t* fresh_cw, int* avail, const int* lanes, const int* count,
                   const unsigned long long* key,
                   float* debug, uint32_t* debug_info, int B, float sigma, float inv_s2,
                   float two_s2, float delta, float eps, float shorten, void* stream) {
  return pool_draw(channel, gtiles, slab_tile0, col_src, ksteps, kwords, kw, item_src, item_dst,
                   n_items, bpi, other_pos, other_short, n_other, other_col0, points, logp,
                   label_of, point_of, M, lane_tile, items_per_slab, others_per_slab, slab_cols,
                   lanes, count, key, debug, debug_info, B, sigma, inv_s2, two_s2, delta, eps,
                   shorten, PlaneSink{fresh, fresh_cw, avail, (size_t)B}, stream);
}

// The reload form's plan (reload_plan_kernel): count [1], lanes [B].
int ldpc_reload_plan(const int* done, const int* refill, int* started, long long quota,
                     int gen_threshold, int B, int* count, int* lanes, void* stream) {
  reload_plan_kernel<<<1, kScanThreads, 0, (cudaStream_t)stream>>>(
      done, refill, started, quota, gen_threshold, B, count, lanes);
  return (int)cudaGetLastError();
}

// The reload form's draw: ldpc_pool_draw's arguments over the plan's lanes
// (float values only: not the BEC), writing the state planes `fresh` (the
// LLRs), `fresh_cw` (the codewords), lv2c [nnz, B] (through vn_ptr and
// perm_c2v) and done / age / iters [B] of every drawn lane.
int ldpc_pool_reload(int channel, const uint2* gtiles, const int* slab_tile0, const int* col_src,
                     int ksteps, int kwords, int kw, const int* item_src, const int* item_dst,
                     int n_items, int bpi, const int* other_pos, const uint8_t* other_short,
                     int n_other, int other_col0, const float* points, const float* logp,
                     const int* label_of, const int* point_of, int M, int lane_tile,
                     int items_per_slab, int others_per_slab, int slab_cols, void* fresh,
                     uint8_t* fresh_cw, const int* lanes, const int* count,
                     const unsigned long long* key, float* debug, uint32_t* debug_info, int B,
                     float sigma, float inv_s2, float two_s2, float delta, float eps,
                     float shorten, float* lv2c, const int* vn_ptr, const int* perm_c2v,
                     int* done, int* age, int* iters, void* stream) {
  if (!lv2c || !vn_ptr || !perm_c2v || !done || !age || !iters || !lanes || !count)
    return (int)cudaErrorInvalidValue;
  return pool_draw(channel, gtiles, slab_tile0, col_src, ksteps, kwords, kw, item_src, item_dst,
                   n_items, bpi, other_pos, other_short, n_other, other_col0, points, logp,
                   label_of, point_of, M, lane_tile, items_per_slab, others_per_slab, slab_cols,
                   lanes, count, key, debug, debug_info, B, sigma, inv_s2, two_s2, delta, eps,
                   shorten,
                   PlaneSink{fresh, fresh_cw, nullptr, (size_t)B, lv2c, vn_ptr, perm_c2v, done,
                             age, iters},
                   stream);
}

// The staged reload: ldpc_pool_reload's draw over the plan's lanes into the
// staging buffer instead of the planes: the lane of rank r writes column r
// of stage_llr and stage_cw ([nc, S], S >= B, so any plan fits) and
// slot[lane] = r; done / age / iters [B] as there; no first message.
int ldpc_pool_reload_staged(int channel, const uint2* gtiles, const int* slab_tile0,
                            const int* col_src, int ksteps, int kwords, int kw,
                            const int* item_src, const int* item_dst, int n_items, int bpi,
                            const int* other_pos, const uint8_t* other_short, int n_other,
                            int other_col0, const float* points, const float* logp,
                            const int* label_of, const int* point_of, int M, int lane_tile,
                            int items_per_slab, int others_per_slab, int slab_cols,
                            float* stage_llr, uint8_t* stage_cw, int S, const int* lanes,
                            const int* count, const unsigned long long* key, float* debug,
                            uint32_t* debug_info, int B, float sigma, float inv_s2, float two_s2,
                            float delta, float eps, float shorten, int* slot, int* done, int* age,
                            int* iters, void* stream) {
  if (!stage_llr || !stage_cw || S < B || !slot || !done || !age || !iters || !lanes || !count)
    return (int)cudaErrorInvalidValue;
  return pool_draw(channel, gtiles, slab_tile0, col_src, ksteps, kwords, kw, item_src, item_dst,
                   n_items, bpi, other_pos, other_short, n_other, other_col0, points, logp,
                   label_of, point_of, M, lane_tile, items_per_slab, others_per_slab, slab_cols,
                   lanes, count, key, debug, debug_info, B, sigma, inv_s2, two_s2, delta, eps,
                   shorten, StageSink{stage_llr, stage_cw, (size_t)S, slot, done, age, iters},
                   stream);
}

int ldpc_stream_grant(const int* done, const int* avail, const int* refill, int* remaining,
                      uint8_t* grant, int B, void* stream) {
  stream_grant_kernel<<<1, kScanThreads, 0, (cudaStream_t)stream>>>(done, avail, refill,
                                                                    remaining, grant, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
