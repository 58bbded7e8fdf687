// Flooding BP decode kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of libldpc_tpu/ops/pallas/decode_fused.py:
//   * bp_decode_fused_kernel      <- `kernel`        (via bp_decode_pallas)
//   * bp_stream_chunk_fused_kernel <- `kernel_stream` (via bp_stream_chunk_pallas)
// They compute what those kernels compute: the CN exclusion combine in every
// CN form, the CN->VN and VN->CN edge permutations, the VN posterior sums,
// the extrinsic `q - lc2v`, the syndrome of `llr <= 0` decisions and
// per-frame early termination with break-before-increment iteration counts;
// the stream kernel adds the in-kernel reload from a fresh-frame pool, an
// exact global start quota and the per-lane counters.  The TPU's Beneš/Clos/
// one-hot transports are not carried over: here a permutation is an indexed
// load from a static table (row_ptr, col_sorted, vn_ptr, perm_c2v).
//
// Layout: every plane is [rows, B] with the frame index fastest.  A block
// holds 32 frames, one per lane, so a warp's loads of one edge row are 32
// consecutive floats (one 128-byte transaction); its 8 warps split each phase
// (checks, variables, syndrome checks) between them, with a __syncthreads
// between phases.  One thread per frame alone would give B = 16384 frames only
// ~124 threads per SM, too few to hide HBM latency (measured on an H100 SXM
// at its 700 W limit: 185 ms per 50-iteration decode of the 1152 code, 40 ms
// with 8 warps per frame); splitting each frame over 8 warps gives each SM
// ~31 warps.  Index tables are read through __ldg; all
// lanes of a warp read the same entry, so they are broadcast loads.
//
// What bounds it: device-memory traffic.  Per frame and iteration the CN phase
// reads lv2c and writes lc2v, the VN phase reads lc2v (twice), the prior, and
// writes the posterior and lv2c, and the syndrome reads the posterior at each
// CN slot: ~6 planes of E x 4 bytes (E = nnz), ~83 KB per frame-iteration for
// the 1152-node (3,6) code.  At B = 16384 a plane (3456 x 16384 x 4 B = 226 MB)
// is far larger than the 50 MB L2, so the planes stream from HBM.  This first
// design does nothing more about it than coalescing and skipping finished
// frames (a block stops iterating once all of its frames are done, a finished
// frame issues no loads, and the syndrome stops at the first unsatisfied
// check); keeping messages in shared memory or registers across phases is
// later work.
//
// Exactness: the file is built with -fmad=false and without fast math, and
// the arithmetic follows the plain PyTorch versions operation for operation
// (association order of the combine, left-to-right VN sums, float32
// constants), so the min-sum family is bit-exact against them.

#include <cuda_runtime.h>
#include <stdint.h>

#define LDPC_MAX_DC 32
#define LDPC_FRAMES 32  // frames per block: one per lane of a warp
#define LDPC_WARPS 8    // warps per block, splitting each phase

namespace {

constexpr float kPadLLR = 1e30f;
constexpr float kTanhClip = 0.99999994f;  // nextafter(1, 0) in float32
constexpr float kPhiSumFloor = 1e-30f;

// CN forms, in the order of ops/kernels/decode_fused.py CN_MODES
enum CnMode { BP = 0, BP_MS = 1, BP_LIN = 2, BP_NMS = 3, BP_OMS = 4, BP_TANH = 5, BP_PHI = 6 };

struct Code {
  const int* __restrict__ row_ptr;     // [mc + 1]
  const int* __restrict__ col_sorted;  // [nnz]
  const int* __restrict__ vn_ptr;      // [nc + 1]
  const int* __restrict__ perm_c2v;    // [nnz]
  int nc, mc, nnz;
};

struct CnParams {
  int mode;
  float scale, offset;
};

__device__ __forceinline__ float sgn(float x) { return signbit(x) ? -1.0f : 1.0f; }

__device__ __forceinline__ float softplus_neg(float a) { return log1pf(expf(-a)); }

__device__ __forceinline__ float lin_approx(float L) {
  float a = fabsf(L);
  return a < 1.0f ? -0.375f * a + 0.6825f : (a < 2.625f ? -0.1875f * a + 0.5f : 0.0f);
}

__device__ __forceinline__ float pair_op(int mode, float x, float y) {
  float m = fminf(fabsf(x), fabsf(y));
  float s = sgn(x) * sgn(y) * m;
  if (mode == BP_MS || mode == BP_NMS || mode == BP_OMS) return s;
  if (mode == BP_LIN) return s + lin_approx(x + y) - lin_approx(x - y);
  return s + (softplus_neg(fabsf(x + y)) - softplus_neg(fabsf(x - y)));
}

__device__ __forceinline__ float tanh_post(float t) {
  float p = fminf(fmaxf(t, -kTanhClip), kTanhClip);
  return log1pf(p) - log1pf(-p);
}

__device__ __forceinline__ float phi(float x) {
  float e = expf(-fmaxf(x, 1e-6f));
  return log1pf(e) - log1pf(-e);
}

__device__ __forceinline__ float phi_out(float s) {
  return -logf(tanhf(fmaxf(s, kPhiSumFloor) * 0.5f));
}

__device__ __forceinline__ float postprocess(const CnParams& cp, float v) {
  if (cp.mode == BP_NMS) return v * cp.scale;
  if (cp.mode == BP_OMS) return sgn(v) * fmaxf(fabsf(v) - cp.offset, 0.0f);
  return v;
}

// The exclusion combine of one check of degree d (2 <= d <= LDPC_MAX_DC)
// for frame b: out[j] = combine of every input but j, from forward prefixes
// f[j] = op(f[j-1], M[j]) and a running backward prefix, in the association
// order of ops/cn_ops.py exclusion_combine (out[j] = op(f[j-1], bwd), bwd
// grown as op(bwd, M[j])).
__device__ void check_update(const CnParams& cp, const float* __restrict__ lv2c,
                             float* __restrict__ lc2v, int e0, int d, size_t B, size_t b) {
  float M[LDPC_MAX_DC];
  float F[LDPC_MAX_DC];
  if (d == 1) {
    lc2v[e0 * B + b] = postprocess(cp, kPadLLR);
    return;
  }
  if (cp.mode == BP_PHI) {
    // sign chains (products of +-1) and magnitude chains (sums of phi(|x|))
    float S[LDPC_MAX_DC];
    float FS[LDPC_MAX_DC];
    for (int j = 0; j < d; ++j) {
      float x = lv2c[(e0 + j) * B + b];
      S[j] = sgn(x);
      M[j] = phi(fabsf(x));
    }
    FS[0] = S[0];
    F[0] = M[0];
    for (int j = 1; j < d; ++j) {
      FS[j] = FS[j - 1] * S[j];
      F[j] = F[j - 1] + M[j];
    }
    float bs = S[d - 1], ba = M[d - 1];
    lc2v[(e0 + d - 1) * B + b] = postprocess(cp, FS[d - 2] * phi_out(F[d - 2]));
    for (int j = d - 2; j >= 1; --j) {
      lc2v[(e0 + j) * B + b] = postprocess(cp, FS[j - 1] * bs * phi_out(F[j - 1] + ba));
      bs = bs * S[j];
      ba = ba + M[j];
    }
    lc2v[e0 * B + b] = postprocess(cp, bs * phi_out(ba));
    return;
  }
  const bool tanh_form = cp.mode == BP_TANH;
  for (int j = 0; j < d; ++j) {
    float x = lv2c[(e0 + j) * B + b];
    M[j] = tanh_form ? tanhf(x * 0.5f) : x;
  }
  F[0] = M[0];
  for (int j = 1; j < d; ++j) F[j] = tanh_form ? F[j - 1] * M[j] : pair_op(cp.mode, F[j - 1], M[j]);
  float bwd = M[d - 1];
  float o = F[d - 2];
  lc2v[(e0 + d - 1) * B + b] = postprocess(cp, tanh_form ? tanh_post(o) : o);
  for (int j = d - 2; j >= 1; --j) {
    o = tanh_form ? F[j - 1] * bwd : pair_op(cp.mode, F[j - 1], bwd);
    lc2v[(e0 + j) * B + b] = postprocess(cp, tanh_form ? tanh_post(o) : o);
    bwd = tanh_form ? bwd * M[j] : pair_op(cp.mode, bwd, M[j]);
  }
  lc2v[e0 * B + b] = postprocess(cp, tanh_form ? tanh_post(bwd) : bwd);
}

// The warps of a block split each phase between them: warp w of the block
// takes checks (or variables, or transmitted bits) w, w + W, w + 2W, ...
// for the block's 32 frames, one frame per lane.

// CN phase over this warp's checks: lv2c -> lc2v.
__device__ void cn_phase(const Code& c, const CnParams& cp, const float* __restrict__ lv2c,
                         float* __restrict__ lc2v, size_t B, size_t b) {
  for (int r = threadIdx.y; r < c.mc; r += blockDim.y) {
    int e0 = __ldg(c.row_ptr + r);
    int d = __ldg(c.row_ptr + r + 1) - e0;
    if (d > 0) check_update(cp, lv2c, lc2v, e0, d, B, b);
  }
}

// VN phase over this warp's variables: posterior = prior + (m0 + m1 + ...),
// extrinsic lv2c = posterior - lc2v at each of the variable's edges.
__device__ void vn_phase(const Code& c, const float* __restrict__ prior,
                         float* __restrict__ lv2c, const float* __restrict__ lc2v,
                         float* __restrict__ post, size_t B, size_t b) {
  for (int v = threadIdx.y; v < c.nc; v += blockDim.y) {
    int s0 = __ldg(c.vn_ptr + v);
    int s1 = __ldg(c.vn_ptr + v + 1);
    float llr = prior[v * B + b];
    if (s1 > s0) {
      float tot = lc2v[__ldg(c.perm_c2v + s0) * B + b];
      for (int s = s0 + 1; s < s1; ++s) tot = tot + lc2v[__ldg(c.perm_c2v + s) * B + b];
      llr = llr + tot;
    }
    post[v * B + b] = llr;
    for (int s = s0; s < s1; ++s) {
      size_t e = __ldg(c.perm_c2v + s) * B + b;
      lv2c[e] = llr - lc2v[e];
    }
  }
}

// Sets bad[lane] when one of this warp's checks is unsatisfied by the
// decisions post <= 0; stops at the first such check, or as soon as another
// warp has found one for this frame.
__device__ void syndrome_part(const Code& c, const float* __restrict__ post, size_t B, size_t b,
                              volatile int* bad) {
  for (int r = threadIdx.y; r < c.mc; r += blockDim.y) {
    if (bad[threadIdx.x]) return;
    int e1 = __ldg(c.row_ptr + r + 1);
    int parity = 0;
    for (int e = __ldg(c.row_ptr + r); e < e1; ++e)
      parity ^= post[__ldg(c.col_sorted + e) * B + b] <= 0.0f ? 1 : 0;
    if (parity) {
      bad[threadIdx.x] = 1;
      return;
    }
  }
}

// Every thread of a frame keeps the frame's control state (done, iters, ...)
// in registers and updates it identically; the __syncthreads below are
// reached by every thread of the block on every pass.
__global__ void __launch_bounds__(LDPC_FRAMES * LDPC_WARPS)
bp_decode_fused_kernel(Code c, CnParams cp, const float* __restrict__ llr_in,
                       float* __restrict__ llr_out, int* __restrict__ iters_out,
                       int* __restrict__ iscw_out, float* __restrict__ lv2c,
                       float* __restrict__ lc2v, int B_, int iterations, int early_term) {
  __shared__ int bad[LDPC_FRAMES];
  const size_t B = B_;
  const size_t b = (size_t)blockIdx.x * LDPC_FRAMES + threadIdx.x;
  const bool valid = b < B;
  const bool lead = threadIdx.y == 0;
  if (valid)
    for (int e = threadIdx.y; e < c.nnz; e += blockDim.y)
      lv2c[e * B + b] = llr_in[__ldg(c.col_sorted + e) * B + b];
  bool done = !valid;
  int iters = 0, iscw = 0;
  __syncthreads();
  for (int it = 0; it < iterations; ++it) {
    // block-level exit once every frame of the block has converged
    if (early_term && !__syncthreads_or(!done)) break;
    const bool check = !done && (early_term || it == iterations - 1);
    if (!done) cn_phase(c, cp, lv2c, lc2v, B, b);
    __syncthreads();
    if (lead) bad[threadIdx.x] = 0;
    if (!done) vn_phase(c, llr_in, lv2c, lc2v, llr_out, B, b);
    __syncthreads();
    if (check) syndrome_part(c, llr_out, B, b, bad);
    __syncthreads();
    if (check) {
      const bool ok = !bad[threadIdx.x];
      if (!early_term) {
        iscw = ok;
      } else if (ok) {
        // a converged frame keeps this pass's posterior and is not counted
        done = true;
        iscw = 1;
      } else {
        ++iters;
      }
    }
  }
  if (valid && lead) {
    iters_out[b] = early_term ? iters : iterations;
    iscw_out[b] = iscw;
  }
}

// k self-refilling passes per lane (see `kernel_stream`): reload phase, one
// BP pass over the lane if it holds a frame, then counting at the pass that
// finishes the frame.  Counter rows: 0 bit errors (transmitted bits only),
// 1 frame errors, 2 frames, 3 iteration sum, 4 starts.
__global__ void __launch_bounds__(LDPC_FRAMES * LDPC_WARPS)
bp_stream_chunk_fused_kernel(Code c, CnParams cp, float* __restrict__ llr,
                             uint8_t* __restrict__ cw, float* __restrict__ lv2c,
                             int* __restrict__ done_p, int* __restrict__ iters_p,
                             int* __restrict__ age_p, int* __restrict__ avail_p,
                             int* __restrict__ ctr, const float* __restrict__ fresh_llr,
                             const uint8_t* __restrict__ fresh_cw, const int* __restrict__ refill,
                             int* remaining, float* __restrict__ lc2v,
                             float* __restrict__ post, const int* __restrict__ bit_pos, int nct,
                             int B_, int k, int cap) {
  __shared__ int flag[LDPC_FRAMES];  // start granted, then check unsatisfied
  __shared__ int berr[LDPC_FRAMES];  // bit errors of a finishing frame
  const size_t B = B_;
  const size_t b = (size_t)blockIdx.x * LDPC_FRAMES + threadIdx.x;
  const bool valid = b < B;
  const bool lead = threadIdx.y == 0;
  int done = 1, iters = 0, age = 0, avail = 0;
  if (valid) {
    done = done_p[b];
    iters = iters_p[b];
    age = age_p[b];
    avail = avail_p[b];
  }
  const bool refill_on = *refill != 0;
  int n_bit = 0, n_frame_err = 0, n_frames = 0, n_iter = 0, n_start = 0;
  for (int pass = 0; pass < k; ++pass) {
    // ---- reload: an idle lane with an unused pool entry takes a ticket
    // against the global quota; it starts iff the ticket is below the
    // remaining count (so starts never exceed the quota, in any block order)
    const bool want = valid && refill_on && done && avail;
    if (lead)
      flag[threadIdx.x] =
          want && *(volatile int*)remaining > 0 && atomicSub(remaining, 1) > 0;
    __syncthreads();
    if (flag[threadIdx.x]) {
      for (int v = threadIdx.y; v < c.nc; v += blockDim.y) {
        llr[v * B + b] = fresh_llr[v * B + b];
        cw[v * B + b] = fresh_cw[v * B + b];
      }
      // warm-up-free reload: lv2c = prior at each CN slot, so the next pass
      // is iteration 1 (age 1, check-eligible)
      for (int e = threadIdx.y; e < c.nnz; e += blockDim.y)
        lv2c[e * B + b] = fresh_llr[__ldg(c.col_sorted + e) * B + b];
      done = 0;
      age = 1;
      iters = 0;
      avail = 0;
      ++n_start;
    }
    const bool work = !done || (want && *(volatile int*)remaining > 0);
    if (!__syncthreads_or(work)) break;  // also orders the reload copy
    // ---- one BP pass; checks only once the warm-up pass is behind
    const bool run = !done;
    const bool checking = run && age >= 1;
    if (run) cn_phase(c, cp, lv2c, lc2v, B, b);
    __syncthreads();
    if (lead) {
      flag[threadIdx.x] = 0;
      berr[threadIdx.x] = 0;
    }
    if (run) vn_phase(c, llr, lv2c, lc2v, post, B, b);
    __syncthreads();
    if (checking) syndrome_part(c, post, B, b, flag);
    __syncthreads();
    bool newly = false;
    if (checking) {
      newly = !flag[threadIdx.x];
      if (!newly) ++iters;
    }
    if (run) ++age;
    const bool finish = run && (newly || age >= cap + 1);
    if (finish) {
      // count at the finishing pass: the decisions of first convergence (or
      // of the iteration cap), transmitted bits only
      int be = 0;
      for (int t = threadIdx.y; t < nct; t += blockDim.y) {
        size_t v = __ldg(bit_pos + t) * B + b;
        be += (post[v] <= 0.0f) != (cw[v] != 0);
      }
      if (be) atomicAdd(&berr[threadIdx.x], be);
    }
    __syncthreads();
    if (finish) {
      const int be = berr[threadIdx.x];
      done = 1;
      n_bit += be;
      n_frame_err += be > 0;
      n_frames += 1;
      n_iter += iters;
    }
  }
  if (valid && lead) {
    done_p[b] = done;
    iters_p[b] = iters;
    age_p[b] = age;
    avail_p[b] = avail;
    ctr[0 * B + b] += n_bit;
    ctr[1 * B + b] += n_frame_err;
    ctr[2 * B + b] += n_frames;
    ctr[3 * B + b] += n_iter;
    ctr[4 * B + b] += n_start;
  }
}

inline unsigned grid_for(int B) { return (unsigned)((B + LDPC_FRAMES - 1) / LDPC_FRAMES); }
const dim3 kBlock(LDPC_FRAMES, LDPC_WARPS);

}  // namespace

extern "C" {

int ldpc_max_dc() { return LDPC_MAX_DC; }

const char* ldpc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Returns the launch's cudaGetLastError() (0 = launched).
int ldpc_bp_decode_fused(const float* llr_in, float* llr_out, int* iters, int* iscw, float* lv2c,
                         float* lc2v, const int* row_ptr, const int* col_sorted,
                         const int* vn_ptr, const int* perm_c2v, int nc, int mc, int nnz, int B,
                         int iterations, int early_term, int cn_mode, float scale, float offset,
                         void* stream) {
  Code c{row_ptr, col_sorted, vn_ptr, perm_c2v, nc, mc, nnz};
  CnParams cp{cn_mode, scale, offset};
  bp_decode_fused_kernel<<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>(
      c, cp, llr_in, llr_out, iters, iscw, lv2c, lc2v, B, iterations, early_term);
  return (int)cudaGetLastError();
}

int ldpc_bp_stream_chunk_fused(float* llr, uint8_t* cw, float* lv2c, int* done, int* iters,
                               int* age, int* avail, int* ctr, const float* fresh_llr,
                               const uint8_t* fresh_cw, const int* refill, int* remaining,
                               float* lc2v, float* post, const int* row_ptr,
                               const int* col_sorted, const int* vn_ptr, const int* perm_c2v,
                               const int* bit_pos, int nc, int mc, int nnz, int nct, int B, int k,
                               int cap, int cn_mode, float scale, float offset, void* stream) {
  Code c{row_ptr, col_sorted, vn_ptr, perm_c2v, nc, mc, nnz};
  CnParams cp{cn_mode, scale, offset};
  bp_stream_chunk_fused_kernel<<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>(
      c, cp, llr, cw, lv2c, done, iters, age, avail, ctr, fresh_llr, fresh_cw, refill, remaining,
      lc2v, post, bit_pos, nct, B, k, cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
