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

#include "bp_phases.cuh"
#include "cn_forms.cuh"

namespace {

// CN phase over this warp's checks: lv2c -> lc2v.
__device__ void cn_phase(const Code& c, const CnParams& cp, const float* __restrict__ lv2c,
                         float* __restrict__ lc2v, size_t B, size_t b) {
  for (int r = threadIdx.y; r < c.mc; r += blockDim.y) {
    int e0 = __ldg(c.row_ptr + r);
    int d = __ldg(c.row_ptr + r + 1) - e0;
    if (d > 0) check_update(cp, lv2c, lc2v, e0, d, B, b);
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
