// Flooding BP decode kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of libldpc_tpu/ops/pallas/decode_fused.py:
//   * bp_decode_fused_kernel      <- `kernel`        (via bp_decode_pallas)
//   * bp_stream_chunk_fused_kernel <- `kernel_stream` (via bp_stream_chunk_pallas),
//     on the chunk shared with the BEC stream kernel (stream_chunk.cuh)
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
#include "stream_chunk.cuh"

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

// The BP pass of the streaming chunk (stream_chunk.cuh): CN phase, VN
// phase, and the syndrome of the posterior's decisions.
struct BpStreamPass {
  using T = float;
  CnParams cp;
  float* lc2v;  // [nnz, B] scratch
  __device__ void cn(const Code& c, const float* lv2c, size_t B, size_t b) const {
    cn_phase(c, cp, lv2c, lc2v, B, b);
  }
  __device__ void vn(const Code& c, const float* prior, const uint8_t*, float* lv2c, float* post,
                     size_t B, size_t b, volatile int*) const {
    vn_phase(c, prior, lv2c, lc2v, post, B, b);
  }
  __device__ void check(const Code& c, const float* post, size_t B, size_t b,
                        volatile int* flag) const {
    syndrome_part(c, post, B, b, flag);
  }
  __device__ bool bit_error(float p, uint8_t cw) const { return (p <= 0.0f) != (cw != 0); }
};

// k self-refilling BP passes per lane (see `kernel_stream`).
__global__ void __launch_bounds__(LDPC_FRAMES * LDPC_WARPS)
bp_stream_chunk_fused_kernel(Code c, BpStreamPass pass, StreamArgs<float> s, int B, int k,
                             int cap) {
  stream_chunk(c, pass, s, B, k, cap);
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
  BpStreamPass pass{CnParams{cn_mode, scale, offset}, lc2v};
  StreamArgs<float> s{llr,       cw,       lv2c,      done, iters, age,     avail, ctr,
                      fresh_llr, fresh_cw, refill, remaining, post, bit_pos, nct};
  bp_stream_chunk_fused_kernel<<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>(c, pass, s, B, k,
                                                                                 cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
