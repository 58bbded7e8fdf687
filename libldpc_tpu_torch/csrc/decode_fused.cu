// Flooding BP decode kernels for Hopper (sm_90a): the HBM-plane forms.
//
// Replaces the TPU kernels of libldpc_tpu/ops/pallas/decode_fused.py:
//   * bp_decode_fused_kernel      <- `kernel`        (via bp_decode_pallas), this file;
//     its tile form, a block's frames on chip for the whole decode, is
//     flood_stream.cuh (decode_fused_tile*.cu); this form serves a code whose
//     tile does not fit (ops/kernels/decode_fused.py flood_form)
//   * bp_stream_chunk_fused_kernel <- `kernel_stream` (via bp_stream_chunk_pallas),
//     in decode_stream.cu (a file of its own, so the two compile side by
//     side), on the chunk shared with the BEC stream kernel (stream_chunk.cuh)
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
// What bounds it: per-slot instruction count and dependent loads, not the
// message planes' device-memory traffic, as first modelled.  Per frame and iteration the CN phase reads lv2c and writes lc2v,
// the VN phase reads lc2v (twice), the prior, and writes the posterior and
// lv2c, and the syndrome reads the posterior at each CN slot: ~6 planes of
// E x 4 bytes (E = nnz), ~83 KB per frame-iteration for the 1152-node (3,6)
// code, far more than the 50 MB L2 holds at B = 16384.  But on an H100 SXM
// (700 W limit) 50 min-sum iterations of that code at B = 16384 take the same
// 28.5-29.0 ms with 4-, 2- and 1-byte messages (the forms below), so the
// planes' bytes do not set the time.  The check combine keeps its inputs and
// prefixes in registers (cn_forms.cuh: unrolled up to degree LDPC_UNROLL_DC,
// a form without per-degree storage past it, so no check degree is refused)
// and each kernel is compiled per CN family, so the inner loops carry no
// mode test; what remains are the index loads each message load waits on.
// Beyond that the design only coalesces and skips finished frames (a block
// stops iterating once all of its frames are done, a finished frame makes no
// loads, and the syndrome stops at the first unsatisfied check).
//
// Exactness: the file is built with -fmad=false and without fast math, and
// the arithmetic follows the plain PyTorch versions operation for operation
// (association order of the combine, left-to-right VN sums, float32
// constants), so the min-sum family is bit-exact against them.
//
// Message forms: each kernel is instantiated for float32, bfloat16 and int8
// message storage (the `message_dtype` of the TPU kernels; traits in
// cn_forms.cuh, store points in bp_phases.cuh and ops/messages.py).  The
// messages (lv2c, lc2v) and the posterior plane take the storage type; the
// channel prior and the stream's pool stay float32.  Arithmetic stays
// float32, so a sub-32-bit form changes only the bytes a plane moves: 2 or
// 1 per slot instead of 4 (a warp's row load is 64 or 32 bytes, two or one
// 32-byte sectors, for the same number of load instructions).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bp_phases.cuh"
#include "cn_forms.cuh"
#include "dispatch.cuh"

namespace {

// Every thread of a frame keeps the frame's control state (done, iters, ...)
// in registers and updates it identically; the __syncthreads below are
// reached by every thread of the block on every pass.  `post` is the stored
// posterior (the output, in the storage type: the wrapper widens it).
template <class Msg, int FAM>
__global__ void __launch_bounds__(LDPC_FRAMES * LDPC_WARPS)
bp_decode_fused_kernel(Code c, CnParams cp, Msg m, const float* __restrict__ llr_in,
                       typename Msg::T* __restrict__ post, int* __restrict__ iters_out,
                       int* __restrict__ iscw_out, typename Msg::T* __restrict__ lv2c,
                       typename Msg::T* __restrict__ lc2v, int B_, int iterations,
                       int early_term) {
  __shared__ int bad[LDPC_FRAMES];
  const size_t B = B_;
  const size_t b = (size_t)blockIdx.x * LDPC_FRAMES + threadIdx.x;
  const bool valid = b < B;
  const bool lead = threadIdx.y == 0;
  if (valid)
    for (int e = threadIdx.y; e < c.nnz; e += blockDim.y)
      lv2c[e * B + b] = m.store(m.prior(llr_in[__ldg(c.col_sorted + e) * B + b]));
  bool done = !valid;
  int iters = 0, iscw = 0;
  __syncthreads();
  for (int it = 0; it < iterations; ++it) {
    // block-level exit once every frame of the block has converged
    if (early_term && !__syncthreads_or(!done)) break;
    const bool check = !done && (early_term || it == iterations - 1);
    if (!done) cn_phase<FAM>(c, cp, m, lv2c, lc2v, B, b);
    __syncthreads();
    if (lead) bad[threadIdx.x] = 0;
    if (!done) vn_phase(c, m, llr_in, lv2c, lc2v, post, B, b);
    __syncthreads();
    if (check) syndrome_part(c, m, post, B, b, bad);
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

}  // namespace

extern "C" {

const char* ldpc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Each returns the launch's cudaGetLastError() (0 = launched).  The
// message planes (lv2c, lc2v, and the posterior `post`) are of the type of
// `msg_dtype`; `inv_q` is the int8 lattice's prior factor (unused
// otherwise).

int ldpc_bp_decode_fused(const float* llr_in, void* post, int* iters, int* iscw, void* lv2c,
                         void* lc2v, const int* row_ptr, const int* col_sorted,
                         const int* vn_ptr, const int* perm_c2v, int nc, int mc, int nnz, int B,
                         int iterations, int early_term, int cn_mode, float scale, float offset,
                         int msg_dtype, float inv_q, void* stream) {
  Code c{row_ptr, col_sorted, vn_ptr, perm_c2v, nc, mc, nnz};
  CnParams cp{cn_mode, scale, offset};
  return by_form(msg_dtype, inv_q, cn_mode, [&](auto m, auto fam) {
    using Msg = decltype(m);
    using T = typename Msg::T;
    bp_decode_fused_kernel<Msg, decltype(fam)::value>
        <<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>(c, cp, m, llr_in, (T*)post, iters, iscw,
                                                           (T*)lv2c, (T*)lc2v, B, iterations,
                                                           early_term);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
