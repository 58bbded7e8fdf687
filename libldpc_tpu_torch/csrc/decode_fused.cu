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
// What bounds it: not the message planes' device-memory traffic, as first
// modelled.  Per frame and iteration the CN phase reads lv2c and writes lc2v,
// the VN phase reads lc2v (twice), the prior, and writes the posterior and
// lv2c, and the syndrome reads the posterior at each CN slot: ~6 planes of
// E x 4 bytes (E = nnz), ~83 KB per frame-iteration for the 1152-node (3,6)
// code, far more than the 50 MB L2 holds at B = 16384.  But on an H100 SXM
// (700 W limit) 50 min-sum iterations of that code at B = 16384 take the same
// 28.5-29.0 ms with 4-, 2- and 1-byte messages (the forms below), so the
// planes' bytes do not set the time; the per-thread combine arrays
// (M[]/F[] of check_combine: 512 bytes of local memory per thread) and the
// index loads each message load waits on are the suspects.  This first design
// does nothing more than coalescing and skipping finished frames (a block
// stops iterating once all of its frames are done, a finished frame issues no
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
#include "stream_chunk.cuh"

namespace {

// CN phase over this warp's checks: lv2c -> lc2v, in the storage form Msg.
template <class Msg>
__device__ void cn_phase(const Code& c, const CnParams& cp, const Msg& m,
                         const typename Msg::T* __restrict__ lv2c,
                         typename Msg::T* __restrict__ lc2v, size_t B, size_t b) {
  for (int r = threadIdx.y; r < c.mc; r += blockDim.y) {
    int e0 = __ldg(c.row_ptr + r);
    int d = __ldg(c.row_ptr + r + 1) - e0;
    if (d > 0) check_update(cp, m, lv2c, lc2v, e0, d, B, b);
  }
}

// Every thread of a frame keeps the frame's control state (done, iters, ...)
// in registers and updates it identically; the __syncthreads below are
// reached by every thread of the block on every pass.  `post` is the stored
// posterior (the output, in the storage type: the wrapper widens it).
template <class Msg>
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
    if (!done) cn_phase(c, cp, m, lv2c, lc2v, B, b);
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

// The BP pass of the streaming chunk (stream_chunk.cuh): CN phase, VN
// phase, and the syndrome of the stored posterior's decisions; the prior and
// the pool are raw float32 LLRs, and a reload stores each slot's prior in
// the message form, as the batch kernel starts.
template <class Msg>
struct BpStreamPass {
  using V = float;
  using M = typename Msg::T;
  CnParams cp;
  Msg m;
  M* lc2v;  // [nnz, B] scratch
  __device__ void cn(const Code& c, const M* lv2c, size_t B, size_t b) const {
    cn_phase(c, cp, m, lv2c, lc2v, B, b);
  }
  __device__ void vn(const Code& c, const float* prior, const uint8_t*, M* lv2c, M* post,
                     size_t B, size_t b, volatile int*) const {
    vn_phase(c, m, prior, lv2c, lc2v, post, B, b);
  }
  __device__ void check(const Code& c, const M* post, size_t B, size_t b,
                        volatile int* flag) const {
    syndrome_part(c, m, post, B, b, flag);
  }
  __device__ bool bit_error(M p, uint8_t cw) const { return (m.load(p) <= 0.0f) != (cw != 0); }
  __device__ M reload(float x) const { return m.store(m.prior(x)); }
};

// k self-refilling BP passes per lane (see `kernel_stream`).
template <class Msg>
__global__ void __launch_bounds__(LDPC_FRAMES * LDPC_WARPS)
bp_stream_chunk_fused_kernel(Code c, BpStreamPass<Msg> pass,
                             StreamArgs<float, typename Msg::T> s, int B, int k, int cap) {
  stream_chunk(c, pass, s, B, k, cap);
}

template <class Msg>
int launch_decode(const Code& c, const CnParams& cp, const Msg& m, const float* llr_in,
                  void* post, int* iters, int* iscw, void* lv2c, void* lc2v, int B,
                  int iterations, int early_term, cudaStream_t stream) {
  using T = typename Msg::T;
  bp_decode_fused_kernel<Msg><<<grid_for(B), kBlock, 0, stream>>>(
      c, cp, m, llr_in, (T*)post, iters, iscw, (T*)lv2c, (T*)lc2v, B, iterations, early_term);
  return (int)cudaGetLastError();
}

template <class Msg>
int launch_stream(const Code& c, const CnParams& cp, const Msg& m, float* llr, uint8_t* cw,
                  void* lv2c, int* done, int* iters, int* age, int* avail, int* ctr,
                  const float* fresh_llr, const uint8_t* fresh_cw, const int* refill,
                  int* remaining, void* lc2v, void* post, const int* bit_pos, int nct, int B,
                  int k, int cap, cudaStream_t stream) {
  using T = typename Msg::T;
  BpStreamPass<Msg> pass{cp, m, (T*)lc2v};
  StreamArgs<float, T> s{llr,       cw,       (T*)lv2c, done,      iters,    age,
                         avail,     ctr,      fresh_llr, fresh_cw, refill,   remaining,
                         (T*)post,  bit_pos,  nct};
  bp_stream_chunk_fused_kernel<Msg><<<grid_for(B), kBlock, 0, stream>>>(c, pass, s, B, k, cap);
  return (int)cudaGetLastError();
}

// Message dtype codes (ops/messages.py DTYPE_CODES)
enum MsgDtype { MSG_F32 = 0, MSG_BF16 = 1, MSG_INT8 = 2 };

}  // namespace

extern "C" {

int ldpc_max_dc() { return LDPC_MAX_DC; }

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
  cudaStream_t st = (cudaStream_t)stream;
  switch (msg_dtype) {
    case MSG_F32:
      return launch_decode(c, cp, F32Msg{}, llr_in, post, iters, iscw, lv2c, lc2v, B,
                           iterations, early_term, st);
    case MSG_BF16:
      return launch_decode(c, cp, Bf16Msg{}, llr_in, post, iters, iscw, lv2c, lc2v, B,
                           iterations, early_term, st);
    case MSG_INT8:
      return launch_decode(c, cp, Int8Msg{inv_q}, llr_in, post, iters, iscw, lv2c, lc2v, B,
                           iterations, early_term, st);
  }
  return (int)cudaErrorInvalidValue;
}

int ldpc_bp_stream_chunk_fused(float* llr, uint8_t* cw, void* lv2c, int* done, int* iters,
                               int* age, int* avail, int* ctr, const float* fresh_llr,
                               const uint8_t* fresh_cw, const int* refill, int* remaining,
                               void* lc2v, void* post, const int* row_ptr, const int* col_sorted,
                               const int* vn_ptr, const int* perm_c2v, const int* bit_pos, int nc,
                               int mc, int nnz, int nct, int B, int k, int cap, int cn_mode,
                               float scale, float offset, int msg_dtype, float inv_q,
                               void* stream) {
  Code c{row_ptr, col_sorted, vn_ptr, perm_c2v, nc, mc, nnz};
  CnParams cp{cn_mode, scale, offset};
  cudaStream_t st = (cudaStream_t)stream;
  switch (msg_dtype) {
    case MSG_F32:
      return launch_stream(c, cp, F32Msg{}, llr, cw, lv2c, done, iters, age, avail, ctr,
                           fresh_llr, fresh_cw, refill, remaining, lc2v, post, bit_pos, nct, B,
                           k, cap, st);
    case MSG_BF16:
      return launch_stream(c, cp, Bf16Msg{}, llr, cw, lv2c, done, iters, age, avail, ctr,
                           fresh_llr, fresh_cw, refill, remaining, lc2v, post, bit_pos, nct, B,
                           k, cap, st);
    case MSG_INT8:
      return launch_stream(c, cp, Int8Msg{inv_q}, llr, cw, lv2c, done, iters, age, avail, ctr,
                           fresh_llr, fresh_cw, refill, remaining, lc2v, post, bit_pos, nct, B,
                           k, cap, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
