// The flooding BP streaming kernel for Hopper (sm_90a): replaces
// libldpc_tpu/ops/pallas/decode_fused.py `kernel_stream` (via
// bp_stream_chunk_pallas).  decode_fused.cu describes both flooding
// kernels (layout, message forms, exactness, what bounds them); the chunk
// (reload, quota, counters) is stream_chunk.cuh.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bp_phases.cuh"
#include "cn_forms.cuh"
#include "dispatch.cuh"
#include "stream_chunk.cuh"

namespace {

// The BP pass of the streaming chunk (stream_chunk.cuh): CN phase, VN
// phase, and the syndrome of the stored posterior's decisions; the prior and
// the pool are raw float32 LLRs, and a reload stores each slot's prior in
// the message form, as the batch kernel starts.
template <class Msg, int FAM>
struct BpStreamPass {
  using V = float;
  using M = typename Msg::T;
  CnParams cp;
  Msg m;
  M* lc2v;  // [nnz, B] scratch
  __device__ void cn(const Code& c, const M* lv2c, size_t B, size_t b) const {
    cn_phase<FAM>(c, cp, m, lv2c, lc2v, B, b);
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
template <class Msg, int FAM>
__global__ void __launch_bounds__(LDPC_FRAMES * LDPC_WARPS)
bp_stream_chunk_fused_kernel(Code c, BpStreamPass<Msg, FAM> pass,
                             StreamArgs<float, typename Msg::T> s, int B, int k, int cap) {
  stream_chunk(c, pass, s, B, k, cap);
}

}  // namespace

extern "C" {

// Returns the launch's cudaGetLastError() (0 = launched).  The message
// planes (lv2c, lc2v, and the posterior `post`) are of the type of
// `msg_dtype`; `inv_q` is the int8 lattice's prior factor (unused
// otherwise).  `slot` (or null), `stage_llr`, `stage_cw` [nc, S]: the staged
// starts at the launch's entry (stream_chunk.cuh).
int ldpc_bp_stream_chunk_fused(float* llr, uint8_t* cw, void* lv2c, int* done, int* iters,
                               int* age, int* avail, int* ctr, const float* fresh_llr,
                               const uint8_t* fresh_cw, const int* refill, int* remaining,
                               const uint8_t* grant, int* slot, const float* stage_llr,
                               const uint8_t* stage_cw, int S, void* lc2v, void* post,
                               const int* row_ptr, const int* col_sorted,
                               const int* vn_ptr, const int* perm_c2v, const int* bit_pos, int nc,
                               int mc, int nnz, int nct, int B, int k, int cap, int cn_mode,
                               float scale, float offset, int msg_dtype, float inv_q,
                               void* stream) {
  Code c{row_ptr, col_sorted, vn_ptr, perm_c2v, nc, mc, nnz};
  CnParams cp{cn_mode, scale, offset};
  return by_form(msg_dtype, inv_q, cn_mode, [&](auto m, auto fam) {
    using Msg = decltype(m);
    using T = typename Msg::T;
    constexpr int FAM = decltype(fam)::value;
    BpStreamPass<Msg, FAM> pass{cp, m, (T*)lc2v};
    StreamArgs<float, T> s{llr,      cw,      (T*)lv2c,  done,     iters,  age,
                           avail,    ctr,     fresh_llr, fresh_cw, refill, remaining,
                           (T*)post, bit_pos, nct, grant, slot, stage_llr, stage_cw, S};
    bp_stream_chunk_fused_kernel<Msg, FAM>
        <<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>(c, pass, s, B, k, cap);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
