// The exact layered schedule's batch kernel for Hopper (sm_90a): replaces
// libldpc_tpu/ops/pallas/decode_fused.py `kernel_layered` and
// decode_lanes.py `kernel_layered` (one function in two TPU layouts).
// decode_layered.cu describes both layered batch kernels (the schedule,
// message forms, layout, exactness, what bounds them).
#include <cuda_runtime.h>
#include <stdint.h>

#include "bp_phases.cuh"
#include "cn_forms.cuh"
#include "dispatch.cuh"
#include "layered_fast.cuh"

namespace {

// The exact layered schedule, all iterations in one launch.  `post` is the
// stored posterior (the output, in the storage type: the wrapper widens it).
template <class Msg, int FAM>
__global__ void __launch_bounds__(LDPC_FRAMES * LDPC_WARPS)
bp_decode_layered_kernel(Code c, Layers L, CnParams cp, Msg m, const float* __restrict__ llr_in,
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
    for (int e = threadIdx.y; e < c.nnz; e += blockDim.y) {
      lv2c[e * B + b] = m.store(m.prior(llr_in[__ldg(c.col_sorted + e) * B + b]));
      lc2v[e * B + b] = m.store(0.0f);
    }
  bool done = !valid;
  int iters = 0, iscw = 0;
  __syncthreads();
  for (int it = 0; it < iterations; ++it) {
    if (early_term && !__syncthreads_or(!done)) break;
    const bool done_start = done;
    for (int l = 0; l < L.nl; ++l) {
      const bool check = !done && (early_term || (it == iterations - 1 && l == L.nl - 1));
      if (!done) {
        const int k1 = __ldg(L.ptr + l + 1);
        for (int k = __ldg(L.ptr + l) + threadIdx.y; k < k1; k += blockDim.y) {
          const int r = __ldg(L.checks + k);
          const int e0 = __ldg(c.row_ptr + r);
          const int d = __ldg(c.row_ptr + r + 1) - e0;
          if (d > 0) check_update<FAM>(cp, m, lv2c, lc2v, e0, d, B, b);
        }
      }
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
          done = true;  // frozen: later layers and iterations skip it
          iscw = 1;
        }
      }
    }
    if (early_term && !done_start && !done) ++iters;
  }
  if (valid && lead) {
    iters_out[b] = early_term ? iters : iterations;
    iscw_out[b] = iscw;
  }
}

}  // namespace

extern "C" {

// Returns the launch's cudaGetLastError() (0 = launched).  The message
// planes lv2c and lc2v and the posterior `post` are of the type of
// `msg_dtype`; `inv_q` is the int8 lattice's prior factor (unused otherwise).
int ldpc_bp_decode_layered(const float* llr_in, void* post, int* iters, int* iscw, void* lv2c,
                           void* lc2v, const int* row_ptr, const int* col_sorted,
                           const int* vn_ptr, const int* perm_c2v, const int* layer_ptr,
                           const int* layer_checks, int nc, int mc, int nnz, int nl, int B,
                           int iterations, int early_term, int cn_mode, float scale, float offset,
                           int msg_dtype, float inv_q, void* stream) {
  Code c{row_ptr, col_sorted, vn_ptr, perm_c2v, nc, mc, nnz};
  Layers L{layer_ptr, layer_checks, nl};
  CnParams cp{cn_mode, scale, offset};
  return by_form(msg_dtype, inv_q, cn_mode, [&](auto m, auto fam) {
    using Msg = decltype(m);
    using T = typename Msg::T;
    bp_decode_layered_kernel<Msg, decltype(fam)::value>
        <<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>(c, L, cp, m, llr_in, (T*)post, iters,
                                                           iscw, (T*)lv2c, (T*)lc2v, B, iterations,
                                                           early_term);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
