// Layered BP batch decode kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of libldpc_tpu/ops/pallas/:
//   * bp_decode_layered_fast_kernel <- decode_lanes.py `kernel_layered_qc`
//                                      (with `_qc_engine`, via bp_decode_lanes),
//                                      this file
//   * bp_decode_layered_kernel      <- decode_fused.py `kernel_layered` and
//                                      decode_lanes.py `kernel_layered` (one
//                                      function in two TPU layouts), in
//                                      decode_layered_exact.cu (a file of its
//                                      own, so the two compile side by side)
// (the fast engine's streaming form, `kernel_stream_layered_qc`, is
// layered_stream.cuh, and so is the batch decode's tile form, a block's
// APP on chip for the whole decode (decode_layered_fast_tile*.cu): the first
// kernel here is its HBM-plane form, for a code whose tile does not fit;
// ops/kernels/decode_layered.py fast_form picks).
//
// The fast engine (first kernel; its pass is layered_fast.cuh) keeps the
// node posterior (APP) as state and
// lets layer l touch only its own checks: per check and frame,
// lv = app[v] - lc2v[e] at each slot, the exclusion combine, then
// delta = o - lc2v[e], app[v] = app[v] + delta, lc2v[e] = o.  The TPU
// kernels walk a QC code's circulant segments with cyclic rolls; here a
// layer is a list of checks in the sorted layout (Layers) and the APP is
// addressed through row_ptr/col_sorted, the indexed loads of the flooding
// kernels.  Early termination is checked once per full iteration from the
// syndrome of app <= 0.
//
// Race freedom: the 8 warps of a block split a layer's checks, and the
// checks of one layer update the APP of their variables concurrently.  That
// is safe because no layer reaches a variable twice; the host refuses
// layers that do (KernelTables.layers_disjoint).  Each check writes only its
// own lc2v slots, whatever their width.  A __syncthreads after each layer
// orders the next layer's reads after this layer's writes.  Frames are
// columns: no two blocks share a frame.
//
// The exact schedule (second kernel) mirrors the XLA layered decoder: per
// layer, the layer's checks refresh their messages (the CN phase may skip
// the other checks, whose outputs the JAX version masks away), then the
// posteriors follow (decode_layered_exact.cu and layered_exact_tile.cuh
// recompute only the layer's own variables, which is the same bits), and
// with early termination a frame whose syndrome is satisfied after any
// layer is frozen for the rest of the decode.  An iteration counts for a
// frame unconverged at its start and at its end.
//
// Message forms: each kernel is instantiated for float32, bfloat16 and int8
// message storage (the TPU kernels' `message_dtype`; traits in
// cn_forms.cuh), behind one extern "C" entry that takes the dtype code, as
// in decode_fused.cu.  The fast engine stores lc2v in the form and keeps
// the APP float32, in decoder units (lattice units for int8: it starts at
// prior(llr) = llr * float32(1/quant_scale)) and never rounded; lv and o are
// rounded into the message domain (Msg::round) before and after the
// combine, as `_qc_engine`'s to_msg does.  The exact schedule stores lc2v
// and the posterior in the form, with the store points of the flooding
// kernels (bp_phases.cuh), and recomputes each extrinsic from them.
//
// Layout, block shape and exactness as in decode_fused.cu: planes are
// [rows, B] with frames fastest, a block holds 32 frames (one per lane)
// and 8 warps, the file is built with -fmad=false, and the arithmetic
// follows the plain PyTorch versions operation for operation
// (lv = round(app - st), o = round(postprocess(...)), delta = o - st,
// app = app + delta; the combine of cn_forms.cuh), so the min-sum family is
// bit-exact against them.
//
// What bounds it: per-slot instruction count and dependent loads, not
// device-memory traffic.  The fast engine reads and writes the APP and lc2v
// at every slot once per iteration (~16 B per slot and frame in float32) and
// the syndrome re-reads the APP; for the 802.11n n=1944 code at B = 16384
// the APP plane is 127 MB and lc2v 456 MB (228 MB in bfloat16, 114 MB in
// int8), far past the 50 MB L2.  It takes the same time with 4-, 2- and
// 1-byte messages within 10 %, so what it waits on is each slot's chain of
// index load, message load and combine (decode_layered_exact.cu says what
// bounds the exact schedule).  The combine keeps its values in registers (cn_forms.cuh) and the
// fast engine reads each slot's index and message once; the kernels here
// keep every plane in HBM (the tile forms hold the APP in shared memory,
// layered_stream.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bp_phases.cuh"
#include "cn_forms.cuh"
#include "dispatch.cuh"
#include "layered_fast.cuh"

namespace {

// Batch decode on the fast engine, all iterations in one launch.  Control
// state is kept per thread and updated identically by every thread of a
// frame, as in bp_decode_fused_kernel.  `app` is the output, in decoder
// units (the wrapper dequantises it).
template <class Msg, int FAM>
__global__ void __launch_bounds__(LDPC_FRAMES * LDPC_WARPS, LDPC_FAST_MIN_BLOCKS)
bp_decode_layered_fast_kernel(Code c, Layers L, CnParams cp, Msg m,
                              const float* __restrict__ llr_in, float* __restrict__ app,
                              int* __restrict__ iters_out, int* __restrict__ iscw_out,
                              typename Msg::T* __restrict__ lc2v, int B_, int iterations,
                              int early_term) {
  __shared__ int bad[LDPC_FRAMES];
  const size_t B = B_;
  const size_t b = (size_t)blockIdx.x * LDPC_FRAMES + threadIdx.x;
  const bool valid = b < B;
  const bool lead = threadIdx.y == 0;
  if (valid) {
    for (int v = threadIdx.y; v < c.nc; v += blockDim.y) app[v * B + b] = m.prior(llr_in[v * B + b]);
    for (int e = threadIdx.y; e < c.nnz; e += blockDim.y) lc2v[e * B + b] = m.store(0.0f);
  }
  bool done = !valid;
  int iters = 0, iscw = 0;
  __syncthreads();
  for (int it = 0; it < iterations; ++it) {
    if (early_term && !__syncthreads_or(!done)) break;
    const bool check = !done && (early_term || it == iterations - 1);
    fast_pass<FAM>(c, L, cp, m, app, lc2v, !done, B, b);
    if (lead) bad[threadIdx.x] = 0;  // after the layer barriers: last reads are behind
    __syncthreads();
    if (check) syndrome_part(c, F32Msg{}, app, B, b, bad);
    __syncthreads();
    if (check) {
      const bool ok = !bad[threadIdx.x];
      if (!early_term) {
        iscw = ok;
      } else if (ok) {
        done = true;  // converged: keeps this APP and is not counted
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

// Each returns the launch's cudaGetLastError() (0 = launched).  The
// message planes (lc2v; for the exact schedule also lv2c and the posterior
// `post`) are of the type of `msg_dtype`; the APP stays float32; `inv_q` is
// the int8 lattice's prior factor (unused otherwise).

int ldpc_bp_decode_layered_fast(const float* llr_in, float* app, int* iters, int* iscw,
                                void* lc2v, const int* row_ptr, const int* col_sorted,
                                const int* vn_ptr, const int* perm_c2v, const int* layer_ptr,
                                const int* layer_checks, int nc, int mc, int nnz, int nl, int B,
                                int iterations, int early_term, int cn_mode, float scale,
                                float offset, int msg_dtype, float inv_q, void* stream) {
  Code c{row_ptr, col_sorted, vn_ptr, perm_c2v, nc, mc, nnz};
  Layers L{layer_ptr, layer_checks, nl};
  CnParams cp{cn_mode, scale, offset};
  return by_form(msg_dtype, inv_q, cn_mode, [&](auto m, auto fam) {
    using Msg = decltype(m);
    bp_decode_layered_fast_kernel<Msg, decltype(fam)::value>
        <<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>(c, L, cp, m, llr_in, app, iters, iscw,
                                                           (typename Msg::T*)lc2v, B, iterations,
                                                           early_term);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
