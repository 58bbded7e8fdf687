// The exact layered schedule's plane form for Hopper (sm_90a): the form of
// a code whose tile (layered_exact_tile.cuh) does not fit a block's shared
// memory.  Replaces, like the tile form, the TPU kernel of
// libldpc_tpu/ops/pallas/decode_fused.py `kernel_layered` (via
// bp_decode_pallas(layered=True); decode_lanes.py `kernel_layered` is the
// same function): the whole decode of a batch, all iterations in one
// launch.  The wrapper (ops/kernels/decode_layered.py exact_form) picks the
// form by size.
//
// The tiles' decode (layered_exact_tile.cuh exact_decode) at PLANE = true:
// a block owns 16 frames for the decode and runs the
// tile's schedule on them, step for step, with the check messages lc2v and
// the stored posterior in device memory, [nnz, B] and [nc, B] (the output
// plane) with the frame index fastest, so a warp's two rows of 16 frames
// read whole sectors, and the packed decisions in a per-block scratch row
// [nc] (hard_scratch); no code is too large.  No lv2c plane exists: a
// check recomputes its extrinsic store(load(post[v]) - load(lc2v[e])), and
// after a layer only the layer's own variables (KernelTables layer_var_ptr
// / layer_vars; every variable at the decode's first layer) recompute their
// posterior, summing lc2v in perm_c2v order from the first, so the min-sum
// family is bit-exact against the plain version.
//
// What bounds it: the slots it moves.  Per frame and iteration a check
// reads its slots' posterior and lc2v and writes lc2v (3 nnz slots), and
// each layer's variables read every slot of theirs (sum over the layers of
// the layer's variables' degrees: 40,824 slots on wifi 1944 against nnz
// 6,966) and read their prior and write their posterior once (2 nlv):
// ~75,600 slots, 302 KB a frame-iteration in float32 on wifi 1944, against
// ~214,000 slots in the HBM-plane design it replaces, which ran the full
// variable phase (every lc2v read, every lv2c and posterior written) after
// every layer.  The design loads a variable's slots eight at a time (eight
// loads in flight a thread) and a check's in one unrolled burst (the
// combine's registers), and leaves the re-reads of a layer's variables to
// the 50 MB L2: 132 blocks of 16 frames touch 59 MB of float32 lc2v on
// wifi 1944.  The posterior of 8 or 16 frames kept in shared memory, and a
// cp.async ring for the lc2v slots of the next check or variable, were
// timed on codes past the tiles and not kept (PERF.md section 6).  Built
// with -fmad=false, in the operation order of the plain version
// (ops/sorted.py _bp_decode_sorted_layered).
#include <cuda_runtime.h>
#include <stdint.h>

#include "layered_exact_tile.cuh"

namespace {

constexpr int kPlaneFrames = 16;

// The plane form's kernel: no minimum of blocks an SM in its launch bounds,
// and lc2v restrict (with a minimum of one and lc2v not restrict, the
// float32 plane took 1.2-1.6x the time; PERF.md section 6).
template <class Msg, int FAM>
__global__ void __launch_bounds__(kPlaneFrames * exact_rows(kPlaneFrames))
bp_decode_layered_plane_kernel(Code c, Layers L, LayerVars V, int nlc, CnParams cp, Msg m,
                               const float* __restrict__ llr_in,
                               typename Msg::T* __restrict__ out,
                               typename Msg::T* __restrict__ lc2v, uint16_t* hard_scratch,
                               int* __restrict__ iters_out, int* __restrict__ iscw_out, int B_,
                               int iterations, int early_term) {
  exact_decode<Msg, FAM, kPlaneFrames, true>(c, L, V, nlc, cp, m, llr_in, out, lc2v,
                                             hard_scratch, iters_out, iscw_out, 0, B_,
                                             iterations, early_term);
}

}  // namespace

extern "C" {

// Returns the launch's cudaGetLastError() (0 = launched).  `post` (the
// output) and the scratch plane `lc2v` [nnz, B] are of the type of
// `msg_dtype`; `hard_scratch` [ceil(B / 16), nc] uint16 holds each block's
// packed decisions; `inv_q` is the int8 lattice's prior factor (unused
// otherwise).
int ldpc_bp_decode_layered(const float* llr_in, void* post, int* iters, int* iscw, void* lc2v,
                           void* hard_scratch, const int* row_ptr, const int* col_sorted,
                           const int* vn_ptr, const int* perm_c2v, const int* layer_ptr,
                           const int* layer_checks, const int* layer_var_ptr,
                           const int* layer_vars, int nc, int mc, int nnz, int nl, int nlc,
                           int nlv, int B, int iterations, int early_term, int cn_mode,
                           float scale, float offset, int msg_dtype, float inv_q, void* stream) {
  constexpr int F = kPlaneFrames;
  Code c{row_ptr, col_sorted, vn_ptr, perm_c2v, nc, mc, nnz};
  Layers L{layer_ptr, layer_checks, nl};
  LayerVars V{layer_var_ptr, layer_vars, nlv};
  CnParams cp{cn_mode, scale, offset};
  return by_form(msg_dtype, inv_q, cn_mode, [&](auto m, auto fam) {
    using Msg = decltype(m);
    using T = typename Msg::T;
    return launch_smem(bp_decode_layered_plane_kernel<Msg, decltype(fam)::value>,
                       (B + F - 1) / F, dim3(F, exact_rows(F)), 0, (cudaStream_t)stream, c, L,
                       V, nlc, cp, m, llr_in, (T*)post, (T*)lc2v, (uint16_t*)hard_scratch, iters,
                       iscw, B, iterations, early_term);
  });
}

}  // extern "C"
