// The exact layered schedule's tile form for Hopper (sm_90a): the kernels
// of decode_layered_exact_tile*.cu, one source file per frames-a-block.
//
// Replaces, like decode_layered_exact.cu (the HBM-plane form), the TPU
// kernel of libldpc_tpu/ops/pallas/decode_fused.py `kernel_layered` (via
// bp_decode_pallas(layered=True); decode_lanes.py `kernel_layered` is the
// same function): the whole decode of a batch, all iterations in one
// launch; per layer its checks refresh, the posterior and the extrinsics
// follow, and (with early termination) a converged frame freezes.  The
// wrapper (ops/kernels/decode_layered.py exact_form) picks the form by size.
//
// A block owns F frames (8 or 16) for the whole decode and keeps, in the
// message form, their stored check-to-variable messages lc2v [nnz, F] and
// stored posterior post [nc, F] in shared memory: it reads the prior at
// the start and writes the stored posterior at the end, and no lv2c plane
// exists.  A check recomputes the extrinsic bit for bit as the HBM-plane
// form's variable phase stores it, lv2c = store(load(post[v]) -
// load(lc2v[e])).  Per layer:
//
// 1. the layer's checks: thread (f, y) runs checks y, y + NTY, ... of the
//    layer for frame f (checks of a layer may share variables: they read
//    post and write only their own slots);
// 2. a barrier;
// 3. the variable phase over the layer's own variables (KernelTables
//    layer_var_ptr / layer_vars; every variable at the first layer of a
//    decode): post = store(prior(x) + (m_s0 + m_s1 + ...)) in perm_c2v
//    order; a variable outside the layer keeps every lc2v, so the full
//    variable phase of the HBM-plane form recomputes the same bits for it;
//    the decisions post <= 0 are packed one F-bit word per variable
//    (__ballot_sync);
// 4. a barrier; the syndrome of all F frames, one check per thread, the
//    XOR of its variables' words; a barrier;
// 5. a frame unconverged at that syndrome goes on; with early termination
//    a converged one freezes (its post is the layer's that froze it), and
//    the block stops when its own F frames have converged.
//
// Break-before-increment counts (an iteration counts iff the frame is
// unconverged at its start and at its end); without early termination
// is_codeword comes from the last layer's syndrome.  The index tables
// (row_ptr, col_sorted, vn_ptr, perm_c2v, the layers' checks and
// variables) are staged in shared memory beside the tiles when the wrapper
// says they fit.
//
// What bounds it: device memory is read once (the prior, and per layer the
// prior of the layer's variables, which the L2 keeps) and written once;
// every slot of a layer costs two shared-memory loads and a store, every
// slot of a layer's variables one load, and BP's box-plus its
// special-function operations.  Built with -fmad=false, in the operation
// order of the plain version (ops/sorted.py _bp_decode_sorted_layered): the
// min-sum family is bit-exact against it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bp_phases.cuh"
#include "cn_forms.cuh"
#include "dispatch.cuh"
#include "layered_fast.cuh"

namespace {

// Checks (and variables) in flight per frame: 512 threads a block.
__host__ __device__ constexpr int exact_rows(int frames) { return 512 / frames; }

// Each layer's variables: the union of col_sorted over the layer's checks,
// sorted labels, CSR over ptr.
struct LayerVars {
  const int* __restrict__ ptr;   // [nl + 1]
  const int* __restrict__ vars;  // [nlv]
  int nlv;
};

// Shared memory of the tile form (bp_phases.cuh Tile): lc2v, the posterior,
// the packed decisions and, when staged, the code's four tables, then
// layer_ptr [nl + 1], layer_checks [nlc], layer_var_ptr [nl + 1] and
// layer_vars [nlv].
inline size_t exact_tile_bytes(int nc, int mc, int nnz, int nl, int nlc, int nlv, int frames,
                               int msg, bool stage) {
  const size_t tables = code_table_ints(nc, mc, nnz) + 2 * (size_t)(nl + 1) + nlc + nlv;
  return tile_layout_bytes(nc, nnz, frames, msg, stage ? tables : 0);
}

// Every thread of a frame keeps the frame's state in registers and updates
// it identically; every barrier is reached by the whole block.
template <class Msg, int FAM, int F>
__global__ void __launch_bounds__(F * exact_rows(F), sizeof(typename Msg::T) == 1 ? 2 : 1)
bp_decode_layered_tile_kernel(Code c, Layers L, LayerVars V, int nlc, CnParams cp, Msg m,
                              const float* __restrict__ llr_in, typename Msg::T* __restrict__ out,
                              int* __restrict__ iters_out, int* __restrict__ iscw_out, int stage,
                              int B_, int iterations, int early_term) {
  using T = typename Msg::T;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned badmask[2];  // per layer parity: bit f, frame f has an unsatisfied check
  constexpr int NTY = exact_rows(F);
  const Tile<T> t = tile_of<T, F>(smem, c.nc, c.nnz);
  const int f = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * F + f, nt = F * NTY;
  const size_t B = B_;
  const size_t b = (size_t)blockIdx.x * F + f;
  const bool valid = b < B;
  int* staged = t.tables;
  const TileCode tc = tile_code(c, staged, stage, tid, nt);
  const int* lptr = stage ? stage_table(staged, L.ptr, L.nl + 1, tid, nt) : L.ptr;
  const int* lchk = stage ? stage_table(staged, L.checks, nlc, tid, nt) : L.checks;
  const int* vptr = stage ? stage_table(staged, V.ptr, L.nl + 1, tid, nt) : V.ptr;
  const int* lvars = stage ? stage_table(staged, V.vars, V.nlv, tid, nt) : V.vars;
  // the first messages: post = store(prior(x)) (so that a check's first
  // extrinsic is store(prior(x))), lc2v = store(0)
  if (valid) {
    for (int v = ty; v < c.nc; v += NTY) t.post[v * F + f] = m.store(m.prior(llr_in[v * B + b]));
    for (int e = ty; e < c.nnz; e += NTY) t.q[e * F + f] = m.store(0.0f);
  }
  if (tid == 0) badmask[0] = badmask[1] = 0;
  bool done = !valid;
  int iters = 0, iscw = 0;
  __syncthreads();
  bool first = true;  // the decode's first variable phase covers every variable
  int parity = 0;     // badmask slot of this layer
  for (int it = 0; it < iterations; ++it) {
    if (early_term && !__syncthreads_or(!done)) break;
    const bool done_start = done;
    for (int l = 0; l < L.nl; ++l) {
      const bool check = !done && (early_term || (it == iterations - 1 && l == L.nl - 1));
      // ---- 1. the layer's checks
      if (!done) {
        const int k1 = lptr[l + 1];
        for (int kk = lptr[l] + ty; kk < k1; kk += NTY) {
          const int r = lchk[kk];
          const int e0 = tc.row_ptr[r];
          const int d = tc.row_ptr[r + 1] - e0;
          if (d > 0)
            check_combine<FAM>(
                cp, d,
                [&](int j) {
                  const int e = e0 + j;
                  const float x = m.load(t.post[tc.col_sorted[e] * F + f]);
                  return m.round(x - m.load(t.q[e * F + f]));
                },
                [&](int j, float o) { t.q[(e0 + j) * F + f] = m.store(o); });
        }
      }
      __syncthreads();
      // ---- 3. the variable phase over the layer's variables, decisions packed
      const int i0 = first ? 0 : vptr[l];
      const int n = first ? c.nc : vptr[l + 1] - i0;
      const int rounds = (n + NTY - 1) / NTY;
      for (int i = 0; i < rounds; ++i) {
        const int j = i * NTY + ty;
        tile_variable<F>(tc, m, t, j < n ? (first ? j : lvars[i0 + j]) : -1, !done, f, tid,
                         [&](int v) { return __ldg(llr_in + v * B + b); });
      }
      first = false;
      // ---- 4. the syndrome of all F frames, one check per thread
      if (__syncthreads_or(check)) {
        tile_syndrome(tc, t.hard, tid, nt, &badmask[parity]);
        __syncthreads();
        if (check) {
          const bool ok = !((badmask[parity] >> f) & 1u);
          if (!early_term) {
            iscw = ok;
          } else if (ok) {
            done = true;  // frozen: later layers and iterations skip it
            iscw = 1;
          }
        }
        // the other slot is next; every thread has read it two barriers ago
        if (tid == 0) badmask[parity ^ 1] = 0;
        parity ^= 1;
      }
    }
    if (early_term && !done_start && !done) ++iters;
  }
  if (valid) {
    for (int v = ty; v < c.nc; v += NTY) out[v * B + b] = t.post[v * F + f];
    if (ty == 0) {
      iters_out[b] = early_term ? iters : iterations;
      iscw_out[b] = iscw;
    }
  }
}

}  // namespace

// The extern "C" entry of one tile form (F frames a block), defined by the
// form's source file.  It returns the launch's cudaGetLastError() (0 =
// launched).  The arguments are those of ldpc_bp_decode_layered
// (decode_layered_exact.cu) without its lv2c and lc2v scratch, plus each
// layer's variables (CSR) and `stage`: the index tables staged in shared
// memory.  `post` is of the type of `msg_dtype`.
#define LDPC_EXACT_TILE_ENTRY(NAME, FRAMES)                                                     \
  extern "C" int NAME(const float* llr_in, void* post, int* iters, int* iscw,                   \
                      const int* row_ptr, const int* col_sorted, const int* vn_ptr,             \
                      const int* perm_c2v, const int* layer_ptr, const int* layer_checks,       \
                      const int* layer_var_ptr, const int* layer_vars, int nc, int mc, int nnz, \
                      int nl, int nlc, int nlv, int B, int iterations, int early_term,          \
                      int cn_mode, float scale, float offset, int msg_dtype, float inv_q,       \
                      int stage, void* stream) {                                                \
    Code c{row_ptr, col_sorted, vn_ptr, perm_c2v, nc, mc, nnz};                                 \
    Layers L{layer_ptr, layer_checks, nl};                                                      \
    LayerVars V{layer_var_ptr, layer_vars, nlv};                                                \
    CnParams cp{cn_mode, scale, offset};                                                        \
    return by_form(msg_dtype, inv_q, cn_mode, [&](auto m, auto fam) {                           \
      using Msg = decltype(m);                                                                  \
      using T = typename Msg::T;                                                                \
      return launch_smem(bp_decode_layered_tile_kernel<Msg, decltype(fam)::value, FRAMES>,      \
                         (B + FRAMES - 1) / FRAMES, dim3(FRAMES, exact_rows(FRAMES)),           \
                         exact_tile_bytes(nc, mc, nnz, nl, nlc, nlv, FRAMES, (int)sizeof(T),    \
                                          stage != 0),                                          \
                         (cudaStream_t)stream, c, L, V, nlc, cp, m, llr_in, (T*)post, iters,    \
                         iscw, stage, B, iterations, early_term);                               \
    });                                                                                         \
  }
