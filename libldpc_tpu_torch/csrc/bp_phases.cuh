// The sorted layout's index tables and the per-frame phases shared by the
// decode kernels (decode_fused.cu, decode_layered.cu).
//
// Every plane is [rows, B] with the frame index fastest.  A block holds 32
// frames, one per lane, and its 8 warps split each phase between them: warp
// w takes checks (or variables, or layer entries) w, w + 8, w + 16, ...
// for the block's frames.  Index tables are read through __ldg; all lanes
// of a warp read the same entry, so they are broadcast loads.
#pragma once

#include <cuda_runtime.h>

#include "cn_forms.cuh"

#define LDPC_FRAMES 32  // frames per block: one per lane of a warp
#define LDPC_WARPS 8    // warps per block, splitting each phase

namespace {

struct Code {
  const int* __restrict__ row_ptr;     // [mc + 1]
  const int* __restrict__ col_sorted;  // [nnz]
  const int* __restrict__ vn_ptr;      // [nc + 1]
  const int* __restrict__ perm_c2v;    // [nnz]
  int nc, mc, nnz;
};

// CN phase over this warp's checks: lv2c -> lc2v, in the storage form Msg.
template <int FAM, class Msg>
__device__ void cn_phase(const Code& c, const CnParams& cp, const Msg& m,
                         const typename Msg::T* __restrict__ lv2c,
                         typename Msg::T* __restrict__ lc2v, size_t B, size_t b) {
  for (int r = threadIdx.y; r < c.mc; r += blockDim.y) {
    int e0 = __ldg(c.row_ptr + r);
    int d = __ldg(c.row_ptr + r + 1) - e0;
    if (d > 0) check_update<FAM>(cp, m, lv2c, lc2v, e0, d, B, b);
  }
}

// VN phase over this warp's variables, in the storage form Msg: posterior
// post = store(prior(llr) + (m0 + m1 + ...)) (the prior in float32, the
// messages widened from their stored form), extrinsic
// lv2c = store(load(post) - load(lc2v)) at each of the variable's edges,
// from the stored posterior.  A degree-0 variable stores its prior.
template <class Msg>
__device__ void vn_phase(const Code& c, const Msg& m, const float* __restrict__ prior,
                         typename Msg::T* __restrict__ lv2c,
                         const typename Msg::T* __restrict__ lc2v,
                         typename Msg::T* __restrict__ post, size_t B, size_t b) {
  for (int v = threadIdx.y; v < c.nc; v += blockDim.y) {
    int s0 = __ldg(c.vn_ptr + v);
    int s1 = __ldg(c.vn_ptr + v + 1);
    float llr = m.prior(prior[v * B + b]);
    if (s1 > s0) {
      float tot = m.load(lc2v[__ldg(c.perm_c2v + s0) * B + b]);
      for (int s = s0 + 1; s < s1; ++s) tot = tot + m.load(lc2v[__ldg(c.perm_c2v + s) * B + b]);
      llr = llr + tot;
    }
    const typename Msg::T q = m.store(llr);
    post[v * B + b] = q;
    const float qf = m.load(q);
    for (int s = s0; s < s1; ++s) {
      size_t e = __ldg(c.perm_c2v + s) * B + b;
      lv2c[e] = m.store(qf - m.load(lc2v[e]));
    }
  }
}

// Sets bad[lane] when one of this warp's checks is unsatisfied by the
// decisions post <= 0 (of the stored posterior); stops at the first such
// check, or as soon as another warp has found one for this frame.
template <class Msg>
__device__ void syndrome_part(const Code& c, const Msg& m,
                              const typename Msg::T* __restrict__ post, size_t B, size_t b,
                              volatile int* bad) {
  for (int r = threadIdx.y; r < c.mc; r += blockDim.y) {
    if (bad[threadIdx.x]) return;
    int e1 = __ldg(c.row_ptr + r + 1);
    int parity = 0;
    for (int e = __ldg(c.row_ptr + r); e < e1; ++e)
      parity ^= m.load(post[__ldg(c.col_sorted + e) * B + b]) <= 0.0f ? 1 : 0;
    if (parity) {
      bad[threadIdx.x] = 1;
      return;
    }
  }
}

inline unsigned grid_for(int B) { return (unsigned)((B + LDPC_FRAMES - 1) / LDPC_FRAMES); }
const dim3 kBlock(LDPC_FRAMES, LDPC_WARPS);

}  // namespace
