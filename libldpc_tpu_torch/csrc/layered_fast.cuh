// The fast layered engine's pass over HBM planes, shared by the batch
// kernel (decode_layered.cu) and the HBM-plane form of the streaming chunk
// (layered_stream.cuh): a layer is a list of checks in the sorted
// layout, the APP plane [nc, B] is addressed through row_ptr/col_sorted,
// and the 8 warps of a 32-frame block split a layer's checks.
#pragma once

// Blocks per SM the compiler keeps registers for in the kernels on this
// pass (at most 85 registers a thread).  They wait on device memory at
// every slot, so resident warps count for more than registers: on an H100
// the min-sum batch decode of the 802.11n n=1944 code took 49.6 ms so and
// 60.2 ms uncapped (BP 71.0 and 64.4 ms: the box-plus spills a little).
#define LDPC_FAST_MIN_BLOCKS 3

#include <cuda_runtime.h>
#include <stdint.h>

#include "bp_phases.cuh"
#include "cn_forms.cuh"

namespace {

struct Layers {
  const int* __restrict__ ptr;     // [nl + 1] range of each layer in checks
  const int* __restrict__ checks;  // sorted check labels, layer by layer
  int nl;
};

// One check of the fast engine for frame b: lv = round(app - lc2v) at each
// slot, the exclusion combine, o = round(postprocess(...)), then
// app = app + (o - lc2v), lc2v = store(o).  Its slots' variables are
// distinct from those of every other check of the layer, so the
// read-modify-write of app is this thread's alone within the layer.  On the
// unrolled path each slot's stored message is read once and kept in a
// register; past it the combine reloads it (never after a slot is emitted,
// cn_forms.cuh).
template <int FAM, class Msg>
__device__ __forceinline__ void fast_check(const Code& c, const CnParams& cp, const Msg& m,
                                           float* __restrict__ app,
                                           typename Msg::T* __restrict__ lc2v, int r, size_t B,
                                           size_t b) {
  const int e0 = __ldg(c.row_ptr + r);
  const int d = __ldg(c.row_ptr + r + 1) - e0;
  if (d == 0) return;
  if (d <= LDPC_UNROLL_DC) {
    float st[LDPC_UNROLL_DC];
#pragma unroll
    for (int j = 0; j < LDPC_UNROLL_DC; ++j)
      if (j < d) st[j] = m.load(lc2v[(e0 + j) * B + b]);
    check_combine_path<FAM, true>(
        cp, d,
        [&](int j) { return m.round(app[__ldg(c.col_sorted + e0 + j) * B + b] - st[j]); },
        [&](int j, float o) {
          const size_t v = __ldg(c.col_sorted + e0 + j) * B + b;
          o = m.round(o);
          app[v] = app[v] + (o - st[j]);
          lc2v[(e0 + j) * B + b] = m.store(o);
        });
  } else {
    check_combine_path<FAM, false>(
        cp, d,
        [&](int j) {
          return m.round(app[__ldg(c.col_sorted + e0 + j) * B + b] -
                         m.load(lc2v[(e0 + j) * B + b]));
        },
        [&](int j, float o) {
          const size_t v = __ldg(c.col_sorted + e0 + j) * B + b;
          const size_t e = (e0 + j) * B + b;
          o = m.round(o);
          app[v] = app[v] + (o - m.load(lc2v[e]));
          lc2v[e] = m.store(o);
        });
  }
}

// One full layered iteration of the fast engine for frame b (skipped when
// !run); every thread of the block calls it, for the barriers.
template <int FAM, class Msg>
__device__ void fast_pass(const Code& c, const Layers& L, const CnParams& cp, const Msg& m,
                          float* __restrict__ app, typename Msg::T* __restrict__ lc2v, bool run,
                          size_t B, size_t b) {
  for (int l = 0; l < L.nl; ++l) {
    if (run) {
      const int k1 = __ldg(L.ptr + l + 1);
      for (int k = __ldg(L.ptr + l) + threadIdx.y; k < k1; k += blockDim.y)
        fast_check<FAM>(c, cp, m, app, lc2v, __ldg(L.checks + k), B, b);
    }
    __syncthreads();  // the next layer reads what this one wrote
  }
}

}  // namespace
