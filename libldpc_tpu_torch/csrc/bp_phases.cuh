// The sorted layout's index tables and the per-frame phases shared by the
// decode kernels (decode_fused.cu, decode_layered.cu), and the helpers of
// the tile forms (flood_stream.cuh, layered_exact_tile.cuh), at the end.
//
// Every plane is [rows, B] with the frame index fastest.  A block holds 32
// frames, one per lane, and its 8 warps split each phase between them: warp
// w takes checks (or variables, or layer entries) w, w + 8, w + 16, ...
// for the block's frames.  Index tables are read through __ldg; all lanes
// of a warp read the same entry, so they are broadcast loads.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

// The start grant of an idle lane that wants its pool entry (`want`) in a
// streaming chunk (K2, K4, K7).  With a grant plane (`grant`, a one-pass
// launch of a chunk where the quota may bind; pool_refill.cu
// stream_grant_kernel) the lane's entry of it, computed in lane order over
// the whole batch; else a ticket against the global quota, which grants
// every wanting lane wherever the quota does not bind.
__device__ __forceinline__ bool start_grant(bool want, const uint8_t* grant, int* remaining,
                                            size_t b) {
  if (grant) return want && grant[b];
  return want && *(volatile int*)remaining > 0 && atomicSub(remaining, 1) > 0;
}

// A wanting lane that may still start in a later pass of this launch.
__device__ __forceinline__ bool may_start(bool want, const uint8_t* grant, int* remaining) {
  return want && !grant && *(volatile int*)remaining > 0;
}

inline unsigned grid_for(int B) { return (unsigned)((B + LDPC_FRAMES - 1) / LDPC_FRAMES); }
const dim3 kBlock(LDPC_FRAMES, LDPC_WARPS);

// Launches `kernel` with `bytes` of dynamic shared memory, its limit raised
// first, and returns the launch's cudaGetLastError() (0 = launched).  A
// limit the card refuses (a tile past a block's shared memory) is returned
// and cleared, so that the next launch's check does not report it as its own.
template <class... P, class... A>
int launch_smem(void (*kernel)(P...), dim3 grid, dim3 block, size_t bytes,
                cudaStream_t stream, A... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  kernel<<<grid, block, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

// ---- The tile forms (flood_stream.cuh, layered_exact_tile.cuh).  A block
// owns F <= 16 frames; thread (f, ty), f = threadIdx.x fastest, so a warp
// holds 32 / F values of ty.  Shared memory holds, in the message type,
// lc2v [nnz, F] and the stored posterior post [nc, F], then the packed
// decisions hard [nc] (uint16, bit f for frame f), then the index tables
// the kernel stages (int32; K5's uint16, layered_exact_tile.cuh).

__host__ __device__ constexpr size_t align4(size_t n) { return (n + 3) & ~(size_t)3; }

// Bytes of that layout with `table_ints` int32 entries staged (0: none).
// ops/kernels/decode_fused.py tile_bytes counts the same; the library
// exports each kernel's count (ldpc_flood_tile_bytes, ldpc_exact_tile_bytes)
// for the card tests to hold the two against each other.
inline size_t tile_layout_bytes(int nc, int nnz, int frames, int msg, size_t table_ints) {
  return align4((size_t)(nnz + nc) * frames * msg) + align4((size_t)nc * 2) + table_ints * 4;
}

// int32 entries of the code's tables row_ptr, col_sorted, vn_ptr, perm_c2v
inline size_t code_table_ints(int nc, int mc, int nnz) {
  return (size_t)(mc + 1) + nnz + (nc + 1) + nnz;
}

template <class T>
struct Tile {
  T* q;            // [nnz, F] lc2v
  T* post;         // [nc, F] the stored posterior
  uint16_t* hard;  // [nc] packed decisions
  int* tables;     // staged index tables
};

template <class T, int F>
__device__ __forceinline__ Tile<T> tile_of(unsigned char* smem, int nc, int nnz) {
  Tile<T> t;
  t.q = (T*)smem;
  t.post = t.q + (size_t)nnz * F;
  t.hard = (uint16_t*)(smem + align4((size_t)(nnz + nc) * F * sizeof(T)));
  t.tables = (int*)((unsigned char*)t.hard + align4((size_t)nc * 2));
  return t;
}

// The code's index tables as a tile kernel reads them, in device memory or
// staged in shared memory (no __restrict__: the block writes a staged table
// before it reads it), with entries of type I: int, or uint16_t where every
// entry is below 65,536 (K5's tiles).
template <class I>
struct TileCodeOf {
  const I* row_ptr;
  const I* col_sorted;
  const I* vn_ptr;
  const I* perm_c2v;
  int nc, mc, nnz;
};
using TileCode = TileCodeOf<int>;

// Copies n int32 entries of src to *dst in shared memory (thread tid of
// nt), moves *dst past them and returns the copy.
__device__ __forceinline__ const int* stage_table(int*& dst, const int* src, int n, int tid,
                                                  int nt) {
  int* out = dst;
  for (int i = tid; i < n; i += nt) out[i] = __ldg(src + i);
  dst += n;
  return out;
}

// The code's tables, staged at *dst (code_table_ints entries) when `stage`.
__device__ __forceinline__ TileCode tile_code(const Code& c, int*& dst, bool stage, int tid,
                                              int nt) {
  if (!stage) return TileCode{c.row_ptr, c.col_sorted, c.vn_ptr, c.perm_c2v, c.nc, c.mc, c.nnz};
  TileCode s{nullptr, nullptr, nullptr, nullptr, c.nc, c.mc, c.nnz};
  s.row_ptr = stage_table(dst, c.row_ptr, c.mc + 1, tid, nt);
  s.col_sorted = stage_table(dst, c.col_sorted, c.nnz, tid, nt);
  s.vn_ptr = stage_table(dst, c.vn_ptr, c.nc + 1, tid, nt);
  s.perm_c2v = stage_table(dst, c.perm_c2v, c.nnz, tid, nt);
  return s;
}

// A frame's slots of a plane of messages (lc2v, or the stored posterior):
// slot r at p[r * F] in a tile of F frames in shared memory, p[r * B] in a
// plane [rows, B] in device memory (p at the frame's column).
template <class T, int F, bool DEV>
struct FrameSlots {
  T* p;
  size_t B;
  __device__ __forceinline__ T& operator[](int r) const { return DEV ? p[r * B] : p[r * F]; }
};

// The variable phase of variable v (< 0: none) for frame f, and the packed
// decisions.  In flight (`run`), post = store(prior(x) + (m_s0 + m_s1 +
// ...)), the messages q summed in perm_c2v order from the first, with x =
// prior(v); then the decisions post <= 0 of the warp are packed one F-bit
// word per variable into hard (__ballot_sync; a frame not in flight adds
// 0).  Every thread of the warp calls it.  W > 1 loads W slots before it
// sums them (q in device memory: W loads in flight a thread).
template <int F, int W = 1, class Msg, class Q, class P, class Prior, class I>
__device__ __forceinline__ void frame_variable(const TileCodeOf<I>& c, const Msg& m, Q q,
                                               P post, uint16_t* hard, int v, bool run, int f,
                                               int tid, Prior prior) {
  bool bit = false;
  if (run && v >= 0) {
    const int s0 = c.vn_ptr[v];
    const int s1 = c.vn_ptr[v + 1];
    float llr = m.prior(prior(v));
    if (s1 > s0) {
      float tot = 0.0f;
      if constexpr (W == 1) {
        tot = m.load(q[c.perm_c2v[s0]]);
        for (int s = s0 + 1; s < s1; ++s) tot = tot + m.load(q[c.perm_c2v[s]]);
      } else {
        for (int base = s0; base < s1; base += W) {
          typename Msg::T x[W];
#pragma unroll
          for (int i = 0; i < W; ++i)
            if (base + i < s1) x[i] = q[c.perm_c2v[base + i]];
#pragma unroll
          for (int i = 0; i < W; ++i)
            if (base + i < s1) tot = base + i == s0 ? m.load(x[i]) : tot + m.load(x[i]);
        }
      }
      llr = llr + tot;
    }
    const typename Msg::T pv = m.store(llr);
    post[v] = pv;
    bit = m.load(pv) <= 0.0f;
  }
  const unsigned word = __ballot_sync(0xffffffffu, bit);
  if (f == 0 && v >= 0) hard[v] = (uint16_t)((word >> (tid & 31)) & ((1u << F) - 1));
}

// frame_variable on a tile's lc2v and posterior in shared memory
template <int F, class Msg, class Prior>
__device__ __forceinline__ void tile_variable(const TileCode& c, const Msg& m,
                                              Tile<typename Msg::T> t, int v, bool run, int f,
                                              int tid, Prior prior) {
  using T = typename Msg::T;
  using S = FrameSlots<T, F, false>;
  frame_variable<F>(c, m, S{t.q + f, 0}, S{t.post + f, 0}, t.hard, v, run, f, tid, prior);
}

// The syndrome of the tile's F frames, checks tid, tid + nt, ...: each the
// XOR of its variables' decision words; sets bit f of *bad when frame f has
// an unsatisfied check.
template <class I>
__device__ __forceinline__ void tile_syndrome(const TileCodeOf<I>& c, const uint16_t* hard,
                                              int tid, int nt, unsigned* bad) {
  for (int r = tid; r < c.mc; r += nt) {
    const int e1 = c.row_ptr[r + 1];
    unsigned par = 0;
    for (int e = c.row_ptr[r]; e < e1; ++e) par ^= hard[c.col_sorted[e]];
    if (par) atomicOr(bad, par);
  }
}

}  // namespace
