// The exact layered schedule's decode for Hopper (sm_90a), the body of its
// tile form's kernels (decode_layered_exact_tile*.cu, one source file per
// frames-a-block) and, at PLANE, of its plane form's (decode_layered_exact.cu).
//
// Replaces, like decode_layered_exact.cu (the plane form), the TPU
// kernel of libldpc_tpu/ops/pallas/decode_fused.py `kernel_layered` (via
// bp_decode_pallas(layered=True); decode_lanes.py `kernel_layered` is the
// same function): the whole decode of a batch, all iterations in one
// launch; per layer its checks refresh, the posterior and the extrinsics
// follow, and (with early termination) a converged frame freezes.  The
// wrapper (ops/kernels/decode_layered.py exact_form) picks the form by size.
//
// A block owns F frames (16, 8 or 4) for the whole decode and keeps, in the
// message form, their stored check-to-variable messages lc2v [nnz, F] and
// stored posterior post [nc, F] in shared memory: it reads the prior at
// the start (and keeps it, float32 [nc, F], in shared memory when the
// wrapper says it fits: `priors`) and writes the stored posterior at the
// end, and no lv2c plane exists.  A check recomputes the extrinsic bit for
// bit as the plain version's variable phase stores it, lv2c =
// store(load(post[v]) - load(lc2v[e])).  Per layer:
//
// 1. the layer's checks: thread (f, y) runs checks y, y + NTY, ... of the
//    layer for frame f (checks of a layer may share variables: they read
//    post and write only their own slots);
// 2. a barrier;
// 3. the variable phase over the layer's own variables (KernelTables
//    layer_var_ptr / layer_vars; every variable at the first layer of a
//    decode): post = store(prior(x) + (m_s0 + m_s1 + ...)) in perm_c2v
//    order; a variable outside the layer keeps every lc2v, so the full
//    variable phase of the plain version recomputes the same bits for it;
//    the decisions post <= 0 are packed one F-bit word per variable.  In
//    the tile with its priors staged a thread takes a variable's F
//    frames, each slot's frames loaded as one row (exact_tile_variables);
//    else a thread takes a variable of one frame (frame_variable,
//    __ballot_sync);
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
// variables) are 16-bit in the tiles (every entry of a code whose tile fits
// a block is below 65,536: KernelTables.exact16, the eight back to back),
// staged in shared memory beside the tiles when the wrapper says they fit,
// else read from device memory; the plane form reads them as int32.
//
// What bounds it: device memory is read once (the prior, and, unless the
// priors are staged, per layer the prior of the layer's variables, which
// the L2 keeps) and written once;
// every slot of a layer costs two shared-memory loads and a store, every
// slot of a layer's variables one load, and BP's box-plus its
// special-function operations.  Built with -fmad=false, in the operation
// order of the plain version (ops/sorted.py _bp_decode_sorted_layered): the
// min-sum family is bit-exact against it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "bp_phases.cuh"
#include "cn_forms.cuh"
#include "dispatch.cuh"

namespace {

// Checks (and variables) in flight per frame: 512 threads a block.
__host__ __device__ constexpr int exact_rows(int frames) { return 512 / frames; }

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// A row of a tile: a slot of lc2v, or a variable's stored posterior, F
// frames of T back to back (F * sizeof(T) bytes, a power of two,
// at a multiple of its size), moved as whole 4-, 8- or 16-byte words.
template <class T, int F>
struct TileRow {
  static constexpr int BYTES = F * (int)sizeof(T);
  static constexpr int WORD = BYTES < 16 ? BYTES : 16;
  static_assert(BYTES >= 4 && (BYTES & (BYTES - 1)) == 0, "a row is a power of two of words");
  using W = typename std::conditional<
      WORD == 16, uint4, typename std::conditional<WORD == 8, uint2, unsigned>::type>::type;
  static constexpr int N = BYTES / WORD;

  __device__ __forceinline__ static void load(const T* p, T (&x)[F]) {
    W w[N];
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = ((const W*)p)[i];
    memcpy(x, w, BYTES);
  }
  __device__ __forceinline__ static void store(T* p, const T (&x)[F]) {
    W w[N];
    memcpy(w, x, BYTES);
#pragma unroll
    for (int i = 0; i < N; ++i) ((W*)p)[i] = w[i];
  }
};

// K5's index tables with entries of type I: the code's four, each layer's
// checks (CSR over lptr) and each layer's variables (the union of
// col_sorted over the layer's checks, sorted labels, CSR over vptr).
template <class I>
struct ExactCode {
  TileCodeOf<I> c;
  const I* lptr;   // [nl + 1]
  const I* lchk;   // [nlc]
  const I* vptr;   // [nl + 1]
  const I* lvars;  // [nlv]
  int nl, nlc, nlv;
};

// Entries of the eight tables: row_ptr, col_sorted, vn_ptr, perm_c2v,
// layer_ptr, layer_checks, layer_var_ptr, layer_vars.
__host__ __device__ constexpr size_t exact_table_entries(int nc, int mc, int nnz, int nl, int nlc,
                                                         int nlv) {
  return (size_t)(mc + 1) + nnz + (nc + 1) + nnz + 2 * (size_t)(nl + 1) + nlc + nlv;
}

// The eight tables back to back from p, in that order (KernelTables.exact16
// in device memory; the staged copy in shared memory is laid out alike).
template <class I>
__host__ __device__ __forceinline__ ExactCode<I> exact_code_at(const I* p, int nc, int mc,
                                                               int nnz, int nl, int nlc, int nlv) {
  ExactCode<I> x;
  x.c = TileCodeOf<I>{p, p + mc + 1, p + mc + 1 + nnz, p + mc + 1 + nnz + nc + 1, nc, mc, nnz};
  x.lptr = x.c.perm_c2v + nnz;
  x.lchk = x.lptr + nl + 1;
  x.vptr = x.lchk + nlc;
  x.lvars = x.vptr + nl + 1;
  x.nl = nl;
  x.nlc = nlc;
  x.nlv = nlv;
  return x;
}

// Bytes of the staged tables, 4-byte aligned (0 unless `stage`).
__host__ __device__ inline size_t exact_staged_table_bytes(int nc, int mc, int nnz, int nl,
                                                           int nlc, int nlv, bool stage) {
  return stage ? align4(2 * exact_table_entries(nc, mc, nnz, nl, nlc, nlv)) : 0;
}

// Shared memory of the tile form (bp_phases.cuh Tile): lc2v, the posterior,
// the packed decisions, when staged the eight 16-bit tables, 4-byte aligned,
// and when `priors` the frames' float32 priors [nc, F] after them, 16-byte
// aligned (ops/kernels/decode_layered.py exact_tile_bytes counts the same).
inline size_t exact_tile_bytes(int nc, int mc, int nnz, int nl, int nlc, int nlv, int frames,
                               int msg, bool stage, bool priors) {
  const size_t n = tile_layout_bytes(nc, nnz, frames, msg, 0) +
                   exact_staged_table_bytes(nc, mc, nnz, nl, nlc, nlv, stage);
  return priors ? align16(n) + (size_t)4 * nc * frames : n;
}

// 3. of the tile form with its priors staged (exact_decode): the variable
// phase over layer l's variables (every variable when `first`), thread tid
// taking variables tid, tid + nt, ... with all F frames: post =
// store(prior(x) + (m_s0 + m_s1 + ...)), the messages summed in perm_c2v
// order from the first, each slot's F frames loaded as one row; then the
// F-bit decision word post <= 0 (frames outside `live` 0).  A frozen frame
// recomputes the bits it holds: none of its lc2v has changed since its
// variables were last computed.  The raw LLRs x are the frames' [nc, F] in
// shared memory at `pri`, read four frames at a time after the sums.
template <class Msg, int F, class I>
__device__ __forceinline__ void exact_tile_variables(const ExactCode<I>& code, const Msg& m,
                                                     const Tile<typename Msg::T>& t, int l,
                                                     bool first, unsigned live, const float* pri,
                                                     int tid, int nt) {
  using T = typename Msg::T;
  static_assert(F % 4 == 0, "the priors are read as 16-byte words");
  const TileCodeOf<I>& c = code.c;
  const int i0 = first ? 0 : code.vptr[l];
  const int n = first ? c.nc : code.vptr[l + 1] - i0;
  for (int j = tid; j < n; j += nt) {
    const int v = first ? j : code.lvars[i0 + j];
    const int s0 = c.vn_ptr[v];
    const int s1 = c.vn_ptr[v + 1];
    float tot[F];
    T row[F];
    if (s1 > s0) {
      TileRow<T, F>::load(t.q + (size_t)c.perm_c2v[s0] * F, row);
#pragma unroll
      for (int k = 0; k < F; ++k) tot[k] = m.load(row[k]);
      for (int s = s0 + 1; s < s1; ++s) {
        TileRow<T, F>::load(t.q + (size_t)c.perm_c2v[s] * F, row);
#pragma unroll
        for (int k = 0; k < F; ++k) tot[k] = tot[k] + m.load(row[k]);
      }
    }
    unsigned word = 0;
#pragma unroll
    for (int k0 = 0; k0 < F; k0 += 4) {
      const float4 x4 = *(const float4*)(pri + (size_t)v * F + k0);
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int k = k0; k < k0 + 4; ++k) {
        float llr = m.prior(x[k - k0]);
        if (s1 > s0) llr = llr + tot[k];
        row[k] = m.store(llr);
        word |= (m.load(row[k]) <= 0.0f ? 1u : 0u) << k;
      }
    }
    TileRow<T, F>::store(t.post + (size_t)v * F, row);
    t.hard[v] = (uint16_t)(word & live);
  }
}

// The decode of both forms, the body of their kernels.  PLANE: lc2v [nnz,
// B] and the stored posterior (the output plane itself) in device memory,
// the packed decisions in a row of hard_scratch [ceil(B / F), nc] per
// block, int32 tables read from device memory, the priors read from
// device memory, and a variable's slots loaded eight at a time; else the
// tile, on 16-bit tables (`code`: in device memory, laid out as
// exact_code_at; copied into shared memory first when `stage`), and either
// the frames' priors copied into shared memory at the start and the
// variable phase a variable's F frames a thread (`priors`:
// exact_tile_variables), or the priors read from device memory at every
// variable phase and a variable's slots of a frame loaded one at a time.
// Every thread of a frame keeps the frame's state in registers and updates
// it identically, and every thread the mask of the frames in flight; every
// barrier is reached by the whole block.
template <class Msg, int FAM, int F, bool PLANE, class I>
__device__ __forceinline__ void exact_decode(ExactCode<I> code, CnParams cp, Msg m,
                                             const float* __restrict__ llr_in,
                                             typename Msg::T* __restrict__ out,
                                             typename Msg::T* __restrict__ lc2v,
                                             uint16_t* hard_scratch, int* __restrict__ iters_out,
                                             int* __restrict__ iscw_out, int stage, int priors,
                                             int B_, int iterations, int early_term) {
  using T = typename Msg::T;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned badmask[2];  // per layer parity: bit f, frame f has an unsatisfied check
  constexpr int NTY = exact_rows(F);
  const int nc = code.c.nc, nnz = code.c.nnz;
  const Tile<T> t = tile_of<T, F>(smem, nc, nnz);
  const int f = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * F + f, nt = F * NTY;
  const size_t B = B_;
  const size_t b = (size_t)blockIdx.x * F + f;
  const bool valid = b < B;
  // this frame's lc2v and stored posterior
  const FrameSlots<T, F, PLANE> q{PLANE ? lc2v + b : t.q + f, B};
  const FrameSlots<T, F, PLANE> post{PLANE ? out + b : t.post + f, B};
  uint16_t* const hard = PLANE ? hard_scratch + (size_t)blockIdx.x * nc : t.hard;
  // the frames' float32 LLRs [nc, F] as llr_in holds them (the variable
  // phase takes m.prior of what it reads), after the staged tables, 16-byte
  // aligned; used only when `priors`
  float* const pri = (float*)(smem + align16((size_t)((unsigned char*)t.tables - smem) +
                                             exact_staged_table_bytes(nc, code.c.mc, nnz, code.nl,
                                                                      code.nlc, code.nlv, stage)));
  const bool staged_priors = !PLANE && priors;
  if constexpr (!PLANE) {
    if (stage) {  // the eight tables in 32-bit words (the buffer holds an even count)
      const int words =
          (int)((exact_table_entries(nc, code.c.mc, nnz, code.nl, code.nlc, code.nlv) + 1) / 2);
      const unsigned* src = (const unsigned*)code.c.row_ptr;
      unsigned* dst = (unsigned*)t.tables;
      for (int i = tid; i < words; i += nt) dst[i] = __ldg(src + i);
      code = exact_code_at((const I*)t.tables, nc, code.c.mc, nnz, code.nl, code.nlc, code.nlv);
    }
  }
  const TileCodeOf<I> tc = code.c;
  const I* const lptr = code.lptr;
  const I* const lchk = code.lchk;
  const I* const vptr = code.vptr;
  const I* const lvars = code.lvars;
  // the first messages: post = store(prior(x)) (so that a check's first
  // extrinsic is store(prior(x))), lc2v = store(0); x kept on chip when
  // the priors are staged
  if (valid) {
    for (int v = ty; v < nc; v += NTY) {
      const float x = llr_in[v * B + b];
      if (staged_priors) pri[v * F + f] = x;
      post[v] = m.store(m.prior(x));
    }
    for (int e = ty; e < nnz; e += NTY) q[e] = m.store(0.0f);
  } else if (staged_priors) {  // a column past B: its bits are never used
    for (int v = ty; v < nc; v += NTY) pri[v * F + f] = 0.0f;
  }
  if (tid == 0) badmask[0] = badmask[1] = 0;
  bool done = !valid;
  unsigned live = 0;  // bit k: frame k of the block in flight (!done)
  for (int k = 0; k < F; ++k) live |= (size_t)blockIdx.x * F + k < B ? 1u << k : 0u;
  int iters = 0, iscw = 0;
  __syncthreads();
  bool first = true;  // the decode's first variable phase covers every variable
  int parity = 0;     // badmask slot of this layer
  for (int it = 0; it < iterations; ++it) {
    if (early_term && !__syncthreads_or(!done)) break;
    const bool done_start = done;
    for (int l = 0; l < code.nl; ++l) {
      const bool check = !done && (early_term || (it == iterations - 1 && l == code.nl - 1));
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
                  const float x = m.load(post[tc.col_sorted[e]]);
                  return m.round(x - m.load(q[e]));
                },
                [&](int j, float o) { q[e0 + j] = m.store(o); });
        }
      }
      __syncthreads();
      // ---- 3. the variable phase over the layer's variables, decisions packed
      if constexpr (!PLANE) {
        if (staged_priors) exact_tile_variables<Msg, F>(code, m, t, l, first, live, pri, tid, nt);
      }
      if (!staged_priors) {  // a frame a thread
        const int i0 = first ? 0 : vptr[l];
        const int n = first ? nc : vptr[l + 1] - i0;
        const int rounds = (n + NTY - 1) / NTY;
        for (int i = 0; i < rounds; ++i) {
          const int j = i * NTY + ty;
          frame_variable<F, PLANE ? 8 : 1>(tc, m, q, post, hard,
                                           j < n ? (first ? j : lvars[i0 + j]) : -1, !done, f,
                                           tid, [&](int v) { return __ldg(llr_in + v * B + b); });
        }
      }
      first = false;
      // ---- 4. the syndrome of all F frames, one check per thread
      if (__syncthreads_or(check)) {
        tile_syndrome(tc, hard, tid, nt, &badmask[parity]);
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
        if (early_term) live &= badmask[parity];  // every thread: the frames frozen here
        // the other slot is next; every thread has read it two barriers ago
        if (tid == 0) badmask[parity ^ 1] = 0;
        parity ^= 1;
      }
    }
    if (early_term && !done_start && !done) ++iters;
  }
  if (valid) {
    if (!PLANE)
      for (int v = ty; v < nc; v += NTY) out[v * B + b] = post[v];
    if (ty == 0) {
      iters_out[b] = early_term ? iters : iterations;
      iscw_out[b] = iscw;
    }
  }
}

// The tile form's kernel (the int8 tiles run two blocks an SM), on the
// 16-bit tables.
template <class Msg, int FAM, int F>
__global__ void __launch_bounds__(F * exact_rows(F), sizeof(typename Msg::T) == 1 ? 2 : 1)
bp_decode_layered_tile_kernel(ExactCode<uint16_t> x, CnParams cp, Msg m,
                              const float* __restrict__ llr_in, typename Msg::T* __restrict__ out,
                              int* __restrict__ iters_out, int* __restrict__ iscw_out, int stage,
                              int priors, int B_, int iterations, int early_term) {
  exact_decode<Msg, FAM, F, false>(x, cp, m, llr_in, out, nullptr, nullptr, iters_out, iscw_out,
                                   stage, priors, B_, iterations, early_term);
}

}  // namespace

// The extern "C" entry of one tile form (F frames a block), defined by the
// form's source file.  It returns the launch's cudaGetLastError() (0 =
// launched).  The arguments are those of ldpc_bp_decode_layered
// (decode_layered_exact.cu) without its lc2v and decision scratch, with the
// eight tables 16-bit and back to back in `tables16` (exact_code_at; an even
// count of entries, 4-byte aligned), plus `stage`: the tables staged in
// shared memory, and `priors`: the frames' priors staged there too.  `post`
// is of the type of `msg_dtype`.
#define LDPC_EXACT_TILE_ENTRY(NAME, FRAMES)                                                     \
  extern "C" int NAME(const float* llr_in, void* post, int* iters, int* iscw,                   \
                      const void* tables16, int nc, int mc, int nnz, int nl, int nlc, int nlv,  \
                      int B, int iterations, int early_term, int cn_mode, float scale,          \
                      float offset, int msg_dtype, float inv_q, int stage, int priors,          \
                      void* stream) {                                                           \
    const ExactCode<uint16_t> x =                                                               \
        exact_code_at((const uint16_t*)tables16, nc, mc, nnz, nl, nlc, nlv);                    \
    CnParams cp{cn_mode, scale, offset};                                                        \
    return by_form(msg_dtype, inv_q, cn_mode, [&](auto m, auto fam) {                           \
      using Msg = decltype(m);                                                                  \
      using T = typename Msg::T;                                                                \
      return launch_smem(bp_decode_layered_tile_kernel<Msg, decltype(fam)::value, FRAMES>,      \
                         (B + FRAMES - 1) / FRAMES, dim3(FRAMES, exact_rows(FRAMES)),           \
                         exact_tile_bytes(nc, mc, nnz, nl, nlc, nlv, FRAMES, (int)sizeof(T),    \
                                          stage != 0, priors != 0),                             \
                         (cudaStream_t)stream, x, cp, m, llr_in, (T*)post, iters, iscw, stage,  \
                         priors, B, iterations, early_term);                                    \
    });                                                                                         \
  }
