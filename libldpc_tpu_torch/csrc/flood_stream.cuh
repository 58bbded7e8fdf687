// The flooding BP tile for Hopper (sm_90a): the streaming chunk's tile
// form (decode_stream_tile*.cu) and the batch decode's tile form
// (decode_fused_tile*.cu), one source file per frames-a-block, on one pass.
//
// Replaces, like decode_stream.cu (the chunk's HBM-plane form, on
// stream_chunk.cuh), the TPU kernel of
// libldpc_tpu/ops/pallas/decode_fused.py `kernel_stream` (via
// bp_stream_chunk_pallas; decode_lanes.py `kernel_stream` is the same
// function): k self-refilling flooding passes per lane with an exact
// global start quota and per-lane counters; and, like decode_fused.cu (the
// batch decode's HBM-plane form), `kernel` (via bp_decode_pallas;
// decode_lanes.py `kernel` is the same function): the whole decode of a
// batch, all iterations in one launch.  The wrappers
// (ops/kernels/decode_fused.py flood_form) pick the form by size.
//
// A block owns F frames (4, 8 or 16) for the whole chunk (the batch
// decode: for the whole decode) and keeps two
// planes of them in shared memory, in the message form: the stored
// check-to-variable messages lc2v [nnz, F] and the stored posterior
// post [nc, F].  The variable-to-check message is never stored inside the
// chunk: a check recomputes it from the two, bit for bit as the variable
// phase of the HBM-plane form writes it, lv2c = store(load(post[v]) -
// load(lc2v[e])), one subtraction (no FMA under -fmad=false).  Per pass:
//
// * check phase: thread (f, y) runs checks y, y + NTY, ... for frame f,
//   lv2c recomputed as above, the combine of cn_forms.cuh, lc2v = store(o);
// * variable phase: post = store(prior(x) + (m_s0 + m_s1 + ...)), the
//   messages summed in perm_c2v order from the first (the prior read from
//   the carried channel plane in device memory); the decisions post <= 0
//   of the block's F frames are packed into one F-bit word per variable
//   (__ballot_sync);
// * syndrome: one check per thread, the XOR of its variables' words, for
//   all F frames at once; the bit-error count of a finishing frame reads
//   the same words.
//
// The batch decode (bp_decode_fused_tile_kernel) runs the same pass
// (flood_tile_pass) over frames that all start at once and never reload:
// each starts as a reload does, post = store(prior(x)) with lc2v taken as
// 0 (its first extrinsic is store(prior(x)), the first messages of
// decode_fused.cu), the prior of each variable phase is read from the
// input plane, the syndrome is taken when a frame checks (every pass with
// early termination, the last without), a converged frame keeps that
// pass's posterior and is not counted (break-before-increment), the block
// stops once its F frames have converged, and the stored posterior goes to
// the `post` plane at the end.  No lv2c or lc2v plane exists.
//
// The chunk boundary keeps the state of the HBM-plane form: the carried
// lv2c plane.  A frame in flight at chunk entry (an injected age-0 lane
// too) runs its first check phase from that plane; a frame reloaded in the
// chunk starts from post = store(prior(x)) with lc2v taken as 0 (its first
// check phase sees lv2c = store(prior(x)), the reload of decode_stream.cu);
// at chunk exit every frame that ran a pass writes lv2c = store(load(post)
// - load(lc2v)) of its last pass back to the plane, as the plain chunk
// keeps lv2c_new for every lane active in a pass.  Reload, quota (one
// atomicSub per granted start) and counters are those of stream_chunk.cuh.
// The index tables (row_ptr, col_sorted, vn_ptr, perm_c2v) are staged in
// shared memory beside the tiles when the wrapper says they fit.
//
// What bounds it: per frame and pass only the prior (nc float32) is read
// from device memory, the messages stay on chip; every slot costs two
// shared-memory loads and a store in the check phase and one load in the
// variable phase, and BP's box-plus its special-function operations.
// Built with -fmad=false, in the operation order of the plain chunk
// (ops/kernels/decode_fused.py bp_stream_chunk_fused_plain, and the sorted
// decoder for the batch): the min-sum family is bit-exact against them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bp_phases.cuh"
#include "cn_forms.cuh"
#include "dispatch.cuh"
#include "stream_chunk.cuh"

namespace {

// Checks (and variables) in flight per frame: a block of F frames has 768
// threads and its SM to itself.
__host__ __device__ constexpr int flood_rows(int frames) { return 768 / frames; }

// Shared memory of the tile form (bp_phases.cuh Tile): lc2v, the posterior,
// the packed decisions and, when staged, the code's four tables.
inline size_t flood_tile_bytes(int nc, int mc, int nnz, int frames, int msg, bool stage) {
  return tile_layout_bytes(nc, nnz, frames, msg, stage ? code_table_ints(nc, mc, nnz) : 0);
}

// Where a frame's check phase finds its variable-to-check messages
enum LvSource { LV_TILE = 0, LV_PLANE = 1, LV_FRESH = 2 };

// One check of degree d >= 1 for frame f of the tile: lv2c from the tiles
// (or from the carried plane, or with lc2v = 0 after a reload), the
// combine, lc2v = store(o).  Every input is read before its slot is
// emitted (cn_forms.cuh), so the tile is updated in place.
template <int FAM, int F, class Msg>
__device__ __forceinline__ void flood_check(const int* col, const CnParams& cp, const Msg& m,
                                            typename Msg::T* q, const typename Msg::T* post,
                                            const typename Msg::T* __restrict__ lv2c, int src,
                                            int e0, int d, size_t B, size_t b, int f) {
  check_combine<FAM>(
      cp, d,
      [&](int j) {
        const int e = e0 + j;
        if (src == LV_PLANE) return m.load(lv2c[e * B + b]);
        const float old = src == LV_FRESH ? 0.0f : m.load(q[e * F + f]);
        return m.round(m.load(post[col[e] * F + f]) - old);
      },
      [&](int j, float o) { q[(e0 + j) * F + f] = m.store(o); });
}

// One flooding pass of the tile over the frames in flight (`run`): the
// check phase (lv2c from `src`: the carried plane, the tiles, or the tiles
// with lc2v taken as 0), then the variable phase, post = store(prior(x) +
// (m_s0 + m_s1 + ...)) with x = prior(v), and the packed decisions; then,
// when `syndrome` (the same in every thread of the block), the syndrome of
// all F frames: bit f of *badmask set when frame f has an unsatisfied
// check.  Every thread of the block calls it.
template <int FAM, int F, class Msg, class Prior>
__device__ __forceinline__ void flood_tile_pass(const TileCode& tc, const CnParams& cp,
                                                const Msg& m, const Tile<typename Msg::T>& t,
                                                const typename Msg::T* __restrict__ lv2c, int src,
                                                bool run, bool syndrome, size_t B, size_t b,
                                                unsigned* badmask, Prior prior) {
  constexpr int NTY = flood_rows(F);
  const int f = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * F + f, nt = F * NTY;
  if (run)
    for (int r = ty; r < tc.mc; r += NTY) {
      const int e0 = tc.row_ptr[r];
      const int d = tc.row_ptr[r + 1] - e0;
      if (d > 0) flood_check<FAM, F>(tc.col_sorted, cp, m, t.q, t.post, lv2c, src, e0, d, B, b, f);
    }
  if (tid == 0) *badmask = 0;
  __syncthreads();
  // ---- variable phase and packed decisions: a warp holds 32 / F values
  // of ty, so its ballot covers that many variables
  const int v_rounds = (tc.nc + NTY - 1) / NTY;
  for (int i = 0; i < v_rounds; ++i) {
    const int v = i * NTY + ty;
    tile_variable<F>(tc, m, t, v < tc.nc ? v : -1, run, f, tid, prior);
  }
  __syncthreads();
  if (!syndrome) return;
  // ---- syndrome of all F frames, one check per thread
  tile_syndrome(tc, t.hard, tid, nt, badmask);
  __syncthreads();
}

// Every thread of a frame keeps the frame's control state in registers and
// updates it identically; every barrier is reached by the whole block.
template <class Msg, int FAM, int F>
__global__ void __launch_bounds__(F * flood_rows(F), 1)
bp_stream_chunk_tile_kernel(Code c, CnParams cp, Msg m, StreamArgs<float, typename Msg::T> s,
                            int stage, int B_, int k, int cap) {
  using T = typename Msg::T;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int flag[F];       // start granted
  __shared__ int berr[F];       // bit errors of a finishing frame
  __shared__ unsigned badmask;  // bit f: frame f has an unsatisfied check
  constexpr int NTY = flood_rows(F);
  const Tile<T> t = tile_of<T, F>(smem, c.nc, c.nnz);
  const int f = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * F + f, nt = F * NTY;
  const size_t B = B_;
  const size_t b = (size_t)blockIdx.x * F + f;
  const bool valid = b < B;
  const bool lead = ty == 0;
  int* staged = t.tables;
  const TileCode tc = tile_code(c, staged, stage, tid, nt);
  int done = 1, iters = 0, age = 0, avail = 0;
  if (valid) {
    done = s.done[b];
    iters = s.iters[b];
    age = s.age[b];
    avail = s.avail[b];
  }
  // a frame in flight at entry takes its first pass from the carried plane;
  // a frame that runs a pass writes its lv2c back at the end
  int src = done ? LV_TILE : LV_PLANE;
  bool dirty = false;
  const bool refill_on = *s.refill != 0;
  int n_bit = 0, n_frame_err = 0, n_frames = 0, n_iter = 0, n_start = 0;
  for (int p = 0; p < k; ++p) {
    // ---- reload: a ticket against the global quota per idle lane with an
    // unused pool entry; it starts iff the ticket is below the remaining count
    const bool want = valid && refill_on && done && avail;
    if (lead)
      flag[f] = want && *(volatile int*)s.remaining > 0 && atomicSub(s.remaining, 1) > 0;
    __syncthreads();  // also ends the table staging before the first pass
    if (flag[f]) {
      for (int v = ty; v < c.nc; v += NTY) {
        const float x = s.fresh_prior[v * B + b];
        s.prior[v * B + b] = x;
        s.cw[v * B + b] = s.fresh_cw[v * B + b];
        t.post[v * F + f] = m.store(m.prior(x));
      }
      src = LV_FRESH;
      done = 0;
      age = 1;
      iters = 0;
      avail = 0;
      ++n_start;
    }
    const bool work = !done || (want && *(volatile int*)s.remaining > 0);
    if (!__syncthreads_or(work)) break;  // also orders the reload's tile writes
    // ---- one flooding pass over the frames in flight, then the syndrome
    const bool run = !done;
    const bool checking = run && age >= 1;
    if (lead) berr[f] = 0;
    flood_tile_pass<FAM, F>(tc, cp, m, t, s.lv2c, src, run, true, B, b, &badmask,
                            [&](int v_) { return s.prior[v_ * B + b]; });
    if (run) {
      dirty = true;
      src = LV_TILE;
    }
    bool newly = false;
    if (checking) {
      newly = !((badmask >> f) & 1u);
      if (!newly) ++iters;
    }
    if (run) ++age;
    const bool finish = run && (newly || age >= cap + 1);
    if (finish) {
      // count at the finishing pass: its decisions, transmitted bits only
      int be = 0;
      for (int j = ty; j < s.nct; j += NTY) {
        const int v = __ldg(s.bit_pos + j);
        be += (int)((t.hard[v] >> f) & 1) != (int)(s.cw[v * B + b] != 0);
      }
      if (be) atomicAdd(&berr[f], be);
    }
    __syncthreads();
    if (finish) {
      const int be = berr[f];
      done = 1;
      n_bit += be;
      n_frame_err += be > 0;
      n_frames += 1;
      n_iter += iters;
    }
  }
  if (dirty)
    for (int e = ty; e < c.nnz; e += NTY)
      s.lv2c[e * B + b] =
          m.store(m.load(t.post[tc.col_sorted[e] * F + f]) - m.load(t.q[e * F + f]));
  if (valid && lead) {
    s.done[b] = done;
    s.iters[b] = iters;
    s.age[b] = age;
    s.avail[b] = avail;
    s.ctr[0 * B + b] += n_bit;
    s.ctr[1 * B + b] += n_frame_err;
    s.ctr[2 * B + b] += n_frames;
    s.ctr[3 * B + b] += n_iter;
    s.ctr[4 * B + b] += n_start;
  }
}

// The batch decode on the tile (see the file's note): a block owns F frames
// for the whole decode, all iterations in one launch; every frame starts as
// a reload does, post = store(prior(x)) with lc2v taken as 0.  `post` is
// the output, the stored posterior in the message type.
template <class Msg, int FAM, int F>
__global__ void __launch_bounds__(F * flood_rows(F), 1)
bp_decode_fused_tile_kernel(Code c, CnParams cp, Msg m, const float* __restrict__ llr_in,
                            typename Msg::T* __restrict__ post, int* __restrict__ iters_out,
                            int* __restrict__ iscw_out, int stage, int B_, int iterations,
                            int early_term) {
  using T = typename Msg::T;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned badmask;  // bit f: frame f has an unsatisfied check
  constexpr int NTY = flood_rows(F);
  const Tile<T> t = tile_of<T, F>(smem, c.nc, c.nnz);
  const int f = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * F + f, nt = F * NTY;
  const size_t B = B_;
  const size_t b = (size_t)blockIdx.x * F + f;
  const bool valid = b < B;
  int* staged = t.tables;
  const TileCode tc = tile_code(c, staged, stage, tid, nt);
  if (valid)
    for (int v = ty; v < c.nc; v += NTY) t.post[v * F + f] = m.store(m.prior(llr_in[v * B + b]));
  bool done = !valid;
  int iters = 0, iscw = 0;
  __syncthreads();  // the tile and the staged tables before the first pass
  for (int it = 0; it < iterations; ++it) {
    // block-level exit once every frame of the block has converged
    if (early_term && !__syncthreads_or(!done)) break;
    const bool syndrome = early_term || it == iterations - 1;
    flood_tile_pass<FAM, F>(tc, cp, m, t, nullptr, it == 0 ? LV_FRESH : LV_TILE, !done, syndrome,
                            B, b, &badmask, [&](int v) { return llr_in[v * B + b]; });
    if (syndrome && !done) {
      const bool ok = !((badmask >> f) & 1u);
      if (!early_term) {
        iscw = ok;
      } else if (ok) {
        done = true;  // a converged frame keeps this pass's posterior and is not counted
        iscw = 1;
      } else {
        ++iters;
      }
    }
  }
  if (valid) {
    for (int v = ty; v < c.nc; v += NTY) post[v * B + b] = t.post[v * F + f];
    if (ty == 0) {
      iters_out[b] = early_term ? iters : iterations;
      iscw_out[b] = iscw;
    }
  }
}

}  // namespace

// The extern "C" entry of one tile form (F frames a block), defined by the
// form's source file (one file per form, so the forms compile side by
// side).  It returns the launch's cudaGetLastError() (0 = launched).  The
// arguments are those of ldpc_bp_stream_chunk_fused (decode_stream.cu)
// without its device-memory scratch, plus `stage`: the index tables staged
// in shared memory.
#define LDPC_FLOOD_STREAM_ENTRY(NAME, FRAMES)                                                    \
  extern "C" int NAME(float* llr, uint8_t* cw, void* lv2c, int* done, int* iters, int* age,      \
                      int* avail, int* ctr, const float* fresh_llr, const uint8_t* fresh_cw,     \
                      const int* refill, int* remaining, const int* row_ptr,                     \
                      const int* col_sorted, const int* vn_ptr, const int* perm_c2v,             \
                      const int* bit_pos, int nc, int mc, int nnz, int nct, int B, int k,        \
                      int cap, int cn_mode, float scale, float offset, int msg_dtype,            \
                      float inv_q, int stage, void* stream) {                                    \
    Code c{row_ptr, col_sorted, vn_ptr, perm_c2v, nc, mc, nnz};                                  \
    CnParams cp{cn_mode, scale, offset};                                                         \
    return by_form(msg_dtype, inv_q, cn_mode, [&](auto m, auto fam) {                            \
      using Msg = decltype(m);                                                                   \
      using T = typename Msg::T;                                                                 \
      StreamArgs<float, T> s{llr,       cw,       (T*)lv2c, done,    iters,  age,                \
                             avail,     ctr,      fresh_llr, fresh_cw, refill, remaining,        \
                             (T*)nullptr, bit_pos, nct};                                         \
      return launch_smem(bp_stream_chunk_tile_kernel<Msg, decltype(fam)::value, FRAMES>,         \
                         (B + FRAMES - 1) / FRAMES, dim3(FRAMES, flood_rows(FRAMES)),            \
                         flood_tile_bytes(nc, mc, nnz, FRAMES, (int)sizeof(T), stage != 0),      \
                         (cudaStream_t)stream, c, cp, m, s, stage, B, k, cap);                   \
    });                                                                                          \
  }

// The extern "C" entry of the batch decode's tile form at FRAMES frames a
// block, defined by the form's source file.  The arguments are those of
// ldpc_bp_decode_fused (decode_fused.cu) without its lv2c and lc2v
// scratch, plus `stage`: the index tables staged in shared memory.  `post`
// is of the type of `msg_dtype`.
#define LDPC_FLOOD_BATCH_ENTRY(NAME, FRAMES)                                                     \
  extern "C" int NAME(const float* llr_in, void* post, int* iters, int* iscw,                    \
                      const int* row_ptr, const int* col_sorted, const int* vn_ptr,              \
                      const int* perm_c2v, int nc, int mc, int nnz, int B, int iterations,       \
                      int early_term, int cn_mode, float scale, float offset, int msg_dtype,     \
                      float inv_q, int stage, void* stream) {                                    \
    Code c{row_ptr, col_sorted, vn_ptr, perm_c2v, nc, mc, nnz};                                  \
    CnParams cp{cn_mode, scale, offset};                                                         \
    return by_form(msg_dtype, inv_q, cn_mode, [&](auto m, auto fam) {                            \
      using Msg = decltype(m);                                                                   \
      using T = typename Msg::T;                                                                 \
      return launch_smem(bp_decode_fused_tile_kernel<Msg, decltype(fam)::value, FRAMES>,         \
                         (B + FRAMES - 1) / FRAMES, dim3(FRAMES, flood_rows(FRAMES)),            \
                         flood_tile_bytes(nc, mc, nnz, FRAMES, (int)sizeof(T), stage != 0),      \
                         (cudaStream_t)stream, c, cp, m, llr_in, (T*)post, iters, iscw, stage,   \
                         B, iterations, early_term);                                             \
    });                                                                                          \
  }
