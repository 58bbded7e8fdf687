// The flooding BP streaming chunk's tile form for Hopper (sm_90a): the
// kernels of decode_stream_tile*.cu, one source file per frames-a-block.
//
// Replaces, like decode_stream.cu (the HBM-plane form, on
// stream_chunk.cuh), the TPU kernel of
// libldpc_tpu/ops/pallas/decode_fused.py `kernel_stream` (via
// bp_stream_chunk_pallas; decode_lanes.py `kernel_stream` is the same
// function): k self-refilling flooding passes per lane with an exact
// global start quota and per-lane counters.  The wrapper
// (ops/kernels/decode_fused.py stream_form) picks the form by size.
//
// A block owns F frames (4, 8 or 16) for the whole chunk and keeps two
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
// (ops/kernels/decode_fused.py bp_stream_chunk_fused_plain): the min-sum
// family is bit-exact against it.

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
  const int v_rounds = (c.nc + NTY - 1) / NTY;
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
    // ---- one flooding pass over the frames in flight
    const bool run = !done;
    const bool checking = run && age >= 1;
    if (run) {
      dirty = true;
      for (int r = ty; r < c.mc; r += NTY) {
        const int e0 = tc.row_ptr[r];
        const int d = tc.row_ptr[r + 1] - e0;
        if (d > 0)
          flood_check<FAM, F>(tc.col_sorted, cp, m, t.q, t.post, s.lv2c, src, e0, d, B, b, f);
      }
      src = LV_TILE;
    }
    if (tid == 0) badmask = 0;
    if (lead) berr[f] = 0;
    __syncthreads();
    // ---- variable phase and packed decisions: a warp holds 32 / F values
    // of ty, so its ballot covers that many variables
    for (int i = 0; i < v_rounds; ++i) {
      const int v = i * NTY + ty;
      tile_variable<F>(tc, m, t, v < c.nc ? v : -1, run, f, tid,
                       [&](int v_) { return s.prior[v_ * B + b]; });
    }
    __syncthreads();
    // ---- syndrome of all F frames, one check per thread
    tile_syndrome(tc, t.hard, tid, nt, &badmask);
    __syncthreads();
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

template <class Msg, int FAM, int F>
int launch_flood_tile(const Code& c, const CnParams& cp, const Msg& m,
                      const StreamArgs<float, typename Msg::T>& s, int stage, int B, int k,
                      int cap, cudaStream_t stream) {
  const size_t bytes =
      flood_tile_bytes(c.nc, c.mc, c.nnz, F, (int)sizeof(typename Msg::T), stage != 0);
  auto kernel = bp_stream_chunk_tile_kernel<Msg, FAM, F>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // not left behind for the next launch's check
    return (int)err;
  }
  kernel<<<(unsigned)((B + F - 1) / F), dim3(F, flood_rows(F)), bytes, stream>>>(c, cp, m, s, stage,
                                                                                  B, k, cap);
  return (int)cudaGetLastError();
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
      return launch_flood_tile<Msg, decltype(fam)::value, FRAMES>(c, cp, m, s, stage, B, k, cap, \
                                                                 (cudaStream_t)stream);          \
    });                                                                                          \
  }
