// The fast layered engine on a tile for Hopper (sm_90a): the streaming
// chunk's kernels (decode_layered_stream*.cu, one source file per form) and
// the batch decode's tile form (decode_layered_fast_tile*.cu), on one pass.
//
// Replaces the TPU kernels of libldpc_tpu/ops/pallas/decode_lanes.py
// `kernel_stream_layered_qc` (via bp_stream_chunk_lanes(layered=True)) and,
// with decode_layered.cu's HBM-plane form, `kernel_layered_qc` + `_qc_engine`
// (via bp_decode_lanes(layered=True)).
//
// The streaming chunk: k self-refilling passes per lane on the fast engine.
// A lane in flight at
// age 0 starts the engine, an idle lane reloads from the pool under the
// exact quota (one atomicSub against `remaining`, as in stream_chunk.cuh),
// then a lane in flight runs one full layered iteration and is counted at
// the pass that finishes it.  The `app` plane is the persistent APP in
// decoder units: a start takes the prior of the LLRs it carries, a reload
// the prior of its pool entry (the pool stays raw float32 LLRs), as the JAX
// kernel's `prior_mul` does.  `lc2v` holds the CN-space check messages in
// the message form (0 on start).  Counter rows: 0 bit errors (transmitted
// bits, decided from the APP), 1 frame errors, 2 frames, 3 iteration sum,
// 4 starts.
//
// The batch decode's tile form (bp_decode_layered_fast_tile_kernel) runs the
// same pass (layered_tile_pass) over frames that all start at once and never
// reload: the APP tile starts at prior(llr), the first iteration takes lc2v
// as 0 (the plane is neither read nor zero-filled), the syndrome is taken
// when a frame checks (every iteration with early termination, the last
// without), a converged frame keeps its APP and is not counted
// (break-before-increment), the block stops once its F frames have
// converged, and the tile goes to the float32 `app` plane at the end.
// decode_layered.cu keeps the HBM-plane form, for a code whose tile does not
// fit (ops/kernels/decode_layered.py fast_form picks by size for both kernels).
//
// The chunk has two forms, chosen by the wrapper from the code's size
// (ops/kernels/decode_layered.py fast_form):
//
// * The tile form (bp_stream_chunk_layered_tile_kernel).  A block owns F
//   frames (8 or 16) and keeps their APP in shared memory for the whole
//   chunk: F x nc floats, loaded from the `app` plane for the frames in
//   flight at chunk start, overwritten with the prior at a start or a
//   reload, written back at chunk end.  Per pass only lc2v crosses device
//   memory, read once and written once per slot; the value read for
//   lv = round(app - lc2v) is kept in a register for app += o - lc2v.
//   Thread (f, y) runs check y, y + 32, ... of a layer for frame f, so a
//   warp covers 32 / F checks; frames are fastest in the lc2v plane, so its
//   F frames of one slot are one 32- or 64-byte segment in float32.  After
//   the pass the decisions app <= 0 are packed into one F-bit word per
//   variable (__ballot_sync), and the syndrome of all F frames comes from
//   XORs of those words, one check per thread; the bit-error count of a
//   finishing frame reads the same words.  The index tables (row_ptr,
//   col_sorted, the layers) are staged in shared memory when the wrapper
//   says they fit beside the tile.
//
// * The HBM-plane form (bp_stream_chunk_layered_fast_kernel): 32 frames x
//   8 warps per block, APP and lc2v planes in device memory, the pass of
//   layered_fast.cuh.  It serves a code whose APP tile does not fit in a
//   block's shared memory even at 8 frames (nc above ~7000).
//
// Semantics, in both: lv = round(app - lc2v), o = round(postprocess(
// combine)), app = app + (o - lc2v), lc2v = store(o); the APP is float32
// and never rounded; race freedom within a layer by layers_disjoint (the
// host refuses other layers), a block barrier between layers.  Built with
// -fmad=false; the min-sum family is bit-exact against the plain chunk and
// the plain batch decode.
//
// What bounds it: the tile form moves 2 x nnz x sizeof(message) bytes per
// frame and pass (55.7 KB in float32 for the 802.11n n=1944 code) and, in
// BP, 3 box-plus per slot, each two expf and two log1pf: the special-function
// unit, not device memory, bounds BP.  That lc2v traffic is the batch tile's
// design floor: for n=1944, 50 iterations at B = 16384 move 45.6 GB, 13.6 ms
// at 3.35 TB/s in float32, 6.8 ms in bfloat16 and 3.4 ms in int8, against a
// bound (each input read once, each output written once, and the operations)
// of 2.98 ms; a tile that also holds lc2v fits a block only at 8 frames in
// bfloat16/int8 and 4 in float32.  The HBM-plane form is bound by per-slot
// instruction count and dependent loads (see decode_layered.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bp_phases.cuh"
#include "cn_forms.cuh"
#include "dispatch.cuh"
#include "layered_fast.cuh"


namespace {

// The per-lane state and pool of a chunk, shared by both forms.
template <class T>
struct LayeredStream {
  float* __restrict__ app;         // [nc, B] persistent APP, decoder units
  uint8_t* __restrict__ cw;        // [nc, B] carried true codewords
  T* __restrict__ lc2v;            // [nnz, B] check messages in the form
  int* __restrict__ done;          // [B] lane idle (finished or empty)
  int* __restrict__ iters;         // [B]
  int* __restrict__ age;           // [B] passes since (re)load (0 = injected, not started)
  int* __restrict__ avail;         // [B] pool entry unused
  int* __restrict__ ctr;           // [5, B] counters
  const float* __restrict__ fresh_llr;    // [nc, B] fresh-frame pool, raw LLRs
  const uint8_t* __restrict__ fresh_cw;   // [nc, B]
  const int* __restrict__ refill;         // [1] reloads allowed
  int* remaining;                         // [1] starts left in the quota
  const int* __restrict__ bit_pos;        // [nct] transmitted variables
  int nct;
};

// ---------------------------------------------------------------- HBM form

template <class Msg, int FAM>
__global__ void __launch_bounds__(LDPC_FRAMES * LDPC_WARPS, LDPC_FAST_MIN_BLOCKS)
bp_stream_chunk_layered_fast_kernel(Code c, Layers L, CnParams cp, Msg m,
                                    LayeredStream<typename Msg::T> s, int B_, int k, int cap) {
  __shared__ int flag[LDPC_FRAMES];  // start granted, then check unsatisfied
  __shared__ int berr[LDPC_FRAMES];  // bit errors of a finishing frame
  const size_t B = B_;
  const size_t b = (size_t)blockIdx.x * LDPC_FRAMES + threadIdx.x;
  const bool valid = b < B;
  const bool lead = threadIdx.y == 0;
  int done = 1, iters = 0, age = 0, avail = 0;
  if (valid) {
    done = s.done[b];
    iters = s.iters[b];
    age = s.age[b];
    avail = s.avail[b];
  }
  const bool refill_on = *s.refill != 0;
  int n_bit = 0, n_frame_err = 0, n_frames = 0, n_iter = 0, n_start = 0;
  for (int pass = 0; pass < k; ++pass) {
    // ---- a lane injected in flight (age 0) starts the engine: APP = the
    // prior of the LLRs it carries, lc2v = 0, and this pass is iteration 1
    if (!done && age == 0) {
      for (int v = threadIdx.y; v < c.nc; v += blockDim.y)
        s.app[v * B + b] = m.prior(s.app[v * B + b]);
      for (int e = threadIdx.y; e < c.nnz; e += blockDim.y) s.lc2v[e * B + b] = m.store(0.0f);
      age = 1;
    }
    // ---- reload: a ticket against the global quota per idle lane with an
    // unused pool entry; it starts iff the ticket is below the remaining count
    const bool want = valid && refill_on && done && avail;
    if (lead)
      flag[threadIdx.x] =
          want && *(volatile int*)s.remaining > 0 && atomicSub(s.remaining, 1) > 0;
    __syncthreads();
    if (flag[threadIdx.x]) {
      for (int v = threadIdx.y; v < c.nc; v += blockDim.y) {
        s.app[v * B + b] = m.prior(s.fresh_llr[v * B + b]);
        s.cw[v * B + b] = s.fresh_cw[v * B + b];
      }
      for (int e = threadIdx.y; e < c.nnz; e += blockDim.y) s.lc2v[e * B + b] = m.store(0.0f);
      done = 0;
      age = 1;
      iters = 0;
      avail = 0;
      ++n_start;
    }
    const bool work = !done || (want && *(volatile int*)s.remaining > 0);
    if (!__syncthreads_or(work)) break;  // also orders the start writes before the pass
    // ---- one full layered iteration over the lanes in flight
    const bool run = !done;
    const bool checking = run && age >= 1;
    fast_pass<FAM>(c, L, cp, m, s.app, s.lc2v, run, B, b);
    if (lead) {
      flag[threadIdx.x] = 0;
      berr[threadIdx.x] = 0;
    }
    __syncthreads();
    if (checking) syndrome_part(c, F32Msg{}, s.app, B, b, flag);
    __syncthreads();
    bool newly = false;
    if (checking) {
      newly = !flag[threadIdx.x];
      if (!newly) ++iters;
    }
    if (run) ++age;
    const bool finish = run && (newly || age >= cap + 1);
    if (finish) {
      int be = 0;
      for (int t = threadIdx.y; t < s.nct; t += blockDim.y) {
        size_t v = __ldg(s.bit_pos + t) * B + b;
        be += (s.app[v] <= 0.0f) != (s.cw[v] != 0);
      }
      if (be) atomicAdd(&berr[threadIdx.x], be);
    }
    __syncthreads();
    if (finish) {
      const int be = berr[threadIdx.x];
      done = 1;
      n_bit += be;
      n_frame_err += be > 0;
      n_frames += 1;
      n_iter += iters;
    }
  }
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

// --------------------------------------------------------------- tile form

// Checks of a layer in flight per frame (blockDim.y of the tile form): a
// block of 16 frames has its SM to itself and takes 768 threads, which
// leaves each 85 registers (on an H100, 6 min-sum passes of the 802.11n
// n=1944 code took 3.7 ms at 48 checks, 4.4 ms at 32 and 5.2 ms at 64);
// blocks of 8 frames share an SM three at a time at 256 threads each.
__host__ __device__ constexpr int tile_checks(int frames) { return frames == 16 ? 48 : 32; }

// Shared-memory layout of the tile form, in bytes: the APP tile
// [nc, F] float32, the packed decisions [nc] uint16 (padded to 4 bytes),
// then, when staged, row_ptr [mc + 1], col_sorted [nnz], layer_ptr
// [nl + 1] and layer_checks [nlc] as int32.
inline size_t tile_bytes(int nc, int frames) {
  return (size_t)nc * frames * 4 + (size_t)((nc + 1) / 2) * 4;
}
inline size_t table_bytes(int mc, int nnz, int nl, int nlc) {
  return (size_t)(mc + 1 + nnz + nl + 1 + nlc) * 4;
}

// The stored messages of a check's slots e0 .. e0+d-1 for frame b
// (d <= LDPC_UNROLL_DC), each read once from the lc2v plane; zeros for a
// frame on its first pass since its start, whose plane is not read.
template <class Msg>
__device__ __forceinline__ void tile_fetch(const Msg& m, const typename Msg::T* __restrict__ lc2v,
                                           int e0, int d, bool fresh, size_t B, size_t b,
                                           float (&st)[LDPC_UNROLL_DC]) {
#pragma unroll
  for (int j = 0; j < LDPC_UNROLL_DC; ++j)
    if (j < d) st[j] = fresh ? 0.0f : m.load(lc2v[(e0 + j) * B + b]);
}

// One check of the fast engine for frame f of the tile (see fast_check in
// layered_fast.cuh): the APP is tile[v * F + f] in shared memory; `st`
// holds the check's stored messages when d <= LDPC_UNROLL_DC (tile_fetch),
// a larger check reads them from the plane as its combine asks.
template <int FAM, int F, class Msg>
__device__ __forceinline__ void tile_check(const int* col, const CnParams& cp, const Msg& m,
                                           float* tile, typename Msg::T* __restrict__ lc2v,
                                           int e0, int d, bool fresh, size_t B, size_t b, int f,
                                           const float (&st)[LDPC_UNROLL_DC]) {
  if (d == 0) return;
  if (d <= LDPC_UNROLL_DC) {
    check_combine_path<FAM, true>(
        cp, d, [&](int j) { return m.round(tile[col[e0 + j] * F + f] - st[j]); },
        [&](int j, float o) {
          float* a = tile + col[e0 + j] * F + f;
          o = m.round(o);
          *a = *a + (o - st[j]);
          lc2v[(e0 + j) * B + b] = m.store(o);
        });
  } else {
    check_combine_path<FAM, false>(
        cp, d,
        [&](int j) {
          const float old = fresh ? 0.0f : m.load(lc2v[(e0 + j) * B + b]);
          return m.round(tile[col[e0 + j] * F + f] - old);
        },
        [&](int j, float o) {
          float* a = tile + col[e0 + j] * F + f;
          const size_t e = (e0 + j) * B + b;
          o = m.round(o);
          *a = *a + (o - (fresh ? 0.0f : m.load(lc2v[e])));
          lc2v[e] = m.store(o);
        });
  }
}

// The index tables a tile reads, in device memory or staged in shared
// memory (no __restrict__: the block writes a staged table before it
// reads it).
struct FastTileCode {
  const int* row_ptr;
  const int* col;
  const int* lptr;  // [nl + 1] range of each layer in lchk
  const int* lchk;  // the layers' checks
  int nc, mc, nl;
};

// The code's and the layers' tables, staged at dst (table_bytes) when `stage`.
__device__ __forceinline__ FastTileCode fast_tile_code(const Code& c, const Layers& L, int nlc,
                                                       bool stage, int* dst, int tid, int nt) {
  if (!stage) return FastTileCode{c.row_ptr, c.col_sorted, L.ptr, L.checks, c.nc, c.mc, L.nl};
  FastTileCode t{nullptr, nullptr, nullptr, nullptr, c.nc, c.mc, L.nl};
  t.row_ptr = stage_table(dst, c.row_ptr, c.mc + 1, tid, nt);
  t.col = stage_table(dst, c.col_sorted, c.nnz, tid, nt);
  t.lptr = stage_table(dst, L.ptr, L.nl + 1, tid, nt);
  t.lchk = stage_table(dst, L.checks, nlc, tid, nt);
  return t;
}

// One full layered iteration of the tile over the frames in flight (`run`;
// `fresh`: a frame's first pass since its start, which finds lc2v = 0
// without reading the plane), then, when `syndrome` (the same in every
// thread of the block), the decisions app <= 0 packed into `hard` and the
// syndrome of all F frames: bit f of *badmask set when frame f has an
// unsatisfied check.  Thread (f, y) runs check y, y + NTY, ... of a layer
// for frame f and reads its messages once, requesting those of its next
// check before this one's arithmetic.  Every thread of the block calls it.
template <class Msg, int FAM, int F>
__device__ __forceinline__ void layered_tile_pass(const FastTileCode& tc, const CnParams& cp,
                                                  const Msg& m, float* tile, uint16_t* hard,
                                                  typename Msg::T* __restrict__ lc2v, bool run,
                                                  bool fresh, bool syndrome, size_t B, size_t b,
                                                  unsigned* badmask) {
  constexpr int NTY = tile_checks(F);
  const int f = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * F + f, nt = F * NTY;
  float st[LDPC_UNROLL_DC], st_next[LDPC_UNROLL_DC];
  int at = -1, e0 = 0, d = 0;  // st holds the messages of layer-list entry `at`
  for (int l = 0; l < tc.nl; ++l) {
    if (run) {
      const int k1 = tc.lptr[l + 1];
      for (int kk = tc.lptr[l] + ty; kk < k1; kk += NTY) {
        if (at != kk) {  // not requested ahead: this thread's first check of the pass
          const int r = tc.lchk[kk];
          e0 = tc.row_ptr[r];
          d = tc.row_ptr[r + 1] - e0;
          if (d <= LDPC_UNROLL_DC) tile_fetch(m, lc2v, e0, d, fresh, B, b, st);
        }
        // this thread's next check, in this layer or at the head of the
        // next one (the same thread wrote its messages in the last pass):
        // its messages are requested before this check's arithmetic
        int next = kk + NTY, e0_next = 0, d_next = 0;
        if (next >= k1) next = (l + 1 < tc.nl && k1 + ty < tc.lptr[l + 2]) ? k1 + ty : -1;
        if (next >= 0) {
          const int r = tc.lchk[next];
          e0_next = tc.row_ptr[r];
          d_next = tc.row_ptr[r + 1] - e0_next;
          if (d_next <= LDPC_UNROLL_DC) tile_fetch(m, lc2v, e0_next, d_next, fresh, B, b, st_next);
        }
        tile_check<FAM, F>(tc.col, cp, m, tile, lc2v, e0, d, fresh, B, b, f, st);
        at = next;
        e0 = e0_next;
        d = d_next;
#pragma unroll
        for (int j = 0; j < LDPC_UNROLL_DC; ++j) st[j] = st_next[j];
      }
    }
    __syncthreads();  // the next layer reads what this one wrote
  }
  if (!syndrome) return;
  // ---- decisions, packed: hard[v] bit f = (app[v] <= 0) of frame f.  A
  // warp holds 32 / F values of ty, so its ballot covers that many variables.
  if (tid == 0) *badmask = 0;
  const int v_rounds = (tc.nc + NTY - 1) / NTY;
  for (int i = 0; i < v_rounds; ++i) {
    const int v = i * NTY + ty;
    const bool bit = v < tc.nc && tile[v * F + f] <= 0.0f;
    const unsigned word = __ballot_sync(0xffffffffu, bit);
    if (f == 0 && v < tc.nc) hard[v] = (uint16_t)((word >> (tid & 31)) & ((1u << F) - 1));
  }
  __syncthreads();
  // ---- syndrome of all F frames, one check per thread
  for (int r = tid; r < tc.mc; r += nt) {
    const int e1 = tc.row_ptr[r + 1];
    unsigned p = 0;
    for (int e = tc.row_ptr[r]; e < e1; ++e) p ^= hard[tc.col[e]];
    if (p) atomicOr(badmask, p);
  }
  __syncthreads();
}

// Every thread of a frame keeps the frame's control state in registers and
// updates it identically; every barrier is reached by the whole block.
template <class Msg, int FAM, int F>
__global__ void __launch_bounds__(F * tile_checks(F), F == 8 ? 3 : 1)
bp_stream_chunk_layered_tile_kernel(Code c, Layers L, CnParams cp, Msg m,
                                    LayeredStream<typename Msg::T> s, int nlc, int stage, int B_,
                                    int k, int cap) {
  extern __shared__ float smem[];
  __shared__ int flag[F];          // start granted
  __shared__ int berr[F];          // bit errors of a finishing frame
  __shared__ unsigned badmask;     // bit f: frame f has an unsatisfied check
  float* tile = smem;                                       // [nc, F] the APP
  uint16_t* hard = (uint16_t*)(tile + (size_t)c.nc * F);    // [nc] bit f: app <= 0
  const int f = threadIdx.x, ty = threadIdx.y;
  constexpr int NTY = tile_checks(F);
  const int tid = ty * F + f, nt = F * NTY;
  const size_t B = B_;
  const size_t b = (size_t)blockIdx.x * F + f;
  const bool valid = b < B;
  const bool lead = ty == 0;
  const FastTileCode tc =
      fast_tile_code(c, L, nlc, stage, (int*)(hard + 2 * ((c.nc + 1) / 2)), tid, nt);
  int done = 1, iters = 0, age = 0, avail = 0;
  if (valid) {
    done = s.done[b];
    iters = s.iters[b];
    age = s.age[b];
    avail = s.avail[b];
  }
  // the frames in flight bring their APP; a frame that runs or starts in
  // this chunk takes its APP back to the plane at the end
  bool dirty = !done;
  if (!done)
    for (int v = ty; v < c.nc; v += NTY) tile[v * F + f] = s.app[v * B + b];
  const bool refill_on = *s.refill != 0;
  int n_bit = 0, n_frame_err = 0, n_frames = 0, n_iter = 0, n_start = 0;
  for (int pass = 0; pass < k; ++pass) {
    // ---- a lane injected in flight (age 0) starts the engine: APP = the
    // prior of the LLRs it carries (each thread its own tile entries),
    // lc2v = 0 (see `fresh` below), and this pass is iteration 1
    if (!done && age == 0) {
      for (int v = ty; v < c.nc; v += NTY) tile[v * F + f] = m.prior(tile[v * F + f]);
      age = 1;
    }
    // ---- reload: a ticket against the global quota per idle lane with an
    // unused pool entry; it starts iff the ticket is below the remaining count
    const bool want = valid && refill_on && done && avail;
    if (lead)
      flag[f] = want && *(volatile int*)s.remaining > 0 && atomicSub(s.remaining, 1) > 0;
    __syncthreads();  // also ends the table staging before the first pass
    if (flag[f]) {
      for (int v = ty; v < c.nc; v += NTY) {
        tile[v * F + f] = m.prior(s.fresh_llr[v * B + b]);
        s.cw[v * B + b] = s.fresh_cw[v * B + b];
      }
      done = 0;
      age = 1;
      iters = 0;
      avail = 0;
      dirty = true;
      ++n_start;
    }
    const bool work = !done || (want && *(volatile int*)s.remaining > 0);
    if (!__syncthreads_or(work)) break;  // also orders the start writes before the pass
    // ---- one full layered iteration over the frames in flight, then the
    // syndrome.  The first pass since a start finds lc2v = 0 without reading
    // the plane (a start does not write the zeros either: this pass writes
    // every slot a later pass reads).
    const bool run = !done;
    const bool checking = run && age >= 1;
    if (lead) berr[f] = 0;
    layered_tile_pass<Msg, FAM, F>(tc, cp, m, tile, hard, s.lc2v, run, age == 1, true, B, b,
                                   &badmask);
    bool newly = false;
    if (checking) {
      newly = !((badmask >> f) & 1u);
      if (!newly) ++iters;
    }
    if (run) ++age;
    const bool finish = run && (newly || age >= cap + 1);
    if (finish) {
      int be = 0;
      for (int t = ty; t < s.nct; t += NTY) {
        const int v = __ldg(s.bit_pos + t);
        be += (int)((hard[v] >> f) & 1) != (int)(s.cw[v * B + b] != 0);
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
    for (int v = ty; v < c.nc; v += NTY) s.app[v * B + b] = tile[v * F + f];
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

// The batch decode of the fast engine on the tile (see the file's note): a
// block owns F frames for the whole decode, all iterations in one launch.
// `lc2v` is the wrapper's uninitialised plane: the first iteration takes it
// as 0 and writes every slot.  `app` is the output, in decoder units.
template <class Msg, int FAM, int F>
__global__ void __launch_bounds__(F * tile_checks(F), F == 8 ? 3 : 1)
bp_decode_layered_fast_tile_kernel(Code c, Layers L, CnParams cp, Msg m,
                                   const float* __restrict__ llr_in, float* __restrict__ app,
                                   int* __restrict__ iters_out, int* __restrict__ iscw_out,
                                   typename Msg::T* __restrict__ lc2v, int nlc, int stage, int B_,
                                   int iterations, int early_term) {
  extern __shared__ float smem[];
  __shared__ unsigned badmask;  // bit f: frame f has an unsatisfied check
  float* tile = smem;                                     // [nc, F] the APP
  uint16_t* hard = (uint16_t*)(tile + (size_t)c.nc * F);  // [nc] bit f: app <= 0
  const int f = threadIdx.x, ty = threadIdx.y;
  constexpr int NTY = tile_checks(F);
  const int tid = ty * F + f, nt = F * NTY;
  const size_t B = B_;
  const size_t b = (size_t)blockIdx.x * F + f;
  const bool valid = b < B;
  const FastTileCode tc =
      fast_tile_code(c, L, nlc, stage, (int*)(hard + 2 * ((c.nc + 1) / 2)), tid, nt);
  if (valid)
    for (int v = ty; v < c.nc; v += NTY) tile[v * F + f] = m.prior(llr_in[v * B + b]);
  bool done = !valid;
  int iters = 0, iscw = 0;
  __syncthreads();  // the tile and the staged tables before the first pass
  for (int it = 0; it < iterations; ++it) {
    // block-level exit once every frame of the block has converged
    if (early_term && !__syncthreads_or(!done)) break;
    const bool syndrome = early_term || it == iterations - 1;
    layered_tile_pass<Msg, FAM, F>(tc, cp, m, tile, hard, lc2v, !done, it == 0, syndrome, B, b,
                                   &badmask);
    if (syndrome && !done) {
      const bool ok = !((badmask >> f) & 1u);
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
  if (valid) {
    for (int v = ty; v < c.nc; v += NTY) app[v * B + b] = tile[v * F + f];
    if (ty == 0) {
      iters_out[b] = early_term ? iters : iterations;
      iscw_out[b] = iscw;
    }
  }
}

inline size_t fast_tile_bytes(int nc, int mc, int nnz, int nl, int nlc, int frames, bool stage) {
  return tile_bytes(nc, frames) + (stage ? table_bytes(mc, nnz, nl, nlc) : (size_t)0);
}

// The launch of the form FRAMES (see LDPC_STREAM_ENTRY).
template <class Msg, int FAM, int FRAMES>
int launch_stream(const Code& c, const Layers& L, const CnParams& cp, const Msg& m,
                  const LayeredStream<typename Msg::T>& s, int nlc, int stage, int B, int k,
                  int cap, cudaStream_t stream) {
  if constexpr (FRAMES == 0) {
    bp_stream_chunk_layered_fast_kernel<Msg, FAM>
        <<<grid_for(B), kBlock, 0, stream>>>(c, L, cp, m, s, B, k, cap);
    return (int)cudaGetLastError();
  } else {
    return launch_smem(bp_stream_chunk_layered_tile_kernel<Msg, FAM, FRAMES>,
                       (B + FRAMES - 1) / FRAMES, dim3(FRAMES, tile_checks(FRAMES)),
                       fast_tile_bytes(c.nc, c.mc, c.nnz, L.nl, nlc, FRAMES, stage != 0), stream,
                       c, L, cp, m, s, nlc, stage, B, k, cap);
  }
}

}  // namespace

// The extern "C" entry of one form, defined by the form's source file
// (one file per form, so the forms compile side by side).  It returns the
// launch's cudaGetLastError() (0 = launched).  `lc2v` is of the type of
// `msg_dtype`; the APP stays float32; `inv_q` is the int8 lattice's prior
// factor (unused otherwise).  FRAMES: 16 or 8 frames a block on the tile
// form (the index tables staged in shared memory when `stage`), 0 the
// HBM-plane form (`nlc` and `stage` unused).
#define LDPC_STREAM_ENTRY(NAME, FRAMES)                                                          \
  extern "C" int NAME(float* app, uint8_t* cw, void* lc2v, int* done, int* iters, int* age,      \
                      int* avail, int* ctr, const float* fresh_llr, const uint8_t* fresh_cw,     \
                      const int* refill, int* remaining, const int* row_ptr,                     \
                      const int* col_sorted, const int* vn_ptr, const int* perm_c2v,             \
                      const int* layer_ptr, const int* layer_checks, const int* bit_pos, int nc, \
                      int mc, int nnz, int nl, int nlc, int nct, int B, int k, int cap,          \
                      int cn_mode, float scale, float offset, int msg_dtype, float inv_q,        \
                      int stage, void* stream) {                                                 \
    Code c{row_ptr, col_sorted, vn_ptr, perm_c2v, nc, mc, nnz};                                  \
    Layers L{layer_ptr, layer_checks, nl};                                                       \
    CnParams cp{cn_mode, scale, offset};                                                         \
    return by_form(msg_dtype, inv_q, cn_mode, [&](auto m, auto fam) {                            \
      using Msg = decltype(m);                                                                   \
      using T = typename Msg::T;                                                                 \
      LayeredStream<T> s{app,      cw,     (T*)lc2v,  done,    iters,  age, avail, ctr,          \
                         fresh_llr, fresh_cw, refill, remaining, bit_pos, nct};                  \
      return launch_stream<Msg, decltype(fam)::value, FRAMES>(c, L, cp, m, s, nlc, stage, B, k,  \
                                                              cap, (cudaStream_t)stream);        \
    });                                                                                          \
  }

// The extern "C" entry of the batch decode's tile form at FRAMES (16 or 8)
// frames a block, defined by the form's source file.  The arguments are
// those of ldpc_bp_decode_layered_fast (decode_layered.cu), plus `nlc` and
// `stage`: the index tables staged in shared memory.
#define LDPC_FAST_BATCH_ENTRY(NAME, FRAMES)                                                      \
  extern "C" int NAME(const float* llr_in, float* app, int* iters, int* iscw, void* lc2v,        \
                      const int* row_ptr, const int* col_sorted, const int* vn_ptr,              \
                      const int* perm_c2v, const int* layer_ptr, const int* layer_checks,        \
                      int nc, int mc, int nnz, int nl, int nlc, int B, int iterations,           \
                      int early_term, int cn_mode, float scale, float offset, int msg_dtype,     \
                      float inv_q, int stage, void* stream) {                                    \
    Code c{row_ptr, col_sorted, vn_ptr, perm_c2v, nc, mc, nnz};                                  \
    Layers L{layer_ptr, layer_checks, nl};                                                       \
    CnParams cp{cn_mode, scale, offset};                                                         \
    return by_form(msg_dtype, inv_q, cn_mode, [&](auto m, auto fam) {                            \
      using Msg = decltype(m);                                                                   \
      return launch_smem(                                                                        \
          bp_decode_layered_fast_tile_kernel<Msg, decltype(fam)::value, FRAMES>,                 \
          (B + FRAMES - 1) / FRAMES, dim3(FRAMES, tile_checks(FRAMES)),                          \
          fast_tile_bytes(nc, mc, nnz, nl, nlc, FRAMES, stage != 0), (cudaStream_t)stream, c, L, \
          cp, m, llr_in, app, iters, iscw, (typename Msg::T*)lc2v, nlc, stage, B, iterations,    \
          early_term);                                                                           \
    });                                                                                          \
  }
