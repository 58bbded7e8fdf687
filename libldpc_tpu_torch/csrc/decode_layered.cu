// Layered BP decode kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of libldpc_tpu/ops/pallas/:
//   * bp_decode_layered_fast_kernel       <- decode_lanes.py `kernel_layered_qc`
//                                            (with `_qc_engine`, via bp_decode_lanes)
//   * bp_stream_chunk_layered_fast_kernel <- decode_lanes.py `kernel_stream_layered_qc`
//                                            (via bp_stream_chunk_lanes(layered=True))
//   * bp_decode_layered_kernel            <- decode_fused.py `kernel_layered` and
//                                            decode_lanes.py `kernel_layered` (one
//                                            function in two TPU layouts)
//
// The fast engine (first two) keeps the node posterior (APP) as state and
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
// The exact schedule (third kernel) mirrors the XLA layered decoder: per
// layer, the layer's checks refresh their messages (the CN phase may skip
// the other checks, whose outputs the JAX version masks away), then every
// variable recomputes its posterior from all current messages and every
// slot its extrinsic, and with early termination a frame whose syndrome is
// satisfied after any layer is frozen for the rest of the decode.  An
// iteration counts for a frame unconverged at its start and at its end.
//
// Message forms: each kernel is instantiated for float32, bfloat16 and int8
// message storage (the TPU kernels' `message_dtype`; traits in
// cn_forms.cuh), behind one extern "C" entry that takes the dtype code, as
// in decode_fused.cu.  The fast engine stores lc2v in the form and keeps
// the APP float32, in decoder units (lattice units for int8: it starts at
// prior(llr) = llr * float32(1/quant_scale)) and never rounded; lv and o are
// rounded into the message domain (Msg::round) before and after the
// combine, as `_qc_engine`'s to_msg does.  The exact schedule stores lv2c,
// lc2v and the posterior in the form, with the store points of the flooding
// kernels (bp_phases.cuh), and starts lv2c at store(prior(llr)).
//
// Layout, block shape and exactness as in decode_fused.cu: planes are
// [rows, B] with frames fastest, a block holds 32 frames (one per lane)
// and 8 warps, the file is built with -fmad=false, and the arithmetic
// follows the plain PyTorch versions operation for operation
// (lv = round(app - st), o = round(postprocess(...)), delta = o - st,
// app = app + delta; the combine of cn_forms.cuh), so the min-sum family is
// bit-exact against them.
//
// What bounds it: modelled as device-memory traffic.  The fast engine
// reads and writes the APP and lc2v at every slot once per iteration
// (~16 B per slot and frame in float32, plus the syndrome's APP reads),
// about what one flooding pass of kernel 1 moves; for the 802.11n n=1944
// code at B = 16384 the APP plane is 127 MB and lc2v 456 MB (228 MB in
// bfloat16, 114 MB in int8), far past the 50 MB L2.  The exact schedule
// pays a full VN phase (and a syndrome) per layer: ~n_layers flooding
// passes per iteration.  Kernel 1 takes the same time with 4-, 2- and
// 1-byte messages (see decode_fused.cu), so the combine's local arrays and
// the dependent index loads are the suspects here too.  This first design
// keeps messages in HBM planes; holding a frame's APP in shared memory
// across layers is later work.

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

// One check of the fast engine for frame b.  Its slots' variables are
// distinct from those of every other check of the layer (see above), so
// the read-modify-write of app is this thread's alone within the layer.
template <class Msg>
__device__ __forceinline__ void fast_check(const Code& c, const CnParams& cp, const Msg& m,
                                           float* __restrict__ app,
                                           typename Msg::T* __restrict__ lc2v, int r, size_t B,
                                           size_t b) {
  const int e0 = __ldg(c.row_ptr + r);
  const int d = __ldg(c.row_ptr + r + 1) - e0;
  if (d == 0) return;
  check_combine(
      cp, d,
      [&](int j) {
        return m.round(app[__ldg(c.col_sorted + e0 + j) * B + b] - m.load(lc2v[(e0 + j) * B + b]));
      },
      [&](int j, float o) {
        const size_t v = __ldg(c.col_sorted + e0 + j) * B + b;
        const size_t e = (e0 + j) * B + b;
        o = m.round(o);
        const float delta = o - m.load(lc2v[e]);
        app[v] = app[v] + delta;
        lc2v[e] = m.store(o);
      });
}

// One full layered iteration of the fast engine for frame b (skipped when
// !run); every thread of the block calls it, for the barriers.
template <class Msg>
__device__ void fast_pass(const Code& c, const Layers& L, const CnParams& cp, const Msg& m,
                          float* __restrict__ app, typename Msg::T* __restrict__ lc2v, bool run,
                          size_t B, size_t b) {
  for (int l = 0; l < L.nl; ++l) {
    if (run) {
      const int k1 = __ldg(L.ptr + l + 1);
      for (int k = __ldg(L.ptr + l) + threadIdx.y; k < k1; k += blockDim.y)
        fast_check(c, cp, m, app, lc2v, __ldg(L.checks + k), B, b);
    }
    __syncthreads();  // the next layer reads what this one wrote
  }
}

// Batch decode on the fast engine, all iterations in one launch.  Control
// state is kept per thread and updated identically by every thread of a
// frame, as in bp_decode_fused_kernel.  `app` is the output, in decoder
// units (the wrapper dequantises it).
template <class Msg>
__global__ void __launch_bounds__(LDPC_FRAMES * LDPC_WARPS)
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
    fast_pass(c, L, cp, m, app, lc2v, !done, B, b);
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

// k self-refilling passes per lane on the fast engine (see
// `kernel_stream_layered_qc`): a lane in flight at age 0 starts the engine,
// an idle lane reloads from the pool under the exact quota (as in
// bp_stream_chunk_fused_kernel), then a lane in flight runs one full
// layered iteration and is counted at the pass that finishes it.  The
// `app` plane is the persistent APP in decoder units: a start takes the
// prior of the LLRs it carries, a reload the prior of its pool entry (the
// pool stays raw float32 LLRs), as the JAX kernel's `prior_mul` does.
// `lc2v` holds the CN-space check messages in the form (0 on start).
// Counter rows: 0 bit errors (transmitted bits, decided from the APP),
// 1 frame errors, 2 frames, 3 iteration sum, 4 starts.
template <class Msg>
__global__ void __launch_bounds__(LDPC_FRAMES * LDPC_WARPS)
bp_stream_chunk_layered_fast_kernel(Code c, Layers L, CnParams cp, Msg m, float* __restrict__ app,
                                    uint8_t* __restrict__ cw, typename Msg::T* __restrict__ lc2v,
                                    int* __restrict__ done_p, int* __restrict__ iters_p,
                                    int* __restrict__ age_p, int* __restrict__ avail_p,
                                    int* __restrict__ ctr, const float* __restrict__ fresh_llr,
                                    const uint8_t* __restrict__ fresh_cw,
                                    const int* __restrict__ refill, int* remaining,
                                    const int* __restrict__ bit_pos, int nct, int B_, int k,
                                    int cap) {
  __shared__ int flag[LDPC_FRAMES];  // start granted, then check unsatisfied
  __shared__ int berr[LDPC_FRAMES];  // bit errors of a finishing frame
  const size_t B = B_;
  const size_t b = (size_t)blockIdx.x * LDPC_FRAMES + threadIdx.x;
  const bool valid = b < B;
  const bool lead = threadIdx.y == 0;
  int done = 1, iters = 0, age = 0, avail = 0;
  if (valid) {
    done = done_p[b];
    iters = iters_p[b];
    age = age_p[b];
    avail = avail_p[b];
  }
  const bool refill_on = *refill != 0;
  int n_bit = 0, n_frame_err = 0, n_frames = 0, n_iter = 0, n_start = 0;
  for (int pass = 0; pass < k; ++pass) {
    // ---- a lane injected in flight (age 0) starts the engine: APP = the
    // prior of the LLRs it carries, lc2v = 0, and this pass is iteration 1
    if (!done && age == 0) {
      for (int v = threadIdx.y; v < c.nc; v += blockDim.y) app[v * B + b] = m.prior(app[v * B + b]);
      for (int e = threadIdx.y; e < c.nnz; e += blockDim.y) lc2v[e * B + b] = m.store(0.0f);
      age = 1;
    }
    // ---- reload: a ticket against the global quota per idle lane with an
    // unused pool entry; it starts iff the ticket is below the remaining count
    const bool want = valid && refill_on && done && avail;
    if (lead)
      flag[threadIdx.x] =
          want && *(volatile int*)remaining > 0 && atomicSub(remaining, 1) > 0;
    __syncthreads();
    if (flag[threadIdx.x]) {
      for (int v = threadIdx.y; v < c.nc; v += blockDim.y) {
        app[v * B + b] = m.prior(fresh_llr[v * B + b]);
        cw[v * B + b] = fresh_cw[v * B + b];
      }
      for (int e = threadIdx.y; e < c.nnz; e += blockDim.y) lc2v[e * B + b] = m.store(0.0f);
      done = 0;
      age = 1;
      iters = 0;
      avail = 0;
      ++n_start;
    }
    const bool work = !done || (want && *(volatile int*)remaining > 0);
    if (!__syncthreads_or(work)) break;  // also orders the start writes before the pass
    // ---- one full layered iteration over the lanes in flight
    const bool run = !done;
    const bool checking = run && age >= 1;
    fast_pass(c, L, cp, m, app, lc2v, run, B, b);
    if (lead) {
      flag[threadIdx.x] = 0;
      berr[threadIdx.x] = 0;
    }
    __syncthreads();
    if (checking) syndrome_part(c, F32Msg{}, app, B, b, flag);
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
      for (int t = threadIdx.y; t < nct; t += blockDim.y) {
        size_t v = __ldg(bit_pos + t) * B + b;
        be += (app[v] <= 0.0f) != (cw[v] != 0);
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
    done_p[b] = done;
    iters_p[b] = iters;
    age_p[b] = age;
    avail_p[b] = avail;
    ctr[0 * B + b] += n_bit;
    ctr[1 * B + b] += n_frame_err;
    ctr[2 * B + b] += n_frames;
    ctr[3 * B + b] += n_iter;
    ctr[4 * B + b] += n_start;
  }
}

// The exact layered schedule, all iterations in one launch.  `post` is the
// stored posterior (the output, in the storage type: the wrapper widens it).
template <class Msg>
__global__ void __launch_bounds__(LDPC_FRAMES * LDPC_WARPS)
bp_decode_layered_kernel(Code c, Layers L, CnParams cp, Msg m, const float* __restrict__ llr_in,
                         typename Msg::T* __restrict__ post, int* __restrict__ iters_out,
                         int* __restrict__ iscw_out, typename Msg::T* __restrict__ lv2c,
                         typename Msg::T* __restrict__ lc2v, int B_, int iterations,
                         int early_term) {
  __shared__ int bad[LDPC_FRAMES];
  const size_t B = B_;
  const size_t b = (size_t)blockIdx.x * LDPC_FRAMES + threadIdx.x;
  const bool valid = b < B;
  const bool lead = threadIdx.y == 0;
  if (valid)
    for (int e = threadIdx.y; e < c.nnz; e += blockDim.y) {
      lv2c[e * B + b] = m.store(m.prior(llr_in[__ldg(c.col_sorted + e) * B + b]));
      lc2v[e * B + b] = m.store(0.0f);
    }
  bool done = !valid;
  int iters = 0, iscw = 0;
  __syncthreads();
  for (int it = 0; it < iterations; ++it) {
    if (early_term && !__syncthreads_or(!done)) break;
    const bool done_start = done;
    for (int l = 0; l < L.nl; ++l) {
      const bool check = !done && (early_term || (it == iterations - 1 && l == L.nl - 1));
      if (!done) {
        const int k1 = __ldg(L.ptr + l + 1);
        for (int k = __ldg(L.ptr + l) + threadIdx.y; k < k1; k += blockDim.y) {
          const int r = __ldg(L.checks + k);
          const int e0 = __ldg(c.row_ptr + r);
          const int d = __ldg(c.row_ptr + r + 1) - e0;
          if (d > 0) check_update(cp, m, lv2c, lc2v, e0, d, B, b);
        }
      }
      __syncthreads();
      if (lead) bad[threadIdx.x] = 0;
      if (!done) vn_phase(c, m, llr_in, lv2c, lc2v, post, B, b);
      __syncthreads();
      if (check) syndrome_part(c, m, post, B, b, bad);
      __syncthreads();
      if (check) {
        const bool ok = !bad[threadIdx.x];
        if (!early_term) {
          iscw = ok;
        } else if (ok) {
          done = true;  // frozen: later layers and iterations skip it
          iscw = 1;
        }
      }
    }
    if (early_term && !done_start && !done) ++iters;
  }
  if (valid && lead) {
    iters_out[b] = early_term ? iters : iterations;
    iscw_out[b] = iscw;
  }
}

template <class Msg>
int launch_fast(const Code& c, const Layers& L, const CnParams& cp, const Msg& m,
                const float* llr_in, float* app, int* iters, int* iscw, void* lc2v, int B,
                int iterations, int early_term, cudaStream_t stream) {
  bp_decode_layered_fast_kernel<Msg><<<grid_for(B), kBlock, 0, stream>>>(
      c, L, cp, m, llr_in, app, iters, iscw, (typename Msg::T*)lc2v, B, iterations, early_term);
  return (int)cudaGetLastError();
}

template <class Msg>
int launch_stream(const Code& c, const Layers& L, const CnParams& cp, const Msg& m, float* app,
                  uint8_t* cw, void* lc2v, int* done, int* iters, int* age, int* avail, int* ctr,
                  const float* fresh_llr, const uint8_t* fresh_cw, const int* refill,
                  int* remaining, const int* bit_pos, int nct, int B, int k, int cap,
                  cudaStream_t stream) {
  bp_stream_chunk_layered_fast_kernel<Msg><<<grid_for(B), kBlock, 0, stream>>>(
      c, L, cp, m, app, cw, (typename Msg::T*)lc2v, done, iters, age, avail, ctr, fresh_llr,
      fresh_cw, refill, remaining, bit_pos, nct, B, k, cap);
  return (int)cudaGetLastError();
}

template <class Msg>
int launch_exact(const Code& c, const Layers& L, const CnParams& cp, const Msg& m,
                 const float* llr_in, void* post, int* iters, int* iscw, void* lv2c, void* lc2v,
                 int B, int iterations, int early_term, cudaStream_t stream) {
  using T = typename Msg::T;
  bp_decode_layered_kernel<Msg><<<grid_for(B), kBlock, 0, stream>>>(
      c, L, cp, m, llr_in, (T*)post, iters, iscw, (T*)lv2c, (T*)lc2v, B, iterations, early_term);
  return (int)cudaGetLastError();
}

// Message dtype codes (ops/messages.py DTYPE_CODES)
enum MsgDtype { MSG_F32 = 0, MSG_BF16 = 1, MSG_INT8 = 2 };

}  // namespace

// One instantiation per message form: `launch` is launch_fast, launch_stream
// or launch_exact, called with the form's traits before its other arguments.
#define LDPC_BY_DTYPE(launch, ...)                                \
  switch (msg_dtype) {                                            \
    case MSG_F32:                                                 \
      return launch(c, L, cp, F32Msg{}, __VA_ARGS__);             \
    case MSG_BF16:                                                \
      return launch(c, L, cp, Bf16Msg{}, __VA_ARGS__);            \
    case MSG_INT8:                                                \
      return launch(c, L, cp, Int8Msg{inv_q}, __VA_ARGS__);       \
  }                                                               \
  return (int)cudaErrorInvalidValue;

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
  LDPC_BY_DTYPE(launch_fast, llr_in, app, iters, iscw, lc2v, B, iterations, early_term,
                (cudaStream_t)stream)
}

int ldpc_bp_stream_chunk_layered_fast(float* app, uint8_t* cw, void* lc2v, int* done, int* iters,
                                      int* age, int* avail, int* ctr, const float* fresh_llr,
                                      const uint8_t* fresh_cw, const int* refill, int* remaining,
                                      const int* row_ptr, const int* col_sorted, const int* vn_ptr,
                                      const int* perm_c2v, const int* layer_ptr,
                                      const int* layer_checks, const int* bit_pos, int nc, int mc,
                                      int nnz, int nl, int nct, int B, int k, int cap, int cn_mode,
                                      float scale, float offset, int msg_dtype, float inv_q,
                                      void* stream) {
  Code c{row_ptr, col_sorted, vn_ptr, perm_c2v, nc, mc, nnz};
  Layers L{layer_ptr, layer_checks, nl};
  CnParams cp{cn_mode, scale, offset};
  LDPC_BY_DTYPE(launch_stream, app, cw, lc2v, done, iters, age, avail, ctr, fresh_llr, fresh_cw,
                refill, remaining, bit_pos, nct, B, k, cap, (cudaStream_t)stream)
}

int ldpc_bp_decode_layered(const float* llr_in, void* post, int* iters, int* iscw, void* lv2c,
                           void* lc2v, const int* row_ptr, const int* col_sorted,
                           const int* vn_ptr, const int* perm_c2v, const int* layer_ptr,
                           const int* layer_checks, int nc, int mc, int nnz, int nl, int B,
                           int iterations, int early_term, int cn_mode, float scale, float offset,
                           int msg_dtype, float inv_q, void* stream) {
  Code c{row_ptr, col_sorted, vn_ptr, perm_c2v, nc, mc, nnz};
  Layers L{layer_ptr, layer_checks, nl};
  CnParams cp{cn_mode, scale, offset};
  LDPC_BY_DTYPE(launch_exact, llr_in, post, iters, iscw, lv2c, lc2v, B, iterations, early_term,
                (cudaStream_t)stream)
}

}  // extern "C"
