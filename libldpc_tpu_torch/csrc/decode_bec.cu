// BEC peeling decode kernels for Hopper (sm_90a).
//
// Replaces the BEC forms of the TPU kernels of
// libldpc_tpu/ops/pallas/decode_lanes.py:
//   * bec_decode_fused_kernel       <- `kernel` with bec_mode (via bec_decode_lanes,
//                                      convergence predicate `resolved`)
//   * bec_stream_chunk_fused_kernel <- `kernel_stream` with bec_mode (via
//                                      bp_stream_chunk_lanes), on the chunk shared
//                                      with the BP stream kernel (stream_chunk.cuh)
// They compute what bec_decode_sorted computes (libldpc_tpu_torch/ops/
// bec_sorted.py): flooding peeling over the 3-state alphabet {0, 1, E = 2}.
//
// The TPU kernels run the peeling as min-sum over the sign encoding
// 0 -> +1, 1 -> -1, E -> 0 in f32/bf16 (the only in-kernel gather they have
// is a permutation network, and min-sum is what those kernels already
// compute).  Here the algebra is the exact integer one on bytes: nothing
// grows (the sign encoding's magnitudes grow by about dv - 1 per iteration
// and can reach inf, then NaN, on a frame stuck on a stopping set), and a
// message is 1 byte instead of 4.  Results are bit-exact with the plain
// version and with the JAX package's BEC decoders.
//
// Check update, from the check's erasure count and XOR (no per-thread
// arrays): with two or more erased inputs every output is E; with one, the
// erased edge gets the XOR of the others and every other edge E; with none,
// edge e gets XOR ^ m_e.  A degree-1 check emits 0.
// Variable update, given the true bit xi: a channel-known bit sends xi on
// every edge and is its own posterior; an erased one sends xi on an edge if
// any other incoming message equals xi, else E, and its posterior is xi if
// any incoming message equals xi.  A degree-1 variable's posterior is its
// raw message and it sends E, or the stale byte (the reference's
// bug-compatible mode, stale >= 0); a degree-0 variable keeps its symbol.
// A frame is resolved when none of its nc posteriors is E.
//
// Layout and block shape as in decode_fused.cu: [rows, B] planes with frames
// fastest, 32 frames (one per lane) x 8 warps per block, each phase split
// over the warps, index tables through __ldg (broadcast loads).
//
// What bounds it: device-memory traffic, as for kernel 1, at a quarter of
// the bytes.  Per frame and iteration the CN phase reads lv2c (up to twice:
// the second read of a check's slots mostly hits L1) and writes lc2v, the
// VN phase reads lc2v at each slot (up to twice) and the symbol and true bit
// of each variable, and writes lv2c and the posterior: ~4 B per slot plus
// ~3 B per variable, ~17 KB per frame-iteration for the 1152-node (3,6)
// code.  At B = 16384 a message plane is 57 MB, past the 50 MB L2.  As in
// kernel 1, a block stops once all of its frames are resolved and a
// resolved frame issues no loads; no message stays on chip across phases.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bp_phases.cuh"
#include "stream_chunk.cuh"

namespace {

constexpr uint8_t kErased = 2;

// CN phase over this warp's checks: lv2c -> lc2v.
__device__ void bec_cn_phase(const Code& c, const uint8_t* __restrict__ lv2c,
                             uint8_t* __restrict__ lc2v, size_t B, size_t b) {
  for (int r = threadIdx.y; r < c.mc; r += blockDim.y) {
    const int e0 = __ldg(c.row_ptr + r);
    const int e1 = __ldg(c.row_ptr + r + 1);
    if (e1 - e0 == 1) {
      lc2v[e0 * B + b] = 0;
      continue;
    }
    int n_erased = 0;
    uint8_t parity = 0;
    for (int e = e0; e < e1; ++e) {
      const uint8_t m = lv2c[e * B + b];
      if (m == kErased)
        ++n_erased;
      else
        parity ^= m;
    }
    for (int e = e0; e < e1; ++e) {
      uint8_t out = kErased;
      if (n_erased == 0) {
        out = parity ^ lv2c[e * B + b];
      } else if (n_erased == 1 && lv2c[e * B + b] == kErased) {
        out = parity;
      }
      lc2v[e * B + b] = out;
    }
  }
}

// VN phase over this warp's variables: lc2v -> lv2c and the posterior.
// Sets unresolved[lane] when one of this warp's posteriors is E.
__device__ void bec_vn_phase(const Code& c, const uint8_t* __restrict__ sym,
                             const uint8_t* __restrict__ cw, uint8_t* __restrict__ lv2c,
                             const uint8_t* __restrict__ lc2v, uint8_t* __restrict__ post,
                             size_t B, size_t b, int stale, volatile int* unresolved) {
  bool any_erased = false;
  for (int v = threadIdx.y; v < c.nc; v += blockDim.y) {
    const int s0 = __ldg(c.vn_ptr + v);
    const int s1 = __ldg(c.vn_ptr + v + 1);
    const uint8_t xi = cw[v * B + b];
    uint8_t p;
    if (sym[v * B + b] != kErased) {
      p = xi;
      for (int s = s0; s < s1; ++s) lv2c[__ldg(c.perm_c2v + s) * B + b] = xi;
    } else if (s1 - s0 == 1) {
      const size_t e = __ldg(c.perm_c2v + s0) * B + b;
      p = lc2v[e];
      lv2c[e] = stale >= 0 ? (uint8_t)stale : kErased;
    } else {
      int n_match = 0;
      for (int s = s0; s < s1; ++s) n_match += lc2v[__ldg(c.perm_c2v + s) * B + b] == xi;
      p = n_match > 0 ? xi : kErased;
      for (int s = s0; s < s1; ++s) {
        const size_t e = __ldg(c.perm_c2v + s) * B + b;
        lv2c[e] = n_match - (lc2v[e] == xi) > 0 ? xi : kErased;
      }
    }
    post[v * B + b] = p;
    any_erased |= p == kErased;
  }
  if (any_erased) unresolved[threadIdx.x] = 1;
}

// The whole decode of a batch, all iterations in one launch, with per-frame
// early termination (break-before-increment iteration counts).  The
// posterior plane is sym_out itself: a resolved frame stops writing it.
// unresolved[] is double-buffered by iteration parity, so resetting next
// iteration's flags never races with this iteration's marks.
__global__ void __launch_bounds__(LDPC_FRAMES * LDPC_WARPS)
bec_decode_fused_kernel(Code c, const uint8_t* __restrict__ sym_in,
                        const uint8_t* __restrict__ cw, uint8_t* __restrict__ sym_out,
                        uint8_t* __restrict__ hard, int* __restrict__ iters_out,
                        int* __restrict__ resolved_out, uint8_t* __restrict__ lv2c,
                        uint8_t* __restrict__ lc2v, int B_, int iterations, int early_term,
                        int stale) {
  __shared__ int unresolved[2][LDPC_FRAMES];
  const size_t B = B_;
  const size_t b = (size_t)blockIdx.x * LDPC_FRAMES + threadIdx.x;
  const bool valid = b < B;
  const bool lead = threadIdx.y == 0;
  if (valid)
    for (int e = threadIdx.y; e < c.nnz; e += blockDim.y)
      lv2c[e * B + b] = sym_in[__ldg(c.col_sorted + e) * B + b];
  if (lead) {
    unresolved[0][threadIdx.x] = 0;
    unresolved[1][threadIdx.x] = 0;
  }
  bool done = !valid;
  int iters = 0, resolved = 0;
  for (int it = 0; it < iterations; ++it) {
    // block-level exit once every frame of the block is resolved (also
    // orders the previous pass's writes before this pass's reads)
    if (!__syncthreads_or(!done)) break;
    const int buf = it & 1;
    if (!done) bec_cn_phase(c, lv2c, lc2v, B, b);
    __syncthreads();
    if (lead) unresolved[buf ^ 1][threadIdx.x] = 0;
    if (!done) bec_vn_phase(c, sym_in, cw, lv2c, lc2v, sym_out, B, b, stale, unresolved[buf]);
    __syncthreads();
    if (!done) {
      const bool ok = !unresolved[buf][threadIdx.x];
      resolved = ok;
      if (early_term && ok)
        done = true;  // a frame resolved at this pass is not counted
      else
        ++iters;
    }
  }
  // decisions: the true bit where resolved, the wrong bit where not (each
  // thread reads back only the posteriors it wrote)
  if (valid) {
    for (int v = threadIdx.y; v < c.nc; v += blockDim.y) {
      const uint8_t x = cw[v * B + b];
      const uint8_t wrong = stale >= 0 ? 1 : 1 - x;
      hard[v * B + b] = sym_out[v * B + b] == kErased ? wrong : x;
    }
    if (lead) {
      iters_out[b] = iters;
      resolved_out[b] = resolved;
    }
  }
}

// The BEC pass of the streaming chunk: peeling CN and VN phases; the VN
// phase marks unresolved frames, so there is no separate check.  A bit is
// wrong where its posterior is E (and, in the bug-compatible mode, whose
// constant decision 1 differs from the true bit).
struct BecStreamPass {
  using V = uint8_t;
  using M = uint8_t;
  uint8_t* lc2v;  // [nnz, B] scratch
  int stale;
  __device__ void cn(const Code& c, const uint8_t* lv2c, size_t B, size_t b) const {
    bec_cn_phase(c, lv2c, lc2v, B, b);
  }
  __device__ void vn(const Code& c, const uint8_t* sym, const uint8_t* cw, uint8_t* lv2c,
                     uint8_t* post, size_t B, size_t b, volatile int* flag) const {
    bec_vn_phase(c, sym, cw, lv2c, lc2v, post, B, b, stale, flag);
  }
  __device__ void check(const Code&, const uint8_t*, size_t, size_t, volatile int*) const {}
  __device__ bool bit_error(uint8_t p, uint8_t cw) const {
    return p == kErased && (stale < 0 || cw == 0);
  }
  __device__ uint8_t reload(uint8_t sym) const { return sym; }
};

// k self-refilling BEC passes per lane (see `kernel_stream`).
__global__ void __launch_bounds__(LDPC_FRAMES * LDPC_WARPS)
bec_stream_chunk_fused_kernel(Code c, BecStreamPass pass, StreamArgs<uint8_t, uint8_t> s, int B, int k,
                              int cap) {
  stream_chunk(c, pass, s, B, k, cap);
}

}  // namespace

extern "C" {

// Each returns the launch's cudaGetLastError() (0 = launched).
int ldpc_bec_decode_fused(const uint8_t* sym_in, const uint8_t* cw, uint8_t* sym_out,
                          uint8_t* hard, int* iters, int* resolved, uint8_t* lv2c, uint8_t* lc2v,
                          const int* row_ptr, const int* col_sorted, const int* vn_ptr,
                          const int* perm_c2v, int nc, int mc, int nnz, int B, int iterations,
                          int early_term, int stale, void* stream) {
  Code c{row_ptr, col_sorted, vn_ptr, perm_c2v, nc, mc, nnz};
  bec_decode_fused_kernel<<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>(
      c, sym_in, cw, sym_out, hard, iters, resolved, lv2c, lc2v, B, iterations, early_term, stale);
  return (int)cudaGetLastError();
}

int ldpc_bec_stream_chunk_fused(uint8_t* sym, uint8_t* cw, uint8_t* lv2c, int* done, int* iters,
                                int* age, int* avail, int* ctr, const uint8_t* fresh_sym,
                                const uint8_t* fresh_cw, const int* refill, int* remaining,
                                uint8_t* lc2v, uint8_t* post, const int* row_ptr,
                                const int* col_sorted, const int* vn_ptr, const int* perm_c2v,
                                const int* bit_pos, int nc, int mc, int nnz, int nct, int B, int k,
                                int cap, int stale, void* stream) {
  Code c{row_ptr, col_sorted, vn_ptr, perm_c2v, nc, mc, nnz};
  BecStreamPass pass{lc2v, stale};
  StreamArgs<uint8_t, uint8_t> s{sym,    cw,        lv2c,      done, iters,   age,
                                 avail,  ctr,       fresh_sym, fresh_cw, refill, remaining,
                                 post,   bit_pos,   nct};
  bec_stream_chunk_fused_kernel<<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>(c, pass, s, B,
                                                                                  k, cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
