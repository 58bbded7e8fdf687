// BEC peeling decode kernels for Hopper (sm_90a).
//
// Replaces the BEC forms of the TPU kernels of
// libldpc_tpu/ops/pallas/decode_lanes.py:
//   * bec_decode_words_kernel       <- `kernel` with bec_mode (via bec_decode_lanes,
//                                      convergence predicate `resolved`)
//   * bec_stream_words_kernel       <- `kernel_stream` with bec_mode (via
//     (bec_stream_words.cuh)           bp_stream_chunk_lanes, convergence `resolved`
//                                      at :714, errors the unresolved transmitted
//                                      bits at :729): the word form
//   * bec_stream_chunk_fused_kernel <- the same, on byte planes: the chunk shared
//                                      with the BP stream kernel's HBM-plane form
//                                      (stream_chunk.cuh), for a code whose words
//                                      do not fit a block's shared memory
// They compute what bec_decode_sorted computes (libldpc_tpu_torch/ops/
// bec_sorted.py): flooding peeling over the 3-state alphabet {0, 1, E = 2}.
//
// The TPU kernels run the peeling as min-sum over the sign encoding
// 0 -> +1, 1 -> -1, E -> 0 in f32/bf16 (the only in-kernel gather they have
// is a permutation network, and min-sum is what those kernels already
// compute).  Here the algebra is the exact integer one: nothing grows (the
// sign encoding's magnitudes grow by about dv - 1 per iteration and can
// reach inf, then NaN, on a frame stuck on a stopping set).  Results are
// bit-exact with the plain version and with the JAX package's BEC decoders.
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
// The batch kernel is bit-sliced: a symbol is two bits, `known` and
// `value`, and the 32 frames of a block make one 32-bit word of each, so
// one integer instruction does the algebra for 32 frames (ops/bec_sorted.py
// bec_words_pass is the same algebra in plain PyTorch).  "At least one" and
// "at least two" accumulators (acc2 |= acc1 & x; acc1 |= x) stand for the
// counts.  One block owns one word: it packs 32 consecutive bytes of each
// row of sym_in and cw with __ballot_sync, keeps the channel words, the
// codeword, the posterior and one message plane pair (known, value) for
// the whole decode, and unpacks sym_out and hard at the end.  Its 256
// threads split the checks, then the variables; both updates run in place
// (a node's thread reads all of its slots before it writes any, and no
// other thread touches them within the phase).  A frame that has resolved
// is masked out of every write (`live`), so it keeps the messages and the
// posterior of the pass that resolved it, as the plain version freezes it,
// and the block leaves when its word is empty.  The state is 4 nc + 2 nnz
// words: 46 KB for the 1152-node (3,6) code, 87 KB for the 802.11n n=1944
// code, in shared memory; a code whose state passes a block's shared memory
// keeps the same words in a device-memory scratch, one row per block (the
// wrapper's size rule chooses, ops/kernels/decode_bec.py).
//
// The streaming kernel runs the same words (bec_stream_words.cuh): a
// block's word lives in shared memory for the whole chunk, packed from the
// carried [rows, B] u8 planes at entry and unpacked at exit, with the
// reload, the start quota and the counters of stream_chunk.cuh on words.
// For a code whose words pass a block's shared memory it keeps the byte
// algebra on [rows, B] u8 planes (stream_chunk.cuh: 32 frames, one per
// lane, x 8 warps per block, each phase split over the warps, index tables
// through __ldg); the wrapper's size rule chooses (ops/kernels/decode_bec.py
// bec_stream_form).
//
// What bounds them: the batch kernel's bytes in and out (sym_in and cw read,
// sym_out and hard written, once) are 4 nc B bytes, 75 MB at B = 16384 for
// the 1152 code; its work is ~40 word operations per slot and iteration for
// 32 frames, served from shared memory, so the instruction count and the three
// block barriers per iteration set its time, not device memory.  The word
// chunk moves its state once a chunk and adds a barrier a pass for the
// control step, two for a reload and one for a count of finishing frames'
// errors.  The byte chunk makes one byte load per slot, frame and
// phase: as many instructions as the float kernels for a quarter of the
// bytes; it is bound by its instruction count and dependent loads.
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

// ------------------------------------------------------- the batch kernel

#define LDPC_BEC_THREADS 256

// The state of one 32-frame word, as uint32 arrays: channel-known and
// codeword bits per variable, the posterior (known, value) per variable,
// and one message plane pair (known, value) per CN-space slot.
struct BecWords {
  uint32_t* chk;  // [nc] bit f: the channel knows the bit of frame f
  uint32_t* xi;   // [nc] the true bits
  uint32_t* pk;   // [nc] posterior known
  uint32_t* pv;   // [nc] posterior value (0 where erased)
  uint32_t* mk;   // [nnz] message known
  uint32_t* mv;   // [nnz] message value (0 where erased)
};

// The words of one 32-frame word's state, laid out from `base`
// (4 nc + 2 nnz words).
__device__ __forceinline__ BecWords bec_words_at(uint32_t* base, const Code& c) {
  BecWords w;
  w.chk = base;
  w.xi = w.chk + c.nc;
  w.pk = w.xi + c.nc;
  w.pv = w.pk + c.nc;
  w.mk = w.pv + c.nc;
  w.mv = w.mk + c.nnz;
  return w;
}

__device__ __forceinline__ uint32_t keep(uint32_t old, uint32_t val, uint32_t live) {
  return (old & ~live) | (val & live);
}

// Check update of this thread's checks, in place: lv2c -> lc2v.
__device__ void bec_words_cn(const Code& c, const BecWords& w, uint32_t live) {
  for (int r = threadIdx.x; r < c.mc; r += LDPC_BEC_THREADS) {
    const int e0 = __ldg(c.row_ptr + r);
    const int e1 = __ldg(c.row_ptr + r + 1);
    if (e1 - e0 == 1) {  // the empty XOR: the symbol 0
      w.mk[e0] = keep(w.mk[e0], 0xffffffffu, live);
      w.mv[e0] = keep(w.mv[e0], 0u, live);
      continue;
    }
    uint32_t one = 0, two = 0, parity = 0;  // >= 1 erased, >= 2 erased, XOR of the known
    for (int e = e0; e < e1; ++e) {
      const uint32_t k = w.mk[e];
      two |= one & ~k;
      one |= ~k;
      parity ^= w.mv[e] & k;
    }
    for (int e = e0; e < e1; ++e) {
      const uint32_t k = w.mk[e], v = w.mv[e];
      // known iff no other input is erased: none at all, or only this one
      const uint32_t ok = ~one | (~two & ~k);
      w.mk[e] = keep(k, ok, live);
      w.mv[e] = keep(v, (parity ^ (v & k)) & ok, live);
    }
  }
}

// Variable update of this thread's variables, in place: lc2v -> lv2c and
// the posterior.  Returns the frames with an erased posterior among this
// thread's variables.
__device__ uint32_t bec_words_vn(const Code& c, const BecWords& w, uint32_t live, int stale) {
  uint32_t erased = 0;
  for (int v = threadIdx.x; v < c.nc; v += LDPC_BEC_THREADS) {
    const int s0 = __ldg(c.vn_ptr + v);
    const int s1 = __ldg(c.vn_ptr + v + 1);
    const uint32_t x = w.xi[v], ck = w.chk[v];
    uint32_t pk, pv;
    if (s1 == s0) {  // keeps its channel symbol
      pk = ck;
      pv = x & ck;
    } else if (s1 - s0 == 1) {  // posterior = its raw message; sends E or the stale byte
      const int e = __ldg(c.perm_c2v + s0);
      const uint32_t k = w.mk[e], mv = w.mv[e];
      pk = ck | k;
      pv = (x & ck) | (mv & ~ck);
      const uint32_t ok = stale >= 0 ? 0xffffffffu : ck;
      const uint32_t ov = (x & ck) | (stale > 0 ? ~ck : 0u);
      w.mk[e] = keep(k, ok, live);
      w.mv[e] = keep(mv, ov & ok, live);
    } else {
      uint32_t one = 0, two = 0;  // >= 1, >= 2 incoming messages equal to xi
      for (int s = s0; s < s1; ++s) {
        const int e = __ldg(c.perm_c2v + s);
        const uint32_t match = w.mk[e] & ~(w.mv[e] ^ x);
        two |= one & match;
        one |= match;
      }
      pk = ck | one;
      pv = x & pk;
      for (int s = s0; s < s1; ++s) {
        const int e = __ldg(c.perm_c2v + s);
        const uint32_t k = w.mk[e], mv = w.mv[e];
        const uint32_t match = k & ~(mv ^ x);
        // xi iff the channel knows it or some other message equals xi
        const uint32_t ok = ck | two | (one & ~match);
        w.mk[e] = keep(k, ok, live);
        w.mv[e] = keep(mv, x & ok, live);
      }
    }
    w.pk[v] = keep(w.pk[v], pk, live);
    w.pv[v] = keep(w.pv[v], pv, live);
    erased |= ~pk;
  }
  return erased;
}

// The whole decode of a batch, all iterations in one launch, with per-frame
// early termination (break-before-increment iteration counts).  Block i
// decodes frames 32 i .. 32 i + 31.  GLOBAL: the state lives in `scratch`
// (device memory, [blocks, 4 nc + 2 nnz] words) instead of shared memory.
template <bool GLOBAL>
__global__ void __launch_bounds__(LDPC_BEC_THREADS)
bec_decode_words_kernel(Code c, const uint8_t* __restrict__ sym_in,
                        const uint8_t* __restrict__ cw, uint8_t* __restrict__ sym_out,
                        uint8_t* __restrict__ hard, int* __restrict__ iters_out,
                        int* __restrict__ resolved_out, uint32_t* __restrict__ scratch, int B_,
                        int iterations, int early_term, int stale) {
  extern __shared__ uint32_t bec_smem[];
  __shared__ uint32_t live_s, erased_s;
  uint32_t* base =
      GLOBAL ? scratch + (size_t)blockIdx.x * (4 * (size_t)c.nc + 2 * (size_t)c.nnz) : bec_smem;
  const BecWords w = bec_words_at(base, c);
  const size_t B = B_;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = (size_t)blockIdx.x * 32 + lane;
  const bool valid = b < B;
  // ---- pack: a warp reads 32 consecutive bytes of a row and votes them
  // into words.  A frame past the batch is a known 0: it resolves at once.
  for (int v = warp; v < c.nc; v += LDPC_BEC_THREADS / 32) {
    const uint8_t sym = valid ? sym_in[v * B + b] : (uint8_t)0;
    const uint8_t x = valid ? cw[v * B + b] : (uint8_t)0;
    const uint32_t k = __ballot_sync(0xffffffffu, sym != kErased);
    const uint32_t val = __ballot_sync(0xffffffffu, sym == 1);
    const uint32_t xw = __ballot_sync(0xffffffffu, x != 0);
    if (lane == 0) {
      w.chk[v] = k;
      w.pv[v] = val;  // the channel's values, until the first pass writes the posterior
      w.xi[v] = xw;
      w.pk[v] = 0;
    }
  }
  if (tid == 0) {
    const size_t left = B - (size_t)blockIdx.x * 32;
    live_s = left >= 32 ? 0xffffffffu : (1u << left) - 1u;
  }
  __syncthreads();
  // the first messages: each slot's channel symbol
  for (int e = tid; e < c.nnz; e += LDPC_BEC_THREADS) {
    const int v = __ldg(c.col_sorted + e);
    w.mk[e] = w.chk[v];
    w.mv[e] = w.pv[v];
  }
  int iters = 0, resolved = 0;  // of frame `tid`, in the first warp
  for (int it = 0; it < iterations; ++it) {
    __syncthreads();  // orders the previous pass's writes before this pass's reads
    const uint32_t live = live_s;
    if (!live) break;  // every frame of the word is resolved
    if (tid == 0) erased_s = 0;
    bec_words_cn(c, w, live);
    __syncthreads();
    uint32_t erased = bec_words_vn(c, w, live, stale);
    erased = __reduce_or_sync(0xffffffffu, erased);
    if (lane == 0 && erased) atomicOr(&erased_s, erased);
    __syncthreads();
    const uint32_t unresolved = erased_s & live;
    if (tid < 32 && ((live >> tid) & 1u)) {
      const bool ok = !((unresolved >> tid) & 1u);
      resolved = ok;
      if (!(early_term && ok)) ++iters;  // a frame resolved at this pass is not counted
    }
    if (tid == 0 && early_term) live_s = unresolved;
  }
  __syncthreads();
  // ---- unpack: posterior symbols, and decisions (the true bit where
  // resolved, the wrong bit where not)
  if (valid) {
    for (int v = warp; v < c.nc; v += LDPC_BEC_THREADS / 32) {
      const uint32_t known = (w.pk[v] >> lane) & 1u;
      const uint8_t x = (uint8_t)((w.xi[v] >> lane) & 1u);
      sym_out[v * B + b] = known ? (uint8_t)((w.pv[v] >> lane) & 1u) : kErased;
      hard[v * B + b] = known ? x : (uint8_t)(stale >= 0 ? 1 : 1 - x);
    }
    if (warp == 0) {
      iters_out[b] = iters;
      resolved_out[b] = resolved;
    }
  }
}

}  // namespace

#include "bec_stream_words.cuh"

namespace {

// The BEC pass of the byte chunk: peeling CN and VN phases; the VN
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

// `scratch` null: the state lives in shared memory; else in `scratch`
// ([ceil(B / 32), 4 nc + 2 nnz] uint32 in device memory).
int ldpc_bec_decode_fused(const uint8_t* sym_in, const uint8_t* cw, uint8_t* sym_out,
                          uint8_t* hard, int* iters, int* resolved, uint32_t* scratch,
                          const int* row_ptr, const int* col_sorted, const int* vn_ptr,
                          const int* perm_c2v, int nc, int mc, int nnz, int B, int iterations,
                          int early_term, int stale, void* stream) {
  Code c{row_ptr, col_sorted, vn_ptr, perm_c2v, nc, mc, nnz};
  const unsigned grid = grid_for(B);
  cudaStream_t st = (cudaStream_t)stream;
  if (scratch) {
    bec_decode_words_kernel<true><<<grid, LDPC_BEC_THREADS, 0, st>>>(
        c, sym_in, cw, sym_out, hard, iters, resolved, scratch, B, iterations, early_term, stale);
    return (int)cudaGetLastError();
  }
  const size_t bytes = (size_t)(4 * nc + 2 * nnz) * 4;  // the state of one word (BecWords)
  return launch_smem(bec_decode_words_kernel<false>, grid, dim3(LDPC_BEC_THREADS), bytes, st, c,
                     sym_in, cw, sym_out, hard, iters, resolved, (uint32_t*)nullptr, B,
                     iterations, early_term, stale);
}

// The word form: a block's 32 frames as words in shared memory for the chunk.
int ldpc_bec_stream_chunk_words(uint8_t* sym, uint8_t* cw, uint8_t* lv2c, int* done, int* iters,
                                int* age, int* avail, int* ctr, const uint8_t* fresh_sym,
                                const uint8_t* fresh_cw, const int* refill, int* remaining,
                                const int* row_ptr, const int* col_sorted, const int* vn_ptr,
                                const int* perm_c2v, const int* bit_pos, int nc, int mc, int nnz,
                                int nct, int B, int k, int cap, int stale, void* stream) {
  Code c{row_ptr, col_sorted, vn_ptr, perm_c2v, nc, mc, nnz};
  StreamArgs<uint8_t, uint8_t> s{sym,    cw,        lv2c,      done, iters,   age,
                                 avail,  ctr,       fresh_sym, fresh_cw, refill, remaining,
                                 nullptr, bit_pos,  nct};
  const size_t bytes = (size_t)(4 * nc + 2 * nnz) * 4;  // the state of one word (BecWords)
  return launch_smem(bec_stream_words_kernel, grid_for(B), dim3(LDPC_BEC_THREADS), bytes,
                     (cudaStream_t)stream, c, s, B, k, cap, stale);
}

// The byte form: [rows, B] u8 planes, `lc2v` and `post` scratch planes.
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
