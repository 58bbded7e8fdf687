// The word form of the BEC streaming chunk (K7): k self-refilling peeling
// passes, after `kernel_stream` of libldpc_tpu/ops/pallas/decode_lanes.py in
// its BEC form, on the bit-sliced words of the batch kernel (K6).
//
// Included by decode_bec.cu after the word algebra (BecWords, keep,
// bec_words_cn, bec_words_vn), which it runs unchanged.
//
// One block owns 32 consecutive frames, one word, for the whole chunk: at
// entry its 256 threads pack the carried symbols, codewords and messages
// ([rows, B] u8 planes, as the byte form keeps them) into the word state in
// shared memory with __ballot_sync; at exit they unpack the messages of the
// frames that ran.  Each frame's control state (done, iters, age, avail)
// and its counters live in registers of lane f of the first warp, which
// also takes the start tickets: one atomicSub of the word's wanting lanes
// against the global quota, granted in lane order, so exactly `remaining`
// frames start over the grid.  A reload packs the pool's rows into the
// channel and codeword words under the grant mask R (and copies the bytes
// into the carried planes), then sets each reloaded frame's messages to its
// channel symbol at the slot, as K6 starts.  A pass is the check update,
// then the variable update, both masked by the word's frames in flight.
// At a pass where a frame finishes, its transmitted-bit errors are the set
// bits of ~pk & (stale < 0 ? ~0 : ~xi) over bit_pos: each warp transposes
// 32 such words at a time (five shuffle stages) so that lane f holds frame
// f's 32 bits and counts them with one __popc.
//
// What bounds it: the carried planes are read and written once a chunk
// (13.9 KB a frame on the 1152-node (3,6) code), the pool read once a
// reload; between them every pass runs from shared memory, so K6's
// instruction count and barriers set its time, plus the barriers of the
// control step, a reload (two) and a count (one).
#pragma once

namespace {

// Lane i holds row i of a 32 x 32 bit matrix (bit c: column c); after it,
// lane i holds column i (bit r: row r's bit i).  Five block swaps.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  uint32_t m = 0x0000ffffu;  // the bits whose column index has bit j clear
#pragma unroll
  for (int j = 16; j > 0; j >>= 1, m ^= m << j) {
    const uint32_t other = __shfl_xor_sync(0xffffffffu, x, j);
    x = (lane & j) ? (x & ~m) | ((other >> j) & m) : (x & m) | ((other & m) << j);
  }
  return x;
}

// ---- 32 bytes of a row (one block's frames, byte f = frame f) moved with
// two 16-byte accesses and turned into words in registers, as 8
// little-endian 32-bit words.
struct Row32 {
  uint32_t u[8];
};

__device__ __forceinline__ Row32 load_row(const uint8_t* p) {
  const uint4 a = reinterpret_cast<const uint4*>(p)[0];
  const uint4 b = reinterpret_cast<const uint4*>(p)[1];
  return {{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

__device__ __forceinline__ void store_row(uint8_t* p, const Row32& r) {
  reinterpret_cast<uint4*>(p)[0] = make_uint4(r.u[0], r.u[1], r.u[2], r.u[3]);
  reinterpret_cast<uint4*>(p)[1] = make_uint4(r.u[4], r.u[5], r.u[6], r.u[7]);
}

// Bits 4j .. 4j + 3: bit 0 of each byte of a per-byte mask (0xff or 0).
__device__ __forceinline__ uint32_t byte_flags(uint32_t mask, int j) {
  return (((mask & 0x01010101u) * 0x01020408u) >> 24) << (4 * j);
}

// The words of a row of 3-state symbols: known (byte != E), one (byte == 1).
__device__ __forceinline__ void symbol_words(const Row32& r, uint32_t& known, uint32_t& one) {
  known = one = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    known |= byte_flags(__vcmpne4(r.u[j], 0x02020202u), j);
    one |= byte_flags(__vcmpeq4(r.u[j], 0x01010101u), j);
  }
}

// The word of a row of bits: byte != 0.
__device__ __forceinline__ uint32_t bit_word(const Row32& r) {
  uint32_t out = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) out |= byte_flags(__vcmpne4(r.u[j], 0u), j);
  return out;
}

// The row of 3-state symbols of a (known, one) word pair: one where known,
// else E.  Inverse of symbol_words on the alphabet {0, 1, E}.
__device__ __forceinline__ Row32 symbol_row(uint32_t known, uint32_t one) {
  Row32 r;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t kb = (((known >> (4 * j)) & 15u) * 0x00204081u) & 0x01010101u;  // spread
    const uint32_t vb = (((one >> (4 * j)) & 15u) * 0x00204081u) & kb;
    r.u[j] = vb | ((kb ^ 0x01010101u) << 1);
  }
  return r;
}

// k self-refilling passes on block i's word, frames 32 i .. 32 i + 31; the
// state is updated in place (StreamArgs; `post` is unused).  A full word
// whose planes allow 16-byte accesses (B and the pointers multiples of 16)
// moves each row of 32 bytes with two vector accesses, one row a thread;
// any other (the last word of a ragged batch) votes bytes into words with
// __ballot_sync, one row a warp.
__global__ void __launch_bounds__(LDPC_BEC_THREADS, 4)  // 64 registers: 4 blocks an SM
bec_stream_words_kernel(Code c, StreamArgs<uint8_t, uint8_t> s, int B_, int k, int cap,
                        int stale) {
  extern __shared__ uint32_t bec_smem[];
  __shared__ uint32_t reload_s, live_s, erased_s;
  __shared__ int berr_s[32];  // bit errors of frame f at a counting pass
  constexpr int kWarps = LDPC_BEC_THREADS / 32;
  const BecWords w = bec_words_at(bec_smem, c);
  const size_t B = B_;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = (size_t)blockIdx.x * 32 + lane;
  const bool valid = b < B;
  const uintptr_t addr = (uintptr_t)s.prior | (uintptr_t)s.cw | (uintptr_t)s.lv2c |
                         (uintptr_t)s.fresh_prior | (uintptr_t)s.fresh_cw;
  const bool vec = (blockIdx.x + 1) * (size_t)32 <= B && B % 16 == 0 && addr % 16 == 0;
  const size_t b0 = (size_t)blockIdx.x * 32;  // the word's first frame
  // ---- entry: the carried channel symbols, codewords and messages into
  // words.  A frame past the batch is idle and never starts.
  if (vec) {
    for (int v0 = tid; v0 < c.nc; v0 += 2 * LDPC_BEC_THREADS) {
      Row32 sym[2], x[2];  // two rows' loads in flight
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int v = v0 + u * LDPC_BEC_THREADS;
        if (v < c.nc) {
          sym[u] = load_row(s.prior + v * B + b0);
          x[u] = load_row(s.cw + v * B + b0);
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int v = v0 + u * LDPC_BEC_THREADS;
        if (v < c.nc) {
          uint32_t kw, one;
          symbol_words(sym[u], kw, one);
          w.chk[v] = kw;
          w.xi[v] = bit_word(x[u]);
          w.pk[v] = 0;
          w.pv[v] = 0;
        }
      }
    }
    for (int e0 = tid; e0 < c.nnz; e0 += 2 * LDPC_BEC_THREADS) {
      Row32 m[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = e0 + u * LDPC_BEC_THREADS;
        if (e < c.nnz) m[u] = load_row(s.lv2c + e * B + b0);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = e0 + u * LDPC_BEC_THREADS;
        if (e < c.nnz) {
          uint32_t mk, mv;
          symbol_words(m[u], mk, mv);
          w.mk[e] = mk;
          w.mv[e] = mv;
        }
      }
    }
  } else {
#pragma unroll 4
    for (int v = warp; v < c.nc; v += kWarps) {
      const uint8_t sym = valid ? s.prior[v * B + b] : (uint8_t)0;
      const uint8_t x = valid ? s.cw[v * B + b] : (uint8_t)0;
      const uint32_t kw = __ballot_sync(0xffffffffu, sym != kErased);
      const uint32_t xw = __ballot_sync(0xffffffffu, x != 0);
      if (lane == 0) {
        w.chk[v] = kw;
        w.xi[v] = xw;
        w.pk[v] = 0;
        w.pv[v] = 0;
      }
    }
#pragma unroll 4
    for (int e = warp; e < c.nnz; e += kWarps) {
      const uint8_t m = valid ? s.lv2c[e * B + b] : kErased;
      const uint32_t mk = __ballot_sync(0xffffffffu, m != kErased);
      const uint32_t mv = __ballot_sync(0xffffffffu, m == 1);
      if (lane == 0) {
        w.mk[e] = mk;
        w.mv[e] = mv;
      }
    }
  }
  // lane f of warp 0: frame f's control state and counters
  int done = 1, iters = 0, age = 0, avail = 0;
  int n_bit = 0, n_frame_err = 0, n_frames = 0, n_iter = 0, n_start = 0;
  if (warp == 0 && valid) {
    done = s.done[b];
    iters = s.iters[b];
    age = s.age[b];
    avail = s.avail[b];
  }
  const bool refill_on = *s.refill != 0;
  if (tid < 32) berr_s[tid] = 0;
  if (tid == 0) erased_s = 0;
  uint32_t ran = 0;  // frames that ran a pass in this chunk
  for (int p = 0; p < k; ++p) {
    // ---- reload: the word's idle lanes with an unused pool entry take
    // tickets against the global quota, granted in lane order
    bool work = false;
    if (warp == 0) {
      const bool want = valid && refill_on && done && avail;
      const uint32_t wanting = __ballot_sync(0xffffffffu, want);
      int left = 0;  // the quota before this word's tickets
      if (lane == 0 && wanting && *(volatile int*)s.remaining > 0)
        left = atomicSub(s.remaining, __popc(wanting));
      left = __shfl_sync(0xffffffffu, left, 0);
      const bool grant = want && __popc(wanting & ((1u << lane) - 1u)) < left;
      if (grant) {
        done = 0;
        age = 1;
        iters = 0;
        avail = 0;
        ++n_start;
      }
      const uint32_t granted = __ballot_sync(0xffffffffu, grant);
      const uint32_t live = __ballot_sync(0xffffffffu, !done);
      work = !done || (want && *(volatile int*)s.remaining > 0);
      if (lane == 0) {
        reload_s = granted;
        live_s = live;
      }
    }
    if (!__syncthreads_or(work)) break;  // nothing runs and nothing may start
    const uint32_t R = reload_s, live = live_s;
    ran |= live;
    if (R && vec) {
      // the pool's rows into the channel and codeword words under R; the
      // reloaded frames' bytes copied into the carried planes
      for (int v0 = tid; v0 < c.nc; v0 += 2 * LDPC_BEC_THREADS) {
        Row32 sym[2], x[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int v = v0 + u * LDPC_BEC_THREADS;
          if (v < c.nc) {
            sym[u] = load_row(s.fresh_prior + v * B + b0);
            x[u] = load_row(s.fresh_cw + v * B + b0);
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int v = v0 + u * LDPC_BEC_THREADS;
          if (v >= c.nc) continue;
          uint32_t kw, one;
          symbol_words(sym[u], kw, one);
          w.chk[v] = keep(w.chk[v], kw, R);
          w.xi[v] = keep(w.xi[v], bit_word(x[u]), R);
          w.pv[v] = keep(w.pv[v], one, R);  // the channel's values until the pass
          if (R == 0xffffffffu) {
            store_row(s.prior + v * B + b0, sym[u]);
            store_row(s.cw + v * B + b0, x[u]);
          } else {
            for (uint32_t f = R; f; f &= f - 1) {  // each reloaded frame's bytes
              const size_t i = v * B + b0 + (__ffs(f) - 1);
              s.prior[i] = s.fresh_prior[i];
              s.cw[i] = s.fresh_cw[i];
            }
          }
        }
      }
    } else if (R) {
      const bool r = (R >> lane) & 1u;
#pragma unroll 4
      for (int v = warp; v < c.nc; v += kWarps) {
        uint8_t sym = 0, x = 0;
        if (r) {
          sym = s.fresh_prior[v * B + b];
          x = s.fresh_cw[v * B + b];
          s.prior[v * B + b] = sym;
          s.cw[v * B + b] = x;
        }
        const uint32_t kw = __ballot_sync(0xffffffffu, sym != kErased);
        const uint32_t vw = __ballot_sync(0xffffffffu, sym == 1);
        const uint32_t xw = __ballot_sync(0xffffffffu, x != 0);
        if (lane == 0) {
          w.chk[v] = keep(w.chk[v], kw, R);
          w.xi[v] = keep(w.xi[v], xw, R);
          w.pv[v] = keep(w.pv[v], vw, R);  // the channel's values until the pass
        }
      }
    }
    if (R) {
      __syncthreads();
      // the first messages: each slot's channel symbol
      for (int e = tid; e < c.nnz; e += LDPC_BEC_THREADS) {
        const int v = __ldg(c.col_sorted + e);
        w.mk[e] = keep(w.mk[e], w.chk[v], R);
        w.mv[e] = keep(w.mv[e], w.pv[v], R);
      }
      __syncthreads();
    }
    // ---- one decode pass of the frames in flight
    if (live) {
      bec_words_cn(c, w, live);
      __syncthreads();
      uint32_t erased = bec_words_vn(c, w, live, stale);
      erased = __reduce_or_sync(0xffffffffu, erased);
      if (lane == 0 && erased) atomicOr(&erased_s, erased);
    }
    __syncthreads();
    bool finish = false;
    if (warp == 0) {
      const bool run = (live >> lane) & 1u;
      const bool checking = run && age >= 1;
      bool newly = false;
      if (checking) {
        newly = !((erased_s >> lane) & 1u);
        if (!newly) ++iters;  // break-before-increment
      }
      if (run) ++age;
      finish = run && (newly || age >= cap + 1);
    }
    if (__syncthreads_or(finish)) {
      // count at the finishing pass: the decisions of first resolution (or
      // of the iteration cap), transmitted bits only
      int count = 0;
      for (int t0 = warp * 32; t0 < s.nct; t0 += LDPC_BEC_THREADS) {
        uint32_t bad = 0;
        if (t0 + lane < s.nct) {
          const int v = __ldg(s.bit_pos + t0 + lane);
          bad = ~w.pk[v] & (stale < 0 ? 0xffffffffu : ~w.xi[v]);
        }
        count += __popc(transpose32(bad, lane));
      }
      if (count) atomicAdd(&berr_s[lane], count);
      __syncthreads();
      if (warp == 0) {
        if (finish) {
          const int be = berr_s[lane];
          done = 1;
          n_bit += be;
          n_frame_err += be > 0;
          n_frames += 1;
          n_iter += iters;
        }
        berr_s[lane] = 0;
      }
    }
    if (tid == 0) erased_s = 0;  // read by warp 0 before the last barrier
  }
  __syncthreads();
  // ---- exit: the messages of the frames that ran (a full word: of every
  // frame of a word in which one ran, those that did not getting back the
  // bytes they had), and the control state
  if (vec && ran) {
    for (int e = tid; e < c.nnz; e += LDPC_BEC_THREADS)
      store_row(s.lv2c + e * B + b0, symbol_row(w.mk[e], w.mv[e]));
  } else if (!vec && valid && ((ran >> lane) & 1u)) {
#pragma unroll 4
    for (int e = warp; e < c.nnz; e += kWarps) {
      const uint32_t known = (w.mk[e] >> lane) & 1u;
      s.lv2c[e * B + b] = known ? (uint8_t)((w.mv[e] >> lane) & 1u) : kErased;
    }
  }
  if (warp == 0 && valid) {
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

}  // namespace
