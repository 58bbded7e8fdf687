// The streaming chunk shared by the flooding stream kernels
// (decode_fused.cu: BP, decode_bec.cu: BEC peeling): k self-refilling
// passes per lane, after `kernel_stream` of the TPU kernels.
//
// Per pass and lane: an idle lane (done) with an unused pool entry (avail)
// takes a ticket against one global start quota (`remaining`, taken with
// atomicSub, so starts never exceed it in any block order) and, if granted,
// reloads its carried channel values, codeword and CN-space messages (the
// prior at each slot) from the pool, with age 1 (check-eligible at once);
// then a lane in flight runs one decode pass, checks convergence once
// age >= 1, and finishes on convergence or at age >= cap + 1, adding its
// transmitted-bit errors, a frame error, a frame and its iteration count
// to the per-lane counters.  Counter rows: 0 bit errors (transmitted bits
// only), 1 frame errors, 2 frames, 3 iteration sum, 4 starts.
//
// The decode pass is the template argument, a struct with
//   using V = ...;  // element type of the channel planes: prior and pool
//                   // (float LLRs, uint8_t BEC symbols)
//   using M = ...;  // element type of the messages and the posterior
//                   // (float, __nv_bfloat16, int8_t; uint8_t for the BEC)
//   cn(c, lv2c, B, b)                          check phase
//   vn(c, prior, cw, lv2c, post, B, b, flag)   variable phase
//   check(c, post, B, b, flag)                 convergence test
//   bit_error(post_value, cw_value)            a decided bit is wrong
//   reload(prior_value)                        a slot's first message
// where `flag[lane]` set by vn or check means "not converged this pass".
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bp_phases.cuh"

namespace {

// The per-lane state of a chunk, in place; planes are [rows, B] with the
// frame index fastest.  The channel planes (V) keep raw values; only the
// messages and the posterior (M) take the storage form.
template <typename V, typename M>
struct StreamArgs {
  V* prior;        // [nc, B] carried channel values (LLRs, or BEC symbols)
  uint8_t* cw;     // [nc, B] carried true codewords
  M* lv2c;         // [nnz, B] carried messages, CN-space slots
  int* done;       // [B] lane idle (finished or empty)
  int* iters;      // [B]
  int* age;        // [B] passes since (re)load
  int* avail;      // [B] pool entry unused
  int* ctr;        // [5, B] counters
  const V* fresh_prior;    // [nc, B] fresh-frame pool
  const uint8_t* fresh_cw;  // [nc, B]
  const int* refill;        // [1] reloads allowed
  int* remaining;           // [1] starts left in the quota
  M* post;                  // [nc, B] scratch: the pass's posterior
  const int* bit_pos;       // [nct] transmitted variables
  int nct;
};

// Every thread of a frame keeps the frame's control state in registers and
// updates it identically; every __syncthreads is reached by the whole block.
template <class Pass>
__device__ void stream_chunk(const Code& c, const Pass& pass,
                             const StreamArgs<typename Pass::V, typename Pass::M>& s, int B_,
                             int k, int cap) {
  __shared__ int flag[LDPC_FRAMES];  // start granted, then not converged
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
  for (int p = 0; p < k; ++p) {
    // ---- reload: an idle lane with an unused pool entry takes a ticket
    // against the global quota; it starts iff the ticket is below the
    // remaining count
    const bool want = valid && refill_on && done && avail;
    if (lead)
      flag[threadIdx.x] = want && *(volatile int*)s.remaining > 0 && atomicSub(s.remaining, 1) > 0;
    __syncthreads();
    if (flag[threadIdx.x]) {
      for (int v = threadIdx.y; v < c.nc; v += blockDim.y) {
        s.prior[v * B + b] = s.fresh_prior[v * B + b];
        s.cw[v * B + b] = s.fresh_cw[v * B + b];
      }
      // warm-up-free reload: lv2c = the prior's first message at each CN
      // slot (as the batch decode starts), so the next pass is iteration 1
      // (age 1, check-eligible)
      for (int e = threadIdx.y; e < c.nnz; e += blockDim.y)
        s.lv2c[e * B + b] = pass.reload(s.fresh_prior[__ldg(c.col_sorted + e) * B + b]);
      done = 0;
      age = 1;
      iters = 0;
      avail = 0;
      ++n_start;
    }
    const bool work = !done || (want && *(volatile int*)s.remaining > 0);
    if (!__syncthreads_or(work)) break;  // also orders the reload copy
    // ---- one decode pass; convergence is checked once age >= 1
    const bool run = !done;
    const bool checking = run && age >= 1;
    if (lead) {
      flag[threadIdx.x] = 0;
      berr[threadIdx.x] = 0;
    }
    if (run) pass.cn(c, s.lv2c, B, b);
    __syncthreads();
    if (run) pass.vn(c, s.prior, s.cw, s.lv2c, s.post, B, b, flag);
    __syncthreads();
    if (checking) pass.check(c, s.post, B, b, flag);
    __syncthreads();
    bool newly = false;
    if (checking) {
      newly = !flag[threadIdx.x];
      if (!newly) ++iters;
    }
    if (run) ++age;
    const bool finish = run && (newly || age >= cap + 1);
    if (finish) {
      // count at the finishing pass: the decisions of first convergence (or
      // of the iteration cap), transmitted bits only
      int be = 0;
      for (int t = threadIdx.y; t < s.nct; t += blockDim.y) {
        size_t v = __ldg(s.bit_pos + t) * B + b;
        be += pass.bit_error(s.post[v], s.cw[v]);
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

}  // namespace
