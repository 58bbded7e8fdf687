// Per-phase cycle stamps of the designs that keep every message in HBM
// planes with one frame per lane: the fast layered engine's streaming chunk
// in its HBM-plane form (32 frames x 8 warps, APP and lc2v planes, a block
// barrier per layer; layered_stream.cuh), the BEC peeling decode on byte
// planes (the phases of the BEC streaming kernel, decode_bec.cu, run as a
// batch decode), the flooding streaming chunk (stream_chunk.cuh with the BP
// pass of decode_stream.cu) and the exact layered batch decode
// (decode_layered_exact.cu), the last two in float32.  Built and run only
// by tests_gpu/phase_breakdown.py; not part of the kernel library.
//
// Lane 0 of every warp reads clock64() at each phase boundary and adds the
// difference to the phase it leaves; at the end the warp's sums are added
// into stamps[phase].  Shares of the summed warp time say where a warp
// spends its life (waiting at barriers included); they are not device time.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../bp_phases.cuh"
#include "../cn_forms.cuh"
#include "../layered_fast.cuh"

namespace {

#define STAMP(i)                  \
  {                               \
    const long long t_ = clock64(); \
    acc[i] += t_ - t0;            \
    t0 = t_;                      \
  }

// Phases of the layered chunk
enum { L_ENTRY = 0, L_RELOAD, L_CHECKS, L_LAYER_BARRIER, L_SYNDROME, L_COUNT, L_N };

template <int FAM>
__global__ void __launch_bounds__(LDPC_FRAMES * LDPC_WARPS, LDPC_FAST_MIN_BLOCKS)
stamped_stream_chunk_layered_fast(Code c, Layers L, CnParams cp, float* __restrict__ app,
                                  uint8_t* __restrict__ cw, float* __restrict__ lc2v,
                                  int* __restrict__ done_p, int* __restrict__ iters_p,
                                  int* __restrict__ age_p, int* __restrict__ avail_p,
                                  int* __restrict__ ctr, const float* __restrict__ fresh_llr,
                                  const uint8_t* __restrict__ fresh_cw,
                                  const int* __restrict__ refill, int* remaining,
                                  const int* __restrict__ bit_pos, int nct, int B_, int k, int cap,
                                  unsigned long long* stamps) {
  __shared__ int flag[LDPC_FRAMES];
  __shared__ int berr[LDPC_FRAMES];
  long long acc[L_N] = {0, 0, 0, 0, 0, 0};
  long long t0 = clock64();
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
  STAMP(L_ENTRY)
  for (int pass = 0; pass < k; ++pass) {
    if (!done && age == 0) {
      for (int e = threadIdx.y; e < c.nnz; e += blockDim.y) lc2v[e * B + b] = 0.0f;
      age = 1;
    }
    const bool want = valid && refill_on && done && avail;
    if (lead)
      flag[threadIdx.x] = want && *(volatile int*)remaining > 0 && atomicSub(remaining, 1) > 0;
    __syncthreads();
    if (flag[threadIdx.x]) {
      for (int v = threadIdx.y; v < c.nc; v += blockDim.y) {
        app[v * B + b] = fresh_llr[v * B + b];
        cw[v * B + b] = fresh_cw[v * B + b];
      }
      for (int e = threadIdx.y; e < c.nnz; e += blockDim.y) lc2v[e * B + b] = 0.0f;
      done = 0;
      age = 1;
      iters = 0;
      avail = 0;
      ++n_start;
    }
    const bool work = !done || (want && *(volatile int*)remaining > 0);
    if (!__syncthreads_or(work)) break;
    STAMP(L_RELOAD)
    const bool run = !done;
    for (int l = 0; l < L.nl; ++l) {
      if (run) {
        const int k1 = __ldg(L.ptr + l + 1);
        for (int kk = __ldg(L.ptr + l) + threadIdx.y; kk < k1; kk += blockDim.y)
          fast_check<FAM>(c, cp, F32Msg{}, app, lc2v, __ldg(L.checks + kk), B, b);
      }
      STAMP(L_CHECKS)
      __syncthreads();
      STAMP(L_LAYER_BARRIER)
    }
    if (lead) {
      flag[threadIdx.x] = 0;
      berr[threadIdx.x] = 0;
    }
    __syncthreads();
    if (run) syndrome_part(c, F32Msg{}, app, B, b, flag);
    __syncthreads();
    STAMP(L_SYNDROME)
    bool newly = false;
    if (run) {
      newly = !flag[threadIdx.x];
      if (!newly) ++iters;
      ++age;
    }
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
    STAMP(L_COUNT)
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
  STAMP(L_ENTRY)
  if (threadIdx.x == 0)
    for (int i = 0; i < L_N; ++i) atomicAdd(stamps + i, (unsigned long long)acc[i]);
}

constexpr uint8_t kErased = 2;

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

__device__ void bec_vn_phase(const Code& c, const uint8_t* __restrict__ sym,
                             const uint8_t* __restrict__ cw, uint8_t* __restrict__ lv2c,
                             const uint8_t* __restrict__ lc2v, uint8_t* __restrict__ post,
                             size_t B, size_t b, volatile int* unresolved) {
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
      lv2c[e] = kErased;
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

// Phases of the byte-plane peeling decode
enum { P_INIT = 0, P_CN, P_VN, P_BARRIER, P_FINAL, P_N };

__global__ void __launch_bounds__(LDPC_FRAMES * LDPC_WARPS)
stamped_bec_decode_bytes(Code c, const uint8_t* __restrict__ sym_in,
                         const uint8_t* __restrict__ cw, uint8_t* __restrict__ sym_out,
                         uint8_t* __restrict__ hard, int* __restrict__ iters_out,
                         int* __restrict__ resolved_out, uint8_t* __restrict__ lv2c,
                         uint8_t* __restrict__ lc2v, int B_, int iterations, int early_term,
                         unsigned long long* stamps) {
  __shared__ int unresolved[2][LDPC_FRAMES];
  long long acc[P_N] = {0, 0, 0, 0, 0};
  long long t0 = clock64();
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
  STAMP(P_INIT)
  for (int it = 0; it < iterations; ++it) {
    if (!__syncthreads_or(!done)) break;
    STAMP(P_BARRIER)
    const int buf = it & 1;
    if (!done) bec_cn_phase(c, lv2c, lc2v, B, b);
    STAMP(P_CN)
    __syncthreads();
    STAMP(P_BARRIER)
    if (lead) unresolved[buf ^ 1][threadIdx.x] = 0;
    if (!done) bec_vn_phase(c, sym_in, cw, lv2c, lc2v, sym_out, B, b, unresolved[buf]);
    STAMP(P_VN)
    __syncthreads();
    STAMP(P_BARRIER)
    if (!done) {
      const bool ok = !unresolved[buf][threadIdx.x];
      resolved = ok;
      if (early_term && ok)
        done = true;
      else
        ++iters;
    }
  }
  if (valid) {
    for (int v = threadIdx.y; v < c.nc; v += blockDim.y) {
      const uint8_t x = cw[v * B + b];
      hard[v * B + b] = sym_out[v * B + b] == kErased ? 1 - x : x;
    }
    if (lead) {
      iters_out[b] = iters;
      resolved_out[b] = resolved;
    }
  }
  STAMP(P_FINAL)
  if (threadIdx.x == 0)
    for (int i = 0; i < P_N; ++i) atomicAdd(stamps + i, (unsigned long long)acc[i]);
}

// Phases of the flooding streaming chunk (K2's HBM-plane design,
// stream_chunk.cuh with decode_stream.cu's BP pass, float32 messages)
enum { F_ENTRY = 0, F_RELOAD, F_CHECK, F_VARIABLE, F_SYNDROME, F_COUNT, F_N };

template <int FAM>
__global__ void __launch_bounds__(LDPC_FRAMES * LDPC_WARPS)
stamped_stream_chunk_flooding(Code c, CnParams cp, float* __restrict__ prior,
                              uint8_t* __restrict__ cw, float* __restrict__ lv2c,
                              float* __restrict__ lc2v, float* __restrict__ post,
                              int* __restrict__ done_p, int* __restrict__ iters_p,
                              int* __restrict__ age_p, int* __restrict__ avail_p,
                              int* __restrict__ ctr, const float* __restrict__ fresh_prior,
                              const uint8_t* __restrict__ fresh_cw, const int* __restrict__ refill,
                              int* remaining, const int* __restrict__ bit_pos, int nct, int B_,
                              int k, int cap, unsigned long long* stamps) {
  __shared__ int flag[LDPC_FRAMES];
  __shared__ int berr[LDPC_FRAMES];
  long long acc[F_N] = {0, 0, 0, 0, 0, 0};
  long long t0 = clock64();
  const F32Msg m{};
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
  STAMP(F_ENTRY)
  for (int p = 0; p < k; ++p) {
    const bool want = valid && refill_on && done && avail;
    if (lead)
      flag[threadIdx.x] = want && *(volatile int*)remaining > 0 && atomicSub(remaining, 1) > 0;
    __syncthreads();
    if (flag[threadIdx.x]) {
      for (int v = threadIdx.y; v < c.nc; v += blockDim.y) {
        prior[v * B + b] = fresh_prior[v * B + b];
        cw[v * B + b] = fresh_cw[v * B + b];
      }
      for (int e = threadIdx.y; e < c.nnz; e += blockDim.y)
        lv2c[e * B + b] = fresh_prior[__ldg(c.col_sorted + e) * B + b];
      done = 0;
      age = 1;
      iters = 0;
      avail = 0;
      ++n_start;
    }
    const bool work = !done || (want && *(volatile int*)remaining > 0);
    if (!__syncthreads_or(work)) break;
    STAMP(F_RELOAD)
    const bool run = !done;
    const bool checking = run && age >= 1;
    if (lead) {
      flag[threadIdx.x] = 0;
      berr[threadIdx.x] = 0;
    }
    if (run) cn_phase<FAM>(c, cp, m, lv2c, lc2v, B, b);
    __syncthreads();
    STAMP(F_CHECK)
    if (run) vn_phase(c, m, prior, lv2c, lc2v, post, B, b);
    __syncthreads();
    STAMP(F_VARIABLE)
    if (checking) syndrome_part(c, m, post, B, b, flag);
    __syncthreads();
    STAMP(F_SYNDROME)
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
        be += (post[v] <= 0.0f) != (cw[v] != 0);
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
    STAMP(F_COUNT)
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
  STAMP(F_ENTRY)
  if (threadIdx.x == 0)
    for (int i = 0; i < F_N; ++i) atomicAdd(stamps + i, (unsigned long long)acc[i]);
}

// Phases of the exact layered batch decode (K5's HBM-plane design,
// decode_layered_exact.cu, float32 messages); a barrier's wait is its own
// phase
enum { X_INIT = 0, X_CHECKS, X_VARIABLE, X_SYNDROME, X_BARRIER, X_N };

template <int FAM>
__global__ void __launch_bounds__(LDPC_FRAMES * LDPC_WARPS)
stamped_decode_layered_exact(Code c, Layers L, CnParams cp, const float* __restrict__ llr_in,
                             float* __restrict__ post, int* __restrict__ iters_out,
                             int* __restrict__ iscw_out, float* __restrict__ lv2c,
                             float* __restrict__ lc2v, int B_, int iterations, int early_term,
                             unsigned long long* stamps) {
  __shared__ int bad[LDPC_FRAMES];
  long long acc[X_N] = {0, 0, 0, 0, 0};
  long long t0 = clock64();
  const F32Msg m{};
  const size_t B = B_;
  const size_t b = (size_t)blockIdx.x * LDPC_FRAMES + threadIdx.x;
  const bool valid = b < B;
  const bool lead = threadIdx.y == 0;
  if (valid)
    for (int e = threadIdx.y; e < c.nnz; e += blockDim.y) {
      lv2c[e * B + b] = llr_in[__ldg(c.col_sorted + e) * B + b];
      lc2v[e * B + b] = 0.0f;
    }
  bool done = !valid;
  int iters = 0, iscw = 0;
  STAMP(X_INIT)
  __syncthreads();
  STAMP(X_BARRIER)
  for (int it = 0; it < iterations; ++it) {
    if (early_term && !__syncthreads_or(!done)) break;
    STAMP(X_BARRIER)
    const bool done_start = done;
    for (int l = 0; l < L.nl; ++l) {
      const bool check = !done && (early_term || (it == iterations - 1 && l == L.nl - 1));
      if (!done) {
        const int k1 = __ldg(L.ptr + l + 1);
        for (int kk = __ldg(L.ptr + l) + threadIdx.y; kk < k1; kk += blockDim.y) {
          const int r = __ldg(L.checks + kk);
          const int e0 = __ldg(c.row_ptr + r);
          const int d = __ldg(c.row_ptr + r + 1) - e0;
          if (d > 0) check_update<FAM>(cp, m, lv2c, lc2v, e0, d, B, b);
        }
      }
      STAMP(X_CHECKS)
      __syncthreads();
      STAMP(X_BARRIER)
      if (lead) bad[threadIdx.x] = 0;
      if (!done) vn_phase(c, m, llr_in, lv2c, lc2v, post, B, b);
      STAMP(X_VARIABLE)
      __syncthreads();
      STAMP(X_BARRIER)
      if (check) syndrome_part(c, m, post, B, b, bad);
      STAMP(X_SYNDROME)
      __syncthreads();
      STAMP(X_BARRIER)
      if (check) {
        const bool ok = !bad[threadIdx.x];
        if (!early_term) {
          iscw = ok;
        } else if (ok) {
          done = true;
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
  STAMP(X_INIT)
  if (threadIdx.x == 0)
    for (int i = 0; i < X_N; ++i) atomicAdd(stamps + i, (unsigned long long)acc[i]);
}

// The launch of a kernel templated on the CN family, by cn_mode
#define LDPC_BY_FAMILY(KERNEL, GRID, ...)                                         \
  switch (cn_family(cn_mode)) {                                                   \
    case FAM_MS:                                                                  \
      KERNEL<FAM_MS><<<GRID, kBlock, 0, (cudaStream_t)stream>>>(__VA_ARGS__);     \
      break;                                                                      \
    case FAM_BP:                                                                  \
      KERNEL<FAM_BP><<<GRID, kBlock, 0, (cudaStream_t)stream>>>(__VA_ARGS__);     \
      break;                                                                      \
    default:                                                                      \
      KERNEL<FAM_REST><<<GRID, kBlock, 0, (cudaStream_t)stream>>>(__VA_ARGS__);   \
  }

}  // namespace

extern "C" {

int dev_n_layered_phases() { return L_N; }
int dev_n_bec_phases() { return P_N; }
int dev_n_flooding_stream_phases() { return F_N; }
int dev_n_exact_phases() { return X_N; }

int dev_stamped_stream_chunk_flooding(
    float* prior, uint8_t* cw, float* lv2c, float* lc2v, float* post, int* done, int* iters,
    int* age, int* avail, int* ctr, const float* fresh_prior, const uint8_t* fresh_cw,
    const int* refill, int* remaining, const int* row_ptr, const int* col_sorted,
    const int* vn_ptr, const int* perm_c2v, const int* bit_pos, int nc, int mc, int nnz, int nct,
    int B, int k, int cap, int cn_mode, float scale, float offset, unsigned long long* stamps,
    void* stream) {
  Code c{row_ptr, col_sorted, vn_ptr, perm_c2v, nc, mc, nnz};
  CnParams cp{cn_mode, scale, offset};
  LDPC_BY_FAMILY(stamped_stream_chunk_flooding, grid_for(B), c, cp, prior, cw, lv2c, lc2v, post,
                 done, iters, age, avail, ctr, fresh_prior, fresh_cw, refill, remaining, bit_pos,
                 nct, B, k, cap, stamps)
  return (int)cudaGetLastError();
}

int dev_stamped_decode_layered_exact(const float* llr_in, float* post, int* iters, int* iscw,
                                     float* lv2c, float* lc2v, const int* row_ptr,
                                     const int* col_sorted, const int* vn_ptr,
                                     const int* perm_c2v, const int* layer_ptr,
                                     const int* layer_checks, int nc, int mc, int nnz, int nl,
                                     int B, int iterations, int early_term, int cn_mode,
                                     float scale, float offset, unsigned long long* stamps,
                                     void* stream) {
  Code c{row_ptr, col_sorted, vn_ptr, perm_c2v, nc, mc, nnz};
  Layers L{layer_ptr, layer_checks, nl};
  CnParams cp{cn_mode, scale, offset};
  LDPC_BY_FAMILY(stamped_decode_layered_exact, grid_for(B), c, L, cp, llr_in, post, iters, iscw,
                 lv2c, lc2v, B, iterations, early_term, stamps)
  return (int)cudaGetLastError();
}

int dev_stamped_stream_chunk_layered_fast(
    float* app, uint8_t* cw, float* lc2v, int* done, int* iters, int* age, int* avail, int* ctr,
    const float* fresh_llr, const uint8_t* fresh_cw, const int* refill, int* remaining,
    const int* row_ptr, const int* col_sorted, const int* vn_ptr, const int* perm_c2v,
    const int* layer_ptr, const int* layer_checks, const int* bit_pos, int nc, int mc, int nnz,
    int nl, int nct, int B, int k, int cap, int cn_mode, float scale, float offset,
    unsigned long long* stamps, void* stream) {
  Code c{row_ptr, col_sorted, vn_ptr, perm_c2v, nc, mc, nnz};
  Layers L{layer_ptr, layer_checks, nl};
  CnParams cp{cn_mode, scale, offset};
#define LDPC_STAMPED(FAM)                                                                    \
  stamped_stream_chunk_layered_fast<FAM><<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>( \
      c, L, cp, app, cw, lc2v, done, iters, age, avail, ctr, fresh_llr, fresh_cw, refill,   \
      remaining, bit_pos, nct, B, k, cap, stamps)
  switch (cn_family(cn_mode)) {
    case FAM_MS:
      LDPC_STAMPED(FAM_MS);
      break;
    case FAM_BP:
      LDPC_STAMPED(FAM_BP);
      break;
    default:
      LDPC_STAMPED(FAM_REST);
  }
#undef LDPC_STAMPED
  return (int)cudaGetLastError();
}

int dev_stamped_bec_decode_bytes(const uint8_t* sym_in, const uint8_t* cw, uint8_t* sym_out,
                                 uint8_t* hard, int* iters, int* resolved, uint8_t* lv2c,
                                 uint8_t* lc2v, const int* row_ptr, const int* col_sorted,
                                 const int* vn_ptr, const int* perm_c2v, int nc, int mc, int nnz,
                                 int B, int iterations, int early_term,
                                 unsigned long long* stamps, void* stream) {
  Code c{row_ptr, col_sorted, vn_ptr, perm_c2v, nc, mc, nnz};
  stamped_bec_decode_bytes<<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>(
      c, sym_in, cw, sym_out, hard, iters, resolved, lv2c, lc2v, B, iterations, early_term,
      stamps);
  return (int)cudaGetLastError();
}

}  // extern "C"
