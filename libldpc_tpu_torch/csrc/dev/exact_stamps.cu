// Per-phase cycle stamps of the exact layered kernel's 4-frame tile (K5,
// layered_exact_tile.cuh exact_decode at F = 4, the tile form, float32
// messages), on the 16-bit tables staged in shared memory or read from
// device memory, or on int32 tables read from device memory (the tile as
// it was before its tables were 16-bit); the frames' priors staged in
// shared memory or read from device memory; with the priors staged, the
// variable phase a variable's 4 frames a thread (`rows`:
// exact_tile_variables, the library's) or a frame a thread
// (frame_variable, the library's without staged priors).  Built and run only by
// tests_gpu/exact_stamps.py; not part of the kernel library.
//
// Lane 0 of every warp reads clock64() at each phase boundary and adds the
// difference to the phase it leaves; at the end the warp's sums are added
// into stamps[phase], and thread 0 of every block adds the layer steps the
// block ran into stamps[X_N].  A warp's wait at a barrier is a phase of
// its own; the sums are warp time, not device time.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../layered_exact_tile.cuh"

namespace {

#define STAMP(i)                    \
  {                                 \
    const long long t_ = clock64(); \
    acc[i] += t_ - t0;              \
    t0 = t_;                        \
  }

// entry: staging, the first messages and the write-out; iteration: the
// early-termination vote opening each iteration; syndrome_vote: the
// barrier deciding whether a layer's syndrome runs
enum {
  X_ENTRY = 0,
  X_ITERATION,
  X_CHECKS,
  X_CHECK_BARRIER,
  X_VARIABLES,
  X_SYNDROME_VOTE,
  X_SYNDROME,
  X_SYNDROME_BARRIER,
  X_N
};

constexpr int kF = 4;

// exact_decode<F32Msg, FAM, 4, false, I> with the stamps, step for step
template <int FAM, class I>
__global__ void __launch_bounds__(kF * exact_rows(kF), 1)
stamped_exact_tile4(ExactCode<I> code, CnParams cp, const float* __restrict__ llr_in,
                    float* __restrict__ out, int* __restrict__ iters_out,
                    int* __restrict__ iscw_out, int stage, int priors, int rows, int B_,
                    int iterations, int early_term, unsigned long long* stamps) {
  constexpr int F = kF;
  const F32Msg m{};
  long long acc[X_N] = {0, 0, 0, 0, 0, 0, 0, 0};
  long long t0 = clock64();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned badmask[2];
  constexpr int NTY = exact_rows(F);
  const int nc = code.c.nc, nnz = code.c.nnz;
  const Tile<float> t = tile_of<float, F>(smem, nc, nnz);
  const int f = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * F + f, nt = F * NTY;
  const size_t B = B_;
  const size_t b = (size_t)blockIdx.x * F + f;
  const bool valid = b < B;
  const FrameSlots<float, F, false> q{t.q + f, B};
  const FrameSlots<float, F, false> post{t.post + f, B};
  uint16_t* const hard = t.hard;
  float* const pri = (float*)(smem + align16((size_t)((unsigned char*)t.tables - smem) +
                                             exact_staged_table_bytes(nc, code.c.mc, nnz, code.nl,
                                                                      code.nlc, code.nlv, stage)));
  if (stage) {
    const int words =
        (int)((exact_table_entries(nc, code.c.mc, nnz, code.nl, code.nlc, code.nlv) + 1) / 2);
    const unsigned* src = (const unsigned*)code.c.row_ptr;
    unsigned* dst = (unsigned*)t.tables;
    for (int i = tid; i < words; i += nt) dst[i] = __ldg(src + i);
    code = exact_code_at((const I*)t.tables, nc, code.c.mc, nnz, code.nl, code.nlc, code.nlv);
  }
  const TileCodeOf<I> tc = code.c;
  const I* const lptr = code.lptr;
  const I* const lchk = code.lchk;
  const I* const vptr = code.vptr;
  const I* const lvars = code.lvars;
  if (valid) {
    for (int v = ty; v < nc; v += NTY) {
      const float x = llr_in[v * B + b];
      if (priors) pri[v * F + f] = x;
      post[v] = m.store(m.prior(x));
    }
    for (int e = ty; e < nnz; e += NTY) q[e] = m.store(0.0f);
  } else if (priors) {
    for (int v = ty; v < nc; v += NTY) pri[v * F + f] = 0.0f;
  }
  if (tid == 0) badmask[0] = badmask[1] = 0;
  bool done = !valid;
  unsigned live = 0;
  for (int k = 0; k < F; ++k) live |= (size_t)blockIdx.x * F + k < B ? 1u << k : 0u;
  int iters = 0, iscw = 0, steps = 0;
  __syncthreads();
  STAMP(X_ENTRY)
  bool first = true;
  int parity = 0;
  for (int it = 0; it < iterations; ++it) {
    if (early_term && !__syncthreads_or(!done)) {
      STAMP(X_ITERATION)
      break;
    }
    STAMP(X_ITERATION)
    const bool done_start = done;
    for (int l = 0; l < code.nl; ++l) {
      ++steps;
      const bool check = !done && (early_term || (it == iterations - 1 && l == code.nl - 1));
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
      STAMP(X_CHECKS)
      __syncthreads();
      STAMP(X_CHECK_BARRIER)
      if (priors && rows) {
        exact_tile_variables<F32Msg, F>(code, m, t, l, first, live, pri, tid, nt);
      } else {
        const int i0 = first ? 0 : vptr[l];
        const int n = first ? nc : vptr[l + 1] - i0;
        const int rounds = (n + NTY - 1) / NTY;
        for (int i = 0; i < rounds; ++i) {
          const int j = i * NTY + ty;
          frame_variable<F, 1>(tc, m, q, post, hard, j < n ? (first ? j : lvars[i0 + j]) : -1,
                               !done, f, tid, [&](int v) {
                                 return priors ? pri[v * F + f] : __ldg(llr_in + v * B + b);
                               });
        }
      }
      first = false;
      STAMP(X_VARIABLES)
      const bool any = __syncthreads_or(check);
      STAMP(X_SYNDROME_VOTE)
      if (any) {
        tile_syndrome(tc, hard, tid, nt, &badmask[parity]);
        STAMP(X_SYNDROME)
        __syncthreads();
        if (check) {
          const bool ok = !((badmask[parity] >> f) & 1u);
          if (!early_term) {
            iscw = ok;
          } else if (ok) {
            done = true;
            iscw = 1;
          }
        }
        if (early_term) live &= badmask[parity];
        if (tid == 0) badmask[parity ^ 1] = 0;
        parity ^= 1;
        STAMP(X_SYNDROME_BARRIER)
      }
    }
    if (early_term && !done_start && !done) ++iters;
  }
  if (valid) {
    for (int v = ty; v < nc; v += NTY) out[v * B + b] = post[v];
    if (ty == 0) {
      iters_out[b] = early_term ? iters : iterations;
      iscw_out[b] = iscw;
    }
  }
  STAMP(X_ENTRY)
  if ((tid & 31) == 0)
    for (int i = 0; i < X_N; ++i) atomicAdd(stamps + i, (unsigned long long)acc[i]);
  if (tid == 0) atomicAdd(stamps + X_N, (unsigned long long)steps);
}

template <class I>
int launch_stamped(ExactCode<I> x, int cn_mode, float scale, float offset, const float* llr_in,
                   float* post, int* iters, int* iscw, int stage, int priors, int rows, int B,
                   int iterations, int early_term, unsigned long long* stamps, size_t bytes,
                   void* stream) {
  CnParams cp{cn_mode, scale, offset};
  return by_family(cn_mode, F32Msg{}, [&](auto, auto fam) {
    return launch_smem(stamped_exact_tile4<decltype(fam)::value, I>, (B + kF - 1) / kF,
                       dim3(kF, exact_rows(kF)), bytes, (cudaStream_t)stream, x, cp, llr_in,
                       post, iters, iscw, stage, priors, rows, B, iterations, early_term, stamps);
  });
}

}  // namespace

extern "C" {

int dev_n_exact_phases() { return X_N; }

// The stamped 4-frame tile in float32: on the 16-bit tables `tables16`
// (KernelTables.exact16), staged when `stage`, or, with tables16 null, on
// the eight int32 tables in device memory (stage must be 0); the priors
// staged when `priors`, and then the variable phase a variable's frames a
// thread when `rows`, else a frame a thread.
// stamps: X_N + 1 zeroed uint64 counters.  Returns the launch's
// cudaGetLastError().
int dev_stamped_exact_tile4(const float* llr_in, float* post, int* iters, int* iscw,
                            const int* row_ptr, const int* col_sorted, const int* vn_ptr,
                            const int* perm_c2v, const int* layer_ptr, const int* layer_checks,
                            const int* layer_var_ptr, const int* layer_vars, const void* tables16,
                            int nc, int mc, int nnz, int nl, int nlc, int nlv, int B,
                            int iterations, int early_term, int cn_mode, float scale, float offset,
                            int stage, int priors, int rows, unsigned long long* stamps,
                            void* stream) {
  const size_t bytes = exact_tile_bytes(nc, mc, nnz, nl, nlc, nlv, kF, 4,
                                        tables16 != nullptr && stage != 0, priors != 0);
  if (tables16)
    return launch_stamped(exact_code_at((const uint16_t*)tables16, nc, mc, nnz, nl, nlc, nlv),
                          cn_mode, scale, offset, llr_in, post, iters, iscw, stage, priors, rows,
                          B, iterations, early_term, stamps, bytes, stream);
  if (stage) return (int)cudaErrorInvalidValue;
  const ExactCode<int> x{TileCode{row_ptr, col_sorted, vn_ptr, perm_c2v, nc, mc, nnz},
                         layer_ptr, layer_checks, layer_var_ptr, layer_vars, nl, nlc, nlv};
  return launch_stamped(x, cn_mode, scale, offset, llr_in, post, iters, iscw, 0, priors, rows, B,
                        iterations, early_term, stamps, bytes, stream);
}

}  // extern "C"
