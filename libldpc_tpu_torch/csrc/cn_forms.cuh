// Check-node forms shared by the BP decode kernels (flooding, layered,
// batch and streaming): the pairwise operators, the
// pre/post transforms of the tanh and phi domains, the NMS/OMS postprocess,
// and the exclusion combine of one check for one frame.  They follow
// libldpc_tpu_torch/ops/cn_ops.py operation for operation (association
// order of the combine, float32 constants); with -fmad=false the min-sum
// family is bit-exact against it.
// Also the message storage forms (float32, bfloat16, the int8 lattice) of
// ops/messages.py: arithmetic is float32 in every form, only loads and
// stores of messages and posteriors change.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Largest check degree whose combine is one fully unrolled window: its
// inputs and forward prefixes are indexed by compile-time constants and
// live in registers.  Larger checks are combined window by window; no
// degree is refused.  Every step of the unrolled loops is guarded by the
// degree, so the limit costs instructions and registers in every check,
// whatever its degree: on an H100 the flooding batch decode of the (3,6)
// code took 32.1 ms at a limit of 8, 35.8 ms at 12 and 53.4 ms at 16.
#define LDPC_UNROLL_DC 8

namespace {

constexpr float kPadLLR = 1e30f;
constexpr float kTanhClip = 0.99999994f;  // nextafter(1, 0) in float32
constexpr float kPhiSumFloor = 1e-30f;

// CN forms, in the order of ops/kernels/decode_fused.py CN_MODES
enum CnMode { BP = 0, BP_MS = 1, BP_LIN = 2, BP_NMS = 3, BP_OMS = 4, BP_TANH = 5, BP_PHI = 6 };

// The kernels are compiled per family of CN forms, so the pairwise operator
// of the inner loops is fixed at compile time: the min-sum family (BP_MS,
// BP_NMS, BP_OMS: one operator, the postprocess chosen per output), exact
// box-plus, and the rest (BP_LIN, BP_TANH, BP_PHI, chosen once per check).
enum CnFamily { FAM_MS = 0, FAM_BP = 1, FAM_REST = 2 };

inline int cn_family(int mode) {
  return (mode == BP_MS || mode == BP_NMS || mode == BP_OMS) ? FAM_MS
                                                            : (mode == BP ? FAM_BP : FAM_REST);
}

struct CnParams {
  int mode;
  float scale, offset;
};

__device__ __forceinline__ float sgn(float x) { return signbit(x) ? -1.0f : 1.0f; }

__device__ __forceinline__ float softplus_neg(float a) { return log1pf(expf(-a)); }

__device__ __forceinline__ float lin_approx(float L) {
  float a = fabsf(L);
  return a < 1.0f ? -0.375f * a + 0.6825f : (a < 2.625f ? -0.1875f * a + 0.5f : 0.0f);
}

__device__ __forceinline__ float minsum_op(float x, float y) {
  return sgn(x) * sgn(y) * fminf(fabsf(x), fabsf(y));
}

__device__ __forceinline__ float tanh_post(float t) {
  float p = fminf(fmaxf(t, -kTanhClip), kTanhClip);
  return log1pf(p) - log1pf(-p);
}

__device__ __forceinline__ float phi(float x) {
  float e = expf(-fmaxf(x, 1e-6f));
  return log1pf(e) - log1pf(-e);
}

__device__ __forceinline__ float phi_out(float s) {
  return -logf(tanhf(fmaxf(s, kPhiSumFloor) * 0.5f));
}

__device__ __forceinline__ float postprocess(const CnParams& cp, float v) {
  if (cp.mode == BP_NMS) return v * cp.scale;
  if (cp.mode == BP_OMS) return sgn(v) * fmaxf(fabsf(v) - cp.offset, 0.0f);
  return v;
}

// One CN form as the combine sees it: V is a combined value, pre() takes an
// input message into the form's domain, op() combines two values, post()
// takes a combined value back to an outgoing message.
struct MinSumForm {  // BP_MS, BP_NMS, BP_OMS
  using V = float;
  __device__ __forceinline__ V pre(float x) const { return x; }
  __device__ __forceinline__ V op(V x, V y) const { return minsum_op(x, y); }
  __device__ __forceinline__ float post(const CnParams& cp, V o) const { return postprocess(cp, o); }
};

struct BoxPlusForm {  // BP
  using V = float;
  __device__ __forceinline__ V pre(float x) const { return x; }
  __device__ __forceinline__ V op(V x, V y) const {
    return minsum_op(x, y) + (softplus_neg(fabsf(x + y)) - softplus_neg(fabsf(x - y)));
  }
  __device__ __forceinline__ float post(const CnParams&, V o) const { return o; }
};

struct LinForm {  // BP_LIN
  using V = float;
  __device__ __forceinline__ V pre(float x) const { return x; }
  __device__ __forceinline__ V op(V x, V y) const {
    return minsum_op(x, y) + lin_approx(x + y) - lin_approx(x - y);
  }
  __device__ __forceinline__ float post(const CnParams&, V o) const { return o; }
};

struct TanhForm {  // BP_TANH: products in the tanh domain
  using V = float;
  __device__ __forceinline__ V pre(float x) const { return tanhf(x * 0.5f); }
  __device__ __forceinline__ V op(V x, V y) const { return x * y; }
  __device__ __forceinline__ float post(const CnParams&, V o) const { return tanh_post(o); }
};

struct PhiForm {  // BP_PHI: sign chains (products of +-1), magnitude chains (sums of phi(|x|))
  struct V {
    float s, a;
  };
  __device__ __forceinline__ V pre(float x) const { return V{sgn(x), phi(fabsf(x))}; }
  __device__ __forceinline__ V op(V x, V y) const { return V{x.s * y.s, x.a + y.a}; }
  __device__ __forceinline__ float post(const CnParams&, V o) const { return o.s * phi_out(o.a); }
};

// The exclusion combine of one check of degree d >= 2 for one frame:
// out[j] = post(combine of every input but j).  load(j) gives input j;
// emit(j, out[j]) takes the outputs in the order d-1 .. 0.  Outputs come
// from forward prefixes F[j] = op(F[j-1], M[j]) and a running backward
// prefix, in the association order of ops/cn_ops.py exclusion_combine
// (out[j] = op(F[j-1], bwd), bwd grown as op(bwd, M[j])).
//
// combine_unrolled (2 <= d <= LDPC_UNROLL_DC): every loop is unrolled to
// the limit with each step guarded by the degree, so M and F are indexed by
// compile-time constants and live in registers (no local-memory arrays,
// no stack frame).  Every input is loaded, in order, before the first
// output.
template <class Form, class Load, class Emit>
__device__ __forceinline__ void combine_unrolled(const Form& fm, const CnParams& cp, int d,
                                                 Load load, Emit emit) {
  using V = typename Form::V;
  V M[LDPC_UNROLL_DC];
  V F[LDPC_UNROLL_DC];
#pragma unroll
  for (int j = 0; j < LDPC_UNROLL_DC; ++j)
    if (j < d) M[j] = fm.pre(load(j));
  F[0] = M[0];
#pragma unroll
  for (int j = 1; j < LDPC_UNROLL_DC - 1; ++j)
    if (j + 1 < d) F[j] = fm.op(F[j - 1], M[j]);
  V bwd = M[0];
#pragma unroll
  for (int j = LDPC_UNROLL_DC - 1; j >= 1; --j) {
    if (j == d - 1) {
      emit(j, fm.post(cp, F[j - 1]));
      bwd = M[j];
    } else if (j < d - 1) {
      emit(j, fm.post(cp, fm.op(F[j - 1], bwd)));
      bwd = fm.op(bwd, M[j]);
    }
  }
  emit(0, fm.post(cp, bwd));
}

// combine_any (any d >= 2): keeps no value per degree.  It walks the check
// in windows of LDPC_UNROLL_DC slots, from the last window to the first;
// within a window the inputs and prefixes are registers as above, and the
// forward prefix that enters the window is recomputed from the inputs
// before it (d^2 / (2 LDPC_UNROLL_DC) extra operations in all), in the same
// association order, so the outputs are the same bits.  load(j) is called
// several times but never after emit(j): a caller whose emit overwrites
// what load reads (the fast layered engine) stays correct.
template <class Form, class Load, class Emit>
__device__ __forceinline__ void combine_any(const Form& fm, const CnParams& cp, int d, Load load,
                                            Emit emit) {
  using V = typename Form::V;
  constexpr int W = LDPC_UNROLL_DC;
  V bwd;  // the backward prefix; starts at slot d-1
  for (int base = ((d - 1) / W) * W; base >= 0; base -= W) {
    const int n = d - base < W ? d - base : W;
    V fin;  // F[base - 1], the prefix of every input before the window
    if (base > 0) {
      fin = fm.pre(load(0));
      for (int i = 1; i < base; ++i) fin = fm.op(fin, fm.pre(load(i)));
    }
    V M[W];
    V F[W];
#pragma unroll
    for (int i = 0; i < W; ++i)
      if (i < n) M[i] = fm.pre(load(base + i));
    F[0] = M[0];
    if (base > 0) F[0] = fm.op(fin, M[0]);
#pragma unroll
    for (int i = 1; i < W; ++i)
      if (i < n) F[i] = fm.op(F[i - 1], M[i]);
#pragma unroll
    for (int i = W - 1; i >= 0; --i)
      if (i < n) {
        const int j = base + i;
        const V left = i > 0 ? F[i > 0 ? i - 1 : 0] : fin;  // F[j - 1]
        if (j == d - 1) {
          emit(j, fm.post(cp, left));
          bwd = M[i];
        } else if (j == 0) {
          emit(0, fm.post(cp, bwd));
        } else {
          emit(j, fm.post(cp, fm.op(left, bwd)));
          bwd = fm.op(bwd, M[i]);
        }
      }
  }
}

template <bool UNROLLED, class Form, class Load, class Emit>
__device__ __forceinline__ void combine(const Form& fm, const CnParams& cp, int d, Load load,
                                        Emit emit) {
  if constexpr (UNROLLED)
    combine_unrolled(fm, cp, d, load, emit);
  else
    combine_any(fm, cp, d, load, emit);
}

// The combine of one check of degree d >= 1 in the CN family FAM, on the
// unrolled path (UNROLLED, d <= LDPC_UNROLL_DC) or the any-degree path.  A
// degree-1 check loads nothing and emits postprocess(kPadLLR).
template <int FAM, bool UNROLLED, class Load, class Emit>
__device__ __forceinline__ void check_combine_path(const CnParams& cp, int d, Load load,
                                                   Emit emit) {
  if (d == 1) {
    emit(0, postprocess(cp, kPadLLR));
    return;
  }
  if constexpr (FAM == FAM_MS) {
    combine<UNROLLED>(MinSumForm{}, cp, d, load, emit);
  } else if constexpr (FAM == FAM_BP) {
    combine<UNROLLED>(BoxPlusForm{}, cp, d, load, emit);
  } else {
    if (cp.mode == BP_LIN)
      combine<UNROLLED>(LinForm{}, cp, d, load, emit);
    else if (cp.mode == BP_TANH)
      combine<UNROLLED>(TanhForm{}, cp, d, load, emit);
    else
      combine<UNROLLED>(PhiForm{}, cp, d, load, emit);
  }
}

// The combine of one check of any degree d >= 1, for callers whose load
// and emit keep no per-slot registers of their own.
template <int FAM, class Load, class Emit>
__device__ __forceinline__ void check_combine(const CnParams& cp, int d, Load load, Emit emit) {
  if (d <= LDPC_UNROLL_DC)
    check_combine_path<FAM, true>(cp, d, load, emit);
  else
    check_combine_path<FAM, false>(cp, d, load, emit);
}

// Message storage forms (ops/messages.py MessageForm): T is the stored
// type; load() widens to float32, store() rounds from float32, round() is
// load(store(x)) kept in a register (the fast layered engine's rounding of
// lv and o, which stay float32), prior() takes a raw float32 channel LLR to
// the decoder's units.
struct F32Msg {
  using T = float;
  __device__ __forceinline__ float load(T x) const { return x; }
  __device__ __forceinline__ T store(float x) const { return x; }
  __device__ __forceinline__ float round(float x) const { return x; }
  __device__ __forceinline__ float prior(float x) const { return x; }
};

// bfloat16 storage, rounded to nearest even (torch's .to(torch.bfloat16))
struct Bf16Msg {
  using T = __nv_bfloat16;
  __device__ __forceinline__ float load(T x) const { return __bfloat162float(x); }
  __device__ __forceinline__ T store(float x) const { return __float2bfloat16_rn(x); }
  __device__ __forceinline__ float round(float x) const { return load(store(x)); }
  __device__ __forceinline__ float prior(float x) const { return x; }
};

// The int8 lattice q = clip(round_half_even(x), -127, 127) in lattice
// units: rintf rounds halves to even like torch.round / jnp.round (roundf
// would round them away from zero).  The prior is multiplied by
// inv_q = float32(1 / quant_scale), never divided by quant_scale.
struct Int8Msg {
  using T = int8_t;
  float inv_q;
  __device__ __forceinline__ float load(T x) const { return (float)x; }
  __device__ __forceinline__ T store(float x) const { return (T)round(x); }
  __device__ __forceinline__ float round(float x) const {
    return fminf(fmaxf(rintf(x), -127.0f), 127.0f);
  }
  __device__ __forceinline__ float prior(float x) const { return x * inv_q; }
};

// check_combine over message planes [rows, B]: reads the check's slots
// e0 .. e0+d-1 of lv2c for frame b and writes the same slots of lc2v,
// each output rounded to the storage form.
template <int FAM, class Msg>
__device__ __forceinline__ void check_update(const CnParams& cp, const Msg& m,
                                             const typename Msg::T* __restrict__ lv2c,
                                             typename Msg::T* __restrict__ lc2v, int e0, int d,
                                             size_t B, size_t b) {
  check_combine<FAM>(
      cp, d, [&](int j) { return m.load(lv2c[(e0 + j) * B + b]); },
      [&](int j, float o) { lc2v[(e0 + j) * B + b] = m.store(o); });
}

}  // namespace
