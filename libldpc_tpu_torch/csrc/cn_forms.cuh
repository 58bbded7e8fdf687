// Check-node forms shared by the decode kernels (decode_fused.cu,
// decode_layered.cu): the pairwise operators, the pre/post transforms of the
// tanh and phi domains, the NMS/OMS postprocess, and the exclusion combine
// of one check for one frame.  They follow libldpc_tpu_torch/ops/cn_ops.py
// operation for operation (association order of the combine, float32
// constants); with -fmad=false the min-sum family is bit-exact against it.
// Also the message storage forms (float32, bfloat16, the int8 lattice) of
// ops/messages.py: arithmetic is float32 in every form, only loads and
// stores of messages and posteriors change.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define LDPC_MAX_DC 32

namespace {

constexpr float kPadLLR = 1e30f;
constexpr float kTanhClip = 0.99999994f;  // nextafter(1, 0) in float32
constexpr float kPhiSumFloor = 1e-30f;

// CN forms, in the order of ops/kernels/decode_fused.py CN_MODES
enum CnMode { BP = 0, BP_MS = 1, BP_LIN = 2, BP_NMS = 3, BP_OMS = 4, BP_TANH = 5, BP_PHI = 6 };

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

__device__ __forceinline__ float pair_op(int mode, float x, float y) {
  float m = fminf(fabsf(x), fabsf(y));
  float s = sgn(x) * sgn(y) * m;
  if (mode == BP_MS || mode == BP_NMS || mode == BP_OMS) return s;
  if (mode == BP_LIN) return s + lin_approx(x + y) - lin_approx(x - y);
  return s + (softplus_neg(fabsf(x + y)) - softplus_neg(fabsf(x - y)));
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

// The exclusion combine of one check of degree d (1 <= d <= LDPC_MAX_DC)
// for one frame: out[j] = postprocess(combine of every input but j).
// load(j) gives input j; all d inputs are loaded, in order, before the
// first output.  emit(j, out[j]) takes the outputs in the order d-1 .. 0.
// A degree-1 check loads nothing and emits postprocess(kPadLLR).  Outputs
// come from forward prefixes f[j] = op(f[j-1], M[j]) and a running
// backward prefix, in the association order of ops/cn_ops.py
// exclusion_combine (out[j] = op(f[j-1], bwd), bwd grown as op(bwd, M[j])).
template <class Load, class Emit>
__device__ __forceinline__ void check_combine(const CnParams& cp, int d, Load load, Emit emit) {
  float M[LDPC_MAX_DC];
  float F[LDPC_MAX_DC];
  if (d == 1) {
    emit(0, postprocess(cp, kPadLLR));
    return;
  }
  if (cp.mode == BP_PHI) {
    // sign chains (products of +-1) and magnitude chains (sums of phi(|x|))
    float S[LDPC_MAX_DC];
    float FS[LDPC_MAX_DC];
    for (int j = 0; j < d; ++j) {
      float x = load(j);
      S[j] = sgn(x);
      M[j] = phi(fabsf(x));
    }
    FS[0] = S[0];
    F[0] = M[0];
    for (int j = 1; j < d; ++j) {
      FS[j] = FS[j - 1] * S[j];
      F[j] = F[j - 1] + M[j];
    }
    float bs = S[d - 1], ba = M[d - 1];
    emit(d - 1, postprocess(cp, FS[d - 2] * phi_out(F[d - 2])));
    for (int j = d - 2; j >= 1; --j) {
      emit(j, postprocess(cp, FS[j - 1] * bs * phi_out(F[j - 1] + ba)));
      bs = bs * S[j];
      ba = ba + M[j];
    }
    emit(0, postprocess(cp, bs * phi_out(ba)));
    return;
  }
  const bool tanh_form = cp.mode == BP_TANH;
  for (int j = 0; j < d; ++j) {
    float x = load(j);
    M[j] = tanh_form ? tanhf(x * 0.5f) : x;
  }
  F[0] = M[0];
  for (int j = 1; j < d; ++j) F[j] = tanh_form ? F[j - 1] * M[j] : pair_op(cp.mode, F[j - 1], M[j]);
  float bwd = M[d - 1];
  float o = F[d - 2];
  emit(d - 1, postprocess(cp, tanh_form ? tanh_post(o) : o));
  for (int j = d - 2; j >= 1; --j) {
    o = tanh_form ? F[j - 1] * bwd : pair_op(cp.mode, F[j - 1], bwd);
    emit(j, postprocess(cp, tanh_form ? tanh_post(o) : o));
    bwd = tanh_form ? bwd * M[j] : pair_op(cp.mode, bwd, M[j]);
  }
  emit(0, postprocess(cp, tanh_form ? tanh_post(bwd) : bwd));
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
template <class Msg>
__device__ __forceinline__ void check_update(const CnParams& cp, const Msg& m,
                                             const typename Msg::T* __restrict__ lv2c,
                                             typename Msg::T* __restrict__ lc2v, int e0, int d,
                                             size_t B, size_t b) {
  check_combine(
      cp, d, [&](int j) { return m.load(lv2c[(e0 + j) * B + b]); },
      [&](int j, float o) { lc2v[(e0 + j) * B + b] = m.store(o); });
}

}  // namespace
