// Host-side choice of a kernel's instantiation from the message dtype code
// (ops/messages.py DTYPE_CODES) and the CN mode: one instantiation per
// storage form and CN family (cn_forms.cuh).  The int8 lattice takes the
// min-sum family only, as the wrappers enforce.
#pragma once

#include <cuda_runtime.h>

#include "cn_forms.cuh"

namespace {

enum MsgDtype { MSG_F32 = 0, MSG_BF16 = 1, MSG_INT8 = 2 };

template <int FAM>
struct Fam {
  static constexpr int value = FAM;
};

// fn(msg traits, Fam<family>{}) -> the launch's cudaGetLastError()
template <class Msg, class Fn>
int by_family(int cn_mode, const Msg& m, Fn fn) {
  switch (cn_family(cn_mode)) {
    case FAM_MS:
      return fn(m, Fam<FAM_MS>{});
    case FAM_BP:
      return fn(m, Fam<FAM_BP>{});
    default:
      return fn(m, Fam<FAM_REST>{});
  }
}

template <class Fn>
int by_form(int msg_dtype, float inv_q, int cn_mode, Fn fn) {
  switch (msg_dtype) {
    case MSG_F32:
      return by_family(cn_mode, F32Msg{}, fn);
    case MSG_BF16:
      return by_family(cn_mode, Bf16Msg{}, fn);
    case MSG_INT8:
      if (cn_family(cn_mode) == FAM_MS) return fn(Int8Msg{inv_q}, Fam<FAM_MS>{});
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
