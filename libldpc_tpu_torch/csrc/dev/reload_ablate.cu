// Dev-only build of K8's reload form into the stream state (the form every
// pass of the XLA super-step took before the staged reload) with its stores
// switched off at run time, to time what the stores cost: run by
// tests_gpu/reload_ablate.py, never by the library.  An ablated draw's
// results are wrong by design; the values are still computed (the switches
// are run-time arguments, so the compiler keeps every draw and transform).
//
// It includes the library's source whole, so the plan, the draw kernel and
// its tiling are the library's; only the sink differs: AblateSink is
// PlaneSink with each of its two store groups behind a switch.
#include "../pool_refill.cu"

namespace {

struct AblateSink {
  static constexpr bool kSymbols = false;
  PlaneSink base;  // the state planes, lv2c set
  int planes;      // 1: the LLR and codeword stores run
  int messages;    // 1: the first messages' stores run
  __device__ __forceinline__ void value(int v, size_t lane, int, float x) const {
    if (planes) ((float*)base.fresh)[v * base.B + lane] = x;
    if (messages) {
      const int j1 = __ldg(base.vn_ptr + v + 1);
      for (int j = __ldg(base.vn_ptr + v); j < j1; ++j)
        base.lv2c[(size_t)__ldg(base.perm_c2v + j) * base.B + lane] = x;
    }
  }
  __device__ __forceinline__ void symbol(int, size_t, int, uint8_t) const {}
  __device__ __forceinline__ void codeword(int v, size_t lane, int, uint8_t c) const {
    if (planes) base.fresh_cw[v * base.B + lane] = c;
  }
  __device__ __forceinline__ void drawn(size_t lane, int rank) const { base.drawn(lane, rank); }
};

}  // namespace

extern "C" {

// ldpc_pool_reload (pool_refill.cu) with two leading switches: `planes`
// (the LLR and codeword stores) and `messages` (each edge's first message).
int ldpc_reload_ablate(int planes, int messages, int channel, const uint2* gtiles,
                       const int* slab_tile0, const int* col_src, int ksteps, int kwords, int kw,
                       const int* item_src, const int* item_dst, int n_items, int bpi,
                       const int* other_pos, const uint8_t* other_short, int n_other,
                       int other_col0, const float* points, const float* logp,
                       const int* label_of, const int* point_of, int M, int lane_tile,
                       int items_per_slab, int others_per_slab, int slab_cols, void* fresh,
                       uint8_t* fresh_cw, const int* lanes, const int* count,
                       const unsigned long long* key, float* debug, uint32_t* debug_info, int B,
                       float sigma, float inv_s2, float two_s2, float delta, float eps,
                       float shorten, float* lv2c, const int* vn_ptr, const int* perm_c2v,
                       int* done, int* age, int* iters, void* stream) {
  const PlaneSink base{fresh, fresh_cw, nullptr, (size_t)B, lv2c, vn_ptr, perm_c2v, done, age, iters};
  return pool_draw(channel, gtiles, slab_tile0, col_src, ksteps, kwords, kw, item_src, item_dst,
                   n_items, bpi, other_pos, other_short, n_other, other_col0, points, logp,
                   label_of, point_of, M, lane_tile, items_per_slab, others_per_slab, slab_cols,
                   lanes, count, key, debug, debug_info, B, sigma, inv_s2, two_s2, delta, eps,
                   shorten, AblateSink{base, planes, messages}, stream);
}

}  // extern "C"
