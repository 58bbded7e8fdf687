// Lane-order scans over a batch in one block of kScanThreads threads: the
// start grants of a streaming chunk (pool_refill.cu stream_grant_kernel) and
// the lanes a pool refill draws (pool_plan_kernel).  A round covers
// kScanThreads x kScanRun lanes; thread i holds lanes [16 i, 16 i + 16) of
// the round as a 16-bit mask, loaded as four 16-byte vectors where the
// plane is aligned and the run lies inside the batch (lane by lane on the
// ragged end), then the block scans the masks' counts, warp by warp with
// shuffles and across the warps through shared memory.  A scan of 16384
// lanes reads each int32 plane once in 16-byte loads, with one round and
// two barriers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScanThreads = 1024;
constexpr int kScanRun = 16;  // lanes a thread, one bit each of its mask
constexpr int kScanRound = kScanThreads * kScanRun;

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// Bit i: x[base + i] != 0, for the lanes base + i < B (0 past B).
__device__ __forceinline__ uint32_t nonzero_mask16(const int* __restrict__ x, int base, int B) {
  uint32_t m = 0;
  if (base + kScanRun <= B && aligned16(x)) {
    const int4* v = reinterpret_cast<const int4*>(x + base);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 w = v[q];
      m |= (uint32_t)(w.x != 0) << (4 * q) | (uint32_t)(w.y != 0) << (4 * q + 1) |
           (uint32_t)(w.z != 0) << (4 * q + 2) | (uint32_t)(w.w != 0) << (4 * q + 3);
    }
  } else {
    for (int i = 0; i < kScanRun; ++i)
      if (base + i < B && x[base + i] != 0) m |= 1u << i;
  }
  return m;
}

// Bits of the lanes base + i < B.
__device__ __forceinline__ uint32_t valid_mask16(int base, int B) {
  const int n = min(max(B - base, 0), kScanRun);
  return n >= 32 ? 0xffffffffu : (1u << n) - 1u;
}

// The lowest k set bits of m (k <= popc(m)).
__device__ __forceinline__ uint32_t lowest_set_bits(uint32_t m, int k) {
  for (int c = __popc(m) - k; c > 0; --c) m &= ~(0x80000000u >> __clz(m));
  return m;
}

// Exclusive prefix of each thread's n over the block (threads in order) and
// the block's total; `sh` holds kScanThreads / 32 ints.  Every thread calls it.
__device__ __forceinline__ int block_exclusive_scan(int n, int* total, int* sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int x = n;  // inclusive over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int t = sh[lane];  // kScanThreads / 32 == 32 warps
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    sh[lane] = t;
  }
  __syncthreads();
  const int excl = x - n + (wid ? sh[wid - 1] : 0);
  *total = sh[kScanThreads / 32 - 1];
  __syncthreads();  // sh is free again
  return excl;
}

// Bit i of m as byte i of the 16 bytes at out[base..], for the lanes < B:
// one 16-byte store where it can.
__device__ __forceinline__ void store_mask16(uint8_t* __restrict__ out, uint32_t m, int base, int B) {
  if (base + kScanRun <= B && aligned16(out + base)) {
    uint4 w;
    w.x = (((m >> 0) & 0xFu) * 0x00204081u) & 0x01010101u;
    w.y = (((m >> 4) & 0xFu) * 0x00204081u) & 0x01010101u;
    w.z = (((m >> 8) & 0xFu) * 0x00204081u) & 0x01010101u;
    w.w = (((m >> 12) & 0xFu) * 0x00204081u) & 0x01010101u;
    *reinterpret_cast<uint4*>(out + base) = w;
  } else {
    for (int i = 0; i < kScanRun; ++i)
      if (base + i < B) out[base + i] = (uint8_t)((m >> i) & 1u);
  }
}

}  // namespace
