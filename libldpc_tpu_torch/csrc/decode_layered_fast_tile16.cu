// The fast layered engine's batch decode, tile form at 16 frames a block
// (layered_stream.cuh has the kernels and what they replace).
#include "layered_stream.cuh"

LDPC_FAST_BATCH_ENTRY(ldpc_bp_decode_layered_fast_tile16, 16)

// The shared memory a tile form of K3 or K4 takes, in bytes
// (ops/kernels/decode_layered.py fast_tile_bytes counts the same, and the
// card tests hold the two against each other).
extern "C" long long ldpc_fast_tile_bytes(int nc, int mc, int nnz, int nl, int nlc, int frames,
                                          int stage) {
  return (long long)fast_tile_bytes(nc, mc, nnz, nl, nlc, frames, stage != 0);
}
