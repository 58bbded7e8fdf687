// The exact layered schedule, tile form at 16 frames a block
// (layered_exact_tile.cuh has the kernel and what it replaces).
#include "layered_exact_tile.cuh"

LDPC_EXACT_TILE_ENTRY(ldpc_bp_decode_layered_tile16, 16)

// The shared memory a tile form takes, in bytes (msg: bytes of a message;
// ops/kernels/decode_layered.py exact_tile_bytes counts the same, and the
// card tests hold the two against each other).
extern "C" long long ldpc_exact_tile_bytes(int nc, int mc, int nnz, int nl, int nlc, int nlv,
                                           int frames, int msg, int stage, int priors) {
  return (long long)exact_tile_bytes(nc, mc, nnz, nl, nlc, nlv, frames, msg, stage != 0,
                                     priors != 0);
}
