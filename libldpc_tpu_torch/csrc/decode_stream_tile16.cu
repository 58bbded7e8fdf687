// The flooding BP streaming chunk, tile form at 16 frames a block
// (flood_stream.cuh has the kernel and what it replaces).
#include "flood_stream.cuh"

LDPC_FLOOD_STREAM_ENTRY(ldpc_bp_stream_chunk_tile16, 16)

// The shared memory a tile form takes, in bytes (msg: bytes of a message;
// ops/kernels/decode_fused.py stream_tile_bytes counts the same, and the
// card tests hold the two against each other).
extern "C" long long ldpc_flood_tile_bytes(int nc, int mc, int nnz, int frames, int msg,
                                           int stage) {
  return (long long)flood_tile_bytes(nc, mc, nnz, frames, msg, stage != 0);
}
