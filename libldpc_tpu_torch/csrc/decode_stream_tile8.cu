// The flooding BP streaming chunk, tile form at 8 frames a block
// (flood_stream.cuh has the kernel and what it replaces).
#include "flood_stream.cuh"

LDPC_FLOOD_STREAM_ENTRY(ldpc_bp_stream_chunk_tile8, 8)
