// The fast layered engine's streaming chunk, tile form at 8 frames a block
// (layered_stream.cuh has the kernels and what they replace).
#include "layered_stream.cuh"

LDPC_STREAM_ENTRY(ldpc_bp_stream_chunk_layered_tile8, 8)
