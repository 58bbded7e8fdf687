// The fast layered engine's batch decode, tile form at 8 frames a block
// (layered_stream.cuh has the kernels and what they replace).
#include "layered_stream.cuh"

LDPC_FAST_BATCH_ENTRY(ldpc_bp_decode_layered_fast_tile8, 8)
