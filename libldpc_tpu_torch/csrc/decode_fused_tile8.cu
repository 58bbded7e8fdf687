// The flooding BP batch decode, tile form at 8 frames a block
// (flood_stream.cuh has the kernels and what they replace).
#include "flood_stream.cuh"

LDPC_FLOOD_BATCH_ENTRY(ldpc_bp_decode_fused_tile8, 8)
