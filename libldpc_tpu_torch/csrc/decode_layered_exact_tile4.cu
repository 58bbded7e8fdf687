// The exact layered schedule, tile form at 4 frames a block
// (layered_exact_tile.cuh has the kernel and what it replaces).
#include "layered_exact_tile.cuh"

LDPC_EXACT_TILE_ENTRY(ldpc_bp_decode_layered_tile4, 4)
