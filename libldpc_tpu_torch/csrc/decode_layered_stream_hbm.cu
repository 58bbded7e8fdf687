// The fast layered engine's streaming chunk, HBM-plane form
// (layered_stream.cuh has the kernels and what they replace).
#include "layered_stream.cuh"

LDPC_STREAM_ENTRY(ldpc_bp_stream_chunk_layered_hbm, 0)
