"""The BEC decoder's output (from :mod:`libldpc_tpu.ops.bec`).

The decoders are :func:`.bec_sorted.bec_decode_sorted` (plain) and the
CUDA kernel of :mod:`.kernels.decode_bec`; the JAX package's decoder on
its padded layout (``bec_decode``) is not ported (ROADMAP Queue 1, "Do not
port unless a test needs it").
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BECDecodeOutput(NamedTuple):
    symbols_out: torch.Tensor  # u8 [nc, B] posterior symbols {0, 1, BEC_ERASURE}
    hard: torch.Tensor  # u8 [nc, B] decided bits (the wrong bit where unresolved)
    iterations: torch.Tensor  # int32 [B]
    resolved: torch.Tensor  # bool [B] True when no erasures remain
