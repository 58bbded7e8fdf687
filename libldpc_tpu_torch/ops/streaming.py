"""Streaming counters and exact quota splitting (from
:mod:`libldpc_tpu.ops.streaming`).

The XLA streaming decoder of that module (``StreamState``,
``_superstep_body``) is not ported yet (ROADMAP Queue 1, "XLA streaming"); the
streaming sweep runs on the fused kernel (:mod:`.streaming_fused`), which
needs only these pieces.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

#: Per-device start-quota clamp: keeps a quota and the frames started under
#: it inside int32 with headroom for one chunk's starts.
_INT32_SAFE = 2**31 - 2**20


class StreamDeltas(NamedTuple):
    """Counters for frames *completed* during one super-step (int64
    device scalars: the per-lane int32 counter planes are summed in int64)."""

    bit_errors: torch.Tensor
    frame_errors: torch.Tensor
    frames: torch.Tensor
    iter_sum: torch.Tensor
    n_active: torch.Tensor  # in-flight frames after the step


def split_exact(total, parts: int) -> np.ndarray:
    """Split a frame offset over ``parts`` per-device ``started`` counters
    so they sum to ``total`` exactly, the remainder on low indices (the
    split the per-device quotas use), each clamped to ``_INT32_SAFE``."""
    total = int(min(int(total), parts * _INT32_SAFE))
    base, rem = divmod(total, parts)
    out = np.full(parts, base, np.int64)
    out[:rem] += 1
    return np.minimum(out, _INT32_SAFE).astype(np.int32)
