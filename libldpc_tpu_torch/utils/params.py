"""Runtime configuration: the decoder, channel and sweep parameters.

A copy of :mod:`libldpc_tpu.utils.params` with the same fields and
defaults (the reference's ``decoder_param``, ``channel_param`` and
``simulation_param``), so that one configuration means the same in both
packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

#: LLR magnitude that pins a known (shortened) bit, the reference's 99999.9.
SHORTEN_LLR = 99999.9


@dataclasses.dataclass(frozen=True)
class DecoderParams:
    """Decoder configuration.

    ``type``: the CN form, ``"BP"``, ``"BP_MS"``, ``"BP_TANH"``,
    ``"BP_PHI"``, ``"BP_LIN"``, ``"BP_NMS"`` or ``"BP_OMS"``; any other
    string behaves like ``"BP"``, as in the reference.  ``layered``: the
    layered schedule over the code's layers.  ``ms_scale``/``ms_offset``:
    the normalised/offset min-sum corrections.  ``bec_ref_bug_compat``:
    the BEC decoder's degree-1 variables emit the reference's stale byte
    (0) instead of an erasure, and an unresolved bit decides 1, which
    reproduces the reference's BEC curves; False is the correct peeling
    algorithm."""

    early_term: bool = True
    iterations: int = 50
    type: str = "BP"
    layered: bool = False
    ms_scale: float = 0.75
    ms_offset: float = 0.15
    message_dtype: str = "float32"
    quant_scale: float = 0.1875
    permute: str = "auto"
    bec_ref_bug_compat: bool = False

    @property
    def use_minsum(self) -> bool:
        return self.type == "BP_MS"

    @property
    def cn_mode(self):
        """The (hashable) CN-operator spec passed to the decoders."""
        if self.type in ("BP_NMS", "BP_OMS"):
            return (self.type, self.ms_scale, self.ms_offset)
        return self.type


@dataclasses.dataclass(frozen=True)
class ChannelParams:
    """Channel configuration.  ``x_range`` is ``(min, max, step)`` with
    ``max`` exclusive, accumulated in float like the reference's sweep
    builder; BSC and BEC sweeps run in reverse (worst point first).
    ``x_values``, when set, is used as given."""

    seed: int = 0
    x_range: Sequence[float] = (0.0, 2.0, 1.0)
    type: str = "AWGN"
    x_values: Optional[Sequence[float]] = None

    def sweep_values(self) -> list[float]:
        if self.x_values is not None:
            return [float(v) for v in self.x_values]
        lo, hi, step = self.x_range
        vals = []
        val = float(lo)
        while val < hi:
            vals.append(val)
            val += step
        if self.type in ("BSC", "BEC"):
            vals.reverse()
        return vals


@dataclasses.dataclass(frozen=True)
class SimulationParams:
    """Sweep configuration: ``batch_size`` frames per device step, the
    stopping rule ``fec``/``max_frames``, the results file, the forensic
    error log (``error_log_codewords`` adds both words to each line; a log
    turns streaming off), the checkpoint file, the lookahead
    ``pipeline_depth``, and the streaming switch and chunk length."""

    batch_size: int = 1024
    max_frames: int = int(10e9)
    fec: int = 50
    result_file: Optional[str] = None
    error_log_file: Optional[str] = None
    error_log_codewords: bool = False
    checkpoint_file: Optional[str] = None
    pipeline_depth: int = 2
    streaming: bool = True
    streaming_chunk: int = 0
