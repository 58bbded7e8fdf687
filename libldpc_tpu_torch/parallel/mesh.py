"""The per-batch simulation step (from :mod:`libldpc_tpu.parallel.mesh`).

One device, no mesh: channel simulation -> decode -> error counting.
Points-parallel and multi-GPU sharding are not ported yet (ROADMAP Queue 1,
"Multi-GPU").
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops.channel import simulate_channel
from ..ops.kernels.decode_bec import bec_decode_fused
from ..ops.kernels.decode_fused import bp_decode_fused
from ..ops.kernels.decode_layered import bp_decode_layered, bp_decode_layered_fast
from ..ops.kernels.layout import KernelTables


class StepCounters(NamedTuple):
    """Counters of one decoded batch, as int64 device scalars."""

    bit_errors: torch.Tensor  # wrong transmitted bits
    frame_errors: torch.Tensor  # frames with >= 1 bit error
    frames: torch.Tensor
    iter_sum: torch.Tensor  # sum of per-frame iterations


class ForensicStepCounters(NamedTuple):
    """:class:`StepCounters` plus the per-frame planes of the forensic error
    log, in sorted VN labels; made only when asked for, so the ordinary
    batch step carries no extra plane."""

    bit_errors: torch.Tensor
    frame_errors: torch.Tensor
    frames: torch.Tensor
    iter_sum: torch.Tensor
    frame_bit_errors: torch.Tensor  # int64 [B] wrong transmitted bits per frame
    hard: torch.Tensor  # u8 [nc, B] decided bits
    codeword: torch.Tensor  # u8 [nc, B] true codeword


def batch_decoder(tables: KernelTables, schedule: str):
    """The batch kernel of a schedule (``"flooding"``, ``"layered"`` or
    ``"layered-fast"``).  The exact layered schedule with fewer than two
    layers is flooding, as in the JAX decoders."""
    if schedule == "layered-fast":
        return bp_decode_layered_fast
    if schedule == "layered" and tables.n_layers > 1:
        return bp_decode_layered
    return bp_decode_fused


def _sim_and_count(
    tables: KernelTables,
    gen: torch.Generator,
    x_value: float,
    channel_type: str,
    dec,
    batch: int,
    schedule: str,
    forensics: bool = False,
    modulation=None,
):
    """Simulate (through ``modulation``'s constellation when given), decode with the schedule's batch kernel in
    ``dec.message_dtype`` (the BEC: the peeling kernel, flooding), count
    from its decisions.  Bit errors count the transmitted bits
    (``bit_pos``) only.  ``forensics`` returns
    :class:`ForensicStepCounters`, else :class:`StepCounters`."""
    ch = simulate_channel(tables.code, channel_type, gen, batch, x_value, modulation)
    if channel_type == "BEC":
        out = bec_decode_fused(
            tables, ch.llr, ch.codeword, iterations=dec.iterations, early_term=dec.early_term,
            degree1_stale_byte=0 if dec.bec_ref_bug_compat else None,
        )
    else:
        out = batch_decoder(tables, schedule)(
            tables, ch.llr, iterations=dec.iterations, early_term=dec.early_term,
            minsum_mode=dec.cn_mode, message_dtype=dec.message_dtype, quant_scale=dec.quant_scale)
    bit_pos = tables.code.bit_pos
    frame_errs = (
        out.hard.index_select(0, bit_pos).bool() != ch.codeword.index_select(0, bit_pos).bool()
    ).sum(0)
    base = StepCounters(
        bit_errors=frame_errs.sum(),
        frame_errors=(frame_errs > 0).sum(),
        frames=torch.full((), batch, dtype=torch.int64, device=ch.codeword.device),
        iter_sum=out.iterations.sum(dtype=torch.int64),
    )
    if forensics:
        return ForensicStepCounters(*base, frame_bit_errors=frame_errs,
                                    hard=out.hard.to(torch.uint8), codeword=ch.codeword)
    return base


def make_sim_step(
    tables: KernelTables, channel_type: str, dec, batch: int, schedule: str,
    forensics: bool = False, modulation=None,
) -> Callable[[torch.Generator, float], StepCounters]:
    """``step(gen, x_value) -> StepCounters`` on ``tables``' device
    (:class:`ForensicStepCounters` with ``forensics``); ``modulation`` as
    :func:`~..ops.channel.simulate_channel` takes it."""

    def step(gen: torch.Generator, x_value: float) -> StepCounters:
        return _sim_and_count(tables, gen, x_value, channel_type, dec, batch, schedule, forensics,
                              modulation)

    return step
