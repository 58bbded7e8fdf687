"""On-device channel simulation: encode -> BPSK -> noise -> LLRs (with a
constellation: encode -> M-ASK -> noise -> bitwise LLRs; the BEC: encode
-> erase -> 3-state symbols).

The port of :mod:`libldpc_tpu.ops.channel` for the AWGN (BPSK or M-ASK),
BSC and BEC channels, node-major ``[nc, B]`` in the sorted VN labelling.  Random
numbers come from an explicit ``torch.Generator`` on the channel's device
(one per sweep point and batch, see :func:`make_generator`); they are not
jax's threefry draws, so channels agree with the JAX package in
distribution only.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.params import SHORTEN_LLR
from . import modulation as mod
from .sorted import TorchSortedCode

#: The erasure symbol of the BEC's 3-state alphabet {0, 1, ERASURE}.
BEC_ERASURE = 2


class ChannelOutput(NamedTuple):
    """One simulated batch ready for decoding."""

    llr: torch.Tensor  # f32 [nc, B] decoder input (BEC: u8 symbols {0, 1, BEC_ERASURE})
    codeword: torch.Tensor  # u8 [nc, B] true transmitted codeword


def make_generator(device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``SeedSequence(key)``, e.g.
    ``(seed, point, batch)``: distinct keys give independent streams."""
    seed = int(np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & (2**63 - 1))
    return gen


def encode_batch(sdc: TorchSortedCode, gen: torch.Generator, batch: int) -> torch.Tensor:
    """Random Bernoulli(1/2) info words encoded as ``c = u G mod 2``:
    ``u8 [nc, B]``, all zeros when the code has no generator.  The product
    runs in float32; the counts stay exact below 2**24 info bits."""
    if sdc.G is None:
        return torch.zeros((sdc.nc, batch), dtype=torch.uint8, device=sdc.device)
    u = torch.randint(0, 2, (sdc.kc, batch), generator=gen, device=sdc.device)
    c = torch.matmul(sdc.G.t(), u.to(torch.float32))
    return (c.to(torch.int32) % 2).to(torch.uint8)


def _place(sdc: TorchSortedCode, values: torch.Tensor, shorten_value: float) -> torch.Tensor:
    """Full ``[nc, B]`` LLRs: transmitted bits get ``values``, punctured bits
    0 and shortened bits ``shorten_value``."""
    llr = torch.zeros((sdc.nc, values.shape[1]), dtype=torch.float32, device=values.device)
    if sdc.shorten.shape[0]:
        llr[sdc.shorten.long()] = shorten_value
    llr[sdc.bit_pos.long()] = values
    return llr


def awgn_values(sdc: TorchSortedCode, c: torch.Tensor, noise: torch.Tensor,
                snr_db: float) -> torch.Tensor:
    """The BPSK LLRs ``2y/sigma^2`` of codewords ``c`` (u8 ``[nc, B]``)
    under unit normal draws ``noise`` (``[nct, B]``, one per transmitted
    bit)."""
    sigma2 = np.float32(10.0 ** (-float(snr_db) / 10.0))
    x = 1.0 - 2.0 * c.index_select(0, sdc.bit_pos).to(torch.float32)
    y = x + noise * float(np.sqrt(sigma2))
    return _place(sdc, 2.0 * y / float(sigma2), SHORTEN_LLR)


def awgn_channel(sdc: TorchSortedCode, gen: torch.Generator, batch: int, snr_db: float) -> ChannelOutput:
    """BPSK (0 -> +1, 1 -> -1) over AWGN with ``sigma^2 = 10^(-snr/10)``,
    ``LLR = 2y/sigma^2``."""
    c = encode_batch(sdc, gen, batch)
    noise = torch.randn((sdc.nct, batch), generator=gen, device=c.device, dtype=torch.float32)
    return ChannelOutput(llr=awgn_values(sdc, c, noise, snr_db), codeword=c)


def modulated_values(sdc: TorchSortedCode, c: torch.Tensor, noise: torch.Tensor, snr_db: float,
                     cstl: mod.Constellation, bit_mapper: torch.Tensor) -> torch.Tensor:
    """The M-ASK bitwise LLRs of codewords ``c`` under unit normal draws
    ``noise`` (``[n_sym, B]``, one per symbol); see
    :func:`modulated_awgn_channel`."""
    x = mod.modulate(cstl, mod.map_bits_to_symbols(cstl, bit_mapper, c))
    sigma2 = np.float32(10.0 ** (-float(snr_db) / 10.0))
    y = x + noise * float(np.sqrt(sigma2))
    llr = mod.demap_llrs_to_codeword(mod.bitwise_llrs(cstl, y, sigma2), bit_mapper, sdc.nc)
    if sdc.shorten.shape[0]:
        llr[sdc.shorten.long()] = SHORTEN_LLR
    return llr


def modulated_awgn_channel(sdc: TorchSortedCode, gen: torch.Generator, batch: int,
                           snr_db: float, cstl: mod.Constellation,
                           bit_mapper: torch.Tensor) -> ChannelOutput:
    """M-ASK over AWGN: the codeword's bits packed into labels through
    ``bit_mapper`` (``[bits, n_sym]`` sorted codeword positions), the
    points plus one ``randn`` draw ``[n_sym, B]`` scaled by ``sigma``, then
    the bitwise LLRs scattered back to their positions.  The draws come
    from ``gen`` in :func:`awgn_channel`'s order, so M = 2 with labels
    ``[1, 0]`` and the transmitted bits as the mapper gives its LLRs to
    rounding.  Shortened bits get ``SHORTEN_LLR``; a punctured bit that no
    mapper entry names stays 0."""
    c = encode_batch(sdc, gen, batch)
    noise = torch.randn((bit_mapper.shape[1], batch), generator=gen, device=c.device,
                        dtype=torch.float32)
    return ChannelOutput(llr=modulated_values(sdc, c, noise, snr_db, cstl, bit_mapper),
                         codeword=c)


def bsc_values(sdc: TorchSortedCode, c: torch.Tensor, uniform: torch.Tensor,
               epsilon: float) -> torch.Tensor:
    """The BSC LLRs ``±log((1-eps)/eps)`` of codewords ``c`` whose
    transmitted bits flip where ``uniform < epsilon`` (``[nct, B]``)."""
    y = c.index_select(0, sdc.bit_pos) ^ (uniform < epsilon).to(torch.uint8)
    delta = float(np.float32(np.log((1.0 - epsilon) / epsilon)))
    return _place(sdc, delta * (1.0 - 2.0 * y.to(torch.float32)), delta)


def bsc_channel(sdc: TorchSortedCode, gen: torch.Generator, batch: int, epsilon: float) -> ChannelOutput:
    """Binary symmetric channel: flip with probability ``epsilon``,
    ``LLR = ±log((1-eps)/eps)``; shortened bits get ``+delta``."""
    c = encode_batch(sdc, gen, batch)
    uniform = torch.rand((sdc.nct, batch), generator=gen, device=c.device)
    return ChannelOutput(llr=bsc_values(sdc, c, uniform, epsilon), codeword=c)


def bec_values(sdc: TorchSortedCode, c: torch.Tensor, uniform: torch.Tensor,
               epsilon: float) -> torch.Tensor:
    """The BEC symbols of codewords ``c`` whose transmitted bits are erased
    where ``uniform < epsilon`` (``[nct, B]``); punctured bits erased,
    shortened bits known."""
    x = c.index_select(0, sdc.bit_pos)
    sym = torch.full(c.shape, BEC_ERASURE, dtype=torch.uint8, device=c.device)
    if sdc.shorten.shape[0]:
        sym[sdc.shorten.long()] = c.index_select(0, sdc.shorten)
    sym[sdc.bit_pos.long()] = torch.where(uniform < epsilon, BEC_ERASURE, x).to(torch.uint8)
    return sym


def bec_channel(sdc: TorchSortedCode, gen: torch.Generator, batch: int, epsilon: float) -> ChannelOutput:
    """Binary erasure channel: each transmitted bit is erased with
    probability ``epsilon``; u8 symbols ``{0, 1, BEC_ERASURE}``, punctured
    bits erased and shortened bits known."""
    c = encode_batch(sdc, gen, batch)
    uniform = torch.rand((sdc.nct, batch), generator=gen, device=c.device)
    return ChannelOutput(llr=bec_values(sdc, c, uniform, epsilon), codeword=c)


def channel_values(sdc: TorchSortedCode, channel_type: str, c: torch.Tensor, draws: torch.Tensor,
                   x_value: float, modulation=None) -> torch.Tensor:
    """The decoder input of codewords ``c`` under the channel's draws (unit
    normals for AWGN, uniforms for the BSC and the BEC; one per transmitted
    bit, or per symbol with a constellation): :func:`simulate_channel`
    after its encode and its draw."""
    if channel_type == "AWGN":
        if modulation is not None:
            return modulated_values(sdc, c, draws, x_value, *modulation)
        return awgn_values(sdc, c, draws, x_value)
    if channel_type == "BSC":
        return bsc_values(sdc, c, draws, x_value)
    if channel_type == "BEC":
        return bec_values(sdc, c, draws, x_value)
    raise ValueError(f"No channel selected: {channel_type!r}")


def simulate_channel(
    sdc: TorchSortedCode,
    channel_type: str,
    gen: torch.Generator,
    batch: int,
    x_value: float,
    modulation=None,
) -> ChannelOutput:
    """Dispatch on the reference's channel-type strings; ``modulation``,
    ``(Constellation, bit_mapper)`` with the mapper in sorted labels on the
    code's device, turns AWGN into :func:`modulated_awgn_channel` (the
    other channels ignore it, as in the JAX package)."""
    if channel_type == "AWGN":
        if modulation is not None:
            return modulated_awgn_channel(sdc, gen, batch, x_value, *modulation)
        return awgn_channel(sdc, gen, batch, x_value)
    if channel_type == "BSC":
        return bsc_channel(sdc, gen, batch, x_value)
    if channel_type == "BEC":
        return bec_channel(sdc, gen, batch, x_value)
    raise ValueError(f"No channel selected: {channel_type!r}")
