"""M-ASK modulation: constellations, bit mapping, bitwise LLRs.

The port of :mod:`libldpc_tpu.ops.modulation` (the GPU stack's
modulation; the CPU stack is BPSK only):

* :class:`Constellation`: uniform M-ASK points ``-M+1+2j`` normalised to
  unit energy with uniform priors, and the simfile's bit labels;
* a bit mapper ``[bits, n_sym]`` of codeword-bit positions per symbol
  (most significant bit first);
* :func:`map_bits_to_symbols`, :func:`modulate`: codeword bits to labels
  to point amplitudes;
* :func:`bitwise_llrs`: the exact per-bit LLR
  ``log sum_{x: bit=0} p(y|x) p(x) - log sum_{x: bit=1} p(y|x) p(x)`` as a
  logsumexp, clamped to ``MIN_LLR``/``MAX_LLR``;
* :func:`demap_llrs_to_codeword`: the bit LLRs scattered to codeword
  positions.

Batched ``[n_sym, B]`` on the device of the inputs, float32.  The JAX
package computes these in XLA, outside its Pallas kernels; plain PyTorch
is their counterpart here (no kernel).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..utils.params import MAX_LLR, MIN_LLR


@dataclasses.dataclass(frozen=True)
class Constellation:
    """A uniform M-ASK constellation with bit labels."""

    M: int
    points: np.ndarray  # f64 [M] unit-energy amplitudes, natural order
    priors: np.ndarray  # f64 [M]
    labels: np.ndarray  # int [M] bit label of each point
    labels_rev: np.ndarray  # int [M] point index of each label

    @classmethod
    def mask(cls, M: int, labels: Optional[np.ndarray] = None) -> "Constellation":
        """Uniform M-ASK (``M`` a power of two), naturally labelled unless
        ``labels`` (a permutation of ``0..M-1``) is given."""
        if M < 2 or M & (M - 1):
            raise ValueError(f"M must be a power of two, got {M}")
        pts = -M + 1 + 2.0 * np.arange(M)
        priors = np.full(M, 1.0 / M)
        pts = pts / np.sqrt((pts**2 * priors).sum())
        labels = np.arange(M) if labels is None else np.asarray(labels, dtype=np.int64)
        if sorted(labels.tolist()) != list(range(M)):
            raise ValueError("labels must be a permutation of 0..M-1")
        rev = np.empty(M, dtype=np.int64)
        rev[labels] = np.arange(M)
        return cls(M=M, points=pts, priors=priors, labels=labels, labels_rev=rev)

    @property
    def bits_per_symbol(self) -> int:
        return int(np.log2(self.M))


def default_bit_mapper(bits: int, n_sym: int) -> np.ndarray:
    """Consecutive mapping: symbol ``l`` carries codeword bits
    ``l*bits .. l*bits+bits-1``, most significant first."""
    return np.arange(bits * n_sym).reshape(n_sym, bits).T.copy()


def map_bits_to_symbols(cstl: Constellation, bit_mapper: torch.Tensor,
                        codeword_bits: torch.Tensor) -> torch.Tensor:
    """Point indices ``[n_sym, B]`` of the labels packed (most significant
    bit first) from the mapped codeword bits (u8 ``[nc, B]``)."""
    bits, n_sym = bit_mapper.shape
    gathered = codeword_bits.index_select(0, bit_mapper.reshape(-1).long())
    gathered = gathered.reshape(bits, n_sym, -1).to(torch.int64)
    weights = (2 ** torch.arange(bits - 1, -1, -1, device=gathered.device))[:, None, None]
    label = (gathered * weights).sum(dim=0)
    return torch.as_tensor(cstl.labels_rev, device=gathered.device)[label]


def modulate(cstl: Constellation, sym_idx: torch.Tensor) -> torch.Tensor:
    """Point indices -> float32 amplitudes."""
    return torch.as_tensor(cstl.points, dtype=torch.float32, device=sym_idx.device)[sym_idx]


def bitwise_llrs(cstl: Constellation, y: torch.Tensor, sigma2) -> torch.Tensor:
    """Exact bitwise LLRs ``[bits, n_sym, B]`` of the received amplitudes
    ``y`` (f32 ``[n_sym, B]``) at noise variance ``sigma2``:
    ``logsumexp`` of ``log w(x) = -(y - x)^2 / (2 sigma2) + log p(x)`` over
    the points whose bit is 0, minus that over those whose bit is 1,
    clamped to ``[MIN_LLR, MAX_LLR]``.  The log-weights are computed once,
    ``[M, n_sym, B]``, and each bit's half of the points is taken by
    index."""
    dev = y.device
    pts = torch.as_tensor(cstl.points, dtype=torch.float32, device=dev)
    logp = torch.as_tensor(np.log(cstl.priors), dtype=torch.float32, device=dev)
    two_s2 = torch.as_tensor(2.0 * np.float32(sigma2), dtype=torch.float32, device=dev)
    d = y.unsqueeze(0) - pts[:, None, None]
    logw = -(d * d) / two_s2 + logp[:, None, None]
    del d
    bits = cstl.bits_per_symbol
    # bit i (most significant first) of each point's label
    point_bits = ((cstl.labels[None, :] >> np.arange(bits - 1, -1, -1)[:, None]) & 1).astype(bool)
    out = []
    for bit in point_bits:
        l0 = torch.logsumexp(logw[torch.as_tensor(np.flatnonzero(~bit), device=dev)], dim=0)
        l1 = torch.logsumexp(logw[torch.as_tensor(np.flatnonzero(bit), device=dev)], dim=0)
        out.append(l0 - l1)
    return torch.clamp(torch.stack(out), MIN_LLR, MAX_LLR)


def demap_llrs_to_codeword(llr_bits: torch.Tensor, bit_mapper: torch.Tensor,
                           nc: int) -> torch.Tensor:
    """``[nc, B]`` LLRs: position ``bit_mapper[k, l]`` gets
    ``llr_bits[k, l]``; positions no entry names stay 0, entries outside
    ``[0, nc)`` are dropped."""
    B = llr_bits.shape[-1]
    idx = bit_mapper.reshape(-1).long()
    vals = llr_bits.reshape(-1, B)
    keep = (idx >= 0) & (idx < nc)
    out = torch.zeros((nc, B), dtype=llr_bits.dtype, device=llr_bits.device)
    out[idx[keep]] = vals[keep]
    return out
