"""curand's Philox4x32-10 generator and its keying, in PyTorch int64
arithmetic (exact on any device): the counter-based generator the
program's channel draw seeds with ``curand_init(key, lane, offset)``.

A state made by ``curand_init(seed, subsequence, offset)`` with ``offset``
a multiple of 4 has the counter ``(offset / 4, 0, subsequence low,
subsequence high)`` and the key ``(seed low, seed high)``; its first
``curand4`` returns Philox4x32-10 of that counter, and ``curand_normal4``
turns its four words into two Box-Muller pairs.
"""

from __future__ import annotations

import numpy as np
import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor):
    p = x * m  # int64 wraps modulo 2**64: the low 64 bits are exact
    return (p >> 32) & MASK, p & MASK


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Ten Philox rounds of the counters (int64 tensors holding 32-bit
    values, broadcast together) under the key ``(k0, k1)``: four int64
    tensors of 32-bit words."""
    c = [torch.as_tensor(v, dtype=torch.int64) for v in (c0, c1, c2, c3)]
    c = list(torch.broadcast_tensors(*c))
    for r in range(10):
        if r:
            k0, k1 = (k0 + W0) & MASK, (k1 + W1) & MASK
        hi0, lo0 = _mulhilo(M0, c[0])
        hi1, lo1 = _mulhilo(M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def curand4(seed: int, lanes: torch.Tensor, call: torch.Tensor):
    """The four words of ``curand4`` after ``curand_init(seed, lane, 4 *
    call)``: int64 ``[4, len(call), len(lanes)]``.  ``lanes`` and ``call``
    are int64 tensors (< 2**32) on one device."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    k0, k1 = seed & MASK, (seed >> 32) & MASK
    c0 = call.to(torch.int64)[:, None]
    c2 = (lanes.to(torch.int64) & MASK)[None, :]
    c3 = (lanes.to(torch.int64) >> 32)[None, :]
    zero = torch.zeros((), dtype=torch.int64, device=lanes.device)
    return torch.stack(philox4x32_10(c0, zero, c2, c3, k0, k1))


#: curand's float constants, as the float32 numbers the device holds
INV_2POW32 = np.float32(2.3283064e-10)
INV_2POW32_2PI = np.float32(np.float32(2.3283064e-10) * np.float32(6.2831855))


def box_muller(x: torch.Tensor, y: torch.Tensor):
    """curand's Box-Muller pair of two 32-bit words: ``u`` and ``v`` formed
    in float32 as the device forms them, then ``sqrt(-2 log u) * (sin v,
    cos v)`` in float64 (the device's float32 ``log``, ``sin`` and ``cos``
    differ from these by a few units in the last place)."""
    u = x.to(torch.float32) * torch.tensor(INV_2POW32) + torch.tensor(INV_2POW32 / np.float32(2))
    v = (y.to(torch.float32) * torch.tensor(INV_2POW32_2PI)
         + torch.tensor(INV_2POW32_2PI / np.float32(2)))
    s = torch.sqrt(-2.0 * torch.log(u.to(torch.float64)))
    v = v.to(torch.float64)
    return s * torch.sin(v), s * torch.cos(v)


def normal4(words: torch.Tensor) -> torch.Tensor:
    """``curand_normal4`` of ``words`` ``[4, ...]``: ``[4, ...]`` float64."""
    a, b = box_muller(words[0], words[1])
    c, d = box_muller(words[2], words[3])
    return torch.stack([a, b, c, d])
