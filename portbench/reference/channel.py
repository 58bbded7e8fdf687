"""The frames a run draws, worked out again from its seed.

The sweep keys each of its steps: step ``j`` of sweep point ``i`` takes a
``torch.Generator`` seeded from ``SeedSequence([seed, i, j])`` (its first
64-bit word, top bit cleared), and the channel draw of a pass takes one
key from it, ``torch.randint(0, 2**62)`` on the card (a streaming
super-step draws its passes' keys in one call).  The frame of lane ``b``
under key ``k`` is then fixed by curand's Philox with ``curand_init(k, b,
offset)``:

* the info word: calls ``q < ceil(kc / 128)`` give words ``4q .. 4q + 3``;
  info bit ``i`` is bit ``i % 32`` of word ``i // 32``;
* the codeword ``c = u G mod 2``;
* the transmitted bits are the variables that are not punctured, in
  ascending order of the code's own labels; the one of rank ``t`` among
  them takes the normal ``t % 4`` of ``curand_normal4`` at call
  ``ceil(kc / 128) + t // 4`` (K8's draw, ``csrc/pool_refill.cu``: an
  item is a transmitted bit, the items are ``bit_pos`` in that order, and
  item ``t``'s group of four is drawn at offset ``kw + 4 (t // 4)``, ``kw
  = 4 ceil(kc / 128)``); without puncturing, rank and label agree;
* BPSK over AWGN: ``x = 1 - 2c``, ``y = x + r sigma`` with ``sigma^2 =
  10^(-snr / 10)`` (as float32), the LLR ``2 y / sigma^2``; a punctured
  bit's LLR is exactly 0 (its codeword bit is still the encoded one).

Float64 throughout but for the float32 steps curand takes itself.
"""

from __future__ import annotations

import numpy as np
import torch

from .philox import curand4, normal4


def step_generator(seed: int, point: int, step: int, device) -> torch.Generator:
    """The generator of step ``step`` of sweep point ``point``."""
    ss = np.random.SeedSequence([int(seed), int(point), int(step)])
    s = int(ss.generate_state(1, np.uint64)[0])
    gen = torch.Generator(device=device)
    gen.manual_seed(s & (2**63 - 1))
    return gen


def step_keys(seed: int, point: int, step: int, n: int, device) -> list:
    """The ``n`` Philox keys a step draws, as Python ints."""
    gen = step_generator(seed, point, step, device)
    keys = torch.randint(0, 2**62, (n,), dtype=torch.int64, generator=gen, device=device)
    return [int(k) for k in keys.tolist()]


class FrameSource:
    """The frames of one code and SNR: ``draw(key, lanes)`` gives the LLRs
    (float64 ``[nc, L]``) and codewords (bool ``[nc, L]``) of ``lanes``.
    ``transmitted``: the variables sent, ascending (every one when None)."""

    def __init__(self, G: np.ndarray, snr_db: float, device, transmitted=None):
        self.device = torch.device(device)
        self.kc, self.nc = G.shape
        self.tx = None
        if transmitted is not None and len(transmitted) < self.nc:
            self.tx = torch.as_tensor(np.asarray(transmitted, dtype=np.int64), device=self.device)
        self.nct = self.nc if self.tx is None else int(self.tx.numel())
        self.info_calls = -(-self.kc // 128)
        self.G = torch.as_tensor(G, dtype=torch.float64, device=self.device)
        sigma2 = float(np.float32(10.0 ** (-float(snr_db) / 10.0)))
        self.sigma = float(np.float32(np.sqrt(np.float32(sigma2))))
        self.sigma2 = sigma2

    def info_bits(self, key: int, lanes: torch.Tensor) -> torch.Tensor:
        """float64 ``[L, kc]`` info bits."""
        calls = torch.arange(self.info_calls, dtype=torch.int64, device=self.device)
        w = curand4(key, lanes, calls)  # [4, calls, L]
        words = w.permute(1, 0, 2).reshape(4 * self.info_calls, -1)  # word j = 4q + i
        idx = torch.arange(self.kc, device=self.device)
        bits = (words[idx // 32] >> (idx % 32)[:, None]) & 1  # [kc, L]
        return bits.t().to(torch.float64)

    def normals(self, key: int, lanes: torch.Tensor) -> torch.Tensor:
        """float64 ``[nct, L]``: the normal of the transmitted bit of rank ``t``."""
        groups = -(-self.nct // 4)
        calls = self.info_calls + torch.arange(groups, dtype=torch.int64, device=self.device)
        r = normal4(curand4(key, lanes, calls))  # [4, groups, L]
        return r.permute(1, 0, 2).reshape(4 * groups, -1)[: self.nct]

    def draw(self, key: int, lanes: torch.Tensor, chunk: int = 4096):
        lanes = lanes.to(self.device, torch.int64)
        llrs, cws = [], []
        for l0 in range(0, lanes.numel(), chunk):
            part = lanes[l0:l0 + chunk]
            u = self.info_bits(key, part)
            cw = torch.remainder(u @ self.G, 2.0).t() > 0.5  # [nc, L]
            x = 1.0 - 2.0 * cw.to(torch.float64)
            if self.tx is None:
                llrs.append(2.0 * (x + self.normals(key, part) * self.sigma) / self.sigma2)
            else:
                y = x.index_select(0, self.tx) + self.normals(key, part) * self.sigma
                llrs.append(torch.zeros_like(x).index_copy_(0, self.tx, 2.0 * y / self.sigma2))
            cws.append(cw)
        if not llrs:
            empty = torch.zeros((self.nc, 0), device=self.device)
            return empty.to(torch.float64), empty.bool()
        return torch.cat(llrs, 1), torch.cat(cws, 1)
