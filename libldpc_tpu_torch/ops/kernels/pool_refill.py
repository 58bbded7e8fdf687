"""K8: the streaming pool's refill, its wrapper and its plain version.

Between the chunks of a streaming super-step the pool of fresh frames is
refilled as the JAX super-steps refill it (``streaming_pallas.py``
``_superstep`` and ``_lanes_superstep``): once at least ``watermark``
entries are used (``do_gen = refill and B - sum(avail) >= watermark``),
every used entry takes a fresh channel frame and every entry is marked
unused; otherwise the pool is kept.  JAX draws a whole channel batch under
``lax.cond`` and keeps it on the used entries only; :func:`pool_refill`
draws only those entries, on the card, without a host read
(``csrc/pool_refill.cu``): the same pool in distribution, and no draw in
a chunk where JAX keeps the pool or in a drain.  The same launch computes
the chunk's start budget, ``remaining = clamp(quota - started -
sum(ctr[4]), 0)``.

:func:`pool_refill_plain` is the same step in plain PyTorch: the channel
batch of :func:`..channel.simulate_channel`, merged under the same mask,
drawn only when ``do_gen`` holds (a host branch, free on the CPU).  The
draws of the two differ (curand's Philox in the kernel, the generator's
own streams here), so the card's checks hold the kernel to the plain
formulas on its own codewords and draws (:func:`pool_refill` ``debug``,
:func:`..channel.channel_values`).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from ...utils.params import SHORTEN_LLR
from ..channel import simulate_channel
from ..sorted import TorchSortedCode
from ..streaming import _INT32_SAFE
from . import build
from .decode_fused import _check, _p, _p_or_null, _raise_on, _require_cuda

#: The channel's code in the kernel (``enum PoolChannel``).
CHANNEL_CODES = {"AWGN": 0, "MASK": 1, "BSC": 2, "BEC": 3}
#: Bits a symbol the kernel takes (``kMaxBits``).
MAX_BITS = 8


def pool_watermark(batch: int) -> int:
    """Used entries before a refill: the JAX package's ``3 B / 4``."""
    return max(1, 3 * batch // 4)


@dataclasses.dataclass
class PoolTables:
    """One code's and channel's tables for :func:`pool_refill`, on the
    code's device (sorted VN labels throughout)."""

    code: TorchSortedCode
    channel_type: str  # "AWGN", "BSC" or "BEC"
    #: ``(Constellation, bit_mapper)`` with the mapper in sorted labels, or None
    modulation: Optional[tuple]
    #: int32 ``[nc, kw]``: bit ``i`` of word ``j`` is ``G[32 j + i, v]`` (``kw`` a
    #: multiple of 4, zero words past ``kc``); None without G
    gcols: Optional[torch.Tensor]
    item_src: torch.Tensor  # int32 [n_items, bpi] positions of an item's bits
    item_dst: torch.Tensor  # int32 [n_items, bpi] where each bit's value goes (-1: nowhere)
    other_pos: torch.Tensor  # int32 [n_other] positions no item writes
    other_short: torch.Tensor  # u8 [n_other] shortened (1) or punctured / unnamed (0)
    points: torch.Tensor  # f32 [M] M-ASK amplitudes ([0] without a constellation)
    logp: torch.Tensor  # f32 [M] log priors
    label_of: torch.Tensor  # int32 [M] label of each point
    point_of: torch.Tensor  # int32 [M] point of each label

    @property
    def kw(self) -> int:
        return 0 if self.gcols is None else self.gcols.shape[1]

    @property
    def channel(self) -> int:
        mod = self.channel_type == "AWGN" and self.modulation is not None
        return CHANNEL_CODES["MASK" if mod else self.channel_type]

    @property
    def device(self) -> torch.device:
        return self.item_src.device


def pack_columns(G: np.ndarray) -> np.ndarray:
    """The generator's columns as 32-bit words: ``[nc, kw]`` uint32, bit
    ``i`` of word ``j`` of column ``v`` is ``G[32 j + i, v]``, with ``kw``
    ``ceil(kc / 32)`` rounded up to a multiple of 4 (zero words), so that a
    column is read in 16-byte loads."""
    kc, nc = G.shape
    kw = -(-kc // 128) * 4
    bits = np.zeros((nc, kw * 32), dtype=np.uint8)
    bits[:, :kc] = (G != 0).T
    return np.packbits(bits, axis=1, bitorder="little").view("<u4").reshape(nc, kw)


def pool_tables(sdc: TorchSortedCode, channel_type: str, modulation=None) -> PoolTables:
    """The tables of :func:`pool_refill` for ``sdc`` and the channel:
    an item is a transmitted bit (its one draw: a normal for AWGN, a
    uniform for the BSC and the BEC) or, with a constellation, a symbol (a
    normal) whose bits the mapper names.  The positions no item writes are
    the others: shortened (a known bit) or punctured (an erased one), and
    with a constellation, the positions the mapper does not name."""
    if channel_type not in ("AWGN", "BSC", "BEC"):
        raise ValueError(f"No channel selected: {channel_type!r}")
    dev, nc = sdc.device, sdc.nc
    mod = modulation if channel_type == "AWGN" else None
    short = np.zeros(nc, dtype=bool)
    short[sdc.shorten.cpu().numpy()] = True
    if mod is None:
        src = sdc.bit_pos.cpu().numpy().astype(np.int64)[:, None]
        dst = src.copy()
    else:
        mapper = mod[1].cpu().numpy().astype(np.int64)  # [bits, n_sym]
        if mapper.shape[0] > MAX_BITS:
            raise ValueError(f"{mapper.shape[0]} bits a symbol: the refill takes at most "
                             f"{MAX_BITS}")
        if mapper.size and (mapper.min() < 0 or mapper.max() >= nc):
            raise ValueError("the bit mapper names a position outside the codeword")
        src = mapper.T.copy()  # [n_sym, bits]
        # the mapper's last entry naming a position writes it (the demap's
        # order, bits major), unless the position is shortened
        owner = np.full(nc, -1, dtype=np.int64)
        flat = mapper.reshape(-1)
        owner[flat] = np.arange(flat.size)  # numpy keeps the last of repeated indices
        flat_index = (np.arange(mapper.shape[0])[None, :] * mapper.shape[1]
                      + np.arange(mapper.shape[1])[:, None])  # [n_sym, bits]
        dst = np.where((owner[src] == flat_index) & ~short[src], src, -1)
    written = np.zeros(nc, dtype=bool)
    written[dst[dst >= 0]] = True
    other = np.flatnonzero(~written)
    G = sdc.G.cpu().numpy() if sdc.G is not None else None
    if mod is None:
        pts = logp = np.zeros(0, np.float32)
        label_of = point_of = np.zeros(0, np.int64)
    else:
        cstl = mod[0]
        pts = cstl.points.astype(np.float32)
        logp = np.log(cstl.priors).astype(np.float32)
        label_of, point_of = cstl.labels, cstl.labels_rev

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=dev)

    return PoolTables(
        code=sdc, channel_type=channel_type, modulation=mod,
        gcols=None if G is None else i32(pack_columns(G).view(np.int32)),
        item_src=i32(src), item_dst=i32(dst), other_pos=i32(other),
        other_short=torch.as_tensor(short[other].astype(np.uint8), device=dev),
        points=torch.as_tensor(pts, device=dev), logp=torch.as_tensor(logp, device=dev),
        label_of=i32(label_of), point_of=i32(point_of),
    )


def draw_keys(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """``n`` Philox keys for the kernel, drawn from ``gen`` on the device
    (int64 ``[n]``, no host read)."""
    return torch.randint(0, 2**62, (n,), dtype=torch.int64, generator=gen, device=device)


def _check_pool(pt: PoolTables, refill, avail, fresh_llr, fresh_cw, ctr, started, remaining):
    sdc, B = pt.code, avail.shape[0] if avail.dim() == 1 else -1
    vals = torch.uint8 if pt.channel_type == "BEC" else torch.float32
    for name, t, dtype, shape in (
        ("refill", refill, torch.int32, (1,)), ("avail", avail, torch.int32, (B,)),
        ("fresh_llr", fresh_llr, vals, (sdc.nc, B)), ("fresh_cw", fresh_cw, torch.uint8, (sdc.nc, B)),
        ("ctr", ctr, torch.int32, (5, B)), ("started", started, torch.int64, (1,)),
        ("remaining", remaining, torch.int32, (1,)),
    ):
        _check(t, name, dtype, shape, pt.device)
    return B


def pool_refill_plain(pt: PoolTables, gen: torch.Generator, x_value: float,
                      refill: torch.Tensor, avail: torch.Tensor, fresh_llr: torch.Tensor,
                      fresh_cw: torch.Tensor, ctr: torch.Tensor, started: torch.Tensor,
                      quota: int, remaining: torch.Tensor) -> None:
    """Plain version of :func:`pool_refill`: ``do_gen`` read on the host;
    when it holds, one channel batch from ``gen`` (:func:`simulate_channel`)
    merged into the used entries, and every entry marked unused."""
    B = _check_pool(pt, refill, avail, fresh_llr, fresh_cw, ctr, started, remaining)
    if int(refill[0]) > 0 and B - int(avail.sum()) >= pool_watermark(B):
        ch = simulate_channel(pt.code, pt.channel_type, gen, B, x_value, pt.modulation)
        take = avail == 0
        fresh_llr.copy_(torch.where(take, ch.llr, fresh_llr))
        fresh_cw.copy_(torch.where(take, ch.codeword, fresh_cw))
        avail.fill_(1)
    remaining.copy_(torch.clamp(quota - started - ctr[4].sum(dtype=torch.int64), 0,
                                _INT32_SAFE).to(torch.int32))


def pool_refill(pt: PoolTables, gen: torch.Generator, x_value: float, refill: torch.Tensor,
                avail: torch.Tensor, fresh_llr: torch.Tensor, fresh_cw: torch.Tensor,
                ctr: torch.Tensor, started: torch.Tensor, quota: int, remaining: torch.Tensor,
                key: Optional[torch.Tensor] = None, debug: Optional[torch.Tensor] = None) -> None:
    """Refill the streaming pool before a chunk, in place, and set the
    chunk's start budget ``remaining``.

    ``avail`` (int32 ``[B]``), ``fresh_llr`` (float32 ``[nc, B]``; u8
    symbols for the BEC) and ``fresh_cw`` (u8 ``[nc, B]``) are the pool,
    ``refill`` (int32 ``[1]``) allows it, ``ctr`` the chunk's counters (row
    4: starts so far in this super-step), ``started`` (int64 ``[1]``) the
    frames started before it and ``quota`` the shard's start quota.  On
    CUDA: one planning launch (``sum(avail)``, ``do_gen``, ``remaining``)
    and one draw launch, in which a lane returns at once unless ``do_gen``
    and its entry is used; ``key`` (int64 ``[1]`` on the device; drawn from
    ``gen`` when None) seeds the draw's Philox, and ``debug`` (float32
    ``[n_items, B]``), when given, takes each drawn item's normal or
    uniform.  Counted in ``pool_refill.launches`` (one per refill).  On the
    CPU: :func:`pool_refill_plain`."""
    B = _check_pool(pt, refill, avail, fresh_llr, fresh_cw, ctr, started, remaining)
    if avail.device.type == "cpu":
        return pool_refill_plain(pt, gen, x_value, refill, avail, fresh_llr, fresh_cw, ctr,
                                 started, quota, remaining)
    _require_cuda(avail)
    dev = avail.device
    if key is None:
        key = draw_keys(gen, 1, dev)
    _check(key, "key", torch.int64, key.shape[:1], dev)
    n_items = pt.item_src.shape[0]
    if debug is not None:
        _check(debug, "debug", torch.float32, (n_items, B), dev)
    lib = build.load()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    ctl = torch.empty(1, dtype=torch.int32, device=dev)
    err = lib.ldpc_pool_plan(_p(avail), _p(ctr), _p(started), int(quota), _p(refill),
                             pool_watermark(B), B, _p(ctl), _p(remaining), stream)
    _raise_on(lib, err, "pool_refill (plan)")
    sigma2 = np.float32(10.0 ** (-float(x_value) / 10.0))
    eps = float(np.float32(x_value))
    awgn = pt.channel_type == "AWGN"
    delta = (float(np.float32(np.log((1.0 - x_value) / x_value)))
             if pt.channel_type == "BSC" else 0.0)
    err = lib.ldpc_pool_draw(
        pt.channel, _p_or_null(pt.gcols), pt.kw, _p(pt.item_src), _p(pt.item_dst), n_items,
        pt.item_src.shape[1], _p(pt.other_pos), _p(pt.other_short), pt.other_pos.shape[0],
        _p(pt.points), _p(pt.logp), _p(pt.label_of), _p(pt.point_of), pt.points.shape[0],
        _p(fresh_llr), _p(fresh_cw), _p(avail), _p(ctl), _p(key), _p_or_null(debug), B,
        float(np.sqrt(sigma2)) if awgn else 0.0,
        float(np.float32(1.0) / sigma2) if awgn else 0.0,
        float(np.float32(2.0) * sigma2) if awgn else 0.0,
        delta, eps, delta if pt.channel_type == "BSC" else float(np.float32(SHORTEN_LLR)),
        stream)
    _raise_on(lib, err, "pool_refill (draw)")
    pool_refill.launches += 1


pool_refill.launches = 0
