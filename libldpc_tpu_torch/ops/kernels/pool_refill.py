"""K8: the channel draw on the card (the streaming pool's refill and a
batch step's channel), its wrappers and its plain versions.

Between the chunks of a streaming super-step the pool of fresh frames is
refilled as the JAX super-steps refill it (``streaming_pallas.py``
``_superstep`` and ``_lanes_superstep``): once at least ``watermark``
entries are used (``do_gen = refill and B - sum(avail) >= watermark``),
every used entry takes a fresh channel frame and every entry is marked
unused; otherwise the pool is kept.  JAX draws a whole channel batch under
``lax.cond`` and keeps it on the used entries only; :func:`pool_refill`
draws only those entries, on the card, without a host read
(``csrc/pool_refill.cu``): :func:`pool_plan` lists the used lanes in order
(and computes the chunk's start budget, ``remaining = clamp(quota -
started - sum(ctr[4]), 0)``), then the draw covers those lanes alone: the
same pool in distribution, and no draw in a chunk where JAX keeps the pool
or in a drain.  :func:`channel_batch` is the same draw over every lane of a
batch, the channel of every batch step on the card
(``parallel/mesh.py``).  :func:`stream_reload` is K8's reload form, the
default sweep's reload at the end of every pass (``ops/streaming.py``): a
plan that decides ``do_gen`` and grants the idle lanes on the device, then
the same draw over the granted lanes, either staged (into a
:class:`ReloadStage`, column by the lane's rank in the plan; K2's next
launch starts the lane from it) or straight into the stream state.

:func:`pool_refill_plain` is the refill in plain PyTorch: the channel
batch of :func:`..channel.simulate_channel`, merged under the same mask,
drawn only when ``do_gen`` holds (a host branch, free on the CPU);
:func:`channel_batch` on the CPU is :func:`..channel.simulate_channel`.
The draws differ (curand's Philox in the kernel, the generator's own
streams here), so the card's checks hold the kernel to the plain formulas
on its own codewords and draws (``debug``, ``debug_info``,
:func:`..channel.channel_values`).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from ...utils.params import SHORTEN_LLR
from ..channel import ChannelOutput, simulate_channel
from ..sorted import TorchSortedCode
from ..streaming import _INT32_SAFE
from . import build
from .decode_fused import (
    SMEM_BLOCK_BYTES, _check, _p, _p_or_null, _raise_on, _require_cuda, check_stage,
)

#: The channel's code in the kernel (``enum PoolChannel``).
CHANNEL_CODES = {"AWGN": 0, "MASK": 1, "BSC": 2, "BEC": 3}
#: Bits a symbol the kernel takes (``kMaxBits``).
MAX_BITS = 8
#: Lanes a draw block takes at most (16, 32 or 64); fewer when a block's
#: shared memory needs it (:func:`pool_tables` fixes the tiling).
LANE_TILE = 64
#: Columns of the codeword a draw block takes at most: items times bits a
#: symbol, or positions no item writes (a multiple of 8).
SLAB_COLS = 288
#: The reload form's tiling (:func:`reload_tables`): a reload draws a burst
#: of a few thousand of the B lanes, too few to fill the card in blocks of
#: the pool's tiling.  In the default sweep of the 1152 code (B = 16384,
#: BPSK 1.0-3.0 dB, 4-ASK 7.25-7.75 dB) the median burst is 1,176-3,163
#: lanes and only a point's first fill passes 6,144; there a point's
#: reloads draw in 0.52-0.61x the pool tiling's time, though the pool's is
#: ahead from ~8 k lanes (``tests_gpu/reload_bursts.py``; ``PERF.md`` §6).
RELOAD_SLAB_COLS, RELOAD_LANE_TILE = 144, 32


def pool_watermark(batch: int) -> int:
    """Used entries before a refill: the JAX package's ``3 B / 4``."""
    return max(1, 3 * batch // 4)


@dataclasses.dataclass
class PoolTables:
    """One code's and channel's tables for the draw, on the code's device
    (sorted VN labels throughout), and the draw's tiling.  Column ``t * bpi
    + k`` of the draw is bit ``k`` of item ``t``; from ``n_items * bpi`` on,
    the columns are the positions no item writes.  The items are cut into
    slabs of ``items_per_slab``, the other positions into slabs of
    ``others_per_slab``; a block draws ``lane_tile`` lanes of one slab."""

    code: TorchSortedCode
    channel_type: str  # "AWGN", "BSC" or "BEC"
    #: ``(Constellation, bit_mapper)`` with the mapper in sorted labels, or None
    modulation: Optional[tuple]
    #: int32 ``[n_tiles, ksteps, 32, 2]`` (:func:`g_tiles`): each slab's
    #: encoded columns as b1 mma B fragments, slab after slab; None without G
    gtiles: Optional[torch.Tensor]
    #: int32 ``[n_slabs + 1]``: slab ``y``'s tiles are ``[slab_tile0[y],
    #: slab_tile0[y + 1])`` of ``gtiles``; None without G
    slab_tile0: Optional[torch.Tensor]
    #: int32 ``[n_cols]``: a column's place among its slab's encoded columns
    #: (>= 0), or ``-1 - k`` for a systematic column (G's column is the unit
    #: vector of row ``k``: its bit is info bit ``k``, no product); None without G
    col_src: Optional[torch.Tensor]
    ksteps: int  # ceil(kc / 256): the encode's k-steps
    kwords: int  # ceil(kc / 32): the info words a lane draws
    kw: int  # info words a lane's Philox outputs start with (ceil(kc / 128) * 4; 0 without G)
    item_src: torch.Tensor  # int32 [n_items, bpi] positions of an item's bits
    item_dst: torch.Tensor  # int32 [n_items, bpi] where each bit's value goes (-1: nowhere)
    other_pos: torch.Tensor  # int32 [n_other] positions no item writes
    other_short: torch.Tensor  # u8 [n_other] shortened (1) or punctured / unnamed (0)
    points: torch.Tensor  # f32 [M] M-ASK amplitudes ([0] without a constellation)
    logp: torch.Tensor  # f32 [M] log priors
    label_of: torch.Tensor  # int32 [M] label of each point
    point_of: torch.Tensor  # int32 [M] point of each label
    lane_tile: int  # lanes a block: 16, 32 or 64
    items_per_slab: int  # a multiple of 8
    others_per_slab: int  # a multiple of 8
    slab_cols: int  # a block's encoded columns at most (a multiple of 8; 0 without G)

    @property
    def channel(self) -> int:
        mod = self.channel_type == "AWGN" and self.modulation is not None
        return CHANNEL_CODES["MASK" if mod else self.channel_type]

    @property
    def device(self) -> torch.device:
        return self.item_src.device

    @property
    def other_col0(self) -> int:
        return self.item_src.numel()


def pack_columns(G: np.ndarray) -> np.ndarray:
    """The generator's columns as 32-bit words, the layout of the scalar
    draw (``csrc/dev/pool_stamps.cu``): ``[nc, kw]`` uint32, bit ``i`` of word
    ``j`` of column ``v`` is ``G[32 j + i, v]``, with ``kw`` ``ceil(kc /
    32)`` rounded up to a multiple of 4 (zero words)."""
    kc, nc = G.shape
    kw = -(-kc // 128) * 4
    bits = np.zeros((nc, kw * 32), dtype=np.uint8)
    bits[:, :kc] = (G != 0).T
    return np.packbits(bits, axis=1, bitorder="little").view("<u4").reshape(nc, kw)


def g_tiles(G: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """The generator's columns ``cols`` (-1: a zero column; a multiple of 8
    of them) as the B operands of ``mma.m16n8k256`` b1: int32 ``[n_tiles,
    ksteps, 32, 2]``, ``ksteps = ceil(kc / 256)``.  Word ``q`` of a column
    holds its rows ``32 q .. 32 q + 31`` (bit ``i``: row ``32 q + i``; rows
    past ``kc`` are 0).  Thread ``l`` of n-tile ``j`` at k-step ``s`` holds,
    for ``g = l // 4`` and ``t = l % 4``, words ``8 s + t`` and ``8 s + t +
    4`` of column ``cols[8 j + g]``: its two fragment registers, one 8-byte
    load, 256 bytes a warp."""
    kc, nc = G.shape
    if len(cols) % 8:
        raise ValueError(f"{len(cols)} columns: a multiple of 8 expected")
    ks = -(-kc // 256)
    bits = np.zeros((nc + 1, ks * 256), dtype=np.uint8)
    bits[:nc, :kc] = (G != 0).T
    words = np.packbits(bits, axis=1, bitorder="little").view("<u4")  # [nc + 1, 8 ks]
    w = words[np.where(np.asarray(cols) < 0, nc, cols)]  # [8 T, 8 ks]
    T = len(cols) // 8
    # column 8 j + g, word 8 s + 4 h + t -> [j, s, (g, t), h]
    return np.ascontiguousarray(
        w.reshape(T, 8, ks, 2, 4).transpose(0, 2, 1, 4, 3).reshape(T, ks, 32, 2)).view(np.int32)


def draw_slabs(G: Optional[np.ndarray], item_src: np.ndarray, other: np.ndarray,
               items_per_slab: int, others_per_slab: int):
    """The encode's share of the draw's slabs: ``(cols, slab_tile0, col_src,
    slab_cols)``.  A slab's columns are its items' bits in order (or its
    positions no item writes); a column whose G column is the unit vector
    of row ``k`` (a systematic column) is info bit ``k`` (``col_src = -1 -
    k``), the others are the slab's encoded columns, in order, padded with
    -1 to a multiple of 8 (``cols``, slab after slab; ``slab_tile0`` the
    tile offsets).  ``slab_cols``: the most encoded columns of a slab."""
    n_items, bpi = item_src.shape
    pos = np.concatenate([item_src.reshape(-1), other]).astype(np.int64)
    bounds = ([(i0 * bpi, min(n_items, i0 + items_per_slab) * bpi)
               for i0 in range(0, n_items, items_per_slab)]
              + [(n_items * bpi + o0, n_items * bpi + min(len(other), o0 + others_per_slab))
                 for o0 in range(0, len(other), others_per_slab)])
    if G is None:
        return None, None, None, 0
    gb = G != 0
    weight = gb.sum(0)
    sys_row = np.where(weight == 1, gb.argmax(0), -1)[pos]  # per column
    col_src = np.empty(len(pos), dtype=np.int64)
    cols, tile0 = [], [0]
    for c0, c1 in bounds:
        enc = np.flatnonzero(sys_row[c0:c1] < 0) + c0
        col_src[c0:c1] = -1 - sys_row[c0:c1]
        col_src[enc] = np.arange(len(enc))
        padded = np.full(-(-len(enc) // 8) * 8, -1, dtype=np.int64)
        padded[:len(enc)] = pos[enc]
        cols.append(padded)
        tile0.append(tile0[-1] + len(padded) // 8)
    slab_cols = max(8, max(len(c) for c in cols)) if cols else 8
    return np.concatenate(cols), np.asarray(tile0), col_src, slab_cols


def pool_tables(sdc: TorchSortedCode, channel_type: str, modulation=None,
                slab_cols: int = SLAB_COLS, lane_tile: int = LANE_TILE) -> PoolTables:
    """The draw's tables for ``sdc`` and the channel: an item is a
    transmitted bit (its one draw: a normal for AWGN, a uniform for the BSC
    and the BEC) or, with a constellation, a symbol (a normal) whose bits
    the mapper names.  The positions no item writes are the others:
    shortened (a known bit) or punctured (an erased one), and with a
    constellation, the positions the mapper does not name.  The generator
    goes to the device once, as :func:`g_tiles` in the draw's column order.
    A block draws at most ``lane_tile`` lanes of a slab of at most
    ``slab_cols`` columns, both shrunk until its shared memory fits."""
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
            raise ValueError(f"{mapper.shape[0]} bits a symbol: the draw takes at most "
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
    kc = 0 if G is None else G.shape[0]
    ksteps = -(-kc // 256)
    # the tiling: slabs of at most slab_cols columns (whole groups of 8
    # items) and lane_tile lanes a block, the slab halved (to 64 columns)
    # and then the lanes (to 16) while a block's shared memory does not fit
    target = slab_cols
    while True:
        ips = max(8, target // src.shape[1] // 8 * 8)
        ops = max(8, target // 8 * 8)
        cols, tile0, col_src, slab_cols = draw_slabs(G, src, other, ips, ops)
        if _draw_bytes(ksteps, G is not None, lane_tile, slab_cols) <= SMEM_BLOCK_BYTES:
            break
        if target > 64:
            target //= 2
        elif lane_tile > 16:
            lane_tile //= 2
        else:
            raise ValueError(f"kc {kc}: 16 lanes' info words pass a block's shared memory")

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=dev)

    return PoolTables(
        code=sdc, channel_type=channel_type, modulation=mod,
        gtiles=None if G is None else torch.as_tensor(g_tiles(G, cols), device=dev),
        slab_tile0=None if G is None else i32(tile0),
        col_src=None if G is None else i32(col_src),
        ksteps=ksteps, kwords=-(-kc // 32), kw=-(-kc // 128) * 4,
        item_src=i32(src), item_dst=i32(dst), other_pos=i32(other),
        other_short=torch.as_tensor(short[other].astype(np.uint8), device=dev),
        points=torch.as_tensor(pts, device=dev), logp=torch.as_tensor(logp, device=dev),
        label_of=i32(label_of), point_of=i32(point_of),
        lane_tile=lane_tile, items_per_slab=ips, others_per_slab=ops,
        slab_cols=slab_cols if G is not None else 0,
    )


def _draw_bytes(ksteps: int, has_g: bool, lane_tile: int, slab_cols: int) -> int:
    """Shared memory of a draw block (``ldpc_pool_draw_bytes``): the lanes'
    info words (``8 ksteps`` rows of ``lane_tile + 8`` words), the slab's
    generator tiles (256 bytes a tile and k-step) and its encoded bits."""
    if not has_g:
        return 0
    return 8 * ksteps * (lane_tile + 8) * 4 + slab_cols // 8 * ksteps * 256 + slab_cols * lane_tile


def reload_tables(pt: PoolTables) -> PoolTables:
    """``pt``'s code and channel in the reload form's tiling
    (:data:`RELOAD_SLAB_COLS` columns x :data:`RELOAD_LANE_TILE` lanes a
    block): the same draws, lane for lane."""
    return pool_tables(pt.code, pt.channel_type, pt.modulation, RELOAD_SLAB_COLS,
                       RELOAD_LANE_TILE)


def draw_bytes(pt: PoolTables) -> int:
    """Shared memory of one of ``pt``'s draw blocks."""
    return _draw_bytes(pt.ksteps, pt.gtiles is not None, pt.lane_tile, pt.slab_cols)


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


def pool_plan_plain(refill: torch.Tensor, avail: torch.Tensor, ctr: torch.Tensor,
                    started: torch.Tensor, quota: int, remaining: torch.Tensor):
    """Plain version of :func:`pool_plan`."""
    B = avail.shape[0]
    do_gen = int(refill[0]) > 0 and B - int(avail.sum()) >= pool_watermark(B)
    used = torch.nonzero(avail == 0).flatten().to(torch.int32) if do_gen else avail[:0]
    lanes = torch.zeros(B, dtype=torch.int32, device=avail.device)
    lanes[:used.shape[0]] = used
    ctl = torch.tensor([int(do_gen), used.shape[0]], dtype=torch.int32, device=avail.device)
    remaining.copy_(torch.clamp(quota - started - ctr[4].sum(dtype=torch.int64), 0,
                                _INT32_SAFE).to(torch.int32))
    return ctl, lanes


def pool_plan(refill: torch.Tensor, avail: torch.Tensor, ctr: torch.Tensor,
              started: torch.Tensor, quota: int, remaining: torch.Tensor):
    """The refill's plan, on the device: ``(ctl, lanes)``, int32 ``ctl =
    [do_gen, count]`` (``count`` the used lanes when ``do_gen``, else 0)
    and ``lanes`` ``[B]``, whose first ``count`` entries are the used lanes
    (``avail == 0``) in lane order (listed only when ``do_gen``: a chunk
    that keeps its pool skips the scan); and ``remaining = clamp(quota - started
    - sum(ctr[4]), 0)``, in place.  On CUDA one block's lane-order scan
    (``csrc/pool_refill.cu`` ``pool_plan_kernel``), counted in
    ``pool_plan.launches``; on the CPU :func:`pool_plan_plain`."""
    B = avail.shape[0]
    for name, t, dtype, shape in (("refill", refill, torch.int32, (1,)),
                                  ("avail", avail, torch.int32, (B,)),
                                  ("ctr", ctr, torch.int32, (5, B)),
                                  ("started", started, torch.int64, (1,)),
                                  ("remaining", remaining, torch.int32, (1,))):
        _check(t, name, dtype, shape, avail.device)
    if avail.device.type == "cpu":
        return pool_plan_plain(refill, avail, ctr, started, quota, remaining)
    _require_cuda(avail)
    dev = avail.device
    lib = build.load()
    ctl = torch.empty(2, dtype=torch.int32, device=dev)
    lanes = torch.empty(B, dtype=torch.int32, device=dev)
    err = lib.ldpc_pool_plan(_p(avail), _p(ctr), _p(started), int(quota), _p(refill),
                             pool_watermark(B), B, _p(ctl), _p(remaining), _p(lanes),
                             ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(lib, err, "pool_plan")
    pool_plan.launches += 1
    return ctl, lanes


pool_plan.launches = 0


def _draw_args(pt: PoolTables, x_value: float, fresh: torch.Tensor, B: int, key: torch.Tensor,
               debug=None, debug_info=None):
    """The draw's arguments before the state pointers (the tables and the
    tiling) and after them (``B`` and the channel's constants)."""
    dev = fresh.device
    _check(key, "key", torch.int64, key.shape[:1], dev)
    n_items, bpi = pt.item_src.shape
    if debug is not None:
        _check(debug, "debug", torch.float32, (n_items, B), dev)
    if debug_info is not None:
        _check(debug_info, "debug_info", torch.int32, (pt.kwords, B), dev)
    sigma2 = np.float32(10.0 ** (-float(x_value) / 10.0))
    awgn = pt.channel_type == "AWGN"
    bsc = pt.channel_type == "BSC"
    delta = float(np.float32(np.log((1.0 - x_value) / x_value))) if bsc else 0.0
    head = (
        pt.channel, _p_or_null(pt.gtiles), _p_or_null(pt.slab_tile0), _p_or_null(pt.col_src),
        pt.ksteps, pt.kwords, pt.kw, _p(pt.item_src), _p(pt.item_dst),
        n_items, bpi, _p(pt.other_pos), _p(pt.other_short), pt.other_pos.shape[0],
        pt.other_col0, _p(pt.points), _p(pt.logp), _p(pt.label_of), _p(pt.point_of),
        pt.points.shape[0], pt.lane_tile, pt.items_per_slab, pt.others_per_slab, pt.slab_cols)
    tail = (
        B, float(np.sqrt(sigma2)) if awgn else 0.0,
        float(np.float32(1.0) / sigma2) if awgn else 0.0,
        float(np.float32(2.0) * sigma2) if awgn else 0.0,
        delta, float(np.float32(x_value)), delta if bsc else float(np.float32(SHORTEN_LLR)))
    return head, tail


def _draw(pt: PoolTables, x_value: float, fresh: torch.Tensor, fresh_cw: torch.Tensor, B: int,
          key: torch.Tensor, avail=None, lanes=None, count=None, debug=None,
          debug_info=None) -> None:
    """One launch of the draw kernel over ``lanes[:count]`` (every lane of
    the batch when None)."""
    head, tail = _draw_args(pt, x_value, fresh, B, key, debug, debug_info)
    lib = build.load()
    err = lib.ldpc_pool_draw(
        *head, _p(fresh), _p(fresh_cw), _p_or_null(avail), _p_or_null(lanes), _p_or_null(count),
        _p(key), _p_or_null(debug), _p_or_null(debug_info), *tail,
        ctypes.c_void_p(torch.cuda.current_stream(fresh.device).cuda_stream))
    _raise_on(lib, err, "the channel draw")


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
                key: Optional[torch.Tensor] = None, debug: Optional[torch.Tensor] = None,
                debug_info: Optional[torch.Tensor] = None) -> None:
    """Refill the streaming pool before a chunk, in place, and set the
    chunk's start budget ``remaining``.

    ``avail`` (int32 ``[B]``), ``fresh_llr`` (float32 ``[nc, B]``; u8
    symbols for the BEC) and ``fresh_cw`` (u8 ``[nc, B]``) are the pool,
    ``refill`` (int32 ``[1]``) allows it, ``ctr`` the chunk's counters (row
    4: starts so far in this super-step), ``started`` (int64 ``[1]``) the
    frames started before it and ``quota`` the shard's start quota.  On
    CUDA: :func:`pool_plan` (``do_gen``, the used lanes in order,
    ``remaining``), then one draw launch over the listed lanes (none unless
    ``do_gen``); ``key`` (int64 ``[1]`` on the device; drawn from ``gen``
    when None) seeds the draw's Philox, ``debug`` (float32 ``[n_items,
    B]``) takes each drawn item's normal or uniform and ``debug_info``
    (int32 ``[kwords, B]``) each drawn lane's info words.  Counted in
    ``pool_refill.launches`` (one per refill).  On the CPU:
    :func:`pool_refill_plain`."""
    B = _check_pool(pt, refill, avail, fresh_llr, fresh_cw, ctr, started, remaining)
    if avail.device.type == "cpu":
        return pool_refill_plain(pt, gen, x_value, refill, avail, fresh_llr, fresh_cw, ctr,
                                 started, quota, remaining)
    _require_cuda(avail)
    if key is None:
        key = draw_keys(gen, 1, avail.device)
    ctl, lanes = pool_plan(refill, avail, ctr, started, quota, remaining)
    _draw(pt, x_value, fresh_llr, fresh_cw, B, key, avail=avail, lanes=lanes, count=ctl[1:],
          debug=debug, debug_info=debug_info)
    pool_refill.launches += 1


pool_refill.launches = 0


def channel_batch(pt: PoolTables, gen: torch.Generator, batch: int, x_value: float,
                  key: Optional[torch.Tensor] = None, debug: Optional[torch.Tensor] = None,
                  debug_info: Optional[torch.Tensor] = None) -> ChannelOutput:
    """One channel batch of ``batch`` frames: the decoder input (float32
    ``[nc, batch]`` LLRs, u8 symbols for the BEC) and the codewords (u8
    ``[nc, batch]``), as :func:`..channel.simulate_channel` returns them.
    On CUDA one launch of K8's draw with every lane taken (no plan; ``key``,
    ``debug`` and ``debug_info`` as :func:`pool_refill` takes them), counted
    in ``channel_batch.launches``; on the CPU :func:`simulate_channel` from
    ``gen``."""
    dev = pt.device
    if dev.type == "cpu":
        return simulate_channel(pt.code, pt.channel_type, gen, batch, x_value, pt.modulation)
    _require_cuda(pt.item_src)
    if key is None:
        key = draw_keys(gen, 1, dev)
    nc = pt.code.nc
    llr = torch.empty((nc, batch), dtype=torch.uint8 if pt.channel_type == "BEC" else torch.float32,
                      device=dev)
    cw = torch.empty((nc, batch), dtype=torch.uint8, device=dev)
    _draw(pt, x_value, llr, cw, batch, key, debug=debug, debug_info=debug_info)
    channel_batch.launches += 1
    return ChannelOutput(llr=llr, codeword=cw)


channel_batch.launches = 0


# ------------------------------------------------------------- reload form


@dataclasses.dataclass
class ReloadStage:
    """The staged reload's buffer: a granted lane's frame waits in column
    ``r`` of ``llr`` and ``cw`` (``r`` its rank in the plan's list of
    granted lanes, ``slot[lane] = r``) until the lane's next K2 launch
    copies it into the planes and sets ``slot`` back to -1.  ``S = B``
    columns, so any plan fits."""

    slot: torch.Tensor  # int32 [B]: the lane's column, or -1
    llr: torch.Tensor  # f32 [nc, B] staged LLRs (sorted VN labelling)
    cw: torch.Tensor  # u8 [nc, B] staged codewords

    @classmethod
    def empty(cls, nc: int, batch: int, device) -> "ReloadStage":
        return cls(slot=torch.full((batch,), -1, dtype=torch.int32, device=device),
                   llr=torch.zeros((nc, batch), dtype=torch.float32, device=device),
                   cw=torch.zeros((nc, batch), dtype=torch.uint8, device=device))


def _check_reload(pt: PoolTables, refill, done, llr, cw, lv2c, age, iters, started,
                  stage=None) -> int:
    sdc, B = pt.code, done.shape[0] if done.dim() == 1 else -1
    if pt.channel_type == "BEC":
        raise ValueError("the reload form draws float LLRs: not the BEC")
    for name, t, dtype, shape in (
        ("refill", refill, torch.int32, (1,)), ("done", done, torch.int32, (B,)),
        ("llr", llr, torch.float32, (sdc.nc, B)), ("cw", cw, torch.uint8, (sdc.nc, B)),
        ("lv2c", lv2c, torch.float32, (sdc.nnz, B)), ("age", age, torch.int32, (B,)),
        ("iters", iters, torch.int32, (B,)), ("started", started, torch.int32, (1,)),
    ):
        _check(t, name, dtype, shape, pt.device)
    if stage is not None:
        check_stage(stage, sdc.nc, B, pt.device)
    return B


def stream_reload_plain(pt: PoolTables, draw, refill: torch.Tensor, done: torch.Tensor,
                        llr: torch.Tensor, cw: torch.Tensor, lv2c: torch.Tensor,
                        age: torch.Tensor, iters: torch.Tensor, started: torch.Tensor,
                        quota: int, gen_threshold: int,
                        stage: Optional[ReloadStage] = None) -> None:
    """Plain version of :func:`stream_reload` (on any device): ``do_gen``
    read on the host; when it holds, ``draw()`` gives a channel batch
    (:class:`~..channel.ChannelOutput` of ``B`` frames) and the granted
    lanes take theirs, as ``_superstep_body`` merges its fresh batch, or,
    with ``stage``, the granted lane of rank ``r`` puts its frame in column
    ``r`` of the staging buffer (``slot[lane] = r``).  On the card's checks
    ``draw`` is K8's full batch on the reload's key (:func:`channel_batch`),
    whose lane ``b`` is the reload's lane ``b``."""
    _check_reload(pt, refill, done, llr, cw, lv2c, age, iters, started, stage)
    idle = done != 0
    if not (int(refill[0]) > 0 and int(idle.sum()) >= gen_threshold):
        return
    ch = draw()
    rs = idle & (int(started[0]) + torch.cumsum(idle.to(torch.int64), 0) <= quota)
    if stage is None:
        llr.copy_(torch.where(rs, ch.llr, llr))
        cw.copy_(torch.where(rs, ch.codeword, cw))
        lv2c.copy_(torch.where(rs, ch.llr.index_select(0, pt.code.col_sorted), lv2c))
    else:
        lanes = torch.nonzero(rs).flatten()
        n = lanes.numel()
        stage.llr[:, :n] = ch.llr.index_select(1, lanes)
        stage.cw[:, :n] = ch.codeword.index_select(1, lanes)
        stage.slot[lanes] = torch.arange(n, dtype=torch.int32, device=done.device)
    done.copy_(torch.where(rs, 0, done))
    age.copy_(torch.where(rs, 1, age))
    iters.copy_(torch.where(rs, 0, iters))
    started += rs.sum().to(torch.int32)


def reload_plan(refill: torch.Tensor, done: torch.Tensor, started: torch.Tensor, quota: int,
                gen_threshold: int):
    """The reload form's plan on the card: ``(count, lanes)``, int32 ``[1]``
    and ``[B]``, ``lanes[:count]`` the granted lanes in lane order (the
    first ``min(idle, quota - started)`` idle lanes when ``refill`` and at
    least ``gen_threshold`` lanes are idle, else none), and ``started``
    raised by ``count``, in place (``csrc/pool_refill.cu``
    ``reload_plan_kernel``, one block's lane-order scan)."""
    B = done.shape[0]
    dev = done.device
    lib = build.load()
    count = torch.empty(1, dtype=torch.int32, device=dev)
    lanes = torch.empty(B, dtype=torch.int32, device=dev)
    err = lib.ldpc_reload_plan(_p(done), _p(refill), _p(started), int(quota), int(gen_threshold),
                               B, _p(count), _p(lanes),
                               ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(lib, err, "reload_plan")
    return count, lanes


def stream_reload(pt: PoolTables, gen: Optional[torch.Generator], x_value: float,
                  refill: torch.Tensor, done: torch.Tensor, llr: torch.Tensor, cw: torch.Tensor,
                  lv2c: torch.Tensor, age: torch.Tensor, iters: torch.Tensor,
                  started: torch.Tensor, quota: int, gen_threshold: int, vn_ptr=None,
                  perm_c2v=None, key: Optional[torch.Tensor] = None,
                  debug: Optional[torch.Tensor] = None,
                  debug_info: Optional[torch.Tensor] = None,
                  stage: Optional[ReloadStage] = None) -> None:
    """The XLA streaming super-step's reload at the end of a pass
    (``libldpc_tpu/ops/streaming.py:176-209``), in place: when ``refill``
    (int32 ``[1]``) holds and at least ``gen_threshold`` lanes are idle
    (``done != 0``), the idle lanes, in lane order and at most ``quota -
    started`` of them, take fresh channel frames: the LLRs into ``llr``
    (float32 ``[nc, B]``), the codeword into ``cw``, each edge's first
    message, its variable's LLR, into ``lv2c`` (float32 ``[nnz, B]``,
    CN-space slots), ``done = 0``, ``age = 1``, ``iters = 0``, and
    ``started`` (int32 ``[1]``) counts them.  Float channels only (AWGN,
    with or without a constellation, and the BSC).

    With ``stage`` the staged form: the granted lane of rank ``r`` in lane
    order puts its LLRs and codeword in column ``r`` of the staging buffer
    and ``slot[lane] = r``; ``llr``, ``cw`` and ``lv2c`` are left alone
    until the lane's next K2 launch (:func:`.decode_fused.bp_stream_chunk_fused`
    with the same ``stage``) starts it.  ``done``, ``age``, ``iters`` and
    ``started`` are set as above either way.

    On CUDA, K8's reload form: :func:`reload_plan` on the device, then one
    draw launch over the granted lanes alone, keyed and computed as
    :func:`pool_refill`'s draw (``key``: int64 ``[1]``, drawn from ``gen``
    when None; ``vn_ptr``/``perm_c2v`` the kernel tables' VN-space slot
    lists, needed by the form into the state; ``debug``/``debug_info`` as
    there), with no host read; counted in ``stream_reload.launches`` (into
    the state) or ``stream_reload.staged_launches`` (staged), one per
    reload.  On the CPU :func:`stream_reload_plain`, drawing a channel batch
    from ``gen`` (:func:`simulate_channel`)."""
    B = _check_reload(pt, refill, done, llr, cw, lv2c, age, iters, started, stage)
    if done.device.type == "cpu":
        return stream_reload_plain(
            pt, lambda: simulate_channel(pt.code, pt.channel_type, gen, B, x_value, pt.modulation),
            refill, done, llr, cw, lv2c, age, iters, started, quota, gen_threshold, stage)
    _require_cuda(done)
    if stage is None and (vn_ptr is None or perm_c2v is None):
        raise ValueError("the reload form needs the kernel tables' vn_ptr and perm_c2v")
    if key is None:
        key = draw_keys(gen, 1, done.device)
    count, lanes = reload_plan(refill, done, started, quota, gen_threshold)
    head, tail = _draw_args(pt, x_value, llr, B, key, debug, debug_info)
    lib = build.load()
    stream = ctypes.c_void_p(torch.cuda.current_stream(done.device).cuda_stream)
    if stage is None:
        err = lib.ldpc_pool_reload(
            *head, _p(llr), _p(cw), _p(lanes), _p(count), _p(key), _p_or_null(debug),
            _p_or_null(debug_info), *tail, _p(lv2c), _p(vn_ptr), _p(perm_c2v), _p(done), _p(age),
            _p(iters), stream)
    else:
        err = lib.ldpc_pool_reload_staged(
            *head, _p(stage.llr), _p(stage.cw), B, _p(lanes), _p(count), _p(key),
            _p_or_null(debug), _p_or_null(debug_info), *tail, _p(stage.slot), _p(done), _p(age),
            _p(iters), stream)
    _raise_on(lib, err, "stream_reload")
    if stage is None:
        stream_reload.launches += 1
    else:
        stream_reload.staged_launches += 1


stream_reload.launches = 0
stream_reload.staged_launches = 0
