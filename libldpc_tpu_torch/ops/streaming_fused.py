"""Streaming early-termination sweep on the fused streaming kernels.

The port of :mod:`libldpc_tpu.ops.streaming_pallas` on one device.  Every
batch lane is an independent frame stream that reloads as soon as its frame
converges, so device work per frame tracks ``avg_iter`` rather than the
batch's slowest frame.  The per-lane loop (decode, counting, reload) lives
in :func:`~.kernels.decode_fused.bp_stream_chunk_fused` (flooding), with
``layered=True`` in the fast layered engine's
:func:`~.kernels.decode_layered.bp_stream_chunk_layered_fast`, and for the
BEC in :func:`~.kernels.decode_bec.bec_stream_chunk_fused` (peeling);
between their launches this module refreshes the lane-aligned fresh-frame
pool.

**Message forms.**  Flooding streams store ``lv2c`` in ``dec.message_dtype``
(float32, bfloat16 or the int8 lattice of ``dec.quant_scale``); the
carried LLRs and the pool stay raw float32 LLRs, and a reload stores each
slot's prior in the message form (``bp_stream_chunk_pallas``'s
``fresh_lv2c``), so a drained chunk equals the batch decode of the same
frames in every form.  The layered engine stores its check messages in the
form and keeps the APP plane float32 (lattice units for int8: a start or a
reload takes the prior of the LLRs, as ``bp_stream_chunk_lanes`` does).
The BEC has u8 planes only.

**BEC state.**  The ``llr_in``, ``lv2c`` and ``fresh_llr`` planes hold u8
3-state symbols (channel symbols, messages, the pool's symbols) instead of
f32 LLRs: the pool is never drawn as LLRs.  The BEC has no layered
streaming form (``layered=True`` raises, as in the JAX package).

**Layered state.**  As in the JAX package (``kernel_stream_layered_qc``),
the state tuple keeps its shapes and is read differently: the ``llr_in``
plane carries the persistent APP and the ``lv2c`` plane the CN-space check
messages; a reload sets the APP to the fresh LLRs, the messages to 0 and
``age`` to 1.

**Pool.**  Lane ``i`` reloads only from pool entry ``i``.  Before each
chunk, once at least 3/4 of the entries (the JAX package's watermark)
are consumed, the consumed entries take the frames of a new channel batch;
unused entries keep theirs.  Whether the watermark is met is a device-side
mask, not a host branch, so a super-step never waits for the device: the
channel batch is drawn for every chunk and only merged when the mask is
set.

**Quota.**  ``max_frames`` is exact: before each chunk the device computes
``remaining = quota - started`` and the kernel grants starts against it.

The state is updated in place; the driver reads the counters of a
super-step (:class:`~.streaming.StreamDeltas`) when it absorbs them.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .channel import BEC_ERASURE, simulate_channel
from .kernels.decode_bec import bec_stream_chunk_fused
from .kernels.decode_fused import bp_stream_chunk_fused
from .kernels.decode_layered import bp_stream_chunk_layered_fast
from .kernels.layout import KernelTables
from .messages import TORCH_DTYPES, MessageForm
from .streaming import _INT32_SAFE, StreamDeltas


@dataclasses.dataclass
class StreamState:
    """Per-lane stream state (batch on the last axis)."""

    llr_in: torch.Tensor  # f32 [nc, B] carried channel LLRs (layered: the APP; BEC: u8 symbols)
    codeword: torch.Tensor  # u8 [nc, B] carried true codewords
    lv2c: torch.Tensor  # [nnz, B] messages in the message dtype (CN-space slots; layered: lc2v; BEC: u8)
    done: torch.Tensor  # i32 [B] lane idle (finished or empty)
    iters: torch.Tensor  # i32 [B]
    age: torch.Tensor  # i32 [B] passes since (re)load (0 = warm-up pending)
    avail: torch.Tensor  # i32 [B] pool entry unused
    ctr: torch.Tensor  # i32 [5, B] counters (see bp_stream_chunk_fused)
    fresh_llr: torch.Tensor  # f32 [nc, B] fresh-frame pool (BEC: u8 symbols)
    fresh_cw: torch.Tensor  # u8 [nc, B]
    started: torch.Tensor  # i64 [1] frames started so far


def init_state(tables: KernelTables, batch: int, channel_type: str = "AWGN",
               message_dtype: str = "float32") -> StreamState:
    """Empty streams (every lane idle, pool empty); the value planes are u8
    symbols for the BEC and f32 otherwise, the messages in
    ``message_dtype``.  The messages start neutral (0 in every form; BEC
    erasures), so a lane given a frame without a reload (age 0) runs a
    warm-up pass first."""
    sdc, dev = tables.code, tables.device
    i32 = dict(dtype=torch.int32, device=dev)
    bec = channel_type == "BEC"
    vals = dict(dtype=torch.uint8 if bec else torch.float32, device=dev)
    msgs = dict(dtype=torch.uint8 if bec else TORCH_DTYPES[message_dtype], device=dev)
    return StreamState(
        llr_in=torch.zeros((sdc.nc, batch), **vals),
        codeword=torch.zeros((sdc.nc, batch), dtype=torch.uint8, device=dev),
        lv2c=torch.full((sdc.nnz, batch), BEC_ERASURE if bec else 0, **msgs),
        done=torch.ones(batch, **i32),
        iters=torch.zeros(batch, **i32),
        age=torch.zeros(batch, **i32),
        avail=torch.zeros(batch, **i32),
        ctr=torch.zeros((5, batch), **i32),
        fresh_llr=torch.zeros((sdc.nc, batch), **vals),
        fresh_cw=torch.zeros((sdc.nc, batch), dtype=torch.uint8, device=dev),
        started=torch.zeros(1, dtype=torch.int64, device=dev),
    )


def make_streaming_fused_step(
    tables: KernelTables,
    channel_type: str,
    dec,
    batch: int,
    chunk_iters: int = 0,
    max_frames: int = int(10e9),
    layered: bool = False,
    modulation=None,
):
    """Build ``(init_fn, step_fn)``.  ``step_fn(state, gen, x_value,
    refill) -> (state, StreamDeltas)`` runs one super-step of about one
    decode's worth of passes (``n_outer`` chunks of ``k`` passes), drawing
    channel batches from ``gen``; ``refill=False`` drains.  ``layered``
    decodes on the fast layered engine (a pass is one full layered
    iteration) instead of flooding.  ``channel_type="BEC"`` runs the
    peeling chunk (with ``dec.bec_ref_bug_compat``'s stale byte).  Flooding
    and the layered engine store their messages in ``dec.message_dtype``.
    ``modulation`` (``(Constellation, bit_mapper)``, the mapper in sorted
    labels) draws the pool's AWGN batches through the constellation."""
    bec = channel_type == "BEC"
    if bec and layered:
        raise ValueError("streaming layered decoding has no BEC form")
    message_dtype = "float32" if bec else dec.message_dtype
    iterations = dec.iterations
    if iterations < 1:
        raise ValueError("streaming decode requires iterations >= 1")
    k = chunk_iters or max(4, min(8, iterations // 8))
    n_outer = max(1, -(-iterations // k))
    gen_watermark = max(1, 3 * batch // 4)
    dev = tables.device
    quota = torch.tensor(min(int(max_frames), _INT32_SAFE), dtype=torch.int64, device=dev)
    refill_flag = {
        flag: torch.full((1,), int(flag), dtype=torch.int32, device=dev) for flag in (False, True)
    }
    sdc = tables.code
    if bec:
        stale = 0 if dec.bec_ref_bug_compat else None
        chunk = functools.partial(bec_stream_chunk_fused, degree1_stale_byte=stale)
    else:
        MessageForm(message_dtype, dec.quant_scale).check_cn_mode(dec.cn_mode, "int8 streaming")
        chunk = functools.partial(
            bp_stream_chunk_layered_fast if layered else bp_stream_chunk_fused,
            minsum_mode=dec.cn_mode, message_dtype=message_dtype, quant_scale=dec.quant_scale)

    def init_fn(started_offset: int = 0) -> StreamState:
        """Empty streams; ``started_offset`` frames count as started
        already, so a point resumed after ``started_offset`` counted frames
        starts exactly ``max_frames - started_offset`` more."""
        st = init_state(tables, batch, channel_type, message_dtype)
        st.started.fill_(min(int(started_offset), _INT32_SAFE))
        return st

    def step_fn(st: StreamState, gen: torch.Generator, x_value: float, refill: bool):
        refill_t = refill_flag[bool(refill)]
        st.ctr.zero_()
        for _ in range(n_outer):
            # refresh the consumed pool entries once the watermark is met
            used = batch - st.avail.sum()
            do_gen = (refill_t > 0) & (used >= gen_watermark)
            ch = simulate_channel(sdc, channel_type, gen, batch, x_value, modulation)
            take = do_gen & (st.avail == 0)
            st.fresh_llr.copy_(torch.where(take, ch.llr, st.fresh_llr))
            st.fresh_cw.copy_(torch.where(take, ch.codeword, st.fresh_cw))
            st.avail.copy_(torch.where(do_gen, 1, st.avail))
            remaining = torch.clamp(
                quota - st.started - st.ctr[4].sum(dtype=torch.int64), 0, _INT32_SAFE
            ).to(torch.int32)
            chunk(
                tables, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age,
                st.avail, st.ctr, st.fresh_llr, st.fresh_cw, refill_t, remaining,
                k=k, cap=iterations,
            )
        sums = st.ctr.sum(dim=1, dtype=torch.int64)
        acc = StreamDeltas(
            bit_errors=sums[0],
            frame_errors=sums[1],
            frames=sums[2],
            iter_sum=sums[3],
            n_active=(st.done == 0).sum(),
        )
        st.started += sums[4]
        return st, acc

    return init_fn, step_fn
