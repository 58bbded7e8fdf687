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
are consumed, the consumed entries take fresh channel frames; unused
entries keep theirs.  :func:`~.kernels.pool_refill.pool_refill` (K8) does
it: on the card the device decides and draws only the consumed entries, so
a super-step never waits for the device and nothing is drawn in a chunk
where the JAX super-step keeps its pool (``lax.cond``) or in a drain; on
the CPU its plain version draws a channel batch in exactly those chunks.

**Quota.**  ``max_frames`` is exact: before each chunk the device computes
``remaining = quota - started`` and the kernel grants starts against it.
The plain chunks grant in lane order, pass by pass, as the JAX kernels do.
A kernel's tickets (``atomicSub``) grant every wanting lane wherever the
quota does not bind, and the same lanes then; in a chunk where it may bind
(:class:`QuotaWatch`: fewer than ``B`` starts may be left) the chunk runs
``ordered``, as one-pass launches with the grants in lane order, so a
quota-ended point repeats frame for frame on the card too.

The state is updated in place; the driver reads the counters of a
super-step (:class:`~.streaming.StreamDeltas`) when it absorbs them.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..utils.profiling import count, span
from .channel import BEC_ERASURE
from .kernels.decode_bec import bec_stream_chunk_fused, bec_stream_chunk_fused_plain
from .kernels.decode_fused import bp_stream_chunk_fused, bp_stream_chunk_fused_plain
from .kernels.decode_layered import (
    bp_stream_chunk_layered_fast, bp_stream_chunk_layered_fast_plain,
)
from .kernels.layout import KernelTables
from .kernels.pool_refill import draw_keys, pool_refill, pool_tables
from .messages import TORCH_DTYPES, MessageForm
from .streaming import _INT32_SAFE, StreamDeltas, split_exact_multi


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
    #: on CUDA, the host's bound on ``started`` that picks the ordered chunks
    watch: Optional["QuotaWatch"] = None


class QuotaWatch:
    """Whether a CUDA shard's start quota may bind in its next chunk, known
    on the host without a host read.

    Every super-step ends with a copy of ``started`` into pinned host
    memory behind an event; a copy whose event has completed is read, and
    the chunks since then are counted at ``B`` starts each (a chunk starts
    each pool entry at most once).  The quota can bind only where fewer
    than ``B`` starts are left: :meth:`may_bind` says so until a read shows
    none left."""

    def __init__(self, quota: int, batch: int, started: int):
        self.quota, self.batch = int(quota), int(batch)
        self.seen, self.seen_at = int(started), 0  # started frames, as of chunk ``seen_at``
        self.chunks = 0  # chunks dispatched
        self._pending = collections.deque()  # (pinned copy, its event, chunks at the copy)
        self._free = []

    def may_bind(self) -> bool:
        while self._pending and self._pending[0][1].query():
            buf, _, at = self._pending.popleft()
            self.seen, self.seen_at = int(buf[0]), at
            self._free.append(buf)
        left = self.quota - self.seen
        return left > 0 and left - (self.chunks - self.seen_at) * self.batch < self.batch

    def observe(self, started: torch.Tensor) -> None:
        with torch.cuda.device(started.device):
            buf = self._free.pop() if self._free else torch.empty(1, dtype=torch.int64,
                                                                  pin_memory=True)
            buf.copy_(started, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        self._pending.append((buf, event, self.chunks))


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
    mesh=None,
    plain: bool = False,
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
    labels) draws the pool's AWGN batches through the constellation.

    With a ``mesh`` (every entry a frame shard of ``batch`` lanes) the
    state is a list of per-shard states, ``step_fn(states, gens, x_value,
    refill)`` takes one generator per local shard and the deltas are summed
    over the shards; ``init_fn(started_offset)`` splits the offset exactly
    over the shards (:func:`~.streaming.split_exact`), each shard's quota
    its share of ``max_frames``.  ``plain`` runs the chunks' plain
    versions (the card's checks hold the kernels against them)."""
    if mesh is None:
        make_shard = _shard_stepper(tables, channel_type, dec, batch, chunk_iters, layered,
                                    modulation, plain)
        return make_shard(tables, min(int(max_frames), _INT32_SAFE), modulation)
    from ..parallel.mesh import FRAME_AXIS, Mesh

    flat = Mesh(mesh.devices.reshape(-1), (FRAME_AXIS,), mesh.processes.reshape(-1))
    init_multi, step_multi = make_streaming_fused_multipoint_step(
        tables, channel_type, dec, batch, flat, chunk_iters, max_frames, layered, modulation,
        plain)

    def init_fn(started_offset: int = 0):
        return init_multi([started_offset])

    def step_fn(states, gens, x_value: float, refill: bool):
        states, acc = step_multi(states, gens, [x_value], [refill])
        return states, StreamDeltas(*(v[0] for v in acc))

    return init_fn, step_fn


def make_streaming_fused_multipoint_step(
    tables: KernelTables,
    channel_type: str,
    dec,
    batch: int,
    mesh,
    chunk_iters: int = 0,
    max_frames: int = int(10e9),
    layered: bool = False,
    modulation=None,
    plain: bool = False,
):
    """The streaming step over a ``(points, frames)`` mesh (a mesh without
    a points axis is one point): the counterpart of the JAX package's
    ``make_streaming_pallas_multipoint_step`` and
    ``make_streaming_lanes_multipoint_step``.  One :class:`StreamState` of
    ``batch`` lanes per local shard; the shard on frame index ``f`` of
    ``n`` starts at most ``max_frames // n + (f < max_frames % n)`` frames
    of its point.  ``init_fn(started_offset)`` takes one offset per point,
    split exactly over its frame shards
    (:func:`~.streaming.split_exact_multi`).  ``step_fn(states, gens,
    x_values, refill)`` takes one generator per local shard and one x-value
    and refill flag per point (a point that is not refilled drains) and
    returns :class:`~.streaming.StreamDeltas` with a leading points axis,
    each summed over the point's frame shards, on the first local device."""
    from ..parallel.mesh import Replicas, on_device

    n_points, n_f = mesh.n_points, mesh.n_frame_shards
    shards = mesh.local_shards()
    if not shards:
        raise ValueError(f"{mesh} has no entry of this process")
    replicas = Replicas(tables, modulation)
    make_shard = _shard_stepper(tables, channel_type, dec, batch, chunk_iters, layered,
                                modulation, plain)
    base, rem = divmod(min(int(max_frames), n_f * _INT32_SAFE), n_f)
    steppers = [make_shard(replicas.tables(s.device),
                           min(base + int(s.frame < rem), _INT32_SAFE),
                           replicas.modulation(s.device)) for s in shards]
    dev = shards[0].device

    def init_fn(started_offset=None) -> list:
        offsets = (np.zeros(n_points * n_f, np.int64) if started_offset is None
                   else split_exact_multi(started_offset, n_f))
        states = []
        for s, (init, _) in zip(shards, steppers):
            with on_device(s.device):
                states.append(init(int(offsets[s.index])))
        return states

    def per_shard(states: list, gens, x_values, refill) -> list:
        """Each local shard's deltas, on its device, in shard order."""
        if len(x_values) != n_points or len(refill) != n_points:
            raise ValueError(f"{len(x_values)} x-values and {len(refill)} refill flags, "
                             f"mesh expects {n_points}")
        out = []
        for s, (_, step), st, gen in zip(shards, steppers, states, gens):
            with on_device(s.device):
                out.append(step(st, gen, float(x_values[s.point]), bool(refill[s.point]))[1])
        return out

    def step_fn(states: list, gens, x_values, refill):
        sums = torch.zeros((5, n_points), dtype=torch.int64, device=dev)
        for s, acc in zip(shards, per_shard(states, gens, x_values, refill)):
            sums[:, s.point] += torch.stack(list(acc)).to(dev)
        return states, StreamDeltas(*sums)

    step_fn.per_shard = per_shard
    return init_fn, step_fn


def _shard_stepper(tables: KernelTables, channel_type: str, dec, batch: int, chunk_iters: int,
                   layered: bool, modulation, plain: bool):
    """``make(tables, quota, modulation) -> (init_fn, step_fn)``: the
    one-shard streaming step on ``tables``' device with a start quota."""
    bec = channel_type == "BEC"
    if bec and layered:
        raise ValueError("streaming layered decoding has no BEC form")
    message_dtype = "float32" if bec else dec.message_dtype
    iterations = dec.iterations
    if iterations < 1:
        raise ValueError("streaming decode requires iterations >= 1")
    k = chunk_iters or max(4, min(8, iterations // 8))
    n_outer = max(1, -(-iterations // k))
    if bec:
        stale = 0 if dec.bec_ref_bug_compat else None
        chunk = functools.partial(bec_stream_chunk_fused_plain if plain else bec_stream_chunk_fused,
                                  degree1_stale_byte=stale)
    else:
        MessageForm(message_dtype, dec.quant_scale).check_cn_mode(dec.cn_mode, "int8 streaming")
        if layered:
            kernel = bp_stream_chunk_layered_fast_plain if plain else bp_stream_chunk_layered_fast
        else:
            kernel = bp_stream_chunk_fused_plain if plain else bp_stream_chunk_fused
        chunk = functools.partial(kernel, minsum_mode=dec.cn_mode, message_dtype=message_dtype,
                                  quant_scale=dec.quant_scale)

    def make(tables: KernelTables, quota_frames: int, modulation):
        dev = tables.device
        cuda = dev.type == "cuda"
        pool = pool_tables(tables.code, channel_type, modulation)
        remaining = torch.zeros(1, dtype=torch.int32, device=dev)
        refill_flag = {
            flag: torch.full((1,), int(flag), dtype=torch.int32, device=dev)
            for flag in (False, True)
        }

        def init_fn(started_offset: int = 0) -> StreamState:
            """Empty streams; ``started_offset`` frames count as started
            already, so a point resumed after ``started_offset`` counted
            frames starts exactly ``quota - started_offset`` more."""
            st = init_state(tables, batch, channel_type, message_dtype)
            offset = min(int(started_offset), _INT32_SAFE)
            st.started.fill_(offset)
            if cuda:
                st.watch = QuotaWatch(quota_frames, batch, offset)
            return st

        def step_fn(st: StreamState, gen: torch.Generator, x_value: float, refill: bool):
            refill_t = refill_flag[bool(refill)]
            st.ctr.zero_()
            keys = draw_keys(gen, n_outer, dev) if cuda else None
            if cuda and st.watch is None:  # a state not made by init_fn: one read
                st.watch = QuotaWatch(quota_frames, batch, int(st.started))
            count("stream.lane_passes", n_outer * k * batch)
            for j in range(n_outer):
                # refresh the consumed pool entries once the watermark is met;
                # the chunk's start budget
                with span("ldpc.channel"):
                    pool_refill(pool, gen, x_value, refill_t, st.avail, st.fresh_llr,
                                st.fresh_cw, st.ctr, st.started, quota_frames, remaining,
                                key=keys[j:j + 1] if cuda else None)
                with span("ldpc.decode"):
                    chunk(
                        tables, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age,
                        st.avail, st.ctr, st.fresh_llr, st.fresh_cw, refill_t, remaining,
                        k=k, cap=iterations,
                        ordered=bool(refill) and cuda and st.watch.may_bind(),
                    )
                if cuda:
                    st.watch.chunks += 1
            sums = st.ctr.sum(dim=1, dtype=torch.int64)
            acc = StreamDeltas(
                bit_errors=sums[0],
                frame_errors=sums[1],
                frames=sums[2],
                iter_sum=sums[3],
                n_active=(st.done == 0).sum(),
            )
            st.started += sums[4]
            if cuda:
                st.watch.observe(st.started)
            return st, acc

        return init_fn, step_fn

    return make
