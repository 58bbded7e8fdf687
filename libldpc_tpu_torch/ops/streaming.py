"""Streaming compaction decoder: the JAX package's default streaming sweep
(from :mod:`libldpc_tpu.ops.streaming`), and the counters and exact quota
splits every streaming step shares.

Each of the ``B`` lanes is an independent frame stream.  Every pass
advances every stream by one flooding BP iteration; a stream whose frame
converges (or reaches the cap) is counted, and at the end of the same pass
the idle streams are reloaded with fresh frames, so the work per decoded
frame follows ``avg_iter`` rather than ``iterations``.  A frame decodes as
in the batch decoder: the same CN/VN order, break-before-increment
iteration counts, decisions taken at first convergence.

The reload policy is the JAX super-step's (``_superstep_body``): after a
pass's finished frames are counted, ``do_gen = refill and idle >=
gen_threshold`` (``gen_threshold`` defaults to ``max(1, B // 16)``, so
reloads come in bursts); when it holds, a fresh channel batch is drawn in
that pass and the idle lanes take theirs in lane order, at most ``quota -
started`` of them (``max_frames`` is exact), at ``age = 1`` with the
first messages the prior at each edge.  Injected state may use the zero
init (``age = 0``): a warm-up pass on all-zero messages rebuilds the same
init, with the convergence check gated off.  ``refill=False`` drains.

This is not the policy of the fused streaming step
(:mod:`.streaming_fused`, the ``--pallas`` sweep), whose lane ``i``
reloads from pool entry ``i`` of a pool refilled between chunks.

**Engines.**  On the CPU the super-step is :func:`_superstep_body`, a
line-for-line torch version of the JAX one.  On the card each pass is two
launches, with no host read: K2 (:func:`.kernels.decode_fused.bp_stream_chunk_fused`)
as one pass (start the lanes the last pass staged, decode, count the
finished frames, freeze them), then K8's reload form
(:func:`.kernels.pool_refill.stream_reload`: ``do_gen``, the lane-order
grants and the draw of the granted lanes, on the device), staged in every
pass of a super-step but its last, into the state in the last
(:func:`_card_superstep`).  The messages are float32, as the JAX
super-step's.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.profiling import count, span
from .sorted import (
    TorchSortedCode, cn_update_sorted, syndrome_ok_from_posterior, vn_posterior_sorted,
)

#: Per-device start-quota clamp: keeps a quota and the frames started under
#: it inside int32 with headroom for one chunk's starts.
_INT32_SAFE = 2**31 - 2**20


class StreamDeltas(NamedTuple):
    """Counters for frames *completed* during one super-step (int64
    device scalars: the per-lane int32 counter planes are summed in int64)."""

    bit_errors: torch.Tensor
    frame_errors: torch.Tensor
    frames: torch.Tensor
    iter_sum: torch.Tensor
    n_active: torch.Tensor  # in-flight frames after the step


@dataclasses.dataclass
class StreamState:
    """Per-stream decode state of one shard (batch on the last axis)."""

    llr_in: torch.Tensor  # f32 [nc, B] channel LLRs (sorted VN labelling)
    codeword: torch.Tensor  # u8 [nc, B] true codeword
    lv2c: torch.Tensor  # f32 [nnz, B] messages (CN-space edge slots)
    active: torch.Tensor  # bool [B] stream holds an in-flight frame
    age: torch.Tensor  # i32 [B] passes since reload (0 = warm-up pending)
    iters: torch.Tensor  # i32 [B] reference-semantics iteration count
    started: torch.Tensor  # i32 [1] frames started on this shard so far


def _init_state(sdc: TorchSortedCode, batch: int) -> StreamState:
    dev = sdc.device
    return StreamState(
        llr_in=torch.zeros((sdc.nc, batch), dtype=torch.float32, device=dev),
        codeword=torch.zeros((sdc.nc, batch), dtype=torch.uint8, device=dev),
        lv2c=torch.zeros((sdc.nnz, batch), dtype=torch.float32, device=dev),
        active=torch.zeros(batch, dtype=torch.bool, device=dev),
        age=torch.zeros(batch, dtype=torch.int32, device=dev),
        iters=torch.zeros(batch, dtype=torch.int32, device=dev),
        started=torch.zeros(1, dtype=torch.int32, device=dev),
    )


def _tx_mask(sdc: TorchSortedCode) -> torch.Tensor:
    """bool ``[nc]``: transmitted-bit positions (sorted labelling); bit
    errors count transmitted bits only."""
    mask = torch.zeros(sdc.nc, dtype=torch.bool, device=sdc.device)
    mask[sdc.bit_pos.long()] = True
    return mask


def simulate_channel(sdc, channel_type, gen, batch, x_value, modulation=None, key=None,
                     pool=None):
    """The super-step's channel draw, a module attribute so that a test can
    replace it: a channel batch from ``gen`` (:func:`.channel.simulate_channel`),
    or, given a pass's ``key`` (int64 ``[1]``), K8's full batch on it from
    ``pool``'s tables (:func:`.kernels.pool_refill.channel_batch`), whose
    lane ``b`` is the one K8's reload form draws for lane ``b`` on that key."""
    if key is not None:
        from .kernels.pool_refill import channel_batch

        return channel_batch(pool, None, batch, x_value, key=key)
    from .channel import simulate_channel as draw

    return draw(sdc, channel_type, gen, batch, x_value, modulation)


def _superstep_body(
    sdc: TorchSortedCode,
    channel_type: str,
    iterations: int,
    cn_mode,
    batch: int,
    modulation,
    quota: int,
    fast_rng: bool,
    gen_threshold: int,
    gen: torch.Generator,
    x_value: float,
    refill: bool,
    state: StreamState,
    n_iters: int,
    pool=None,
):
    """``n_iters`` passes of the JAX super-step (plain PyTorch, any
    device): ``(state, StreamDeltas)``, the state a new one.  A pass's
    fresh batch is drawn from ``gen`` only where ``do_gen`` holds; with
    ``pool`` (K8's tables on the card) it is K8's full batch on the pass's
    key, the keys drawn as :func:`_card_superstep` draws them, so that the
    card's launches can be held to this super-step on the same frames."""
    from .kernels.pool_refill import draw_keys

    is_tx = _tx_mask(sdc)[:, None]
    st = state
    dev = st.llr_in.device
    keys = draw_keys(gen, n_iters, dev) if pool is not None else None
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    bit_errors = frame_errors = frames = iter_sum = zero
    for i in range(n_iters):
        # --- one flooding BP iteration over every stream
        lc2v = cn_update_sorted(sdc, st.lv2c, cn_mode)
        lc2v_v = lc2v.index_select(0, sdc.perm_c2v)
        llr_out = vn_posterior_sorted(sdc, st.llr_in, lc2v_v)
        g = llr_out.index_select(0, sdc.col_sorted)  # posterior at the edges
        # --- convergence and iteration accounting; warm-up passes (age 0)
        # only rebuild the standard init: no check, no count
        checking = st.active & (st.age >= 1)
        ok = syndrome_ok_from_posterior(sdc, g)
        newly = checking & ok
        iters = st.iters + (checking & ~ok).to(torch.int32)
        age = st.age + st.active.to(torch.int32)
        finished = st.active & (newly | (age >= iterations + 1))
        # --- count the completed frames
        hard = llr_out <= 0
        biterr = ((hard != (st.codeword > 0)) & is_tx).to(torch.int32).sum(0)
        bit_errors = bit_errors + torch.where(finished, biterr, 0).sum()
        frame_errors = frame_errors + (finished & (biterr > 0)).sum()
        frames = frames + finished.sum()
        iter_sum = iter_sum + torch.where(finished, iters, 0).sum()
        active = st.active & ~finished
        # --- reload the idle streams with fresh frames, in bursts
        idle = ~active
        lv2c = g - lc2v
        llr_in, codeword, started = st.llr_in, st.codeword, st.started
        rs = torch.zeros_like(active)
        if refill and int(idle.sum()) >= gen_threshold:
            ch = simulate_channel(sdc, channel_type, gen, batch, x_value, modulation,
                                  key=None if keys is None else keys[i:i + 1], pool=pool)
            # max_frames: never start more than this shard's quota, in lane order
            rs = idle & (st.started[0] + torch.cumsum(idle.to(torch.int32), 0) <= quota)
            started = st.started + rs.sum().to(torch.int32)
            lv2c = torch.where(rs, ch.llr.index_select(0, sdc.col_sorted), lv2c)
            llr_in = torch.where(rs, ch.llr, llr_in)
            codeword = torch.where(rs, ch.codeword, codeword)
        st = StreamState(
            llr_in=llr_in,
            codeword=codeword,
            lv2c=lv2c,
            active=active | rs,
            age=torch.where(rs, 1, age),
            iters=torch.where(rs, 0, iters),
            started=started,
        )
    acc = StreamDeltas(bit_errors, frame_errors, frames, iter_sum, st.active.sum())
    return st, acc


def _card_superstep(tables, pool, iterations: int, cn_mode, quota: int, gen_threshold: int,
                    scratch: dict, gen, x_value: float, refill: bool, state: StreamState,
                    n_iters: int):
    """The super-step as the card runs it, in place: per pass a one-pass
    K2 launch, then K8's reload form, each pass's draw on its own key.

    A fixed rule of the super-step: every pass's reload but the last one's
    is staged (``scratch["stage"]``, a :class:`.kernels.pool_refill.ReloadStage`:
    the granted lanes' frames drawn into a staging buffer, in whole
    sectors, with no first message), and the next pass's K2 launch starts
    those lanes from it as an in-chunk reload starts (the same first
    messages, bit for bit); the last pass reloads straight into the state,
    so the staging buffer is empty (``slot`` all -1) between super-steps
    and the :class:`StreamState` a super-step returns is the one
    :func:`_superstep_body` gives.

    On the CPU the two wrappers run their plain versions (the reload's draw
    a channel batch from ``gen``): the CPU tests hold that sequence to the
    JAX super-step, the card's checks hold the launches to
    :func:`_superstep_body` on the same keys."""
    from .kernels.decode_fused import bp_stream_chunk_fused
    from .kernels.pool_refill import draw_keys, stream_reload

    st = state
    dev = st.llr_in.device
    done = (~st.active).to(torch.int32)
    ctr = scratch["ctr"]
    ctr.zero_()
    keys = draw_keys(gen, n_iters, dev) if dev.type == "cuda" else None
    refill_t = scratch["refill"][bool(refill)]
    stage = scratch["stage"]
    for i in range(n_iters):
        # start the staged lanes, decode, count and freeze (the lane's pool
        # is its own planes: no pool starts, so never read)
        with span("ldpc.decode"):
            bp_stream_chunk_fused(
                tables, st.llr_in, st.codeword, st.lv2c, done, st.iters, st.age,
                scratch["avail"], ctr, st.llr_in, st.codeword, scratch["refill"][False],
                scratch["remaining"], k=1, cap=iterations, minsum_mode=cn_mode, stage=stage)
        with span("ldpc.channel"):
            stream_reload(pool, gen, x_value, refill_t, done, st.llr_in, st.codeword, st.lv2c,
                          st.age, st.iters, st.started, quota, gen_threshold,
                          vn_ptr=tables.vn_ptr, perm_c2v=tables.perm_c2v,
                          key=None if keys is None else keys[i:i + 1],
                          stage=stage if i < n_iters - 1 else None)
    st.active = done == 0
    sums = ctr.sum(dim=1, dtype=torch.int64)
    return st, StreamDeltas(sums[0], sums[1], sums[2], sums[3], st.active.sum())


def card_scratch(nc: int, batch: int, device) -> dict:
    """The buffers :func:`_card_superstep` keeps between calls for one
    shard of ``batch`` lanes: K2's unused pool flags, counters and start
    budget, the two refill flags, and the staging buffer of the staged
    reload (empty)."""
    from .kernels.pool_refill import ReloadStage

    i32 = dict(dtype=torch.int32, device=device)
    return dict(avail=torch.zeros(batch, **i32), ctr=torch.zeros((5, batch), **i32),
                remaining=torch.zeros(1, **i32),
                refill={f: torch.full((1,), int(f), **i32) for f in (False, True)},
                stage=ReloadStage.empty(nc, batch, device))


def _runs_kernels(device: torch.device) -> bool:
    """Whether a shard on ``device`` runs the card's launches
    (:func:`_card_superstep`) rather than :func:`_superstep_body`: on CUDA.
    Checks replace it: the CPU tests to run the card's sequence through the
    wrappers' plain versions, the card's checks to run
    :func:`_superstep_body` on the card as the reference."""
    return device.type == "cuda"


def _check_streamable(channel_type: str, iterations: int) -> None:
    if channel_type == "BEC":
        raise ValueError("streaming decode does not cover the BEC decoder")
    if iterations < 1:
        raise ValueError("streaming decode requires iterations >= 1")


def _shard_stepper(sdc_or_tables, channel_type: str, dec, batch: int, chunk_iters: int,
                   gen_threshold: Optional[int], fast_rng: bool):
    """``(tables, make)``: the code's kernel tables, and ``make(replicas,
    device, quota) -> (init_fn, step_fn)``, one shard's super-step on
    ``device`` (its tables, pool tables and modulation from ``replicas``)
    with a start quota."""
    from ..parallel.mesh import Replicas
    from .kernels.layout import KernelTables, kernel_tables

    iterations = dec.iterations
    _check_streamable(channel_type, iterations)
    cn_mode = dec.cn_mode
    n_iters = chunk_iters or iterations
    if gen_threshold is None:
        # reload in bursts of ~1/16 of the lanes
        gen_threshold = max(1, batch // 16)
    tables0 = (sdc_or_tables if isinstance(sdc_or_tables, KernelTables)
               else kernel_tables(sdc_or_tables))

    def make(replicas: Replicas, device: torch.device, quota: int):
        tables = replicas.tables(device)
        sdc = tables.code
        kernels = _runs_kernels(device)
        # the card draws with K8 in either super-step
        pool = replicas.pool(device) if kernels or device.type == "cuda" else None
        if kernels:
            from .kernels.pool_refill import reload_tables

            body = functools.partial(_card_superstep, tables, reload_tables(pool), iterations,
                                     cn_mode, quota, gen_threshold,
                                     card_scratch(sdc.nc, batch, device))
        else:
            body = functools.partial(_superstep_body, sdc, channel_type, iterations, cn_mode,
                                     batch, replicas.modulation(device), quota, fast_rng,
                                     gen_threshold, pool=pool)

        def init_fn(started_offset: int = 0) -> StreamState:
            st = _init_state(sdc, batch)
            st.started.fill_(min(int(started_offset), _INT32_SAFE))
            return st

        def step_fn(state: StreamState, gen, x_value: float, refill: bool):
            count("stream.lane_passes", n_iters * batch)
            return body(gen, float(x_value), bool(refill), state, n_iters)

        return init_fn, step_fn

    return tables0, make


def make_streaming_step(
    sdc,
    channel_type: str,
    dec,
    batch_per_device: int,
    mesh=None,
    modulation=None,
    chunk_iters: int = 0,
    max_frames: int = int(10e9),
    fast_rng: bool = False,
    gen_threshold: Optional[int] = None,
):
    """Build ``(init_fn, step_fn)`` for the streaming decoder.

    ``step_fn(state, gen, x_value, refill) -> (state, StreamDeltas)`` runs
    ``chunk_iters`` passes (default ``iterations``), drawing fresh frames
    from ``gen`` (a ``torch.Generator`` on the state's device) and
    reloading idle streams when ``refill`` is truthy.  ``sdc`` is the
    sorted code (or its kernel tables); ``modulation`` ``(Constellation,
    bit_mapper)`` with the mapper in sorted labels on the code's device.

    ``max_frames`` is exact: each shard holds a start quota (its share of
    ``max_frames``, clamped to ``_INT32_SAFE``) and stops reloading once it
    is spent.  With a ``mesh`` (every entry a frame shard of
    ``batch_per_device`` lanes) the state is a list of per-shard states,
    ``step_fn(states, gens, x_value, refill)`` takes one generator per
    local shard (each shard its own key) and the deltas are summed over
    the shards; the shard on frame index ``f`` of ``n`` holds the quota
    ``max_frames // n + (f < max_frames % n)``; ``init_fn(started_offset)``
    splits the offset exactly (:func:`split_exact`).

    ``fast_rng`` is accepted for the JAX signature and changes nothing: the
    port has one Philox.  The engine (module docstring) is the card's
    launches on a CUDA device and :func:`_superstep_body` on the CPU."""
    if mesh is None:
        from ..parallel.mesh import Replicas

        tables, make = _shard_stepper(sdc, channel_type, dec, batch_per_device, chunk_iters,
                                      gen_threshold, fast_rng)
        return make(Replicas(tables, modulation, channel_type), tables.device,
                    min(int(max_frames), _INT32_SAFE))
    from ..parallel.mesh import FRAME_AXIS, Mesh

    flat = Mesh(mesh.devices.reshape(-1), (FRAME_AXIS,), mesh.processes.reshape(-1))
    init_multi, step_multi = make_streaming_multipoint_step(
        sdc, channel_type, dec, batch_per_device, flat, modulation, chunk_iters, max_frames,
        gen_threshold)

    def init_fn(started_offset: int = 0):
        return init_multi([started_offset])

    def step_fn(states, gens, x_value: float, refill: bool):
        states, acc = step_multi(states, gens, [x_value], [refill])
        return states, StreamDeltas(*(v[0] for v in acc))

    step_fn.per_shard = lambda states, gens, x_value, refill: step_multi.per_shard(
        states, gens, [x_value], [refill])
    return init_fn, step_fn


def make_streaming_multipoint_step(
    sdc,
    channel_type: str,
    dec,
    batch_per_device: int,
    mesh,
    modulation=None,
    chunk_iters: int = 0,
    max_frames: int = int(10e9),
    gen_threshold: Optional[int] = None,
):
    """Streaming compaction over a ``(points, frames)`` mesh (a mesh
    without a points axis is one point): every point group runs its own
    streams at its own sweep value.  One :class:`StreamState` of
    ``batch_per_device`` lanes per local shard, each with its own
    generator; ``step_fn(states, gens, x_values[n_points],
    refill[n_points])`` returns :class:`StreamDeltas` with a leading points
    axis, each summed over the point's frame shards, on the first local
    device, so each point retires its stopping rule on its own (refill
    gating and drain per point).  ``init_fn(started_offset)`` takes one
    offset per point, split exactly over its frame shards
    (:func:`split_exact_multi`)."""
    from ..parallel.mesh import Replicas, on_device

    n_points, n_f = mesh.n_points, mesh.n_frame_shards
    shards = mesh.local_shards()
    if not shards:
        raise ValueError(f"{mesh} has no entry of this process")
    tables, make = _shard_stepper(sdc, channel_type, dec, batch_per_device, chunk_iters,
                                  gen_threshold, False)
    replicas = Replicas(tables, modulation, channel_type)
    base, rem = divmod(min(int(max_frames), n_f * _INT32_SAFE), n_f)
    steppers = []
    for s in shards:
        with on_device(s.device):
            steppers.append(make(replicas, s.device, min(base + int(s.frame < rem),
                                                         _INT32_SAFE)))
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
        """Each local shard's deltas, on its device, in shard order (the
        states are replaced in the list)."""
        if len(x_values) != n_points or len(refill) != n_points:
            raise ValueError(f"{len(x_values)} x-values and {len(refill)} refill flags, "
                             f"mesh expects {n_points}")
        out = []
        for j, (s, (_, step), gen) in enumerate(zip(shards, steppers, gens)):
            with on_device(s.device):
                states[j], acc = step(states[j], gen, float(x_values[s.point]),
                                      bool(refill[s.point]))
            out.append(acc)
        return out

    def step_fn(states: list, gens, x_values, refill):
        sums = torch.zeros((5, n_points), dtype=torch.int64, device=dev)
        for s, acc in zip(shards, per_shard(states, gens, x_values, refill)):
            sums[:, s.point] += torch.stack(list(acc)).to(dev)
        return states, StreamDeltas(*sums)

    step_fn.per_shard = per_shard
    return init_fn, step_fn


def split_exact(total, parts: int) -> np.ndarray:
    """Split a frame offset over ``parts`` per-device ``started`` counters
    so they sum to ``total`` exactly, the remainder on low indices (the
    split the per-device quotas use), each clamped to ``_INT32_SAFE``."""
    total = int(min(int(total), parts * _INT32_SAFE))
    base, rem = divmod(total, parts)
    out = np.full(parts, base, np.int64)
    out[:rem] += 1
    return np.minimum(out, _INT32_SAFE).astype(np.int32)


def split_exact_multi(offsets, n_frame_dev: int) -> np.ndarray:
    """Per-point resume offsets, each split exactly over that point's
    ``n_frame_dev`` frame shards (:func:`split_exact`), points-major."""
    return np.concatenate([split_exact(o, n_frame_dev) for o in np.asarray(offsets).ravel()])
