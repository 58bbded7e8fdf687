"""The three layered decode kernels, their wrappers and their plain versions.

* :func:`bp_decode_layered_fast` runs the fast engine's batch decode, the
  port of ``libldpc_tpu/ops/pallas/decode_lanes.py`` ``kernel_layered_qc``
  (with ``_qc_engine``): a persistent APP, each layer updating only its own
  checks' slots, early termination once per full iteration.
* :func:`bp_stream_chunk_layered_fast` runs its streaming form, the port of
  ``kernel_stream_layered_qc``: ``k`` self-refilling passes per lane on the
  fast engine, with the flooding stream kernel's reload, exact start quota
  and counters.

  Both kernels have two forms, chosen by :func:`fast_form` from the code's
  size: the tile form (``csrc/layered_stream.cuh``, one pass for both: a
  block's APP in shared memory for the whole decode or chunk) and, for a
  code whose tile does not fit, the HBM-plane form
  (``csrc/decode_layered.cu``, ``layered_stream.cuh``).
* :func:`bp_decode_layered` runs the exact layered schedule, the port of
  ``decode_fused.py`` ``kernel_layered`` and ``decode_lanes.py``
  ``kernel_layered`` (one function, two TPU layouts): per layer, the
  layer's checks refresh, the posterior and the extrinsics follow, and a
  converged frame freezes.  The kernel has two forms, chosen by
  :func:`exact_form` from the code's size and the message form: the tile
  form (``csrc/layered_exact_tile.cuh``: a block's 16, 8 or 4 frames keep
  their messages and posteriors in shared memory for the whole decode, and
  after a layer only that layer's variables recompute) and the plane form
  (``csrc/decode_layered_exact.cu``: the same kernel and schedule with
  ``lc2v``, the posterior and the decisions in device memory).

All three take a message storage form (``message_dtype`` float32,
bfloat16 or int8, and the int8 lattice step ``quant_scale``;
:mod:`..messages`), as ``bp_decode_lanes``, ``bp_stream_chunk_lanes`` and
``bp_decode_pallas`` do: each kernel is built in the three forms.  The fast
engine stores its check messages in the form and keeps its APP in float32
(in lattice units for int8); the exact schedule stores its messages and
posterior in the form.  int8 takes the min-sum family only.

Each wrapper takes its plain PyTorch version (same signature) only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
Each keeps a launch count per form, ``<wrapper>.launches[dtype]``, raised
by one at every kernel launch of that form and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from .. import layered
from ..messages import DEFAULT_QUANT_SCALE, DTYPE_CODES, TORCH_DTYPES, MessageForm
from ..sorted import SortedDecodeOutput, bp_decode_sorted, syndrome_ok_from_posterior
from . import build
from .decode_fused import (
    SMEM_BLOCK_BYTES, SMEM_SM_BYTES, _align4, _check, _p, _p_or_null, _raise_on, _require_cuda,
    _zero_output, chunk_launches, cn_mode_args, code_table_ints, stream_grant_plain, tile_bytes,
    tile_form,
)
from .layout import KernelTables


def _require_fast_layers(tables: KernelTables) -> None:
    """The fast engine's host gate: its APP updates are race-free only when
    no layer reaches a variable twice."""
    if tables.n_layers < 1:
        raise ValueError("the fast layered engine needs the code's layers "
                         "(to_sorted_device(code, with_layers=True))")
    if not tables.layers_disjoint:
        raise ValueError("the fast layered engine needs layers that touch each "
                         "variable at most once; decode with the exact layered schedule")


def _tables_args(tables: KernelTables):
    return (_p(tables.row_ptr), _p(tables.col_sorted), _p(tables.vn_ptr), _p(tables.perm_c2v),
            _p(tables.layer_ptr), _p(tables.layer_checks))


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def bp_decode_layered_fast_plain(
    tables: KernelTables,
    llr_in: torch.Tensor,
    iterations: int = 50,
    early_term: bool = True,
    minsum_mode=False,
    message_dtype: str = "float32",
    quant_scale: float = DEFAULT_QUANT_SCALE,
) -> SortedDecodeOutput:
    """Plain version of :func:`bp_decode_layered_fast`:
    :func:`..layered.bp_decode_layered_fast_plain` in the message form."""
    return layered.bp_decode_layered_fast_plain(tables, llr_in, iterations, early_term,
                                                minsum_mode, MessageForm(message_dtype, quant_scale))


def bp_decode_layered_fast(
    tables: KernelTables,
    llr_in: torch.Tensor,  # f32 [nc, B], sorted VN labelling
    iterations: int = 50,
    early_term: bool = True,
    minsum_mode=False,
    message_dtype: str = "float32",
    quant_scale: float = DEFAULT_QUANT_SCALE,
) -> SortedDecodeOutput:
    """The fast layered engine's batch decode, all iterations in one kernel
    launch.  Same boundary as ``bp_decode_lanes(..., layered=True)`` on a
    layout with natural-QC layers: ``llr_out`` is the APP as LLRs
    (``app * quant_scale`` on the int8 lattice), ``hard = llr_out <= 0``,
    break-before-increment ``iterations`` and ``is_codeword``; without early
    termination every frame reports the cap and ``is_codeword`` comes from
    the last iteration; ``iterations == 0`` returns all zeros.  The check
    messages are stored in ``message_dtype``; int8 takes a min-sum-family
    ``minsum_mode`` only (``ValueError`` otherwise).  Any ``B``: the last
    block is masked.  The kernel's form (a block's APP on chip for the
    decode, or every plane in device memory) follows :func:`batch_form`;
    both compute the same."""
    form = MessageForm(message_dtype, quant_scale)
    form.check_cn_mode(minsum_mode)
    nc = tables.code.nc
    B = llr_in.shape[1] if llr_in.dim() == 2 else -1
    _check(llr_in, "llr_in", torch.float32, (nc, B), tables.device)
    _require_fast_layers(tables)
    if iterations == 0:
        return _zero_output(llr_in)
    if llr_in.device.type == "cpu":
        return bp_decode_layered_fast_plain(tables, llr_in, iterations, early_term, minsum_mode,
                                            message_dtype, quant_scale)
    _require_cuda(llr_in)
    lib = build.load()
    dev = llr_in.device
    sdc = tables.code
    app = torch.empty_like(llr_in)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    iscw = torch.empty(B, dtype=torch.int32, device=dev)
    lc2v = torch.empty((sdc.nnz, B), dtype=form.torch_dtype, device=dev)
    mode, scale, offset = cn_mode_args(form.cn_mode(minsum_mode))
    run = (iterations, int(bool(early_term)), mode, scale, offset, form.code, form.inv_q)
    head = (_p(llr_in), _p(app), _p(iters), _p(iscw), _p(lc2v), *_tables_args(tables), nc,
            sdc.mc, sdc.nnz, tables.n_layers)
    frames, stage = batch_form(tables)
    if frames == 0:
        err = lib.ldpc_bp_decode_layered_fast(*head, B, *run, _stream(llr_in))
    else:
        entry = {16: lib.ldpc_bp_decode_layered_fast_tile16,
                 8: lib.ldpc_bp_decode_layered_fast_tile8}[frames]
        err = entry(*head, tables.layer_checks.shape[0], B, *run, int(stage), _stream(llr_in))
    _raise_on(lib, err, "bp_decode_layered_fast")
    bp_decode_layered_fast.launches[form.dtype] += 1
    bp_decode_layered_fast.last_form = (frames, stage)
    llr_out = form.dequant(app)
    return SortedDecodeOutput(llr_out=llr_out, hard=llr_out <= 0, iterations=iters,
                              is_codeword=iscw > 0)


bp_decode_layered_fast.launches = dict.fromkeys(DTYPE_CODES, 0)
#: ``(frames, stage)`` of the last launch (:func:`batch_form`)
bp_decode_layered_fast.last_form = None


#: Force a form of the batch kernel (:func:`batch_form`) or of the streaming
#: kernel (:func:`stream_form`) (the card tests and the smoke run's
#: side-by-side times do): None follows :func:`fast_form`; else
#: ``(frames, stage)`` with frames 0 (HBM-plane form), 8 or 16.
BATCH_FORM_OVERRIDE = None
STREAM_FORM_OVERRIDE = None


def fast_tile_bytes(tables: KernelTables, frames: int, stage: bool) -> int:
    """Dynamic shared memory of a tile form of the batch or the streaming
    kernel (``csrc/layered_stream.cuh`` ``fast_tile_bytes``, exported by the
    library as ``ldpc_fast_tile_bytes``): the APP tile ``[nc, frames]``
    float32, the packed decisions ``[nc]`` uint16 padded to 4 bytes and,
    staged, the int32 tables ``row_ptr``, ``col_sorted``, ``layer_ptr``,
    ``layer_checks``."""
    sdc = tables.code
    n = sdc.nc * frames * 4 + (sdc.nc + 1) // 2 * 4
    if stage:
        n += (sdc.mc + 1 + sdc.nnz + tables.n_layers + 1 + tables.layer_checks.shape[0]) * 4
    return n


def fast_form(tables: KernelTables) -> tuple[int, bool]:
    """``(frames, stage)`` of the fast engine's tile forms (the batch decode
    and the streaming chunk share the tile and the pass) for this code, by
    size alone (:func:`.decode_fused.tile_form` without its test of the
    tables against the L1, as the chunk's forms were timed).  16 frames a
    block on the tile form when that tile fits a block's shared memory
    (``nc`` up to ~3500; a block then has its SM to itself), else 8 frames
    (``nc`` up to ~7000),
    else ``(0, False)``, the HBM-plane form.  The index tables are staged
    beside the tile when they fit too (at 8 frames: when two such blocks
    still fit one SM).  In float32 a block's 16 frames of one slot are a
    64-byte segment of the ``lc2v`` plane, 8 frames a 32-byte one, half of
    what the card's memory moves at a time (``PERF.md`` section 6 has the
    times of each form)."""
    return tile_form(lambda frames, stage: fast_tile_bytes(tables, frames, stage), (16, 8),
                     blocks_per_sm=lambda frames: 1 if frames == 16 else 2, tables_in_l1=False)


def batch_form(tables: KernelTables) -> tuple[int, bool]:
    """``(frames, stage)`` of the batch kernel: :data:`BATCH_FORM_OVERRIDE`,
    else :func:`fast_form`."""
    return BATCH_FORM_OVERRIDE if BATCH_FORM_OVERRIDE is not None else fast_form(tables)


def stream_form(tables: KernelTables) -> tuple[int, bool]:
    """``(frames, stage)`` of the streaming kernel: :data:`STREAM_FORM_OVERRIDE`,
    else :func:`fast_form`."""
    return STREAM_FORM_OVERRIDE if STREAM_FORM_OVERRIDE is not None else fast_form(tables)


def bp_stream_chunk_layered_fast_plain(
    tables, app, cw, lc2v, done, iters, age, avail, ctr, fresh_llr, fresh_cw,
    refill, remaining, *, k: int, cap: int, minsum_mode=False, message_dtype: str = "float32",
    quant_scale: float = DEFAULT_QUANT_SCALE, ordered: bool = False,
) -> None:
    """Plain version of :func:`bp_stream_chunk_layered_fast`, pass for pass
    as ``kernel_stream_layered_qc``: starts are granted in lane order (an
    inclusive scan against ``remaining``), whatever ``ordered`` says."""
    form = MessageForm(message_dtype, quant_scale)
    form.check_cn_mode(minsum_mode, "int8 streaming")
    sdc = tables.code
    is_tx = torch.zeros(sdc.nc, dtype=torch.bool, device=app.device)
    is_tx[sdc.bit_pos.long()] = True
    for _ in range(k):
        # ---- lanes injected in flight at age 0 start the engine here, from
        # the prior of the LLRs they carry
        raw = (done == 0) & (age == 0)
        app.copy_(torch.where(raw, form.prior(app), app))
        lc2v.masked_fill_(raw[None, :], 0)
        age += raw.to(torch.int32)
        # ---- reload idle lanes from the pool, within the quota
        rs = stream_grant_plain(done, avail, refill, remaining) != 0
        app.copy_(torch.where(rs, form.prior(fresh_llr), app))
        cw.copy_(torch.where(rs, fresh_cw, cw))
        lc2v.masked_fill_(rs[None, :], 0)
        r = rs.to(torch.int32)
        done.mul_(1 - r)
        age.copy_(torch.where(rs, 1, age))
        iters.mul_(1 - r)
        avail.sub_(r)
        ctr[4] += r
        # ---- one layered iteration over the lanes in flight
        active = done == 0
        layered.layered_fast_pass(tables, app, lc2v, ~active, minsum_mode, form)
        checking = active & (age >= 1)
        ok = syndrome_ok_from_posterior(sdc, app.index_select(0, sdc.col_sorted))
        iters += (checking & ~ok).to(torch.int32)
        age += active.to(torch.int32)
        finished = active & ((checking & ok) | (age >= cap + 1))
        f = finished.to(torch.int32)
        done += f
        biterr = (((app <= 0) != (cw != 0)) & is_tx[:, None]).sum(0, dtype=torch.int32)
        ctr[0] += f * biterr
        ctr[1] += f * (biterr > 0).to(torch.int32)
        ctr[2] += f
        ctr[3] += f * iters


def bp_stream_chunk_layered_fast(
    tables: KernelTables,
    app: torch.Tensor,  # f32 [nc, B] carried APP posterior (decoder units)
    cw: torch.Tensor,  # u8 [nc, B] carried true codewords
    lc2v: torch.Tensor,  # [nnz, B] carried CN-space check messages, in message_dtype
    done: torch.Tensor,  # i32 [B] lane idle (finished or empty)
    iters: torch.Tensor,  # i32 [B]
    age: torch.Tensor,  # i32 [B] passes since (re)load (0 = injected, not started)
    avail: torch.Tensor,  # i32 [B] pool entry unused
    ctr: torch.Tensor,  # i32 [5, B] counters
    fresh_llr: torch.Tensor,  # f32 [nc, B] fresh-frame pool (raw LLRs)
    fresh_cw: torch.Tensor,  # u8 [nc, B]
    refill: torch.Tensor,  # i32 [1]: reloads allowed
    remaining: torch.Tensor,  # i32 [1]: starts left in the quota
    *,
    k: int,
    cap: int,
    minsum_mode=False,
    message_dtype: str = "float32",
    quant_scale: float = DEFAULT_QUANT_SCALE,
    ordered: bool = False,
) -> None:
    """``k`` self-refilling passes of the fast layered engine per lane,
    updating the state in place.

    Per pass and lane: a lane in flight at ``age == 0`` (injected) starts
    the engine (APP = the prior of the LLRs it carries, ``lc2v = 0``,
    ``age = 1``); an idle lane (``done``) with an unused pool entry
    (``avail``) starts that entry if the quota allows (``remaining`` is
    decremented per start; APP = the prior of the fresh LLRs, ``lc2v = 0``,
    ``age = 1``); then a lane in flight runs one full layered iteration,
    checks the syndrome of ``app <= 0``, and finishes on convergence or at
    ``age >= cap + 1``, adding its transmitted-bit errors (decided from the
    APP), a frame error, a frame and its iteration count to ``ctr`` rows
    0-3 (row 4 counts starts).  On CUDA the quota is one device counter
    taken with ``atomicSub``, so where the quota binds, which lanes start
    depends on the block order; ``ordered=True`` runs the chunk as ``k``
    one-pass launches with the grants in lane order
    (:func:`.decode_fused.chunk_launches`), equal to the plain version's in
    every chunk.  The kernel's form
    (a block's APP in shared memory, or every plane in device memory)
    follows :func:`stream_form`; both compute the same.

    ``lc2v`` is stored in ``message_dtype``; the APP is float32 in decoder
    units (lattice units on the int8 lattice, where the prior is the LLR
    times ``float32(1 / quant_scale)``, as ``bp_stream_chunk_lanes``
    scales it), and the pool stays raw float32 LLRs.  int8 takes a
    min-sum-family ``minsum_mode`` only."""
    form = MessageForm(message_dtype, quant_scale)
    form.check_cn_mode(minsum_mode, "int8 streaming")
    sdc = tables.code
    nc, nnz = sdc.nc, sdc.nnz
    B = app.shape[1] if app.dim() == 2 else -1
    dev = tables.device
    for name, t, dtype, shape in (
        ("app", app, torch.float32, (nc, B)), ("cw", cw, torch.uint8, (nc, B)),
        ("lc2v", lc2v, form.torch_dtype, (nnz, B)), ("done", done, torch.int32, (B,)),
        ("iters", iters, torch.int32, (B,)), ("age", age, torch.int32, (B,)),
        ("avail", avail, torch.int32, (B,)), ("ctr", ctr, torch.int32, (5, B)),
        ("fresh_llr", fresh_llr, torch.float32, (nc, B)),
        ("fresh_cw", fresh_cw, torch.uint8, (nc, B)),
        ("refill", refill, torch.int32, (1,)), ("remaining", remaining, torch.int32, (1,)),
    ):
        _check(t, name, dtype, shape, dev)
    if k < 1 or cap < 1:
        raise ValueError(f"k ({k}) and cap ({cap}) must be >= 1")
    _require_fast_layers(tables)
    if app.device.type == "cpu":
        return bp_stream_chunk_layered_fast_plain(
            tables, app, cw, lc2v, done, iters, age, avail, ctr, fresh_llr,
            fresh_cw, refill, remaining, k=k, cap=cap, minsum_mode=minsum_mode,
            message_dtype=message_dtype, quant_scale=quant_scale,
        )
    _require_cuda(app)
    lib = build.load()
    mode, scale, offset = cn_mode_args(form.cn_mode(minsum_mode))
    frames, stage = stream_form(tables)
    entry = {16: lib.ldpc_bp_stream_chunk_layered_tile16,
             8: lib.ldpc_bp_stream_chunk_layered_tile8,
             0: lib.ldpc_bp_stream_chunk_layered_hbm}[frames]
    for passes, grant in chunk_launches(k, ordered, done, avail, refill, remaining):
        err = entry(
            _p(app), _p(cw), _p(lc2v), _p(done), _p(iters), _p(age), _p(avail), _p(ctr),
            _p(fresh_llr), _p(fresh_cw), _p(refill), _p(remaining), _p_or_null(grant),
            *_tables_args(tables), _p(tables.bit_pos), nc, sdc.mc, nnz, tables.n_layers,
            tables.layer_checks.shape[0], sdc.nct, B, passes, cap, mode, scale, offset,
            form.code, form.inv_q, int(stage), _stream(app),
        )
        _raise_on(lib, err, "bp_stream_chunk_layered_fast")
        bp_stream_chunk_layered_fast.launches[form.dtype] += 1
    bp_stream_chunk_layered_fast.last_form = (frames, stage)


bp_stream_chunk_layered_fast.launches = dict.fromkeys(DTYPE_CODES, 0)
#: ``(frames, stage)`` of the last launch (:func:`stream_form`)
bp_stream_chunk_layered_fast.last_form = None


#: Frames a block of the exact layered kernel's tile form may own, largest first.
EXACT_TILE_FRAMES = (16, 8, 4)
#: Force a form of the exact layered kernel (the card tests and the smoke
#: run's side-by-side times do): None follows :func:`exact_form`; else
#: ``(frames, stage)`` with frames 16, 8 or 4 (a tile) or 0 (the plane form).
EXACT_FORM_OVERRIDE = None


def _exact_table_ints(tables: KernelTables) -> int:
    """int32 entries the exact kernel stages: the code's four tables and
    each layer's checks and variables (CSR)."""
    return (code_table_ints(tables) + 2 * (tables.n_layers + 1) + tables.layer_checks.shape[0]
            + tables.layer_vars.shape[0])


def exact_tile_bytes(tables: KernelTables, frames: int, message_dtype: str, stage: bool) -> int:
    """Dynamic shared memory of the exact layered kernel's tile form
    (``csrc/layered_exact_tile.cuh`` ``exact_tile_bytes``, exported by the
    library as ``ldpc_exact_tile_bytes``): the tile and, staged, the code's
    four tables and each layer's checks and variables (CSR)."""
    return tile_bytes(tables, frames, message_dtype, _exact_table_ints(tables) if stage else 0)


def exact_form(tables: KernelTables, message_dtype: str = "float32") -> tuple[int, bool]:
    """``(frames, stage)`` of the exact layered kernel for this code and
    message form, by size alone: a tile of :data:`EXACT_TILE_FRAMES` frames
    a block where one fits, else ``(0, False)``, the plane form (``lc2v``,
    the posterior and the decisions in device memory, 16 frames a block),
    which every tile beat where both fit.

    float32 and bfloat16 (one block an SM) take
    :func:`.decode_fused.tile_form`'s tile: the most frames whose tables
    stay on chip, staged or in the L1 the tile leaves, else the most frames
    that fit.  The int8 tiles run two blocks an SM
    (``csrc/layered_exact_tile.cuh`` ``__launch_bounds__``): the most frames
    whose unstaged tile lets two blocks share an SM, staged if the staged
    tile does too, whatever the L1 holds.

    The choices and their times on the card (``PERF.md`` section 6; 50
    iterations at B = 16384, BP, int8 BP_MS): wifi 648 16 frames staged in
    every form (228,640 bytes in float32); wifi 1296 4 staged in float32
    (74.2 ms against 79.2 at 8 unstaged and 111.5 in the plane form), 8
    staged in bfloat16 (59.9 against 70.8 at 8 unstaged), 16 unstaged in
    int8 (34.4 against 34.8 at 8 unstaged); wifi 1944 4 unstaged in float32
    (134.0 ms against 170.2 in the plane form and 374.2 in the HBM-plane
    design before it), 4 staged in bfloat16 (100.2 against 120.4 at 8
    unstaged), 8 unstaged in int8 (57.0 against 63.6 at 4 unstaged and 87.6
    at 16 unstaged).  Past the tiles, on (3,6) QC codes of 4,800 (float32)
    and 8,000 (bfloat16) variables, the plane form took 0.68 and 0.93 times
    the time of a plane form keeping the posterior of 8 frames a block on
    chip, on 16,000 (int8) 1.10 times: that form was not kept.  At any
    other shape the rule extrapolates."""
    if EXACT_FORM_OVERRIDE is not None:
        return EXACT_FORM_OVERRIDE

    def bytes_of(frames, stage):
        return exact_tile_bytes(tables, frames, message_dtype, stage)

    if TORCH_DTYPES[message_dtype].itemsize > 1:
        return tile_form(bytes_of, EXACT_TILE_FRAMES)
    two = SMEM_SM_BYTES // 2 - 1024
    shared = tuple(f for f in EXACT_TILE_FRAMES if bytes_of(f, False) <= two)
    return tile_form(bytes_of, shared or EXACT_TILE_FRAMES, blocks_per_sm=lambda frames: 2,
                     tables_in_l1=False)


def bp_decode_layered_plain(
    tables: KernelTables,
    llr_in: torch.Tensor,
    iterations: int = 50,
    early_term: bool = True,
    minsum_mode=False,
    message_dtype: str = "float32",
    quant_scale: float = DEFAULT_QUANT_SCALE,
) -> SortedDecodeOutput:
    """Plain version of :func:`bp_decode_layered`: the sorted decoder's
    exact layered schedule in the message form, with ``bp_decode_pallas``'s
    all-zero output at ``iterations == 0``."""
    form = MessageForm(message_dtype, quant_scale)
    form.check_cn_mode(minsum_mode)
    if iterations == 0:
        return _zero_output(llr_in)
    return bp_decode_sorted(tables.code, llr_in, iterations, early_term, minsum_mode,
                            layered=True, form=form)


def bp_decode_layered(
    tables: KernelTables,
    llr_in: torch.Tensor,  # f32 [nc, B], sorted VN labelling
    iterations: int = 50,
    early_term: bool = True,
    minsum_mode=False,
    message_dtype: str = "float32",
    quant_scale: float = DEFAULT_QUANT_SCALE,
) -> SortedDecodeOutput:
    """The exact layered schedule of a batch, all iterations in one kernel
    launch.  Same boundary as ``bp_decode_pallas(..., layered=True)`` (see
    :func:`..sorted.bp_decode_sorted` for the schedule): ``llr_out`` is the
    stored posterior as float32 LLRs (dequantised on the int8 lattice); a
    frame's iteration counts iff it is unconverged at the start and at the
    end of the full iteration; without early termination every frame
    reports the cap and ``is_codeword`` comes from the last layer's
    syndrome.  Messages and the posterior are stored in ``message_dtype``;
    int8 takes a min-sum-family ``minsum_mode`` only.  Needs at least two
    layers (with fewer the schedule is flooding:
    :func:`.decode_fused.bp_decode_fused`).  The kernel's form (a block's
    frames on chip for the decode, or its messages and posterior in device
    memory) follows :func:`exact_form`; all compute the same."""
    form = MessageForm(message_dtype, quant_scale)
    form.check_cn_mode(minsum_mode)
    nc = tables.code.nc
    B = llr_in.shape[1] if llr_in.dim() == 2 else -1
    _check(llr_in, "llr_in", torch.float32, (nc, B), tables.device)
    if tables.n_layers < 2:
        raise ValueError(f"the exact layered kernel needs >= 2 layers, got {tables.n_layers}")
    if iterations == 0:
        return _zero_output(llr_in)
    if llr_in.device.type == "cpu":
        return bp_decode_layered_plain(tables, llr_in, iterations, early_term, minsum_mode,
                                       message_dtype, quant_scale)
    _require_cuda(llr_in)
    lib = build.load()
    dev = llr_in.device
    sdc = tables.code
    msgs = dict(dtype=form.torch_dtype, device=dev)
    post = torch.empty((nc, B), **msgs)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    iscw = torch.empty(B, dtype=torch.int32, device=dev)
    mode, scale, offset = cn_mode_args(form.cn_mode(minsum_mode))
    run = (iterations, int(bool(early_term)), mode, scale, offset, form.code, form.inv_q)
    frames, stage = exact_form(tables, form.dtype)
    layer_args = (_p(tables.layer_var_ptr), _p(tables.layer_vars), nc, sdc.mc, sdc.nnz,
                  tables.n_layers, tables.layer_checks.shape[0], tables.layer_vars.shape[0], B)
    if frames == 0:
        lc2v = torch.empty((sdc.nnz, B), **msgs)
        # the packed decisions, a row per block of 16 frames
        hard = torch.empty(((B + 15) // 16, nc), dtype=torch.int16, device=dev)
        err = lib.ldpc_bp_decode_layered(
            _p(llr_in), _p(post), _p(iters), _p(iscw), _p(lc2v), _p(hard),
            *_tables_args(tables), *layer_args, *run, _stream(llr_in),
        )
    else:
        entry = {16: lib.ldpc_bp_decode_layered_tile16, 8: lib.ldpc_bp_decode_layered_tile8,
                 4: lib.ldpc_bp_decode_layered_tile4}[frames]
        err = entry(_p(llr_in), _p(post), _p(iters), _p(iscw), *_tables_args(tables),
                    *layer_args, *run, int(stage), _stream(llr_in))
    _raise_on(lib, err, "bp_decode_layered")
    bp_decode_layered.launches[form.dtype] += 1
    bp_decode_layered.last_form = (frames, stage)
    llr_out = form.dequant(post)
    return SortedDecodeOutput(llr_out=llr_out, hard=llr_out <= 0, iterations=iters,
                              is_codeword=iscw > 0)


bp_decode_layered.launches = dict.fromkeys(DTYPE_CODES, 0)
#: ``(frames, stage)`` of the last launch (:func:`exact_form`)
bp_decode_layered.last_form = None
