"""The two flooding decode kernels, their wrappers and their plain versions.

* :func:`bp_decode_fused` runs the batch kernel, the port of
  ``libldpc_tpu/ops/pallas/decode_fused.py`` ``kernel`` (reached there
  through ``bp_decode_pallas``): the whole decode of a batch, all
  iterations in one launch, with per-frame early termination.
* :func:`bp_stream_chunk_fused` runs its streaming kernel, the port of
  ``kernel_stream`` (``bp_stream_chunk_pallas``): ``k`` self-refilling
  passes per lane with in-kernel reload, an exact global start quota and
  per-lane counters.

Each kernel has two forms, chosen by :func:`flood_form` from the code's
size and the message form: the tile form (``csrc/flood_stream.cuh``, one
pass for both: a block's frames keep their messages and posteriors in
shared memory for the whole decode or chunk) and, for a code whose tile
does not fit, the HBM-plane form (``csrc/decode_fused.cu``,
``csrc/decode_stream.cu``).

Both take a message storage form (``message_dtype`` float32, bfloat16 or
int8, and the int8 lattice step ``quant_scale``; :mod:`..messages`), as
``bp_decode_pallas`` and ``bp_stream_chunk_pallas`` do: each kernel is
built in the three forms.  Unlike the JAX package, int8 needs no
particular transport here (there, the MXU one).

Each wrapper takes its plain PyTorch version (same signature, beside it)
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises.  Each keeps a launch count per form, ``<wrapper>.launches[dtype]``,
raised by one at every kernel launch of that form and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from ..messages import DEFAULT_QUANT_SCALE, DTYPE_CODES, TORCH_DTYPES, MessageForm
from ..sorted import SortedDecodeOutput, bp_decode_sorted, bp_pass, syndrome_ok_from_posterior
from . import build
from .layout import KernelTables

#: CN form -> the kernel's mode number (``enum CnMode`` in the source).
CN_MODES = {"BP": 0, "BP_MS": 1, "BP_LIN": 2, "BP_NMS": 3, "BP_OMS": 4,
            "BP_TANH": 5, "BP_PHI": 6}


def cn_mode_args(minsum_mode) -> tuple[int, float, float]:
    """``(mode, scale, offset)`` for the kernel.  NMS/OMS correct only when
    given as a ``(type, scale, offset)`` tuple (as ``DecoderParams.cn_mode``
    gives them); a bare string of theirs is plain min-sum, and an unknown
    string is ``BP`` (the reference's fallback)."""
    scale = offset = 0.0
    if isinstance(minsum_mode, tuple):
        kind, scale, offset = minsum_mode
    elif isinstance(minsum_mode, str):
        kind = "BP_MS" if minsum_mode in ("BP_NMS", "BP_OMS") else minsum_mode
    else:
        kind = "BP_MS" if minsum_mode else "BP"
    return CN_MODES.get(kind, 0), float(scale), float(offset)


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)}, got "
            f"{'contiguous' if t.is_contiguous() else 'strided'} {t.dtype} "
            f"{tuple(t.shape)}"
        )
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the code tables on {device}")


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the decode kernels take CPU or CUDA tensors, not {t.device}")


def _raise_on(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: {lib.ldpc_error_string(err).decode()}")


def _p(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _zero_output(llr_in: torch.Tensor) -> SortedDecodeOutput:
    B = llr_in.shape[1]
    return SortedDecodeOutput(
        llr_out=torch.zeros_like(llr_in),
        hard=torch.zeros_like(llr_in, dtype=torch.bool),
        iterations=torch.zeros(B, dtype=torch.int32, device=llr_in.device),
        is_codeword=torch.zeros(B, dtype=torch.bool, device=llr_in.device),
    )


def bp_decode_fused_plain(
    tables: KernelTables,
    llr_in: torch.Tensor,
    iterations: int = 50,
    early_term: bool = True,
    minsum_mode=False,
    message_dtype: str = "float32",
    quant_scale: float = DEFAULT_QUANT_SCALE,
) -> SortedDecodeOutput:
    """Plain version of :func:`bp_decode_fused`: the sorted decoder, with
    ``bp_decode_pallas``'s all-zero output at ``iterations == 0``."""
    form = MessageForm(message_dtype, quant_scale)
    form.check_cn_mode(minsum_mode)
    if iterations == 0:
        return _zero_output(llr_in)
    return bp_decode_sorted(tables.code, llr_in, iterations, early_term, minsum_mode, form=form)


def bp_decode_fused(
    tables: KernelTables,
    llr_in: torch.Tensor,  # f32 [nc, B], sorted VN labelling
    iterations: int = 50,
    early_term: bool = True,
    minsum_mode=False,
    message_dtype: str = "float32",
    quant_scale: float = DEFAULT_QUANT_SCALE,
) -> SortedDecodeOutput:
    """Flooding BP of a batch, all iterations in one kernel launch.

    Same boundary as ``bp_decode_pallas``: ``llr_out`` (the stored
    posterior as float32 LLRs, ``f32(q) * quant_scale`` on the int8
    lattice), ``hard = llr_out <= 0``, break-before-increment
    ``iterations`` and ``is_codeword``; with ``early_term=False`` every
    frame reports the cap and ``is_codeword`` comes from the last pass;
    ``iterations == 0`` returns all zeros.  Messages and the posterior are
    stored in ``message_dtype``; int8 takes a min-sum-family
    ``minsum_mode`` only (``ValueError`` otherwise).  Any ``B``: the last
    block is masked.  The kernel's form (a block's frames on chip for the
    decode, or every plane in device memory) follows :func:`batch_form`;
    both compute the same."""
    form = MessageForm(message_dtype, quant_scale)
    form.check_cn_mode(minsum_mode)
    nc = tables.code.nc
    B = llr_in.shape[1] if llr_in.dim() == 2 else -1
    _check(llr_in, "llr_in", torch.float32, (nc, B), tables.device)
    if iterations == 0:
        return _zero_output(llr_in)
    if llr_in.device.type == "cpu":
        return bp_decode_fused_plain(tables, llr_in, iterations, early_term, minsum_mode,
                                     message_dtype, quant_scale)
    _require_cuda(llr_in)
    lib = build.load()
    dev = llr_in.device
    nnz = tables.code.nnz
    msgs = dict(dtype=form.torch_dtype, device=dev)
    post = torch.empty((nc, B), **msgs)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    iscw = torch.empty(B, dtype=torch.int32, device=dev)
    mode, scale, offset = cn_mode_args(form.cn_mode(minsum_mode))
    code = (_p(tables.row_ptr), _p(tables.col_sorted), _p(tables.vn_ptr), _p(tables.perm_c2v),
            nc, tables.code.mc, nnz, B, iterations, int(bool(early_term)), mode, scale, offset,
            form.code, form.inv_q)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    frames, stage = batch_form(tables, form.dtype)
    if frames == 0:
        lv2c = torch.empty((nnz, B), **msgs)
        lc2v = torch.empty((nnz, B), **msgs)
        err = lib.ldpc_bp_decode_fused(_p(llr_in), _p(post), _p(iters), _p(iscw), _p(lv2c),
                                       _p(lc2v), *code, stream)
    else:
        entry = {16: lib.ldpc_bp_decode_fused_tile16, 8: lib.ldpc_bp_decode_fused_tile8,
                 4: lib.ldpc_bp_decode_fused_tile4}[frames]
        err = entry(_p(llr_in), _p(post), _p(iters), _p(iscw), *code, int(stage), stream)
    _raise_on(lib, err, "bp_decode_fused")
    bp_decode_fused.launches[form.dtype] += 1
    bp_decode_fused.last_form = (frames, stage)
    llr_out = form.dequant(post)
    return SortedDecodeOutput(
        llr_out=llr_out,
        hard=llr_out <= 0,
        iterations=iters,
        is_codeword=iscw > 0,
    )


bp_decode_fused.launches = dict.fromkeys(DTYPE_CODES, 0)
#: ``(frames, stage)`` of the last launch (:func:`batch_form`)
bp_decode_fused.last_form = None


#: Shared memory one block may take on the card (232,448 bytes), less the
#: kernels' static arrays.
SMEM_BLOCK_BYTES = 232448 - 256
#: Frames a block of the flooding kernels' tile forms may own, largest first.
FLOOD_TILE_FRAMES = (16, 8, 4)
#: Force a form of the batch kernel (:func:`batch_form`) or of the streaming
#: kernel (:func:`stream_form`) (the card tests and the smoke run's
#: side-by-side times do): None follows :func:`flood_form`; else
#: ``(frames, stage)`` with frames 0 (the HBM-plane form), 4, 8 or 16.
BATCH_FORM_OVERRIDE = None
STREAM_FORM_OVERRIDE = None


def _align4(n: int) -> int:
    return (n + 3) // 4 * 4


def tile_bytes(tables: KernelTables, frames: int, message_dtype: str, table_ints: int) -> int:
    """Dynamic shared memory of a tile form of K1, K2 or K5 (``csrc/bp_phases.cuh``
    ``tile_layout_bytes``): ``lc2v [nnz, frames]`` and the posterior
    ``[nc, frames]`` in the message type, the packed decisions ``[nc]``
    uint16, then ``table_ints`` int32 entries of staged index tables."""
    sdc = tables.code
    msg = TORCH_DTYPES[message_dtype].itemsize
    return _align4((sdc.nnz + sdc.nc) * frames * msg) + _align4(sdc.nc * 2) + 4 * table_ints


def code_table_ints(tables: KernelTables) -> int:
    """int32 entries of ``row_ptr``, ``col_sorted``, ``vn_ptr`` and ``perm_c2v``."""
    sdc = tables.code
    return sdc.mc + 1 + sdc.nnz + sdc.nc + 1 + sdc.nnz


def flood_tile_bytes(tables: KernelTables, frames: int, message_dtype: str, stage: bool) -> int:
    """Dynamic shared memory of a tile form of the batch or the streaming
    kernel (``csrc/flood_stream.cuh`` ``flood_tile_bytes``, exported by the
    library as ``ldpc_flood_tile_bytes``): the tile and, staged, the code's
    four tables."""
    return tile_bytes(tables, frames, message_dtype, code_table_ints(tables) if stage else 0)


#: Shared memory of one SM (228 KB), the 1 KB the system keeps per block
#: included; the L1 and shared memory of one SM (one array of 256 KB); and
#: the shared-memory capacities, in KB, the CUDA driver may carve from that
#: array (compute capability 9.0), the rest being the L1 cache.
SMEM_SM_BYTES = 233472
L1_SM_BYTES = 256 * 1024
SMEM_CARVEOUTS_KB = (0, 8, 16, 32, 64, 100, 132, 164, 196, 228)


def l1_left(sm_bytes: int) -> int:
    """L1 cache left on an SM whose blocks take ``sm_bytes`` of shared
    memory in all (1 KB a block included)."""
    return L1_SM_BYTES - 1024 * next(kb for kb in SMEM_CARVEOUTS_KB + (256,)
                                     if kb * 1024 >= sm_bytes)


def tile_form(bytes_of, frames_choices, blocks_per_sm=lambda frames: 1,
              tables_in_l1: bool = True) -> tuple[int, bool]:
    """``(frames, stage)`` of a kernel with tile forms, by size alone.

    The most frames of ``frames_choices`` (largest first) whose tile
    (``bytes_of(frames, False)``) fits a block's shared memory with its
    index tables on chip: staged beside it, when the staged tile
    (``bytes_of(frames, True)``) leaves room for the kernel's
    ``blocks_per_sm(frames)`` blocks an SM; or unstaged, when the tables
    fit the L1 cache those blocks' shared memory leaves (:func:`l1_left`;
    ``tables_in_l1=False`` skips that test).  If no tile keeps its tables
    on chip, the most frames whose tile fits; else ``(0, False)``, the
    HBM-plane form.

    At every shape timed on the card it picks the fastest form measured,
    or one within 0.3 % of it (``PERF.md`` section 6).  On wifi 648, whose
    34 KB of K5 tables fit the 60 KB of L1 beside a 16-frame tile, 16
    frames staged; unstaged they still beat 8 staged in bf16 BP (30.8
    against 39.7 ms).  On wifi 1296, whose 66 KB do not: bf16 BP 8 staged
    59.8 ms against 72.0 at 16 unstaged; int8 BP_MS (two blocks an SM) 8
    unstaged 34.6 ms against 42.8 at 16 staged (one block an SM)."""
    for frames in frames_choices:
        tile = bytes_of(frames, False)
        if tile > SMEM_BLOCK_BYTES:
            continue
        n = blocks_per_sm(frames)
        room = SMEM_BLOCK_BYTES if n == 1 else SMEM_SM_BYTES // n - 1024
        staged = bytes_of(frames, True)
        if staged <= room:
            return frames, True
        if not tables_in_l1:
            return frames, False
        blocks = n if tile <= room else 1
        if staged - tile <= l1_left(blocks * (tile + 1024)):
            return frames, False
    for frames in frames_choices:
        if bytes_of(frames, False) <= SMEM_BLOCK_BYTES:
            return frames, False
    return 0, False


def flood_form(tables: KernelTables, message_dtype: str = "float32") -> tuple[int, bool]:
    """``(frames, stage)`` of the flooding kernels' tile forms (the batch
    decode and the streaming chunk share the layout and the pass) for this
    code and message form, by size alone (:func:`tile_form`): for the 1152
    (3,6) code 8 frames a block in float32, 16 in bfloat16 and int8, all
    staged; for wifi 1944 4, 8 and 16, staged.  ``PERF.md`` section 6 has
    the times of every form at those shapes; at any other shape the rule
    extrapolates."""
    return tile_form(lambda frames, stage: flood_tile_bytes(tables, frames, message_dtype, stage),
                     FLOOD_TILE_FRAMES)


def batch_form(tables: KernelTables, message_dtype: str = "float32") -> tuple[int, bool]:
    """``(frames, stage)`` of the batch kernel: :data:`BATCH_FORM_OVERRIDE`,
    else :func:`flood_form`."""
    return BATCH_FORM_OVERRIDE if BATCH_FORM_OVERRIDE is not None else flood_form(
        tables, message_dtype)


def stream_form(tables: KernelTables, message_dtype: str = "float32") -> tuple[int, bool]:
    """``(frames, stage)`` of the streaming kernel: :data:`STREAM_FORM_OVERRIDE`,
    else :func:`flood_form`."""
    return STREAM_FORM_OVERRIDE if STREAM_FORM_OVERRIDE is not None else flood_form(
        tables, message_dtype)


def stream_chunk_plain(tables, llr, cw, lv2c, done, iters, age, avail, ctr, fresh_llr, fresh_cw,
                       refill, remaining, k: int, cap: int, decode_pass, converged,
                       bit_errors, reload=None) -> None:
    """The streaming chunk in plain PyTorch, pass for pass as
    ``kernel_stream``, for any decode pass: ``decode_pass(prior, cw, lv2c)
    -> (posterior, lv2c_new)``, ``converged(posterior)`` (bool ``[B]``),
    ``bit_errors(posterior, cw)`` (bool ``[nc, B]``) and ``reload(x)``, the
    first messages of a reloaded lane from its pool values gathered at the
    CN-space slots (the values themselves when None).  Starts are granted
    in lane order (an inclusive scan against ``remaining``)."""
    sdc = tables.code
    is_tx = torch.zeros(sdc.nc, dtype=torch.bool, device=llr.device)
    is_tx[sdc.bit_pos.long()] = True
    refill_on = refill != 0
    for _ in range(k):
        # ---- reload idle lanes from the pool, within the quota
        eligible = refill_on & (done != 0) & (avail != 0)
        rs = eligible & (torch.cumsum(eligible.to(torch.int32), 0) <= remaining)
        remaining -= rs.sum().to(torch.int32)
        llr.copy_(torch.where(rs, fresh_llr, llr))
        cw.copy_(torch.where(rs, fresh_cw, cw))
        first = fresh_llr.index_select(0, sdc.col_sorted)
        lv2c.copy_(torch.where(rs, first if reload is None else reload(first), lv2c))
        r = rs.to(torch.int32)
        done.mul_(1 - r)
        age.copy_(torch.where(rs, 1, age))
        iters.mul_(1 - r)
        avail.sub_(r)
        ctr[4] += r
        # ---- one decode pass over the lanes in flight
        active = done == 0
        post, lv2c_new = decode_pass(llr, cw, lv2c)
        checking = active & (age >= 1)
        ok = converged(post)
        iters += (checking & ~ok).to(torch.int32)
        age += active.to(torch.int32)
        finished = active & ((checking & ok) | (age >= cap + 1))
        f = finished.to(torch.int32)
        done += f
        biterr = (bit_errors(post, cw) & is_tx[:, None]).sum(0, dtype=torch.int32)
        ctr[0] += f * biterr
        ctr[1] += f * (biterr > 0).to(torch.int32)
        ctr[2] += f
        ctr[3] += f * iters
        lv2c.copy_(torch.where(active, lv2c_new, lv2c))


def bp_stream_chunk_fused_plain(
    tables, llr, cw, lv2c, done, iters, age, avail, ctr, fresh_llr, fresh_cw,
    refill, remaining, *, k: int, cap: int, minsum_mode=False, message_dtype: str = "float32",
    quant_scale: float = DEFAULT_QUANT_SCALE,
) -> None:
    """Plain version of :func:`bp_stream_chunk_fused`: the plain chunk with
    the BP pass in the message form, the syndrome of the stored
    posterior's ``<= 0`` decisions, and reloads of ``store(prior(x))``."""
    sdc = tables.code
    form = MessageForm(message_dtype, quant_scale)
    form.check_cn_mode(minsum_mode, "int8 streaming")
    stream_chunk_plain(
        tables, llr, cw, lv2c, done, iters, age, avail, ctr, fresh_llr, fresh_cw, refill,
        remaining, k, cap,
        decode_pass=lambda prior, _cw, msgs: bp_pass(sdc, prior, msgs, minsum_mode, form),
        converged=lambda post: syndrome_ok_from_posterior(
            sdc, form.load(post).index_select(0, sdc.col_sorted)),
        bit_errors=lambda post, cw_: (form.load(post) <= 0) != (cw_ != 0),
        reload=lambda x: form.store(form.prior(x)),
    )


def bp_stream_chunk_fused(
    tables: KernelTables,
    llr: torch.Tensor,  # f32 [nc, B] carried channel LLRs
    cw: torch.Tensor,  # u8 [nc, B] carried true codewords
    lv2c: torch.Tensor,  # [nnz, B] carried messages (CN-space slots), in message_dtype
    done: torch.Tensor,  # i32 [B] lane idle (finished or empty)
    iters: torch.Tensor,  # i32 [B]
    age: torch.Tensor,  # i32 [B] passes since (re)load
    avail: torch.Tensor,  # i32 [B] pool entry unused
    ctr: torch.Tensor,  # i32 [5, B] counters
    fresh_llr: torch.Tensor,  # f32 [nc, B] fresh-frame pool
    fresh_cw: torch.Tensor,  # u8 [nc, B]
    refill: torch.Tensor,  # i32 [1]: reloads allowed
    remaining: torch.Tensor,  # i32 [1]: starts left in the quota
    *,
    k: int,
    cap: int,
    minsum_mode=False,
    message_dtype: str = "float32",
    quant_scale: float = DEFAULT_QUANT_SCALE,
) -> None:
    """``k`` self-refilling BP passes per lane, updating the state in place.

    Per pass and lane: an idle lane (``done``) with an unused pool entry
    (``avail``) starts that entry if the quota allows (``remaining`` is
    decremented per start; lv2c starts at the prior, ``age = 1``); then a
    lane in flight runs one BP pass, checks its syndrome once ``age >= 1``,
    and finishes on convergence or at ``age >= cap + 1``, adding its
    transmitted-bit errors, a frame error, a frame and its iteration count
    to ``ctr`` rows 0-3 (row 4 counts starts).  On CUDA the quota is one
    device counter taken with ``atomicSub``: which lanes start differs from
    the plain version's lane order, the number that start does not.  The
    kernel's form (a block's frames on chip for the chunk, or every plane in
    device memory) follows :func:`stream_form`; both leave the same state.

    The messages ``lv2c`` are stored in ``message_dtype`` (a reload stores
    ``store(prior(x))``, as the batch decode starts); the carried LLRs and
    the pool stay raw float32, as in ``bp_stream_chunk_pallas``.  int8
    takes a min-sum-family ``minsum_mode`` only."""
    form = MessageForm(message_dtype, quant_scale)
    form.check_cn_mode(minsum_mode, "int8 streaming")
    sdc = tables.code
    nc, nnz = sdc.nc, sdc.nnz
    B = llr.shape[1] if llr.dim() == 2 else -1
    dev = tables.device
    for name, t, dtype, shape in (
        ("llr", llr, torch.float32, (nc, B)), ("cw", cw, torch.uint8, (nc, B)),
        ("lv2c", lv2c, form.torch_dtype, (nnz, B)), ("done", done, torch.int32, (B,)),
        ("iters", iters, torch.int32, (B,)), ("age", age, torch.int32, (B,)),
        ("avail", avail, torch.int32, (B,)), ("ctr", ctr, torch.int32, (5, B)),
        ("fresh_llr", fresh_llr, torch.float32, (nc, B)),
        ("fresh_cw", fresh_cw, torch.uint8, (nc, B)),
        ("refill", refill, torch.int32, (1,)), ("remaining", remaining, torch.int32, (1,)),
    ):
        _check(t, name, dtype, shape, dev)
    if k < 1 or cap < 1:
        raise ValueError(f"k ({k}) and cap ({cap}) must be >= 1")
    if llr.device.type == "cpu":
        return bp_stream_chunk_fused_plain(
            tables, llr, cw, lv2c, done, iters, age, avail, ctr, fresh_llr,
            fresh_cw, refill, remaining, k=k, cap=cap, minsum_mode=minsum_mode,
            message_dtype=message_dtype, quant_scale=quant_scale,
        )
    _require_cuda(llr)
    lib = build.load()
    mode, scale, offset = cn_mode_args(form.cn_mode(minsum_mode))
    frames, stage = stream_form(tables, form.dtype)
    state = (_p(llr), _p(cw), _p(lv2c), _p(done), _p(iters), _p(age), _p(avail), _p(ctr),
             _p(fresh_llr), _p(fresh_cw), _p(refill), _p(remaining))
    code = (_p(tables.row_ptr), _p(tables.col_sorted), _p(tables.vn_ptr), _p(tables.perm_c2v),
            _p(tables.bit_pos), nc, sdc.mc, nnz, sdc.nct, B, k, cap, mode, scale, offset,
            form.code, form.inv_q)
    stream = ctypes.c_void_p(torch.cuda.current_stream(llr.device).cuda_stream)
    if frames == 0:
        lc2v = torch.empty((nnz, B), dtype=form.torch_dtype, device=llr.device)
        post = torch.empty((nc, B), dtype=form.torch_dtype, device=llr.device)
        err = lib.ldpc_bp_stream_chunk_fused(*state, _p(lc2v), _p(post), *code, stream)
    else:
        entry = {16: lib.ldpc_bp_stream_chunk_tile16, 8: lib.ldpc_bp_stream_chunk_tile8,
                 4: lib.ldpc_bp_stream_chunk_tile4}[frames]
        err = entry(*state, *code, int(stage), stream)
    _raise_on(lib, err, "bp_stream_chunk_fused")
    bp_stream_chunk_fused.launches[form.dtype] += 1
    bp_stream_chunk_fused.last_form = (frames, stage)


bp_stream_chunk_fused.launches = dict.fromkeys(DTYPE_CODES, 0)
#: ``(frames, stage)`` of the last launch (:func:`stream_form`)
bp_stream_chunk_fused.last_form = None
