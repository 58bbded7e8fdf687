"""The two BEC peeling kernels, their wrappers and their plain versions.

* :func:`bec_decode_fused` runs ``csrc/decode_bec.cu``'s batch kernel, the
  port of ``libldpc_tpu/ops/pallas/decode_lanes.py`` ``kernel`` in its BEC
  form (reached there through ``bec_decode_lanes``): the whole peeling
  decode of a batch in one launch, with per-frame early termination.
* :func:`bec_stream_chunk_fused` runs its streaming kernel, the port of
  ``kernel_stream`` in its BEC form (``bp_stream_chunk_lanes`` with
  ``bec_mode``): ``k`` self-refilling passes per lane.

Both run the exact 3-state algebra of :mod:`..bec_sorted` (the TPU
kernels run it as min-sum over a sign encoding), so they are bit-exact
against their plain versions.  Both run it bit-sliced, 32 frames to a
word (:func:`..bec_sorted.bec_words_pass` is that algebra in plain
PyTorch).  The batch kernel keeps a block's whole state in shared memory,
or in a device-memory scratch for a code whose state does not fit
(:func:`words_in_shared`).  The streaming kernel's word form
(``csrc/bec_stream_words.cuh``; :func:`..bec_sorted.bec_stream_chunk_words`
models it) packs a block's 32 frames from the carried u8 planes into words
in shared memory for the whole chunk and unpacks them at exit; for a code
whose words do not fit it runs its byte form, on u8 planes in device
memory, on the chunk the BP stream kernel's HBM-plane form uses
(``csrc/stream_chunk.cuh``).  :func:`bec_stream_form` chooses, by size
only.  ``degree1_stale_byte`` (None, or the byte 0-1 of the reference's
bug-compatible mode) is passed to the kernels as ``-1`` or the byte.

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.  Each keeps a launch count,
``<wrapper>.launches``, raised by one at every kernel launch and nowhere
else.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..bec import BECDecodeOutput
from ..bec_sorted import bec_decode_sorted, bec_pass, wrong_bits
from ..channel import BEC_ERASURE
from . import build
from .decode_fused import (
    SMEM_BLOCK_BYTES, _check, _p, _raise_on, _require_cuda, stream_chunk_plain,
)
from .layout import KernelTables


#: Keep the batch kernel's state in the device-memory scratch whatever the
#: code's size (the card tests do, to run that form on a small code).
FORCE_SCRATCH = False
#: Run the streaming kernel's byte form whatever the code's size (the card
#: tests and the smoke run do, to hold and time both forms).
FORCE_BYTES = False


def words_state_bytes(tables: KernelTables) -> int:
    """Bytes of state the word kernels (the batch kernel and the streaming
    kernel's word form) keep per 32-frame word: channel, codeword and
    posterior words per variable, a message word pair per slot
    (``csrc/decode_bec.cu`` ``BecWords``)."""
    return (4 * tables.code.nc + 2 * tables.code.nnz) * 4


def words_in_shared(tables: KernelTables) -> bool:
    """The batch kernel's size rule: the state of a word lives in shared
    memory when it fits one block's, else in a device-memory scratch."""
    return not FORCE_SCRATCH and words_state_bytes(tables) <= SMEM_BLOCK_BYTES


def bec_stream_form(tables: KernelTables) -> str:
    """The streaming kernel's size rule: ``"words"`` (a block's 32 frames
    as words in shared memory for the chunk) when a word's state fits one
    block's shared memory, else ``"bytes"`` (u8 planes in device memory)."""
    fits = words_state_bytes(tables) <= SMEM_BLOCK_BYTES
    return "words" if fits and not FORCE_BYTES else "bytes"


def _stale_arg(degree1_stale_byte: Optional[int]) -> int:
    if degree1_stale_byte is None:
        return -1
    if degree1_stale_byte not in (0, 1):
        raise ValueError(f"degree1_stale_byte must be None, 0 or 1, not {degree1_stale_byte!r}")
    return int(degree1_stale_byte)


def _no_pass_output(symbols_in, codeword, degree1_stale_byte) -> BECDecodeOutput:
    """``iterations == 0``, as ``bec_decode_lanes`` returns it: the channel
    symbols, zero iterations, resolved where nothing is erased."""
    unresolved = symbols_in == BEC_ERASURE
    return BECDecodeOutput(
        symbols_out=symbols_in.clone(),
        hard=torch.where(unresolved, wrong_bits(codeword, degree1_stale_byte), codeword),
        iterations=torch.zeros(symbols_in.shape[1], dtype=torch.int32, device=symbols_in.device),
        resolved=~unresolved.any(0),
    )


def bec_decode_fused_plain(
    tables: KernelTables,
    symbols_in: torch.Tensor,
    codeword: torch.Tensor,
    iterations: int = 50,
    early_term: bool = True,
    degree1_stale_byte: Optional[int] = None,
) -> BECDecodeOutput:
    """Plain version of :func:`bec_decode_fused`: the sorted peeling
    decoder, with ``bec_decode_lanes``'s output at ``iterations == 0``."""
    if iterations == 0:
        return _no_pass_output(symbols_in, codeword, degree1_stale_byte)
    return bec_decode_sorted(tables.code, symbols_in, codeword, iterations, early_term,
                             degree1_stale_byte)


def bec_decode_fused(
    tables: KernelTables,
    symbols_in: torch.Tensor,  # u8 [nc, B] {0, 1, BEC_ERASURE}, sorted VN labelling
    codeword: torch.Tensor,  # u8 [nc, B] true codeword, sorted VN labelling
    iterations: int = 50,
    early_term: bool = True,
    degree1_stale_byte: Optional[int] = None,
) -> BECDecodeOutput:
    """BEC peeling decode of a batch, all iterations in one kernel launch.

    Same outputs as :func:`..bec_sorted.bec_decode_sorted`: posterior
    symbols, decisions (the wrong bit where unresolved), break-before-
    increment ``iterations`` and ``resolved``; with ``early_term=False``
    every frame reports the cap and ``resolved`` comes from the last pass.
    ``iterations == 0`` runs no pass (module docstring of the plain
    version).  Any ``B``: the last block is masked."""
    nc = tables.code.nc
    B = symbols_in.shape[1] if symbols_in.dim() == 2 else -1
    _check(symbols_in, "symbols_in", torch.uint8, (nc, B), tables.device)
    _check(codeword, "codeword", torch.uint8, (nc, B), tables.device)
    stale = _stale_arg(degree1_stale_byte)
    if iterations == 0:
        return _no_pass_output(symbols_in, codeword, degree1_stale_byte)
    if symbols_in.device.type == "cpu":
        return bec_decode_fused_plain(tables, symbols_in, codeword, iterations, early_term,
                                      degree1_stale_byte)
    _require_cuda(symbols_in)
    lib = build.load()
    dev = symbols_in.device
    nnz = tables.code.nnz
    sym_out = torch.empty_like(symbols_in)
    hard = torch.empty_like(symbols_in)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    resolved = torch.empty(B, dtype=torch.int32, device=dev)
    in_shared = words_in_shared(tables)
    scratch = None if in_shared else torch.empty(
        ((B + 31) // 32, words_state_bytes(tables) // 4), dtype=torch.int32, device=dev)
    err = lib.ldpc_bec_decode_fused(
        _p(symbols_in), _p(codeword), _p(sym_out), _p(hard), _p(iters), _p(resolved),
        None if in_shared else _p(scratch), _p(tables.row_ptr), _p(tables.col_sorted),
        _p(tables.vn_ptr), _p(tables.perm_c2v), nc, tables.code.mc, nnz, B, iterations,
        int(bool(early_term)), stale,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _raise_on(lib, err, "bec_decode_fused")
    bec_decode_fused.launches += 1
    bec_decode_fused.last_in_shared = in_shared
    return BECDecodeOutput(symbols_out=sym_out, hard=hard, iterations=iters,
                           resolved=resolved > 0)


bec_decode_fused.launches = 0
#: whether the last launch kept its state in shared memory (:func:`words_in_shared`)
bec_decode_fused.last_in_shared = None


def bec_stream_chunk_fused_plain(
    tables, sym, cw, lv2c, done, iters, age, avail, ctr, fresh_sym, fresh_cw,
    refill, remaining, *, k: int, cap: int, degree1_stale_byte: Optional[int] = None,
) -> None:
    """Plain version of :func:`bec_stream_chunk_fused`: the plain chunk
    with the peeling pass; a frame converges when no posterior is erased,
    and its bit errors are its unresolved transmitted bits (in the
    bug-compatible mode, those whose constant decision 1 is wrong)."""
    sdc = tables.code
    stream_chunk_plain(
        tables, sym, cw, lv2c, done, iters, age, avail, ctr, fresh_sym, fresh_cw, refill,
        remaining, k, cap,
        decode_pass=lambda prior, cw_, msgs: bec_pass(sdc, prior, cw_, msgs, degree1_stale_byte),
        converged=lambda post: ~(post == BEC_ERASURE).any(0),
        bit_errors=lambda post, cw_: (post == BEC_ERASURE) & (
            wrong_bits(cw_, degree1_stale_byte) != cw_),
    )


def bec_stream_chunk_fused(
    tables: KernelTables,
    sym: torch.Tensor,  # u8 [nc, B] carried channel symbols
    cw: torch.Tensor,  # u8 [nc, B] carried true codewords
    lv2c: torch.Tensor,  # u8 [nnz, B] carried messages (CN-space slots)
    done: torch.Tensor,  # i32 [B] lane idle (finished or empty)
    iters: torch.Tensor,  # i32 [B]
    age: torch.Tensor,  # i32 [B] passes since (re)load
    avail: torch.Tensor,  # i32 [B] pool entry unused
    ctr: torch.Tensor,  # i32 [5, B] counters
    fresh_sym: torch.Tensor,  # u8 [nc, B] fresh-frame pool (symbols)
    fresh_cw: torch.Tensor,  # u8 [nc, B]
    refill: torch.Tensor,  # i32 [1]: reloads allowed
    remaining: torch.Tensor,  # i32 [1]: starts left in the quota
    *,
    k: int,
    cap: int,
    degree1_stale_byte: Optional[int] = None,
) -> None:
    """``k`` self-refilling peeling passes per lane, updating the state in
    place, with the reload, quota and counters of
    :func:`.decode_fused.bp_stream_chunk_fused`; a lane finishes when its
    frame is resolved or at ``age >= cap + 1``.  The pool holds symbols,
    not LLRs.  On CUDA the quota is one device counter taken with
    ``atomicSub`` (once a word in the word form, granted in lane order
    within the word): which lanes start differs from the plain version's
    lane order, the number that start does not.  The form is
    :func:`bec_stream_form`'s; the word form allocates nothing."""
    sdc = tables.code
    nc, nnz = sdc.nc, sdc.nnz
    B = sym.shape[1] if sym.dim() == 2 else -1
    dev = tables.device
    for name, t, dtype, shape in (
        ("sym", sym, torch.uint8, (nc, B)), ("cw", cw, torch.uint8, (nc, B)),
        ("lv2c", lv2c, torch.uint8, (nnz, B)), ("done", done, torch.int32, (B,)),
        ("iters", iters, torch.int32, (B,)), ("age", age, torch.int32, (B,)),
        ("avail", avail, torch.int32, (B,)), ("ctr", ctr, torch.int32, (5, B)),
        ("fresh_sym", fresh_sym, torch.uint8, (nc, B)),
        ("fresh_cw", fresh_cw, torch.uint8, (nc, B)),
        ("refill", refill, torch.int32, (1,)), ("remaining", remaining, torch.int32, (1,)),
    ):
        _check(t, name, dtype, shape, dev)
    if k < 1 or cap < 1:
        raise ValueError(f"k ({k}) and cap ({cap}) must be >= 1")
    stale = _stale_arg(degree1_stale_byte)
    if sym.device.type == "cpu":
        return bec_stream_chunk_fused_plain(
            tables, sym, cw, lv2c, done, iters, age, avail, ctr, fresh_sym, fresh_cw, refill,
            remaining, k=k, cap=cap, degree1_stale_byte=degree1_stale_byte,
        )
    _require_cuda(sym)
    lib = build.load()
    state = (_p(sym), _p(cw), _p(lv2c), _p(done), _p(iters), _p(age), _p(avail), _p(ctr),
             _p(fresh_sym), _p(fresh_cw), _p(refill), _p(remaining))
    tabs = (_p(tables.row_ptr), _p(tables.col_sorted), _p(tables.vn_ptr), _p(tables.perm_c2v),
            _p(tables.bit_pos), nc, sdc.mc, nnz, sdc.nct, B, k, cap, stale,
            ctypes.c_void_p(torch.cuda.current_stream(sym.device).cuda_stream))
    form = bec_stream_form(tables)
    if form == "words":
        err = lib.ldpc_bec_stream_chunk_words(*state, *tabs)
    else:
        lc2v = torch.empty((nnz, B), dtype=torch.uint8, device=sym.device)
        post = torch.empty((nc, B), dtype=torch.uint8, device=sym.device)
        err = lib.ldpc_bec_stream_chunk_fused(*state, _p(lc2v), _p(post), *tabs)
    _raise_on(lib, err, "bec_stream_chunk_fused")
    bec_stream_chunk_fused.launches += 1
    bec_stream_chunk_fused.last_form = form


bec_stream_chunk_fused.launches = 0
#: the form of the last launch, ``"words"`` or ``"bytes"`` (:func:`bec_stream_form`)
bec_stream_chunk_fused.last_form = None
