"""Batched belief-propagation decoding over the padded layout, flooding and
layered (from :mod:`libldpc_tpu.ops.decoder`).

The library's decode entry point on a :class:`~.device.DeviceCode`:
frames on the last axis (``[nc, B]`` LLRs in the code's own labelling),
the CN update a reshape to ``[mc, max_dc, B]`` and the exclusion combine,
the VN update a masked gather-sum (``LLROut = LLRIn + sum Lc2v``) and the
extrinsic subtraction (``Lv2c = LLROut[col] - Lc2v``), per-frame early
termination that freezes a converged frame, and the reference's
break-before-increment iteration counts (a frame whose first pass already
gives a codeword reports 0; one that never converges reports
``iterations``).  Padding slots carry :data:`~.device.PAD_LLR`, the
combine's identity.

On the CPU :func:`bp_decode` runs the plain padded decoder
(:func:`bp_decode_plain`, a line-for-line torch version of the JAX
decoder).  On a CUDA ``DeviceCode`` it runs the CUDA kernels on the code's
sorted layout: K1 (:func:`.kernels.decode_fused.bp_decode_fused`) for
flooding, K5 (:func:`.kernels.decode_layered.bp_decode_layered`, the exact
layered schedule) for ``layered=True`` with two or more layers; the rows
are permuted into the sorted labelling and the outputs back, so they stay
in the code's labelling.  Both compute the same schedule: bit for bit in
the min-sum family, to float32 rounding in the sum-product forms (whose
``log``/``exp`` differ between the CPU and the card).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cn_ops
from .device import PAD_LLR, DeviceCode


class DecodeOutput(NamedTuple):
    llr_out: torch.Tensor  # f32 [nc, B] posterior LLRs
    hard: torch.Tensor  # bool [nc, B] hard decisions (LLROut <= 0)
    iterations: torch.Tensor  # int32 [B] per-frame iteration count
    is_codeword: torch.Tensor  # bool [B] final syndrome check


def _extend(x: torch.Tensor, fill) -> torch.Tensor:
    """Append one dummy row (for the padding slots and sentinels)."""
    return torch.cat([x, torch.full((1,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                                    device=x.device)], dim=0)


def init_messages(dcode: DeviceCode, llr_in: torch.Tensor) -> torch.Tensor:
    """``Lv2c[e] = LLRIn[col(e)]``; padding slots get ``PAD_LLR``."""
    return _extend(llr_in, PAD_LLR).index_select(0, dcode.pad_col)


def cn_update(dcode: DeviceCode, lv2c: torch.Tensor, minsum_mode) -> torch.Tensor:
    """Check-node update: ``[E, B] -> [E, B]`` extrinsic messages."""
    M = lv2c.reshape(dcode.mc, dcode.max_dc, -1)
    return cn_ops.cn_postprocess(cn_ops.exclusion(M, minsum_mode).reshape(dcode.E, -1),
                                 minsum_mode)


def vn_update(dcode: DeviceCode, llr_in: torch.Tensor, lc2v: torch.Tensor):
    """Variable-node / APP update: ``(llr_out [nc, B], hard [nc, B], lv2c
    [E, B])``.  A variable's messages are summed left to right in file
    order (the JAX decoder's sum), then added to its prior."""
    gathered = _extend(lc2v, 0.0).index_select(0, dcode.vn_edges.reshape(-1)).reshape(
        dcode.nc, dcode.max_dv, -1)
    masked = torch.where(dcode.vn_mask[:, :, None], gathered, 0.0)
    sums = masked[:, 0]
    for j in range(1, dcode.max_dv):
        sums = sums + masked[:, j]
    llr_out = llr_in + sums
    lv2c = _extend(llr_out, PAD_LLR).index_select(0, dcode.pad_col) - lc2v
    return llr_out, llr_out <= 0, lv2c


def syndrome_ok(dcode: DeviceCode, hard: torch.Tensor) -> torch.Tensor:
    """Per-frame ``is_codeword``: the parity of every check row of the
    bool ``[nc, B]`` decisions is even.  bool ``[B]``."""
    bits = _extend(hard.to(torch.int32), 0).index_select(0, dcode.pad_col).reshape(
        dcode.mc, dcode.max_dc, -1)
    return ~((bits.sum(dim=1) % 2) != 0).any(dim=0)


def _layered(dcode: DeviceCode, layered: bool) -> bool:
    return layered and dcode.layer_masks is not None and dcode.layer_masks.shape[0] > 1


def bp_decode_plain(
    dcode: DeviceCode,
    llr_in: torch.Tensor,
    iterations: int = 50,
    early_term: bool = True,
    minsum_mode=False,
    layered: bool = False,
) -> DecodeOutput:
    """The plain padded decoder (on any device): the JAX decoder's
    flooding schedule, or with ``layered`` and two or more layer masks its
    layered schedule."""
    if _layered(dcode, layered):
        return _bp_decode_layered(dcode, llr_in, iterations, early_term, minsum_mode)
    return _bp_decode_flooding(dcode, llr_in, iterations, early_term, minsum_mode)


def _bp_decode_flooding(dcode, llr_in, iterations, early_term, minsum_mode) -> DecodeOutput:
    B = llr_in.shape[1]
    dev = llr_in.device
    lv2c = init_messages(dcode, llr_in)
    llr_out = torch.zeros_like(llr_in)
    hard = torch.zeros(llr_in.shape, dtype=torch.bool, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    for _ in range(iterations):
        if bool(done.all()):
            break
        lc2v = cn_update(dcode, lv2c, minsum_mode)
        llr_out_i, hard_i, lv2c_i = vn_update(dcode, llr_in, lc2v)
        finished_now = (~done & syndrome_ok(dcode, hard_i)) if early_term else torch.zeros_like(done)
        keep = done[None, :]
        lv2c = torch.where(keep, lv2c, lv2c_i)
        llr_out = torch.where(keep, llr_out, llr_out_i)
        hard = torch.where(keep, hard, hard_i)
        iters += (~done & ~finished_now).to(torch.int32)
        done = done | finished_now
    return DecodeOutput(llr_out=llr_out, hard=hard, iterations=iters,
                        is_codeword=syndrome_ok(dcode, hard))


def _bp_decode_layered(dcode, llr_in, iterations, early_term, minsum_mode) -> DecodeOutput:
    """Layered schedule: per iteration the CN update runs layer by layer,
    with the APP recomputed after every layer; early termination is
    checked after each layer and the counter advances on completed full
    iterations (a frame unconverged at the start and at the end)."""
    B = llr_in.shape[1]
    dev = llr_in.device
    layer_edges = torch.repeat_interleave(dcode.layer_masks, dcode.max_dc, dim=1)  # [nl, E]
    lv2c = init_messages(dcode, llr_in)
    lc2v = torch.zeros((dcode.E, B), dtype=llr_in.dtype, device=dev)
    llr_out = torch.zeros_like(llr_in)
    hard = torch.zeros(llr_in.shape, dtype=torch.bool, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    for _ in range(iterations):
        if bool(done.all()):
            break
        done_start = done
        for mask in layer_edges:
            lc2v_l = torch.where(mask[:, None], cn_update(dcode, lv2c, minsum_mode), lc2v)
            llr_out_l, hard_l, lv2c_l = vn_update(dcode, llr_in, lc2v_l)
            finished_now = ((~done & syndrome_ok(dcode, hard_l)) if early_term
                            else torch.zeros_like(done))
            keep = done[None, :]
            lv2c = torch.where(keep, lv2c, lv2c_l)
            lc2v = torch.where(keep, lc2v, lc2v_l)
            llr_out = torch.where(keep, llr_out, llr_out_l)
            hard = torch.where(keep, hard, hard_l)
            done = done | finished_now
        iters += (~done_start & ~done).to(torch.int32)
    return DecodeOutput(llr_out=llr_out, hard=hard, iterations=iters,
                        is_codeword=syndrome_ok(dcode, hard))


def bp_decode(
    dcode: DeviceCode,
    llr_in: torch.Tensor,
    iterations: int = 50,
    early_term: bool = True,
    minsum_mode=False,
    layered: bool = False,
) -> DecodeOutput:
    """Decode a batch: ``llr_in`` float32 ``[nc, B]`` in the code's
    labelling, on ``dcode``'s device.  ``minsum_mode`` is the legacy bool,
    a decoder-type string or a ``(type, scale, offset)`` tuple, as
    :mod:`.cn_ops` takes it.  On the CPU (or with no pass to run) the plain
    padded decoder; on CUDA K1 (flooding) or K5 (``layered`` with two or
    more layer masks) on the sorted layout, the rows permuted in and out."""
    if llr_in.device.type == "cpu" or iterations == 0:
        return bp_decode_plain(dcode, llr_in, iterations, early_term, minsum_mode, layered)
    from .kernels.decode_fused import _require_cuda, bp_decode_fused
    from .kernels.decode_layered import bp_decode_layered

    _require_cuda(llr_in)
    if dcode._tables is None:
        raise ValueError("a CUDA decode needs a DeviceCode built by to_device on a CUDA device")
    kernel = bp_decode_layered if _layered(dcode, layered) else bp_decode_fused
    out = kernel(dcode._tables, llr_in.index_select(0, dcode._vn_perm), iterations, early_term,
                 minsum_mode)
    llr_out = out.llr_out.index_select(0, dcode._vn_inv)
    return DecodeOutput(llr_out=llr_out, hard=llr_out <= 0, iterations=out.iterations,
                        is_codeword=out.is_codeword)


#: The JAX package's jitted entry point; here the same function (each
#: kernel launch is one call already), kept so that callers carry over.
bp_decode_jit = bp_decode
