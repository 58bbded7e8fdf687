"""The BEC peeling decoder over the degree-class-sorted layout, in plain
PyTorch (from :mod:`libldpc_tpu.ops.bec_sorted`).

Messages are u8 symbols of the 3-state alphabet ``{0, 1, BEC_ERASURE}``
in the sorted layout's CN-space slots.  Per flooding iteration:

* check update: an outgoing message is an erasure if any *other* input of
  the check is erased, else the XOR of the others; a degree-1 check emits
  0 (its empty XOR: it pins its bit to 0);
* variable update, given the true bit ``xi`` (over a BEC a known symbol is
  the true bit, so the decoder is handed the codeword, as the reference's
  is): a channel-known bit sends ``xi`` on every edge and is its own
  posterior; an erased bit sends ``xi`` on an edge if any *other* incoming
  message equals ``xi``, else an erasure, and its posterior is ``xi`` if
  any incoming message equals ``xi``.  A degree-1 variable's posterior is
  its raw incoming message and it sends an erasure (or, in the
  reference's bug-compatible mode, the stale byte ``degree1_stale_byte``);
  a degree-0 variable keeps its channel symbol.

A frame is resolved when none of its ``nc`` posteriors is an erasure;
early termination freezes it there, with the break-before-increment
iteration count of the BP decoders.  An unresolved bit decides the wrong
bit ``1 - cw`` (a constant 1 in the bug-compatible mode, as the
reference's GF(2) negation gives), so its frame counts as errored.

Deliberate difference from the JAX package: there a degree-0 variable
(an empty column of H) reports an erasure even when the channel knows it,
and the node offset of every later class is not advanced; here it keeps
its channel symbol and the offset advances (the reference's behaviour).
The counting is integer throughout, so this decoder, the CUDA kernel and
the JAX decoders agree bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from .bec import BECDecodeOutput
from .channel import BEC_ERASURE
from .sorted import TorchSortedCode, _class_slices


def bec_cn_update(sdc: TorchSortedCode, lv2c: torch.Tensor) -> torch.Tensor:
    """Check update ``[nnz, B] -> [nnz, B]`` (u8, CN-space slots), from each
    check's erasure count and XOR."""
    parts = []
    for e0, e1, count, d in _class_slices(sdc.cn_classes):
        if d == 0:
            continue
        M = lv2c[e0:e1].reshape(count, d, -1)
        if d == 1:
            parts.append(torch.zeros_like(M).reshape(count, -1))
            continue
        erased = M == BEC_ERASURE
        n_erased = erased.sum(1, keepdim=True, dtype=torch.int32)
        known = torch.where(erased, 0, M)
        parity = known.sum(1, keepdim=True, dtype=torch.int32) & 1
        out = torch.where(n_erased - erased.to(torch.int32) > 0, BEC_ERASURE,
                          (parity ^ known).to(torch.uint8))
        parts.append(out.reshape(count * d, -1))
    return torch.cat(parts, dim=0)


def bec_vn_update(
    sdc: TorchSortedCode,
    symbols_in: torch.Tensor,  # u8 [nc, B]
    xi: torch.Tensor,  # u8 [nc, B] true bits
    lc2v_v: torch.Tensor,  # u8 [nnz, B] check messages, VN-space slots
    degree1_stale_byte: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Variable update: ``(lv2c [nnz, B] in VN-space slots, posterior
    symbols [nc, B])``."""
    lv2c_parts = []
    post_parts = []
    n0 = 0
    for e0, e1, count, d in _class_slices(sdc.vn_classes):
        sym = symbols_in[n0:n0 + count]
        x = xi[n0:n0 + count]
        n0 += count
        known = sym != BEC_ERASURE
        if d == 0:
            post_parts.append(torch.where(known, x, BEC_ERASURE).to(torch.uint8))
            continue
        M = lc2v_v[e0:e1].reshape(count, d, -1)
        if d == 1:
            post = M[:, 0]
            fill = BEC_ERASURE if degree1_stale_byte is None else int(degree1_stale_byte)
            excl = torch.full_like(M, fill)
        else:
            match = (M == x[:, None]).to(torch.int32)
            n_match = match.sum(1, keepdim=True)
            excl = torch.where(n_match - match > 0, x[:, None], BEC_ERASURE).to(torch.uint8)
            post = torch.where(n_match[:, 0] > 0, x, BEC_ERASURE).to(torch.uint8)
        lv2c_parts.append(torch.where(known[:, None], x[:, None], excl).reshape(count * d, -1))
        post_parts.append(torch.where(known, x, post))
    return torch.cat(lv2c_parts, dim=0), torch.cat(post_parts, dim=0)


def bec_pass(sdc: TorchSortedCode, symbols_in: torch.Tensor, xi: torch.Tensor,
             lv2c: torch.Tensor, degree1_stale_byte: Optional[int] = None):
    """One flooding iteration: ``(posterior [nc, B], lv2c_new [nnz, B])``,
    messages in CN-space slots."""
    lc2v = bec_cn_update(sdc, lv2c)
    lv2c_v, post = bec_vn_update(sdc, symbols_in, xi, lc2v.index_select(0, sdc.perm_c2v),
                                 degree1_stale_byte)
    lv2c_new = torch.empty_like(lv2c)
    lv2c_new[sdc.perm_c2v.long()] = lv2c_v
    return post, lv2c_new


def wrong_bits(codeword: torch.Tensor, degree1_stale_byte: Optional[int]) -> torch.Tensor:
    """The decision of an unresolved bit: ``1 - cw``, or the constant 1 of
    the bug-compatible mode."""
    if degree1_stale_byte is not None:
        return torch.ones_like(codeword)
    return 1 - codeword


def bec_decode_sorted(
    sdc: TorchSortedCode,
    symbols_in: torch.Tensor,  # u8 [nc, B], sorted VN labelling
    codeword: torch.Tensor,  # u8 [nc, B], sorted VN labelling
    iterations: int = 50,
    early_term: bool = True,
    degree1_stale_byte: Optional[int] = None,
) -> BECDecodeOutput:
    """Flooding peeling decode of a batch (module docstring).  With no
    pass run (``iterations == 0``) every posterior is an erasure, as in
    the JAX decoder."""
    B = symbols_in.shape[1]
    dev = symbols_in.device
    lv2c = symbols_in.index_select(0, sdc.col_sorted)
    sym_out = torch.full_like(symbols_in, BEC_ERASURE)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    for _ in range(iterations):
        if bool(done.all()):
            break
        post, new = bec_pass(sdc, symbols_in, codeword, lv2c, degree1_stale_byte)
        if early_term:
            finished = ~done & ~(post == BEC_ERASURE).any(0)
        else:
            finished = torch.zeros_like(done)
        keep = done[None, :]
        lv2c = torch.where(keep, lv2c, new)
        sym_out = torch.where(keep, sym_out, post)
        iters += (~done & ~finished).to(torch.int32)
        done |= finished
    unresolved = sym_out == BEC_ERASURE
    return BECDecodeOutput(
        symbols_out=sym_out,
        hard=torch.where(unresolved, wrong_bits(codeword, degree1_stale_byte), codeword),
        iterations=iters,
        resolved=~unresolved.any(0),
    )
