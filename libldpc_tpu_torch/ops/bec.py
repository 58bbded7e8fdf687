"""Batched BEC (binary erasure channel) peeling decoder over the padded
layout (from :mod:`libldpc_tpu.ops.bec`).

Masked integer algebra over the 3-state alphabet ``{0, 1, BEC_ERASURE}``:

* CN: ``cn(l, r) = ERASURE if l or r erased else l XOR r``; identity 0,
  used on padding slots;
* VN, given the true bit ``xi``: ``vn(l, r | xi) = xi if (l == xi or r ==
  xi) else ERASURE``; identity ERASURE, used on padding slots.

As in the reference, the decoder receives the true codeword (over a BEC a
non-erased observation is the true bit).  A variable still erased at the
end decides the wrong bit, so its frame counts as errored; early
termination stops a frame when no erasure remains, with the
break-before-increment iteration count of the BP decoder.

**dtype.**  The port's symbols are u8 (``symbols_out`` of
:class:`BECDecodeOutput`, on every device, for every input); the JAX
package's are int8.  The values are the same three, so ``symbols_in`` may
be either: int8 symbols are read as u8.

On the CPU (or with no pass to run) :func:`bec_decode` runs the plain
padded decoder (:func:`bec_decode_plain`, line for line the JAX decoder);
on a CUDA :class:`~.device.DeviceCode` it runs K6
(:func:`.kernels.decode_bec.bec_decode_fused`) on the code's sorted
layout, the rows permuted in and out.  The counting is integer throughout,
so both agree bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .channel import BEC_ERASURE


class BECDecodeOutput(NamedTuple):
    symbols_out: torch.Tensor  # u8 [nc, B] posterior symbols {0, 1, BEC_ERASURE}
    hard: torch.Tensor  # u8 [nc, B] decided bits (the wrong bit where unresolved)
    iterations: torch.Tensor  # int32 [B]
    resolved: torch.Tensor  # bool [B] True when no erasures remain


def as_u8_symbols(symbols: torch.Tensor) -> torch.Tensor:
    """``symbols`` as u8: int8 symbols (the JAX package's) are viewed as u8
    (the three values keep their bits); any other dtype is left for the
    decoders' checks."""
    return symbols.view(torch.uint8) if symbols.dtype == torch.int8 else symbols


def _cn_op(l: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    erased = (l == BEC_ERASURE) | (r == BEC_ERASURE)
    return torch.where(erased, BEC_ERASURE, torch.bitwise_xor(l, r))


def _exclusion_combine(M: torch.Tensor, op):
    """All-but-one combine along axis 1, and the total combine."""
    d = M.shape[1]
    if d == 1:
        return torch.full_like(M, BEC_ERASURE), M[:, 0]
    fwd = [M[:, 0]]
    bwd = [M[:, d - 1]]
    for j in range(1, d):
        fwd.append(op(fwd[-1], M[:, j]))
        bwd.append(op(bwd[-1], M[:, d - 1 - j]))
    out = [bwd[d - 2]]
    for j in range(1, d - 1):
        out.append(op(fwd[j - 1], bwd[d - 2 - j]))
    out.append(fwd[d - 2])
    return torch.stack(out, dim=1), fwd[d - 1]


def bec_decode_plain(
    dcode,
    symbols_in: torch.Tensor,
    codeword: torch.Tensor,
    iterations: int = 50,
    early_term: bool = True,
    degree1_stale_byte: Optional[int] = None,
) -> BECDecodeOutput:
    """The plain padded peeling decoder (on any device); see
    :func:`bec_decode`."""
    symbols_in = as_u8_symbols(symbols_in)
    B = symbols_in.shape[1]
    dev = symbols_in.device
    xi = codeword.to(torch.uint8)
    known = symbols_in != BEC_ERASURE
    deg1 = dcode.vn_mask.sum(dim=1) == 1  # [nc]

    def extend(x, fill):
        return torch.cat([x, torch.full((1, B), fill, dtype=x.dtype, device=dev)], dim=0)

    def vn_op(l, r):
        return torch.where((l == xi) | (r == xi), xi, BEC_ERASURE)

    # Lv2c init = the channel symbol of the slot's variable; 0 on padding
    lv2c = extend(symbols_in, 0).index_select(0, dcode.pad_col)
    sym_out = torch.full((dcode.nc, B), BEC_ERASURE, dtype=torch.uint8, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    for _ in range(iterations):
        if bool(done.all()):
            break
        lc2v, _ = _exclusion_combine(lv2c.reshape(dcode.mc, dcode.max_dc, B), _cn_op)
        lc2v = lc2v.reshape(dcode.E, B)
        gathered = extend(lc2v, BEC_ERASURE).index_select(0, dcode.vn_edges.reshape(-1)).reshape(
            dcode.nc, dcode.max_dv, B)
        gathered = torch.where(dcode.vn_mask[:, :, None], gathered, BEC_ERASURE)
        excl, total = _exclusion_combine(gathered, vn_op)
        # a degree-1 variable's posterior is its single raw incoming message
        total = torch.where(deg1[:, None], gathered[:, 0, :], total)
        if degree1_stale_byte is not None:
            excl = torch.where(deg1[:, None, None],
                               torch.tensor(degree1_stale_byte, dtype=torch.uint8, device=dev),
                               excl)
        lv2c_vnspace = torch.where(known[:, None, :], xi[:, None, :], excl)
        post = torch.where(known, xi, total)
        # back to the padded CN slots; padding slots read the CN identity 0
        vn_flat = extend(lv2c_vnspace.reshape(dcode.nc * dcode.max_dv, B), 0)
        lv2c_new = vn_flat.index_select(0, dcode.edge_vslot)
        finished_now = (~done & ~(post == BEC_ERASURE).any(dim=0)) if early_term \
            else torch.zeros_like(done)
        keep = done[None, :]
        lv2c = torch.where(keep, lv2c, lv2c_new)
        sym_out = torch.where(keep, sym_out, post)
        iters += (~done & ~finished_now).to(torch.int32)
        done = done | finished_now
    unresolved = sym_out == BEC_ERASURE
    # an unresolved bit decides the wrong bit (a constant 1 in the
    # bug-compatible mode, as the reference's GF(2) negation gives)
    wrong = torch.ones_like(xi) if degree1_stale_byte is not None else 1 - xi
    return BECDecodeOutput(
        symbols_out=sym_out,
        hard=torch.where(unresolved, wrong, xi),
        iterations=iters,
        resolved=~unresolved.any(dim=0),
    )


def bec_decode(
    dcode,
    symbols_in: torch.Tensor,  # u8 or int8 [nc, B] channel symbols (BEC_ERASURE for erased)
    codeword: torch.Tensor,  # u8 [nc, B] true codeword
    iterations: int = 50,
    early_term: bool = True,
    degree1_stale_byte: Optional[int] = None,
) -> BECDecodeOutput:
    """Peeling decode of a batch on ``dcode``'s device (module docstring);
    ``symbols_out`` is u8 whether ``symbols_in`` is u8 or int8.

    ``degree1_stale_byte`` emulates a reference bug: for a degree-1
    variable the reference's exclusion reads the byte before its scratch
    buffer (usually 0), so an erased degree-1 variable sends that byte
    instead of an erasure, a per-bit genie hint.  Set 0 to reproduce the
    reference's numbers; ``None`` runs the correct algorithm."""
    symbols_in = as_u8_symbols(symbols_in)
    if symbols_in.device.type == "cpu" or iterations == 0:
        return bec_decode_plain(dcode, symbols_in, codeword, iterations, early_term,
                                degree1_stale_byte)
    from .kernels.decode_bec import bec_decode_fused
    from .kernels.decode_fused import _require_cuda

    _require_cuda(symbols_in)
    if dcode._tables is None:
        raise ValueError("a CUDA decode needs a DeviceCode built by to_device on a CUDA device")
    perm, inv = dcode._vn_perm, dcode._vn_inv
    out = bec_decode_fused(dcode._tables, symbols_in.index_select(0, perm),
                           codeword.to(torch.uint8).index_select(0, perm), iterations,
                           early_term, degree1_stale_byte)
    return BECDecodeOutput(symbols_out=out.symbols_out.index_select(0, inv),
                           hard=out.hard.index_select(0, inv), iterations=out.iterations,
                           resolved=out.resolved)


#: The JAX package's jitted entry point; here the same function.
bec_decode_jit = bec_decode
