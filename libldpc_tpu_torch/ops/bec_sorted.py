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

The second half of the module is the same algebra bit-sliced, as the CUDA
batch kernel runs it: a symbol is two bits, ``known`` and ``value`` (0
where erased), and 32 frames make one int32 word of each
(:func:`pack_symbols`, :func:`bec_words_pass`, :func:`unpack_symbols`,
:func:`bec_decode_words`).  Counts become two accumulators, "at least one"
and "at least two" (``two |= one & x; one |= x``).
:func:`bec_stream_chunk_words` is the streaming chunk the CUDA kernel's
word form runs, on the same words.  Both are held against the byte
versions by the tests and are on no decode path.
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


# ---------------------------------------------------------------- bit-sliced


def _to_words(bits: torch.Tensor) -> torch.Tensor:
    """bool ``[rows, B]`` -> int32 ``[rows, ceil(B / 32)]``: bit ``f`` of word
    ``w`` is frame ``32 w + f``; frames past ``B`` are 0."""
    rows, B = bits.shape
    W = (B + 31) // 32
    padded = torch.zeros((rows, W * 32), dtype=torch.int64, device=bits.device)
    padded[:, :B] = bits
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << torch.arange(
        32, device=bits.device)
    words = (padded.reshape(rows, W, 32) * weights).sum(2)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _from_words(words: torch.Tensor, B: int) -> torch.Tensor:
    """int32 ``[rows, W]`` -> bool ``[rows, B]`` (inverse of :func:`_to_words`)."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1)[:, :B].bool()


def pack_symbols(symbols: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """u8 3-state symbols ``[rows, B]`` -> ``(known, value)`` int32 words
    ``[rows, ceil(B / 32)]``.  A frame past ``B`` is a known 0."""
    known = _to_words(symbols != BEC_ERASURE)
    B = symbols.shape[1]
    if B % 32:
        known[:, -1] |= -1 << (B % 32)
    return known, _to_words(symbols == 1)


def unpack_symbols(known: torch.Tensor, value: torch.Tensor, B: int) -> torch.Tensor:
    """``(known, value)`` words -> u8 symbols ``[rows, B]``."""
    return torch.where(_from_words(known, B), _from_words(value, B).to(torch.uint8),
                       BEC_ERASURE).to(torch.uint8)


def bec_words_pass(
    sdc: TorchSortedCode,
    chk: torch.Tensor,  # i32 [nc, W] the channel knows the bit
    xi: torch.Tensor,  # i32 [nc, W] true bits
    mk: torch.Tensor,  # i32 [nnz, W] lv2c known, CN-space slots
    mv: torch.Tensor,  # i32 [nnz, W] lv2c value (0 where erased)
    degree1_stale_byte: Optional[int] = None,
):
    """One flooding iteration on words: ``(pk, pv, mk_new, mv_new)``, the
    posterior and the new ``lv2c``, each as (known, value) words."""
    # ---- check update: known iff no *other* input is erased
    ck_parts, cv_parts = [], []
    for e0, e1, count, d in _class_slices(sdc.cn_classes):
        if d == 0:
            continue
        K = mk[e0:e1].reshape(count, d, -1)
        V = mv[e0:e1].reshape(count, d, -1)
        if d == 1:
            ck_parts.append(torch.full_like(K, -1).reshape(count, -1))
            cv_parts.append(torch.zeros_like(V).reshape(count, -1))
            continue
        one = torch.zeros_like(K[:, 0])
        two = torch.zeros_like(one)
        parity = torch.zeros_like(one)
        for j in range(d):
            two = two | (one & ~K[:, j])
            one = one | ~K[:, j]
            parity = parity ^ (V[:, j] & K[:, j])
        ok = ~one[:, None] | (~two[:, None] & ~K)
        ck_parts.append(ok.reshape(count * d, -1))
        cv_parts.append(((parity[:, None] ^ (V & K)) & ok).reshape(count * d, -1))
    lk = torch.cat(ck_parts, dim=0).index_select(0, sdc.perm_c2v)  # VN-space slots
    lv = torch.cat(cv_parts, dim=0).index_select(0, sdc.perm_c2v)
    # ---- variable update
    vk_parts, vv_parts, pk_parts, pv_parts = [], [], [], []
    n0 = 0
    for e0, e1, count, d in _class_slices(sdc.vn_classes):
        c = chk[n0:n0 + count]
        x = xi[n0:n0 + count]
        n0 += count
        if d == 0:
            pk_parts.append(c)
            pv_parts.append(x & c)
            continue
        K = lk[e0:e1].reshape(count, d, -1)
        V = lv[e0:e1].reshape(count, d, -1)
        if d == 1:
            pk_parts.append(c | K[:, 0])
            pv_parts.append((x & c) | (V[:, 0] & ~c))
            if degree1_stale_byte is None:
                ok, ov = c, x & c
            else:
                ok = torch.full_like(c, -1)
                ov = (x & c) | (~c if degree1_stale_byte else torch.zeros_like(c))
            vk_parts.append(ok)
            vv_parts.append(ov & ok)
            continue
        match = K & ~(V ^ x[:, None])
        one = torch.zeros_like(c)
        two = torch.zeros_like(c)
        for j in range(d):
            two = two | (one & match[:, j])
            one = one | match[:, j]
        pk = c | one
        pk_parts.append(pk)
        pv_parts.append(x & pk)
        ok = c[:, None] | two[:, None] | (one[:, None] & ~match)
        vk_parts.append(ok.reshape(count * d, -1))
        vv_parts.append((x[:, None] & ok).reshape(count * d, -1))
    mk_new = torch.empty_like(mk)
    mv_new = torch.empty_like(mv)
    mk_new[sdc.perm_c2v.long()] = torch.cat(vk_parts, dim=0)
    mv_new[sdc.perm_c2v.long()] = torch.cat(vv_parts, dim=0)
    return torch.cat(pk_parts, dim=0), torch.cat(pv_parts, dim=0), mk_new, mv_new


def bec_decode_words(
    sdc: TorchSortedCode,
    symbols_in: torch.Tensor,  # u8 [nc, B], sorted VN labelling
    codeword: torch.Tensor,  # u8 [nc, B], sorted VN labelling
    iterations: int = 50,
    early_term: bool = True,
    degree1_stale_byte: Optional[int] = None,
) -> BECDecodeOutput:
    """:func:`bec_decode_sorted` on words: pack, ``iterations`` word passes
    with a ``live`` word masking every write of a resolved frame, unpack."""
    B = symbols_in.shape[1]
    chk, val = pack_symbols(symbols_in)
    xi = _to_words(codeword != 0)
    mk = chk.index_select(0, sdc.col_sorted)
    mv = val.index_select(0, sdc.col_sorted)
    pk = torch.zeros_like(chk)
    pv = torch.zeros_like(chk)
    live = _to_words(torch.ones((1, B), dtype=torch.bool, device=symbols_in.device))[0]
    iters = torch.zeros(B, dtype=torch.int32, device=symbols_in.device)
    for _ in range(iterations):
        if not bool(live.any()):
            break
        pk_n, pv_n, mk_n, mv_n = bec_words_pass(sdc, chk, xi, mk, mv, degree1_stale_byte)
        mk, mv = (mk & ~live) | (mk_n & live), (mv & ~live) | (mv_n & live)
        pk, pv = (pk & ~live) | (pk_n & live), (pv & ~live) | (pv_n & live)
        erased = torch.zeros_like(live)
        for row in ~pk_n:  # OR over the variables
            erased = erased | row
        unresolved = erased & live
        counted = unresolved if early_term else live
        iters += _from_words(counted[None], B)[0].to(torch.int32)
        if early_term:
            live = unresolved
    sym_out = unpack_symbols(pk, pv, B)
    unres = sym_out == BEC_ERASURE
    return BECDecodeOutput(
        symbols_out=sym_out,
        hard=torch.where(unres, wrong_bits(codeword, degree1_stale_byte), codeword),
        iterations=iters,
        resolved=~unres.any(0),
    )


def _keep(old: torch.Tensor, val: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``val`` in the frames of ``mask``, ``old`` elsewhere (words)."""
    return (old & ~mask) | (val & mask)


def transpose32(x: torch.Tensor) -> torch.Tensor:
    """The warp transposition of ``csrc/bec_stream_words.cuh``
    ``transpose32``: int64 words in ``[0, 2**32)``, ``[..., 32, W]`` with
    lane ``i`` (axis -2) holding row ``i`` of a 32 x 32 bit matrix, to lane
    ``i`` holding column ``i``, in the kernel's five block swaps."""
    lane = torch.arange(32, device=x.device)
    m, j = 0x0000FFFF, 16
    while j:
        other = x.index_select(x.dim() - 2, lane ^ j)
        high = ((lane & j) != 0)[:, None]
        x = torch.where(high, (x & ~m) | ((other >> j) & m), (x & m) | ((other & m) << j))
        j >>= 1
        m ^= m << j
    return x


def count_frame_bits(words: torch.Tensor, B: int) -> torch.Tensor:
    """int32 ``[rows, W]`` -> int32 ``[B]``: each frame's set bits over the
    rows, counted as the kernel counts them: 32 rows at a time transposed
    (:func:`transpose32`), then a population count per lane."""
    rows, W = words.shape
    x = torch.zeros((-(-rows // 32) * 32, W), dtype=torch.int64, device=words.device)
    x[:rows] = words.to(torch.int64) & 0xFFFFFFFF
    cols = transpose32(x.reshape(-1, 32, W))
    bits = (cols[..., None] >> torch.arange(32, device=words.device)) & 1
    return bits.sum((0, 3)).t().reshape(-1)[:B].to(torch.int32)


def bec_stream_chunk_words(
    sdc: TorchSortedCode, sym, cw, lv2c, done, iters, age, avail, ctr, fresh_sym, fresh_cw,
    refill, remaining, *, k: int, cap: int, degree1_stale_byte: Optional[int] = None,
) -> None:
    """The BEC streaming chunk as the CUDA kernel's word form runs it, in
    place on the state of ``kernels.decode_bec.bec_stream_chunk_fused``:
    pack the carried symbols, codewords and messages into words; per pass,
    grant starts in lane order against ``remaining``, pack the pool's rows
    under the grant mask (their messages the channel symbol at each slot),
    run :func:`bec_words_pass` on the frames in flight (``live``), and count
    the finishing frames' transmitted-bit errors (:func:`count_frame_bits`);
    unpack the messages of the frames that ran.  It leaves the state the
    byte chunk (``bec_stream_chunk_fused_plain``) leaves."""
    B = sym.shape[1]
    E = BEC_ERASURE
    chk, xi = _to_words(sym != E), _to_words(cw != 0)
    mk, mv = _to_words(lv2c != E), _to_words(lv2c == 1)
    pk, pv = torch.zeros_like(chk), torch.zeros_like(chk)
    pool_k, pool_v = _to_words(fresh_sym != E), _to_words(fresh_sym == 1)
    pool_x = _to_words(fresh_cw != 0)
    ran = torch.zeros_like(chk[0])
    refill_on = bool(refill[0] != 0)
    for _ in range(k):
        # ---- reload, in lane order within the quota
        want = refill_on & (done != 0) & (avail != 0)
        grant = want & (torch.cumsum(want.to(torch.int32), 0) <= remaining)
        remaining -= grant.sum(dtype=torch.int32)
        sym.copy_(torch.where(grant, fresh_sym, sym))
        cw.copy_(torch.where(grant, fresh_cw, cw))
        g = grant.to(torch.int32)
        done.mul_(1 - g)
        age.copy_(torch.where(grant, 1, age))
        iters.mul_(1 - g)
        avail.sub_(g)
        ctr[4] += g
        run = done == 0
        if not bool(run.any()):
            break  # nothing runs and nothing may start
        R, live = _to_words(grant[None])[0], _to_words(run[None])[0]
        ran |= live
        chk, xi, pv = _keep(chk, pool_k, R), _keep(xi, pool_x, R), _keep(pv, pool_v, R)
        mk = _keep(mk, chk.index_select(0, sdc.col_sorted), R)
        mv = _keep(mv, pv.index_select(0, sdc.col_sorted), R)
        # ---- one pass of the frames in flight
        pk_n, pv_n, mk_n, mv_n = bec_words_pass(sdc, chk, xi, mk, mv, degree1_stale_byte)
        mk, mv = _keep(mk, mk_n, live), _keep(mv, mv_n, live)
        pk, pv = _keep(pk, pk_n, live), _keep(pv, pv_n, live)
        checking = run & (age >= 1)
        newly = checking & ~_from_words(~pk_n, B).any(0)
        iters += (checking & ~newly).to(torch.int32)
        age += run.to(torch.int32)
        finish = run & (newly | (age >= cap + 1))
        if bool(finish.any()):
            bad = ~pk.index_select(0, sdc.bit_pos)
            if degree1_stale_byte is not None:
                bad &= ~xi.index_select(0, sdc.bit_pos)
            be = count_frame_bits(bad, B)
            f = finish.to(torch.int32)
            ctr[0] += f * be
            ctr[1] += f * (be > 0).to(torch.int32)
            ctr[2] += f
            ctr[3] += f * iters
            done.add_(f)
    lv2c.copy_(torch.where(_from_words(ran[None], B)[0], unpack_symbols(mk, mv, B), lv2c))
