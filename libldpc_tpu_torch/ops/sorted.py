"""Degree-class-sorted edge layout and the plain flooding BP decoder over it.

The port of :mod:`libldpc_tpu.ops.sorted`: check and variable nodes are
relabelled so that equal-degree nodes are contiguous, which makes the CN
update a per-class reshape and exclusion combine and the VN sum a per-class
reshape and sum, with no padding anywhere.  One static permutation
``perm_c2v`` maps CN-space edge slots to VN-space edge slots and
``col_sorted`` maps CN-space slots to (sorted) VN labels.  Per-node tensors
(LLRs, codewords, ``bit_pos``, G's columns) live in the sorted VN labelling.

The tables are built with NumPy by the same stable sorts as the JAX
package, so they are equal to its ``SortedDeviceCode`` entry for entry.
:func:`bp_decode_sorted` is the port's plain decoder: the CPU path of the
sweep, and the reference its CUDA kernel is held against.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..models.code import LDPCCode
from . import cn_ops
from .messages import FLOAT32, MessageForm


def _degree_classes(degrees: np.ndarray) -> tuple[np.ndarray, list[tuple[int, int]]]:
    """Stable-sort node labels by degree: ``(perm, classes)`` with
    ``perm[new_label] = old_label`` and ``classes`` the ``(count, degree)``
    blocks in sorted order."""
    perm = np.argsort(degrees, kind="stable").astype(np.int32)
    classes = [(int((degrees == d).sum()), int(d)) for d in np.unique(degrees[perm])]
    return perm, classes


@dataclasses.dataclass
class TorchSortedCode:
    """The sorted layout's tables as tensors on one device."""

    nc: int
    mc: int
    nnz: int
    cn_classes: tuple[tuple[int, int], ...]  # (count, degree) blocks, CN space
    vn_classes: tuple[tuple[int, int], ...]  # (count, degree) blocks, VN space
    col_sorted: torch.Tensor  # int32 [nnz] sorted-VN label per CN-space slot
    perm_c2v: torch.Tensor  # int32 [nnz] CN-space slot per VN-space slot
    bit_pos: torch.Tensor  # int32 [nct] sorted labels of transmitted bits
    puncture: torch.Tensor  # int32 [P] sorted labels
    shorten: torch.Tensor  # int32 [S] sorted labels
    vn_perm: torch.Tensor  # int32 [nc] sorted label -> original label
    vn_inv: torch.Tensor  # int32 [nc] original label -> sorted label
    G: Optional[torch.Tensor]  # f32 [kc, nc] generator, columns sorted
    #: bool [nl, nnz] per-layer membership of each CN-space slot (the
    #: layered schedule's masks), or None without layers
    layer_edge_masks: Optional[torch.Tensor] = None

    @property
    def nct(self) -> int:
        return self.bit_pos.shape[0]

    @property
    def kc(self) -> int:
        if self.G is None:
            raise RuntimeError("code has no generator matrix")
        return self.G.shape[0]

    @property
    def device(self) -> torch.device:
        return self.col_sorted.device

    @property
    def max_dc(self) -> int:
        return max(d for _, d in self.cn_classes)

    def to(self, device) -> "TorchSortedCode":
        """A copy with every tensor on ``device``."""
        moved = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return dataclasses.replace(self, **moved)


def to_sorted_device(code: LDPCCode, device="cuda", with_layers: bool = False) -> TorchSortedCode:
    """Build the sorted-layout tables of ``code`` on ``device`` (the card
    unless the caller names another, as the ``Simulator`` and the CLI
    do); ``with_layers`` adds the per-layer CN-slot masks of
    ``code.layers``."""
    rows = code.rows.astype(np.int64)
    cols = code.cols.astype(np.int64)
    nc, mc, nnz = code.nc, code.mc, code.nnz

    cn_deg = np.bincount(rows, minlength=mc)
    vn_deg = np.bincount(cols, minlength=nc)
    cn_perm, cn_classes = _degree_classes(cn_deg)  # new -> old
    vn_perm, vn_classes = _degree_classes(vn_deg)
    cn_inv = np.empty(mc, dtype=np.int64)
    cn_inv[cn_perm] = np.arange(mc)
    vn_inv = np.empty(nc, dtype=np.int64)
    vn_inv[vn_perm] = np.arange(nc)

    # CN-major edge order: (sorted CN label, file order); the stable sort
    # keeps each row's file order, which fixes the combine's association order
    order_c = np.argsort(cn_inv[rows], kind="stable")
    col_sorted = vn_inv[cols[order_c]]
    # VN-major edge order: (sorted VN label, file order); per VN-space slot,
    # the CN-space slot of the same edge
    cn_slot_of_edge = np.empty(nnz, dtype=np.int64)
    cn_slot_of_edge[order_c] = np.arange(nnz)
    perm_c2v = cn_slot_of_edge[np.argsort(vn_inv[cols], kind="stable")]

    def dev(x, dtype=torch.int32):
        return torch.as_tensor(np.asarray(x, dtype=np.int64)).to(dtype).to(device)

    layer_edge_masks = None
    if with_layers and code.layers:
        # sorted row label of each CN-space slot: class blocks are contiguous rows
        slot_row = np.repeat(np.arange(mc), np.sort(cn_deg))
        masks = np.zeros((len(code.layers), nnz), dtype=bool)
        for li, layer in enumerate(code.layers):
            in_layer = np.zeros(mc, dtype=bool)
            in_layer[cn_inv[np.asarray(layer, dtype=np.int64)]] = True
            masks[li] = in_layer[slot_row]
        layer_edge_masks = torch.as_tensor(masks).to(device)

    return TorchSortedCode(
        nc=nc,
        mc=mc,
        nnz=nnz,
        cn_classes=tuple(cn_classes),
        vn_classes=tuple(vn_classes),
        col_sorted=dev(col_sorted),
        perm_c2v=dev(perm_c2v),
        bit_pos=dev(vn_inv[code.bit_pos]),
        puncture=dev(vn_inv[code.puncture] if len(code.puncture) else []),
        shorten=dev(vn_inv[code.shorten] if len(code.shorten) else []),
        vn_perm=dev(vn_perm),
        vn_inv=dev(vn_inv),
        G=None if code.G is None else torch.as_tensor(
            np.ascontiguousarray(code.G[:, vn_perm], dtype=np.float32)
        ).to(device),
        layer_edge_masks=layer_edge_masks,
    )


def _class_slices(classes: Sequence[tuple[int, int]]):
    """Yield ``(edge_start, edge_stop, count, degree)`` per class block."""
    e = 0
    for count, degree in classes:
        yield e, e + count * degree, count, degree
        e += count * degree


def cn_update_sorted(sdc: TorchSortedCode, lv2c: torch.Tensor, minsum_mode) -> torch.Tensor:
    """CN exclusion update ``[nnz, B] -> [nnz, B]``, per degree class."""
    B = lv2c.shape[1]
    parts = []
    for e0, e1, count, degree in _class_slices(sdc.cn_classes):
        if degree == 0:
            continue
        M = lv2c[e0:e1].reshape(count, degree, B)
        parts.append(cn_ops.exclusion(M, minsum_mode).reshape(count * degree, B))
    return cn_ops.cn_postprocess(torch.cat(parts, dim=0), minsum_mode)


def vn_posterior_sorted(
    sdc: TorchSortedCode, prior: torch.Tensor, lc2v_vnspace: torch.Tensor
) -> torch.Tensor:
    """Posterior LLRs ``[nc, B]``: ``prior + (m_0 + m_1 + ... )`` with the
    VN-space messages summed left to right, the order the CUDA kernel sums
    them in; a degree-0 node keeps its prior."""
    parts = []
    n0 = 0
    for e0, e1, count, degree in _class_slices(sdc.vn_classes):
        lin = prior[n0:n0 + count]
        n0 += count
        if degree == 0:
            parts.append(lin)
            continue
        M = lc2v_vnspace[e0:e1].reshape(count, degree, -1)
        tot = M[:, 0]
        for j in range(1, degree):
            tot = tot + M[:, j]
        parts.append(lin + tot)
    return torch.cat(parts, dim=0)


def syndrome_ok_from_posterior(sdc: TorchSortedCode, g: torch.Tensor) -> torch.Tensor:
    """Per-frame codeword check ``[B]`` from the posterior gathered at the
    CN-space slots (``g = llr_out[col_sorted]``).  The decision rule is
    ``llr <= 0``, so a zero posterior decides 1."""
    bits = (g <= 0).to(torch.int32)
    bad = torch.zeros(g.shape[1], dtype=torch.bool, device=g.device)
    for e0, e1, count, degree in _class_slices(sdc.cn_classes):
        if degree == 0:
            continue
        blk = bits[e0:e1].reshape(count, degree, -1)
        bad |= (blk.sum(dim=1) % 2).bool().any(dim=0)
    return ~bad


def syndrome_ok_sorted(sdc: TorchSortedCode, hard: torch.Tensor) -> torch.Tensor:
    """Per-frame codeword check from sorted-space hard decisions ``[nc, B]``."""
    g = torch.where(hard, -1.0, 1.0)
    return syndrome_ok_from_posterior(sdc, g.index_select(0, sdc.col_sorted))


class SortedDecodeOutput(NamedTuple):
    llr_out: torch.Tensor  # f32 [nc, B] (sorted VN labelling)
    hard: torch.Tensor  # bool [nc, B]
    iterations: torch.Tensor  # int32 [B]
    is_codeword: torch.Tensor  # bool [B]


def bp_pass(sdc: TorchSortedCode, prior: torch.Tensor, lv2c: torch.Tensor, minsum_mode,
            form: MessageForm = FLOAT32):
    """One flooding iteration: ``(post [nc, B], lv2c_new [nnz, B])``, both
    in ``form``'s storage (the posterior rounded as it is stored; see
    :mod:`.messages` for the store points).  ``prior`` is raw float32 LLRs;
    ``minsum_mode`` is given in LLR units."""
    lc2v = form.store(cn_update_sorted(sdc, form.load(lv2c), form.cn_mode(minsum_mode)))
    lc2v_f = form.load(lc2v)
    post = form.store(vn_posterior_sorted(sdc, form.prior(prior),
                                          lc2v_f.index_select(0, sdc.perm_c2v)))
    return post, form.store(form.load(post).index_select(0, sdc.col_sorted) - lc2v_f)


def init_messages(sdc: TorchSortedCode, llr_in: torch.Tensor,
                  form: MessageForm = FLOAT32) -> torch.Tensor:
    """First VN->CN messages: ``store(prior(llr))`` at each CN-space slot."""
    return form.store(form.prior(llr_in.index_select(0, sdc.col_sorted)))


def bp_decode_sorted(
    sdc: TorchSortedCode,
    llr_in: torch.Tensor,  # f32 [nc, B], sorted VN labelling
    iterations: int = 50,
    early_term: bool = True,
    minsum_mode=False,
    layered: bool = False,
    form: MessageForm = FLOAT32,
) -> SortedDecodeOutput:
    """Flooding BP with the JAX package's semantics: per-frame early
    termination that freezes a converged frame's decisions, and
    break-before-increment iteration counts (a frame that converges at
    pass ``i`` reports ``i - 1``; one that never converges reports the
    cap).  Without early termination every frame runs every pass and
    ``is_codeword`` comes from the last one.

    ``form`` stores messages and posteriors in bfloat16 or on the int8
    lattice (``bp_decode_pallas``'s ``message_dtype``); ``llr_out`` is the
    stored posterior as float32 LLRs (dequantised on the lattice).

    ``layered=True`` runs the exact layered schedule when ``sdc`` carries
    more than one layer mask, and flooding otherwise (as the JAX decoder
    does), in the same message form."""
    form.check_cn_mode(minsum_mode)
    if layered and sdc.layer_edge_masks is not None and sdc.layer_edge_masks.shape[0] > 1:
        return _bp_decode_sorted_layered(sdc, llr_in, iterations, early_term, minsum_mode, form)
    B = llr_in.shape[1]
    dev = llr_in.device
    lv2c = init_messages(sdc, llr_in, form)
    post = torch.zeros(llr_in.shape, dtype=form.torch_dtype, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    for _ in range(iterations):
        if early_term and bool(done.all()):
            break
        new_post, new_lv2c = bp_pass(sdc, llr_in, lv2c, minsum_mode, form)
        keep = done[None, :]
        lv2c = torch.where(keep, lv2c, new_lv2c)
        post = torch.where(keep, post, new_post)
        if early_term:
            newly = ~done & syndrome_ok_from_posterior(
                sdc, form.load(post).index_select(0, sdc.col_sorted)
            )
            iters += (~done & ~newly).to(torch.int32)
            done |= newly
        else:
            iters += 1
    llr_out = form.dequant(post)
    # with no pass run, the decision word is all zeros (like the JAX decoder)
    hard = llr_out <= 0 if iterations > 0 else torch.zeros_like(llr_in, dtype=torch.bool)
    return SortedDecodeOutput(
        llr_out=llr_out,
        hard=hard,
        iterations=iters,
        is_codeword=syndrome_ok_sorted(sdc, hard),
    )


def _bp_decode_sorted_layered(sdc, llr_in, iterations, early_term, minsum_mode, form):
    """The exact layered schedule of ``_bp_decode_sorted_layered`` in the
    JAX package: per layer, the full CN update masked to the layer's slots,
    the full APP recompute from every check's current message, the
    extrinsics of every slot, and (with early termination) a syndrome
    check that freezes a frame for the rest of the decode.  An iteration
    counts for a frame unconverged both at its start and at its end.  In
    ``form``, with :func:`bp_pass`'s store points (``kernel_layered``'s):
    a stale layer's checks keep their stored messages, and ``llr_out`` is
    the stored posterior dequantised."""
    B = llr_in.shape[1]
    dev = llr_in.device
    masks = sdc.layer_edge_masks[:, :, None]  # [nl, nnz, 1]
    mode = form.cn_mode(minsum_mode)
    prior = form.prior(llr_in)
    lv2c = init_messages(sdc, llr_in, form)
    lc2v = torch.zeros((sdc.nnz, B), dtype=form.torch_dtype, device=dev)
    post = torch.zeros(llr_in.shape, dtype=form.torch_dtype, device=dev)
    hard = torch.zeros_like(llr_in, dtype=torch.bool)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    for _ in range(iterations):
        if bool(done.all()):
            break
        done_start = done
        for mask in masks:
            lc2v_l = torch.where(mask, form.store(cn_update_sorted(sdc, form.load(lv2c), mode)),
                                 lc2v)
            lc2v_f = form.load(lc2v_l)
            post_l = form.store(vn_posterior_sorted(sdc, prior, lc2v_f.index_select(0, sdc.perm_c2v)))
            post_f = form.load(post_l)
            g = post_f.index_select(0, sdc.col_sorted)
            keep = done[None, :]
            lv2c = torch.where(keep, lv2c, form.store(g - lc2v_f))
            lc2v = torch.where(keep, lc2v, lc2v_l)
            post = torch.where(keep, post, post_l)
            hard = torch.where(keep, hard, post_f <= 0)
            if early_term:
                done = done | syndrome_ok_from_posterior(sdc, g)
        iters += (~done_start & ~done).to(torch.int32)
    return SortedDecodeOutput(
        llr_out=form.dequant(post),
        hard=hard,
        iterations=iters,
        is_codeword=syndrome_ok_sorted(sdc, hard),
    )
