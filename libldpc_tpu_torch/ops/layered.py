"""The fast layered engine for QC codes on their natural layers.

The port of the JAX package's app-update layered engine
(``libldpc_tpu/ops/pallas/decode_lanes.py`` ``_qc_engine`` /
``kernel_layered_qc``, NumPy golden ``tests/golden.py``
``layered_qc_golden``).  The node posterior (APP) is persistent state and
layer ``r`` touches only its own checks' slots: per check,

* ``lv = app[v(e)] - lc2v[e]`` at each of its slots,
* the exclusion combine of the ``lv`` in CN position order, postprocessed,
* ``delta = o - lc2v[e]``, ``app[v(e)] += delta``, ``lc2v[e] = o``;

early termination is checked once per full iteration, from the syndrome of
``app <= 0``, and the decoder's posterior is the APP.  The updates of one
layer are independent only when no variable is touched twice in the layer,
which :func:`natural_qc_layers` requires and the kernel tables record.

The TPU engine walks circulant segments with embedded cyclic rolls; here a
layer is a list of checks in the sorted layout and the APP is addressed
through ``row_ptr``/``col_sorted``, the indexed loads the flooding kernels
use.  Tables are built with NumPy; the decoders are plain PyTorch, the
reference the CUDA kernels of :mod:`.kernels.decode_layered` are held
against.

The check messages may be stored in bfloat16 or on the int8 lattice
(:class:`.messages.MessageForm`, ``_qc_engine``'s ``to_msg``): ``lv`` and
the postprocessed ``o`` are rounded into the message domain, the APP stays
float32 (in lattice units for int8, starting at the prior) and is never
rounded, and the output is the dequantised APP.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from ..models.code import LDPCCode
from . import cn_ops
from .messages import FLOAT32, MessageForm
from .sorted import SortedDecodeOutput, syndrome_ok_from_posterior, syndrome_ok_sorted

if TYPE_CHECKING:
    from .kernels.layout import KernelTables


def natural_qc_layers(code: LDPCCode) -> bool:
    """Whether ``code.layers`` is the natural schedule of its QC structure,
    the preconditions of ``_derive_qc_layers`` in the JAX package's lanes
    layout: ``code.qc`` is set, there are ``mc / Z`` layers, layer ``r``
    holds exactly the checks ``[r*Z, (r+1)*Z)``, and no variable is touched
    twice within a layer."""
    if getattr(code, "qc", None) is None or not code.layers:
        return False
    Z = int(code.qc[0])
    if code.mc % Z or len(code.layers) != code.mc // Z:
        return False
    for r, layer in enumerate(code.layers):
        if not np.array_equal(np.sort(np.asarray(layer, dtype=np.int64)),
                              np.arange(r * Z, (r + 1) * Z)):
            return False
    rows = code.rows.astype(np.int64)
    cols = code.cols.astype(np.int64)
    key = (rows // Z) * code.nc + cols  # (layer, variable) per edge
    return np.unique(key).size == key.size


def layer_check_lists(row_ptr: np.ndarray, layer_edge_masks: np.ndarray):
    """``(layer_ptr [nl + 1], layer_checks)``: per layer, the sorted labels
    of the checks whose slots its mask selects (CSR, int32)."""
    slot_row = np.repeat(np.arange(row_ptr.size - 1), np.diff(row_ptr))
    lists = [np.unique(slot_row[m]) for m in layer_edge_masks]
    ptr = np.concatenate([[0], np.cumsum([len(x) for x in lists])])
    checks = np.concatenate(lists) if lists else np.zeros(0, np.int64)
    return ptr.astype(np.int32), checks.astype(np.int32)


def layer_variable_lists(row_ptr: np.ndarray, col_sorted: np.ndarray, layer_ptr: np.ndarray,
                         layer_checks: np.ndarray):
    """``(layer_var_ptr [nl + 1], layer_vars)``: per layer, the sorted labels
    of the variables its checks reach (the union of ``col_sorted`` over
    their slots), CSR, int32.  The exact schedule's tile kernel recomputes
    only these posteriors after a layer; with layers that touch each
    variable at most once the lists hold at most ``nnz`` labels in all."""
    lists = []
    for l in range(layer_ptr.size - 1):
        checks = layer_checks[layer_ptr[l]:layer_ptr[l + 1]]
        slots = [np.arange(row_ptr[r], row_ptr[r + 1]) for r in checks]
        lists.append(np.unique(col_sorted[np.concatenate(slots)]) if slots else
                     np.zeros(0, np.int64))
    ptr = np.concatenate([[0], np.cumsum([len(x) for x in lists])])
    flat = np.concatenate(lists) if lists else np.zeros(0, np.int64)
    return ptr.astype(np.int32), flat.astype(np.int32)


def layer_slot_groups(row_ptr: np.ndarray, layer_ptr: np.ndarray, layer_checks: np.ndarray):
    """Per layer, its checks grouped by degree: a tuple of ``[count, d]``
    arrays of CN-space slots (the plain engine's gather indices)."""
    out = []
    for l in range(layer_ptr.size - 1):
        checks = layer_checks[layer_ptr[l]:layer_ptr[l + 1]]
        deg = row_ptr[checks + 1] - row_ptr[checks]
        groups = []
        for d in np.unique(deg[deg > 0]):
            sel = checks[deg == d]
            groups.append(row_ptr[sel][:, None] + np.arange(d)[None, :])
        out.append(tuple(groups))
    return tuple(out)


def layers_touch_variables_once(col_sorted: np.ndarray, groups) -> bool:
    """True when no layer reaches a variable through two slots: then the
    APP updates of one layer's checks are independent."""
    for layer in groups:
        slots = np.concatenate([g.ravel() for g in layer]) if layer else np.zeros(0, np.int64)
        v = col_sorted[slots]
        if np.unique(v).size != v.size:
            return False
    return True


def layered_fast_pass(tables: "KernelTables", app: torch.Tensor, lc2v: torch.Tensor,
                      keep: torch.Tensor, minsum_mode, form: MessageForm = FLOAT32) -> None:
    """One full layered iteration in place over ``app [nc, B]`` (float32,
    in ``form``'s units) and ``lc2v [nnz, B]`` (stored in ``form``); frames
    with ``keep`` (bool ``[B]``) stay frozen.  ``minsum_mode`` is given in
    LLR units."""
    col = tables.code.col_sorted.long()
    keep = keep[None, None, :]
    mode = form.cn_mode(minsum_mode)
    for layer in tables.layer_slots:
        for slots in layer:  # [count, d] int64
            V = col[slots]
            stored = lc2v[slots]
            st = form.load(stored)
            lv = form.round(app[V] - st)
            o = form.round(cn_ops.cn_postprocess(cn_ops.exclusion(lv, mode), mode))
            app[V] = torch.where(keep, app[V], app[V] + (o - st))
            lc2v[slots] = torch.where(keep, stored, form.store(o))


def bp_decode_layered_fast_plain(
    tables: "KernelTables",
    llr_in: torch.Tensor,  # f32 [nc, B], sorted VN labelling
    iterations: int = 50,
    early_term: bool = True,
    minsum_mode=False,
    form: MessageForm = FLOAT32,
) -> SortedDecodeOutput:
    """The fast layered engine's batch decode, ``kernel_layered_qc``'s
    semantics: APP starts at ``form.prior`` of the channel LLRs and
    ``lc2v`` at 0; per iteration, one :func:`layered_fast_pass` over the
    unconverged frames, then (with early termination) the syndrome of
    ``app <= 0`` freezes the converged ones, with break-before-increment
    iteration counts.  Without early termination every frame reports the
    cap and ``is_codeword`` comes from the last iteration.  ``llr_out`` is
    the APP as LLRs (``form.dequant``; the APP itself off the lattice),
    ``hard = llr_out <= 0``; ``iterations == 0`` gives all zeros."""
    form.check_cn_mode(minsum_mode)
    sdc = tables.code
    B = llr_in.shape[1]
    dev = llr_in.device
    if iterations == 0:
        return SortedDecodeOutput(
            llr_out=torch.zeros_like(llr_in),
            hard=torch.zeros_like(llr_in, dtype=torch.bool),
            iterations=torch.zeros(B, dtype=torch.int32, device=dev),
            is_codeword=torch.zeros(B, dtype=torch.bool, device=dev),
        )
    app = form.prior(llr_in).clone()
    lc2v = torch.zeros((sdc.nnz, B), dtype=form.torch_dtype, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    for _ in range(iterations):
        if early_term and bool(done.all()):
            break
        layered_fast_pass(tables, app, lc2v, done, minsum_mode, form)
        if early_term:
            newly = ~done & syndrome_ok_from_posterior(sdc, app.index_select(0, sdc.col_sorted))
            iters += (~done & ~newly).to(torch.int32)
            done |= newly
    if early_term:
        is_cw = done
    else:
        iters.fill_(iterations)
        is_cw = syndrome_ok_sorted(sdc, app <= 0)
    llr_out = form.dequant(app)
    return SortedDecodeOutput(llr_out=llr_out, hard=llr_out <= 0, iterations=iters,
                              is_codeword=is_cw)
