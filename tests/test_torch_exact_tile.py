"""The identity the exact layered schedule's tile kernel rests on, against
the JAX package on the CPU, on the same numpy LLRs.

The tile form (``csrc/layered_exact_tile.cuh``) keeps only the stored
posterior ``post`` and the stored check messages ``lc2v`` of its frames:
a check recomputes its extrinsic ``lv2c = store(load(post[v]) -
load(lc2v[e]))``, and after a layer only the posteriors of that layer's
variables (``KernelTables.layer_vars``) are recomputed, every variable at
the decode's first layer.  :func:`tile_schedule` is that schedule in plain
PyTorch on the port's ``cn_ops`` and ``messages``; it is held against
``bp_decode_pallas(..., layered=True)`` in interpret mode (the MXU
transport for int8, the JAX package's condition there), with early
termination on and off, on a code split into two halves of its checks and
on one split into even and odd checks, whose layers reach a variable
through two checks; and, in every form, against the port's plain version,
which recomputes every posterior and extrinsic after each layer (itself
held against the JAX kernels in ``tests/test_torch_layered_messages.py``).

Tolerances: the min-sum family in float32 and bfloat16 and the int8
lattice bit-exact in ``llr_out``, ``iterations`` and ``is_codeword``; BP
in decisions and iteration counts on >= 99.9 % of frames and within 1e-4
(float32) or 2^-4 (bfloat16, its posterior recomputed from stored
messages after every layer) on their posteriors, the limits of
``tests/test_torch_layered.py`` and ``tests/test_torch_layered_messages.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libldpc_tpu.models import make_benchmark_code
from libldpc_tpu.ops.pallas.decode_fused import bp_decode_pallas
from libldpc_tpu.ops.pallas.layout import to_pallas_device
from libldpc_tpu_torch.convert import code_from_jax
from libldpc_tpu_torch.ops import cn_ops
from libldpc_tpu_torch.ops.kernels import decode_layered as dl
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.ops.messages import MessageForm
from libldpc_tpu_torch.ops.sorted import (
    syndrome_ok_from_posterior, to_sorted_device, vn_posterior_sorted,
)

from test_torch_sorted import awgn_llrs

torch.set_num_threads(2)

SCALE = 0.1875
OMS = ("BP_OMS", 1.0, 0.375)
NMS = ("BP_NMS", 0.75, 0.15)
#: (message dtype, CN form) held bit-exact
EXACT = [("float32", "BP_MS"), ("float32", NMS), ("bfloat16", "BP_MS"), ("int8", "BP_MS"),
         ("int8", OMS)]


def tile_schedule(tables, llr, iterations, early_term, minsum_mode, form):
    """The exact layered schedule as the tile kernel runs it: ``(post,
    iterations, is_codeword)``, the stored posterior dequantised."""
    sdc = tables.code
    B = llr.shape[1]
    col, perm = sdc.col_sorted.long(), sdc.perm_c2v.long()
    mode = form.cn_mode(minsum_mode)
    prior = form.prior(llr)
    post = form.store(prior)  # a check's first extrinsic is store(prior(x))
    lc2v = form.store(torch.zeros((sdc.nnz, B)))
    vptr, lvars = tables.layer_var_ptr.tolist(), tables.layer_vars.long()
    done = torch.zeros(B, dtype=torch.bool)
    iters = torch.zeros(B, dtype=torch.int32)
    iscw = torch.zeros(B, dtype=torch.bool)
    first = True
    for it in range(iterations):
        if early_term and bool(done.all()):
            break
        done_start = done.clone()
        for l, groups in enumerate(tables.layer_slots):
            run = ~done[None, :]
            # the layer's checks, the extrinsic recomputed from the stored values
            for slots in groups:  # [count, d] CN-space slots
                lv = form.round(form.load(post)[col[slots]] - form.load(lc2v[slots]))
                o = form.store(cn_ops.cn_postprocess(cn_ops.exclusion(lv, mode), mode))
                lc2v[slots] = torch.where(run[None], o, lc2v[slots])
            # the posterior of the layer's variables (all of them at first)
            in_layer = torch.ones(sdc.nc, dtype=torch.bool) if first else torch.zeros(
                sdc.nc, dtype=torch.bool).index_fill_(0, lvars[vptr[l]:vptr[l + 1]], True)
            first = False
            new = form.store(vn_posterior_sorted(sdc, prior, form.load(lc2v)[perm]))
            post = torch.where(in_layer[:, None] & run, new, post)
            check = ~done & (early_term or (it == iterations - 1 and l == len(vptr) - 2))
            ok = syndrome_ok_from_posterior(sdc, form.load(post)[col])
            if early_term:
                iscw |= check & ok
                done |= check & ok
            else:
                iscw = torch.where(check, ok, iscw)
        if early_term:
            iters += (~done_start & ~done).to(torch.int32)
    if not early_term:
        iters.fill_(iterations)
    return form.dequant(post), iters, iscw


def half_split(code):
    half = code.mc // 2
    return dataclasses.replace(code, layers=[np.arange(half, dtype=np.int32),
                                             np.arange(half, code.mc, dtype=np.int32)])


def even_odd_split(code):
    return dataclasses.replace(code, layers=[np.arange(0, code.mc, 2, dtype=np.int32),
                                             np.arange(1, code.mc, 2, dtype=np.int32)])


@pytest.fixture(scope="module", params=["halves", "even_odd"])
def setup(request):
    base = make_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True)
    code = half_split(base) if request.param == "halves" else even_odd_split(base)
    pdc = to_pallas_device(code, with_layers=True)
    tables = kernel_tables(to_sorted_device(code_from_jax(code), "cpu", with_layers=True))
    if request.param == "even_odd":
        assert not tables.layers_disjoint  # a layer reaches a variable through two checks
    return pdc, tables, awgn_llrs(code, pdc.sorted_dc.vn_perm, 128, 1.0, seed=3)


@pytest.mark.parametrize("dtype,form,early_term", [
    ("float32", "BP_MS", True), ("int8", OMS, False), ("bfloat16", "BP", True)])
def test_tile_schedule_matches_pallas_kernel(setup, dtype, form, early_term):
    pdc, tables, llr = setup
    jout = bp_decode_pallas(pdc, jnp.asarray(llr), iterations=8, early_term=early_term,
                            minsum_mode=form, batch_tile=128, interpret=True, layered=True,
                            message_dtype=dtype, quant_scale=SCALE,
                            permute="mxu" if dtype == "int8" else "benes")
    post, iters, iscw = tile_schedule(tables, torch.from_numpy(llr), 8, early_term, form,
                                      MessageForm(dtype, SCALE))
    j_llr, j_it, j_cw = (np.asarray(x) for x in (jout.llr_out, jout.iterations,
                                                  jout.is_codeword))
    if (dtype, form) in EXACT:
        np.testing.assert_array_equal(post.numpy(), j_llr)
        np.testing.assert_array_equal(iters.numpy(), j_it)
        np.testing.assert_array_equal(iscw.numpy(), j_cw)
        return
    agree = ((post.numpy() <= 0) == (j_llr <= 0)).all(0) & (iters.numpy() == j_it)
    assert agree.mean() >= 0.999
    tol = 1e-4 if dtype == "float32" else 2 ** -4
    np.testing.assert_allclose(post.numpy()[:, agree], j_llr[:, agree], rtol=tol, atol=tol)


@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("dtype,form", EXACT + [("float32", "BP"), ("bfloat16", "BP")])
def test_tile_schedule_matches_plain_version(setup, dtype, form, early_term):
    """The same bits as the HBM-plane form's plain version, which recomputes
    every posterior and extrinsic after each layer (BP too: the same torch
    arithmetic in the same order)."""
    _, tables, llr = setup
    x = torch.from_numpy(llr)
    want = dl.bp_decode_layered_plain(tables, x, 8, early_term, form, dtype, SCALE)
    post, iters, iscw = tile_schedule(tables, x, 8, early_term, form, MessageForm(dtype, SCALE))
    assert torch.equal(post, want.llr_out)
    assert torch.equal(iters, want.iterations) and torch.equal(iscw, want.is_codeword)
