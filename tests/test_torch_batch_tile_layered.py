"""K3's tile form, the fast layered engine's batch decode on a block of F
frames (``csrc/layered_stream.cuh`` ``bp_decode_layered_fast_tile_kernel``),
in plain PyTorch on the port's ``cn_ops`` and ``messages``
(:func:`fast_tile_batch`), against the JAX kernel on the CPU on the same
numpy LLRs and against the port's plain version.

The APP tile starts at ``prior(llr)``; the first iteration takes ``lc2v``
as 0 and does not read the plane (here filled with garbage to show it);
the syndrome is taken when a frame checks (every iteration with early
termination, the last without), from F-bit decision words
(``tests/test_torch_batch_tile.py`` ``packed_bad``); a converged frame keeps
its APP and is not counted; the block stops once its F frames have
converged.  Held against ``bp_decode_lanes(..., layered=True)`` on the qc
transport in interpret mode, against the NumPy golden
``tests/golden.py:layered_qc_golden``, and bit for bit against
``bp_decode_layered_fast_plain`` at a batch that is not a multiple of F.

Tolerances as in ``tests/test_torch_batch_tile.py``: the min-sum family
bit for bit; BP in decisions and iteration counts and, on the APP, float32
within 1e-4 of the JAX kernel and atol 1e-3 of the golden (NumPy's
``exp``/``log1p``, as ``tests/test_torch_layered.py`` holds it), bfloat16
within one bf16 step (2^-8 relative) plus atol 1e-3: the APP accumulates a
box-plus that XLA and torch may round to the other side of a step.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from golden import layered_qc_golden
from libldpc_tpu.models import make_qc_benchmark_code, qc_natural_layers, wifi_code
from libldpc_tpu.ops.pallas.decode_lanes import bp_decode_lanes
from libldpc_tpu.ops.pallas.lanes_layout import to_lanes_device
from libldpc_tpu_torch.convert import code_from_jax
from libldpc_tpu_torch.ops import cn_ops
from libldpc_tpu_torch.ops.kernels import decode_layered as dl
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.ops.messages import MessageForm
from libldpc_tpu_torch.ops.sorted import to_sorted_device

from test_torch_batch_tile import (
    CASES, OMS, SCALE, _check, _output, _pad, assert_agrees, assert_same, packed_bad,
)
from test_torch_sorted import awgn_llrs

torch.set_num_threads(2)


def fast_tile_batch(tables, llr, iterations, early_term, minsum_mode, form, F):
    """K3's tile form in plain PyTorch (see the module note)."""
    sdc = tables.code
    col = sdc.col_sorted.long()
    mode = form.cn_mode(minsum_mode)
    B = llr.shape[1]
    x, valid = _pad(llr, F)
    app = form.prior(x).clone()
    # the wrapper's torch.empty plane: never read before the first pass writes it
    lc2v = torch.randint(-100, 100, (sdc.nnz, x.shape[1])).to(form.torch_dtype)
    done, iscw = ~valid, torch.zeros_like(valid)
    iters = torch.zeros(x.shape[1], dtype=torch.int32)
    for it in range(iterations):
        if early_term and bool(done.all()):
            break
        keep = done[None, None, :]
        for layer in tables.layer_slots:
            for slots in layer:
                V = col[slots]
                stored = lc2v[slots]
                st = torch.zeros(stored.shape) if it == 0 else form.load(stored)
                lv = form.round(app[V] - st)
                o = form.round(cn_ops.cn_postprocess(cn_ops.exclusion(lv, mode), mode))
                app[V] = torch.where(keep, app[V], app[V] + (o - st))
                lc2v[slots] = torch.where(keep, stored, form.store(o))
        if early_term or it == iterations - 1:
            bad = packed_bad(tables, app <= 0, F)
            done, iscw, iters = _check(bad, done, iscw, iters, early_term)
    return _output(form, app, B, iters, iscw, iterations, early_term)



# ------------------------------------------------- K3, the fast layered engine


@pytest.fixture(scope="module")
def qc_setup():
    code = make_qc_benchmark_code(8 * 81, 81, dv=3, dc=6, seed=5)
    qc_natural_layers(code)
    ldc = to_lanes_device(code, transport="qc", with_layers=True)
    tables = kernel_tables(to_sorted_device(code_from_jax(code), "cpu", with_layers=True))
    return ldc, tables, awgn_llrs(code, ldc.sorted_dc.vn_perm, 16, 1.5, seed=7)


@pytest.mark.parametrize("dtype,form,early_term", [
    ("float32", "BP_MS", True), ("float32", "BP", True), ("float32", "BP", False),
    ("bfloat16", "BP_MS", False), ("bfloat16", "BP", True), ("int8", "BP_MS", False),
    ("int8", OMS, True)])
def test_fast_tile_batch_matches_lanes_kernel(qc_setup, dtype, form, early_term):
    ldc, tables, llr = qc_setup
    jout = bp_decode_lanes(ldc, jnp.asarray(llr), iterations=6, early_term=early_term,
                           minsum_mode=form, layered=True, message_dtype=dtype,
                           quant_scale=SCALE, interpret=True)
    tout = fast_tile_batch(tables, torch.from_numpy(llr), 6, early_term, form,
                           MessageForm(dtype, SCALE), 16)
    tol = (2 ** -8, 1e-3) if dtype == "bfloat16" else (1e-4, 1e-4)
    assert_agrees((jout.llr_out, jout.iterations, jout.is_codeword), tout, dtype, form, tol)


@pytest.fixture(scope="module")
def wifi1944():
    code = wifi_code(1944)
    return code, kernel_tables(to_sorted_device(code_from_jax(code), "cpu", with_layers=True))


@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("dtype,form", [("float32", "BP"), ("bfloat16", "BP_MS"),
                                        ("int8", OMS)])
def test_fast_tile_batch_matches_golden(wifi1944, dtype, form, early_term):
    code, tables = wifi1944
    rng = np.random.default_rng(7)
    sigma2 = 10 ** (-1.5 / 10)
    llr = (2.0 * (1.0 + rng.normal(size=(code.nc, 8)) * np.sqrt(sigma2)) / sigma2).astype(np.float32)
    vperm, vinv = tables.code.vn_perm.numpy(), tables.code.vn_inv.numpy()
    g_llr, g_it, g_cw = layered_qc_golden(code, llr, iterations=8, early_term=early_term,
                                          minsum_mode=form, message_dtype=dtype,
                                          quant_scale=SCALE)
    out = fast_tile_batch(tables, torch.from_numpy(np.ascontiguousarray(llr[vperm])), 8,
                          early_term, form, MessageForm(dtype, SCALE), 16)
    out = out._replace(llr_out=out.llr_out[vinv], hard=out.hard[vinv])
    assert_agrees((g_llr, g_it, g_cw), out, dtype, form, (1e-4, 1e-3))


@pytest.mark.parametrize("F", [16, 8])
@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("dtype,form", CASES + [("float32", ("BP_NMS", 0.75, 0.15))])
def test_fast_tile_batch_matches_plain(qc_setup, dtype, form, early_term, F):
    """Bit for bit the port's plain version, at a batch that is not a
    multiple of F, one iteration included."""
    _, tables, llr = qc_setup
    x = torch.from_numpy(llr[:, :13].copy())
    for iterations in (1, 6):
        got = fast_tile_batch(tables, x, iterations, early_term, form, MessageForm(dtype, SCALE), F)
        want = dl.bp_decode_layered_fast_plain(tables, x, iterations, early_term, form, dtype,
                                               SCALE)
        assert_same(got, want)
