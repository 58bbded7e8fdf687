"""The batch decodes' tile forms, K1 (flooding, ``csrc/flood_stream.cuh``
``bp_decode_fused_tile_kernel``) and K3 (the fast layered engine,
``csrc/layered_stream.cuh`` ``bp_decode_layered_fast_tile_kernel``), in
plain PyTorch on the port's ``cn_ops`` and ``messages``, against the JAX
kernels on the CPU on the same numpy LLRs, and against the port's plain
versions.  This file holds K1 and the pieces both share;
``tests/test_torch_batch_tile_layered.py`` holds K3.

* :func:`flood_tile_batch` is K1's schedule on a block of F frames: every
  frame starts as a streaming reload does, ``post = store(prior(x))`` with
  ``lc2v`` taken as 0; a check recomputes the extrinsic ``lv2c =
  store(load(post[v]) - load(lc2v[e]))`` from the two tiles (no ``lv2c``
  plane); the prior of each variable phase is read from the input; the
  syndrome comes from F-bit decision words (:func:`packed_bad`); a
  converged frame keeps that pass's posterior; a block stops once its F
  frames have converged.  Held against ``bp_decode_pallas`` in interpret
  mode (the MXU transport for int8).
* :func:`fast_tile_batch` is K3's: the APP tile starts at ``prior(llr)``;
  the first iteration takes ``lc2v`` as 0 and does not read the plane
  (here filled with garbage to show it); the syndrome is taken when a
  frame checks (every iteration with early termination, the last
  without), from the packed words; the block stops once its F frames have
  converged.  Held against ``bp_decode_lanes(..., layered=True)`` on the
  qc transport in interpret mode and against the NumPy golden
  ``tests/golden.py:layered_qc_golden``.
* Both against the port's plain versions (``bp_decode_fused_plain``,
  ``bp_decode_layered_fast_plain``), bit for bit in every form (BP too: the
  same torch arithmetic in the same order), at a batch that is not a
  multiple of F.

Tolerances, as in ``tests/test_torch_flood_tile.py``: the min-sum family
(float32, bfloat16, int8) bit for bit in posteriors, iteration counts and
codeword flags; BP in decisions and iteration counts on >= 99.9 % of
frames (all at these seeds) and, on their posteriors, float32 within 1e-4
(the XLA kernel may sum a node's messages in another order) and bfloat16
within one bf16 step (2^-8 relative, plus atol 1e-3 for K3's APP, which
accumulates the step), where XLA's and torch's ``exp``/``log1p`` may round
a box-plus differently.  Against the golden, float32 BP's APP is held to
atol 1e-3, as ``tests/test_torch_layered.py`` holds it (NumPy's
``exp``/``log1p``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libldpc_tpu.models import make_benchmark_code
from libldpc_tpu.ops.pallas.decode_fused import bp_decode_pallas
from libldpc_tpu.ops.pallas.layout import to_pallas_device
from libldpc_tpu_torch.convert import code_from_jax
from libldpc_tpu_torch.ops.kernels import decode_fused as df
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.ops.messages import MessageForm
from libldpc_tpu_torch.ops.sorted import (
    SortedDecodeOutput, cn_update_sorted, syndrome_ok_from_posterior, to_sorted_device,
    vn_posterior_sorted,
)

from test_torch_sorted import awgn_llrs

torch.set_num_threads(2)

SCALE = 0.1875
OMS = ("BP_OMS", 1.0, 0.375)  # offset 2.0 on the lattice
#: (message dtype, CN form); the float32 and bf16 BP rows are held to tolerances
CASES = [("float32", "BP_MS"), ("float32", "BP"), ("bfloat16", "BP_MS"), ("bfloat16", "BP"),
         ("int8", "BP_MS"), ("int8", OMS)]


def packed_bad(tables, bits, F):
    """Frames with an unsatisfied check, as the tiles find them: per block
    of F frames, one F-bit decision word per variable (bit f: frame f), the
    XOR of the words over each check's slots, ORed over the checks.
    ``bits`` is bool ``[nc, B]`` with B a multiple of F."""
    sdc = tables.code
    nc, B = bits.shape
    words = (bits.view(nc, B // F, F).to(torch.int64) << torch.arange(F)).sum(-1)
    row = tables.row_ptr.long()
    deg = row[1:] - row[:-1]
    col = sdc.col_sorted.long()
    par = torch.zeros((sdc.mc, B // F), dtype=torch.int64)
    for j in range(int(deg.max())):
        has = j < deg
        slot = torch.where(has, row[:-1] + j, 0)
        par ^= torch.where(has[:, None], words[col[slot]], 0)
    bad = ((par[:, :, None] >> torch.arange(F)) & 1).any(0)  # [B // F, F]
    return bad.reshape(B)


def _pad(llr, F):
    B = llr.shape[1]
    Bp = -(-B // F) * F
    return torch.nn.functional.pad(llr, (0, Bp - B)), torch.arange(Bp) < B


def _check(bad, done, iscw, iters, early_term):
    """The control state after a syndrome: break-before-increment counts,
    a converged frame done with early termination."""
    ok = ~bad
    chk = ~done
    if not early_term:
        return done, torch.where(chk, ok, iscw), iters
    newly = chk & ok
    return done | newly, iscw | newly, iters + (chk & ~ok).to(torch.int32)


def _output(form, x, B, iters, iscw, iterations, early_term):
    llr_out = form.dequant(x)[:, :B]
    its = iters[:B] if early_term else torch.full((B,), iterations, dtype=torch.int32)
    return SortedDecodeOutput(llr_out=llr_out, hard=llr_out <= 0, iterations=its,
                              is_codeword=iscw[:B])


def flood_tile_batch(tables, llr, iterations, early_term, minsum_mode, form, F):
    """K1's tile form in plain PyTorch (see the module note)."""
    sdc = tables.code
    col, perm = sdc.col_sorted.long(), sdc.perm_c2v.long()
    mode = form.cn_mode(minsum_mode)
    B = llr.shape[1]
    x, valid = _pad(llr, F)
    post = form.store(form.prior(x))
    lc2v = torch.zeros((sdc.nnz, x.shape[1]), dtype=form.torch_dtype)
    done, iscw = ~valid, torch.zeros_like(valid)
    iters = torch.zeros(x.shape[1], dtype=torch.int32)
    for it in range(iterations):
        if early_term and bool(done.all()):  # every block has stopped
            break
        run = ~done
        old = 0.0 if it == 0 else form.load(lc2v)
        lv = form.store(form.load(post)[col] - old)
        lc2v_new = form.store(cn_update_sorted(sdc, form.load(lv), mode))
        post_new = form.store(vn_posterior_sorted(sdc, form.prior(x), form.load(lc2v_new)[perm]))
        lc2v = torch.where(run, lc2v_new, lc2v)
        post = torch.where(run, post_new, post)
        if early_term or it == iterations - 1:
            bad = packed_bad(tables, (form.load(post) <= 0) & run, F)
            done, iscw, iters = _check(bad, done, iscw, iters, early_term)
    return _output(form, post, B, iters, iscw, iterations, early_term)


def assert_agrees(jout, tout, dtype, form, tol):
    """``jout``: (llr_out, iterations, is_codeword) of the JAX side; ``tol``:
    (rtol, atol) of the float32 and bf16 BP posteriors."""
    j_llr, j_it, j_cw = (np.asarray(x) for x in jout)
    if form != "BP":
        np.testing.assert_array_equal(tout.llr_out.numpy(), j_llr)
        np.testing.assert_array_equal(tout.iterations.numpy(), j_it)
        np.testing.assert_array_equal(tout.is_codeword.numpy(), j_cw)
        return
    agree = (tout.hard.numpy() == (j_llr <= 0)).all(0) & (tout.iterations.numpy() == j_it)
    assert agree.mean() >= 0.999
    np.testing.assert_allclose(tout.llr_out.numpy()[:, agree], j_llr[:, agree],
                               rtol=tol[0], atol=tol[1])


def assert_same(got, want):
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


# ----------------------------------------------------------- K1, flooding


@pytest.fixture(scope="module")
def flood_setup():
    code = make_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True)
    pdc = to_pallas_device(code)
    tables = kernel_tables(to_sorted_device(code_from_jax(code), "cpu"))
    return pdc, tables, awgn_llrs(code, pdc.sorted_dc.vn_perm, 128, 1.0, seed=3)


@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("dtype,form", CASES)
def test_flood_tile_batch_matches_pallas_kernel(flood_setup, dtype, form, early_term):
    pdc, tables, llr = flood_setup
    jout = bp_decode_pallas(pdc, jnp.asarray(llr), iterations=8, early_term=early_term,
                            minsum_mode=form, batch_tile=128, interpret=True,
                            message_dtype=dtype, quant_scale=SCALE,
                            permute="mxu" if dtype == "int8" else "benes")
    tout = flood_tile_batch(tables, torch.from_numpy(llr), 8, early_term, form,
                            MessageForm(dtype, SCALE), 16)
    tol = (2 ** -8, 2 ** -8) if dtype == "bfloat16" else (1e-4, 1e-4)
    assert_agrees((jout.llr_out, jout.iterations, jout.is_codeword), tout, dtype, form, tol)


@pytest.mark.parametrize("F", [16, 8, 4])
@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("dtype,form", CASES + [("float32", ("BP_NMS", 0.75, 0.15)),
                                                ("float32", "BP_PHI")])
def test_flood_tile_batch_matches_plain(flood_setup, dtype, form, early_term, F):
    """Bit for bit the port's plain version (the sorted decoder), at a
    batch that is not a multiple of F, one iteration included."""
    _, tables, llr = flood_setup
    x = torch.from_numpy(llr[:, :37].copy())
    for iterations in (1, 6):
        got = flood_tile_batch(tables, x, iterations, early_term, form, MessageForm(dtype, SCALE), F)
        want = df.bp_decode_fused_plain(tables, x, iterations, early_term, form, dtype, SCALE)
        assert_same(got, want)


def test_packed_bad_is_the_syndrome(flood_setup):
    """The packed words give each frame's syndrome, whatever the block."""
    _, tables, llr = flood_setup
    x = torch.from_numpy(np.where(llr <= 0, -1.0, 1.0).astype(np.float32))
    want = ~syndrome_ok_from_posterior(tables.code, x.index_select(0, tables.code.col_sorted))
    for F in (16, 8, 4):
        assert torch.equal(packed_bad(tables, torch.from_numpy(llr <= 0), F), want)
