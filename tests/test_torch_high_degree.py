"""A code whose checks have degree 36, past the degree up to which the CUDA
check combine is unrolled: the port's plain decoders (flooding, BEC
peeling; the exact layered schedule is in
``test_torch_high_degree_layered.py``) against the JAX package on the CPU,
on the same numpy inputs, and ``make_regular_code``'s regularity.

Tolerances as for the other codes: the min-sum family and the BEC agree bit
for bit (decisions, iteration counts, codeword or resolution flags;
posteriors within 1e-5, the XLA decoder may sum a node's messages in
another order); BP agrees in decisions and iteration counts on >= 99 % of
frames and within 1e-4 on those posteriors."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libldpc_tpu import models as jm
from libldpc_tpu.ops import sorted as jsorted
from libldpc_tpu.ops.bec_sorted import bec_decode_sorted as jax_bec_decode_sorted
from libldpc_tpu.utils.params import DecoderParams
from libldpc_tpu_torch import models as tm
from libldpc_tpu_torch.convert import code_from_jax
from libldpc_tpu_torch.ops import sorted as tsorted
from libldpc_tpu_torch.ops.channel import BEC_ERASURE
from libldpc_tpu_torch.ops.kernels import decode_bec as db
from libldpc_tpu_torch.ops.kernels import decode_fused as df
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables

from test_torch_sorted import awgn_llrs, compare

torch.set_num_threads(2)

#: the min-sum family with early termination on and off; BP (whose
#: degree-36 box-plus chain takes XLA ~20 s to compile) with it on
FLOODING_CASES = [(f, et) for f in ("BP_MS", "BP_NMS", "BP_OMS") for et in (True, False)] + [
    ("BP", True)]
SNR_DB = 6.5  # the (3,36) code has rate 11/12: its waterfall is near here


def row_degrees(code):
    return np.bincount(code.rows, minlength=code.mc)


@pytest.fixture(scope="module")
def dc36():
    """The (1152, 3, 36) code at seed 1 with its checks split into even and
    odd layers: the JAX sorted code, the port's, and the kernel tables."""
    jcode = dataclasses.replace(jm.make_regular_code(1152, 3, 36, seed=1))
    assert (row_degrees(jcode) == 36).all()
    jcode.layers = [np.arange(0, jcode.mc, 2, dtype=np.int32),
                    np.arange(1, jcode.mc, 2, dtype=np.int32)]
    tsdc = tsorted.to_sorted_device(code_from_jax(jcode), "cpu", with_layers=True)
    return jcode, jsorted.to_sorted_device(jcode, with_layers=True), tsdc, kernel_tables(tsdc)


def test_tables_carry_the_degree(dc36):
    _, jsdc, tsdc, tables = dc36
    assert tsdc.cn_classes == jsdc.cn_classes == ((96, 36),)
    assert tables.max_dc == 36 and tables.n_layers == 2


@pytest.mark.parametrize("form,early_term", FLOODING_CASES)
def test_flooding_matches_jax(dc36, form, early_term):
    jcode, jsdc, tsdc, tables = dc36
    mode = DecoderParams(type=form).cn_mode
    llr = awgn_llrs(jcode, jsdc.vn_perm, 32, SNR_DB, seed=3)
    jout = jax.jit(lambda l: jsorted.bp_decode_sorted(jsdc, l, 10, early_term, mode))(
        jnp.asarray(llr))
    launches = dict(df.bp_decode_fused.launches)
    tout = df.bp_decode_fused(tables, torch.from_numpy(llr), 10, early_term, mode)
    assert df.bp_decode_fused.launches == launches  # CPU: the plain version, no refusal
    compare(jout, tout, exact=form != "BP", rtol=1e-4 if form == "BP" else 1e-5)
    if early_term:
        its = tout.iterations.numpy()
        assert 0 < its.mean() < 10  # some frames converge, some work is done


@pytest.mark.parametrize("stale", [None, 0])
@pytest.mark.parametrize("early_term", [True, False])
def test_bec_matches_jax(dc36, early_term, stale):
    jcode, jsdc, tsdc, tables = dc36
    rng = np.random.default_rng(5)
    cw = np.zeros((jcode.nc, 48), np.uint8)  # no generator: the all-zero codeword
    sym = np.where(rng.random(cw.shape) < 0.04, BEC_ERASURE, cw).astype(np.uint8)
    jout = jax_bec_decode_sorted(jsdc, jnp.asarray(sym.astype(np.int8)), jnp.asarray(cw), 20,
                                 early_term, stale)
    tout = db.bec_decode_fused(tables, torch.from_numpy(sym), torch.from_numpy(cw), 20,
                               early_term, stale)
    np.testing.assert_array_equal(np.asarray(jout.symbols_out).astype(np.uint8),
                                  tout.symbols_out.numpy())
    np.testing.assert_array_equal(np.asarray(jout.hard).astype(np.uint8), tout.hard.numpy())
    np.testing.assert_array_equal(np.asarray(jout.iterations), tout.iterations.numpy())
    np.testing.assert_array_equal(np.asarray(jout.resolved), tout.resolved.numpy())
    assert tout.resolved.any() and (tout.iterations > 0).any()


# ------------------------------------------------------- make_regular_code


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("nc", [1152, 432])
def test_regular_code_is_exactly_regular(nc, seed):
    """Every check of degree 36, every variable of degree 3, no repeated
    edge; and the JAX package's code wherever that one is regular (its
    duplicate repair can change a check's degree)."""
    code = tm.make_regular_code(nc, 3, 36, seed=seed)
    assert (row_degrees(code) == 36).all()
    assert (np.bincount(code.cols, minlength=nc) == 3).all()
    assert np.unique(code.rows.astype(np.int64) * nc + code.cols).size == code.rows.size
    jcode = jm.make_regular_code(nc, 3, 36, seed=seed)
    if (row_degrees(jcode) == 36).all():
        np.testing.assert_array_equal(code.rows, jcode.rows)
        np.testing.assert_array_equal(code.cols, jcode.cols)


def test_jax_repair_is_what_breaks_regularity():
    """The case the port repairs: at seed 0 the JAX package's (1152, 3, 36)
    code has checks of degree 35 and 37."""
    assert set(row_degrees(jm.make_regular_code(1152, 3, 36, seed=0))) == {35, 36, 37}


@pytest.mark.parametrize("nc,dv,dc,seed", [(1152, 3, 6, 0), (1152, 3, 6, 1), (1152, 3, 6, 2),
                                          (128, 4, 8, 3), (96, 3, 6, 7)])
def test_shipped_codes_do_not_move(nc, dv, dc, seed):
    code, jcode = tm.make_regular_code(nc, dv, dc, seed=seed), jm.make_regular_code(nc, dv, dc,
                                                                                   seed=seed)
    assert (row_degrees(code) == dc).all()
    np.testing.assert_array_equal(code.rows, jcode.rows)
    np.testing.assert_array_equal(code.cols, jcode.cols)


def test_benchmark_code_does_not_move():
    code = tm.make_benchmark_code(1152, 3, 6, seed=0, with_G=True)
    jcode = jm.make_benchmark_code(1152, 3, 6, seed=0, with_G=True)
    np.testing.assert_array_equal(code.rows, jcode.rows)
    np.testing.assert_array_equal(code.cols, jcode.cols)
    np.testing.assert_array_equal(code.G, jcode.G)
