"""The port's sorted layout and plain flooding decoder against
:mod:`libldpc_tpu.ops.sorted` on the same numpy LLRs.

Tables are equal entry for entry.  Decoding: the min-sum family agrees
exactly on decisions, iteration counts and codeword flags; ``BP_MS`` and
``BP_OMS`` posteriors bit for bit, ``BP_NMS`` posteriors within 1e-5 of the
jitted JAX decoder (compiled, XLA rounds the scaled messages' sums
otherwise) and bit for bit against the JAX decoder run op by op
(``jax.disable_jit``); the transcendental forms agree on >= 99% of frames (all at these seeds) and
within 1e-4 on those, the discipline of tests/test_pallas.py.  The tanh
form is the exception for posteriors: its extrinsics sit near the
2*atanh(TANH_CLIP) ~ 17.3 cap, where one ulp of a tanh-domain product moves
the extrinsic by ~0.5, so its posteriors are held to 5e-2 (its decisions
and iteration counts to the same 99%)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libldpc_tpu.models import make_benchmark_code, wifi_code
from libldpc_tpu.ops import sorted as jsorted
from libldpc_tpu.utils.params import DecoderParams
from libldpc_tpu_torch import convert
from libldpc_tpu_torch.convert import code_from_jax
from libldpc_tpu_torch.ops import sorted as tsorted

torch.set_num_threads(2)

MINSUM = ["BP_MS", "BP_NMS", "BP_OMS"]
TRANSCENDENTAL = ["BP", "BP_PHI", "BP_TANH", "BP_LIN"]
FIELDS = ["col_sorted", "perm_c2v", "bit_pos", "puncture", "shorten", "vn_perm", "vn_inv", "G"]


@pytest.fixture(scope="module")
def setup():
    code = make_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True)
    return code, jsorted.to_sorted_device(code), tsorted.to_sorted_device(code_from_jax(code), "cpu")


def awgn_llrs(code, vn_perm, B, snr_db, seed):
    """Channel LLRs made with numpy, in the sorted labelling."""
    rng = np.random.default_rng(seed)
    sigma2 = 10 ** (-snr_db / 10)
    llr = np.zeros((code.nc, B), np.float32)
    y = 1.0 + rng.normal(size=(code.nct, B)) * np.sqrt(sigma2)
    llr[code.bit_pos] = 2.0 * y / sigma2
    return np.ascontiguousarray(llr[np.asarray(vn_perm)])


def jax_fields(jsdc):
    out = {f: (None if getattr(jsdc, f) is None else np.asarray(getattr(jsdc, f)))
           for f in FIELDS}
    out.update(cn_classes=jsdc.cn_classes, vn_classes=jsdc.vn_classes)
    return out


def assert_same_tables(jsdc, tsdc):
    assert (tsdc.nc, tsdc.mc, tsdc.nnz) == (jsdc.nc, jsdc.mc, jsdc.nnz)
    assert tsdc.cn_classes == jsdc.cn_classes and tsdc.vn_classes == jsdc.vn_classes
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tsdc, f).numpy(), np.asarray(getattr(jsdc, f)), f)


def compare(jout, tout, exact, rtol):
    hard_j, hard_t = np.asarray(jout.hard), tout.hard.numpy()
    it_j, it_t = np.asarray(jout.iterations), tout.iterations.numpy()
    agree = (hard_j == hard_t).all(0) & (it_j == it_t)
    if exact:
        assert agree.all()
        np.testing.assert_array_equal(tout.is_codeword.numpy(), np.asarray(jout.is_codeword))
    else:
        assert agree.mean() >= 0.99
    got, want = tout.llr_out.numpy()[:, agree], np.asarray(jout.llr_out)[:, agree]
    if rtol == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)


def test_tables_equal_jax(setup):
    _, jsdc, tsdc = setup
    assert_same_tables(jsdc, tsdc)


def test_tables_through_convert(setup):
    _, jsdc, tsdc = setup
    assert_same_tables(jsdc, convert.from_sorted_device(jax_fields(jsdc)))


def test_to_device_roundtrip(setup):
    _, jsdc, tsdc = setup
    assert_same_tables(jsdc, tsdc.to("cpu"))
    assert tsdc.max_dc == 6 and tsdc.kc == tsdc.G.shape[0]


@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("form", MINSUM + TRANSCENDENTAL)
def test_decoder_matches_jax(setup, form, early_term):
    code, jsdc, tsdc = setup
    mode = DecoderParams(type=form).cn_mode
    llr = awgn_llrs(code, jsdc.vn_perm, 64, 1.0, seed=3)
    jout = jax.jit(lambda l: jsorted.bp_decode_sorted(jsdc, l, 12, early_term, mode))(
        jnp.asarray(llr))
    tout = tsorted.bp_decode_sorted(tsdc, torch.from_numpy(llr), 12, early_term, mode)
    rtol = {"BP_MS": 0, "BP_OMS": 0, "BP_NMS": 1e-5, "BP_TANH": 5e-2}.get(form, 1e-4)
    compare(jout, tout, exact=form in MINSUM, rtol=rtol)


@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("name", ["bench96", "wifi648"])
def test_nms_bit_exact_against_jax_op_by_op(setup, name, early_term):
    """``BP_NMS`` on the main path's decoder: the JAX decoder run op by op
    (each op rounded on its own) gives the port's posteriors bit for bit."""
    if name == "bench96":
        code, jsdc, tsdc = setup
    else:
        code = wifi_code(648)
        jsdc = jsorted.to_sorted_device(code)
        tsdc = tsorted.to_sorted_device(code_from_jax(code), "cpu")
    mode = DecoderParams(type="BP_NMS").cn_mode
    llr = awgn_llrs(code, jsdc.vn_perm, 32, 1.0, seed=4)
    with jax.disable_jit():
        jout = jsorted.bp_decode_sorted(jsdc, jnp.asarray(llr), 12, early_term, mode)
    tout = tsorted.bp_decode_sorted(tsdc, torch.from_numpy(llr), 12, early_term, mode)
    compare(jout, tout, exact=True, rtol=0)


def test_wifi_648_xla_only(setup):
    """802.11n n=648 (irregular, Z=27): tables and BP decoding agree."""
    code = wifi_code(648)
    jsdc, tsdc = jsorted.to_sorted_device(code), tsorted.to_sorted_device(code_from_jax(code), "cpu")
    assert_same_tables(jsdc, tsdc)
    llr = awgn_llrs(code, jsdc.vn_perm, 32, 1.5, seed=5)
    jout = jax.jit(lambda l: jsorted.bp_decode_sorted(jsdc, l, 10, True, "BP"))(jnp.asarray(llr))
    tout = tsorted.bp_decode_sorted(tsdc, torch.from_numpy(llr), 10, True, "BP")
    compare(jout, tout, exact=False, rtol=1e-4)


def test_zero_iterations(setup):
    code, jsdc, tsdc = setup
    llr = awgn_llrs(code, jsdc.vn_perm, 8, 1.0, seed=1)
    out = tsorted.bp_decode_sorted(tsdc, torch.from_numpy(llr), 0)
    assert not out.hard.any() and out.is_codeword.all() and not out.iterations.any()
