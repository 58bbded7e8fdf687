"""The layered schedule of the port against the JAX package on the same
numpy LLRs: the exact layered decoder, the fast QC engine (against the
NumPy golden ``tests/golden.py:layered_qc_golden`` and the JAX lanes kernel
in interpret mode), the layer tables, and the schedule the driver picks.

Tolerances: the min-sum family matches bit for bit (decisions, iteration
counts, codeword flags, posteriors); the transcendental forms match in
decisions and iteration counts on >= 99% of frames (all at these seeds) and
within rtol 1e-4 on those posteriors, the discipline of
``tests/test_torch_sorted.py``.  The tanh form's posteriors are held to
1e-1: its extrinsics sit at the ill-conditioned 2*atanh cap, where one ulp
of a tanh-domain product moves an extrinsic by ~0.5 (5e-2 in flooding),
and the exact schedule recomputes every posterior from them after each of
the layers.  Against the JAX lanes kernel
and the golden, whose box-plus runs through other exp/log1p roundings, BP
posteriors are held to atol 1e-3 as the JAX package's own test does."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from golden import layered_qc_golden
from libldpc_tpu.models import make_benchmark_code, make_qc_benchmark_code, qc_natural_layers, wifi_code
from libldpc_tpu.ops import sorted as jsorted
from libldpc_tpu.ops.pallas.decode_lanes import bp_decode_lanes
from libldpc_tpu.ops.pallas.lanes_layout import to_lanes_device
from libldpc_tpu.sim.driver import Simulator as JaxSimulator
from libldpc_tpu.utils.params import ChannelParams, DecoderParams, SimulationParams
from libldpc_tpu_torch import convert
from libldpc_tpu_torch import models as tmodels
from libldpc_tpu_torch.convert import code_from_jax
from libldpc_tpu_torch.ops import layered
from libldpc_tpu_torch.ops import sorted as tsorted
from libldpc_tpu_torch.ops.kernels import decode_layered as dl
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.sim.driver import Simulator, route

from test_torch_sorted import MINSUM, TRANSCENDENTAL, awgn_llrs, compare, jax_fields

torch.set_num_threads(2)


def two_layer_code():
    """A (3,6) code without QC structure, split into even and odd checks."""
    code = dataclasses.replace(make_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True))
    code.layers = [np.arange(0, code.mc, 2, dtype=np.int32), np.arange(1, code.mc, 2, dtype=np.int32)]
    return code


def natural_qc_code(nc, Z):
    code = make_qc_benchmark_code(nc, Z, dv=3, dc=6, seed=5)
    qc_natural_layers(code)
    return code


@pytest.fixture(scope="module")
def two_layer():
    code = two_layer_code()
    return (code, jsorted.to_sorted_device(code, with_layers=True),
            tsorted.to_sorted_device(code_from_jax(code), "cpu", with_layers=True))


@pytest.fixture(scope="module")
def wifi1944():
    code = wifi_code(1944)
    return code, kernel_tables(tsorted.to_sorted_device(code_from_jax(code), "cpu", with_layers=True))


# ---------------------------------------------------------------- tables


def test_layer_masks_equal_jax(two_layer):
    _, jsdc, tsdc = two_layer
    np.testing.assert_array_equal(tsdc.layer_edge_masks.numpy(), np.asarray(jsdc.layer_edge_masks))
    fields = jax_fields(jsdc)
    fields["layer_edge_masks"] = np.asarray(jsdc.layer_edge_masks)
    carried = convert.from_sorted_device(fields)
    assert torch.equal(carried.layer_edge_masks, tsdc.layer_edge_masks)


def test_layer_check_lists(two_layer):
    code, _, tsdc = two_layer
    tables = kernel_tables(tsdc)
    cn_perm = np.argsort(np.bincount(code.rows, minlength=code.mc), kind="stable")
    ptr, checks = tables.layer_ptr.numpy(), tables.layer_checks.numpy()
    assert tables.n_layers == 2 and ptr.tolist() == [0, 24, 48]
    for li, layer in enumerate(code.layers):
        assert sorted(cn_perm[checks[ptr[li]:ptr[li + 1]]]) == sorted(layer)
    assert not tables.layers_disjoint  # even and odd checks share variables
    assert kernel_tables(tsorted.to_sorted_device(code_from_jax(code), "cpu")).n_layers == 0


@pytest.mark.parametrize("Z", [81, 128])
def test_qc_layer_tables_equal_jax_segments(Z):
    """Per layer and lift ``j``, the port's check and its slots in CN
    position order reach the same variables as the JAX engine's segments
    ``(ac, col_lane, s)`` (lift ``j`` of a segment reads lane
    ``col_lane + (j + s) mod Z``)."""
    code = wifi_code(1944) if Z == 81 else natural_qc_code(8 * Z, Z)
    ldc = to_lanes_device(code, transport="qc", with_layers=True)
    assert ldc.qc_layers and layered.natural_qc_layers(code_from_jax(code))
    tables = kernel_tables(tsorted.to_sorted_device(code_from_jax(code), "cpu", with_layers=True))
    assert tables.layers_disjoint and tables.n_layers == len(ldc.qc_layers)
    cn_inv = np.empty(code.mc, np.int64)
    cn_inv[np.argsort(np.bincount(code.rows, minlength=code.mc), kind="stable")] = np.arange(code.mc)
    row_ptr, col = tables.row_ptr.numpy(), tables.code.col_sorted.numpy()
    ptr, checks = tables.layer_ptr.numpy(), tables.layer_checks.numpy()
    vn_of_lane = np.asarray(ldc.vn_of_lane)
    for r, segs in enumerate(ldc.qc_layers):
        lifts = cn_inv[r * Z + np.arange(Z)]
        assert sorted(checks[ptr[r]:ptr[r + 1]]) == sorted(lifts)
        for j, chk in enumerate(lifts):
            got = col[row_ptr[chk]:row_ptr[chk + 1]]
            want = [vn_of_lane[lane + (j + s) % Z] for _, lane, s in segs]
            np.testing.assert_array_equal(got, want)


def test_natural_qc_layers():
    code = tmodels.wifi_code(648)
    assert layered.natural_qc_layers(code)
    code.layers = code.layers[::-1]
    assert not layered.natural_qc_layers(code)  # a layer order that is not natural
    assert not layered.natural_qc_layers(code_from_jax(two_layer_code()))  # no QC metadata


# ---------------------------------------------------------- exact layered


@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("form", MINSUM + TRANSCENDENTAL)
def test_exact_layered_matches_jax(two_layer, form, early_term):
    code, jsdc, tsdc = two_layer
    mode = DecoderParams(type=form).cn_mode
    llr = awgn_llrs(code, jsdc.vn_perm, 16, 1.0, seed=3)
    jout = jax.jit(lambda l: jsorted.bp_decode_sorted(jsdc, l, 12, early_term, mode, layered=True))(
        jnp.asarray(llr))
    tout = tsorted.bp_decode_sorted(tsdc, torch.from_numpy(llr), 12, early_term, mode, layered=True)
    rtol = 1e-5 if form in MINSUM else (1e-1 if form == "BP_TANH" else 1e-4)
    compare(jout, tout, exact=form in MINSUM, rtol=rtol)
    if form in MINSUM:
        np.testing.assert_array_equal(tout.llr_out.numpy(), np.asarray(jout.llr_out))


def test_exact_layered_wrapper_is_plain_on_cpu(two_layer):
    code, jsdc, tsdc = two_layer
    tables = kernel_tables(tsdc)
    llr = torch.from_numpy(awgn_llrs(code, jsdc.vn_perm, 8, 1.0, seed=4))
    launches = dict(dl.bp_decode_layered.launches)
    got = dl.bp_decode_layered(tables, llr, 10, True, "BP_MS")
    want = tsorted.bp_decode_sorted(tsdc, llr, 10, True, "BP_MS", layered=True)
    assert dl.bp_decode_layered.launches == launches
    assert torch.equal(got.llr_out, want.llr_out) and torch.equal(got.iterations, want.iterations)
    zero = dl.bp_decode_layered(tables, llr, 0)
    assert not zero.llr_out.any() and not zero.is_codeword.any()
    with pytest.raises(ValueError, match=">= 2 layers"):
        dl.bp_decode_layered(kernel_tables(tsorted.to_sorted_device(code_from_jax(code), "cpu")), llr, 5)


def test_exact_layered_single_layer_is_flooding(two_layer):
    code, jsdc, _ = two_layer
    one = code_from_jax(dataclasses.replace(code, layers=[np.arange(code.mc, dtype=np.int32)]))
    tsdc = tsorted.to_sorted_device(one, "cpu", with_layers=True)
    llr = torch.from_numpy(awgn_llrs(code, jsdc.vn_perm, 8, 1.0, seed=5))
    a = tsorted.bp_decode_sorted(tsdc, llr, 8, True, "BP_MS", layered=True)
    b = tsorted.bp_decode_sorted(tsdc, llr, 8, True, "BP_MS")
    assert torch.equal(a.llr_out, b.llr_out) and torch.equal(a.iterations, b.iterations)


# ------------------------------------------------------------ fast engine


@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("form", ["BP_MS", ("BP_NMS", 0.75, 0.15), ("BP_OMS", 0.75, 0.15), "BP"])
def test_fast_engine_matches_golden(wifi1944, form, early_term):
    code, tables = wifi1944
    rng = np.random.default_rng(7)
    sigma2 = 10 ** (-1.5 / 10)
    llr = (2.0 * (1.0 + rng.normal(size=(code.nc, 8)) * np.sqrt(sigma2)) / sigma2).astype(np.float32)
    vperm, vinv = tables.code.vn_perm.numpy(), tables.code.vn_inv.numpy()
    g_llr, g_it, g_cw = layered_qc_golden(code, llr, iterations=8, early_term=early_term,
                                          minsum_mode=form)
    launches = dict(dl.bp_decode_layered_fast.launches)
    out = dl.bp_decode_layered_fast(tables, torch.from_numpy(np.ascontiguousarray(llr[vperm])), 8,
                                    early_term, form)
    assert dl.bp_decode_layered_fast.launches == launches  # CPU: the plain version
    np.testing.assert_array_equal(out.iterations.numpy(), g_it)
    np.testing.assert_array_equal(out.is_codeword.numpy(), g_cw)
    if form == "BP":
        np.testing.assert_allclose(out.llr_out.numpy()[vinv], g_llr, atol=1e-3)
    else:
        np.testing.assert_array_equal(out.llr_out.numpy()[vinv], g_llr)


@pytest.mark.parametrize("form", ["BP_MS", "BP"])
@pytest.mark.parametrize("Z", [81, 128])
def test_fast_engine_matches_jax_lanes_kernel(Z, form):
    code = natural_qc_code(8 * Z, Z)
    ldc = to_lanes_device(code, transport="qc", with_layers=True)
    tables = kernel_tables(tsorted.to_sorted_device(code_from_jax(code), "cpu", with_layers=True))
    llr = awgn_llrs(code, ldc.sorted_dc.vn_perm, 16, 1.5, seed=7)
    jout = bp_decode_lanes(ldc, jnp.asarray(llr), iterations=8, early_term=True, minsum_mode=form,
                           layered=True, interpret=True)
    tout = layered.bp_decode_layered_fast_plain(tables, torch.from_numpy(llr), 8, True, form)
    np.testing.assert_array_equal(tout.iterations.numpy(), np.asarray(jout.iterations))
    np.testing.assert_array_equal(tout.is_codeword.numpy(), np.asarray(jout.is_codeword))
    if form == "BP":
        np.testing.assert_allclose(tout.llr_out.numpy(), np.asarray(jout.llr_out), atol=1e-3)
    else:
        np.testing.assert_array_equal(tout.llr_out.numpy(), np.asarray(jout.llr_out))


def test_fast_engine_converges_faster_than_flooding(wifi1944):
    code, tables = wifi1944
    llr = torch.from_numpy(awgn_llrs(code, tables.code.vn_perm, 16, 1.5, seed=11))
    fast = dl.bp_decode_layered_fast(tables, llr, 30, True, "BP")
    flood = tsorted.bp_decode_sorted(tables.code, llr, 30, True, "BP")
    assert fast.iterations.sum() < flood.iterations.sum()
    assert fast.is_codeword.sum() >= flood.is_codeword.sum()


def test_fast_engine_refuses_shared_variables(two_layer):
    _, _, tsdc = two_layer
    with pytest.raises(ValueError, match="at most once"):
        dl.bp_decode_layered_fast(kernel_tables(tsdc), torch.zeros(tsdc.nc, 4), 5)


# ----------------------------------------------------------- the schedule


def _jax_decode_path(code, dec, use_pallas):
    sim = JaxSimulator(code, dec, ChannelParams(seed=1, x_range=(1.0, 2.0, 1.0)),
                       SimulationParams(batch_size=32, fec=3, max_frames=128),
                       use_pallas=use_pallas, verbose=False)
    return [p for p in sim.decode_path.split() if p.split("=")[0] in ("schedule", "streaming")]


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("name", ["wifi648", "wifi1296", "wifi1944", "two_layer96", "qc1024",
                                  "qc2048"])
def test_schedule_matches_jax_decode_path(name, use_pallas):
    code = {
        "wifi648": lambda: wifi_code(648, with_G=False),
        "wifi1296": lambda: wifi_code(1296, with_G=False),
        "wifi1944": lambda: wifi_code(1944, with_G=False),
        "two_layer96": two_layer_code,
        "qc1024": lambda: natural_qc_code(8 * 128, 128),  # Beneš pad 4096: edge-major, exact
        "qc2048": lambda: natural_qc_code(16 * 128, 128),  # pad 8192: qc lanes, fast
    }[name]()
    tcode = code_from_jax(code)
    for early_term in (True, False):
        dec = DecoderParams(iterations=8, layered=True, early_term=early_term)
        sim = Simulator(tcode, dec, ChannelParams(seed=1, x_range=(1.0, 2.0, 1.0)),
                        SimulationParams(batch_size=32, fec=3, max_frames=128),
                        device="cpu", verbose=False, use_pallas=use_pallas)
        port = [p for p in sim.decode_path.split() if p.split("=")[0] in ("schedule", "streaming")]
        assert port == _jax_decode_path(code, dec, use_pallas)
        assert sim.schedule == route(tcode, dec, use_pallas)[0]
    assert route(tcode, DecoderParams(), use_pallas)[0] == "flooding"
