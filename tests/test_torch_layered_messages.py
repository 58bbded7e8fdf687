"""The bfloat16 and int8 message forms of the layered schedules against the
JAX package, on the CPU, on the same numpy LLRs.

* The fast QC engine (plain version of K3) against ``bp_decode_lanes(...,
  layered=True)`` on the qc transport in interpret mode and against the
  NumPy golden ``tests/golden.py:layered_qc_golden``.
* The exact layered schedule (plain version of K5) against
  ``bp_decode_pallas(..., layered=True)`` (the MXU transport for int8, the
  JAX package's condition there) and ``bp_decode_lanes`` on the Clos
  transport, in interpret mode.
* The fast engine's stream (plain version of K4) against
  ``bp_stream_chunk_lanes(..., layered=True)`` (drained totals and final
  state) and against the batch decode of the same frames, whether they
  enter through the pool or are injected at age 0 (the prior's lattice
  scaling at both starts); a JAX int8 layered stream state carries into
  the port.
* Routing: the port's ``schedule=`` and ``dtype=`` against the JAX
  ``Simulator``'s ``decode_path``, with and without ``--pallas``, and
  past the qc layout's sub-32-bit walls (made small here); the CLI's int8
  BP_OMS layered sweep against the JAX CLI.

Tolerances: the int8 forms and bf16 min-sum are bit-exact in ``llr_out``,
``iterations`` and ``is_codeword``.  bf16 BP agrees in decisions and
iteration counts on >= 99.9 % of frames (all at these seeds) and within
atol 1e-3 plus one bf16 step (2^-8 relative) on their posteriors: the box-plus
runs through other exp/log1p roundings in XLA, NumPy and torch, and a
rounded message may then land on the other side of a bf16 step before the
APP accumulates it.  The exact schedule stores the posterior itself in
bf16 and recomputes it from every stored message after each layer, so such
a step compounds: its bf16 BP posteriors are held to 2^-4 (eight bf16
steps), relative and absolute.  The CLI sweeps draw different frames: FER
within |z| < 3 per point.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import libldpc_tpu.sim.driver as jax_driver
from golden import layered_qc_golden
from libldpc_tpu import cli as jax_cli
from libldpc_tpu.models import make_benchmark_code, make_qc_benchmark_code, qc_natural_layers, wifi_code
from libldpc_tpu.ops.pallas.decode_fused import bp_decode_pallas
from libldpc_tpu.ops.pallas.decode_lanes import bp_decode_lanes, bp_stream_chunk_lanes
from libldpc_tpu.ops.pallas.lanes_layout import to_lanes_device
from libldpc_tpu.ops.pallas.layout import to_pallas_device
from libldpc_tpu.ops.streaming_pallas import make_streaming_lanes_step
from libldpc_tpu.sim.driver import Simulator as JaxSimulator
from libldpc_tpu.utils import params as jparams
from libldpc_tpu_torch import cli, convert
from libldpc_tpu_torch.convert import code_from_jax
from libldpc_tpu_torch.models import write_codefile, write_layerfile
from libldpc_tpu_torch.ops import layered
from libldpc_tpu_torch.ops.kernels import decode_layered as dl
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.ops.messages import MessageForm
from libldpc_tpu_torch.ops.sorted import to_sorted_device
from libldpc_tpu_torch.ops.streaming_fused import init_state, make_streaming_fused_step
from libldpc_tpu_torch.sim import driver
from libldpc_tpu_torch.sim.driver import (
    ChannelParams, DecoderParams, SimulationParams, Simulator,
)

from test_torch_sim import _read
from test_torch_sorted import awgn_llrs
from test_torch_streaming import drain, frames

torch.set_num_threads(2)

SCALE = 0.1875
OMS = ("BP_OMS", 1.0, 0.375)  # offset 2.0 on the lattice
#: (message dtype, CN form): the cases held bit-exact, then bf16 BP
EXACT = [("int8", "BP_MS"), ("int8", OMS), ("bfloat16", "BP_MS")]
CASES = EXACT + [("bfloat16", "BP")]


def natural_qc_code(nc, Z, with_G=False):
    code = make_qc_benchmark_code(nc, Z, dv=3, dc=6, seed=5, with_G=with_G)
    qc_natural_layers(code)
    return code


def two_layer(code):
    """``code`` split into its first and second half of checks."""
    half = code.mc // 2
    return dataclasses.replace(code, layers=[np.arange(half, dtype=np.int32),
                                             np.arange(half, code.mc, dtype=np.int32)])


def assert_agrees(jout, tout, exact, tol=(2 ** -8, 1e-3)):
    """``jout``: (llr_out, iterations, is_codeword) of the JAX side; ``tol``
    the (rtol, atol) of bf16 BP's posteriors."""
    j_llr, j_it, j_cw = (np.asarray(x) for x in jout)
    if exact:
        np.testing.assert_array_equal(tout.llr_out.numpy(), j_llr)
        np.testing.assert_array_equal(tout.iterations.numpy(), j_it)
        np.testing.assert_array_equal(tout.is_codeword.numpy(), j_cw)
        return
    agree = (tout.hard.numpy() == (j_llr <= 0)).all(0) & (tout.iterations.numpy() == j_it)
    assert agree.mean() >= 0.999
    np.testing.assert_allclose(tout.llr_out.numpy()[:, agree], j_llr[:, agree],
                               rtol=tol[0], atol=tol[1])


# ------------------------------------------------------------ fast engine


@pytest.fixture(scope="module")
def qc_setups():
    out = {}
    for Z in (81, 128):
        code = natural_qc_code(8 * Z, Z)
        ldc = to_lanes_device(code, transport="qc", with_layers=True)
        tables = kernel_tables(to_sorted_device(code_from_jax(code), "cpu", with_layers=True))
        out[Z] = (code, ldc, tables, awgn_llrs(code, ldc.sorted_dc.vn_perm, 16, 1.5, seed=7))
    return out


@pytest.mark.parametrize("Z,dtype,form", [(81, "int8", "BP_MS"), (81, "bfloat16", "BP_MS"),
                                          (81, "bfloat16", "BP"), (128, "int8", OMS),
                                          (128, "bfloat16", "BP")])
def test_fast_engine_matches_jax_lanes_kernel(qc_setups, Z, dtype, form):
    _, ldc, tables, llr = qc_setups[Z]
    jout = bp_decode_lanes(ldc, jnp.asarray(llr), iterations=8, early_term=True, minsum_mode=form,
                           layered=True, message_dtype=dtype, quant_scale=SCALE, interpret=True)
    launches = dict(dl.bp_decode_layered_fast.launches)
    tout = dl.bp_decode_layered_fast(tables, torch.from_numpy(llr), 8, True, form, dtype, SCALE)
    assert dl.bp_decode_layered_fast.launches == launches  # CPU: the plain version
    assert_agrees((jout.llr_out, jout.iterations, jout.is_codeword), tout,
                  (dtype, form) in EXACT)
    np.testing.assert_array_equal(tout.hard.numpy(), tout.llr_out.numpy() <= 0)


@pytest.fixture(scope="module")
def wifi1944():
    code = wifi_code(1944)
    return code, kernel_tables(to_sorted_device(code_from_jax(code), "cpu", with_layers=True))


@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("dtype,form", CASES)
def test_fast_engine_matches_golden(wifi1944, dtype, form, early_term):
    code, tables = wifi1944
    rng = np.random.default_rng(7)
    sigma2 = 10 ** (-1.5 / 10)
    llr = (2.0 * (1.0 + rng.normal(size=(code.nc, 8)) * np.sqrt(sigma2)) / sigma2).astype(np.float32)
    vperm, vinv = tables.code.vn_perm.numpy(), tables.code.vn_inv.numpy()
    g_llr, g_it, g_cw = layered_qc_golden(code, llr, iterations=8, early_term=early_term,
                                          minsum_mode=form, message_dtype=dtype,
                                          quant_scale=SCALE)
    out = layered.bp_decode_layered_fast_plain(
        tables, torch.from_numpy(np.ascontiguousarray(llr[vperm])), 8, early_term, form,
        MessageForm(dtype, SCALE))
    out = out._replace(llr_out=out.llr_out[vinv], hard=out.hard[vinv])
    assert_agrees((g_llr, g_it, g_cw), out, (dtype, form) in EXACT)


def test_fast_engine_int8_keeps_app_off_the_lattice(wifi1944):
    """The APP accumulates in float32 and is not requantised: the output is
    not a multiple of the lattice step, while the check messages are."""
    code, tables = wifi1944
    llr = torch.from_numpy(awgn_llrs(code, tables.code.vn_perm, 8, 1.5, seed=2))
    form = MessageForm("int8", SCALE)
    app = form.prior(llr)
    lc2v = torch.zeros((tables.code.nnz, 8), dtype=torch.int8)
    layered.layered_fast_pass(tables, app, lc2v, torch.zeros(8, dtype=torch.bool), "BP_MS", form)
    assert lc2v.any() and not torch.equal(app, torch.round(app))
    out = dl.bp_decode_layered_fast(tables, llr, 1, False, "BP_MS", "int8", SCALE)
    assert torch.equal(out.llr_out, app * torch.tensor(SCALE))


# ---------------------------------------------------------- exact schedule


@pytest.fixture(scope="module")
def exact_setup():
    code = two_layer(make_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True))
    pdc = to_pallas_device(code, with_layers=True)
    assert pdc.mxu_blocks_fwd is not None
    tables = kernel_tables(to_sorted_device(code_from_jax(code), "cpu", with_layers=True))
    return pdc, tables, awgn_llrs(code, pdc.sorted_dc.vn_perm, 128, 1.0, seed=3)


@pytest.mark.parametrize("dtype,form,early_term", [c + (True,) for c in CASES]
                         + [("int8", OMS, False), ("bfloat16", "BP", False)])
def test_exact_schedule_matches_pallas_kernel(exact_setup, dtype, form, early_term):
    pdc, tables, llr = exact_setup
    jout = bp_decode_pallas(pdc, jnp.asarray(llr), iterations=8, early_term=early_term,
                            minsum_mode=form, batch_tile=128, interpret=True, layered=True,
                            message_dtype=dtype, quant_scale=SCALE,
                            permute="mxu" if dtype == "int8" else "benes")
    launches = dict(dl.bp_decode_layered.launches)
    tout = dl.bp_decode_layered(tables, torch.from_numpy(llr), 8, early_term, form, dtype, SCALE)
    assert dl.bp_decode_layered.launches == launches
    assert_agrees((jout.llr_out, jout.iterations, jout.is_codeword), tout,
                  (dtype, form) in EXACT, tol=(2 ** -4, 2 ** -4))


@pytest.mark.parametrize("dtype,form", EXACT)
def test_exact_schedule_matches_lanes_kernel(dtype, form):
    code = two_layer(make_benchmark_code(128, dv=3, dc=6, seed=4, with_G=True))
    ldc = to_lanes_device(code, transport="clos", with_layers=True)
    tables = kernel_tables(to_sorted_device(code_from_jax(code), "cpu", with_layers=True))
    llr = awgn_llrs(code, ldc.sorted_dc.vn_perm, 16, 0.5, seed=8)
    jout = bp_decode_lanes(ldc, jnp.asarray(llr), iterations=6, early_term=True, minsum_mode=form,
                           layered=True, message_dtype=dtype, quant_scale=SCALE, frame_tile=8,
                           interpret=True)
    tout = dl.bp_decode_layered(tables, torch.from_numpy(llr), 6, True, form, dtype, SCALE)
    assert_agrees((jout.llr_out, jout.iterations, jout.is_codeword), tout, True)


def test_layered_forms_refuse_int8_bp(exact_setup):
    _, tables, llr = exact_setup
    x = torch.from_numpy(llr)
    for fn in (dl.bp_decode_layered, dl.bp_decode_layered_plain):
        with pytest.raises(ValueError, match="min-sum-family"):
            fn(tables, x, 4, True, "BP", "int8")


# ------------------------------------------------------------------ stream


@pytest.fixture(scope="module")
def stream_setup():
    code = natural_qc_code(8 * 128, 128, with_G=True)
    ldc = to_lanes_device(code, transport="qc", with_layers=True)
    tables = kernel_tables(to_sorted_device(code_from_jax(code), "cpu", with_layers=True))
    llr, cw = frames(code, tables.code.vn_perm, 32, 1.5, seed=5)
    return ldc, tables, llr, cw


def lanes_of(ldc, x, dtype):
    """Sorted-label ``[nc, B]`` -> lane space ``[B, nc_pad]``."""
    out = np.zeros((x.shape[1], ldc.nc_pad), dtype)
    out[:, np.asarray(ldc.lane_of_vn)] = x.T
    return out


def jax_layered_drain(ldc, llr, cw, dtype, form, cap, k):
    """The JAX layered stream kernel drained from a full pool; returns the
    totals and the final state (``LStreamState`` field names)."""
    B = llr.shape[1]
    col0 = jnp.zeros((B, 128), jnp.int32).at[:, 0].set(1)
    zeros = jnp.zeros((B, 128), jnp.int32)
    st = dict(llr_in=jnp.zeros((B, ldc.nc_pad), jnp.float32),
              codeword=jnp.zeros((B, ldc.nc_pad), jnp.int32),
              lv2c=jnp.zeros((B, ldc.n_pad), dtype), done=col0, iters=zeros, age=zeros,
              avail=col0, ctr=zeros)
    fresh_llr = jnp.asarray(lanes_of(ldc, llr, np.float32))
    fresh_cw = jnp.asarray(lanes_of(ldc, cw, np.int32))
    totals = np.zeros(5, np.int64)
    for step in range(20):
        out = bp_stream_chunk_lanes(
            ldc, st["llr_in"], st["codeword"], st["lv2c"], st["done"], st["iters"], st["age"],
            st["avail"], zeros, fresh_llr, fresh_cw, jnp.zeros((B, ldc.n_pad), dtype),
            jnp.int32(step == 0), jnp.int32(B), k=k, cap=cap, minsum_mode=form,
            message_dtype=dtype, quant_scale=SCALE, layered=True, interpret=True)
        st = dict(zip(("llr_in", "codeword", "lv2c", "done", "iters", "age", "avail", "ctr"),
                      out))
        totals += np.asarray(st["ctr"])[:, :5].sum(0)
        if int(np.asarray(st["done"])[:, 0].min()) == 1:
            st.update(ctr=zeros, fresh_llr=fresh_llr, fresh_cw=fresh_cw, started=jnp.zeros(1))
            return totals, st
    raise AssertionError("JAX streams did not drain")


def port_layered_drain(tables, llr, cw, dtype, form, cap, k, via_pool=True):
    """The port's plain layered chunk drained: frames from a full pool
    (reloads) or injected at age 0."""
    B = llr.shape[1]
    st = init_state(tables, B, message_dtype=dtype)
    if via_pool:
        st.fresh_llr.copy_(torch.from_numpy(llr))
        st.fresh_cw.copy_(torch.from_numpy(cw))
        st.avail.fill_(1)
    else:
        st.llr_in.copy_(torch.from_numpy(llr))
        st.codeword.copy_(torch.from_numpy(cw))
        st.done.zero_()
    totals = np.zeros(5, np.int64)
    for step in range(20):
        st.ctr.zero_()
        dl.bp_stream_chunk_layered_fast(
            tables, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail,
            st.ctr, st.fresh_llr, st.fresh_cw, torch.tensor([int(step == 0)], dtype=torch.int32),
            torch.tensor([B], dtype=torch.int32), k=k, cap=cap, minsum_mode=form,
            message_dtype=dtype, quant_scale=SCALE)
        totals += st.ctr.sum(1).numpy()
        if bool((st.done == 1).all()):
            return totals, st
    raise AssertionError("port streams did not drain")


@pytest.mark.parametrize("dtype,form", EXACT)
def test_stream_drains_like_jax_and_batch(stream_setup, dtype, form):
    ldc, tables, llr, cw = stream_setup
    B, cap = llr.shape[1], 10
    want, jst = jax_layered_drain(ldc, llr, cw, dtype, form, cap, k=4)
    got, st = port_layered_drain(tables, llr, cw, dtype, form, cap, k=4)
    np.testing.assert_array_equal(got, want)
    out = dl.bp_decode_layered_fast(tables, torch.from_numpy(llr), cap, True, form, dtype, SCALE)
    bit_pos = tables.code.bit_pos.numpy()
    errs = (out.hard.numpy()[bit_pos] != cw[bit_pos]).sum(0)
    np.testing.assert_array_equal(got, [errs.sum(), (errs > 0).sum(), B,
                                        out.iterations.sum().item(), B])
    # the final state, carried over lane by lane (reloads are granted in lane order)
    carried = convert.from_lstream_state({f: np.asarray(v) for f, v in jst.items()},
                                         tables.code.cn_classes, ldc.lane_of_vn, ldc.qc_z,
                                         ldc.qc_zq)
    for f in ("llr_in", "codeword", "lv2c", "done", "iters", "age", "avail"):
        assert torch.equal(getattr(carried, f), getattr(st, f)), f


@pytest.mark.parametrize("dtype,form", CASES)
def test_injected_stream_drains_like_batch(stream_setup, dtype, form):
    """Frames injected at age 0 start from the prior of the LLRs they carry
    (on the lattice, the LLRs times float32(1 / quant_scale))."""
    _, tables, llr, cw = stream_setup
    B, cap = llr.shape[1], 10
    got, _ = port_layered_drain(tables, llr, cw, dtype, form, cap, k=3, via_pool=False)
    out = dl.bp_decode_layered_fast(tables, torch.from_numpy(llr), cap, True, form, dtype, SCALE)
    bit_pos = tables.code.bit_pos.numpy()
    errs = (out.hard.numpy()[bit_pos] != cw[bit_pos]).sum(0)
    np.testing.assert_array_equal(got, [errs.sum(), (errs > 0).sum(), B,
                                        out.iterations.sum().item(), 0])


def test_int8_layered_state_from_jax_drains_alike(stream_setup):
    """One JAX int8 layered streaming super-step with reloads, its state
    carried into the port: both drain to the same totals."""
    ldc, tables, _, _ = stream_setup
    B = 32
    dec = jparams.DecoderParams(iterations=8, type="BP_MS", message_dtype="int8", layered=True)
    init_j, step_j = make_streaming_lanes_step(ldc, "AWGN", dec, B, chunk_iters=4,
                                               interpret=True)
    st_j, acc = step_j(init_j(), jax.random.PRNGKey(5), np.float32(1.5), jnp.asarray(True))
    assert int(acc.n_active) > 0
    state = convert.from_lstream_state({f: np.asarray(getattr(st_j, f)) for f in st_j._fields},
                                       tables.code.cn_classes, ldc.lane_of_vn, ldc.qc_z,
                                       ldc.qc_zq)
    assert state.lv2c.dtype == torch.int8 and state.lv2c.any()
    want = np.zeros(4, dtype=np.int64)
    for step in range(100):
        st_j, acc = step_j(st_j, jax.random.PRNGKey(100 + step), np.float32(1.5),
                           jnp.asarray(False))
        want += [int(acc.bit_errors), int(acc.frame_errors), int(acc.frames), int(acc.iter_sum)]
        if int(acc.n_active) == 0:
            break
    tdec = DecoderParams(iterations=8, type="BP_MS", message_dtype="int8")
    _, step_fn = make_streaming_fused_step(tables, "AWGN", tdec, B, chunk_iters=4, layered=True)
    np.testing.assert_array_equal(drain(step_fn, state), want)


# ---------------------------------------------------------------- routing


ROUTING_CODES = {
    "wifi648": lambda: wifi_code(648, with_G=False),
    "wifi1296": lambda: wifi_code(1296, with_G=False),
    "wifi1944": lambda: wifi_code(1944, with_G=False),
    "two_layer96": lambda: two_layer(make_benchmark_code(96, dv=3, dc=6, seed=7)),
    "qc1024": lambda: natural_qc_code(8 * 128, 128),  # Beneš pad 4096: edge-major, exact
    "qc2048": lambda: natural_qc_code(16 * 128, 128),  # pad 8192: qc lanes, fast
}


def _fields(path):
    return {k: v for k, v in (p.split("=", 1) for p in path.split() if "=" in p)
            if k in ("schedule", "dtype")}


def _paths(code, dec, use_pallas):
    """(port, JAX) ``schedule=``/``dtype=`` of the same flags."""
    sim = Simulator(code_from_jax(code), DecoderParams(**dec),
                    ChannelParams(seed=1, x_range=(1.0, 2.0, 1.0)),
                    SimulationParams(batch_size=32, fec=3, max_frames=128),
                    device="cpu", verbose=False, use_pallas=use_pallas)
    jsim = JaxSimulator(code, jparams.DecoderParams(**dec),
                        jparams.ChannelParams(seed=1, x_range=(1.0, 2.0, 1.0)),
                        jparams.SimulationParams(batch_size=32, fec=3, max_frames=128),
                        use_pallas=use_pallas, verbose=False)
    return sim, _fields(sim.decode_path), _fields(jsim.decode_path)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("name", list(ROUTING_CODES))
def test_layered_routing_matches_jax_decode_path(name, use_pallas):
    code = ROUTING_CODES[name]()
    for dtype, form in (("bfloat16", "BP"), ("bfloat16", "BP_MS"), ("int8", "BP_OMS")):
        dec = dict(iterations=8, layered=True, type=form, message_dtype=dtype)
        sim, port, want = _paths(code, dec, use_pallas)
        assert port == want, (dtype, form)
        assert port["dtype"] == (dtype if use_pallas else "float32")
        assert sim.message_dtype == port["dtype"] and not sim.fallback


@pytest.mark.parametrize("layered_", [True, False])
def test_qc_sub32_walls_widen_like_jax(monkeypatch, layered_):
    """qc2048's qc lane layout spans 6144 slots: with the walls at 4096 and
    8192, bf16 BP widens to float32 and the min-sum forms keep their dtype;
    with both at 4096 every sub-32-bit dtype widens, in both packages, and
    the port says so in its provenance line."""
    code = ROUTING_CODES["qc2048"]()
    for wall, wide, widened in ((4096, 8192, {("bfloat16", "BP")}),
                                (4096, 4096, {("bfloat16", "BP"), ("bfloat16", "BP_MS"),
                                              ("int8", "BP_MS")})):
        for mod in (jax_driver, driver):
            monkeypatch.setattr(mod, "QC_LANES_SUB32_EDGE_SPACE_LIMIT", wall)
            monkeypatch.setattr(mod, "QC_LANES_SUB32_WIDE_EDGE_SPACE_LIMIT", wide)
        for dtype, form in (("bfloat16", "BP"), ("bfloat16", "BP_MS"), ("int8", "BP_MS")):
            dec = dict(iterations=8, layered=layered_, type=form, message_dtype=dtype)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                sim, port, want = _paths(code, dec, True)
            is_widened = (dtype, form) in widened
            assert port == want
            assert port["dtype"] == ("float32" if is_widened else dtype)
            assert port["schedule"] == ("layered-fast" if layered_ else "flooding")
            assert ("fallback[qc n_pad 6144" in sim.decode_path) == is_widened
            assert any("widened to float32" in str(w.message) for w in caught) == is_widened


def test_cli_int8_oms_layered_sweep_agrees_with_jax(tmp_path):
    """``--layer-file --pallas --message-dtype int8 --decoding BP_OMS`` on a
    QC code on its natural layers (the fast engine) against the JAX CLI
    (its XLA exact layered decoder in float32: ``--pallas`` needs a TPU
    there)."""
    code = natural_qc_code(16 * 128, 128, with_G=True)
    write_codefile(str(tmp_path / "h.txt"), code.rows, code.cols, code.nc, code.mc)
    r, c = np.nonzero(code.G)
    (tmp_path / "g.txt").write_text("".join(f"{i} {j}\n" for i, j in zip(r, c)))
    write_layerfile(str(tmp_path / "l.txt"), code.layers)
    common = [str(tmp_path / "h.txt"), "PLACEHOLDER", "1.0", "1.51", "0.5", "-G",
              str(tmp_path / "g.txt"), "--layer-file", str(tmp_path / "l.txt"), "-i", "10",
              "--decoding", "BP_OMS", "--frame-error-count", "20", "--batch-size", "64",
              "--max-frames", "384", "-s", "3"]

    def argv(out, *extra):
        a = list(common)
        a[1] = str(tmp_path / out)
        return a + list(extra)

    assert cli.main(argv("t.txt", "--qc-z", "128", "--pallas", "--message-dtype", "int8",
                         "--device", "cpu")) == 0
    assert jax_cli.main(argv("j.txt")) == 0
    (comment, head_t, rows_t), (_, head_j, rows_j) = _read(tmp_path / "t.txt"), _read(
        tmp_path / "j.txt")
    assert comment == ["# kernel=torch-plain dtype=int8 cn=BP_OMS schedule=layered-fast "
                       "streaming=on"]
    assert head_t == head_j and rows_t.shape == rows_j.shape == (2, 6)
    for (_, fer_t, _, n_t, _, _), (_, fer_j, _, n_j, _, _) in zip(rows_t, rows_j):
        p = (fer_t * n_t + fer_j * n_j) / (n_t + n_j)
        z = (fer_t - fer_j) / np.sqrt(p * (1 - p) * (1 / n_t + 1 / n_j))
        assert abs(z) < 3, (fer_t, n_t, fer_j, n_j)
