"""The bfloat16 and int8 message forms of the flooding decoders against the
JAX package, on the CPU, on the same numpy LLRs.

* int8 (the integer lattice ``round(L / 0.1875)`` saturated to +-127, with
  ``BP_MS`` and ``BP_OMS``): bit-exact in ``llr_out``, ``hard``,
  ``iterations`` and ``is_codeword`` against ``bp_decode_pallas`` (MXU
  transport) and ``bp_decode_lanes`` (Clos transport) in interpret mode,
  and against the numpy integer golden of ``tests/test_pallas.py``.
* bfloat16: the min-sum family bit-exact against ``bp_decode_pallas``; BP
  in decisions and iteration counts on >= 99.9 % of frames and within one
  bf16 step (1/256 relative) on their posteriors, where XLA's and torch's
  ``exp``/``log1p`` may round a box-plus differently before the store.
* The stream: the int8 chunk drained from a full pool gives the totals of
  the JAX stream kernel and of the batch decode; a JAX int8 stream state
  carries into the port.
* The CLI with ``--pallas --device cpu`` against the JAX CLI (its XLA
  path, which runs float32: ``--pallas`` needs a TPU there), FER within
  |z| < 3; the ``dtype=`` of the provenance line and
  :func:`route`'s dtype against the JAX ``Simulator``'s
  ``decode_path`` (the layered schedule too); the refusals.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libldpc_tpu import cli as jax_cli
from libldpc_tpu.models import make_benchmark_code, wifi_code
from libldpc_tpu.ops.pallas.decode_fused import bp_decode_pallas, bp_stream_chunk_pallas
from libldpc_tpu.ops.pallas.decode_lanes import bp_decode_lanes
from libldpc_tpu.ops.pallas.lanes_layout import to_lanes_device
from libldpc_tpu.ops.pallas.layout import to_pallas_device
from libldpc_tpu.ops.streaming_pallas import _edge_prior_pool, make_streaming_pallas_step
from libldpc_tpu.models.code import LDPCCode as JaxCode
from libldpc_tpu.sim import driver as jax_driver
from libldpc_tpu.sim.driver import Simulator as JaxSimulator
from libldpc_tpu.utils import params as jparams
from libldpc_tpu_torch import cli, convert
from libldpc_tpu_torch.convert import code_from_jax
from libldpc_tpu_torch.models import LDPCCode, write_codefile
from libldpc_tpu_torch.ops.kernels import decode_fused as df
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.ops.messages import MessageForm
from libldpc_tpu_torch.ops.sorted import to_sorted_device
from libldpc_tpu_torch.ops.streaming_fused import init_state, make_streaming_fused_step
from libldpc_tpu_torch.sim import driver, tpu_layouts
from libldpc_tpu_torch.sim.driver import (
    ChannelParams, DecoderParams, SimulationParams, Simulator, route,
)

import test_pallas
from test_torch_sorted import awgn_llrs
from test_torch_streaming import drain, frames

torch.set_num_threads(2)

SCALE = 0.1875
INT8_FORMS = ["BP_MS", ("BP_OMS", 1.0, 0.375)]
BF16_MINSUM = ["BP_MS", ("BP_NMS", 0.75, 0.15), ("BP_OMS", 1.0, 0.375)]


@pytest.fixture(scope="module")
def setup():
    code = make_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True)
    pdc = to_pallas_device(code)
    tables = kernel_tables(to_sorted_device(code_from_jax(code), "cpu"))
    llr = awgn_llrs(code, pdc.sorted_dc.vn_perm, 128, 1.0, seed=3)
    return code, pdc, tables, llr


def assert_exact(jout, tout):
    np.testing.assert_array_equal(tout.llr_out.numpy(), np.asarray(jout.llr_out))
    np.testing.assert_array_equal(tout.hard.numpy(), np.asarray(jout.hard))
    np.testing.assert_array_equal(tout.iterations.numpy(), np.asarray(jout.iterations))
    np.testing.assert_array_equal(tout.is_codeword.numpy(), np.asarray(jout.is_codeword))


def golden(code, llr_sorted, vn_perm, iters, form, early_term):
    """The numpy integer golden of tests/test_pallas.py, in the original
    labelling: ``(hard, iterations, is_codeword)``."""
    llr = np.zeros_like(llr_sorted)
    llr[np.asarray(vn_perm)] = llr_sorted
    oms = form[2] if isinstance(form, tuple) else None
    return test_pallas.TestInt8Quantized._golden(code, llr, iters, SCALE, oms_offset=oms,
                                                 early_term=early_term)


@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("form", INT8_FORMS)
def test_int8_matches_pallas_kernel_and_golden(setup, form, early_term):
    """Against ``bp_decode_pallas(..., "int8", permute="mxu")`` bit for bit,
    and against the integer golden in decisions, counts and flags."""
    code, pdc, tables, llr = setup
    launches = dict(df.bp_decode_fused.launches)
    jout = bp_decode_pallas(pdc, jnp.asarray(llr), iterations=8, early_term=early_term,
                            minsum_mode=form, batch_tile=128, interpret=True,
                            message_dtype="int8", permute="mxu", quant_scale=SCALE)
    tout = df.bp_decode_fused(tables, torch.from_numpy(llr), 8, early_term, form, "int8", SCALE)
    assert_exact(jout, tout)
    assert df.bp_decode_fused.launches == launches  # CPU: the plain version, no launch
    hard_g, iters_g, iscw_g = golden(code, llr, pdc.sorted_dc.vn_perm, 8, form, early_term)
    vn_perm = np.asarray(pdc.sorted_dc.vn_perm)
    np.testing.assert_array_equal(tout.hard.numpy().astype(np.uint8), hard_g[vn_perm])
    np.testing.assert_array_equal(tout.iterations.numpy(), iters_g)
    np.testing.assert_array_equal(tout.is_codeword.numpy(), iscw_g)


@pytest.fixture(scope="module")
def lanes_setup():
    """The Clos lane-major layout of tests/test_lanes.py ``TestLanesInt8``."""
    code = make_benchmark_code(128, dv=3, dc=6, seed=4, with_G=True)
    ldc = to_lanes_device(code, transport="clos")
    tables = kernel_tables(to_sorted_device(code_from_jax(code), "cpu"))
    llr = awgn_llrs(code, ldc.sorted_dc.vn_perm, 16, -0.5, seed=8)
    return ldc, tables, llr


@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("form", INT8_FORMS)
def test_int8_matches_lanes_kernel(lanes_setup, form, early_term):
    ldc, tables, llr = lanes_setup
    jout = bp_decode_lanes(ldc, jnp.asarray(llr), iterations=6, early_term=early_term,
                           minsum_mode=form, message_dtype="int8", quant_scale=SCALE,
                           frame_tile=8, interpret=True)
    tout = df.bp_decode_fused(tables, torch.from_numpy(llr), 6, early_term, form, "int8", SCALE)
    assert_exact(jout, tout)


@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("form", BF16_MINSUM + ["BP"])
def test_bf16_matches_pallas_kernel(setup, form, early_term):
    _, pdc, tables, llr = setup
    jout = bp_decode_pallas(pdc, jnp.asarray(llr), iterations=12, early_term=early_term,
                            minsum_mode=form, batch_tile=128, interpret=True,
                            message_dtype="bfloat16")
    tout = df.bp_decode_fused(tables, torch.from_numpy(llr), 12, early_term, form, "bfloat16")
    if form in BF16_MINSUM:
        assert_exact(jout, tout)
        return
    agree = ((tout.hard.numpy() == np.asarray(jout.hard)).all(0)
             & (tout.iterations.numpy() == np.asarray(jout.iterations)))
    assert agree.mean() >= 0.999
    np.testing.assert_allclose(tout.llr_out.numpy()[:, agree], np.asarray(jout.llr_out)[:, agree],
                               rtol=2 ** -8, atol=2 ** -8)


def test_store_points():
    """Rounding: bf16 to nearest even, int8 half to even and saturated; the
    prior multiplied by float32(1 / 0.1875); the OMS offset in lattice
    units; the output dequantised."""
    f = MessageForm("int8", SCALE)
    assert f.inv_q == np.float32(1.0 / SCALE) == np.float32(5.3333335)
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 126.6, 300.0, -1e30])
    assert f.store(x).tolist() == [0, 2, 2, 0, -2, 127, 127, -127]
    assert f.dequant(torch.tensor([-3, 127], dtype=torch.int8)).tolist() == [-0.5625, 23.8125]
    assert f.prior(torch.tensor([1.0]))[0].item() == np.float32(5.3333335)
    assert f.cn_mode(("BP_OMS", 1.0, 0.15)) == ("BP_OMS", 1.0, 0.15 * (1.0 / SCALE))
    assert np.float32(f.cn_mode(("BP_OMS", 1.0, 0.15))[2]) == np.float32(0.8)
    assert MessageForm("float32").cn_mode(("BP_OMS", 1.0, 0.15)) == ("BP_OMS", 1.0, 0.15)
    b = MessageForm("bfloat16").store(torch.tensor([1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8]))
    assert b.float().tolist() == [1.0, 1.0 + 2 ** -6]


def jax_stream_drain(pdc, llr, cw, form, cap, k):
    """The JAX stream kernel drained from a full pool: one fresh frame per
    lane, started by the kernel's own reload."""
    nc, B = llr.shape
    fresh_llr = jnp.asarray(llr)
    fresh_lv2c = _edge_prior_pool(pdc.cn_edge_node, fresh_llr, jnp.int8, qscale=SCALE)
    flag = jnp.zeros((8, B), jnp.int32).at[0].set(1)
    state = (jnp.zeros((nc, B), jnp.float32), jnp.zeros((nc, B), jnp.int32),
             jnp.zeros((pdc.n_pad, B), jnp.int8), flag, jnp.zeros((8, B), jnp.int32),
             jnp.zeros((8, B), jnp.int32), flag, jnp.zeros((8, B), jnp.int32))
    totals = np.zeros(5, np.int64)
    for step in range(20):
        llr_in, cwj, lv2c, done8, iters8, age8, avail8, ctr8 = state
        state = bp_stream_chunk_pallas(
            pdc, llr_in, cwj, lv2c, done8, iters8, age8, avail8, jnp.zeros_like(ctr8),
            fresh_llr, jnp.asarray(cw.astype(np.int32)), fresh_lv2c, jnp.int32(step == 0),
            jnp.int32(B), k=k, cap=cap, minsum_mode=form, batch_tile=B, interpret=True,
            message_dtype="int8", permute="mxu", quant_scale=SCALE)
        totals += np.asarray(state[7])[:5].sum(1)
        if int(np.asarray(state[3])[0].min()) == 1:
            return totals
    raise AssertionError("JAX streams did not drain")


def port_stream_drain(tables, llr, cw, form, cap, k):
    B = llr.shape[1]
    st = init_state(tables, B, message_dtype="int8")
    assert st.lv2c.dtype == torch.int8 and not st.lv2c.any()
    st.fresh_llr.copy_(torch.from_numpy(llr))
    st.fresh_cw.copy_(torch.from_numpy(cw))
    st.avail.fill_(1)
    totals = np.zeros(5, np.int64)
    for step in range(20):
        st.ctr.zero_()
        df.bp_stream_chunk_fused(
            tables, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail,
            st.ctr, st.fresh_llr, st.fresh_cw, torch.tensor([int(step == 0)], dtype=torch.int32),
            torch.tensor([B], dtype=torch.int32), k=k, cap=cap, minsum_mode=form,
            message_dtype="int8", quant_scale=SCALE)
        totals += st.ctr.sum(1).numpy()
        if bool((st.done == 1).all()):
            return totals
    raise AssertionError("port streams did not drain")


@pytest.mark.parametrize("form", INT8_FORMS)
def test_int8_stream_drains_like_jax_and_batch(setup, form):
    code, pdc, tables, _ = setup
    B, cap = 128, 10
    llr, cw = frames(code, pdc.sorted_dc.vn_perm, B, 1.5, seed=5)
    want = jax_stream_drain(pdc, llr, cw, form, cap, k=4)
    got = port_stream_drain(tables, llr, cw, form, cap, k=4)
    out = df.bp_decode_fused(tables, torch.from_numpy(llr), cap, True, form, "int8", SCALE)
    bit_pos = tables.code.bit_pos.numpy()
    errs = (out.hard.numpy()[bit_pos] != cw[bit_pos]).sum(0)
    batch = [errs.sum(), (errs > 0).sum(), B, out.iterations.sum().item(), B]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, batch)


def test_int8_state_from_jax_stream_drains_alike(setup):
    """One JAX int8 streaming super-step with reloads, its state (int8
    ``lv2c``) carried into the port: both drain to the same totals."""
    _, pdc, tables, _ = setup
    B = 32
    dec = jparams.DecoderParams(iterations=8, type="BP_MS", message_dtype="int8")
    init_j, step_j = make_streaming_pallas_step(pdc, "AWGN", dec, B, chunk_iters=4,
                                                interpret=True, batch_tile=B)
    st_j, acc = step_j(init_j(), jax.random.PRNGKey(5), np.float32(1.0), jnp.asarray(True))
    assert int(acc.n_active) > 0
    state = convert.from_pstream_state({f: np.asarray(getattr(st_j, f)) for f in st_j._fields},
                                       tables.code.cn_classes)
    assert state.lv2c.dtype == torch.int8 and state.lv2c.any()
    want = np.zeros(4, dtype=np.int64)
    for step in range(100):
        st_j, acc = step_j(st_j, jax.random.PRNGKey(100 + step), np.float32(1.0),
                           jnp.asarray(False))
        want += [int(acc.bit_errors), int(acc.frame_errors), int(acc.frames), int(acc.iter_sum)]
        if int(acc.n_active) == 0:
            break
    tdec = DecoderParams(iterations=8, type="BP_MS", message_dtype="int8")
    _, step_fn = make_streaming_fused_step(tables, "AWGN", tdec, B, chunk_iters=4)
    np.testing.assert_array_equal(drain(step_fn, state), want)


# ---- the CLI, routing and refusals ------------------------------------------

SWEEP = ["1.0", "3.01", "1.0"]  # 1, 2, 3 dB
COMMON = ["-i", "12", "--frame-error-count", "20", "--batch-size", "64",
          "--max-frames", "20000", "-s", "3"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("code")
    code = make_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True)
    write_codefile(str(d / "h.txt"), code.rows, code.cols, code.nc, code.mc)
    r, c = np.nonzero(code.G)
    (d / "g.txt").write_text("".join(f"{i} {j}\n" for i, j in zip(r, c)))
    return code, d


def _read(path):
    lines = path.read_text().splitlines()
    rows = [ln.split() for ln in lines if not ln.startswith("#")]
    return lines[0], rows[0], np.array(rows[1:], dtype=float)


def jax_path(code, dec, use_pallas):
    """The ``key=value`` fields of the JAX ``Simulator``'s ``decode_path``."""
    sim = JaxSimulator(code, jparams.DecoderParams(**dec),
                       jparams.ChannelParams(seed=1, x_range=(1.0, 1.1, 1.0)),
                       jparams.SimulationParams(batch_size=32, fec=3, max_frames=64),
                       use_pallas=use_pallas, verbose=False)
    return dict(p.split("=", 1) for p in sim.decode_path.split() if "=" in p)


def jax_dtype(code, dec, use_pallas):
    return jax_path(code, dec, use_pallas)["dtype"]


@pytest.mark.parametrize("dtype,form", [("bfloat16", "BP"), ("int8", "BP_OMS")])
def test_cli_sweep_agrees_with_jax(files, dtype, form):
    code, d = files
    base = [str(d / "h.txt")]
    gen = ["-G", str(d / "g.txt")] + COMMON + ["--decoding", form]
    assert cli.main(base + [str(d / f"t_{dtype}.txt")] + SWEEP + gen
                    + ["--device", "cpu", "--pallas", "--message-dtype", dtype]) == 0
    assert jax_cli.main(base + [str(d / f"j_{dtype}.txt")] + SWEEP + gen) == 0
    (comment, head_t, rows_t), (_, head_j, rows_j) = (_read(d / f"t_{dtype}.txt"),
                                                      _read(d / f"j_{dtype}.txt"))
    assert head_t == head_j and rows_t.shape == rows_j.shape == (3, 6)
    np.testing.assert_array_equal(rows_t[:, 0], rows_j[:, 0])
    for (_, fer_t, _, n_t, _, _), (_, fer_j, _, n_j, _, _) in zip(rows_t, rows_j):
        p = (fer_t * n_t + fer_j * n_j) / (n_t + n_j)
        z = (fer_t - fer_j) / np.sqrt(p * (1 - p) * (1 / n_t + 1 / n_j))
        assert abs(z) < 3, (fer_t, n_t, fer_j, n_j)
    assert rows_t[0, 1] > rows_t[-1, 1]
    want = jax_dtype(code, dict(iterations=12, type=form, message_dtype=dtype), True)
    assert want == dtype
    assert comment == (f"# kernel=torch-plain dtype={want} cn={form} schedule=flooding "
                       "streaming=on")


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("name", ["bench96", "wifi648", "wifi1944"])
def test_message_dtype_routing_matches_jax(name, dtype, use_pallas):
    jcode = (make_benchmark_code(96, dv=3, dc=6, seed=7) if name == "bench96"
             else wifi_code(int(name[4:]), with_G=False))
    dec = dict(iterations=8, type="BP_MS", message_dtype=dtype)
    tdec = DecoderParams(**dec)
    got = route(code_from_jax(jcode), tdec, use_pallas)[1]
    assert got == jax_dtype(jcode, dec, use_pallas) == (dtype if use_pallas else "float32")
    assert route(code_from_jax(jcode), tdec, use_pallas, "BEC")[1] == "uint8-3state"


def test_int8_refuses_non_minsum_like_jax(setup):
    _, pdc, tables, llr = setup
    with pytest.raises(ValueError, match="min-sum-family"):
        bp_decode_pallas(pdc, jnp.asarray(llr), iterations=4, minsum_mode="BP",
                         message_dtype="int8", permute="mxu", interpret=True)
    for fn in (df.bp_decode_fused, df.bp_decode_fused_plain):
        with pytest.raises(ValueError, match="min-sum-family"):
            fn(tables, torch.from_numpy(llr), 4, True, "BP", "int8")
    with pytest.raises(ValueError, match="min-sum-family"):
        make_streaming_fused_step(tables, "AWGN", DecoderParams(type="BP", message_dtype="int8"),
                                  32)


def _argv(d, out, *flags):
    return ([str(d / "h.txt"), str(out)] + SWEEP + ["-G", str(d / "g.txt")] + COMMON
            + ["--device", "cpu", "--pallas", *flags])


def test_cli_refuses_int8_bp(files, tmp_path, capsys):
    _, d = files
    assert cli.main(_argv(d, tmp_path / "r.txt", "--message-dtype", "int8")) == 2
    assert "min-sum-family" in capsys.readouterr().err
    assert not (tmp_path / "r.txt").exists()


def test_cli_refuses_sub32_past_the_envelope(tmp_path, monkeypatch):
    """Past the sizes the port once refused, a sub-32-bit dtype routes as
    the JAX package routes it.  A code of one check of each degree 1..8
    (36 edges, whose degree classes pad to 4608 lane slots) with the
    edge-major wall lowered to 16 slots in both packages goes to the Clos
    lanes: it keeps its dtype there, and past a Clos fill wall lowered to
    4096 it widens to float32 Beneš lanes (float32 XLA at fixed
    iterations), with the JAX package's dtype and ``fallback[...]`` notes.
    A (3,6) code of 36000 edges keeps bfloat16 on the Clos lanes, and its
    CLI sweep runs in it."""
    rng = np.random.default_rng(0)
    nc, mc = 12000, 6000
    big = LDPCCode(rows=np.repeat(np.arange(mc), 6).astype(np.int32),
                   cols=rng.permutation(np.repeat(np.arange(nc), 3)).astype(np.int32),
                   nc=nc, mc=mc)
    degs = np.arange(1, 9)
    rows = np.repeat(np.arange(8), degs).astype(np.int32)
    cols = np.concatenate([np.arange(d) for d in degs]).astype(np.int32)
    padded = LDPCCode(rows=rows, cols=cols, nc=8, mc=8)
    jcode = JaxCode(rows=rows, cols=cols, nc=8, mc=8)
    assert tpu_layouts.lanes_space(padded) == (4608, 8192)
    for mod in (driver, jax_driver):
        monkeypatch.setattr(mod, "FUSED_EDGE_SPACE_LIMIT", 16)
    for fill_limit in (65536, 4096):
        for mod in (driver, jax_driver):
            monkeypatch.setattr(mod, "CLOS_LANES_FILL_LIMIT", fill_limit)
        for dtype in ("bfloat16", "int8"):
            for et in (True, False):
                dec = dict(iterations=4, type="BP_MS", message_dtype=dtype, early_term=et)
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    want = JaxSimulator(jcode, jparams.DecoderParams(**dec),
                                        jparams.ChannelParams(seed=1, x_range=(1.0, 1.1, 1.0)),
                                        jparams.SimulationParams(batch_size=32, fec=3,
                                                                 max_frames=64),
                                        use_pallas=True, verbose=False).decode_path
                    got = Simulator(padded, DecoderParams(**dec),
                                    ChannelParams(seed=1, x_range=(1.0, 1.1, 1.0)),
                                    SimulationParams(batch_size=32, fec=3, max_frames=64),
                                    device="cpu", verbose=False, use_pallas=True)
                jfields = dict(p.split("=", 1) for p in want.split() if "=" in p)
                assert got.message_dtype == jfields["dtype"]
                assert got.decode_path.split(" fallback[")[1:] == want.split(" fallback[")[1:]
                assert got.message_dtype == (dtype if fill_limit == 65536 else "float32")
                assert ("clos fill 4608 > envelope" in got.decode_path) == (fill_limit == 4096)
                assert route(padded, DecoderParams(**dec), False)[1] == "float32"
    monkeypatch.setattr(driver, "FUSED_EDGE_SPACE_LIMIT", 4096)
    monkeypatch.setattr(driver, "CLOS_LANES_FILL_LIMIT", 65536)
    assert tpu_layouts.lanes_space(big) == (36096, 65536)
    for dtype in ("bfloat16", "int8"):
        assert driver.tpu_layout(big, DecoderParams(type="BP_MS", message_dtype=dtype),
                                 True) == ("clos", dtype, ())
    write_codefile(str(tmp_path / "h.txt"), big.rows, big.cols, nc, mc)
    argv = [str(tmp_path / "h.txt"), str(tmp_path / "r.txt"), "1.0", "1.1", "1.0", "--pallas",
            "--message-dtype", "bfloat16", "--device", "cpu", "-i", "2", "--batch-size", "16",
            "--max-frames", "16"]
    assert cli.main(argv) == 0
    comment = (tmp_path / "r.txt").read_text().splitlines()[0]
    assert comment.startswith("# kernel=torch-plain dtype=bfloat16 cn=BP schedule=flooding")
    assert "fallback" not in comment


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_layered_sub32_follows_jax_decode_path(files, dtype, use_pallas):
    """``--layer-file`` with a sub-32-bit dtype takes the JAX ``decode_path``'s
    schedule and dtype (float32 without ``--pallas``) and runs."""
    code, _ = files
    jcode = dataclasses.replace(code, layers=[np.arange(24), np.arange(24, 48)])
    dec = dict(iterations=6, type="BP_MS", layered=True, message_dtype=dtype)
    sim = Simulator(code_from_jax(jcode), DecoderParams(**dec),
                    ChannelParams(seed=1, x_range=(1.0, 1.1, 1.0)),
                    SimulationParams(batch_size=32, fec=3, max_frames=64), device="cpu",
                    verbose=False, use_pallas=use_pallas)
    port = dict(p.split("=", 1) for p in sim.decode_path.split() if "=" in p)
    want = jax_path(jcode, dec, use_pallas)
    assert port["schedule"] == want["schedule"] == "layered"
    assert port["dtype"] == want["dtype"] == (dtype if use_pallas else "float32")
    assert sim.start().frames[0] == 64
