"""The port's ``LDPC`` class and the host-layer pieces it needs, on the CPU,
against the JAX package: GF(2) rank, syndrome and encoding, the alist and
codefile round trips, ``LDPC.decode`` against the JAX ``LDPC.decode``
(min-sum bit-exact, NMS in decisions, BP on >= 99.9 % of frames; flooding, the exact layered
schedule, int8 on the JAX fused kernel in interpret mode), the routing
cache's key, and the threaded simulation."""

import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest
import torch

from libldpc_tpu.api import LDPC as JaxLDPC
from libldpc_tpu.models import gf2 as jax_gf2
from libldpc_tpu.models import make_benchmark_code as jax_benchmark_code
from libldpc_tpu.models import wifi_code as jax_wifi_code
from libldpc_tpu.models.code import LDPCCode as JaxCode
from libldpc_tpu.ops.pallas import decode_fused as jax_fused
from libldpc_tpu_torch import LDPC
from libldpc_tpu_torch.convert import code_from_jax
from libldpc_tpu_torch.models import gf2
from libldpc_tpu_torch.models.code import LDPCCode
from libldpc_tpu_torch.sim import driver
from libldpc_tpu_torch.sim.driver import Simulator
from libldpc_tpu_torch.utils.params import ChannelParams, DecoderParams, SimulationParams

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def wifi648():
    """wifi 648 with its natural layers and two bits punctured: the JAX
    code and the port's copy."""
    jcode = dataclasses.replace(jax_wifi_code(648, with_G=True),
                                puncture=np.array([5, 400], dtype=np.int32))
    return jcode, code_from_jax(jcode)


@pytest.fixture(scope="module")
def two_layer96():
    jcode = dataclasses.replace(jax_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True),
                                layers=[np.arange(0, 48, 2), np.arange(1, 48, 2)])
    return jcode, code_from_jax(jcode)


@pytest.fixture(scope="module")
def bench96():
    jcode = jax_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True)
    return jcode, code_from_jax(jcode)


def _llrs(nct, B, snr_db, seed, tx=None):
    """BPSK over AWGN, transmitted positions, ``[B, nct]`` (all-zero
    codeword unless ``tx``)."""
    rng = np.random.default_rng(seed)
    sigma2 = 10 ** (-snr_db / 10)
    x = 1.0 - 2.0 * (np.zeros(nct) if tx is None else tx)
    y = x + rng.normal(size=(B, nct)) * np.sqrt(sigma2)
    return (2 * y / sigma2).astype(np.float32)


@pytest.mark.parametrize("name", ["wifi648", "bench96"])
def test_rank_syndrome_encode_equal_jax(name, wifi648, bench96):
    jcode, code = {"wifi648": wifi648, "bench96": bench96}[name]
    port, jax_ = LDPC(code=code, device="cpu"), JaxLDPC(code=jcode)
    assert (port.n, port.m, port.k, port.nct, port.mct, port.kct) == (
        jax_.n, jax_.m, jax_.k, jax_.nct, jax_.mct, jax_.kct)
    assert port.rank() == jax_.rank() == code.mc
    rng = np.random.default_rng(3)
    for _ in range(4):
        u = rng.integers(0, 2, code.G.shape[0]).astype(np.uint8)
        tx = port.encode(u)
        np.testing.assert_array_equal(tx, jax_.encode(u))
        assert tx.shape == (port.nct,)
        v = rng.integers(0, 2, code.nc).astype(np.uint8)
        np.testing.assert_array_equal(port.syndrome(v), jax_.syndrome(v))
        assert not port.syndrome(code.encode(u)).any()


@pytest.mark.parametrize("fn", ["rank", "mat_vec", "vec_mat", "is_generator_matrix"])
def test_gf2_equals_jax(fn, wifi648):
    _, code = wifi648
    rng = np.random.default_rng(4)
    H, G = code.H_dense, code.G
    bad_G = G.copy()
    bad_G[0, 0] ^= 1
    wide = rng.integers(0, 2, (70, 130))  # past one 64-bit word each way
    cases = {
        "rank": [(H,), (G,), (wide,), (wide.T,), (np.zeros((3, 5), np.uint8),)],
        "mat_vec": [(H, rng.integers(0, 2, code.nc)), (wide, rng.integers(0, 2, 130))],
        "vec_mat": [(rng.integers(0, 2, G.shape[0]), G), (rng.integers(0, 2, 70), wide)],
        "is_generator_matrix": [(H, G), (H, bad_G)],
    }[fn]
    for args in cases:
        got, want = getattr(gf2, fn)(*args), getattr(jax_gf2, fn)(*args)
        np.testing.assert_array_equal(got, want)
    if fn == "is_generator_matrix":
        assert gf2.is_generator_matrix(H, G) and not gf2.is_generator_matrix(H, bad_G)


def test_alist_and_codefile_round_trips_equal_jax(wifi648, tmp_path):
    jcode, code = wifi648
    code.save_alist(str(tmp_path / "p.alist"))
    jcode.save_alist(str(tmp_path / "j.alist"))
    assert (tmp_path / "p.alist").read_text() == (tmp_path / "j.alist").read_text()
    back, jback = LDPCCode.from_alist(str(tmp_path / "j.alist")), JaxCode.from_alist(
        str(tmp_path / "p.alist"))
    np.testing.assert_array_equal(back.rows, jback.rows)
    np.testing.assert_array_equal(back.cols, jback.cols)
    assert (back.nc, back.mc) == (jback.nc, jback.mc) == (code.nc, code.mc)
    np.testing.assert_array_equal(back.H_dense, code.H_dense)
    for headered in (True, False):
        code.save(str(tmp_path / "p.txt"), headered=headered)
        jcode.save(str(tmp_path / "j.txt"), headered=headered)
        assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()
    again = LDPCCode.from_files(str(tmp_path / "p.txt"))
    np.testing.assert_array_equal(again.H_dense, code.H_dense)


def _jax_decode(jax_, llr, **kw):
    """The JAX ``LDPC.decode``.  For NMS/OMS on flooding without
    ``usePallas`` its default path hands the bare type string to the
    decoder, which then skips the correction; the port applies it, as the
    JAX fused path (``_decode_fast``) and the JAX sweep do, so that path is
    the reference there."""
    if kw["dec_type"] in ("BP_NMS", "BP_OMS") and not kw.get("layered"):
        full = np.zeros((jax_.n, llr.shape[0]), np.float32)
        full[jax_.code.bit_pos] = llr.T
        out, it = jax_._decode_fast(full, True, kw["iters"], kw["dec_type"], False, "float32",
                                    False, 0.1875)
        return out[jax_.code.bit_pos].T, it
    return jax_.decode(llr, **kw)


@pytest.mark.parametrize("layered", [False, True], ids=["flooding", "layered"])
@pytest.mark.parametrize("dec_type", ["BP_MS", "BP_NMS", "BP"])
def test_decode_equals_jax(wifi648, two_layer96, layered, dec_type):
    """Flooding on wifi 648 (irregular: the sorted labels matter), the
    exact layered schedule on a two-layer code."""
    jcode, code = two_layer96 if layered else wifi648
    port, jax_ = LDPC(code=code, device="cpu"), JaxLDPC(code=jcode)
    llr = _llrs(code.nct, 160, 1.75, seed=9)
    kw = dict(iters=12, dec_type=dec_type, layered=layered)
    out, it = port.decode(llr, **kw)
    jout, jit = _jax_decode(jax_, llr, **kw)
    assert out.shape == jout.shape == (160, code.nct) and it.shape == (160,)
    same = ((out <= 0) == (jout <= 0)).all(1) & (it == jit)
    if dec_type == "BP_MS":
        np.testing.assert_array_equal(out, jout)
        np.testing.assert_array_equal(it, jit)
    elif dec_type == "BP_NMS":  # the scaling rounds apart: decisions exact
        assert same.all()
        np.testing.assert_allclose(out, jout, rtol=1e-4, atol=1e-4)
    else:
        assert same.mean() >= 0.999
        np.testing.assert_allclose(out[same], jout[same], rtol=1e-4, atol=1e-4)


def test_nms_default_path_fault_not_copied(wifi648):
    jcode, code = wifi648
    port, jax_ = LDPC(code=code, device="cpu"), JaxLDPC(code=jcode)
    llr = _llrs(code.nct, 16, 1.75, seed=2)
    np.testing.assert_array_equal(jax_.decode(llr, iters=6, dec_type="BP_NMS")[0],
                                  jax_.decode(llr, iters=6, dec_type="BP_MS")[0])
    assert not np.array_equal(port.decode(llr, iters=6, dec_type="BP_NMS")[0],
                              port.decode(llr, iters=6, dec_type="BP_MS")[0])


def test_single_frame_and_punctured_positions(wifi648):
    jcode, code = wifi648
    port, jax_ = LDPC(code=code, device="cpu"), JaxLDPC(code=jcode)
    rng = np.random.default_rng(2)
    tx = port.encode(rng.integers(0, 2, code.G.shape[0]))
    llr = _llrs(code.nct, 1, 3.0, seed=1, tx=tx)[0]
    out, it = port.decode(llr, iters=20, dec_type="BP_MS")
    jout, jit = jax_.decode(llr, iters=20, dec_type="BP_MS")
    assert out.shape == (code.nct,) == (code.nc - 2,) and isinstance(it, int)
    np.testing.assert_array_equal(out, jout)
    assert it == jit
    np.testing.assert_array_equal((out <= 0).astype(np.uint8), tx)
    with pytest.raises(ValueError, match="nct"):
        port.decode(np.zeros(code.nc, np.float32))


def test_int8_use_pallas_equals_jax_fused_kernel(bench96):
    """int8 BP_MS with ``usePallas``: the JAX package's fused kernel (its
    ``_decode_fast``, in interpret mode) against the port's route."""
    jcode, code = bench96
    port, jax_ = LDPC(code=code, device="cpu"), JaxLDPC(code=jcode)
    llr = _llrs(code.nct, 48, 1.5, seed=6)
    kw = dict(iters=8, dec_type="BP_MS", usePallas=True, messageDtype="int8")
    interp = functools.partial(jax_fused.bp_decode_pallas, interpret=True)
    with mock.patch.object(jax_fused, "bp_decode_pallas", interp):
        jout, jit = jax_.decode(llr, **kw)
    out, it = port.decode(llr, **kw)
    assert port._routes[True, "int8", False, "BP_MS"] == ("flooding", "int8")
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(it, jit)


def test_route_cache_keys_on_the_cn_form(bench96, monkeypatch):
    """An int8 BP_MS decode followed by an int8 BP decode raises on the
    same object as on a fresh one; and where the widening depends on the
    CN form (bf16 BP widens past the first qc wall, min-sum past the
    second), each form keeps its own route in either order."""
    _, code = bench96
    llr = _llrs(code.nct, 8, 1.5, seed=1)
    for obj in (LDPC(code=code, device="cpu"), None):
        if obj is not None:
            obj.decode(llr, iters=4, dec_type="BP_MS", usePallas=True, messageDtype="int8")
        with pytest.raises(ValueError, match="min-sum-family"):
            (obj or LDPC(code=code, device="cpu")).decode(
                llr, iters=4, dec_type="BP", usePallas=True, messageDtype="int8")
    wifi = code_from_jax(jax_wifi_code(1944, with_G=False))  # qc edge space 11008
    monkeypatch.setattr(driver, "QC_LANES_SUB32_EDGE_SPACE_LIMIT", 10000)
    monkeypatch.setattr(driver, "QC_LANES_SUB32_WIDE_EDGE_SPACE_LIMIT", 20000)
    want = {"BP_MS": "bfloat16", "BP": "float32"}
    for order in (["BP_MS", "BP"], ["BP", "BP_MS"]):
        obj = LDPC(code=wifi, device="cpu")
        for cn in order:
            dec = DecoderParams(type=cn, message_dtype="bfloat16")
            with mock.patch("warnings.warn"):
                assert obj._route(dec, True) == ("flooding", want[cn])
        assert len(obj._routes) == 2


def test_threaded_simulate_equals_the_simulator(bench96, tmp_path):
    _, code = bench96
    kw = dict(snr=[1.0, 3.01, 1.0], fec=6, batchSize=32, iterations=10, maxFrames=4096, seed=2)
    ldpc = LDPC(code=code, device="cpu")
    assert ldpc.get_results() == {}
    ldpc.simulate(**kw, resultFile=str(tmp_path / "r.txt"))
    ldpc.wait(timeout=120)
    got = ldpc.get_results()
    ref = Simulator(code, DecoderParams(iterations=10), ChannelParams(seed=2, x_range=(1.0, 3.01, 1.0)),
                    SimulationParams(batch_size=32, fec=6, max_frames=4096), device="cpu",
                    verbose=False).start().as_dict(trim=True)
    assert set(got) == {"x", "fer", "ber", "avg_iter", "time", "fec", "frames"}
    for k in ("x", "fer", "ber", "avg_iter", "fec", "frames"):
        np.testing.assert_array_equal(got[k], ref[k])
    assert (tmp_path / "r.txt").read_text().startswith("# kernel=torch-plain")


def test_stop_simulation_freezes_results(bench96):
    _, code = bench96
    ldpc = LDPC(code=code, device="cpu")
    ldpc.simulate(snr=[4.0, 6.01, 1.0], fec=10**9, batchSize=32, iterations=10,
                  maxFrames=10**9)
    while not len(ldpc.get_results().get("frames", ())):
        ldpc._sim_thread.join(0.05)
    ldpc.stop_simulation()
    assert ldpc._sim_thread is None
    frozen = ldpc.get_results()
    assert frozen["frames"][0] > 0
    assert ldpc.get_results() is frozen


@pytest.mark.parametrize("kw,item", [
    (dict(mesh=object()), '"Multi-GPU"'), (dict(pointsParallel=2), '"Multi-GPU"'),
    (dict(modulation=(None, None)), '"Modulation"'),
])
def test_simulate_refuses_what_is_not_ported(bench96, kw, item):
    _, code = bench96
    with pytest.raises(NotImplementedError, match=item):
        LDPC(code=code, device="cpu").simulate(snr=[1.0, 2.0, 1.0], **kw)


def test_cuda_is_the_default_device(bench96):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        LDPC(code=bench96[1])
