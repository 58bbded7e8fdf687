"""The port's padded-layout library (``ops.device``, ``ops.decoder``,
``ops.bec``, ``models.code``'s ``EdgeLayout``) against the JAX package, on
the CPU.

The same NumPy-seeded LLRs and erasures go through the JAX decoders and the
port's.  Decisions, iteration counts and codeword flags are held exactly in
every CN form, and so is every output of the BEC.  ``llr_out`` is held bit
for bit in ``BP_MS`` and ``BP_OMS``; in ``BP_NMS`` to 1e-5 (relative and
absolute) against the jitted JAX decoder, whose compiled loop rounds the
scaled messages' sums otherwise than op by op (XLA on the CPU contracts a
multiply into the add that follows), and bit for bit against the JAX
decoder run op by op (``jax.disable_jit``); in the sum-product ``BP`` to
1e-5 (XLA and PyTorch evaluate the box-plus's ``log1p(exp(.))`` with their
own kernels)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libldpc_tpu import models as jm
from libldpc_tpu.ops import bec as jbec
from libldpc_tpu.ops import decoder as jdec
from libldpc_tpu.ops import device as jdevice
from libldpc_tpu.parallel import mesh as jmesh
from libldpc_tpu.utils import params as jparams
from libldpc_tpu_torch import ops
from libldpc_tpu_torch.convert import code_from_jax
from libldpc_tpu_torch.ops import bec as tbec
from libldpc_tpu_torch.ops import decoder as tdec
from libldpc_tpu_torch.ops import device as tdevice
from libldpc_tpu_torch.ops.channel import BEC_ERASURE, make_generator
from libldpc_tpu_torch.parallel import mesh as tmesh
from libldpc_tpu_torch.utils.params import DecoderParams

torch.set_num_threads(2)

MODES = {
    "BP": False,
    "BP_MS": True,
    "BP_NMS": ("BP_NMS", 0.75, 0.0),
    "BP_OMS": ("BP_OMS", 1.0, 0.5),
}


def _irregular():
    """An irregular code with degree-1 checks and variables, a punctured
    and a shortened bit (no generator)."""
    rng = np.random.default_rng(3)
    H = (rng.random((20, 40)) < 0.12).astype(np.uint8)
    H[0] = 0
    H[0, 5] = 1  # a degree-1 check
    H[:, 7] = 0
    H[3, 7] = 1  # a degree-1 variable
    return jm.LDPCCode.from_dense(H, puncture=np.array([1], np.int32),
                                  shorten=np.array([2], np.int32))


def _codes():
    small = jm.make_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True)
    layered = dataclasses.replace(small)
    layered.layers = [np.arange(0, small.mc, 3, dtype=np.int32),
                      np.arange(1, small.mc, 3, dtype=np.int32),
                      np.arange(2, small.mc, 3, dtype=np.int32)]
    return {"regular": small, "irregular": _irregular(), "layered": layered}


CODES = _codes()


def _llrs(code, B, snr_db, seed):
    rng = np.random.default_rng(seed)
    s2 = 10 ** (-snr_db / 10)
    y = 1.0 + rng.normal(size=(code.nc, B)) * np.sqrt(s2)
    return (2.0 * y / s2).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CODES))
def test_layout_and_device_tables_equal_jax(name):
    jc = CODES[name]
    tc = code_from_jax(jc)
    for field in jm.code.EdgeLayout._fields:
        np.testing.assert_array_equal(getattr(tc.layout, field), getattr(jc.layout, field),
                                      err_msg=field)
    assert (tc.max_dc, tc.max_dv, tc.max_degree) == (jc.max_dc, jc.max_dv, jc.max_degree)
    np.testing.assert_array_equal(tc.layer_masks(), jc.layer_masks())
    jd = jdevice.to_device(jc, with_layers=True)
    td = tdevice.to_device(tc, with_layers=True, device="cpu")
    for field in jdevice.DeviceCode._fields:
        a, b = getattr(jd, field), getattr(td, field)
        if a is None:
            assert b is None, field
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=field)
    for prop in ("E", "mc", "max_dc", "nc", "max_dv", "nct"):
        assert getattr(td, prop) == getattr(jd, prop), prop
    assert td._tables is None and td.device.type == "cpu"
    np.testing.assert_array_equal(tdevice.degrees_from_mask(jc.layout.cn_mask),
                                  jdevice.degrees_from_mask(jc.layout.cn_mask))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name,layered", [("regular", False), ("irregular", False),
                                          ("layered", True), ("layered", False)])
@pytest.mark.parametrize("early_term", [True, False])
def test_bp_decode_equals_jax(name, layered, mode, early_term):
    jc = CODES[name]
    tc = code_from_jax(jc)
    llr = _llrs(jc, 24, 1.5, seed=len(name) + 7 * layered)
    kw = dict(iterations=12, early_term=early_term, minsum_mode=MODES[mode], layered=layered)
    ref = jdec.bp_decode_jit(jdevice.to_device(jc, with_layers=layered), jnp.asarray(llr), **kw)
    got = ops.bp_decode(tdevice.to_device(tc, with_layers=layered, device="cpu"),
                        torch.from_numpy(llr), **kw)
    np.testing.assert_array_equal(got.hard.numpy(), np.asarray(ref.hard))
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.is_codeword.numpy(), np.asarray(ref.is_codeword))
    if mode in ("BP_MS", "BP_OMS"):
        np.testing.assert_array_equal(got.llr_out.numpy(), np.asarray(ref.llr_out))
    else:
        np.testing.assert_allclose(got.llr_out.numpy(), np.asarray(ref.llr_out), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("name,layered", [("regular", False), ("irregular", False),
                                          ("layered", True)])
def test_nms_bit_exact_against_jax_op_by_op(name, layered):
    """``BP_NMS``'s ``llr_out`` is held to the jitted JAX decoder to 1e-5
    (above): compiled, XLA rounds the scaled messages' sums otherwise.  Run
    op by op, each op rounded on its own, the JAX decoder gives the port's
    bits."""
    import jax

    jc = CODES[name]
    tc = code_from_jax(jc)
    llr = _llrs(jc, 24, 1.5, seed=len(name) + 7 * layered)
    kw = dict(iterations=12, early_term=False, minsum_mode=MODES["BP_NMS"], layered=layered)
    with jax.disable_jit():
        ref = jdec.bp_decode(jdevice.to_device(jc, with_layers=layered), jnp.asarray(llr), **kw)
    got = ops.bp_decode(tdevice.to_device(tc, with_layers=layered, device="cpu"),
                        torch.from_numpy(llr), **kw)
    np.testing.assert_array_equal(got.llr_out.numpy(), np.asarray(ref.llr_out))
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))


@pytest.mark.parametrize("layered", [False, True])
def test_zero_iterations_and_clean_input(layered):
    """``tests/test_decoder.py``'s cases: no pass gives all zeros with the
    all-zero word a codeword; a clean all-zero-codeword input converges at
    the first pass and reports 0 iterations."""
    jc = CODES["layered"]
    dc = tdevice.to_device(code_from_jax(jc), with_layers=layered, device="cpu")
    llr = torch.from_numpy(_llrs(jc, 4, 2.0, seed=1))
    out = tdec.bp_decode_jit(dc, llr, iterations=0, layered=layered)
    assert not out.llr_out.any() and not out.hard.any()
    assert not out.iterations.any() and bool(out.is_codeword.all())
    clean = torch.full((jc.nc, 6), 8.0)
    out = tdec.bp_decode(dc, clean, iterations=10, minsum_mode=True, layered=layered)
    assert bool(out.is_codeword.all()) and not out.iterations.any()
    assert not out.hard.any()


def test_building_blocks_equal_jax():
    jc = CODES["irregular"]
    jd = jdevice.to_device(jc)
    td = tdevice.to_device(code_from_jax(jc), device="cpu")
    llr = _llrs(jc, 5, 1.0, seed=2)
    lv = tdec.init_messages(td, torch.from_numpy(llr))
    np.testing.assert_array_equal(lv.numpy(), np.asarray(jdec.init_messages(jd, jnp.asarray(llr))))
    lc = tdec.cn_update(td, lv, True)
    np.testing.assert_array_equal(lc.numpy(), np.asarray(jdec.cn_update(jd, jnp.asarray(lv.numpy()),
                                                                         True)))
    for a, b in zip(tdec.vn_update(td, torch.from_numpy(llr), lc),
                    jdec.vn_update(jd, jnp.asarray(llr), jnp.asarray(lc.numpy()))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    hard = torch.from_numpy(llr <= 0)
    np.testing.assert_array_equal(tdec.syndrome_ok(td, hard).numpy(),
                                  np.asarray(jdec.syndrome_ok(jd, jnp.asarray(hard.numpy()))))


def _bec_frames(code, B, eps, seed):
    rng = np.random.default_rng(seed)
    if code.G is None:
        cw = np.zeros((code.nc, B), np.uint8)
    else:
        u = rng.integers(0, 2, size=(code.G.shape[0], B))
        cw = (code.G.T.astype(np.int64) @ u % 2).astype(np.uint8)
    sym = np.where(rng.random(cw.shape) < eps, BEC_ERASURE, cw).astype(np.uint8)
    return sym, cw


@pytest.mark.parametrize("name", ["regular", "irregular"])
@pytest.mark.parametrize("stale", [None, 0])
@pytest.mark.parametrize("iterations,early_term", [(20, True), (6, False), (0, True)])
def test_bec_decode_equals_jax(name, stale, iterations, early_term):
    jc = CODES[name]
    sym, cw = _bec_frames(jc, 40, 0.4, seed=5)
    kw = dict(iterations=iterations, early_term=early_term, degree1_stale_byte=stale)
    ref = jbec.bec_decode_jit(jdevice.to_device(jc), jnp.asarray(sym.astype(np.int8)),
                              jnp.asarray(cw), **kw)
    got = tbec.bec_decode(tdevice.to_device(code_from_jax(jc), device="cpu"),
                          torch.from_numpy(sym), torch.from_numpy(cw), **kw)
    assert got.symbols_out.dtype == torch.uint8  # the JAX decoder's are int8
    np.testing.assert_array_equal(got.symbols_out.numpy(), np.asarray(ref.symbols_out))
    np.testing.assert_array_equal(got.hard.numpy(), np.asarray(ref.hard))
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.resolved.numpy(), np.asarray(ref.resolved))
    assert tbec.bec_decode_jit is tbec.bec_decode


@pytest.mark.parametrize("name", ["regular", "irregular"])
@pytest.mark.parametrize("iterations", [20, 0])
def test_bec_decode_takes_jax_int8_symbols(name, iterations):
    """The JAX package's int8 symbols in: u8 ``symbols_out``, the values of
    ``bec_decode_jit`` (the CPU path once promoted u8 and int8 to int16)."""
    jc = CODES[name]
    sym, cw = _bec_frames(jc, 40, 0.4, seed=6)
    sym8 = sym.astype(np.int8)
    ref = jbec.bec_decode_jit(jdevice.to_device(jc), jnp.asarray(sym8), jnp.asarray(cw),
                              iterations=iterations)
    dc = tdevice.to_device(code_from_jax(jc), device="cpu")
    for decode in (tbec.bec_decode, tbec.bec_decode_plain):
        got = decode(dc, torch.from_numpy(sym8), torch.from_numpy(cw), iterations=iterations)
        assert got.symbols_out.dtype == torch.uint8
        np.testing.assert_array_equal(got.symbols_out.numpy(), np.asarray(ref.symbols_out))
        np.testing.assert_array_equal(got.hard.numpy(), np.asarray(ref.hard))
        np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))


@pytest.mark.parametrize("channel_type,x", [("AWGN", 2.0), ("BEC", 0.35)])
@pytest.mark.parametrize("layered", [False, True])
def test_sim_step_on_a_device_code_reaches_the_padded_decoders(monkeypatch, channel_type, x,
                                                               layered):
    """``make_sim_step`` takes a ``DeviceCode`` and decodes with the padded
    decoders (spied), as the JAX step's branches do; its counters agree
    with the JAX step in statistics."""
    jc = CODES["layered"]
    td = tdevice.to_device(code_from_jax(jc), with_layers=layered, device="cpu")
    calls = []
    for mod, name in ((tmesh, "bp_decode"), (tmesh, "bec_decode")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append((_name, k.get("layered")))
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    dec = DecoderParams(iterations=10, type="BP_MS", layered=layered)
    step = tmesh.make_sim_step(td, channel_type, dec, 256)
    frames = fe = 0
    for b in range(4):
        out = step(make_generator("cpu", 3, b), x)
        frames += int(out.frames)
        fe += int(out.frame_errors)
        assert 0 <= int(out.bit_errors) <= 256 * jc.nct
    assert frames == 1024
    want = "bec_decode" if channel_type == "BEC" else "bp_decode"
    assert calls and all(c[0] == want for c in calls)
    if want == "bp_decode":
        assert all(c[1] == layered for c in calls)
    jdec_p = jparams.DecoderParams(iterations=10, type="BP_MS", layered=layered)
    jstep = jmesh.make_sim_step(jdevice.to_device(jc, with_layers=layered), channel_type, jdec_p,
                                1024)
    import jax

    jout = jstep(jax.random.PRNGKey(0), jnp.float32(x))
    p = (fe + int(jout.frame_errors)) / 2048
    z = (fe - int(jout.frame_errors)) / np.sqrt(max(2 * 1024 * p * (1 - p), 1e-9))
    assert abs(z) < 3, (fe, int(jout.frame_errors))
