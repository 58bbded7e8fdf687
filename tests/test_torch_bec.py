"""The BEC slice of the port against the JAX package, on the CPU.

The peeling algebra is integer, so every decoder output (posterior
symbols, decisions, iteration counts, resolution flags) is held to the JAX
decoders exactly: the sorted peeling decoder, the lane-major kernel in its
BEC form (interpret mode, f32/Beneš and bf16/Clos), and the NumPy golden
of the reference's decoder.  Inputs are random codewords and erasures made
with numpy from a seed.  The channel and the CLI sweep draw torch's random
numbers, not jax's, so they are held to statistics (|z| < 3)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from golden import ERASURE, GoldenBECDecoder
from libldpc_tpu import cli as jax_cli
from libldpc_tpu import models as jm
from libldpc_tpu.ops import sorted as jsorted
from libldpc_tpu.ops.bec_sorted import bec_decode_sorted as jax_bec_decode_sorted
from libldpc_tpu.ops.pallas.decode_lanes import bec_decode_lanes
from libldpc_tpu.ops.pallas.lanes_layout import to_lanes_device
from libldpc_tpu.sim.driver import Simulator as JaxSimulator
from libldpc_tpu.utils import params as jparams
from libldpc_tpu_torch import cli
from libldpc_tpu_torch import models as tm
from libldpc_tpu_torch.convert import code_from_jax
from libldpc_tpu_torch.ops import channel
from libldpc_tpu_torch.ops.bec_sorted import bec_decode_sorted
from libldpc_tpu_torch.ops.kernels import decode_bec as db
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.ops.sorted import to_sorted_device
from libldpc_tpu_torch.ops.streaming_fused import init_state, make_streaming_fused_step
from libldpc_tpu_torch.sim.driver import Simulator, route
from libldpc_tpu_torch.utils.params import ChannelParams, DecoderParams, SimulationParams

torch.set_num_threads(2)

E = channel.BEC_ERASURE
assert E == ERASURE


def frames(code, B, eps, seed):
    """Random codewords (all zeros without G) and their BEC symbols, made
    with numpy, in the code's own labelling (u8)."""
    rng = np.random.default_rng(seed)
    if code.G is None:
        cw = np.zeros((code.nc, B), np.uint8)
    else:
        u = rng.integers(0, 2, size=(code.G.shape[0], B))
        cw = (code.G.T.astype(np.int64) @ u % 2).astype(np.uint8)
    sym = np.where(rng.random(cw.shape) < eps, E, cw).astype(np.uint8)
    return sym, cw


def sort_rows(tsdc, *arrays):
    vp = tsdc.vn_perm.numpy()
    return [np.ascontiguousarray(a[vp]) for a in arrays]


def assert_same(jout, tout):
    np.testing.assert_array_equal(np.asarray(jout.symbols_out).astype(np.uint8),
                                  tout.symbols_out.numpy())
    np.testing.assert_array_equal(np.asarray(jout.hard).astype(np.uint8), tout.hard.numpy())
    np.testing.assert_array_equal(np.asarray(jout.iterations), tout.iterations.numpy())
    np.testing.assert_array_equal(np.asarray(jout.resolved), tout.resolved.numpy())


def both(jcode, sym, cw, iterations, early_term, stale=None):
    """The JAX sorted peeling decoder and the port's (through the kernel
    wrapper, which is the plain version on the CPU) on the same frames."""
    tsdc = to_sorted_device(code_from_jax(jcode), "cpu")
    sym_s, cw_s = sort_rows(tsdc, sym, cw)
    jout = jax_bec_decode_sorted(jsorted.to_sorted_device(jcode),
                                 jnp.asarray(sym_s.astype(np.int8)), jnp.asarray(cw_s),
                                 iterations, early_term, stale)
    launches = db.bec_decode_fused.launches
    tout = db.bec_decode_fused(kernel_tables(tsdc), torch.from_numpy(sym_s),
                               torch.from_numpy(cw_s), iterations, early_term, stale)
    assert db.bec_decode_fused.launches == launches  # CPU: the plain version
    return jout, tout


def irregular_code(rng, nc=32, mc=20):
    """A random sparse H with a spread of degrees, every check of degree
    >= 2 and every variable of degree >= 1 (as ``tests/test_fuzz.py``)."""
    while True:
        H = (rng.random((mc, nc)) < 0.12).astype(np.uint8)
        for i in range(mc):
            H[i, rng.integers(0, nc)] = 1
        for v in range(nc):
            if not H[:, v].any():
                H[rng.integers(0, mc), v] = 1
        if (H.sum(1) >= 2).all():
            return jm.LDPCCode.from_dense(H)


@pytest.fixture(scope="module")
def bench96():
    return jm.make_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True)


# ------------------------------------------------------------ the decoders


@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("n", [96, 1152])
def test_plain_matches_jax_sorted(n, early_term):
    jcode = jm.make_benchmark_code(n, 3, 6, seed=7 if n == 96 else 0, with_G=True)
    sym, cw = frames(jcode, 16, 0.42, seed=n)
    jout, tout = both(jcode, sym, cw, 50, early_term)
    assert_same(jout, tout)
    assert cw.any()  # random codewords: the wrong bit is forced on 0s and 1s


@pytest.mark.parametrize("stale", [None, 0])
@pytest.mark.parametrize("trial", range(3))
def test_plain_matches_jax_on_irregular_codes(trial, stale):
    """Degree-1 variables, with and without the reference's stale-byte
    compat mode (its constant-1 wrong bit included)."""
    rng = np.random.default_rng(200 + trial)
    jcode = irregular_code(rng)
    assert (np.bincount(jcode.cols, minlength=jcode.nc) == 1).any()
    G = tm.systematic_generator(code_from_jax(jcode))
    if G is not None:
        jcode.G = G
    for early_term in (True, False):
        sym, cw = frames(jcode, 16, 0.3, seed=trial)
        jout, tout = both(jcode, sym, cw, 20, early_term, stale)
        assert_same(jout, tout)


@pytest.mark.parametrize("transport,dtype", [("benes", "float32"), ("clos", "bfloat16")])
def test_plain_matches_jax_lanes_kernel(bench96, transport, dtype):
    """The TPU kernel itself (interpret mode), min-sum over the sign
    encoding, against the port's byte algebra."""
    ldc = to_lanes_device(bench96, transport=transport)
    tsdc = to_sorted_device(code_from_jax(bench96), "cpu")
    sym, cw = sort_rows(tsdc, *frames(bench96, 16, 0.42, seed=5))
    for early_term in (True, False):
        jout = bec_decode_lanes(ldc, jnp.asarray(sym.astype(np.int8)), jnp.asarray(cw),
                                iterations=10, early_term=early_term, frame_tile=8,
                                message_dtype=dtype, interpret=True)
        tout = db.bec_decode_fused(kernel_tables(tsdc), torch.from_numpy(sym),
                                   torch.from_numpy(cw), 10, early_term)
        assert_same(jout, tout)
        assert tout.resolved.any() and not tout.resolved.all()


@pytest.mark.parametrize("early_term", [True, False])
def test_plain_matches_golden(bench96, early_term):
    tsdc = to_sorted_device(code_from_jax(bench96), "cpu")
    sym, cw = frames(bench96, 6, 0.4, seed=11)
    out = bec_decode_sorted(tsdc, *map(torch.from_numpy, sort_rows(tsdc, sym, cw)), 25,
                            early_term)
    inv = tsdc.vn_inv.numpy()
    golden = GoldenBECDecoder(bench96, iterations=25, early_term=early_term)
    for b in range(sym.shape[1]):
        g_sym, g_hard, g_it = golden.decode(sym[:, b], cw[:, b])
        np.testing.assert_array_equal(out.symbols_out.numpy()[inv, b], g_sym)
        np.testing.assert_array_equal(out.hard.numpy()[inv, b], g_hard)
        assert out.iterations[b] == g_it
        assert bool(out.resolved[b]) == (not (g_sym == ERASURE).any())


def test_degree0_variable_keeps_its_symbol():
    """An empty column of H (bit 4).  Frame 0: only bit 0 is erased; check
    0 recovers it from bits 1 and 2 in the first pass, so the frame is
    resolved with 0 iterations counted.  Frame 1: bit 4 is erased too and
    no check can recover it, so it stays erased for all 5 iterations and
    decides the wrong bit.  Deliberate difference: the JAX package's
    sorted decoder reports the degree-0 bit as erased even when it is
    known (and misaligns the later classes), so frame 0 is unresolved
    there."""
    H = np.array([[1, 1, 1, 0, 0], [0, 1, 1, 1, 0]], np.uint8)
    tcode = tm.LDPCCode.from_dense(H)
    tsdc = to_sorted_device(tcode, "cpu")
    cw = np.zeros((5, 2), np.uint8)
    sym = np.zeros((5, 2), np.uint8)
    sym[0, :] = E
    sym[4, 1] = E
    sym_s, cw_s = sort_rows(tsdc, sym, cw)
    out = db.bec_decode_fused(kernel_tables(tsdc), torch.from_numpy(sym_s),
                              torch.from_numpy(cw_s), 5, True)
    inv = tsdc.vn_inv.numpy()
    np.testing.assert_array_equal(out.symbols_out.numpy()[inv],
                                  [[0, 0], [0, 0], [0, 0], [0, 0], [0, E]])
    np.testing.assert_array_equal(out.hard.numpy()[inv], [[0, 0]] * 4 + [[0, 1]])
    assert out.iterations.tolist() == [0, 5]
    assert out.resolved.tolist() == [True, False]
    jout = jax_bec_decode_sorted(jsorted.to_sorted_device(jm.LDPCCode.from_dense(H)),
                                 jnp.asarray(sym_s.astype(np.int8)), jnp.asarray(cw_s), 5, True)
    assert not bool(np.asarray(jout.resolved)[0])  # the JAX-side fault, not copied


def test_zero_iterations(bench96):
    """No pass: the kernel wrapper and its plain version return what
    ``bec_decode_lanes`` returns (the channel symbols, 0 iterations); the
    sorted decoder, like the JAX one, leaves every posterior erased."""
    ldc = to_lanes_device(bench96, transport="benes")
    tsdc = to_sorted_device(code_from_jax(bench96), "cpu")
    sym, cw = sort_rows(tsdc, *frames(bench96, 8, 0.1, seed=2))
    jout = bec_decode_lanes(ldc, jnp.asarray(sym.astype(np.int8)), jnp.asarray(cw), iterations=0,
                            interpret=True)
    for fn in (db.bec_decode_fused, db.bec_decode_fused_plain):
        assert_same(jout, fn(kernel_tables(tsdc), torch.from_numpy(sym), torch.from_numpy(cw), 0))
    jsorted_out, _ = both(bench96, *frames(bench96, 8, 0.1, seed=2), 0, True)
    tsorted_out = bec_decode_sorted(tsdc, torch.from_numpy(sym), torch.from_numpy(cw), 0)
    assert_same(jsorted_out, tsorted_out)
    assert (tsorted_out.symbols_out == E).all()


def test_wrapper_checks_its_inputs(bench96):
    tables = kernel_tables(to_sorted_device(code_from_jax(bench96), "cpu"))
    sym = torch.zeros((96, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="symbols_in"):
        db.bec_decode_fused(tables, sym.float(), sym)
    with pytest.raises(ValueError, match="degree1_stale_byte"):
        db.bec_decode_fused(tables, sym, sym, 5, True, 7)


# ------------------------------------------------------------ streaming


def drained_totals(tables, sym, cw, cap, k, stale=None, via_pool=True):
    """Run the plain stream chunk on frames given to every lane (through
    the pool, or injected at age 0) until every lane is idle; the counter
    totals."""
    B = sym.shape[1]
    st = init_state(tables, B, "BEC")
    refill = torch.ones(1, dtype=torch.int32)
    if via_pool:
        st.fresh_llr.copy_(torch.from_numpy(sym))
        st.fresh_cw.copy_(torch.from_numpy(cw))
        st.avail.fill_(1)
    else:
        st.llr_in.copy_(torch.from_numpy(sym))
        st.codeword.copy_(torch.from_numpy(cw))
        st.done.zero_()
    remaining = torch.full((1,), B, dtype=torch.int32)
    for _ in range(4 * cap):
        launches = db.bec_stream_chunk_fused.launches
        db.bec_stream_chunk_fused(tables, st.llr_in, st.codeword, st.lv2c, st.done, st.iters,
                                  st.age, st.avail, st.ctr, st.fresh_llr, st.fresh_cw, refill,
                                  remaining, k=k, cap=cap, degree1_stale_byte=stale)
        assert db.bec_stream_chunk_fused.launches == launches
        refill.zero_()
        if int((st.done == 0).sum()) == 0:
            return st.ctr.sum(1).tolist()
    raise AssertionError("streams did not drain")


def batch_totals(tables, sym, cw, iterations, stale=None):
    out = db.bec_decode_fused(tables, torch.from_numpy(sym), torch.from_numpy(cw), iterations,
                              True, stale)
    bp = tables.code.bit_pos.long()
    errs = (out.hard[bp] != torch.from_numpy(cw)[bp]).sum(0)
    return [int(errs.sum()), int((errs > 0).sum()), sym.shape[1], int(out.iterations.sum()), 0]


@pytest.mark.parametrize("via_pool", [True, False])
@pytest.mark.parametrize("iters,k", [(9, 4), (20, 6)])
def test_stream_drain_matches_batch(bench96, iters, k, via_pool):
    """As the JAX package's ``test_bec_drain_matches_batch_bec_kernel``:
    every frame runs the same passes in a lane as in the batch decoder, so
    the drained counters equal the batch's (row 4, starts, aside)."""
    tables = kernel_tables(to_sorted_device(code_from_jax(bench96), "cpu"))
    sym, cw = sort_rows(tables.code, *frames(bench96, 16, 0.45, seed=iters))
    got = drained_totals(tables, sym, cw, iters, k, via_pool=via_pool)
    want = batch_totals(tables, sym, cw, iters)
    assert got[:4] == want[:4]
    assert got[4] == (16 if via_pool else 0)
    assert 0 < want[1] < 16


def test_stream_drain_matches_batch_compat():
    """The bug-compatible mode on a code with degree-1 variables, through
    the pool (a reload starts from the channel symbols, as the batch does)."""
    jcode = irregular_code(np.random.default_rng(201))
    tables = kernel_tables(to_sorted_device(code_from_jax(jcode), "cpu"))
    sym, cw = sort_rows(tables.code, *frames(jcode, 16, 0.3, seed=4))
    got = drained_totals(tables, sym, cw, 12, 5, stale=0)
    assert got[:4] == batch_totals(tables, sym, cw, 12, stale=0)[:4]


def test_streaming_step_quota_exact(bench96):
    """``max_frames`` = 37 is met exactly at ε = 0.55, with frame errors."""
    tables = kernel_tables(to_sorted_device(code_from_jax(bench96), "cpu"))
    init_fn, step_fn = make_streaming_fused_step(tables, "BEC", DecoderParams(iterations=8), 16,
                                                 chunk_iters=4, max_frames=37)
    st = init_fn()
    assert st.lv2c.dtype == torch.uint8 and st.fresh_llr.dtype == torch.uint8
    frames_, fec = 0, 0
    for step in range(100):
        st, acc = step_fn(st, channel.make_generator("cpu", 3, 0, step), 0.55, True)
        frames_ += int(acc.frames)
        fec += int(acc.frame_errors)
        if frames_ >= 37 and int(acc.n_active) == 0:
            break
    assert frames_ == 37 and int(st.started) == 37
    assert fec > 0


def test_streaming_layered_bec_raises(bench96):
    tables = kernel_tables(to_sorted_device(code_from_jax(bench96), "cpu"))
    with pytest.raises(ValueError, match="no BEC form"):
        make_streaming_fused_step(tables, "BEC", DecoderParams(iterations=8), 16, layered=True)


# ------------------------------------------------------------ channel, sweep


def test_bec_channel_statistics():
    code = tm.make_benchmark_code(96, 3, 6, seed=7, with_G=True)
    code.puncture = np.array([0, 1], np.int32)
    code.shorten = np.array([5, 6, 7], np.int32)
    sdc = to_sorted_device(code, "cpu")
    eps = 0.3
    out = channel.simulate_channel(sdc, "BEC", channel.make_generator("cpu", 4), 4096, eps)
    sym, cw = out.llr, out.codeword
    assert sym.dtype == torch.uint8 and cw.dtype == torch.uint8
    assert set(sym.unique().tolist()) <= {0, 1, E}
    assert (sym[sdc.puncture.long()] == E).all()
    assert torch.equal(sym[sdc.shorten.long()], cw[sdc.shorten.long()])
    tx = sym[sdc.bit_pos.long()]
    known = tx != E
    assert torch.equal(tx[known], cw[sdc.bit_pos.long()][known])
    n = tx.numel()
    z = (float((~known).sum()) - n * eps) / np.sqrt(n * eps * (1 - eps))
    assert abs(z) < 3
    orig = cw.numpy()[sdc.vn_inv.numpy()]
    assert not ((code.H_dense.astype(np.int64) @ orig) % 2).any()


def _rows(path):
    lines = path.read_text().splitlines()
    return [ln for ln in lines if ln.startswith("#")], np.array(
        [ln.split() for ln in lines if not ln.startswith("#")][1:], dtype=float)


def test_cli_bec_sweep_fer_agrees_with_jax(tmp_path):
    code = tm.make_benchmark_code(96, 3, 6, seed=7, with_G=True)
    tm.write_codefile(str(tmp_path / "h.txt"), code.rows, code.cols, code.nc, code.mc)
    r, c = np.nonzero(code.G)
    (tmp_path / "g.txt").write_text("".join(f"{i} {j}\n" for i, j in zip(r, c)))
    common = [str(tmp_path / "h.txt")]
    sweep = ["0.30", "0.451", "0.05", "-G", str(tmp_path / "g.txt"), "--channel", "BEC", "-i",
             "20", "--frame-error-count", "40", "--batch-size", "64", "--max-frames", "4000",
             "-s", "5"]
    assert cli.main(common + [str(tmp_path / "t.txt")] + sweep + ["--device", "cpu"]) == 0
    assert jax_cli.main(common + [str(tmp_path / "j.txt")] + sweep) == 0
    (comment,), t = _rows(tmp_path / "t.txt")
    _, j = _rows(tmp_path / "j.txt")
    assert "kernel=torch-plain dtype=uint8-3state cn=peeling schedule=flooding streaming=off" \
        in comment
    np.testing.assert_allclose(t[:, 0], [0.45, 0.40, 0.35, 0.30])  # reversed, as in the JAX CLI
    np.testing.assert_allclose(t[:, 0], j[:, 0])
    for (_, f1, _, n1, *_), (_, f2, _, n2, *_) in zip(t, j):
        p = (f1 * n1 + f2 * n2) / (n1 + n2)
        z = (f1 - f2) / np.sqrt(p * (1 - p) * (1 / n1 + 1 / n2))
        assert abs(z) < 3, (f1, n1, f2, n2)
    assert t[0, 1] > t[-1, 1]  # FER falls with the erasure probability


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("layered", [False, True])
def test_routing_matches_jax_decode_path(layered, use_pallas, compat):
    """Both packages batch-step the BEC with a flooding peeling decoder for
    every combination of ``--layer-file``, ``--pallas`` and the compat
    mode.  The JAX package's ``decode_path`` names its kernel (the lanes
    kernel for ``--pallas`` outside the layered and compat modes, else its
    sorted decoder) and says ``schedule=layered`` with a layer file though
    its peeling ignores the layers; the port says ``flooding``."""
    jcode = jm.wifi_code(648, with_G=False)
    tcode = code_from_jax(jcode)
    common = dict(iterations=8, layered=layered, bec_ref_bug_compat=compat)
    ch = dict(seed=1, x_range=(0.3, 0.31, 1.0), type="BEC")
    sp = dict(batch_size=32, fec=3, max_frames=128)
    jsim = JaxSimulator(jcode, jparams.DecoderParams(**common), jparams.ChannelParams(**ch),
                        jparams.SimulationParams(**sp), use_pallas=use_pallas, verbose=False)
    tsim = Simulator(tcode, DecoderParams(**common), ChannelParams(**ch), SimulationParams(**sp),
                     device="cpu", verbose=False, use_pallas=use_pallas)
    jpath = dict(p.split("=", 1) for p in jsim.decode_path.split() if "=" in p)
    tpath = dict(p.split("=", 1) for p in tsim.decode_path.split() if "=" in p)
    fused = use_pallas and not layered and not compat
    assert jpath["kernel"] == ("pallas-lanes" if fused else "xla-sorted")
    assert jpath["streaming"] == tpath["streaming"] == "off"
    assert jpath["schedule"] == ("layered" if layered else "flooding")
    assert tpath["schedule"] == "flooding" and tpath["kernel"] == "torch-plain"
    assert ("bec" in tpath) == compat
    assert route(tcode, DecoderParams(**common), use_pallas, "BEC")[0] == "flooding"
    assert tsim.tables.n_layers == 0  # no layer tables are built for the peeling


def test_bec_sweep_ignores_layers():
    """The same seed with and without the layered flag gives the same
    counts: the peeling decoder runs flooding either way."""
    code = tm.wifi_code(648)

    def run(layered):
        return Simulator(code, DecoderParams(iterations=10, layered=layered),
                         ChannelParams(seed=2, x_range=(0.4, 0.41, 1.0), type="BEC"),
                         SimulationParams(batch_size=32, fec=10**6, max_frames=64),
                         device="cpu", verbose=False).start()

    a, b = run(False), run(True)
    assert a.fec == b.fec and a.frames == b.frames and a.ber == b.ber and a.avg_iter == b.avg_iter
