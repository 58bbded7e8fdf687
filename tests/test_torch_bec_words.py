"""The bit-sliced BEC peeling algebra (32 frames to an int32 word, the form
the CUDA batch kernel runs) in plain PyTorch, against the byte version of
the port and against the JAX package's sorted peeling decoder, on the CPU.

The algebra is integer, so every output is held exactly: posterior
symbols, decisions, iteration counts and resolution flags.  Inputs are
random codewords and erasures made with numpy from a seed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libldpc_tpu import models as jm
from libldpc_tpu.ops import sorted as jsorted
from libldpc_tpu.ops.bec_sorted import bec_decode_sorted as jax_bec_decode_sorted
from libldpc_tpu_torch import models as tm
from libldpc_tpu_torch.ops import bec_sorted as bs
from libldpc_tpu_torch.ops import channel
from libldpc_tpu_torch.ops.kernels import decode_bec as db
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.ops.sorted import to_sorted_device

torch.set_num_threads(2)

E = channel.BEC_ERASURE


def degree1_code():
    """A random irregular code with degree-1 variables, a degree-1 check
    (it pins bit 3) and a degree-0 variable (an empty column, bit 7)."""
    rng = np.random.default_rng(17)
    H = (rng.random((60, 120)) < 0.05).astype(np.uint8)
    for i in range(60):
        H[i, rng.integers(0, 120)] = 1
        H[i, rng.integers(0, 120)] = 1
    for v in range(120):
        if not H[:, v].any():
            H[rng.integers(0, 60), v] = 1
    H[0] = 0
    H[0, 3] = 1
    H[:, 7] = 0
    code = tm.LDPCCode.from_dense(H)
    deg_v = np.bincount(code.cols, minlength=code.nc)
    assert (deg_v == 1).any() and (deg_v == 0).any()
    assert (np.bincount(code.rows, minlength=code.mc) == 1).any()
    return code


CODES = {
    "bench96": lambda: tm.make_benchmark_code(96, 3, 6, seed=7, with_G=True),
    "bench1152": lambda: tm.make_benchmark_code(1152, 3, 6, seed=0, with_G=True),
    "degree1": degree1_code,
}


@pytest.fixture(scope="module", params=sorted(CODES))
def sdc(request):
    return to_sorted_device(CODES[request.param](), "cpu")


def frames(sdc, B, eps, seed):
    """Random codewords (zeros without a generator) and their BEC symbols,
    sorted labelling, u8, made with numpy."""
    rng = np.random.default_rng(seed)
    if sdc.G is None:
        cw = np.zeros((sdc.nc, B), np.uint8)
    else:
        u = rng.integers(0, 2, size=(sdc.G.shape[0], B))
        cw = (sdc.G.numpy().T.astype(np.int64) @ u % 2).astype(np.uint8)
    sym = np.where(rng.random(cw.shape) < eps, E, cw).astype(np.uint8)
    return torch.from_numpy(sym), torch.from_numpy(cw)


def assert_equal(got, want):
    for a, b, name in zip(got, want, got._fields):
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("B", [32, 1000, 33])  # 33, 1000: a ragged last word
def test_pack_unpack_round_trip(B):
    rng = np.random.default_rng(B)
    sym = torch.from_numpy(rng.integers(0, 3, size=(17, B)).astype(np.uint8))
    known, value = bs.pack_symbols(sym)
    assert known.dtype == value.dtype == torch.int32
    assert known.shape == value.shape == (17, (B + 31) // 32)
    assert not (value & ~known).any()  # the value bit of an erasure is 0
    assert torch.equal(bs.unpack_symbols(known, value, B), sym)
    if B % 32:  # a frame past the batch is a known 0
        assert ((known[:, -1] >> (B % 32)) == -1).all()


@pytest.mark.parametrize("stale", [None, 0])
@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("B", [32, 1000, 33])
def test_word_decode_matches_byte_decode(sdc, B, early_term, stale):
    if sdc.nc > 1000 and B == 1000:
        B = 200  # the 1152 code: fewer frames, still ragged
    sym, cw = frames(sdc, B, 0.40, seed=B)
    want = bs.bec_decode_sorted(sdc, sym, cw, 25, early_term, stale)
    got = bs.bec_decode_words(sdc, sym, cw, 25, early_term, stale)
    assert_equal(got, want)
    assert not want.resolved.all() and (want.iterations > 0).any()
    if not early_term:
        assert (got.iterations == 25).all()


@pytest.mark.parametrize("stale", [None, 0, 1])
def test_word_pass_matches_byte_pass(sdc, stale):
    """One pass from messages a few passes into a decode: the posterior and
    the new messages, symbol for symbol."""
    sym, cw = frames(sdc, 70, 0.45, seed=3)
    lv2c = sym.index_select(0, sdc.col_sorted)
    for _ in range(3):
        post, new = bs.bec_pass(sdc, sym, cw, lv2c, stale)
        chk, _ = bs.pack_symbols(sym)
        pk, pv, mk, mv = bs.bec_words_pass(sdc, chk, bs.pack_symbols(cw)[1],
                                           *bs.pack_symbols(lv2c), stale)
        assert torch.equal(bs.unpack_symbols(pk, pv, 70), post)
        assert torch.equal(bs.unpack_symbols(mk, mv, 70), new)
        lv2c = new


def test_wrapper_takes_the_byte_version_on_the_cpu(sdc):
    """The kernel wrapper's plain version stays the byte decoder; the word
    decoder agrees with what it returns."""
    sym, cw = frames(sdc, 40, 0.35, seed=9)
    launches = db.bec_decode_fused.launches
    out = db.bec_decode_fused(kernel_tables(sdc), sym, cw, 30, True)
    assert db.bec_decode_fused.launches == launches
    assert_equal(bs.bec_decode_words(sdc, sym, cw, 30, True), out)


def test_degree0_variable_keeps_its_symbol():
    """The case of ``test_torch_bec.py``: bit 4 is an empty column of H."""
    H = np.array([[1, 1, 1, 0, 0], [0, 1, 1, 1, 0]], np.uint8)
    tsdc = to_sorted_device(tm.LDPCCode.from_dense(H), "cpu")
    vp = tsdc.vn_perm.numpy()
    sym = np.zeros((5, 2), np.uint8)
    sym[0, :] = E
    sym[4, 1] = E
    out = bs.bec_decode_words(tsdc, torch.from_numpy(sym[vp]), torch.zeros((5, 2), dtype=torch.uint8),
                              5, True)
    inv = tsdc.vn_inv.numpy()
    np.testing.assert_array_equal(out.symbols_out.numpy()[inv],
                                  [[0, 0], [0, 0], [0, 0], [0, 0], [0, E]])
    assert out.iterations.tolist() == [0, 5] and out.resolved.tolist() == [True, False]


@pytest.mark.parametrize("stale", [None, 0])
@pytest.mark.parametrize("early_term", [True, False])
def test_word_decode_matches_jax_sorted(early_term, stale):
    """Against the JAX package's sorted peeling decoder, on a code without
    degree-0 variables (its fault there is not copied), bit for bit."""
    jcode = jm.make_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True)
    tsdc = to_sorted_device(CODES["bench96"](), "cpu")
    sym, cw = frames(tsdc, 45, 0.42, seed=11)
    jout = jax_bec_decode_sorted(jsorted.to_sorted_device(jcode),
                                 jnp.asarray(sym.numpy().astype(np.int8)),
                                 jnp.asarray(cw.numpy()), 30, early_term, stale)
    got = bs.bec_decode_words(tsdc, sym, cw, 30, early_term, stale)
    np.testing.assert_array_equal(np.asarray(jout.symbols_out).astype(np.uint8),
                                  got.symbols_out.numpy())
    np.testing.assert_array_equal(np.asarray(jout.hard).astype(np.uint8), got.hard.numpy())
    np.testing.assert_array_equal(np.asarray(jout.iterations), got.iterations.numpy())
    np.testing.assert_array_equal(np.asarray(jout.resolved), got.resolved.numpy())


def test_size_rule():
    """The batch kernel's state per word and where it lives."""
    small = kernel_tables(to_sorted_device(CODES["bench1152"](), "cpu"))
    assert db.words_state_bytes(small) == (4 * 1152 + 2 * 3456) * 4
    assert db.words_in_shared(small)
    big = kernel_tables(to_sorted_device(tm.make_regular_code(8190, 3, 6, seed=0), "cpu"))
    assert db.words_state_bytes(big) > db.SMEM_BLOCK_BYTES and not db.words_in_shared(big)
