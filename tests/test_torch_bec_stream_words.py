"""The word form of the BEC streaming chunk (what the CUDA kernel K7 runs:
a block's 32 frames as bit-sliced words for the whole chunk) in plain
PyTorch, against the port's byte chunk and the JAX package's lane-major
BEC stream, on the CPU.

``ops/bec_sorted.py`` ``bec_stream_chunk_words`` packs the carried planes
into words, reloads under a grant mask, runs ``bec_words_pass`` on the
frames in flight, counts errors through the kernel's warp transposition,
and unpacks at exit.  The algebra is integer, so it is held exactly: every
carried plane and counter equal to ``bec_stream_chunk_fused_plain``'s after
each chunk (both grant starts in lane order, so a binding quota starts the
same lanes), and drained totals equal to the JAX stream kernel's (interpret
mode) and to ``bec_decode_lanes``.  Inputs are random codewords and
erasures made with numpy from a seed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libldpc_tpu import models as jm
from libldpc_tpu.ops.pallas.decode_lanes import bec_decode_lanes
from libldpc_tpu.ops.pallas.lanes_layout import to_lanes_device
from libldpc_tpu.ops.streaming_pallas import make_streaming_lanes_step
from libldpc_tpu.utils.params import DecoderParams as JaxDecoderParams
from libldpc_tpu_torch import models as tm
from libldpc_tpu_torch.convert import code_from_jax
from libldpc_tpu_torch.ops import bec_sorted as bs
from libldpc_tpu_torch.ops.channel import BEC_ERASURE as E
from libldpc_tpu_torch.ops.kernels import decode_bec as db
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.ops.sorted import to_sorted_device
from libldpc_tpu_torch.ops.streaming_fused import init_state

torch.set_num_threads(2)

#: the carried state of a chunk, in the order the chunk functions take it
PLANES = ("llr_in", "codeword", "lv2c", "done", "iters", "age", "avail", "ctr", "fresh_llr",
          "fresh_cw")


def irregular_code():
    """A random irregular code (the recipe of ``test_torch_bec.py``
    ``irregular_code``) with degree-1 variables, a degree-1 check (it pins
    bit 3) and a degree-0 variable (an empty column, bit 7)."""
    rng = np.random.default_rng(29)
    H = (rng.random((40, 72)) < 0.08).astype(np.uint8)
    for i in range(40):
        H[i, rng.integers(0, 72)] = 1
        H[i, rng.integers(0, 72)] = 1
    for v in range(72):
        if not H[:, v].any():
            H[rng.integers(0, 40), v] = 1
    H[0] = 0
    H[0, 3] = 1
    H[:, 7] = 0
    code = tm.LDPCCode.from_dense(H)
    deg_v = np.bincount(code.cols, minlength=code.nc)
    assert (deg_v == 1).any() and (deg_v == 0).any()
    assert (np.bincount(code.rows, minlength=code.mc) == 1).any()
    return code


CODES = {
    "bench1152": lambda: tm.make_benchmark_code(1152, 3, 6, seed=0, with_G=True),
    "irregular": irregular_code,
}
#: an erasure rate at which a few passes resolve some frames and not others
EPS = {"bench1152": 0.36, "irregular": 0.2}


@pytest.fixture(scope="module", params=sorted(CODES))
def tables(request):
    return request.param, kernel_tables(to_sorted_device(CODES[request.param](), "cpu"))


def frames(sdc, B, eps, rng):
    """Random codewords (zeros without a generator) and their BEC symbols,
    sorted labelling, u8."""
    if sdc.G is None:
        cw = np.zeros((sdc.nc, B), np.uint8)
    else:
        u = rng.integers(0, 2, size=(sdc.G.shape[0], B))
        cw = (sdc.G.numpy().T.astype(np.int64) @ u % 2).astype(np.uint8)
    sym = np.where(rng.random(cw.shape) < eps, E, cw).astype(np.uint8)
    return torch.from_numpy(sym), torch.from_numpy(cw)


def test_transpose32_is_the_transpose():
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 2**32, (2, 32, 3)))
    t = bs.transpose32(x)
    bits = lambda w: (w[..., None] >> torch.arange(32)) & 1  # [..., 32 rows, W, 32 bits]
    assert torch.equal(bits(t), bits(x).permute(0, 3, 2, 1))


def test_count_frame_bits():
    rng = np.random.default_rng(4)
    B = 77
    bad = rng.random((45, B)) < 0.3
    words = bs._to_words(torch.from_numpy(bad))
    assert bs.count_frame_bits(words, B).tolist() == bad.sum(0).tolist()


@pytest.mark.parametrize("stale", [None, 0, 1])
@pytest.mark.parametrize("B", [45, 77])
def test_word_chunk_matches_plain(tables, B, stale):
    """Chunk by chunk from a state with lanes injected at age 0 and a pool
    for every lane: the first chunk's quota starts the idle lanes and two
    more; the next three chunks' quotas (5) bind as lanes finish mid-chunk
    (lane-order grants in both); the consumed entries take new frames
    between chunks, then the lanes drain with reloads off.  Every carried
    plane and counter equal after every chunk."""
    name, tb = tables
    sdc = tb.code
    rng = np.random.default_rng([B, 0 if stale is None else stale + 1])
    st = init_state(tb, B, "BEC")
    sym, cw = frames(sdc, B, EPS[name], rng)
    inject = torch.from_numpy(rng.random(B) < 0.3)
    st.llr_in.copy_(torch.where(inject, sym, st.llr_in))
    st.codeword.copy_(torch.where(inject, cw, st.codeword))
    st.done.copy_((~inject).to(torch.int32))
    word, plain = ({n: getattr(st, n).clone() for n in PLANES} for _ in range(2))
    quota = {"word": torch.zeros(1, dtype=torch.int32), "plain": torch.zeros(1, dtype=torch.int32)}
    refill = torch.ones(1, dtype=torch.int32)
    cap, k = 9, 4
    started, bound = 0, 0
    for chunk in range(8 * cap):
        if chunk == 4:
            refill.zero_()  # drain
        if refill.item():  # the consumed entries take new frames
            fsym, fcw = frames(sdc, B, EPS[name], rng)
            take = plain["avail"] == 0
            for st_ in (word, plain):
                st_["fresh_llr"].copy_(torch.where(take, fsym, st_["fresh_llr"]))
                st_["fresh_cw"].copy_(torch.where(take, fcw, st_["fresh_cw"]))
                st_["avail"].fill_(1)
            for q in quota.values():
                q.fill_(5 if chunk else int((~inject).sum()) + 2)
            started += int(quota["plain"])
        bs.bec_stream_chunk_words(sdc, *word.values(), refill, quota["word"], k=k, cap=cap,
                                  degree1_stale_byte=stale)
        db.bec_stream_chunk_fused_plain(tb, *plain.values(), refill, quota["plain"], k=k,
                                        cap=cap, degree1_stale_byte=stale)
        for n in PLANES:
            assert torch.equal(word[n], plain[n]), (chunk, n)
        assert torch.equal(quota["word"], quota["plain"])
        started -= int(quota["plain"])
        bound += 1 <= chunk <= 3 and int(quota["plain"]) == 0
        if not refill.item() and not (plain["done"] == 0).any():
            break
    else:
        raise AssertionError("streams did not drain")
    totals = plain["ctr"].sum(1).tolist()
    assert 0 < totals[1] < totals[2] and totals[2] == totals[4] + int(inject.sum())
    assert totals[4] == started and bound >= 2


# ------------------------------------------------- against the JAX package


@pytest.fixture(scope="module")
def bench96():
    return jm.make_benchmark_code(96, 3, 6, seed=7, with_G=True)


def jax_lanes_stream_totals(ldc, sym, cw, iters):
    """As ``test_streaming_pallas.py``
    ``test_bec_drain_matches_batch_bec_kernel``: the frames injected into
    the lane-major stream (sign encoding, lane space), drained."""
    B = sym.shape[1]
    init_fn, step_fn = make_streaming_lanes_step(
        ldc, "BEC", JaxDecoderParams(iterations=iters), B, chunk_iters=4, interpret=True,
        frame_tile=8)
    sign = np.where(sym == E, 0.0, 1.0 - 2.0 * sym.astype(np.float32)).astype(np.float32)
    real = np.zeros((ldc.nc_pad, 1), np.float32)
    real[np.asarray(ldc.lane_of_vn)] = 1.0
    llr_l = (np.asarray(jnp.take(jnp.asarray(sign), ldc.vn_of_lane, axis=0, mode="fill",
                                 fill_value=0.0)) * real).T
    cw_l = (np.asarray(jnp.take(jnp.asarray(cw.astype(np.float32)), ldc.vn_of_lane, axis=0,
                                mode="fill", fill_value=0.0)) * real).T
    state = init_fn()._replace(llr_in=jnp.asarray(llr_l, jnp.float32),
                               codeword=jnp.asarray(cw_l).astype(jnp.int32),
                               done=jnp.zeros((B, 128), jnp.int32))
    totals = np.zeros(4, dtype=np.int64)
    for step in range(60):
        state, acc = step_fn(state, jax.random.PRNGKey(step), np.float32(0.45),
                             jnp.asarray(False))
        totals += [int(acc.bit_errors), int(acc.frame_errors), int(acc.frames),
                   int(acc.iter_sum)]
        if int(acc.n_active) == 0:
            return totals.tolist()
    raise AssertionError("JAX streams did not drain")


def word_drain_totals(tb, sym, cw, iters, k, via_pool):
    """The word chunk on frames given to every lane (through the pool, or
    injected at age 0), drained; the counter totals."""
    B = sym.shape[1]
    st = init_state(tb, B, "BEC")
    if via_pool:
        st.fresh_llr.copy_(sym)
        st.fresh_cw.copy_(cw)
        st.avail.fill_(1)
    else:
        st.llr_in.copy_(sym)
        st.codeword.copy_(cw)
        st.done.zero_()
    refill = torch.ones(1, dtype=torch.int32)
    remaining = torch.full((1,), B, dtype=torch.int32)
    for _ in range(4 * iters):
        bs.bec_stream_chunk_words(tb.code, *(getattr(st, n) for n in PLANES), refill, remaining,
                                  k=k, cap=iters)
        refill.zero_()
        if not (st.done == 0).any():
            return st.ctr.sum(1).tolist()
    raise AssertionError("streams did not drain")


def test_word_chunk_drains_like_jax(bench96):
    """Drained totals of the word chunk (frames through the pool and
    injected at age 0) equal the JAX lane-major BEC stream's and those of
    ``bec_decode_lanes`` on the same numpy frames."""
    ldc = to_lanes_device(bench96)
    tb = kernel_tables(to_sorted_device(code_from_jax(bench96), "cpu"))
    B, iters = 16, 9
    sym, cw = (t.numpy() for t in frames(tb.code, B, 0.45, np.random.default_rng(5)))
    out = bec_decode_lanes(ldc, jnp.asarray(sym.astype(np.int8)), jnp.asarray(cw),
                           iterations=iters, early_term=True, interpret=True, frame_tile=8)
    bp = tb.code.bit_pos.numpy()
    errs = (np.asarray(out.hard)[bp] != cw[bp]).sum(0)
    batch = [int(errs.sum()), int((errs > 0).sum()), B, int(np.asarray(out.iterations).sum())]
    assert 0 < batch[1] < B
    assert jax_lanes_stream_totals(ldc, sym, cw, iters) == batch
    for via_pool, k in ((True, 4), (False, 6)):
        got = word_drain_totals(tb, torch.from_numpy(sym), torch.from_numpy(cw), iters, k, via_pool)
        assert got == batch + [B if via_pool else 0]


# ------------------------------------------------------------ the size rule


def test_bec_stream_form():
    """Words for the 1152 (3,6) code (46 KB a word) and the 802.11n n=1944
    code (87 KB); bytes for a (3,6) code whose words pass a block's shared
    memory (40 nc bytes: nc >= 5810); the switch forces bytes."""
    def form(code):
        return db.bec_stream_form(kernel_tables(to_sorted_device(code, "cpu")))

    bench, wifi = tm.make_benchmark_code(1152, 3, 6, seed=0), tm.wifi_code(1944, with_layers=False)
    big = tm.make_benchmark_code(5810, 3, 6, seed=0)
    assert [form(bench), form(wifi), form(big)] == ["words", "words", "bytes"]
    tb = kernel_tables(to_sorted_device(big, "cpu"))
    assert db.words_state_bytes(tb) == 40 * 5810 > db.SMEM_BLOCK_BYTES
    db.FORCE_BYTES = True
    try:
        assert form(bench) == "bytes"
    finally:
        db.FORCE_BYTES = False
    assert form(bench) == "words"
