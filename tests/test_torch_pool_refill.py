"""The streaming pool's refill (K8's plain version, its tables and the
streaming step's draws) on the CPU against the JAX package.

* The step draws a channel batch exactly in the chunks where the JAX
  super-step's ``lax.cond(do_gen, gen, keep)`` draws one (``refill`` and
  ``used >= watermark``), and never in a drain.
* Against the JAX super-step (interpret mode) from the same pool planes, the
  entries replaced and ``avail`` after are equal.
* The pool's statistics agree with the JAX ``simulate_channel``'s within 5
  standard errors.
* K8's tables: the packed generator columns encode as ``G`` does, and the
  kernel's value formulas (emulated in NumPy on the tables) give the plain
  channel's values on the same codewords and draws.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libldpc_tpu.models import make_benchmark_code
from libldpc_tpu.ops import channel as jchannel
from libldpc_tpu.ops import modulation as jmod
from libldpc_tpu.ops.pallas.layout import to_pallas_device
from libldpc_tpu.ops.streaming_pallas import make_streaming_pallas_step
from libldpc_tpu.utils.params import DecoderParams
from libldpc_tpu_torch.convert import code_from_jax
from libldpc_tpu_torch.ops import channel, modulation as mod
from libldpc_tpu_torch.ops import streaming_fused
from libldpc_tpu_torch.ops.kernels import pool_refill as pr
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.ops.sorted import to_sorted_device
from libldpc_tpu_torch.ops.streaming_fused import make_streaming_fused_step
from libldpc_tpu_torch.utils.params import SHORTEN_LLR

torch.set_num_threads(2)
GRAY4 = [0, 1, 3, 2]


@pytest.fixture(scope="module")
def setup():
    code = make_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True)
    return code, to_pallas_device(code), kernel_tables(to_sorted_device(code_from_jax(code), "cpu"))


def test_step_draws_only_where_jax_draws(setup, monkeypatch):
    """A spy on the step's channel draw: a draw before chunk j exactly when
    refill is on and ``B - sum(avail)`` after chunk j - 1 reaches the
    watermark; none while draining."""
    _, _, tables = setup
    B = 32
    events = []
    draw = pr.simulate_channel

    def spy_draw(*args, **kwargs):
        events.append("draw")
        return draw(*args, **kwargs)

    chunk = streaming_fused.bp_stream_chunk_fused

    def spy_chunk(*args, **kwargs):
        chunk(*args, **kwargs)
        events.append(("chunk", int(args[7].sum()), int(args[11][0])))  # avail after, refill

    monkeypatch.setattr(pr, "simulate_channel", spy_draw)
    monkeypatch.setattr(streaming_fused, "bp_stream_chunk_fused", spy_chunk)
    init_fn, step_fn = make_streaming_fused_step(tables, "AWGN", DecoderParams(iterations=20),
                                                 B, chunk_iters=4)
    st, frames = init_fn(), 0
    for step in range(10):
        st, acc = step_fn(st, channel.make_generator("cpu", 3, step), 1.5, step < 6)
        frames += int(acc.frames)
    assert frames > 2 * B  # lanes finished and reloaded
    drawn, avail_before, chunks = [], 0, []
    pending = False
    for e in events:
        if e == "draw":
            pending = True
            continue
        _, avail_after, refill = e
        chunks.append((refill, avail_before))
        drawn.append(pending)
        pending, avail_before = False, avail_after
    want = [bool(refill) and B - avail >= pr.pool_watermark(B) for refill, avail in chunks]
    assert drawn == want
    assert len(chunks) == 10 * 5
    assert 0 < sum(drawn) < sum(refill for refill, _ in chunks)  # some refilling chunks keep
    assert not any(d for d, (refill, _) in zip(drawn, chunks) if not refill)


@pytest.mark.parametrize("used,refill", [(28, True), (24, True), (23, True), (0, True),
                                         (32, False)])
def test_replaced_entries_and_avail_match_jax_superstep(setup, used, refill):
    """From the same pool planes (``used`` of 32 entries consumed, the
    watermark 24) and a quota of 0 (so no lane starts and ``avail`` after
    the super-step is the refill's), one JAX super-step and one of the port
    replace the same entries and leave the same ``avail``."""
    _, pdc, tables = setup
    B, dec = 32, DecoderParams(iterations=8, type="BP_MS")
    rng = np.random.default_rng(used)
    avail = np.ones(B, np.int32)
    avail[rng.permutation(B)[:used]] = 0
    sentinel = np.float32(123.0)

    init_j, step_j = make_streaming_pallas_step(pdc, "AWGN", dec, B, chunk_iters=4,
                                                max_frames=0, interpret=True, batch_tile=B)
    st_j = init_j()
    st_j = st_j._replace(avail8=st_j.avail8.at[0].set(jnp.asarray(avail)),
                         fresh_llr=jnp.full_like(st_j.fresh_llr, sentinel))
    st_j, _ = step_j(st_j, jax.random.PRNGKey(9), np.float32(1.0), jnp.asarray(refill))
    replaced_j = (np.asarray(st_j.fresh_llr) != sentinel).any(0)

    init_fn, step_fn = make_streaming_fused_step(tables, "AWGN", dec, B, chunk_iters=4,
                                                 max_frames=0)
    st = init_fn()
    st.avail.copy_(torch.from_numpy(avail))
    st.fresh_llr.fill_(float(sentinel))
    st, _ = step_fn(st, channel.make_generator("cpu", 9), 1.0, refill)
    replaced = (st.fresh_llr != float(sentinel)).any(0).numpy()

    np.testing.assert_array_equal(replaced, replaced_j)
    np.testing.assert_array_equal(st.avail.numpy(), np.asarray(st_j.avail8)[0])
    assert replaced.sum() == (used if refill and used >= pr.pool_watermark(B) else 0)


def _z(a, b):
    """|mean(a) - mean(b)| over their standard errors."""
    se = np.sqrt(a.var() / a.size + b.var() / b.size)
    return abs(a.mean() - b.mean()) / max(se, 1e-12)


@pytest.mark.parametrize("ch,x", [("AWGN", 2.0), ("AWGN-4ASK", 7.5), ("BSC", 0.05),
                                  ("BEC", 0.4)])
def test_pool_statistics_match_jax_channel(setup, ch, x):
    """A pool filled by the step's refill (from empty, refill on) against one
    JAX ``simulate_channel`` batch of the same size: codeword bit balance;
    BPSK the LLR's mean ``2/sigma^2`` and variance ``4/sigma^2`` (signed by
    the bit); the BSC's flip and the BEC's erasure shares; 4-ASK each
    label bit's mean LLR, signed by the bit.  Each within 5 standard
    errors, and BPSK's moments within 5 % of their values."""
    code, pdc, tables = setup
    B = 4096
    sdc, jsdc = tables.code, pdc.sorted_dc
    channel_type = ch.split("-")[0]
    modulation = jmodulation = None
    tx = sdc.bit_pos.numpy()
    if ch == "AWGN-4ASK":
        mapper = sdc.bit_pos.reshape(-1, 2).T.contiguous()
        modulation = (mod.Constellation.mask(4, GRAY4), mapper)
        jmodulation = (jmod.Constellation.mask(4, np.array(GRAY4)), jnp.asarray(mapper.numpy()))
    pt = pr.pool_tables(sdc, channel_type, modulation)
    vals = torch.uint8 if channel_type == "BEC" else torch.float32
    fresh = torch.zeros((sdc.nc, B), dtype=vals)
    fresh_cw = torch.zeros((sdc.nc, B), dtype=torch.uint8)
    avail = torch.zeros(B, dtype=torch.int32)
    pr.pool_refill(pt, channel.make_generator("cpu", 21), x, torch.ones(1, dtype=torch.int32),
                   avail, fresh, fresh_cw, torch.zeros((5, B), dtype=torch.int32),
                   torch.zeros(1, dtype=torch.int64), 10**6, torch.zeros(1, dtype=torch.int32))
    assert avail.tolist() == [1] * B
    out_j = jchannel.simulate_channel(jsdc, channel_type, jax.random.PRNGKey(21), B,
                                      jnp.float32(x), modulation=jmodulation)
    port = (fresh.numpy().astype(np.float64), fresh_cw.numpy())
    ref = (np.asarray(out_j.llr).astype(np.float64), np.asarray(out_j.codeword).astype(np.uint8))
    assert _z(port[1][tx].ravel(), ref[1][tx].ravel()) < 5
    for values, cw in (port, ref):
        assert abs(cw[tx].mean() - 0.5) < 5 * 0.5 / np.sqrt(cw[tx].size)
    if ch == "AWGN":
        s2 = 10 ** (-x / 10)
        signed = [v[tx] * (1 - 2.0 * c[tx]) for v, c in (port, ref)]
        assert _z(signed[0].ravel(), signed[1].ravel()) < 5
        for s in signed:
            assert abs(s.mean() - 2 / s2) < 0.05 * 2 / s2
            assert abs(s.var() - 4 / s2) < 0.05 * 4 / s2
    elif ch == "BSC":
        flips = [((v[tx] < 0) != (c[tx] != 0)).astype(np.float64).ravel() for v, c in (port, ref)]
        assert _z(*flips) < 5 and abs(flips[0].mean() - x) < 5 * np.sqrt(x * (1 - x) / flips[0].size)
    elif ch == "BEC":
        erased = [(v[tx] == channel.BEC_ERASURE).astype(np.float64).ravel() for v, _ in (port, ref)]
        assert _z(*erased) < 5 and abs(erased[0].mean() - x) < 5 * np.sqrt(x * (1 - x) / erased[0].size)
    else:
        mapper = modulation[1].numpy()
        for k in range(2):
            pos = mapper[k]
            got, want = ((v[pos] * (1 - 2.0 * c[pos])).ravel() for v, c in (port, ref))
            assert _z(got, want) < 5


def test_packed_columns_encode_like_g(setup):
    """The kernel's encode, ``c_v = parity(u & column_v)`` on the packed
    columns, equals ``u G mod 2`` (NumPy, the sorted labels)."""
    _, _, tables = setup
    G = tables.code.G.numpy()
    kc, nc = G.shape
    rng = np.random.default_rng(4)
    u = rng.integers(0, 2, size=(kc, 50))
    cols = pr.pack_columns(G).astype(np.uint64)  # [nc, kw]
    assert cols.shape[1] % 4 == 0 and cols.shape[1] * 32 >= kc  # 16-byte rows
    assert not cols[:, -(-kc // 32):].any()  # the padding words are 0
    words = np.zeros((cols.shape[1], 50), np.uint64)
    for i in range(kc):
        words[i // 32] |= u[i].astype(np.uint64) << np.uint64(i % 32)
    got = np.zeros((nc, 50), np.int64)
    for v in range(nc):
        x = np.bitwise_xor.reduce(cols[v][:, None] & words, axis=0)
        got[v] = np.array([bin(int(w)).count("1") & 1 for w in x])
    np.testing.assert_array_equal(got, (G.T.astype(np.int64) @ u) % 2)


def _emulate(pt, c, draws, x_value):
    """K8's value formulas on its tables, in NumPy: each item's values at
    its destinations, the constants at the other positions."""
    sdc = pt.code
    nc, B = c.shape
    src, dst = pt.item_src.numpy(), pt.item_dst.numpy()
    bec = pt.channel_type == "BEC"
    out = np.full((nc, B), -77, np.int64 if bec else np.float64)
    s2 = np.float32(10.0 ** (-x_value / 10.0))
    sigma = np.float32(np.sqrt(s2))
    for t in range(src.shape[0]):
        bits = c[src[t]]  # [bpi, B]
        r = draws[t].astype(np.float32)
        if pt.modulation is not None:
            cstl, _ = pt.modulation
            label = (bits * (2 ** np.arange(bits.shape[0] - 1, -1, -1))[:, None]).sum(0)
            y = pt.points.numpy()[pt.point_of.numpy()[label]] + r * sigma
            w = (-(y[None] - pt.points.numpy()[:, None]) ** 2 / (2 * s2)
                 + pt.logp.numpy()[:, None])
            for k, v in enumerate(dst[t]):
                if v < 0:
                    continue
                one = ((pt.label_of.numpy() >> (bits.shape[0] - 1 - k)) & 1) == 1
                l0 = np.logaddexp.reduce(w[~one], axis=0)
                l1 = np.logaddexp.reduce(w[one], axis=0)
                out[v] = np.clip(l0 - l1, -9999.9, 9999.9)
        elif pt.channel_type == "AWGN":
            out[dst[t, 0]] = 2 * ((1 - 2.0 * bits[0]) + r * sigma) / s2
        elif pt.channel_type == "BSC":
            delta = np.float32(np.log((1 - x_value) / x_value))
            out[dst[t, 0]] = delta * (1 - 2.0 * (bits[0] ^ (r < np.float32(x_value))))
        else:
            out[dst[t, 0]] = np.where(r < np.float32(x_value), channel.BEC_ERASURE, bits[0])
    short = pt.other_short.numpy().astype(bool)
    for v, sh in zip(pt.other_pos.numpy(), short):
        if bec:
            out[v] = c[v] if sh else channel.BEC_ERASURE
        elif pt.channel_type == "BSC":
            out[v] = np.float32(np.log((1 - x_value) / x_value)) if sh else 0.0
        else:
            out[v] = np.float32(SHORTEN_LLR) if sh else 0.0
    assert not (out == -77).any(), "a position no item or other writes"
    return out


@pytest.mark.parametrize("ch,x", [("AWGN", 2.0), ("AWGN-4ASK", 7.5), ("BSC", 0.05),
                                  ("BEC", 0.4)])
def test_tables_give_the_plain_channel_values(setup, ch, x):
    """On a code with shortened and punctured bits (4-ASK: a mapper that
    names a shortened bit and one position twice), the kernel's formulas on
    its tables give :func:`channel_values` on the same codewords and draws:
    BSC and BEC exactly, AWGN to float32 rounding."""
    code, _, _ = setup
    jcode = dataclasses.replace(code, puncture=np.array([5, 9], np.int32),
                                shorten=np.array([0, 17], np.int32))
    sdc = to_sorted_device(code_from_jax(jcode), "cpu")
    channel_type = ch.split("-")[0]
    modulation = None
    B = 64
    if ch == "AWGN-4ASK":
        mapper = torch.cat([sdc.shorten[:1], sdc.bit_pos[: sdc.nct // 2 * 2 - 1]])
        mapper = mapper.reshape(-1, 2).T.contiguous()
        mapper[1, -1] = mapper[1, 0]  # one position named twice: the later entry writes it
        modulation = (mod.Constellation.mask(4, GRAY4), mapper)
    pt = pr.pool_tables(sdc, channel_type, modulation)
    rng = np.random.default_rng(11)
    G = sdc.G.numpy().astype(np.int64)
    c = ((G.T @ rng.integers(0, 2, size=(G.shape[0], B))) % 2).astype(np.uint8)
    n_items = pt.item_src.shape[0]
    draws = (rng.standard_normal((n_items, B)) if channel_type == "AWGN"
             else rng.random((n_items, B))).astype(np.float32)
    want = channel.channel_values(sdc, channel_type, torch.from_numpy(c),
                                  torch.from_numpy(draws), x, modulation).numpy()
    got = _emulate(pt, c, draws, x)
    if channel_type == "AWGN":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        np.testing.assert_array_equal(got, want)
    if ch == "AWGN-4ASK":
        assert (want[sdc.shorten.numpy()] == np.float32(SHORTEN_LLR)).all()
