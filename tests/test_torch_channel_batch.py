"""K8's full-batch entry (``channel_batch``), its tables and the lane-order
scans' plain versions, on the CPU against the plain channel and the JAX
package.

* ``channel_batch`` on the CPU is ``simulate_channel`` from the same
  generator, bit for bit, for AWGN, 4-ASK, BSC and the BEC, with punctured
  and shortened positions and without a generator; its statistics agree
  with the JAX ``simulate_channel``'s within 5 standard errors.
* The batch step (``_sim_and_count``) draws through ``channel_batch`` for
  every schedule and the BEC, kernels or plain versions.
* The generator tiles the draw reads (``g_tiles``), read as ``mma.m16n8k256``
  b1 B fragments, give ``u G mod 2`` on the 1152 (3,6) code and wifi 1944.
* The plan's lane list (plain version) is ``nonzero(avail == 0)`` in order;
  ``stream_grant_plain`` grants as a lane-by-lane loop on odd batch sizes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libldpc_tpu.models import make_benchmark_code as jax_benchmark_code
from libldpc_tpu.ops import channel as jchannel
from libldpc_tpu.ops import modulation as jmod
from libldpc_tpu.ops.pallas.layout import to_pallas_device
from libldpc_tpu_torch.convert import code_from_jax
from libldpc_tpu_torch.models import make_benchmark_code, make_regular_code, wifi_code
from libldpc_tpu_torch.ops import channel, modulation as mod
from libldpc_tpu_torch.ops.kernels import decode_fused as df
from libldpc_tpu_torch.ops.kernels import pool_refill as pr
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.ops.sorted import to_sorted_device
from libldpc_tpu_torch.parallel import mesh
from libldpc_tpu_torch.sim.driver import DecoderParams

torch.set_num_threads(2)
GRAY4 = [0, 1, 3, 2]
CHANNELS = [("AWGN", 2.0), ("AWGN-4ASK", 7.5), ("BSC", 0.05), ("BEC", 0.4)]


def _modulation(sdc, ch):
    if ch != "AWGN-4ASK":
        return None
    mapper = sdc.bit_pos[: sdc.nct // 2 * 2].reshape(-1, 2).T.contiguous()
    return mod.Constellation.mask(4, GRAY4), mapper


@pytest.mark.parametrize("with_g", [True, False])
@pytest.mark.parametrize("ch,x", CHANNELS)
def test_channel_batch_is_simulate_channel_on_cpu(ch, x, with_g):
    code = (make_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True) if with_g
            else make_regular_code(96, 3, 6, seed=2))
    code = dataclasses.replace(code, puncture=np.array([5, 9], np.int32),
                               shorten=np.array([0, 17], np.int32))
    sdc = to_sorted_device(code, "cpu")
    channel_type = ch.split("-")[0]
    modulation = _modulation(sdc, ch)
    pt = pr.pool_tables(sdc, channel_type, modulation)
    assert (pt.gtiles is None) != with_g
    got = pr.channel_batch(pt, channel.make_generator("cpu", 3, 1), 64, x)
    want = channel.simulate_channel(sdc, channel_type, channel.make_generator("cpu", 3, 1), 64, x,
                                    modulation)
    assert torch.equal(got.llr, want.llr) and torch.equal(got.codeword, want.codeword)
    assert got.llr.dtype == (torch.uint8 if channel_type == "BEC" else torch.float32)
    if not with_g:
        assert not bool(got.codeword.any())


def _z(a, b):
    se = np.sqrt(a.var() / a.size + b.var() / b.size)
    return abs(a.mean() - b.mean()) / max(se, 1e-12)


@pytest.mark.parametrize("ch,x", CHANNELS)
def test_channel_batch_statistics_match_jax(ch, x):
    """Mean signed LLR (BPSK; 4-ASK per label bit), flip share (BSC) and
    erasure share (BEC) of one batch against one JAX ``simulate_channel``
    batch of the same code, each within 5 standard errors."""
    jcode = jax_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True)
    jsdc = to_pallas_device(jcode).sorted_dc
    sdc = to_sorted_device(code_from_jax(jcode), "cpu")
    channel_type = ch.split("-")[0]
    modulation = _modulation(sdc, ch)
    jmodulation = None if modulation is None else (
        jmod.Constellation.mask(4, np.array(GRAY4)), jnp.asarray(modulation[1].numpy()))
    B = 4096
    out = pr.channel_batch(pr.pool_tables(sdc, channel_type, modulation),
                           channel.make_generator("cpu", 8), B, x)
    out_j = jchannel.simulate_channel(jsdc, channel_type, jax.random.PRNGKey(8), B,
                                      jnp.float32(x), modulation=jmodulation)
    port = (out.llr.numpy().astype(np.float64), out.codeword.numpy())
    ref = (np.asarray(out_j.llr).astype(np.float64), np.asarray(out_j.codeword).astype(np.uint8))
    tx = sdc.bit_pos.numpy()
    if channel_type == "BEC":
        stats = [(v[tx] == channel.BEC_ERASURE).astype(np.float64).ravel() for v, _ in (port, ref)]
    elif channel_type == "BSC":
        stats = [((v[tx] < 0) != (c[tx] != 0)).astype(np.float64).ravel() for v, c in (port, ref)]
    elif modulation is None:
        stats = [(v[tx] * (1 - 2.0 * c[tx])).ravel() for v, c in (port, ref)]
    else:
        for k in range(2):
            pos = modulation[1].numpy()[k]
            assert _z(*[(v[pos] * (1 - 2.0 * c[pos])).ravel() for v, c in (port, ref)]) < 5
        stats = [c[tx].astype(np.float64).ravel() for _, c in (port, ref)]
    assert _z(*stats) < 5


@pytest.mark.parametrize("case", ["flooding", "layered", "layered-fast", "BEC"])
@pytest.mark.parametrize("plain", [False, True])
def test_batch_step_draws_through_channel_batch(monkeypatch, case, plain):
    """A spy on ``channel_batch``: every batch step draws its channel there,
    once, with the step's pool tables and batch."""
    calls = []
    draw = mesh.channel_batch

    def spy(pt, gen, batch, x_value, **kw):
        calls.append((pt.channel_type, batch, x_value))
        return draw(pt, gen, batch, x_value, **kw)

    monkeypatch.setattr(mesh, "channel_batch", spy)
    code = wifi_code(648) if case.startswith("layered") else make_benchmark_code(
        96, dv=3, dc=6, seed=7, with_G=True)
    tables = kernel_tables(to_sorted_device(code, "cpu", with_layers=True))
    channel_type, x = ("BEC", 0.3) if case == "BEC" else ("AWGN", 2.0)
    schedule = "flooding" if case == "BEC" else case
    dec = DecoderParams(iterations=3, type="BP_MS", layered=case.startswith("layered"))
    step = mesh.make_sim_step(tables, channel_type, dec, 8, schedule, plain=plain)
    for i in range(2):
        counters = step(channel.make_generator("cpu", 5, i), x)
        assert int(counters.frames) == 8
    assert calls == [(channel_type, 8, x)] * 2


def _fragment_b(tiles_js: np.ndarray) -> np.ndarray:
    """The 256 x 8 bit B matrix of one (n-tile, k-step) from its 32
    threads' two words, by the mma.m16n8k256 b1 layout: thread l = 4 g + t
    holds B[32 t + i, g] (bit i of its first word) and B[128 + 32 t + i,
    g] (of its second)."""
    b = np.zeros((256, 8), np.int64)
    words = tiles_js.astype(np.uint32)
    bit = np.arange(32, dtype=np.uint32)
    for lane in range(32):
        g, t = divmod(lane, 4)
        b[32 * t:32 * t + 32, g] = (words[lane, 0] >> bit) & 1
        b[128 + 32 * t:160 + 32 * t, g] = (words[lane, 1] >> bit) & 1
    return b


@pytest.mark.parametrize("name", ["bench1152", "wifi1944"])
def test_g_tiles_encode_like_g(name):
    """Every column of the draw, slab by slab: an encoded column's bits from
    the tiles, popc(A AND B) summed k-step by k-step as the tensor cores
    sum it (A: 16 lanes' info bits), and a systematic column's info bit,
    equal ``u G mod 2`` at its position; the 4-ASK column order too."""
    code = (make_benchmark_code(1152, 3, 6, seed=0, with_G=True) if name == "bench1152"
            else wifi_code(1944))
    sdc = to_sorted_device(code, "cpu")
    G = sdc.G.numpy().astype(np.int64)
    kc = G.shape[0]
    rng = np.random.default_rng(1)
    u = rng.integers(0, 2, size=(16, kc))  # one m-tile of lanes
    want = (u @ G) % 2  # [16, nc]
    for modulation in (None, _modulation(sdc, "AWGN-4ASK")):
        pt = pr.pool_tables(sdc, "AWGN", modulation)
        tiles, tile0, col_src = (t.numpy() for t in (pt.gtiles, pt.slab_tile0, pt.col_src))
        n_items, bpi = pt.item_src.shape
        assert tiles.shape[1] == pt.ksteps == -(-kc // 256) and pt.kwords == -(-kc // 32)
        assert pt.kw == -(-kc // 128) * 4 and pt.other_col0 == n_items * bpi
        pos = np.concatenate([pt.item_src.numpy().reshape(-1), pt.other_pos.numpy()])
        assert (col_src < 0).sum() == kc  # a systematic G: kc unit columns
        a = np.zeros((16, 256 * pt.ksteps), np.int64)
        a[:, :kc] = u
        n_slabs = len(tile0) - 1
        assert n_slabs == -(-n_items // pt.items_per_slab)
        for y in range(n_slabs):
            c0, c1 = y * pt.items_per_slab * bpi, min(n_items, (y + 1) * pt.items_per_slab) * bpi
            bits = np.zeros((16, 8 * (tile0[y + 1] - tile0[y])), np.int64)
            for j in range(tile0[y], tile0[y + 1]):
                acc = sum(a[:, 256 * s:256 * s + 256] @ _fragment_b(tiles[j, s])
                          for s in range(pt.ksteps))
                bits[:, 8 * (j - tile0[y]):8 * (j - tile0[y] + 1)] = acc % 2
            assert 8 * (tile0[y + 1] - tile0[y]) <= pt.slab_cols
            for c in range(c0, c1):
                got = bits[:, col_src[c]] if col_src[c] >= 0 else u[:, -1 - col_src[c]]
                np.testing.assert_array_equal(got, want[:, pos[c]])


@pytest.mark.parametrize("batch", [33, 1000, 16384])
def test_plan_lanes_are_nonzero_in_order(batch):
    rng = np.random.default_rng(batch)
    avail = torch.from_numpy((rng.random(batch) < 0.15).astype(np.int32))  # 85 % used
    ctr = torch.from_numpy(rng.integers(0, 3, (5, batch)).astype(np.int32))
    started = torch.tensor([11], dtype=torch.int64)
    for refill in (1, 0):
        rem = torch.zeros(1, dtype=torch.int32)
        ctl, lanes = pr.pool_plan(torch.tensor([refill], dtype=torch.int32), avail, ctr, started,
                                  10**6, rem)
        used = torch.nonzero(avail == 0).flatten()
        do_gen = refill == 1 and used.numel() >= pr.pool_watermark(batch)
        assert ctl.tolist() == [int(do_gen), used.numel() if do_gen else 0]
        assert torch.equal(lanes[:int(ctl[1])].long(), used[:int(ctl[1])])
        assert int(rem) == 10**6 - 11 - int(ctr[4].sum())


@pytest.mark.parametrize("batch", [33, 1000, 16385])
@pytest.mark.parametrize("quota", [0, 7, 300, 10**6])
def test_stream_grant_plain_on_odd_batches(batch, quota):
    rng = np.random.default_rng(batch + quota)
    done = (rng.random(batch) < 0.5).astype(np.int32)
    avail = (rng.random(batch) < 0.7).astype(np.int32)
    rem = torch.tensor([quota], dtype=torch.int32)
    got = df.stream_grant(torch.from_numpy(done), torch.from_numpy(avail),
                          torch.ones(1, dtype=torch.int32), rem)
    want, left = np.zeros(batch, np.uint8), quota
    for i in range(batch):  # lane by lane, in order
        if done[i] and avail[i] and left > 0:
            want[i], left = 1, left - 1
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(rem) == left


def test_draw_tiling_fits_a_block():
    """The slab and then the lane tile fall from SLAB_COLS and LANE_TILE only
    where a block's shared memory needs it: the 1152 code and wifi 1944 keep
    both; a large kc gives up the slab first."""
    for code in (make_benchmark_code(1152, 3, 6, seed=0, with_G=True), wifi_code(1944)):
        pt = pr.pool_tables(to_sorted_device(code, "cpu"), "AWGN")
        assert (pt.lane_tile, pt.items_per_slab, pt.others_per_slab) == (
            pr.LANE_TILE, pr.SLAB_COLS, pr.SLAB_COLS)
        assert pr.draw_bytes(pt) <= df.SMEM_BLOCK_BYTES
    big_ks, slab = 20, 144
    assert pr._draw_bytes(big_ks, True, pr.LANE_TILE, 2 * slab) > df.SMEM_BLOCK_BYTES
    assert pr._draw_bytes(big_ks, True, pr.LANE_TILE, slab) <= df.SMEM_BLOCK_BYTES


def test_draw_slabs_cover_every_column():
    """Each column of the draw is encoded in its own slab or systematic; a
    slab's encoded columns are padded to tiles of 8; no G: no encode."""
    G = np.zeros((4, 12), np.int64)
    G[np.arange(4), [0, 3, 5, 9]] = 1  # unit columns 0, 3, 5, 9
    G[:, [1, 2, 4, 6, 7, 8, 10, 11]] = np.random.default_rng(2).integers(0, 2, (4, 8)) | 1
    item_src = np.arange(10)[:, None]
    cols, tile0, col_src, slab_cols = pr.draw_slabs(G, item_src, np.array([10, 11]), 8, 8)
    assert tile0.tolist() == [0, 1, 2, 3] and slab_cols == 8
    assert col_src[[0, 3, 5, 9]].tolist() == [-1, -2, -3, -4]
    assert col_src[[1, 2, 4, 6, 7]].tolist() == [0, 1, 2, 3, 4]  # slab 0: items 0..7
    assert cols[:8].tolist() == [1, 2, 4, 6, 7, -1, -1, -1]
    assert cols[8:16].tolist() == [8] + [-1] * 7  # slab 1: items 8, 9
    assert cols[16:].tolist() == [10, 11] + [-1] * 6  # slab 2: the other positions
    assert col_src[[8, 10, 11]].tolist() == [0, 0, 1]
    assert pr.draw_slabs(None, item_src, np.array([10, 11]), 8, 8) == (None, None, None, 0)
