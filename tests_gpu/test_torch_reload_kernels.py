"""Card tests of K8's reload form (``csrc/pool_refill.cu``
``reload_plan_kernel`` and the reload draw) and of the XLA streaming
super-step on the card (a one-pass K2 launch, then the reload), and of the
padded decoders on K1, K5 and K6.

* The reload against its plain version (``stream_reload_plain`` drawing K8's
  full batch on the same key, whose lane ``b`` is the reload's lane ``b``),
  for BPSK, 4-ASK and the BSC on the 1152 (3,6) code at B = 16384: the
  granted lanes (the first idle ones in lane order, within the quota), their
  LLRs, codewords, first messages (each edge's prior), ``done``/``age``/
  ``iters`` and ``started`` bit-equal, every other lane untouched; a binding
  quota; ``do_gen`` false (too few idle lanes, or no refill) draws nothing.
* The staged reload (``stream_reload(..., stage=)``) against its plain
  version at 1,536 granted lanes on the 1152 code and wifi 1944: ``slot``,
  the staged columns, ``done``/``age``/``iters`` and ``started`` bit-equal,
  the planes untouched; a staged column equal to the lane's column of the
  reload into the state on the same key.  Then K2's one-pass launch with
  those pending starts against the plain chunk (``BP_MS``, every plane, the
  counters, ``slot`` back to -1), in the form the size rule picks and in
  the HBM-plane form, and against the sequence it replaces (a reload into
  the state, then K2 with no starts): the same state, bit for bit.
* The card's super-step (``_card_superstep``: the launches) against the
  plain super-step on the card (``_superstep_body``, selected by replacing
  ``streaming._runs_kernels``, its draws K8's full batch on each pass's
  key) over several super-steps, ``BP_MS``: deltas and every plane
  bit-equal, ``lv2c`` on the lanes in flight.
* ``bp_decode`` (flooding on K1, layered on K5) and ``bec_decode`` (K6) on a
  CUDA ``DeviceCode`` against the plain padded decoders on the same card.
"""

import pytest
import torch

from libldpc_tpu_torch.models import make_benchmark_code, wifi_code
from libldpc_tpu_torch.ops import bec as pbec
from libldpc_tpu_torch.ops import channel
from libldpc_tpu_torch.ops import decoder as pdec
from libldpc_tpu_torch.ops import modulation as mod
from libldpc_tpu_torch.ops import streaming
from libldpc_tpu_torch.ops.device import to_device
from libldpc_tpu_torch.ops.kernels import decode_bec as db
from libldpc_tpu_torch.ops.kernels import decode_fused as df
from libldpc_tpu_torch.ops.kernels import decode_layered as dl
from libldpc_tpu_torch.ops.kernels import pool_refill as pr
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.ops.sorted import to_sorted_device
from libldpc_tpu_torch.sim.driver import DecoderParams

pytestmark = pytest.mark.cuda

B = 16384
CHANNELS = {"BPSK": ("AWGN", 2.0), "4-ASK": ("AWGN", 7.5), "BSC": ("BSC", 0.05)}


@pytest.fixture(scope="module")
def bench_tables():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return kernel_tables(to_sorted_device(make_benchmark_code(1152, 3, 6, seed=0, with_G=True),
                                          "cuda"))


def pool_of(tables, kind):
    sdc = tables.code
    channel_type, x = CHANNELS[kind]
    modulation = None
    if kind == "4-ASK":
        modulation = (mod.Constellation.mask(4, [0, 1, 3, 2]),
                      sdc.bit_pos[: sdc.nct // 2 * 2].reshape(-1, 2).T.contiguous())
    return pr.pool_tables(sdc, channel_type, modulation), x


def state(tables, idle: int, seed: int = 0):
    """Sentinel planes with ``idle`` random lanes idle."""
    sdc, dev = tables.code, tables.device
    g = torch.Generator(device="cpu").manual_seed(seed)
    done = torch.zeros(B, dtype=torch.int32)
    done[torch.randperm(B, generator=g)[:idle]] = 1
    i32 = dict(dtype=torch.int32, device=dev)
    return dict(done=done.to(dev), llr=torch.full((sdc.nc, B), 123.0, device=dev),
                cw=torch.full((sdc.nc, B), 7, dtype=torch.uint8, device=dev),
                lv2c=torch.full((sdc.nnz, B), -5.0, device=dev),
                age=torch.full((B,), 9, **i32), iters=torch.full((B,), 4, **i32),
                started=torch.tensor([1000], **i32))


def reload(tables, pt, x, s, refill_on, quota, thr, key, plain):
    refill = torch.tensor([int(refill_on)], dtype=torch.int32, device=tables.device)
    planes = (refill, s["done"], s["llr"], s["cw"], s["lv2c"], s["age"], s["iters"],
              s["started"], quota, thr)
    if plain:
        pr.stream_reload_plain(pt, lambda: pr.channel_batch(pt, None, B, x, key=key), *planes)
    else:
        pr.stream_reload(pt, None, x, *planes, vn_ptr=tables.vn_ptr, perm_c2v=tables.perm_c2v,
                         key=key)


@pytest.mark.parametrize("kind", sorted(CHANNELS))
@pytest.mark.parametrize("idle,quota,thr,refill_on", [
    (1500, 10**6, 1024, True),  # the usual burst
    (1500, 1000 + 700, 1024, True),  # a binding quota: 700 of 1500 start
    (1000, 10**6, 1024, True),  # do_gen false: too few idle lanes
    (1500, 10**6, 1024, False),  # do_gen false: a drain
    (B, 10**6, 1, True),  # every lane idle
])
def test_reload_against_plain(bench_tables, kind, idle, quota, thr, refill_on):
    pt, x = pool_of(bench_tables, kind)
    key = torch.tensor([0x1234567 + idle], dtype=torch.int64, device="cuda")
    a, b = state(bench_tables, idle), state(bench_tables, idle)
    before = {k: v.clone() for k, v in a.items()}
    reload(bench_tables, pt, x, a, refill_on, quota, thr, key, plain=False)
    reload(bench_tables, pt, x, b, refill_on, quota, thr, key, plain=True)
    for name in a:
        assert torch.equal(a[name], b[name]), name
    granted = (before["done"] != 0) & (a["done"] == 0)
    want = min(idle, quota - 1000) if refill_on and idle >= thr else 0
    assert int(granted.sum()) == want and int(a["started"]) == 1000 + want
    if want:
        first = torch.nonzero(before["done"]).flatten()[:want]
        assert torch.equal(torch.nonzero(granted).flatten(), first)  # lane order
        assert bool((a["age"][granted] == 1).all()) and not a["iters"][granted].any()
        assert torch.isfinite(a["llr"][:, granted]).all()
        assert torch.equal(a["lv2c"][:, granted],
                           a["llr"][:, granted].index_select(0, bench_tables.col_sorted))
    for name in ("llr", "cw", "lv2c"):
        assert torch.equal(a[name][:, ~granted], before[name][:, ~granted]), name
    assert pr.stream_reload.launches > 0


@pytest.fixture(scope="module")
def wifi_tables():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return kernel_tables(to_sorted_device(wifi_code(1944, with_layers=False), "cuda"))


STAGED_IDLE = 1536


def staged_case(tables, pt, x, key, plain):
    """A state of ``STAGED_IDLE`` idle lanes (the rest in flight, on
    sentinel values) and the staged reload of them: ``(state, stage)``."""
    s = state(tables, STAGED_IDLE, seed=5)
    stage = pr.ReloadStage.empty(tables.code.nc, B, tables.device)
    refill = torch.ones(1, dtype=torch.int32, device=tables.device)
    planes = (refill, s["done"], s["llr"], s["cw"], s["lv2c"], s["age"], s["iters"],
              s["started"], 10**9, B // 16)
    if plain:
        pr.stream_reload_plain(pt, lambda: pr.channel_batch(pt, None, B, x, key=key), *planes,
                               stage=stage)
    else:
        pr.stream_reload(pt, None, x, *planes, key=key, stage=stage)
    return s, stage


@pytest.mark.parametrize("case", ["bench1152 BPSK", "bench1152 4-ASK", "bench1152 BSC",
                                  "wifi1944 BPSK"])
def test_staged_reload_against_plain(bench_tables, wifi_tables, case):
    name, kind = case.split()
    tables = bench_tables if name == "bench1152" else wifi_tables
    pt, x = pool_of(tables, kind)
    key = torch.tensor([0x5151 + len(case)], dtype=torch.int64, device="cuda")
    n = pr.stream_reload.staged_launches
    (a, sa), (b, sb) = (staged_case(tables, pt, x, key, plain) for plain in (False, True))
    assert pr.stream_reload.staged_launches == n + 1
    before = state(tables, STAGED_IDLE, seed=5)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    granted = torch.nonzero(before["done"]).flatten()
    assert torch.equal(sa.slot, sb.slot)
    assert torch.equal(sa.slot[granted], torch.arange(STAGED_IDLE, dtype=torch.int32,
                                                      device="cuda"))
    assert int((sa.slot >= 0).sum()) == STAGED_IDLE and int(a["started"]) == 1000 + STAGED_IDLE
    assert torch.equal(sa.llr[:, :STAGED_IDLE], sb.llr[:, :STAGED_IDLE])
    assert torch.equal(sa.cw[:, :STAGED_IDLE], sb.cw[:, :STAGED_IDLE])
    for k in ("llr", "cw", "lv2c"):  # nothing written into the planes
        assert torch.equal(a[k], before[k]), k
    assert not a["done"][granted].any() and bool((a["age"][granted] == 1).all())
    # the same frames as the reload into the state on the same key
    c = state(tables, STAGED_IDLE, seed=5)
    reload(tables, pt, x, c, True, 10**9, B // 16, key, plain=False)
    assert torch.equal(sa.llr[:, :STAGED_IDLE], c["llr"][:, granted])
    assert torch.equal(sa.cw[:, :STAGED_IDLE], c["cw"][:, granted])


def _k2_state(tables, seed):
    """Every lane in flight after one pass, from a channel batch: the state
    a one-pass launch of the XLA super-step sees."""
    sdc, dev = tables.code, tables.device
    i32 = dict(dtype=torch.int32, device=dev)
    ch = channel.awgn_channel(sdc, channel.make_generator(dev, seed), B, 1.5)
    st = dict(llr=ch.llr.clone(), cw=ch.codeword.clone(),
              lv2c=ch.llr.index_select(0, sdc.col_sorted).contiguous(),
              done=torch.zeros(B, **i32), iters=torch.zeros(B, **i32), age=torch.ones(B, **i32),
              avail=torch.zeros(B, **i32), ctr=torch.zeros((5, B), **i32))
    one_pass(tables, st, None, plain=False)
    return st


def one_pass(tables, st, stage, plain):
    zero = torch.zeros(1, dtype=torch.int32, device=tables.device)
    fn = df.bp_stream_chunk_fused_plain if plain else df.bp_stream_chunk_fused
    fn(tables, st["llr"], st["cw"], st["lv2c"], st["done"], st["iters"], st["age"], st["avail"],
       st["ctr"], st["llr"], st["cw"], zero, zero.clone(), k=1, cap=50, minsum_mode="BP_MS",
       stage=stage)


@pytest.mark.parametrize("hbm", [False, True])
@pytest.mark.parametrize("name", ["bench1152", "wifi1944"])
def test_k2_staged_start_against_plain(bench_tables, wifi_tables, name, hbm, monkeypatch):
    tables = bench_tables if name == "bench1152" else wifi_tables
    if hbm:
        monkeypatch.setattr(df, "STREAM_FORM_OVERRIDE", (0, False))
    pt, x = pool_of(tables, "BPSK")
    key = torch.tensor([777], dtype=torch.int64, device="cuda")
    base = _k2_state(tables, 21)
    g = torch.Generator(device="cpu").manual_seed(8)
    idle = torch.randperm(B, generator=g)[:STAGED_IDLE].to("cuda")
    base["done"].zero_()  # every other lane in flight
    base["done"][idle] = 1
    i32 = dict(dtype=torch.int32, device="cuda")
    refill = torch.ones(1, **i32)
    runs = []
    for staged, plain in ((True, False), (True, True), (False, False)):
        st = {k: v.clone() for k, v in base.items()}
        started = torch.zeros(1, **i32)
        stage = pr.ReloadStage.empty(tables.code.nc, B, "cuda")
        planes = (refill, st["done"], st["llr"], st["cw"], st["lv2c"], st["age"], st["iters"],
                  started, 10**9, B // 16)
        if staged:
            pr.stream_reload(pt, None, x, *planes, key=key, stage=stage)
        else:
            pr.stream_reload(pt, None, x, *planes, vn_ptr=tables.vn_ptr,
                             perm_c2v=tables.perm_c2v, key=key)
        assert int(started) == STAGED_IDLE
        n = df.bp_stream_chunk_fused.staged_launches
        one_pass(tables, st, stage if staged else None, plain)
        if staged and not plain:
            assert df.bp_stream_chunk_fused.staged_launches == n + 1
            assert df.bp_stream_chunk_fused.last_form[0] == (0 if hbm else
                                                             df.flood_form(tables)[0])
        assert not bool((stage.slot >= 0).any())
        runs.append(st)
    kernel, plain_run, present = runs
    for ref in (plain_run, present):  # every lane ran the pass, so lv2c is whole
        for k in ("llr", "cw", "lv2c", "done", "iters", "age", "avail", "ctr"):
            assert torch.equal(kernel[k], ref[k]), k
    assert int(kernel["ctr"][4].sum()) == 0  # the plan counted the starts, not K2


@pytest.mark.parametrize("form", ["BP_MS", "BP"])
def test_superstep_on_the_card_against_its_plain_sequence(bench_tables, form, monkeypatch):
    dec = DecoderParams(iterations=50, type=form)
    monkeypatch.setattr(pr.stream_reload, "launches", 0)
    monkeypatch.setattr(pr.stream_reload, "staged_launches", 0)
    runs = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(streaming, "_runs_kernels", lambda device: False)
        init, step = streaming.make_streaming_step(bench_tables, "AWGN", dec, B,
                                                   max_frames=60000)
        st = init()
        deltas = []
        for s in range(12):
            st, acc = step(st, channel.make_generator("cuda", 3, s), 1.5, s < 8)
            deltas.append([int(v) for v in acc])
        runs.append((st, deltas))
    (ka, kd), (pa, pd) = runs
    if form == "BP_MS":
        assert kd == pd
        for name in ("llr_in", "codeword", "active", "age", "iters", "started"):
            assert torch.equal(getattr(ka, name), getattr(pa, name)), name
        act = ka.active
        assert torch.equal(ka.lv2c[:, act], pa.lv2c[:, act])
    else:
        assert abs(sum(d[2] for d in kd) - sum(d[2] for d in pd)) <= B // 1000
    assert sum(d[2] for d in kd) > B
    # 49 of a super-step's 50 reloads were staged (the last one's into the
    # state, so none is left pending)
    assert (pr.stream_reload.launches, pr.stream_reload.staged_launches) == (12, 12 * 49)


@pytest.fixture(scope="module")
def device_codes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return {"wifi648": to_device(wifi_code(648), with_layers=True),
            "bench1152": to_device(make_benchmark_code(1152, 3, 6, seed=0, with_G=True))}


@pytest.mark.parametrize("name,layered", [("bench1152", False), ("wifi648", False),
                                          ("wifi648", True)])
@pytest.mark.parametrize("mode", ["BP_MS", ("BP_NMS", 0.75, 0.0), "BP"])
def test_padded_bp_decode_on_the_card(device_codes, name, layered, mode):
    dc = device_codes[name]
    g = channel.make_generator("cuda", 9)
    llr = channel.awgn_channel(dc, g, 2048, 1.5).llr
    k1, k5 = df.bp_decode_fused.launches["float32"], dl.bp_decode_layered.launches["float32"]
    got = pdec.bp_decode(dc, llr, iterations=20, minsum_mode=mode, layered=layered)
    assert (dl.bp_decode_layered.launches["float32"] - k5, df.bp_decode_fused.launches[
        "float32"] - k1) == ((1, 0) if layered else (0, 1))
    want = pdec.bp_decode_plain(dc, llr, iterations=20, minsum_mode=mode, layered=layered)
    same = (got.hard == want.hard).all(0) & (got.iterations == want.iterations)
    if mode == "BP":
        assert same.float().mean() >= 0.999
        torch.testing.assert_close(got.llr_out[:, same], want.llr_out[:, same], rtol=1e-4,
                                   atol=1e-4)
    else:
        assert bool(same.all()) and torch.equal(got.is_codeword, want.is_codeword)
        assert torch.equal(got.llr_out, want.llr_out)


@pytest.mark.parametrize("stale", [None, 0])
def test_padded_bec_decode_on_the_card(device_codes, stale):
    dc = device_codes["bench1152"]
    ch = channel.bec_channel(dc, channel.make_generator("cuda", 4), 4096, 0.40)
    n = db.bec_decode_fused.launches
    got = pbec.bec_decode(dc, ch.llr, ch.codeword, iterations=50, degree1_stale_byte=stale)
    assert db.bec_decode_fused.launches == n + 1
    want = pbec.bec_decode_plain(dc, ch.llr, ch.codeword, iterations=50,
                                 degree1_stale_byte=stale)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
