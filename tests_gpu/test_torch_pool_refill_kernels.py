"""Card tests of K8 (the channel draw, ``csrc/pool_refill.cu``: the
streaming pool's refill and the full channel batch of a batch step) and of
the start grants in lane order of the streaming chunks K2, K4 and K7 in a
chunk where the quota binds.

* K8 against its plain version for each channel (BPSK, 4-ASK, BSC, BEC) on
  the 1152 (3,6) code and wifi 1944: which entries are taken, ``avail``
  after, the untouched entries and ``remaining`` bit-equal; every taken
  codeword satisfies ``H c = 0``; the plain formulas on K8's codewords and
  its drawn normals or uniforms (its debug plane) give K8's values bit for
  bit (4-ASK's logsumexps within 1e-5 relative); no entry moves when the
  watermark is not met or refill is off; the pool's statistics agree with
  the plain refill's within 5 standard errors; every drawn codeword is
  ``u G mod 2`` of the lane's info words (its ``debug_info`` plane).
* K8's full batch (``channel_batch``) the same way against
  ``simulate_channel``; the plan's lane list and the redesigned grant
  against their plain versions at B = 16384, 1000 and 33 (and on planes
  that are not 16-byte aligned); a batch step of K1, K5 and K6, drawn
  through ``channel_batch``, counts as its plain step on the same draws.
* A chunk under a binding quota, from the same state: K2 (its tile forms
  and its HBM-plane form, float32, bfloat16 and int8), K4 (each form) and K7
  (the word and the byte form), run ``ordered``, equal their plain chunks'
  planes and counters exactly in the min-sum family, starts granted pass by
  pass in lane order.
"""

import dataclasses

import pytest
import torch

from libldpc_tpu_torch.models import make_benchmark_code, wifi_code
from libldpc_tpu_torch.ops import channel
from libldpc_tpu_torch.ops import modulation as mod
from libldpc_tpu_torch.ops.kernels import decode_bec as db
from libldpc_tpu_torch.ops.kernels import decode_fused as df
from libldpc_tpu_torch.ops.kernels import decode_layered as dl
from libldpc_tpu_torch.ops.kernels import pool_refill as pr
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.ops.sorted import to_sorted_device
from libldpc_tpu_torch.ops.streaming_fused import init_state
from libldpc_tpu_torch.parallel.mesh import make_sim_step
from libldpc_tpu_torch.sim.driver import DecoderParams

pytestmark = pytest.mark.cuda

B = 16384
CODES = {"bench1152": lambda: make_benchmark_code(1152, 3, 6, seed=0, with_G=True),
         "wifi1944": lambda: wifi_code(1944), "wifi648": lambda: wifi_code(648)}
CHANNELS = {"BPSK": ("AWGN", 2.0), "4-ASK": ("AWGN", 7.5), "BSC": ("BSC", 0.05),
            "BEC": ("BEC", 0.40)}
GRAY4 = [0, 1, 3, 2]


@pytest.fixture(scope="module")
def built():
    return {}


@pytest.fixture
def tables_of(built, cuda_device):
    def get(name):
        if name not in built:
            built[name] = kernel_tables(to_sorted_device(CODES[name](), cuda_device,
                                                         with_layers=True))
        return built[name]

    return get


def pool_of(tables, kind):
    sdc = tables.code
    channel_type, x = CHANNELS[kind]
    modulation = None
    if kind == "4-ASK":
        modulation = (mod.Constellation.mask(4, GRAY4),
                      sdc.bit_pos[: sdc.nct // 2 * 2].reshape(-1, 2).T.contiguous())
    return pr.pool_tables(sdc, channel_type, modulation), channel_type, x, modulation


def pool_state(tables, channel_type, used, seed=0):
    """A pool with ``used`` random entries consumed and sentinel values."""
    sdc, dev = tables.code, tables.device
    g = torch.Generator(device="cpu").manual_seed(seed)
    avail = torch.ones(B, dtype=torch.int32)
    avail[torch.randperm(B, generator=g)[:used]] = 0
    vals = torch.uint8 if channel_type == "BEC" else torch.float32
    return dict(
        avail=avail.to(dev),
        fresh=torch.full((sdc.nc, B), 1 if channel_type == "BEC" else 123.0, dtype=vals,
                         device=dev),
        fresh_cw=torch.full((sdc.nc, B), 7, dtype=torch.uint8, device=dev),
        ctr=torch.randint(0, 3, (5, B), dtype=torch.int32, generator=g).to(dev),
        started=torch.tensor([12345], dtype=torch.int64, device=dev),
        remaining=torch.zeros(1, dtype=torch.int32, device=dev),
    )


def clone(s):
    return {k: v.clone() for k, v in s.items()}


def refill(fn, pt, s, x, refill_on, seed, debug=None):
    dev = s["avail"].device
    kw = {} if debug is None else {"debug": debug}
    fn(pt, channel.make_generator(dev, 5, seed), x,
       torch.tensor([int(refill_on)], dtype=torch.int32, device=dev), s["avail"], s["fresh"],
       s["fresh_cw"], s["ctr"], s["started"], 10**6, s["remaining"], **kw)


def syndrome_zero(tables, cw):
    """``H c = 0`` per frame (the sorted code's checks)."""
    sdc = tables.code
    row_ptr = tables.row_ptr.long()
    rows = torch.repeat_interleave(torch.arange(sdc.mc, device=cw.device),
                                   row_ptr[1:] - row_ptr[:-1])
    par = torch.zeros((sdc.mc, cw.shape[1]), dtype=torch.int32, device=cw.device)
    par.index_add_(0, rows, cw.index_select(0, tables.col_sorted.long()).to(torch.int32))
    return ((par % 2) == 0).all(0)


def encoded(tables, info):
    """``u G mod 2`` of info words ``info`` (int32 ``[kwords, n]``, bit
    ``i`` of word ``j`` info bit ``32 j + i``), u8 ``[nc, n]``."""
    G = tables.code.G
    kc = G.shape[0]
    shifts = torch.arange(32, device=info.device, dtype=torch.int64)
    bits = ((info.to(torch.int64)[:, None, :] >> shifts[None, :, None]) & 1).reshape(-1, info.shape[1])
    return (torch.matmul(G.t(), bits[:kc].to(torch.float32)).to(torch.int64) % 2).to(torch.uint8)


def check_draw(tables, pt, channel_type, x, modulation, cw, vals, draws, info):
    """A drawn batch (its columns): codewords with ``H c = 0`` equal to
    ``u G`` of the lanes' info words, values equal to the plain formulas on
    the codewords and draws (4-ASK within 1e-5 relative)."""
    assert bool((cw <= 1).all()) and bool(syndrome_zero(tables, cw).all())
    if pt.gtiles is not None:
        assert torch.equal(cw, encoded(tables, info))
    assert not bool(torch.isnan(draws).any())
    want = channel.channel_values(tables.code, channel_type, cw, draws, x, modulation)
    if modulation is not None:
        torch.testing.assert_close(vals, want, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(vals, want)


def stat_pairs(tables, channel_type, pools):
    """(codeword bits, channel statistic) of each pool's transmitted bits."""
    tx = tables.code.bit_pos.long()
    out = []
    for v, c in pools:
        v, c = v[tx].double(), c[tx].double()
        if channel_type == "BEC":
            stat = (v == channel.BEC_ERASURE).double()
        elif channel_type == "BSC":
            stat = ((v < 0).double() != c).double()
        else:
            stat = v * (1 - 2 * c)
        out.append((c.flatten(), stat.flatten()))
    return out


def assert_same_statistics(pairs):
    for a, b in zip(*pairs):
        se = (a.var() / a.numel() + b.var() / b.numel()).sqrt()
        assert abs(float(a.mean() - b.mean())) < 5 * float(se)


@pytest.mark.parametrize("kind", list(CHANNELS))
@pytest.mark.parametrize("code", ["bench1152", "wifi1944"])
def test_k8_against_plain(tables_of, code, kind):
    tables = tables_of(code)
    pt, channel_type, x, modulation = pool_of(tables, kind)
    used = 13000  # past the watermark (12288): every used entry is drawn
    s0 = pool_state(tables, channel_type, used)
    taken = s0["avail"] == 0
    k8, plain = clone(s0), clone(s0)
    debug = torch.full((pt.item_src.shape[0], B), float("nan"), device=tables.device)
    info = torch.zeros((pt.kwords, B), dtype=torch.int32, device=tables.device)
    before = pr.pool_refill.launches
    dev = tables.device
    pr.pool_refill(pt, channel.make_generator(dev, 5, 1), x,
                   torch.ones(1, dtype=torch.int32, device=dev), k8["avail"], k8["fresh"],
                   k8["fresh_cw"], k8["ctr"], k8["started"], 10**6, k8["remaining"], debug=debug,
                   debug_info=info)
    refill(pr.pool_refill_plain, pt, plain, x, True, 1)
    torch.cuda.synchronize()
    assert pr.pool_refill.launches == before + 1
    assert torch.equal(k8["avail"], plain["avail"]) and bool((k8["avail"] == 1).all())
    assert torch.equal(k8["remaining"], plain["remaining"])
    for name in ("fresh", "fresh_cw"):
        assert torch.equal(k8[name][:, ~taken], s0[name][:, ~taken]), name
        assert torch.equal(plain[name][:, ~taken], s0[name][:, ~taken]), name
        assert not bool((k8[name][:, taken] == s0[name][:, taken]).all(0).any()), name
    check_draw(tables, pt, channel_type, x, modulation, k8["fresh_cw"][:, taken],
               k8["fresh"][:, taken], debug[:, taken], info[:, taken])
    assert_same_statistics(stat_pairs(
        tables, channel_type, [(s["fresh"][:, taken], s["fresh_cw"][:, taken]) for s in (k8, plain)]))


@pytest.mark.parametrize("kind", list(CHANNELS))
@pytest.mark.parametrize("code", ["bench1152", "wifi1944"])
def test_channel_batch_against_plain(tables_of, code, kind):
    """K8's full batch: every lane drawn, against the plain channel batch."""
    tables = tables_of(code)
    pt, channel_type, x, modulation = pool_of(tables, kind)
    dev = tables.device
    debug = torch.full((pt.item_src.shape[0], B), float("nan"), device=dev)
    info = torch.zeros((pt.kwords, B), dtype=torch.int32, device=dev)
    before = pr.channel_batch.launches
    out = pr.channel_batch(pt, channel.make_generator(dev, 6, 1), B, x, debug=debug,
                           debug_info=info)
    want = channel.simulate_channel(tables.code, channel_type, channel.make_generator(dev, 6, 1),
                                    B, x, modulation)
    torch.cuda.synchronize()
    assert pr.channel_batch.launches == before + 1
    assert out.llr.dtype == want.llr.dtype and out.llr.shape == want.llr.shape
    assert out.codeword.shape == want.codeword.shape
    check_draw(tables, pt, channel_type, x, modulation, out.codeword, out.llr, debug, info)
    assert_same_statistics(stat_pairs(tables, channel_type, [(out.llr, out.codeword),
                                                             (want.llr, want.codeword)]))


@pytest.mark.parametrize("with_g", [True, False])
def test_channel_batch_punctured_shortened(cuda_device, with_g):
    """Punctured and shortened positions (the draw's slab of positions no
    item writes), with the generator and without it (the all-zero word)."""
    import dataclasses as dc

    import numpy as np

    from libldpc_tpu_torch.models import make_regular_code

    code = (make_benchmark_code(1152, 3, 6, seed=0, with_G=True) if with_g
            else make_regular_code(1152, 3, 36, seed=1))
    code = dc.replace(code, puncture=np.array([3, 8], np.int32), shorten=np.array([0, 17], np.int32))
    tables = kernel_tables(to_sorted_device(code, cuda_device))
    n = 4096
    for kind in CHANNELS:
        pt, channel_type, x, modulation = pool_of(tables, kind)
        assert (pt.gtiles is not None) == with_g and pt.other_pos.shape[0] >= 4
        debug = torch.full((pt.item_src.shape[0], n), float("nan"), device=cuda_device)
        info = torch.zeros((pt.kwords, n), dtype=torch.int32, device=cuda_device)
        out = pr.channel_batch(pt, channel.make_generator(cuda_device, 2), n, x, debug=debug,
                               debug_info=info)
        if not with_g:
            assert not bool(out.codeword.any())
        check_draw(tables, pt, channel_type, x, modulation, out.codeword, out.llr, debug, info)


@pytest.mark.parametrize("kind", list(CHANNELS))
@pytest.mark.parametrize("code", ["bench1152", "wifi1944"])
def test_draw_bytes_match_the_kernel(tables_of, code, kind):
    """The draw's shared memory as pool_tables sizes it equals the kernel's
    own count (``ldpc_pool_draw_bytes``)."""
    from libldpc_tpu_torch.ops.kernels import build

    pt = pool_of(tables_of(code), kind)[0]
    assert build.load().ldpc_pool_draw_bytes(pt.ksteps, int(pt.gtiles is not None), pt.lane_tile,
                                             pt.slab_cols) == pr.draw_bytes(pt)


@pytest.mark.parametrize("batch", [16384, 1000, 33])
@pytest.mark.parametrize("used_share", [0.0, 0.5, 0.8, 1.0])
@pytest.mark.parametrize("offset", [0, 1])
def test_plan_lanes_equal_plain(cuda_device, batch, used_share, offset):
    """The plan's used lanes in order, do_gen, its count and ``remaining``
    against its plain version; ``offset`` 1 views the planes 4 bytes past
    an aligned start (the scan's lane-by-lane loads)."""
    g = torch.Generator(device="cpu").manual_seed(batch + int(10 * used_share))
    avail = (torch.rand(batch + offset, generator=g) >= used_share).to(torch.int32).to(cuda_device)
    ctr = torch.randint(0, 3, (5, batch), dtype=torch.int32, generator=g).to(cuda_device)
    av = avail[offset:]
    got_rem, want_rem = (torch.zeros(1, dtype=torch.int32, device=cuda_device) for _ in range(2))
    started = torch.tensor([7], dtype=torch.int64, device=cuda_device)
    refill_on = torch.ones(1, dtype=torch.int32, device=cuda_device)
    before = pr.pool_plan.launches
    ctl, lanes = pr.pool_plan(refill_on, av, ctr, started, 10**5, got_rem)
    ctl_p, lanes_p = pr.pool_plan_plain(refill_on, av, ctr, started, 10**5, want_rem)
    torch.cuda.synchronize()
    assert pr.pool_plan.launches == before + 1
    assert torch.equal(ctl, ctl_p) and torch.equal(got_rem, want_rem)
    n = int(ctl[1])  # every used lane when the pool is drawn, none otherwise
    assert n == (int((av == 0).sum()) if int(ctl[0]) else 0)
    assert torch.equal(lanes[:n], lanes_p[:n])
    assert torch.equal(lanes[:n].long(), torch.nonzero(av == 0).flatten()[:n])


@pytest.mark.parametrize("batch", [16384, 1000, 33])
@pytest.mark.parametrize("quota", [0, 5, 400, 10**6])
@pytest.mark.parametrize("offset", [0, 1])
def test_stream_grant_equals_plain(cuda_device, batch, quota, offset):
    """The redesigned grant (16-byte loads and stores where aligned, lane by
    lane elsewhere) against ``stream_grant_plain``."""
    g = torch.Generator(device="cpu").manual_seed(batch + quota)
    planes = [(torch.rand(batch + offset, generator=g) < 0.6).to(torch.int32).to(cuda_device)
              for _ in range(2)]
    done, avail = (p_[offset:] for p_ in planes)
    for refill_on in (1, 0):
        flag = torch.tensor([refill_on], dtype=torch.int32, device=cuda_device)
        rem_k = torch.tensor([quota], dtype=torch.int32, device=cuda_device)
        rem_p = rem_k.clone()
        got = df.stream_grant(done, avail, flag, rem_k)
        want = df.stream_grant_plain(done, avail, flag, rem_p)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(rem_k, rem_p)


@pytest.mark.parametrize("case", ["K1", "K5", "K6"])
def test_batch_step_draws_through_k8(tables_of, case):
    """A batch step of K1 (flooding), K5 (exact layered) and K6 (BEC) draws
    its channel with K8's full batch and counts as its plain step on the
    same draws (the min-sum family and the peeling are exact)."""
    code, channel_type, x, schedule = {
        "K1": ("bench1152", "AWGN", 2.0, "flooding"),
        "K5": ("wifi648", "AWGN", 2.0, "layered"),
        "K6": ("bench1152", "BEC", 0.40, "flooding")}[case]
    tables = tables_of(code)
    dec = DecoderParams(iterations=50, type="BP_MS", layered=schedule == "layered")
    before = pr.channel_batch.launches
    got, want = (make_sim_step(tables, channel_type, dec, 4096, schedule, plain=plain)(
        channel.make_generator(tables.device, 4, 0), x) for plain in (False, True))
    torch.cuda.synchronize()
    assert pr.channel_batch.launches == before + 2
    assert [int(v) for v in got] == [int(v) for v in want]
    assert 0 < int(got.frames) == 4096


@pytest.mark.parametrize("used,refill_on", [(12287, True), (16384, False)])
def test_k8_keeps_the_pool(tables_of, used, refill_on):
    """Below the watermark, or with refill off, nothing is drawn."""
    tables = tables_of("bench1152")
    pt, channel_type, x, _ = pool_of(tables, "BPSK")
    s0 = pool_state(tables, channel_type, used)
    k8, plain = clone(s0), clone(s0)
    refill(pr.pool_refill, pt, k8, x, refill_on, 2)
    refill(pr.pool_refill_plain, pt, plain, x, refill_on, 2)
    for name in ("avail", "fresh", "fresh_cw"):
        assert torch.equal(k8[name], s0[name]) and torch.equal(plain[name], s0[name]), name
    assert torch.equal(k8["remaining"], plain["remaining"])


# ---- chunks under a binding quota


def half_started(tables, chunk_plain, bec, snr, dtype=None, form="BP_MS"):
    """A state from the plain chunk: half the lanes started from a full pool
    and ran one pass; then a fresh pool on every lane."""
    sdc, dev = tables.code, tables.device
    kind = "BEC" if bec else "AWGN"
    kw = {} if bec else {"minsum_mode": form}
    if dtype is not None:
        kw["message_dtype"] = dtype
    st = init_state(tables, B, kind, dtype or "float32")
    gen = channel.make_generator(dev, 8, 0)

    def fresh_pool():
        ch = channel.simulate_channel(sdc, kind, gen, B, snr)
        st.fresh_llr.copy_(ch.llr)
        st.fresh_cw.copy_(ch.codeword)
        st.avail.fill_(1)

    fresh_pool()
    chunk_plain(tables, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail,
                st.ctr, st.fresh_llr, st.fresh_cw, torch.ones(1, dtype=torch.int32, device=dev),
                torch.tensor([B // 2], dtype=torch.int32, device=dev), k=1, cap=50, **kw)
    fresh_pool()
    st.ctr.zero_()
    return st


def copy_state(st):
    return dataclasses.replace(st, **{f.name: getattr(st, f.name).clone()
                                      for f in dataclasses.fields(st)
                                      if isinstance(getattr(st, f.name), torch.Tensor)})


def run_chunk(fn, tables, st, remaining, **kw):
    dev = tables.device
    rem = torch.tensor([remaining], dtype=torch.int32, device=dev)
    fn(tables, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail, st.ctr,
       st.fresh_llr, st.fresh_cw, torch.ones(1, dtype=torch.int32, device=dev), rem, k=6,
       cap=50, **kw)
    return rem


#: the quota: every idle lane starts in the first pass, and 1000 more
#: starts are left for the lanes that finish in the later passes
BINDING = B // 2 + 1000


def check_binding(tables, kernel, plain, bec, snr, override=None, dtype=None, form="BP_MS"):
    """The kernel's chunk, ``ordered``, under ``override`` (``(module,
    attribute, value, default)``: a forced form), against the plain chunk
    from the same state: every plane, the counters and ``remaining``."""
    kw = {} if bec else dict(minsum_mode=form)
    if dtype is not None:
        kw["message_dtype"] = dtype
    st_p = half_started(tables, plain, bec, snr, dtype, form)
    st_k = copy_state(st_p)
    if override is not None:
        setattr(override[0], override[1], override[2])
    try:
        rk = run_chunk(kernel, tables, st_k, BINDING, ordered=True, **kw)
    finally:
        if override is not None:
            setattr(override[0], override[1], override[3])
    rp = run_chunk(plain, tables, st_p, BINDING, **kw)
    starts = int(st_p.ctr[4].sum())
    assert B // 2 < starts <= BINDING, starts  # lanes started after the first pass
    assert int(rp) == 0  # and the quota bound
    for name in ("llr_in", "codeword", "lv2c", "done", "iters", "age", "avail", "ctr"):
        assert torch.equal(getattr(st_k, name), getattr(st_p, name)), name
    assert torch.equal(rk, rp)


@pytest.mark.parametrize("dtype,form", [("float32", "BP_MS"), ("float32", ("BP_NMS", 0.75, 0.15)),
                                        ("bfloat16", "BP_MS"), ("int8", "BP_MS"),
                                        ("int8", ("BP_OMS", 0.75, 0.15))])
@pytest.mark.parametrize("forced", [None, (16, True), (8, True), (4, True), (0, False)])
def test_k2_binding_chunk_equals_plain(tables_of, dtype, form, forced):
    tables = tables_of("bench1152")
    if forced and forced[0] and df.flood_tile_bytes(tables, forced[0], dtype,
                                                    forced[1]) > df.SMEM_BLOCK_BYTES:
        pytest.skip("the tile does not fit a block's shared memory")
    check_binding(tables, df.bp_stream_chunk_fused, df.bp_stream_chunk_fused_plain, False, 2.5,
                  (df, "STREAM_FORM_OVERRIDE", forced, None), dtype, form)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("forced", [None, (16, False), (8, True), (0, False)])
def test_k4_binding_chunk_equals_plain(tables_of, dtype, forced):
    tables = tables_of("wifi1944")
    check_binding(tables, dl.bp_stream_chunk_layered_fast, dl.bp_stream_chunk_layered_fast_plain,
                  False, 2.5, (dl, "STREAM_FORM_OVERRIDE", forced, None), dtype)


@pytest.mark.parametrize("code", list(CODES))
@pytest.mark.parametrize("force_bytes", [False, True])
def test_k7_binding_chunk_equals_plain(tables_of, code, force_bytes):
    tables = tables_of(code)
    check_binding(tables, db.bec_stream_chunk_fused, db.bec_stream_chunk_fused_plain, True, 0.25,
                  (db, "FORCE_BYTES", force_bytes, False))
    assert db.bec_stream_chunk_fused.last_form == ("bytes" if force_bytes else "words")


def test_ordered_chunk_counts_its_launches(tables_of):
    tables = tables_of("bench1152")
    st = half_started(tables, df.bp_stream_chunk_fused_plain, False, 2.5)
    chunks, grants = df.bp_stream_chunk_fused.launches["float32"], df.stream_grant.launches
    run_chunk(df.bp_stream_chunk_fused, tables, st, BINDING, ordered=True, minsum_mode="BP_MS")
    assert df.bp_stream_chunk_fused.launches["float32"] == chunks + 6
    assert df.stream_grant.launches == grants + 6
