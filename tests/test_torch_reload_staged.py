"""The staged reload of the XLA streaming super-step on the CPU, through
the wrappers' plain versions (``ops.streaming._card_superstep``: per pass a
one-pass K2 chunk that starts the lanes the last pass staged, then K8's
reload form, staged in every pass but a super-step's last).

* Against the sequence it replaces (every pass's reload straight into the
  state, then K2 with no starts), on the same draws (both reloads call
  ``stream_reload_plain``'s ``draw``, a channel batch from the pass's
  generator): ``BP_MS`` deltas and every plane bit for bit at every
  super-step's end, with the quota binding and not binding.
* Against the JAX package's super-step (``libldpc_tpu.ops.streaming``
  ``make_streaming_step``, whose body is ``_superstep_body``) on one
  injected NumPy channel batch (both packages' ``simulate_channel``
  replaced): ``BP_MS`` deltas and planes bit for bit, ``lv2c`` on the
  lanes in flight (K2 leaves an idle lane's alone); ``BP`` the same, but
  ``lv2c`` within 1e-2 (relative and absolute): the box-plus's last bits
  differ between XLA and PyTorch, and over a super-step's 50 passes the
  difference grows to ~5e-3 on this code, where ``test_torch_xla_streaming``'s
  10-pass super-steps stay within 1e-4.
* The staging buffer is empty (``slot`` all -1) after every super-step,
  and every super-step staged all but its last pass's reloads.

A small code (the 96-variable (3,6) code), B = 256, reloads in bursts of
B / 16, super-steps of 50 passes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libldpc_tpu.models import make_benchmark_code
from libldpc_tpu.ops import channel as jchannel
from libldpc_tpu.ops import sorted as jsorted
from libldpc_tpu.ops import streaming as jstreaming
from libldpc_tpu.utils import params as jparams
from libldpc_tpu_torch.convert import code_from_jax
from libldpc_tpu_torch.ops import streaming as tstreaming
from libldpc_tpu_torch.ops.channel import ChannelOutput, make_generator
from libldpc_tpu_torch.ops.kernels import decode_fused as df
from libldpc_tpu_torch.ops.kernels import pool_refill as pr
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.ops.sorted import to_sorted_device
from libldpc_tpu_torch.utils.params import DecoderParams

torch.set_num_threads(2)

B = 256
PASSES = 50
THRESHOLD = B // 16
PLANES = ("llr_in", "codeword", "lv2c", "active", "age", "iters", "started")


@pytest.fixture(scope="module")
def code():
    return make_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True)


@pytest.fixture(scope="module")
def tables(code):
    return kernel_tables(to_sorted_device(code_from_jax(code), "cpu"))


def present_superstep(tables, pool, cn_mode, quota, scratch, gen, x_value, refill, st, n_iters):
    """The sequence the staged one replaces: every pass's reload straight
    into the state, then the next pass's K2 launch with no starts."""
    done = (~st.active).to(torch.int32)
    ctr = scratch["ctr"]
    ctr.zero_()
    for _ in range(n_iters):
        df.bp_stream_chunk_fused(
            tables, st.llr_in, st.codeword, st.lv2c, done, st.iters, st.age, scratch["avail"],
            ctr, st.llr_in, st.codeword, scratch["refill"][False], scratch["remaining"], k=1,
            cap=PASSES, minsum_mode=cn_mode)
        pr.stream_reload(pool, gen, x_value, scratch["refill"][bool(refill)], done, st.llr_in,
                         st.codeword, st.lv2c, st.age, st.iters, st.started, quota, THRESHOLD)
    st.active = done == 0
    sums = ctr.sum(dim=1, dtype=torch.int64)
    return st, tstreaming.StreamDeltas(sums[0], sums[1], sums[2], sums[3], st.active.sum())


def staged_superstep(tables, pool, cn_mode, quota, scratch, gen, x_value, refill, st, n_iters):
    return tstreaming._card_superstep(tables, pool, PASSES, cn_mode, quota, THRESHOLD, scratch,
                                      gen, x_value, refill, st, n_iters)


@pytest.mark.parametrize("quota", [10**6, 1007], ids=["free", "binding"])
def test_staged_sequence_equals_the_present_one(tables, quota, monkeypatch):
    forms = []  # per reload: staged or into the state
    real = pr.stream_reload

    def spy(*args, stage=None, **kwargs):
        forms.append(stage is not None)
        return real(*args, stage=stage, **kwargs)

    monkeypatch.setattr(pr, "stream_reload", spy)
    pool = pr.pool_tables(tables.code, "AWGN")
    cn_mode = DecoderParams(iterations=PASSES, type="BP_MS").cn_mode
    runs = []
    for step in (present_superstep, staged_superstep):
        scratch = tstreaming.card_scratch(tables.code.nc, B, "cpu")
        st = tstreaming._init_state(tables.code, B)
        rows = []
        for s, refill in enumerate([True] * 3 + [False] * 2):
            st, acc = step(tables, pool, cn_mode, quota, scratch, make_generator("cpu", 4, s),
                           1.5, refill, st, PASSES)
            assert not bool((scratch["stage"].slot >= 0).any()), s
            rows.append(([int(v) for v in acc], {n: getattr(st, n).clone() for n in PLANES}))
        runs.append(rows)
    for s, ((dp, pp), (ds, ps)) in enumerate(zip(*runs)):
        assert ds == dp, s
        for name in PLANES:
            assert torch.equal(ps[name], pp[name]), (s, name)
    frames = sum(d[2] for d, _ in runs[1])
    assert frames > B
    if quota < 10**6:
        assert frames == quota  # the quota lands exactly once drained
    # the present sequence never staged; the staged one staged every reload
    # of a super-step but its last
    present, staged = forms[:5 * PASSES], forms[5 * PASSES:]
    assert not any(present)
    assert staged == ([True] * (PASSES - 1) + [False]) * 5


def frame_table(code, vn_perm, batch, snr_db, seed):
    """Random codewords and their AWGN LLRs, made with NumPy, sorted labels."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(code.G.shape[0], batch))
    cw = (code.G.T.astype(np.int64) @ u % 2).astype(np.uint8)
    s2 = 10 ** (-snr_db / 10)
    llr = np.zeros((code.nc, batch), np.float32)
    x = 1.0 - 2.0 * cw[code.bit_pos]
    llr[code.bit_pos] = 2.0 * (x + rng.normal(size=x.shape) * np.sqrt(s2)) / s2
    vp = np.asarray(vn_perm)
    return np.ascontiguousarray(llr[vp]), np.ascontiguousarray(cw[vp])


@pytest.mark.parametrize("form", ["BP_MS", "BP"])
def test_staged_sequence_against_the_jax_superstep(code, tables, form, monkeypatch):
    jsdc = jsorted.to_sorted_device(code)
    llr, cw = frame_table(code, jsdc.vn_perm, B, 1.5, seed=13)
    monkeypatch.setattr(jstreaming, "simulate_channel",
                        lambda *a, **k: jchannel.ChannelOutput(jnp.asarray(llr), jnp.asarray(cw)))
    monkeypatch.setattr(pr, "simulate_channel",
                        lambda *a, **k: ChannelOutput(torch.from_numpy(llr).clone(),
                                                      torch.from_numpy(cw).clone()))
    quota = 1200
    j_init, j_step = jstreaming.make_streaming_step(
        jsdc, "AWGN", jparams.DecoderParams(iterations=PASSES, type=form), B, max_frames=quota,
        gen_threshold=THRESHOLD)
    pool = pr.pool_tables(tables.code, "AWGN")
    cn_mode = DecoderParams(iterations=PASSES, type=form).cn_mode
    scratch = tstreaming.card_scratch(tables.code.nc, B, "cpu")
    jst, tst = j_init(), tstreaming._init_state(tables.code, B)
    for s, refill in enumerate([True] * 3 + [False] * 2):
        jst, jacc = j_step(jst, jax.random.PRNGKey(s), jnp.float32(1.5), jnp.bool_(refill))
        tst, tacc = staged_superstep(tables, pool, cn_mode, quota, scratch,
                                     make_generator("cpu", 0, s), 1.5, refill, tst, PASSES)
        assert [int(v) for v in tacc] == [int(v) for v in jacc], s
        assert not bool((scratch["stage"].slot >= 0).any()), s
        active = np.asarray(jst.active)
        for name in PLANES:
            j, t = np.asarray(getattr(jst, name)), getattr(tst, name).numpy()
            if name == "lv2c":
                j, t = j[:, active], t[:, active]
                if form == "BP":
                    np.testing.assert_allclose(t, j, rtol=1e-2, atol=1e-2, err_msg=str(s))
                    continue
            np.testing.assert_array_equal(t, j, err_msg=f"{s} {name}")


def test_reload_tables_take_the_reload_tiling():
    """The reload form's tables: the pool's, cut into the reload's tiling
    (``RELOAD_SLAB_COLS`` columns x ``RELOAD_LANE_TILE`` lanes a block);
    what a lane draws depends on the key and the lane only."""
    sdc = to_sorted_device(code_from_jax(make_benchmark_code(1152, 3, 6, seed=0, with_G=True)),
                           "cpu")
    pt = pr.pool_tables(sdc, "AWGN")
    rt = pr.reload_tables(pt)
    assert (pt.lane_tile, pt.items_per_slab) == (pr.LANE_TILE, pr.SLAB_COLS)
    assert (rt.lane_tile, rt.items_per_slab) == (pr.RELOAD_LANE_TILE, pr.RELOAD_SLAB_COLS)
    for name in ("item_src", "item_dst", "other_pos", "other_short"):
        assert torch.equal(getattr(rt, name), getattr(pt, name)), name
    assert (rt.code, rt.channel_type, rt.modulation, rt.kw) == (pt.code, "AWGN", None, pt.kw)
    assert rt.slab_tile0.numel() - 1 == 2 * (pt.slab_tile0.numel() - 1)  # slabs of half the items
