"""The streaming kernel's plain version and the streaming step against the
JAX package.

Drain equivalence: frames injected into the streams (``refill=False``)
drain to the same ``[bit_errors, frame_errors, frames, iter_sum]`` as the
JAX batch decoder on the same frames.  Each frame runs the same arithmetic
as in the batch decoder, so the totals are exact for ``BP_MS``, and for
``BP`` too at these seeds (the port's plain box-plus differs from XLA's in
the last bit of a posterior at most, which flips no decision here)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libldpc_tpu.models import make_benchmark_code
from libldpc_tpu.ops.pallas.layout import to_pallas_device
from libldpc_tpu.ops.sorted import bp_decode_sorted
from libldpc_tpu.ops.streaming_pallas import make_streaming_pallas_step
from libldpc_tpu.utils.params import DecoderParams
from libldpc_tpu_torch import convert
from libldpc_tpu_torch.ops.channel import make_generator
from libldpc_tpu_torch.ops.kernels import decode_fused as df
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.convert import code_from_jax
from libldpc_tpu_torch.ops.sorted import to_sorted_device
from libldpc_tpu_torch.ops.streaming import split_exact
from libldpc_tpu_torch.ops.streaming_fused import make_streaming_fused_step

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup():
    code = make_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True)
    pdc = to_pallas_device(code)
    return code, pdc, kernel_tables(to_sorted_device(code_from_jax(code), "cpu"))


def frames(code, vn_perm, B, snr_db, seed):
    """Random codewords and their AWGN LLRs, made with numpy (sorted labels)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(code.G.shape[0], B))
    cw = (code.G.T.astype(np.int64) @ u % 2).astype(np.uint8)
    sigma2 = 10 ** (-snr_db / 10)
    llr = np.zeros((code.nc, B), np.float32)
    x = 1.0 - 2.0 * cw[code.bit_pos]
    llr[code.bit_pos] = 2.0 * (x + rng.normal(size=x.shape) * np.sqrt(sigma2)) / sigma2
    vn_perm = np.asarray(vn_perm)
    return np.ascontiguousarray(llr[vn_perm]), np.ascontiguousarray(cw[vn_perm])


def drain(step_fn, state, max_steps=100):
    totals = np.zeros(4, dtype=np.int64)
    for step in range(max_steps):
        state, acc = step_fn(state, make_generator("cpu", 0, step), 0.0, False)
        totals += [int(acc.bit_errors), int(acc.frame_errors), int(acc.frames), int(acc.iter_sum)]
        if int(acc.n_active) == 0:
            return totals
    raise AssertionError("streams did not drain")


@pytest.mark.parametrize("snr,iters,k", [(-2.0, 12, 5), (1.0, 12, 12), (3.0, 7, 3)])
@pytest.mark.parametrize("form", ["BP", "BP_MS"])
def test_drain_matches_batch_decoder(setup, snr, iters, k, form):
    code, pdc, tables = setup
    B = 64
    llr, cw = frames(code, pdc.sorted_dc.vn_perm, B, snr, seed=3)
    out = bp_decode_sorted(pdc.sorted_dc, jnp.asarray(llr), iterations=iters,
                           early_term=True, minsum_mode=form)
    bit_pos = np.asarray(pdc.sorted_dc.bit_pos)
    errs = (np.asarray(out.hard)[bit_pos] != cw[bit_pos]).sum(axis=0)
    want = [errs.sum(), (errs > 0).sum(), B, np.asarray(out.iterations).sum()]

    dec = DecoderParams(iterations=iters, type=form)
    init_fn, step_fn = make_streaming_fused_step(tables, "AWGN", dec, B, chunk_iters=k)
    state = init_fn()
    state.llr_in.copy_(torch.from_numpy(llr))
    state.codeword.copy_(torch.from_numpy(cw))
    state.done.zero_()  # injected frames, zero-init protocol (age 0)
    np.testing.assert_array_equal(drain(step_fn, state), want)


def test_state_from_jax_stream_drains_alike(setup):
    """One JAX in-kernel streaming super-step (interpret mode) with reloads,
    then its state carried into the port: both drain to the same totals."""
    code, pdc, tables = setup
    B, dec = 32, DecoderParams(iterations=8, type="BP_MS")
    init_j, step_j = make_streaming_pallas_step(pdc, "AWGN", dec, B, chunk_iters=4,
                                                interpret=True, batch_tile=B)
    st_j, acc = step_j(init_j(), jax.random.PRNGKey(5), np.float32(1.0), jnp.asarray(True))
    assert int(acc.n_active) > 0
    arrays = {f: np.asarray(getattr(st_j, f)) for f in st_j._fields}
    state = convert.from_pstream_state(arrays, tables.code.cn_classes)
    assert int(state.started) == int(np.asarray(st_j.started).sum()) > B  # lanes reloaded

    want = np.zeros(4, dtype=np.int64)
    for step in range(100):
        st_j, acc = step_j(st_j, jax.random.PRNGKey(100 + step), np.float32(1.0),
                           jnp.asarray(False))
        want += [int(acc.bit_errors), int(acc.frame_errors), int(acc.frames), int(acc.iter_sum)]
        if int(acc.n_active) == 0:
            break
    _, step_fn = make_streaming_fused_step(tables, "AWGN", dec, B, chunk_iters=4)
    np.testing.assert_array_equal(drain(step_fn, state), want)


def _run(tables, B, max_frames, steps, form="BP_MS"):
    dec = DecoderParams(iterations=6, type=form)
    init_fn, step_fn = make_streaming_fused_step(tables, "AWGN", dec, B, max_frames=max_frames)
    state = init_fn()
    n_frames = 0
    for step in range(steps):
        state, acc = step_fn(state, make_generator("cpu", 1, step), 1.0, True)
        n_frames += int(acc.frames)
    return state, n_frames


def test_quota_starts_exactly(setup):
    _, _, tables = setup
    state, n_frames = _run(tables, 32, 48, steps=8)
    assert int(state.started) == 48
    assert n_frames == 48 and int((state.done == 0).sum()) == 0


def test_streams_recycle(setup):
    _, _, tables = setup
    state, n_frames = _run(tables, 32, int(10e9), steps=6)
    assert n_frames > 2 * 32  # lanes reload after their frames finish
    assert int(state.started) >= n_frames


def test_plain_quota_grants_in_lane_order(setup):
    code, pdc, tables = setup
    B = 16
    llr, cw = frames(code, pdc.sorted_dc.vn_perm, B, 2.0, seed=1)
    state = make_streaming_fused_step(tables, "AWGN", DecoderParams(iterations=4), B)[0]()
    state.fresh_llr.copy_(torch.from_numpy(llr))
    state.fresh_cw.copy_(torch.from_numpy(cw))
    state.avail.fill_(1)
    remaining = torch.tensor([5], dtype=torch.int32)
    df.bp_stream_chunk_fused(
        tables, state.llr_in, state.codeword, state.lv2c, state.done, state.iters, state.age,
        state.avail, state.ctr, state.fresh_llr, state.fresh_cw,
        torch.ones(1, dtype=torch.int32), remaining, k=1, cap=4, minsum_mode="BP_MS",
    )
    assert state.ctr[4].tolist() == [1] * 5 + [0] * 11
    assert int(remaining) == 0 and state.avail.tolist() == [0] * 5 + [1] * 11


def test_split_exact():
    assert split_exact(10, 3).tolist() == [4, 3, 3]
    assert split_exact(2, 4).tolist() == [1, 1, 0, 0]
    assert split_exact(7, 1).tolist() == [7]
