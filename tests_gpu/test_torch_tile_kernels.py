"""Card tests of the tile forms of the flooding streaming kernel (K2,
``csrc/flood_stream.cuh``) and of the exact layered kernel (K5,
``csrc/layered_exact_tile.cuh``), each form forced in turn through the
wrappers' overrides and held against its plain version.

* K2: every CN form in every message form, frames injected at age 0 and
  frames started from a full pool, drained chunk by chunk; the state after
  every chunk (the carried ``lv2c`` plane, ``done``, ``iters``, ``age``,
  ``avail`` and the counters) equal to the plain chunk's; chunks that
  alternate the tile and the HBM-plane forms; the exact quota; the
  degree-36 code; a batch that is not a multiple of the frames a block.
* K5: every CN form in every message form, early termination on and off,
  on the 802.11n n=648 and n=1296 codes, the degree-36 code on two layers,
  a code of check degrees 1-20 and a code whose layers reach a variable
  through two checks, at a batch that is not a multiple of the frames a
  block.
* The size rules' byte counts against the kernels' own (the library's
  ``ldpc_flood_tile_bytes`` and ``ldpc_exact_tile_bytes``).

Tolerances as in the other card tests: the min-sum family and the int8
lattice bit-exact; the other CN forms agree in decisions and iteration
counts on >= 99.9 % of frames and within 1e-4 (float32) or 2^-4
(bfloat16 on the exact schedule) on those posteriors, and their drained
totals are equal at these seeds."""

import dataclasses

import numpy as np
import pytest
import torch

from libldpc_tpu_torch.models import make_benchmark_code, wifi_code
from libldpc_tpu_torch.ops.kernels import build
from libldpc_tpu_torch.ops.kernels import decode_fused as df
from libldpc_tpu_torch.ops.kernels import decode_layered as dl
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.ops.messages import TORCH_DTYPES
from libldpc_tpu_torch.ops.sorted import to_sorted_device
from libldpc_tpu_torch.ops.streaming_fused import init_state

from test_torch_redesign_kernels import (
    CODES, DTYPE_FORMS, MINSUM, SNR_DB, assert_matches, frames, tol_of,
)

pytestmark = pytest.mark.cuda

#: (frames a block, tables staged) of the flooding streaming kernel; 0
#: frames is the HBM-plane form
K2_FORMS = [(16, True), (8, True), (4, True), (8, False), (0, False)]
#: the same for the exact layered kernel
K5_FORMS = [(16, True), (16, False), (8, True), (8, False), (4, True), (4, False), (0, False)]
B_RAGGED = 301  # no multiple of 4, 8 or 16


def overlapping():
    """The 1152 (3,6) code on its even and odd checks: a layer reaches some
    variables through two of its checks."""
    code = make_benchmark_code(1152, 3, 6, seed=0, with_G=True)
    return dataclasses.replace(code, layers=[np.arange(0, code.mc, 2, dtype=np.int32),
                                             np.arange(1, code.mc, 2, dtype=np.int32)])


TILE_CODES = {**CODES, "wifi648": lambda: wifi_code(648), "wifi1296": lambda: wifi_code(1296),
              "overlapping": overlapping}
TILE_SNR = {**SNR_DB, "wifi648": 2.0, "wifi1296": 2.0, "overlapping": 1.5, "bench1152": 1.5}


@pytest.fixture(scope="module")
def built():
    return {}


@pytest.fixture
def tables_of(built, cuda_device):
    def get(name):
        if name not in built:
            code = TILE_CODES[name]()
            built[name] = (code, kernel_tables(to_sorted_device(code, cuda_device, with_layers=True)))
        return built[name]

    return get


@pytest.fixture
def force():
    """Force a form of K2 or K5 for one test."""
    def set_forms(k2=None, k5=None):
        df.STREAM_FORM_OVERRIDE = k2
        dl.EXACT_FORM_OVERRIDE = k5

    yield set_forms
    df.STREAM_FORM_OVERRIDE = None
    dl.EXACT_FORM_OVERRIDE = None


def k2_fits(tables, forced, dtype):
    frames, stage = forced
    return frames == 0 or df.flood_tile_bytes(tables, frames, dtype, stage) <= df.SMEM_BLOCK_BYTES


def k5_fits(tables, forced, dtype):
    frames, stage = forced
    return frames == 0 or dl.exact_tile_bytes(tables, frames, dtype, stage) <= dl.SMEM_BLOCK_BYTES


# ----------------------------------------------------------------------- K2


def _start(tables, llr, cw, dtype, via_pool):
    B, dev = llr.shape[1], llr.device
    st = init_state(tables, B, message_dtype=dtype)
    if via_pool:
        st.fresh_llr.copy_(llr)
        st.fresh_cw.copy_(cw)
        st.avail.fill_(1)
    else:  # injected in flight at age 0, neutral messages: a warm-up pass first
        st.llr_in.copy_(llr)
        st.codeword.copy_(cw)
        st.done.zero_()
    return st


STATE_FIELDS = ("llr_in", "codeword", "lv2c", "done", "iters", "age", "avail", "ctr")


def _chunks(forms, tables, st, form, dtype, via_pool, k=3, cap=10, n=10):
    """Run ``n`` chunks, chunk i in ``forms[i % len(forms)]`` (None: the
    plain chunk); the state after each chunk."""
    dev = st.llr_in.device
    refill = torch.full((1,), int(via_pool), dtype=torch.int32, device=dev)
    out = []
    for i in range(n):
        forced = forms[i % len(forms)]
        remaining = torch.full((1,), st.llr_in.shape[1], dtype=torch.int32, device=dev)
        if forced is None:
            df.bp_stream_chunk_fused_plain(
                tables, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail,
                st.ctr, st.fresh_llr, st.fresh_cw, refill, remaining, k=k, cap=cap,
                minsum_mode=form, message_dtype=dtype)
        else:
            df.STREAM_FORM_OVERRIDE = forced
            launches = df.bp_stream_chunk_fused.launches[dtype]
            df.bp_stream_chunk_fused(
                tables, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail,
                st.ctr, st.fresh_llr, st.fresh_cw, refill, remaining, k=k, cap=cap,
                minsum_mode=form, message_dtype=dtype)
            assert df.bp_stream_chunk_fused.launches[dtype] == launches + 1
            assert df.bp_stream_chunk_fused.last_form == forced
        out.append({f: getattr(st, f).clone() for f in STATE_FIELDS})
        refill.zero_()
    assert int((st.done == 0).sum()) == 0
    return out


def _assert_states(got, want, form, dtype):
    for i, (g, w) in enumerate(zip(got, want)):
        for f in STATE_FIELDS:
            if f == "lv2c" and form not in MINSUM:
                same = (g["done"] == w["done"]) & (g["age"] == w["age"])
                assert same.float().mean() >= 0.999, f"chunk {i} {f}"
                torch.testing.assert_close(g[f].float()[:, same], w[f].float()[:, same],
                                           rtol=tol_of(dtype, True), atol=tol_of(dtype, True))
            else:
                assert torch.equal(g[f], w[f]), f"chunk {i}: {f} differs"


@pytest.mark.parametrize("dtype,form", DTYPE_FORMS)
@pytest.mark.parametrize("via_pool", [False, True])
@pytest.mark.parametrize("k2", K2_FORMS)
def test_flood_stream_state_after_every_chunk(tables_of, force, built, k2, via_pool, dtype,
                                              form):
    code, tables = tables_of("bench1152")
    llr, cw = frames(code, tables, B_RAGGED, TILE_SNR["bench1152"], seed=11)
    if not k2_fits(tables, k2, dtype):  # a form forced past shared memory: the launch raises
        with pytest.raises(RuntimeError, match="launch failed"):
            _chunks([k2], tables, _start(tables, llr, cw, dtype, via_pool), form, dtype,
                    via_pool, n=1)
        return
    key = ("k2 plain", via_pool, dtype, str(form))
    if key not in built:
        built[key] = _chunks([None], tables, _start(tables, llr, cw, dtype, via_pool), form,
                             dtype, via_pool)
    got = _chunks([k2], tables, _start(tables, llr, cw, dtype, via_pool), form, dtype, via_pool)
    _assert_states(got, built[key], form, dtype)
    assert int(got[-1]["ctr"][2].sum()) == B_RAGGED


@pytest.mark.parametrize("dtype,form", [("float32", "BP_MS"), ("bfloat16", "BP_MS"),
                                        ("int8", ("BP_OMS", 0.75, 0.15)), ("float32", "BP")])
@pytest.mark.parametrize("via_pool", [False, True])
def test_flood_stream_forms_alternate(tables_of, force, via_pool, dtype, form):
    """Chunks of one drain in the tile forms and the HBM-plane form in turn:
    the carried plane is the one state both read and write."""
    code, tables = tables_of("bench1152")
    llr, cw = frames(code, tables, B_RAGGED, 1.0, seed=12)
    want = _chunks([None], tables, _start(tables, llr, cw, dtype, via_pool), form, dtype,
                   via_pool, k=2, n=16)
    forms = [f for f in K2_FORMS if k2_fits(tables, f, dtype)]
    assert len(forms) >= 2
    got = _chunks(forms, tables, _start(tables, llr, cw, dtype, via_pool), form, dtype,
                  via_pool, k=2, n=16)
    _assert_states(got, want, form, dtype)


@pytest.mark.parametrize("dtype,form", [("float32", "BP_MS"), ("float32", "BP"),
                                        ("bfloat16", "BP_MS"), ("int8", ("BP_OMS", 0.75, 0.15))])
@pytest.mark.parametrize("k2", [(16, True), (8, False), (4, True)])
@pytest.mark.parametrize("name", ["regular36", "wifi1944"])
def test_flood_stream_other_codes(tables_of, force, name, k2, dtype, form):
    """The degree-36 code (the windowed combine on the tile) and the 802.11n
    n=1944 code, drained from a full pool; an age-0 injection too."""
    code, tables = tables_of(name)
    llr, cw = frames(code, tables, B_RAGGED, TILE_SNR[name], seed=13)
    if not k2_fits(tables, k2, dtype):
        k2 = df.stream_form(tables, dtype)  # the rule's form instead
    assert k2[0] > 0
    for via_pool in (True, False):
        want = _chunks([None], tables, _start(tables, llr, cw, dtype, via_pool), form, dtype,
                       via_pool, k=4, cap=12, n=6)
        got = _chunks([k2], tables, _start(tables, llr, cw, dtype, via_pool), form, dtype,
                      via_pool, k=4, cap=12, n=6)
        _assert_states(got, want, form, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("quota", [0, 37, 5000, 20000])
@pytest.mark.parametrize("k2", [(16, True), (8, True), (4, True)])
def test_flood_stream_quota_exact(tables_of, force, cuda_device, k2, quota, dtype):
    code, tables = tables_of("bench1152")
    B = 16384
    llr, cw = frames(code, tables, B, 2.0, seed=1)
    st = _start(tables, llr, cw, dtype, True)
    remaining = torch.full((1,), quota, dtype=torch.int32, device=cuda_device)
    force(k2=k2 if k2_fits(tables, k2, dtype) else df.stream_form(tables, dtype))
    df.bp_stream_chunk_fused(
        tables, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail, st.ctr,
        st.fresh_llr, st.fresh_cw, torch.ones(1, dtype=torch.int32, device=cuda_device),
        remaining, k=3, cap=12, minsum_mode="BP_MS" if dtype == "int8" else "BP",
        message_dtype=dtype)
    assert int(st.ctr[4].sum()) == min(quota, B) == B - int(st.avail.sum())


def test_flood_stream_form_rule(tables_of):
    _, bench = tables_of("bench1152")
    assert [df.stream_form(bench, dt) for dt in ("float32", "bfloat16", "int8")] == [
        (8, True), (16, True), (16, True)]


# ----------------------------------------------------------------------- K5


@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("dtype,form", DTYPE_FORMS)
@pytest.mark.parametrize("k5", K5_FORMS)
@pytest.mark.parametrize("name", ["wifi648", "wifi1296", "regular36", "mixed", "overlapping"])
def test_exact_layered_forms(tables_of, force, built, name, k5, dtype, form, early_term):
    code, tables = tables_of(name)
    assert tables.n_layers >= 2
    llr, _ = frames(code, tables, B_RAGGED, TILE_SNR[name], seed=14)
    force(k5=k5)
    if not k5_fits(tables, k5, dtype):  # a form forced past shared memory: the launch raises
        with pytest.raises(RuntimeError, match="launch failed"):
            dl.bp_decode_layered(tables, llr, 12, early_term, form, dtype)
        return
    launches = dl.bp_decode_layered.launches[dtype]
    got = dl.bp_decode_layered(tables, llr, 12, early_term, form, dtype)
    assert dl.bp_decode_layered.launches[dtype] == launches + 1
    assert dl.bp_decode_layered.last_form == k5
    key = ("k5 plain", name, dtype, str(form), early_term)
    if key not in built:
        built[key] = dl.bp_decode_layered_plain(tables, llr, 12, early_term, form, dtype)
    want = built[key]
    torch.cuda.synchronize()
    assert_matches(got, want, form, tol_of(dtype, exact_schedule=True))


def test_exact_form_rule(tables_of):
    _, wifi = tables_of("wifi648")
    assert [dl.exact_form(wifi, dt) for dt in ("float32", "bfloat16", "int8")] == [
        (16, True)] * 3
    assert dl.exact_tile_bytes(wifi, 16, "float32", True) == 228640
    _, wifi1296 = tables_of("wifi1296")
    assert [dl.exact_form(wifi1296, dt) for dt in ("float32", "bfloat16", "int8")] == [
        (4, True), (8, True), (16, False)]


@pytest.mark.parametrize("name", ["bench1152", "wifi648", "wifi1296", "wifi1944", "regular36",
                                  "overlapping"])
def test_tile_bytes_match_the_kernels(tables_of, name):
    """The size rules count a tile's shared memory as the kernels' launchers
    do, in every message form, frames a block and staging."""
    lib = build.load()
    _, t = tables_of(name)
    c = t.code
    for dtype in ("float32", "bfloat16", "int8"):
        msg = TORCH_DTYPES[dtype].itemsize
        for frames_ in (16, 8, 4):
            for stage in (True, False):
                assert df.flood_tile_bytes(t, frames_, dtype, stage) == lib.ldpc_flood_tile_bytes(
                    c.nc, c.mc, c.nnz, frames_, msg, int(stage))
                assert dl.exact_tile_bytes(t, frames_, dtype, stage) == lib.ldpc_exact_tile_bytes(
                    c.nc, c.mc, c.nnz, t.n_layers, t.layer_checks.shape[0], t.layer_vars.shape[0],
                    frames_, msg, int(stage))
