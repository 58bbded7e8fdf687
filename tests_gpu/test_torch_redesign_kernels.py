"""Card tests of the check combine's two paths and of the redesigned
kernels: check degrees past the unrolled limit through every kernel, every
CN form on the unrolled and on the windowed path, the layered streaming
kernel in each of its forms (16 and 8 frames a block with the APP in shared
memory, tables staged or not, and the HBM-plane form) against the plain
chunk and the batch kernel, and the bit-sliced BEC batch kernel with its
state in shared memory and in the device-memory scratch.

Tolerances as in the other card tests: the min-sum family, the int8 lattice
and every BEC output bit-exact; the other CN forms agree in decisions and
iteration counts on >= 99.9 % of frames and within 1e-4 (float32) or one
bf16 step (bfloat16) on those posteriors."""

import numpy as np
import pytest
import torch

from libldpc_tpu_torch.models import (
    LDPCCode, make_benchmark_code, make_qc_benchmark_code, make_regular_code, qc_natural_layers,
    wifi_code,
)
from libldpc_tpu_torch.ops.channel import BEC_ERASURE
from libldpc_tpu_torch.ops.kernels import decode_bec as db
from libldpc_tpu_torch.ops.kernels import decode_fused as df
from libldpc_tpu_torch.ops.kernels import decode_layered as dl
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.ops.sorted import to_sorted_device
from libldpc_tpu_torch.ops.streaming_fused import init_state

pytestmark = pytest.mark.cuda

MINSUM = ["BP_MS", ("BP_NMS", 0.75, 0.15), ("BP_OMS", 0.75, 0.15)]
FORMS = MINSUM + ["BP", "BP_PHI", "BP_TANH", "BP_LIN"]
DTYPE_FORMS = ([("float32", f) for f in FORMS] + [("bfloat16", f) for f in ("BP_MS", "BP")]
               + [("int8", f) for f in MINSUM])
#: (frames a block, tables staged) of the layered streaming kernel; 0 frames
#: is the HBM-plane form
STREAM_FORMS = [(16, True), (16, False), (8, True), (8, False), (0, False)]


def regular36():
    """Every check of degree 36, split into even and odd layers."""
    code = make_regular_code(1152, 3, 36, seed=1)
    code.layers = [np.arange(0, code.mc, 2, dtype=np.int32), np.arange(1, code.mc, 2, dtype=np.int32)]
    return code


def qc36():
    """A QC code with checks of degree 36 on three natural layers, each
    reaching every variable once: the fast layered engine's shape."""
    code = make_qc_benchmark_code(36 * 32, 32, dv=3, dc=36, seed=3)
    qc_natural_layers(code)
    return code


def mixed_degrees():
    """Check degrees 1 .. 20, one or more of each: both sides of the
    unrolled limit and of every window edge."""
    rng = np.random.default_rng(23)
    H = np.zeros((40, 160), np.uint8)
    for i in range(40):
        H[i, rng.choice(160, size=i % 20 + 1, replace=False)] = 1
    for v in range(160):
        if not H[:, v].any():
            H[rng.integers(20, 40), v] = 1
    code = LDPCCode.from_dense(H)
    code.layers = [np.arange(0, 40, 2, dtype=np.int32), np.arange(1, 40, 2, dtype=np.int32)]
    return code


CODES = {"regular36": regular36, "qc36": qc36, "mixed": mixed_degrees,
         "wifi1944": lambda: wifi_code(1944),
         "bench1152": lambda: make_benchmark_code(1152, 3, 6, seed=0, with_G=True)}
#: an SNR at which a few iterations resolve some frames and not others
SNR_DB = {"regular36": 6.5, "qc36": 6.5, "mixed": 3.0, "wifi1944": 1.8}


@pytest.fixture(scope="module")
def built():
    return {}


@pytest.fixture
def tables_of(built, cuda_device):
    def get(name):
        if name not in built:
            code = CODES[name]()
            built[name] = (code, kernel_tables(to_sorted_device(code, cuda_device, with_layers=True)))
        return built[name]

    return get


@pytest.fixture
def stream_form():
    """Force a form of the layered streaming kernel for one test."""
    def force(frames, stage):
        dl.STREAM_FORM_OVERRIDE = (frames, stage)

    yield force
    dl.STREAM_FORM_OVERRIDE = None


@pytest.fixture
def bec_scratch():
    """Force the BEC batch kernel's state into the device-memory scratch."""
    def force(on):
        db.FORCE_SCRATCH = on

    yield force
    db.FORCE_SCRATCH = False


def frames(code, tables, B, snr_db, seed):
    """Random codewords (zeros without a generator) and their AWGN LLRs, in
    the sorted labelling, on the card: information bits and noise from
    numpy, the encoding ``u G`` as a float32 product on the card (exact:
    0/1 terms, sums far below 2**24)."""
    sdc, dev = tables.code, tables.device
    rng = np.random.default_rng(seed)
    if sdc.G is None:
        cw = torch.zeros((sdc.nc, B), dtype=torch.uint8, device=dev)
    else:
        u = torch.from_numpy(rng.integers(0, 2, size=(sdc.G.shape[0], B)).astype(np.float32))
        cw = (torch.matmul(sdc.G.t(), u.to(dev)) % 2).to(torch.uint8)
    sigma2 = 10 ** (-snr_db / 10)
    bp = sdc.bit_pos.long()
    noise = torch.from_numpy(rng.normal(size=(bp.shape[0], B)).astype(np.float32)).to(dev)
    llr = torch.zeros((sdc.nc, B), dtype=torch.float32, device=dev)
    llr[bp] = 2.0 * ((1.0 - 2.0 * cw[bp].float()) + noise * float(np.sqrt(sigma2))) / float(sigma2)
    return llr, cw


def bec_frames(tables, B, eps, seed):
    """The all-zero codeword (or random ones with a generator) through a
    BEC, sorted labelling, on the card."""
    sdc, dev = tables.code, tables.device
    rng = np.random.default_rng(seed)
    if sdc.G is None:
        cw = torch.zeros((sdc.nc, B), dtype=torch.uint8, device=dev)
    else:
        u = torch.from_numpy(rng.integers(0, 2, size=(sdc.G.shape[0], B)).astype(np.float32))
        cw = (torch.matmul(sdc.G.t(), u.to(dev)) % 2).to(torch.uint8)
    erase = torch.from_numpy(rng.random((sdc.nc, B)) < eps).to(dev)
    return torch.where(erase, BEC_ERASURE, cw).to(torch.uint8), cw


def assert_matches(got, want, form, tol):
    same = (got.hard == want.hard).all(0) & (got.iterations == want.iterations)
    if form in MINSUM:
        assert same.all() and torch.equal(got.llr_out, want.llr_out)
        assert torch.equal(got.is_codeword, want.is_codeword)
    else:
        assert same.float().mean() >= 0.999
        torch.testing.assert_close(got.llr_out[:, same], want.llr_out[:, same], rtol=tol, atol=tol)


def tol_of(dtype, exact_schedule=False):
    return 1e-4 if dtype == "float32" else (2 ** -4 if exact_schedule else 2 ** -8)


# ------------------------------------------- the combine's paths, K1 .. K5


@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("dtype,form", DTYPE_FORMS)
@pytest.mark.parametrize("name", ["regular36", "mixed"])
def test_flooding_batch_any_degree(tables_of, name, dtype, form, early_term):
    code, tables = tables_of(name)
    assert tables.max_dc > 8
    llr, _ = frames(code, tables, 200, SNR_DB[name], seed=3)
    launches = df.bp_decode_fused.launches[dtype]
    got = df.bp_decode_fused(tables, llr, 10, early_term, form, dtype)
    want = df.bp_decode_fused_plain(tables, llr, 10, early_term, form, dtype)
    torch.cuda.synchronize()
    assert df.bp_decode_fused.launches[dtype] == launches + 1
    assert_matches(got, want, form, tol_of(dtype))


@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("dtype,form", DTYPE_FORMS)
@pytest.mark.parametrize("name", ["regular36", "mixed"])
def test_exact_layered_any_degree(tables_of, name, dtype, form, early_term):
    code, tables = tables_of(name)
    llr, _ = frames(code, tables, 200, SNR_DB[name], seed=4)
    got = dl.bp_decode_layered(tables, llr, 8, early_term, form, dtype)
    want = dl.bp_decode_layered_plain(tables, llr, 8, early_term, form, dtype)
    torch.cuda.synchronize()
    assert_matches(got, want, form, tol_of(dtype, exact_schedule=True))


@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("dtype,form", DTYPE_FORMS)
def test_fast_engine_degree36(tables_of, dtype, form, early_term):
    code, tables = tables_of("qc36")
    assert tables.max_dc == 36 and tables.layers_disjoint and tables.n_layers == 3
    llr, _ = frames(code, tables, 200, SNR_DB["qc36"], seed=5)
    got = dl.bp_decode_layered_fast(tables, llr, 8, early_term, form, dtype)
    want = dl.bp_decode_layered_fast_plain(tables, llr, 8, early_term, form, dtype)
    torch.cuda.synchronize()
    assert_matches(got, want, form, tol_of(dtype))


def _drain(fn, tables, llr, cw, form, dtype, via_pool, k=5, cap=12, chunks=8):
    B = llr.shape[1]
    dev = llr.device
    st = init_state(tables, B, message_dtype=dtype)
    if via_pool:
        st.fresh_llr.copy_(llr)
        st.fresh_cw.copy_(cw)
        st.avail.fill_(1)
    else:
        st.llr_in.copy_(llr)
        st.codeword.copy_(cw)
        st.done.zero_()
    refill = torch.full((1,), int(via_pool), dtype=torch.int32, device=dev)
    remaining = torch.full((1,), B, dtype=torch.int32, device=dev)
    for _ in range(chunks):
        fn(tables, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail, st.ctr,
           st.fresh_llr, st.fresh_cw, refill, remaining, k=k, cap=cap, minsum_mode=form,
           message_dtype=dtype)
    assert int((st.done == 0).sum()) == 0
    return st.ctr.sum(1).tolist()


def _batch_totals(out, cw, tables):
    bp = tables.code.bit_pos.long()
    errs = (out.hard[bp] != cw[bp].bool()).sum(0)
    B = cw.shape[1]
    return [int(errs.sum()), int((errs > 0).sum()), B, int(out.iterations.sum()), B]


@pytest.mark.parametrize("dtype,form", [("float32", "BP_MS"), ("float32", "BP"),
                                        ("bfloat16", "BP_MS"), ("int8", ("BP_OMS", 0.75, 0.15))])
@pytest.mark.parametrize("via_pool", [False, True])
def test_flooding_stream_degree36(tables_of, dtype, form, via_pool):
    code, tables = tables_of("regular36")
    llr, cw = frames(code, tables, 300, SNR_DB["regular36"], seed=6)
    got = _drain(df.bp_stream_chunk_fused, tables, llr, cw, form, dtype, via_pool)
    want = _drain(df.bp_stream_chunk_fused_plain, tables, llr, cw, form, dtype, via_pool)
    assert got == want and got[2] == 300


# --------------------------------- K4: every form of the layered streaming


@pytest.mark.parametrize("dtype,form", [("float32", "BP_MS"), ("float32", "BP"),
                                        ("float32", ("BP_NMS", 0.75, 0.15)),
                                        ("bfloat16", "BP_MS"), ("bfloat16", "BP"),
                                        ("int8", "BP_MS"), ("int8", ("BP_OMS", 0.75, 0.15))])
@pytest.mark.parametrize("via_pool", [False, True])
@pytest.mark.parametrize("frames_per_block,stage", STREAM_FORMS)
@pytest.mark.parametrize("name", ["wifi1944", "qc36"])
def test_layered_stream_forms_drain_like_plain_and_batch(tables_of, built, stream_form, name,
                                                         frames_per_block, stage, via_pool, dtype,
                                                         form):
    """Injected frames (age 0) or frames started from a full pool, drained:
    the totals of each form equal the plain chunk's and, from the pool, the
    batch kernel's on the same frames (B = 300: ragged last blocks).
    Bit-exact for the min-sum family and for bfloat16 BP; float32 BP's
    totals are equal too at these seeds."""
    code, tables = tables_of(name)
    llr, cw = frames(code, tables, 300, SNR_DB[name], seed=4)
    stream_form(frames_per_block, stage)
    launches = dl.bp_stream_chunk_layered_fast.launches[dtype]
    got = _drain(dl.bp_stream_chunk_layered_fast, tables, llr, cw, form, dtype, via_pool)
    assert dl.bp_stream_chunk_layered_fast.launches[dtype] == launches + 8
    assert dl.bp_stream_chunk_layered_fast.last_form == (frames_per_block, stage)
    key = (name, via_pool, dtype, str(form))
    if key not in built:  # the plain chunk's totals, once for the five forms
        built[key] = _drain(dl.bp_stream_chunk_layered_fast_plain, tables, llr, cw, form, dtype,
                            via_pool)
    assert got == built[key] and got[2] == 300
    if via_pool:
        out = dl.bp_decode_layered_fast(tables, llr, 12, True, form, dtype)
        assert got == _batch_totals(out, cw, tables)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("quota", [0, 37, 5000, 20000])
@pytest.mark.parametrize("frames_per_block,stage", [(16, True), (8, False), (0, False)])
def test_layered_stream_forms_quota_exact(tables_of, stream_form, cuda_device, frames_per_block,
                                          stage, quota, dtype):
    code, tables = tables_of("wifi1944")
    B = 16384
    llr, cw = frames(code, tables, B, 2.0, seed=1)
    st = init_state(tables, B, message_dtype=dtype)
    st.fresh_llr.copy_(llr)
    st.fresh_cw.copy_(cw)
    st.avail.fill_(1)
    remaining = torch.full((1,), quota, dtype=torch.int32, device=cuda_device)
    stream_form(frames_per_block, stage)
    dl.bp_stream_chunk_layered_fast(
        tables, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail, st.ctr,
        st.fresh_llr, st.fresh_cw, torch.ones(1, dtype=torch.int32, device=cuda_device),
        remaining, k=3, cap=12, minsum_mode="BP_MS", message_dtype=dtype)
    assert int(st.ctr[4].sum()) == min(quota, B) == B - int(st.avail.sum())


def test_layered_stream_state_carries_across_chunks_and_forms(tables_of, stream_form):
    """A chunk's APP plane and messages are the next chunk's input: chunks
    of one drain run in different forms give the totals of one form."""
    code, tables = tables_of("wifi1944")
    llr, cw = frames(code, tables, 300, 1.0, seed=8)
    want = _drain(dl.bp_stream_chunk_layered_fast_plain, tables, llr, cw, "BP_MS", "float32", True,
                  k=2, chunks=14)
    st = init_state(tables, 300)
    st.fresh_llr.copy_(llr)
    st.fresh_cw.copy_(cw)
    st.avail.fill_(1)
    refill = torch.ones(1, dtype=torch.int32, device=llr.device)
    remaining = torch.full((1,), 300, dtype=torch.int32, device=llr.device)
    for i in range(14):
        stream_form(*STREAM_FORMS[i % len(STREAM_FORMS)])
        dl.bp_stream_chunk_layered_fast(
            tables, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail, st.ctr,
            st.fresh_llr, st.fresh_cw, refill, remaining, k=2, cap=12, minsum_mode="BP_MS")
    assert st.ctr.sum(1).tolist() == want


def test_stream_form_rule(tables_of):
    """The size rule: the 802.11n n=1944 tile fits at 16 frames with its
    tables; a code of 8190 variables keeps the HBM-plane form."""
    _, wifi = tables_of("wifi1944")
    assert dl.stream_form(wifi) == (16, True)
    assert dl.fast_tile_bytes(wifi, 16, False) == 1944 * 16 * 4 + 972 * 4


# -------------------------------------------------- K6 / K7: the BEC kernels


def _assert_equal(got, want):
    for a, b, name in zip(got, want, got._fields):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("scratch", [False, True])
@pytest.mark.parametrize("stale", [None, 0])
@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("name,B,eps", [("bench1152", 33, 0.40), ("wifi1944", 16384, 0.45),
                                        ("wifi1944", 33, 0.45), ("regular36", 1000, 0.04),
                                        ("mixed", 1000, 0.15)])
def test_bec_batch_words(tables_of, bec_scratch, name, B, eps, early_term, stale, scratch):
    _, tables = tables_of(name)
    sym, cw = bec_frames(tables, B, eps, seed=B)
    bec_scratch(scratch)
    got = db.bec_decode_fused(tables, sym, cw, 50, early_term, stale)
    assert db.bec_decode_fused.last_in_shared == (not scratch)
    want = db.bec_decode_fused_plain(tables, sym, cw, 50, early_term, stale)
    torch.cuda.synchronize()
    _assert_equal(got, want)


def test_bec_stream_degree36(tables_of):
    _, tables = tables_of("regular36")
    sym, cw = bec_frames(tables, 1000, 0.05, seed=7)

    def drain(fn):
        st = init_state(tables, 1000, "BEC")
        st.fresh_llr.copy_(sym)
        st.fresh_cw.copy_(cw)
        st.avail.fill_(1)
        refill = torch.ones(1, dtype=torch.int32, device=sym.device)
        remaining = torch.full((1,), 1000, dtype=torch.int32, device=sym.device)
        for _ in range(10):
            fn(tables, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail,
               st.ctr, st.fresh_llr, st.fresh_cw, refill, remaining, k=6, cap=50)
            refill.zero_()
        assert int((st.done == 0).sum()) == 0
        return st.ctr.sum(1).tolist()

    got = drain(db.bec_stream_chunk_fused)
    assert got == drain(db.bec_stream_chunk_fused_plain) and got[2] == got[4] == 1000
    out = db.bec_decode_fused(tables, sym, cw, 50, True)
    bp = tables.code.bit_pos.long()
    errs = (out.hard[bp] != cw[bp]).sum(0)
    assert got[:4] == [int(errs.sum()), int((errs > 0).sum()), 1000, int(out.iterations.sum())]
