"""The BEC peeling kernels (batch and streaming) against their plain
PyTorch versions, on the card, on the same inputs.  The algebra is
integer, so every output must be equal, byte for byte: posterior symbols,
decisions, iteration counts, resolution flags and drained counters.  The
streaming kernel runs in the form its size rule picks (words in shared
memory, or byte planes for a code whose words do not fit) and in the byte
form forced (``decode_bec.FORCE_BYTES``); both leave every carried plane
and counter of a chunk equal to the plain version's."""

import numpy as np
import pytest
import torch

from libldpc_tpu_torch.models import (
    LDPCCode, make_benchmark_code, make_qc_benchmark_code, make_regular_code, wifi_code,
)
from libldpc_tpu_torch.ops.channel import BEC_ERASURE, make_generator
from libldpc_tpu_torch.ops.kernels import decode_bec as db
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.ops.sorted import to_sorted_device
from libldpc_tpu_torch.ops.streaming_fused import init_state, make_streaming_fused_step
from libldpc_tpu_torch.sim.driver import ChannelParams, DecoderParams, SimulationParams, Simulator

pytestmark = pytest.mark.cuda

B_FULL = 16384


def degree1_code():
    """A random irregular code with degree-1 variables and a degree-1
    check (every other check of degree >= 2)."""
    rng = np.random.default_rng(17)
    H = (rng.random((60, 120)) < 0.05).astype(np.uint8)
    for i in range(60):
        H[i, rng.integers(0, 120)] = 1
        H[i, rng.integers(0, 120)] = 1
    for v in range(120):
        if not H[:, v].any():
            H[rng.integers(0, 60), v] = 1
    H[0] = 0
    H[0, 3] = 1  # a degree-1 check pins bit 3
    code = LDPCCode.from_dense(H)
    assert (np.bincount(code.cols, minlength=code.nc) == 1).any()
    return code


CODES = {
    "bench1152": lambda: make_benchmark_code(1152, 3, 6, seed=0, with_G=True),
    "wifi1944": lambda: wifi_code(1944, with_layers=False),
    "degree1": degree1_code,
}


@pytest.fixture(scope="module", params=sorted(CODES))
def tables(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return kernel_tables(to_sorted_device(CODES[request.param](), torch.device("cuda")))


#: the streaming kernel's codes: those above, every check of degree 36, and
#: a QC code of 8192 variables whose words pass a block's shared memory
STREAM_CODES = {**CODES, "regular36": lambda: make_regular_code(1152, 3, 36, seed=1),
                "big": lambda: make_qc_benchmark_code(8 * 1024, 1024, dv=3, dc=6, seed=2)}
#: an erasure rate at which a chunk resolves some frames and not others
STREAM_EPS = {"bench1152": 0.40, "wifi1944": 0.40, "degree1": 0.3, "regular36": 0.04,
              "big": 0.40}


@pytest.fixture(scope="module")
def stream_built():
    return {}


@pytest.fixture
def stream_tables(stream_built, cuda_device):
    def get(name):
        if name not in stream_built:
            code = STREAM_CODES[name]()
            stream_built[name] = kernel_tables(to_sorted_device(code, cuda_device))
        return stream_built[name]

    return get


@pytest.fixture(params=["rule", "bytes"])
def stream_form(request):
    """The streaming kernel in its size rule's form, or in the byte form
    forced; yields the form expected of a code's tables."""
    db.FORCE_BYTES = request.param == "bytes"
    yield lambda tables: "bytes" if db.FORCE_BYTES else db.bec_stream_form(tables)
    db.FORCE_BYTES = False


def frames(tables, B, eps, seed):
    """Random codewords (zeros without a generator) and their BEC symbols,
    in the sorted labelling, on the card: information bits and erasures
    from numpy, the encoding ``u G`` as a float32 product on the card
    (exact: 0/1 terms, sums far below 2**24)."""
    sdc = tables.code
    dev = tables.device
    rng = np.random.default_rng(seed)
    if sdc.G is None:
        cw = torch.zeros((sdc.nc, B), dtype=torch.uint8, device=dev)
    else:
        u = torch.from_numpy(rng.integers(0, 2, size=(sdc.G.shape[0], B)).astype(np.float32))
        cw = (torch.matmul(sdc.G.t(), u.to(dev)) % 2).to(torch.uint8)
    erase = torch.from_numpy(rng.random((sdc.nc, B)) < eps).to(dev)
    return torch.where(erase, BEC_ERASURE, cw).to(torch.uint8), cw


def assert_equal(got, want):
    for a, b, name in zip(got, want, got._fields):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("stale", [None, 0])
@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("B", [B_FULL, 1000])  # 1000: a ragged last block
def test_batch_kernel_matches_plain(tables, cuda_device, B, early_term, stale):
    sym, cw = frames(tables, B, 0.40, seed=B)
    launches = db.bec_decode_fused.launches
    got = db.bec_decode_fused(tables, sym, cw, 50, early_term, stale)
    want = db.bec_decode_fused_plain(tables, sym, cw, 50, early_term, stale)
    torch.cuda.synchronize()
    assert db.bec_decode_fused.launches == launches + 1
    assert_equal(got, want)
    if not early_term:
        assert (got.iterations == 50).all()


def test_zero_iterations_launches_nothing(tables, cuda_device):
    sym, cw = frames(tables, 64, 0.3, seed=1)
    launches = db.bec_decode_fused.launches
    got = db.bec_decode_fused(tables, sym, cw, 0)
    assert db.bec_decode_fused.launches == launches
    assert_equal(got, db.bec_decode_fused_plain(tables, sym, cw, 0))
    assert torch.equal(got.symbols_out, sym) and not got.iterations.any()


def test_one_iteration(tables, cuda_device):
    sym, cw = frames(tables, 777, 0.2, seed=2)
    assert_equal(db.bec_decode_fused(tables, sym, cw, 1),
                 db.bec_decode_fused_plain(tables, sym, cw, 1))


def _drain(fn, tables, sym, cw, k, cap, stale):
    B = sym.shape[1]
    st = init_state(tables, B, "BEC")
    st.fresh_llr.copy_(sym)
    st.fresh_cw.copy_(cw)
    st.avail.fill_(1)
    refill = torch.ones(1, dtype=torch.int32, device=sym.device)
    remaining = torch.full((1,), B, dtype=torch.int32, device=sym.device)
    for _ in range(cap + 2):
        fn(tables, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail, st.ctr,
           st.fresh_llr, st.fresh_cw, refill, remaining, k=k, cap=cap, degree1_stale_byte=stale)
        refill.zero_()
        if int((st.done == 0).sum()) == 0:
            return st.ctr.sum(1).tolist()
    raise AssertionError("streams did not drain")


def test_stream_form_rule(stream_tables):
    """Words for every code here but the QC code of 8192 variables."""
    for name in STREAM_CODES:
        assert db.bec_stream_form(stream_tables(name)) == ("bytes" if name == "big" else "words")


STATE = ("llr_in", "codeword", "lv2c", "done", "iters", "age", "avail", "ctr")


@pytest.mark.parametrize("stale", [None, 0, 1])
@pytest.mark.parametrize("B", [1, 31, 33, 48, 301, B_FULL])
@pytest.mark.parametrize("name", sorted(STREAM_CODES))
def test_stream_kernel_state_after_a_chunk(stream_tables, stream_form, name, B, stale):
    """One chunk from a state in mid-stream (lanes injected at age 0, then
    three plain passes with reloads from the pool), with reloads from a
    fresh pool and frames finishing at their cap: every carried plane and
    counter equal to the plain version's (the quota does not bind).  B = 48
    and 16384 take the word form's 16-byte row accesses (in the first of
    48's two words only), the rest its byte votes."""
    tables = stream_tables(name)
    sym, cw = frames(tables, B, STREAM_EPS[name], seed=B)
    fsym, fcw = frames(tables, B, STREAM_EPS[name], seed=B + 1)
    st = init_state(tables, B, "BEC")
    inject = torch.from_numpy(np.random.default_rng(B).random(B) < 0.3).to(sym.device)
    st.llr_in.copy_(torch.where(inject, sym, st.llr_in))
    st.codeword.copy_(torch.where(inject, cw, st.codeword))
    st.done.copy_((~inject).to(torch.int32))
    st.fresh_llr.copy_(fsym)
    st.fresh_cw.copy_(fcw)
    st.avail.fill_(1)
    refill = torch.ones(1, dtype=torch.int32, device=sym.device)
    args = lambda s: (tables, s.llr_in, s.codeword, s.lv2c, s.done, s.iters, s.age, s.avail,
                      s.ctr, s.fresh_llr, s.fresh_cw, refill)
    db.bec_stream_chunk_fused_plain(*args(st), torch.full((1,), B // 2, dtype=torch.int32,
                                                          device=sym.device),
                                    k=3, cap=8, degree1_stale_byte=stale)
    st.fresh_llr.copy_(torch.where(st.avail == 0, sym, st.fresh_llr))
    st.fresh_cw.copy_(torch.where(st.avail == 0, cw, st.fresh_cw))
    st.avail.fill_(1)
    got, want = init_state(tables, B, "BEC"), init_state(tables, B, "BEC")
    for s_ in (got, want):
        for n in STATE + ("fresh_llr", "fresh_cw"):
            getattr(s_, n).copy_(getattr(st, n))
    launches = db.bec_stream_chunk_fused.launches
    db.bec_stream_chunk_fused(*args(got), torch.full((1,), B, dtype=torch.int32,
                                                     device=sym.device),
                              k=6, cap=8, degree1_stale_byte=stale)
    assert db.bec_stream_chunk_fused.launches == launches + 1
    assert db.bec_stream_chunk_fused.last_form == stream_form(tables)
    db.bec_stream_chunk_fused_plain(*args(want), torch.full((1,), B, dtype=torch.int32,
                                                            device=sym.device),
                                    k=6, cap=8, degree1_stale_byte=stale)
    torch.cuda.synchronize()
    for n in STATE:
        assert torch.equal(getattr(got, n), getattr(want, n)), n
    if B == B_FULL:
        assert int(want.ctr[2].sum()) > 0 and int(want.ctr[4].sum()) > 0


@pytest.mark.parametrize("stale", [None, 0])
@pytest.mark.parametrize("B", [B_FULL, 1000])
def test_stream_kernel_drains_like_plain_and_batch(tables, stream_form, cuda_device, B, stale):
    sym, cw = frames(tables, B, 0.42, seed=3)
    launches = db.bec_stream_chunk_fused.launches
    got = _drain(db.bec_stream_chunk_fused, tables, sym, cw, 6, 50, stale)
    assert db.bec_stream_chunk_fused.launches > launches
    assert db.bec_stream_chunk_fused.last_form == stream_form(tables)
    want = _drain(db.bec_stream_chunk_fused_plain, tables, sym, cw, 6, 50, stale)
    assert got == want and got[2] == got[4] == B
    out = db.bec_decode_fused(tables, sym, cw, 50, True, stale)
    bp = tables.code.bit_pos.long()
    errs = (out.hard[bp] != cw[bp]).sum(0)
    assert got[:4] == [int(errs.sum()), int((errs > 0).sum()), B, int(out.iterations.sum())]


@pytest.mark.parametrize("quota", [0, 1, 37, 5000, B_FULL, 20000])
def test_stream_kernel_quota_exact(tables, stream_form, cuda_device, quota):
    B = B_FULL
    sym, cw = frames(tables, B, 0.55, seed=4)
    st = init_state(tables, B, "BEC")
    st.fresh_llr.copy_(sym)
    st.fresh_cw.copy_(cw)
    st.avail.fill_(1)
    remaining = torch.full((1,), quota, dtype=torch.int32, device=cuda_device)
    db.bec_stream_chunk_fused(
        tables, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail, st.ctr,
        st.fresh_llr, st.fresh_cw, torch.ones(1, dtype=torch.int32, device=cuda_device),
        remaining, k=3, cap=50)
    assert int(st.ctr[4].sum()) == min(quota, B) == B - int(st.avail.sum())


def test_stream_words_past_shared_memory_raise(stream_tables, monkeypatch):
    """The word form forced on a code whose words pass a block's shared
    memory raises at its launch; the refused limit is cleared, so the next
    launch, in the rule's form, succeeds and matches the plain version."""
    big = stream_tables("big")
    B = 64
    st = init_state(big, B, "BEC")
    sym, cw = frames(big, B, 0.1, seed=5)
    st.llr_in.copy_(sym)
    st.codeword.copy_(cw)
    st.done.zero_()
    zero = torch.zeros(1, dtype=torch.int32, device=sym.device)
    monkeypatch.setattr(db, "bec_stream_form", lambda tables_: "words")
    launches = db.bec_stream_chunk_fused.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        db.bec_stream_chunk_fused(big, st.llr_in, st.codeword, st.lv2c, st.done, st.iters,
                                  st.age, st.avail, st.ctr, st.fresh_llr, st.fresh_cw, zero,
                                  zero.clone(), k=2, cap=4)
    assert db.bec_stream_chunk_fused.launches == launches
    monkeypatch.undo()
    bench = stream_tables("bench1152")
    sym, cw = frames(bench, 1000, 0.42, seed=6)
    got = _drain(db.bec_stream_chunk_fused, bench, sym, cw, 6, 50, None)
    assert db.bec_stream_chunk_fused.last_form == "words"
    assert got == _drain(db.bec_stream_chunk_fused_plain, bench, sym, cw, 6, 50, None)


def test_streaming_step_max_frames_exact(cuda_device):
    tb = kernel_tables(to_sorted_device(make_benchmark_code(96, 3, 6, seed=7, with_G=True),
                                        cuda_device))
    init_fn, step_fn = make_streaming_fused_step(tb, "BEC", DecoderParams(iterations=8), 256,
                                                 max_frames=1000)
    st, n, fec = init_fn(), 0, 0
    for step in range(40):
        st, acc = step_fn(st, make_generator(cuda_device, 0, step), 0.55, True)
        n += int(acc.frames)
        fec += int(acc.frame_errors)
    assert n == 1000 == int(st.started) and fec > 0


def test_bec_simulator_on_card(cuda_device, tmp_path):
    code = make_benchmark_code(96, 3, 6, seed=7, with_G=True)
    sim = Simulator(
        code, DecoderParams(iterations=20), ChannelParams(seed=3, x_range=(0.3, 0.451, 0.05),
                                                          type="BEC"),
        SimulationParams(batch_size=512, fec=20, max_frames=50000,
                         result_file=str(tmp_path / "r.txt")),
        device=cuda_device, verbose=False,
    )
    launches = db.bec_decode_fused.launches
    res = sim.start()
    assert db.bec_decode_fused.launches > launches
    assert res.fer[0] > res.fer[-1] and (res.frames > 0).all()
    head = (tmp_path / "r.txt").read_text().splitlines()[0]
    assert head.startswith("# kernel=cuda-bec") and "schedule=flooding streaming=off" in head
