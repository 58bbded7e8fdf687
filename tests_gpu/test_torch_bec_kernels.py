"""The BEC peeling kernels (batch and streaming) against their plain
PyTorch versions, on the card, on the same inputs.  The algebra is
integer, so every output must be equal, byte for byte: posterior symbols,
decisions, iteration counts, resolution flags and drained counters."""

import numpy as np
import pytest
import torch

from libldpc_tpu_torch.models import LDPCCode, make_benchmark_code, wifi_code
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


@pytest.mark.parametrize("stale", [None, 0])
@pytest.mark.parametrize("B", [B_FULL, 1000])
def test_stream_kernel_drains_like_plain_and_batch(tables, cuda_device, B, stale):
    sym, cw = frames(tables, B, 0.42, seed=3)
    launches = db.bec_stream_chunk_fused.launches
    got = _drain(db.bec_stream_chunk_fused, tables, sym, cw, 6, 50, stale)
    assert db.bec_stream_chunk_fused.launches > launches
    want = _drain(db.bec_stream_chunk_fused_plain, tables, sym, cw, 6, 50, stale)
    assert got == want and got[2] == got[4] == B
    out = db.bec_decode_fused(tables, sym, cw, 50, True, stale)
    bp = tables.code.bit_pos.long()
    errs = (out.hard[bp] != cw[bp]).sum(0)
    assert got[:4] == [int(errs.sum()), int((errs > 0).sum()), B, int(out.iterations.sum())]


@pytest.mark.parametrize("quota", [0, 37, 5000, 20000])
def test_stream_kernel_quota_exact(tables, cuda_device, quota):
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
