"""The CUDA decode kernels against their plain PyTorch versions, on the
card, on the same inputs, in each message form (float32, bfloat16, the
int8 lattice; int8 with the min-sum family only).  Min-sum forms are
bit-exact (the kernel is built with -fmad=false and follows the plain
versions' operation order); BP is held to identical decisions and
iteration counts on >= 99.9% of frames and 1e-4 (float32) or one bf16
step (bfloat16) on their posteriors."""

import numpy as np
import pytest
import torch

from libldpc_tpu_torch.models import make_benchmark_code
from libldpc_tpu_torch.ops.kernels import decode_fused as df
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.ops.sorted import to_sorted_device
from libldpc_tpu_torch.ops.streaming_fused import init_state, make_streaming_fused_step
from libldpc_tpu_torch.sim.driver import DecoderParams, Simulator, ChannelParams, SimulationParams

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def code():
    return make_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True)


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


MINSUM = ["BP_MS", ("BP_NMS", 0.75, 0.15), ("BP_OMS", 0.75, 0.15)]
FORMS = MINSUM + ["BP", "BP_PHI", "BP_TANH", "BP_LIN"]
#: (message dtype, CN form): every form in float32 and bfloat16, the
#: min-sum family on the int8 lattice
DTYPE_FORMS = ([("float32", f) for f in FORMS] + [("bfloat16", f) for f in FORMS]
               + [("int8", f) for f in MINSUM])


@pytest.mark.parametrize("B", [300, 64])
@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("dtype,form", DTYPE_FORMS)
def test_batch_kernel_matches_plain(code, cuda_device, dtype, form, early_term, B):
    tables = kernel_tables(to_sorted_device(code, cuda_device))
    llr, _ = frames(code, tables.code.vn_perm.cpu(), B, 1.5, seed=9)
    x = torch.from_numpy(llr).to(cuda_device)
    launches = df.bp_decode_fused.launches[dtype]
    got = df.bp_decode_fused(tables, x, 12, early_term, form, dtype)
    want = df.bp_decode_fused_plain(tables, x, 12, early_term, form, dtype)
    torch.cuda.synchronize()
    assert df.bp_decode_fused.launches[dtype] == launches + 1
    same = (got.hard == want.hard).all(0) & (got.iterations == want.iterations)
    if form in MINSUM:
        assert same.all() and torch.equal(got.llr_out, want.llr_out)
        assert torch.equal(got.is_codeword, want.is_codeword)
    else:
        tol = 1e-4 if dtype == "float32" else 2 ** -8
        assert same.float().mean() >= 0.999
        torch.testing.assert_close(got.llr_out[:, same], want.llr_out[:, same],
                                   rtol=tol, atol=tol)


def test_zero_iterations_launches_nothing(code, cuda_device):
    tables = kernel_tables(to_sorted_device(code, cuda_device))
    launches = dict(df.bp_decode_fused.launches)
    out = df.bp_decode_fused(tables, torch.ones(code.nc, 5, device=cuda_device), 0)
    assert df.bp_decode_fused.launches == launches and not out.is_codeword.any()


def test_device_mismatch_raises(code, cuda_device):
    tables = kernel_tables(to_sorted_device(code, cuda_device))
    with pytest.raises(ValueError, match="is on cpu"):
        df.bp_decode_fused(tables, torch.zeros(code.nc, 4), 5)


@pytest.mark.parametrize("dtype,form", [("float32", "BP_MS"), ("float32", "BP"),
                                        ("bfloat16", "BP_MS"), ("bfloat16", "BP"),
                                        ("int8", "BP_MS"), ("int8", ("BP_OMS", 0.75, 0.15))])
@pytest.mark.parametrize("via_pool", [False, True])
def test_stream_kernel_drains_like_plain(code, cuda_device, dtype, form, via_pool):
    """Frames injected (age 0, a warm-up pass) or started from a full pool
    by the kernel's reload; min-sum totals exact, BP's too at this seed."""
    tables = kernel_tables(to_sorted_device(code, cuda_device))
    B = 300
    llr, cw = frames(code, tables.code.vn_perm.cpu(), B, 1.0, seed=4)
    zero = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    totals = []
    for fn in (df.bp_stream_chunk_fused, df.bp_stream_chunk_fused_plain):
        st = init_state(tables, B, message_dtype=dtype)
        if via_pool:
            st.fresh_llr.copy_(torch.from_numpy(llr))
            st.fresh_cw.copy_(torch.from_numpy(cw))
            st.avail.fill_(1)
        else:
            st.llr_in.copy_(torch.from_numpy(llr))
            st.codeword.copy_(torch.from_numpy(cw))
            st.done.zero_()
        refill = torch.full((1,), int(via_pool), dtype=torch.int32, device=cuda_device)
        remaining = torch.full((1,), B, dtype=torch.int32, device=cuda_device)
        for _ in range(10):
            fn(tables, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail,
               st.ctr, st.fresh_llr, st.fresh_cw, refill, remaining, k=5, cap=12,
               minsum_mode=form, message_dtype=dtype)
        totals.append(st.ctr.sum(1).tolist())
    assert totals[0] == totals[1] and totals[0][2] == B


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("quota", [0, 48, 299, 1000])
def test_stream_kernel_quota_exact(code, cuda_device, quota, dtype):
    tables = kernel_tables(to_sorted_device(code, cuda_device))
    B = 300
    llr, cw = frames(code, tables.code.vn_perm.cpu(), B, 2.0, seed=1)
    st = init_state(tables, B, message_dtype=dtype)
    st.fresh_llr.copy_(torch.from_numpy(llr))
    st.fresh_cw.copy_(torch.from_numpy(cw))
    st.avail.fill_(1)
    remaining = torch.full((1,), quota, dtype=torch.int32, device=cuda_device)
    df.bp_stream_chunk_fused(
        tables, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail, st.ctr,
        st.fresh_llr, st.fresh_cw, torch.ones(1, dtype=torch.int32, device=cuda_device),
        remaining, k=3, cap=12, minsum_mode="BP_MS", message_dtype=dtype,
    )
    assert df.bp_stream_chunk_fused.launches[dtype] > 0
    assert int(st.ctr[4].sum()) == min(quota, B) == B - int(st.avail.sum())


def test_streaming_step_max_frames_exact(code, cuda_device):
    tables = kernel_tables(to_sorted_device(code, cuda_device))
    init_fn, step_fn = make_streaming_fused_step(
        tables, "AWGN", DecoderParams(iterations=8), 256, max_frames=1000)
    from libldpc_tpu_torch.ops.channel import make_generator
    st, n = init_fn(), 0
    for step in range(40):
        st, acc = step_fn(st, make_generator(cuda_device, 0, step), 2.0, True)
        n += int(acc.frames)
    assert n == 1000 == int(st.started)


@pytest.mark.parametrize("dtype,form", [("float32", "BP"), ("bfloat16", "BP"),
                                        ("int8", "BP_OMS")])
def test_simulator_on_card(code, cuda_device, tmp_path, dtype, form):
    sim = Simulator(
        code, DecoderParams(iterations=10, type=form, message_dtype=dtype),
        ChannelParams(seed=3, x_range=(1.0, 3.01, 1.0)),
        SimulationParams(batch_size=512, fec=20, max_frames=50000,
                         result_file=str(tmp_path / "r.txt")),
        device=cuda_device, verbose=False, use_pallas=True,
    )
    launches = df.bp_stream_chunk_fused.launches[dtype]
    res = sim.start()
    assert df.bp_stream_chunk_fused.launches[dtype] > launches
    assert res.fer[0] > res.fer[-1] and (res.frames > 0).all()
    assert (tmp_path / "r.txt").read_text().startswith(
        f"# kernel=cuda-fused dtype={dtype} cn={form}")
