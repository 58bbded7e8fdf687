"""The M-ASK path and the widened sub-32-bit routing on the card.

The modulated channel is plain PyTorch on the device (no kernel): its
bitwise LLRs on the card against the same computation on the CPU, and the
M = 2 constellation against the BPSK channel from one generator.  Its LLRs
then enter the kernels as they are: K1, K3 and K5 on them against their
plain versions (min-sum bit-exact), K2 and K4 drained from a modulated
pool against their plain chunks (min-sum counters equal).  The front ends
launch their kernels: the ``sim_cuda`` command line (K2; with ``-layer``
K5), ``LDPC.simulate(modulation=...)`` on the fast layered engine (K4), and
a bfloat16 sweep of a (3,6) code of 36000 edges, which the port once
refused, on K2's bfloat16 form, which drains that code's pools as its
plain chunk does."""

import numpy as np
import pytest
import torch

from libldpc_tpu_torch import LDPC, cli, sim_cuda
from libldpc_tpu_torch.models import (
    make_benchmark_code, make_regular_code, wifi_code, write_codefile, write_layerfile,
)
from libldpc_tpu_torch.ops import channel, modulation as mod
from libldpc_tpu_torch.ops.kernels import decode_fused as df
from libldpc_tpu_torch.ops.kernels import decode_layered as dl
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.ops.sorted import to_sorted_device
from libldpc_tpu_torch.ops.streaming_fused import init_state

pytestmark = pytest.mark.cuda

GRAY = {2: [1, 0], 4: [0, 1, 3, 2], 8: [0, 1, 3, 2, 6, 7, 5, 4],
        16: [i ^ (i >> 1) for i in range(16)]}


def _modulated(tables, M, snr, B, seed=1):
    """A modulated channel batch on the tables' device, the transmitted
    bits mapped consecutively (sorted labels)."""
    sdc = tables.code
    bits = int(np.log2(M))
    tx = sdc.bit_pos.long()
    mapper = tx[: tx.numel() // bits * bits].reshape(-1, bits).T.contiguous()
    return channel.simulate_channel(sdc, "AWGN", channel.make_generator(sdc.device, seed, 0, 0),
                                    B, snr, modulation=(mod.Constellation.mask(M, GRAY[M]), mapper))


@pytest.mark.parametrize("M", [2, 4, 8, 16])
def test_llrs_on_the_card_match_the_cpu(cuda_device, M):
    cstl = mod.Constellation.mask(M, GRAY[M])
    rng = np.random.default_rng(M)
    for sigma2 in (0.5, 0.02, 0.001):
        y = (cstl.points[rng.integers(0, M, (300, 257))]
             + rng.normal(size=(300, 257)) * np.sqrt(sigma2)).astype(np.float32)
        got = mod.bitwise_llrs(cstl, torch.from_numpy(y).to(cuda_device), np.float32(sigma2))
        want = mod.bitwise_llrs(cstl, torch.from_numpy(y), np.float32(sigma2))
        torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=1e-4)


def test_bpsk_constellation_equals_awgn_on_the_card(cuda_device):
    sdc = to_sorted_device(make_benchmark_code(1152, 3, 6, seed=0, with_G=True), cuda_device)
    cstl = mod.Constellation.mask(2, labels=[1, 0])
    for snr in (1.5, 3.0):
        out_m = channel.modulated_awgn_channel(
            sdc, channel.make_generator(cuda_device, 5, 1), 4096, snr, cstl,
            sdc.bit_pos.reshape(1, -1))
        out_b = channel.awgn_channel(sdc, channel.make_generator(cuda_device, 5, 1), 4096, snr)
        assert torch.equal(out_m.codeword, out_b.codeword)
        torch.testing.assert_close(out_m.llr, out_b.llr, rtol=1e-4, atol=2e-2)


#: kernel -> (code, M, SNR, kernel, its plain version)
BATCH_CASES = {
    "K1": (lambda: make_benchmark_code(1152, 3, 6, seed=0, with_G=True), 4, 7.5,
           df.bp_decode_fused, df.bp_decode_fused_plain),
    "K3": (lambda: wifi_code(1944), 16, 17.0, dl.bp_decode_layered_fast,
           dl.bp_decode_layered_fast_plain),
    "K5": (lambda: wifi_code(1944), 8, 12.0, dl.bp_decode_layered, dl.bp_decode_layered_plain),
}


@pytest.mark.parametrize("form", ["BP_MS", "BP"])
@pytest.mark.parametrize("name", list(BATCH_CASES))
def test_batch_kernels_on_modulated_llrs(cuda_device, name, form):
    make, M, snr, kernel, plain = BATCH_CASES[name]
    tb = kernel_tables(to_sorted_device(make(), cuda_device, with_layers=name != "K1"))
    ch = _modulated(tb, M, snr, 301)
    got, want = kernel(tb, ch.llr, 20, True, form), plain(tb, ch.llr, 20, True, form)
    same = (got.hard == want.hard).all(0) & (got.iterations == want.iterations)
    if form == "BP_MS":
        assert bool(same.all()) and torch.equal(got.llr_out, want.llr_out)
    else:
        assert same.float().mean().item() >= 0.99
        torch.testing.assert_close(got.llr_out[:, same], want.llr_out[:, same], rtol=1e-4,
                                   atol=1e-4)
    tx = tb.code.bit_pos.long()
    assert ((got.hard[tx] != ch.codeword[tx].bool()).sum(0) == 0).float().mean() > 0.5


def _pool_drain(chunk, tb, ch, form, dtype="float32"):
    """Every frame of a pool started and decoded to the end; the summed
    counters."""
    B = ch.llr.shape[1]
    st = init_state(tb, B, message_dtype=dtype)
    st.fresh_llr.copy_(ch.llr)
    st.fresh_cw.copy_(ch.codeword)
    st.avail.fill_(1)
    refill = torch.ones(1, dtype=torch.int32, device=tb.device)
    remaining = torch.full((1,), B, dtype=torch.int32, device=tb.device)
    for _ in range(60):
        chunk(tb, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail, st.ctr,
              st.fresh_llr, st.fresh_cw, refill, remaining, k=6, cap=20, minsum_mode=form,
              message_dtype=dtype)
        if int((st.done == 0).sum()) == 0 and int(st.avail.sum()) == 0:
            return st.ctr.sum(1).tolist()
    raise AssertionError("the streams did not drain")


@pytest.mark.parametrize("name", ["K2", "K4"])
def test_stream_chunks_drain_modulated_pools_like_plain(cuda_device, name):
    if name == "K2":
        tb = kernel_tables(to_sorted_device(make_benchmark_code(1152, 3, 6, seed=0, with_G=True),
                                            cuda_device))
        ch, pair = _modulated(tb, 4, 7.5, 2048), (df.bp_stream_chunk_fused,
                                                   df.bp_stream_chunk_fused_plain)
    else:
        tb = kernel_tables(to_sorted_device(wifi_code(1944), cuda_device, with_layers=True))
        ch, pair = _modulated(tb, 16, 17.0, 2048), (dl.bp_stream_chunk_layered_fast,
                                                     dl.bp_stream_chunk_layered_fast_plain)
    got, want = (_pool_drain(fn, tb, ch, "BP_MS") for fn in pair)
    assert got == want and got[2] == got[4] == 2048


def _files(tmp_path, code, M, layers=False):
    h = tmp_path / "h.txt"
    write_codefile(str(h), code.rows, code.cols, code.nc, code.mc)
    r, c = code.G.nonzero()
    (tmp_path / "g.txt").write_text("".join(f"{i} {j}\n" for i, j in zip(r, c)))
    bits = int(np.log2(M))
    (tmp_path / "map.txt").write_text(
        ", ".join(map(str, code.bit_pos[mod.default_bit_mapper(bits, code.nct // bits)].ravel())))
    argv = ["-code", str(h), "-map", str(tmp_path / "map.txt"), "-G", str(tmp_path / "g.txt"),
            "-threads", "1024", "-seed", "2"]
    if layers:
        write_layerfile(str(tmp_path / "l.txt"), code.layers)
        argv += ["-layer", str(tmp_path / "l.txt")]
    return argv


def _simfile(tmp_path, M, snrs, iters=20):
    (tmp_path / "sim.txt").write_text(
        f"name: {tmp_path / 'res.txt'}\nM: {M}\nbits: {int(np.log2(M))}\n"
        f"labels: {' '.join(map(str, GRAY[M]))}\nsnrs: {' '.join(map(str, snrs))}\n"
        f"max frames: 20480\nmin fec: 20\nbp iter: {iters}\nearly term: 1\n")
    return ["-sim", str(tmp_path / "sim.txt")]


@pytest.mark.parametrize("layered", [False, True], ids=["flooding-K2", "layered-K5"])
def test_sim_cuda_runs_its_kernel(cuda_device, tmp_path, layered):
    code = wifi_code(1944) if layered else make_benchmark_code(1152, 3, 6, seed=0, with_G=True)
    M, snrs = (8, (11.5, 12.5)) if layered else (4, (7.0, 7.5))
    kernel = dl.bp_decode_layered if layered else df.bp_stream_chunk_fused
    before = kernel.launches["float32"]
    assert sim_cuda.main(_files(tmp_path, code, M, layered) + _simfile(tmp_path, M, snrs)) == 0
    assert kernel.launches["float32"] > before
    lines = (tmp_path / "res.txt").read_text().splitlines()
    schedule = "layered streaming=off" if layered else "flooding streaming=on"
    assert lines[0].startswith(f"# kernel=cuda-fused dtype=float32 cn=BP schedule={schedule}")
    rows = np.array([ln.split() for ln in lines[2:]], dtype=float)
    assert rows.shape[0] == 2 and list(rows[:, 0]) == list(snrs)
    assert np.isfinite(rows).all() and rows[0, 1] >= rows[1, 1]


def test_ldpc_simulate_modulated_runs_k4(cuda_device):
    code = wifi_code(1944)
    ldpc = LDPC(code=code, device=cuda_device)
    mapping = (mod.Constellation.mask(16, GRAY[16]),
               code.bit_pos[mod.default_bit_mapper(4, code.nct // 4)])
    before = dl.bp_stream_chunk_layered_fast.launches["float32"]
    ldpc.simulate(blocking=True, snr=[16.5, 17.01, 0.5], fec=20, batchSize=2048, iterations=20,
                  maxFrames=40960, usePallas=True, layered=True, modulation=mapping)
    assert dl.bp_stream_chunk_layered_fast.launches["float32"] > before
    got = ldpc.get_results()
    assert len(got["frames"]) == 2 and (got["frames"] > 0).all()
    assert "schedule=layered-fast streaming=on" in ldpc._simulator.decode_path


def test_formerly_refused_bf16_code_runs_k2_bf16(cuda_device, tmp_path):
    """36000 edges (past the 32768 the port once refused): bfloat16 on the
    Clos lanes in the JAX routing, so K2 runs its bfloat16 form, in the
    size rule's form; drained from a pool of that code, it counts what the
    plain chunk counts (min-sum equal, BP within what 0.1 % of the frames
    can change)."""
    code = make_regular_code(12000, 3, 6, seed=0)
    write_codefile(str(tmp_path / "h.txt"), code.rows, code.cols, code.nc, code.mc)
    before = df.bp_stream_chunk_fused.launches["bfloat16"]
    argv = [str(tmp_path / "h.txt"), str(tmp_path / "r.txt"), "1.5", "1.76", "0.25", "--pallas",
            "--message-dtype", "bfloat16", "-i", "20", "--batch-size", "2048",
            "--frame-error-count", "20", "--max-frames", "40960"]
    assert cli.main(argv) == 0
    assert df.bp_stream_chunk_fused.launches["bfloat16"] > before
    head = (tmp_path / "r.txt").read_text().splitlines()[0]
    assert head.startswith("# kernel=cuda-fused dtype=bfloat16 cn=BP schedule=flooding "
                           "streaming=on") and "fallback" not in head
    tb = kernel_tables(to_sorted_device(code, cuda_device))
    assert df.bp_stream_chunk_fused.last_form == df.stream_form(tb, "bfloat16")
    B = 2048
    ch = channel.awgn_channel(tb.code, channel.make_generator(cuda_device, 3, 0, 0), B, 1.5)
    for form in ("BP_MS", "BP"):
        got, want = (_pool_drain(fn, tb, ch, form, "bfloat16")
                     for fn in (df.bp_stream_chunk_fused, df.bp_stream_chunk_fused_plain))
        assert got[2] == got[4] == want[2] == want[4] == B
        if form == "BP_MS":
            assert got == want
        else:
            room = B // 1000  # frames that may decide otherwise
            assert abs(got[0] - want[0]) <= room * code.nc and abs(got[1] - want[1]) <= room
            assert abs(got[3] - want[3]) <= room * 20
