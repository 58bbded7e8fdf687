"""The layered sweep end to end on the CPU: the fast engine's streaming
chunk (plain version) against the plain batch decode of the same frames,
the streaming step on the fast engine, and the port's CLI with
``--layer-file`` / ``--qc-z`` against the JAX package's CLI.

Drain equivalence: frames injected into the streams (``refill=False``)
drain to the same ``[bit_errors, frame_errors, frames, iter_sum]`` as the
batch decode of the same frames, exactly: each frame runs the same
arithmetic in both.  The CLIs draw different random frames, so the sweeps
are held to FER agreement within |z| < 3 per point (a two-proportion
z-test; both runs are seeded, so the test is deterministic)."""

import numpy as np
import pytest
import torch

from libldpc_tpu import cli as jax_cli
from libldpc_tpu.utils.params import DecoderParams
from libldpc_tpu_torch import cli
from libldpc_tpu_torch.models import parse_layerfile, wifi_code, write_codefile, write_layerfile
from libldpc_tpu_torch.ops.channel import make_generator
from libldpc_tpu_torch.ops.kernels import decode_layered as dl
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.ops.sorted import to_sorted_device
from libldpc_tpu_torch.ops.streaming_fused import make_streaming_fused_step

from test_torch_sim import _read
from test_torch_streaming import drain, frames

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def wifi1944():
    code = wifi_code(1944)
    return code, kernel_tables(to_sorted_device(code, "cpu", with_layers=True))


@pytest.mark.parametrize("snr,iters,k", [(1.0, 12, 5), (2.0, 7, 3)])
@pytest.mark.parametrize("form", ["BP", "BP_MS"])
def test_drain_matches_fast_batch_decode(wifi1944, snr, iters, k, form):
    code, tables = wifi1944
    B = 16
    llr, cw = frames(code, tables.code.vn_perm, B, snr, seed=3)
    out = dl.bp_decode_layered_fast(tables, torch.from_numpy(llr), iters, True, form)
    bit_pos = tables.code.bit_pos.numpy()
    errs = (out.hard.numpy()[bit_pos] != cw[bit_pos]).sum(axis=0)
    want = [errs.sum(), (errs > 0).sum(), B, out.iterations.sum().item()]

    dec = DecoderParams(iterations=iters, type=form)
    init_fn, step_fn = make_streaming_fused_step(tables, "AWGN", dec, B, chunk_iters=k,
                                                 layered=True)
    state = init_fn()
    state.llr_in.copy_(torch.from_numpy(llr))  # the APP plane: the injected frames' LLRs
    state.codeword.copy_(torch.from_numpy(cw))
    state.done.zero_()  # injected in flight at age 0: the engine starts them
    np.testing.assert_array_equal(drain(step_fn, state), want)


def test_layered_streams_quota_exact_and_recycle(wifi1944):
    _, tables = wifi1944
    dec = DecoderParams(iterations=6, type="BP_MS")
    for quota, steps in ((40, 6), (int(10e9), 3)):
        init_fn, step_fn = make_streaming_fused_step(tables, "AWGN", dec, 16, max_frames=quota,
                                                     layered=True)
        state, n_frames = init_fn(), 0
        for step in range(steps):
            state, acc = step_fn(state, make_generator("cpu", 1, step), 2.5, True)
            n_frames += int(acc.frames)
        if quota == 40:
            assert int(state.started) == n_frames == 40 and int((state.done == 0).sum()) == 0
        else:
            assert n_frames > 2 * 16  # lanes reload after their frames finish


def test_write_layerfile_roundtrip(tmp_path):
    layers = wifi_code(648).layers
    write_layerfile(str(tmp_path / "l.txt"), layers)
    back = parse_layerfile(str(tmp_path / "l.txt"))
    assert len(back) == len(layers) and all(np.array_equal(a, b) for a, b in zip(back, layers))


def _write_code(d, code):
    write_codefile(str(d / "h.txt"), code.rows, code.cols, code.nc, code.mc)
    r, c = np.nonzero(code.G)
    (d / "g.txt").write_text("".join(f"{i} {j}\n" for i, j in zip(r, c)))
    write_layerfile(str(d / "l.txt"), code.layers)
    return [str(d / "h.txt")], ["-G", str(d / "g.txt"), "--layer-file", str(d / "l.txt")]


SWEEP = ["1.0", "2.01", "0.5"]  # 1.0, 1.5, 2.0 dB
COMMON = ["-i", "8", "--decoding", "BP_MS", "--frame-error-count", "20", "--batch-size", "128",
          "--max-frames", "640", "-s", "3"]


def test_cli_wifi648_layered_fer_matches_jax(tmp_path):
    """802.11n n=648 with its natural layers: the port (``--pallas``, which
    keeps Z = 27 on the exact schedule) against the JAX CLI's XLA exact
    layered decoder."""
    base, flags = _write_code(tmp_path, wifi_code(648))
    assert cli.main(base + [str(tmp_path / "torch.txt")] + SWEEP + flags + COMMON
                    + ["--device", "cpu", "--pallas"]) == 0
    assert jax_cli.main(base + [str(tmp_path / "jax.txt")] + SWEEP + flags + COMMON) == 0
    (comment, head_t, rows_t), (_, head_j, rows_j) = _read(tmp_path / "torch.txt"), _read(
        tmp_path / "jax.txt")
    assert comment == ["# kernel=torch-plain dtype=float32 cn=BP_MS schedule=layered streaming=off"]
    assert head_t == head_j and rows_t.shape == rows_j.shape == (3, 6)
    for (_, fer_t, _, n_t, _, _), (_, fer_j, _, n_j, _, _) in zip(rows_t, rows_j):
        p = (fer_t * n_t + fer_j * n_j) / (n_t + n_j)
        z = (fer_t - fer_j) / np.sqrt(p * (1 - p) * (1 / n_t + 1 / n_j))
        assert abs(z) < 3, (fer_t, n_t, fer_j, n_j)
    assert rows_t[0, 1] > rows_t[-1, 1]


def test_cli_wifi1944_fast_engine_streams(tmp_path, capsys):
    """``--pallas --layer-file --qc-z auto`` on the 802.11n n=1944 code runs
    the fast engine's streaming sweep, as the JAX CLI does."""
    base, flags = _write_code(tmp_path, wifi_code(1944))
    argv = base + [str(tmp_path / "r.txt"), "2.0", "2.01", "1"] + flags + [
        "--qc-z", "auto", "-i", "8", "--frame-error-count", "3", "--batch-size", "32",
        "--max-frames", "96", "--device", "cpu", "--pallas"]
    assert cli.main(argv) == 0
    assert "QC structure detected: Z = 81" in capsys.readouterr().out
    comment, _, rows = _read(tmp_path / "r.txt")
    assert comment == ["# kernel=torch-plain dtype=float32 cn=BP schedule=layered-fast streaming=on"]
    assert rows[0, 3] > 0 and 0 < rows[0, 4] <= 8


def test_cli_qc_z_rejects_non_qc(tmp_path):
    base, flags = _write_code(tmp_path, wifi_code(648))
    with pytest.raises(ValueError):
        cli.main(base + [str(tmp_path / "r.txt"), "2.0", "2.01", "1"] + flags
                 + ["--qc-z", "54", "--device", "cpu"])
