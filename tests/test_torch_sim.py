"""The slice end to end: the port's CLI against the JAX package's CLI (its
XLA path: ``--pallas`` needs a TPU) on the same small code, written to
disk as a codefile and a genfile.  The two draw different random frames,
so the sweeps are held to the same rows and columns and to FER agreement
within |z| < 3 per point (a two-proportion z-test; both runs are seeded,
so the test is deterministic)."""

import numpy as np
import pytest
import torch

from libldpc_tpu import cli as jax_cli
from libldpc_tpu_torch import cli
from libldpc_tpu_torch.models import make_benchmark_code, write_codefile, write_layerfile
from libldpc_tpu_torch.sim.driver import Simulator
from libldpc_tpu_torch.utils.params import ChannelParams, DecoderParams, SimulationParams

torch.set_num_threads(2)

SWEEP = ["1.0", "3.01", "1.0"]  # 1, 2, 3 dB
COMMON = ["-i", "12", "--frame-error-count", "20", "--batch-size", "64",
          "--max-frames", "20000", "-s", "3"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("code")
    code = make_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True)
    write_codefile(str(d / "h.txt"), code.rows, code.cols, code.nc, code.mc)
    r, c = np.nonzero(code.G)
    (d / "g.txt").write_text("".join(f"{i} {j}\n" for i, j in zip(r, c)))
    write_layerfile(str(d / "layers.txt"), [np.arange(24), np.arange(24, 48)])
    return code, d


def _read(path):
    lines = path.read_text().splitlines()
    comment = [ln for ln in lines if ln.startswith("#")]
    rows = [ln.split() for ln in lines if not ln.startswith("#")]
    return comment, rows[0], np.array(rows[1:], dtype=float)


@pytest.fixture(scope="module")
def sweeps(files):
    _, d = files
    base = [str(d / "h.txt")]
    gen = ["-G", str(d / "g.txt")]
    assert cli.main(base + [str(d / "torch.txt")] + SWEEP + gen + COMMON
                    + ["--device", "cpu", "--pallas"]) == 0
    assert jax_cli.main(base + [str(d / "jax.txt")] + SWEEP + gen + COMMON) == 0
    return _read(d / "torch.txt"), _read(d / "jax.txt")


def test_same_rows_and_columns(sweeps):
    (_, head_t, rows_t), (_, head_j, rows_j) = sweeps
    assert head_t == head_j
    assert rows_t.shape == rows_j.shape == (3, 6)
    np.testing.assert_array_equal(rows_t[:, 0], rows_j[:, 0])
    assert (rows_t[:, 3] > 0).all()


def test_fer_agrees(sweeps):
    (_, _, rows_t), (_, _, rows_j) = sweeps
    for (_, fer_t, _, n_t, _, _), (_, fer_j, _, n_j, _, _) in zip(rows_t, rows_j):
        p = (fer_t * n_t + fer_j * n_j) / (n_t + n_j)
        z = (fer_t - fer_j) / np.sqrt(p * (1 - p) * (1 / n_t + 1 / n_j))
        assert abs(z) < 3, (fer_t, n_t, fer_j, n_j)
    assert rows_t[0, 1] > rows_t[-1, 1]  # the waterfall


def test_provenance_line(sweeps):
    (comment, _, _), _ = sweeps
    assert comment == ["# kernel=torch-plain dtype=float32 cn=BP schedule=flooding streaming=on"]


def test_fixed_iterations_batch_path(files, tmp_path):
    code, _ = files
    sim = Simulator(
        code, DecoderParams(iterations=7, early_term=False, type="BP_MS"),
        ChannelParams(seed=2, x_range=(2.0, 2.1, 0.5)),
        SimulationParams(batch_size=40, max_frames=100, fec=10**6,
                         result_file=str(tmp_path / "r.txt")),
        device="cpu", verbose=False,
    )
    res = sim.start()
    assert "streaming=off" in sim.decode_path
    assert res.frames[0] == 120 and res.avg_iter[0] == 7.0  # 3 batches of 40
    assert (tmp_path / "r.txt").read_text().startswith("# kernel=torch-plain")


def test_streaming_max_frames_exact(files):
    code, _ = files
    sim = Simulator(
        code, DecoderParams(iterations=6, type="BP_MS"),
        ChannelParams(seed=2, x_range=(3.0, 3.1, 0.5)),
        SimulationParams(batch_size=32, max_frames=80, fec=10**6),
        device="cpu", verbose=False,
    )
    assert int(sim.start().frames[0]) == 80


def test_cuda_device_without_gpu_raises(files, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, d = files
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([str(d / "h.txt"), str(tmp_path / "r.txt")] + SWEEP + ["--device", "cuda"])


CHECKPOINT = '"Checkpoint/resume and the forensic error log"'


@pytest.mark.parametrize("flags,item", [
    (["--checkpoint", "c.json"], CHECKPOINT), (["--error-log", "e.txt"], CHECKPOINT),
    (["--points-parallel", "2"], '"Multi-GPU"'), (["--multihost"], '"Multi-GPU"'),
    (["--devices", "2"], '"Multi-GPU"'), (["--log-codewords"], CHECKPOINT),
])
def test_refuses_unported_flags(files, tmp_path, capsys, flags, item):
    _, d = files
    flags = [f.format(d=d) for f in flags]
    argv = [str(d / "h.txt"), str(tmp_path / "r.txt")] + SWEEP + flags + ["--device", "cpu"]
    assert cli.main(argv) == 2
    assert item in capsys.readouterr().err
    assert not (tmp_path / "r.txt").exists()
