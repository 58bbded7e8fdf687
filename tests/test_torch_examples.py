"""The six ``examples/torch_*.py`` scripts, each run through its
``main(argv)`` at a tiny size on the CPU (batch 64, one SNR point, a few
hundred frames): the rows they print, what they import, and
``basic_sweep``'s FER against the JAX ``Simulator`` at the same point
(|z| < 3, a two-proportion z-test; both runs are seeded)."""

import ast
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from libldpc_tpu import ChannelParams as JaxChannel
from libldpc_tpu import DecoderParams as JaxDecoder
from libldpc_tpu import SimulationParams as JaxSimulation
from libldpc_tpu import Simulator as JaxSimulator
from libldpc_tpu import make_benchmark_code as jax_benchmark_code

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ["basic_sweep", "multihost_sweep", "pyldpc_style", "qc_code_sweep",
            "wide_streaming_sweep", "wifi_sweep"]
TINY = ["--device", "cpu", "--max-frames", "256"]


def _path(name):
    return os.path.join(REPO, "examples", f"torch_{name}.py")


def _load(name):
    spec = importlib.util.spec_from_file_location(f"torch_{name}_example", _path(name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _fers(text):
    return [float(v) for v in re.findall(r"FER (\S+)", text)]


def test_every_example_has_a_port_counterpart():
    jax_examples = sorted(f[:-3] for f in os.listdir(os.path.join(REPO, "examples"))
                          if f.endswith(".py") and not f.startswith("torch_"))
    assert jax_examples == EXAMPLES


@pytest.mark.parametrize("name", EXAMPLES)
def test_imports_only_the_port(name):
    with open(_path(name)) as f:
        tree = ast.parse(f.read())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert any(m.startswith("libldpc_tpu_torch") for m in mods)
    bad = [m for m in mods if m.split(".")[0] in ("jax", "libldpc_tpu")]
    assert not bad, bad
    src = open(_path(name)).read()
    assert re.search(r'add_argument\("--device", default="cuda"', src)


@pytest.fixture(scope="module")
def basic(tmp_path_factory):
    out = tmp_path_factory.mktemp("basic") / "res.txt"
    return _load("basic_sweep").main(
        TINY + ["--batch-size", "64", "--snr", "1.5", "1.6", "1.0",
                "--result-file", str(out)]), out


def test_basic_sweep(basic, capsys):
    sim, out = basic
    res = sim.results
    assert sim.engine == "xla-superstep" and sim.code.nc == 1152
    assert list(res.x_values) == [1.5] and int(res.frames[0]) == 256
    assert 0.0 <= res.fer[0] <= 1.0
    assert out.read_text().splitlines()[-1].split()[0] == "1.500000"


def test_basic_sweep_prints_its_rows(tmp_path, capsys):
    _load("basic_sweep").main(TINY + ["--batch-size", "64", "--snr", "2.5", "2.6", "1.0",
                                      "--max-frames", "128", "--result-file", ""])
    text = capsys.readouterr().out
    assert "N : 1152" in text
    rows = [ln for ln in text.splitlines() if ln.startswith("SNR ")]
    assert len(rows) == 1 and rows[0].endswith("(128 frames)")
    assert all(0.0 <= v <= 1.0 for v in _fers(rows[0]))


def test_basic_sweep_fer_agrees_with_jax(basic):
    sim, _ = basic
    jax = JaxSimulator(
        jax_benchmark_code(1152, 3, 6, seed=0, with_G=True),
        JaxDecoder(iterations=50, type="BP"),
        JaxChannel(seed=0, x_range=(1.5, 1.6, 1.0), type="AWGN"),
        JaxSimulation(batch_size=64, fec=100, max_frames=256),
        verbose=False,
    ).start()
    f_t, n_t = sim.results.fer[0], sim.results.frames[0]
    f_j, n_j = jax.fer[0], jax.frames[0]
    p = (f_t * n_t + f_j * n_j) / (n_t + n_j)
    z = (f_t - f_j) / np.sqrt(p * (1 - p) * (1 / n_t + 1 / n_j))
    assert 0.0 < p < 1.0 and abs(z) < 3, (f_t, n_t, f_j, n_j)


def test_pyldpc_style(capsys, monkeypatch):
    # the threaded sweep is waited for before the polls, so that what they
    # read does not depend on the machine's load
    from libldpc_tpu_torch.api import LDPC

    simulate = LDPC.simulate

    def simulate_then_wait(self, *args, **kwargs):
        simulate(self, *args, **kwargs)
        self.wait(timeout=300)

    monkeypatch.setattr(LDPC, "simulate", simulate_then_wait)
    out = _load("pyldpc_style").main(
        TINY + ["--batch-size", "64", "--snr", "1.5", "1.6", "1.0", "--max-frames", "64",
                "--polls", "1", "--poll-seconds", "0.1", "--decode-snr", "3.0"])
    text = capsys.readouterr().out
    assert out["rank"] == 576 and "rank(H) = 576" in text
    final = out["ldpc"].get_results()
    assert list(final["frames"]) == [64] and 0.0 <= final["fer"][0] <= 1.0
    assert "live:" in text and "final:" in text
    # one seeded frame at 3 dB decodes without a bit error
    assert out["bit_errors"] == 0 and 1 <= out["iterations"] <= 50
    assert "bit errors: 0" in text


def test_qc_code_sweep(capsys):
    sim = _load("qc_code_sweep").main(TINY + ["--batch-size", "64", "--snr", "1.0", "1.1", "1.0"])
    text = capsys.readouterr().out
    assert "decode path: kernel=torch-plain dtype=float32" in text
    assert sim.engine == "xla-superstep" and sim.code.nc == 1536
    rows = [ln for ln in text.splitlines() if ln.startswith("SNR ")]
    assert len(rows) == 1 and 0.0 <= _fers(rows[0])[0] <= 1.0
    assert 0 < sim.results.frames[0] <= 256


def test_wifi_sweep(capsys):
    sim = _load("wifi_sweep").main(TINY + ["--batch-size", "64", "--snr", "2.0", "2.1", "1.0"])
    text = capsys.readouterr().out
    assert "QC: Z=81, 12 natural layers" in text
    # the CPU keeps float32 without --pallas: the exact layered schedule
    assert (sim.schedule, sim.message_dtype, sim.engine) == ("layered", "float32", "batch")
    rows = [ln for ln in text.splitlines() if re.match(r"\s+2\.0 dB", ln)]
    assert len(rows) == 1 and 0.0 <= _fers(rows[0])[0] <= 1.0


def test_wide_streaming_sweep(capsys):
    sim = _load("wide_streaming_sweep").main(
        TINY + ["--batch-per-device", "64", "--snr", "1.5", "1.6", "1.0"])
    text = capsys.readouterr().out
    rows = [ln for ln in text.splitlines() if ln.startswith("SNR ")]
    assert len(rows) == 1 and 0.0 <= _fers(rows[0])[0] <= 1.0
    assert sim.engine == "xla-superstep"
    assert [int(f) for f in sim.results.frames] == [256]


def test_multihost_sweep_as_one_rank(tmp_path, monkeypatch, capsys):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    out = tmp_path / "res.txt"
    sim = _load("multihost_sweep").main(
        TINY + ["--batch-per-device", "64", "--snr", "1.5", "1.6", "1.0",
                "--result-file", str(out)])
    text = capsys.readouterr().out
    assert "'process_count': 1" in text and sim.mesh.size == 1
    res = ast.literal_eval(text.strip().splitlines()[-1])  # the results dict, printed last
    assert res["frames"] == [256] and 0.0 <= res["fer"][0] <= 1.0
    assert out.exists()
