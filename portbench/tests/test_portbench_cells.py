"""On the card: the reference's frames are the program's draw, each cell
runs for a second with ``correct`` true, the control (the reference with
its messages stored in bfloat16) comes out not correct, and so does a run
whose timed path is broken underneath.

Run on a machine with one H100, from the repo root:
``python -m pytest portbench/tests -q -m cuda``
"""

import copy
import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness, spec
from portbench.codes import build_code
from portbench.reference.channel import FrameSource

ROOT = spec.ROOT
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
SEEDS = [2**31 + 17, 977, 123456789]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bench1152-bp", "wifi1944-bp"])
def test_reference_frames_are_the_programs_draw(cuda_device, name):
    """K8's full batch on a key (its debug planes: each lane's info words
    and each item's normal) against the reference's frames on that key."""
    from libldpc_tpu_torch.models import LDPCCode
    from libldpc_tpu_torch.ops.kernels.pool_refill import channel_batch, pool_tables
    from libldpc_tpu_torch.ops.sorted import to_sorted_device

    code = build_code(json.loads((spec.HERE / "configs" / f"{name}.json").read_text())["code"])
    pcode = LDPCCode(rows=code.rows.astype(np.int32), cols=code.cols.astype(np.int32),
                     nc=code.nc, mc=code.mc, G=code.G)
    sdc = to_sorted_device(pcode, cuda_device)
    pt = pool_tables(sdc, "AWGN")
    B, key = 4096, 0x2545F4914F6CDD1D
    kt = torch.tensor([key], dtype=torch.int64, device=cuda_device)
    debug = torch.zeros((code.nc, B), dtype=torch.float32, device=cuda_device)
    info = torch.zeros((pt.kwords, B), dtype=torch.int32, device=cuda_device)
    ch = channel_batch(pt, None, B, 2.0, key=kt, debug=debug, debug_info=info)
    inv = sdc.vn_inv.long()
    fs = FrameSource(code.G, 2.0, cuda_device)
    lanes = torch.arange(B, device=cuda_device)
    u = fs.info_bits(key, lanes)
    words = info.to(torch.int64) & 0xFFFFFFFF
    idx = torch.arange(code.kc, device=cuda_device)
    bits = ((words[idx // 32] >> (idx % 32)[:, None]) & 1).t().double()
    assert torch.equal(bits, u)
    r = fs.normals(key, lanes)
    assert (debug.double() - r).abs().max().item() < 1e-4
    llr, cw = fs.draw(key, lanes)
    assert torch.equal(ch.codeword[inv].bool(), cw)
    assert (ch.llr[inv].double() - llr).abs().max().item() < 1e-3


def test_qc_mix_builds_the_fast_layered_engine(monkeypatch, tmp_path):
    """On the CPU: the mix's ``qc`` declares the code quasi-cyclic at its
    configuration's ``Z``, as ``--qc-z`` does, so ``--pallas --layer-file``
    routes to the fused pool on the fast layered engine; the same mix
    without it routes to the exact schedule, batch-stepped; a code that is
    not quasi-cyclic at its ``Z``, or has none, is refused."""
    from portbench.codes import cached_code

    monkeypatch.setattr(harness, "DEVICE", torch.device("cpu"))
    cell = spec.resolve(spec.load_benchmark(), "wifi1944-fast-2.0dB")
    assert cell.traffic["qc"] is True and cell.traffic["layer_file"] and cell.traffic["pallas"]
    cell = dataclasses.replace(cell, config={**cell.config, "batch_size": 32})
    _, files = cached_code(cell.config["code"], tmp_path / "codes")
    sim, _ = harness.build_simulator(cell, files, 5, tmp_path)
    assert (sim.engine, sim.schedule) == ("fused-pool", "layered-fast")
    assert sim.code.qc[0] == 81
    plain = dataclasses.replace(cell, traffic={k: v for k, v in cell.traffic.items()
                                               if k != "qc"})
    sim, _ = harness.build_simulator(plain, files, 5, tmp_path)
    assert (sim.engine, sim.schedule) == ("batch", "layered")
    for code in ({**cell.config["code"], "Z": 80},
                 {k: v for k, v in cell.config["code"].items() if k != "Z"}):
        bad = dataclasses.replace(cell, config={**cell.config, "code": code})
        with pytest.raises(ValueError):
            harness.build_simulator(bad, files, 5, tmp_path)


def _run(cell: str, seed: int, seconds: float, trace: int = 0):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(seed),
         "--seconds", str(seconds), "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    return proc


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_a_second_correctly(cuda_device, cell):
    proc = _run(cell, SEEDS[0], 1.0)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], proc.stderr[-4000:]
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert list(out)[-1] == "checks"
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cuda_device, cell):
    """The reference in bfloat16 storage, put in the program's place, fails
    one of the cell's limits on every seed."""
    limits = spec.resolve(spec.load_benchmark(), cell).check["limits"]
    for row in harness.readings(cell, SEEDS, 1.0, control=len(SEEDS)):
        assert any(row["control"][k] > limits[k] for k in limits), row
        assert all(row["program"][k] <= limits[k] for k in limits), row


def _broken(kind: str):
    """A fault planted under the timed path: the sweep's step wrapped (the
    batch step's decisions are altered in its decoder, :func:`_bad_decisions`)."""
    def wrap(sim):
        if sim.engine == "batch":
            step = sim._step

            def bad(gen, x):
                out = step(gen, x)
                if kind == "unchanged":
                    return type(out)(*(torch.zeros_like(v) for v in out))
                if kind == "half":
                    return type(out)(out.bit_errors // 2, out.frame_errors // 2,
                                     out.frames // 2, out.iter_sum // 2)
                if kind == "altered":
                    return type(out)(out.bit_errors, out.frame_errors, out.frames,
                                     out.iter_sum + out.frames)
                return out
            sim._step = bad
        else:
            step = sim._stream_step

            def bad(state, gen, x, refill):
                if kind == "unchanged":
                    _, acc = step(_copied(state), gen, x, refill)
                    return state, type(acc)(*(torch.zeros_like(v) for v in acc))
                state, acc = step(state, gen, x, refill)
                if kind == "half":
                    return state, type(acc)(acc.bit_errors // 2, acc.frame_errors // 2,
                                            acc.frames // 2, acc.iter_sum // 2, acc.n_active)
                if kind == "altered":
                    return state, type(acc)(acc.bit_errors, acc.frame_errors, acc.frames,
                                            acc.iter_sum + acc.frames, acc.n_active)
                # decisions: one frame in 16 of those counted reads one bit wrong
                # (rare_decisions: one in 16,384)
                wrong = acc.frames // (16 if kind == "decisions" else 16384)
                return state, type(acc)(acc.bit_errors + wrong, acc.frame_errors + wrong,
                                        acc.frames, acc.iter_sum, acc.n_active)
            sim._stream_step = bad
    return wrap


def _copied(state):
    """A streaming state to step in the original's place: a deep copy, or
    for the fused pool's state its tensors cloned (its quota watch, which
    holds CUDA events, shared)."""
    if getattr(state, "watch", None) is None:
        return copy.deepcopy(state)
    return dataclasses.replace(state, **{f.name: getattr(state, f.name).clone()
                                         for f in dataclasses.fields(state)
                                         if isinstance(getattr(state, f.name), torch.Tensor)})


def _bad_decisions(batch_decoder):
    """``batch_decoder`` whose decoder flips the first decided bit of every
    16th frame where it is produced."""
    def make(*a, **k):
        decode = batch_decoder(*a, **k)

        def bad(*args, **kw):
            out = decode(*args, **kw)
            hard = out.hard.clone()
            hard[0, ::16] = (hard[0, ::16] == 0).to(hard.dtype)
            return out._replace(hard=hard)
        return bad
    return make


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "decisions"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cuda_device, cell, fault, monkeypatch, capsys):
    """A step that returns its state unchanged, half of the batch left out,
    an answer altered where it is produced (every frame's iteration count
    one off; one decided bit in 16 frames wrong, in the streaming cell its
    count): each run comes out not correct (the card's look is skipped; the
    rest of the run is the harness's)."""
    from libldpc_tpu_torch.parallel import mesh

    build = harness.build_simulator

    def broken_build(*a, **k):
        sim, rec = build(*a, **k)
        _broken(fault)(sim)
        return sim, rec

    monkeypatch.setattr(harness, "build_simulator", broken_build)
    if fault == "decisions":
        monkeypatch.setattr(mesh, "batch_decoder", _bad_decisions(mesh.batch_decoder))
    import time

    rc = harness.run(cell, SEEDS[1], 1.0, False, time.perf_counter(), ROOT)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["correct"] is False, out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c for c in CELLS
                                  if spec.resolve(spec.load_benchmark(), c).check["kind"]
                                  != "batch"])
def test_rare_decision_fault_is_not_correct(cuda_device, cell, monkeypatch, capsys):
    """A streaming cell's counts with one frame in 16,384 read one bit wrong
    (a frame error rate a few times the code's at 2.0 dB on the
    802.11n code) come out not correct."""
    build = harness.build_simulator

    def broken_build(*a, **k):
        sim, rec = build(*a, **k)
        _broken("rare_decisions")(sim)
        return sim, rec

    monkeypatch.setattr(harness, "build_simulator", broken_build)
    import time

    rc = harness.run(cell, SEEDS[2], 1.0, False, time.perf_counter(), ROOT)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["correct"] is False, out["checks"]
