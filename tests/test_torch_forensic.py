"""The forensic error log on the CPU: the port's ``_log_error_frames``
against the JAX package's on the same arrays (byte for byte, with and
without codewords), the streaming fallback it forces (warning and
provenance, as in the JAX package), the batch step's forensic planes, and
whole logged sweeps whose lines agree with their counts."""

import dataclasses
import re

import numpy as np
import pytest
import torch

from libldpc_tpu.models import wifi_code as jax_wifi_code
from libldpc_tpu.parallel.mesh import ForensicStepCounters as JaxForensic
from libldpc_tpu.sim.driver import Simulator as JaxSimulator
from libldpc_tpu.utils.params import (
    ChannelParams as JaxChannel, DecoderParams as JaxDecoder, SimulationParams as JaxSimParams,
)
from libldpc_tpu_torch.convert import code_from_jax
from libldpc_tpu_torch.models import make_benchmark_code
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.ops.sorted import to_sorted_device
from libldpc_tpu_torch.parallel.mesh import ForensicStepCounters, StepCounters, make_sim_step
from libldpc_tpu_torch.ops.channel import make_generator
from libldpc_tpu_torch.sim.driver import Simulator
from libldpc_tpu_torch.utils.params import ChannelParams, DecoderParams, SimulationParams

torch.set_num_threads(2)

FALLBACK = "fallback[forensic error log -> streaming ET disabled (batch stepping)]"
LINE = re.compile(
    r"x=(\S+) frame=(\d+) bit_errors=(\d+) is_codeword=([01]) dE=([\d.]+) dH=(\d+) "
    r"syndrome_weight=(\d+) failed_bits=({0}) failed_checks=({0})".format(
        r"[\d,]*(?:,\.\.\.\(\d+ total\))?") +
    r"(?: decided_cw=([0-9a-f]+) true_cw=([0-9a-f]+))?$")


@pytest.fixture(scope="module")
def codes():
    """wifi 648 (irregular, so the sorted labels differ from the file's),
    two bits punctured: the JAX code and the port's copy."""
    jcode = dataclasses.replace(jax_wifi_code(648, with_G=True),
                                puncture=np.array([3, 200], dtype=np.int32))
    return jcode, code_from_jax(jcode)


def _sims(codes, tmp_path, with_cw):
    jcode, code = codes
    jlog, plog = tmp_path / "jax.txt", tmp_path / "port.txt"
    jsim = JaxSimulator(jcode, JaxDecoder(iterations=4, early_term=False),
                        JaxChannel(seed=1, x_range=(1.5, 2.0, 1.0)),
                        JaxSimParams(batch_size=8, error_log_file=str(jlog),
                                     error_log_codewords=with_cw), verbose=False)
    psim = Simulator(code, DecoderParams(iterations=4, early_term=False),
                     ChannelParams(seed=1, x_range=(1.5, 2.0, 1.0)),
                     SimulationParams(batch_size=8, error_log_file=str(plog),
                                      error_log_codewords=with_cw),
                     device="cpu", verbose=False)
    return jsim, psim, jlog, plog


@pytest.mark.parametrize("with_cw", [False, True], ids=["plain", "codewords"])
def test_log_lines_equal_the_jax_package_byte_for_byte(codes, tmp_path, with_cw):
    jcode, code = codes
    jsim, psim, jlog, plog = _sims(codes, tmp_path, with_cw)
    np.testing.assert_array_equal(psim._vn_inv, jsim._vn_inv)
    rng = np.random.default_rng(5)
    B, nc, vn_inv = 24, code.nc, psim._vn_inv
    vn_perm = np.argsort(vn_inv)  # sorted label -> original label
    u = rng.integers(0, 2, (B, code.G.shape[0]))
    cw = np.stack([code.encode(x) for x in u], 1)[vn_perm].astype(np.uint8)  # sorted labels
    hard = cw.copy()
    for b in range(B):
        kind = b % 4
        if kind == 1:  # a few wrong bits
            flip = rng.choice(nc, rng.integers(1, 9), replace=False)
        elif kind == 2:  # past the 64-index cut
            flip = rng.choice(nc, 150, replace=False)
        elif kind == 3:  # another codeword: a decoding that converged wrongly
            flip = np.nonzero(code.encode(rng.integers(0, 2, code.G.shape[0]))[vn_perm])[0]
        else:
            flip = []
        hard[flip, b] ^= 1
    tx = vn_inv[code.bit_pos]
    errs = (hard[tx] != cw[tx]).sum(0)
    assert (errs[1::4] > 0).all() and (errs[0::4] == 0).all()
    for x, frames in ((1.5, B), (-0.25, 5 * B)):
        jsim._log_error_frames(JaxForensic(0, 0, B, 0, errs.astype(np.int32), hard, cw), x, frames)
        psim._log_error_frames(errs, hard, cw, x, frames)
    text = plog.read_text()
    assert text == jlog.read_text()
    lines = text.splitlines()
    assert len(lines) == 2 * int((errs > 0).sum())
    assert all(LINE.match(ln) for ln in lines)
    for ln in lines:
        _, frame, be, iscw, _, _, weight, bits, *_ = LINE.match(ln).groups()
        b = int(frame) % B
        assert int(be) == errs[b]
        # a wrong codeword satisfies every check, wrong bits do not
        assert iscw == str(int(b % 4 == 3)) and (int(weight) == 0) == (b % 4 == 3)
        assert bits.endswith(",...(150 total)") == (b % 4 == 2)
    assert all(("decided_cw=" in ln) == with_cw for ln in lines)


def test_error_log_turns_streaming_off_with_warning_and_provenance(codes, tmp_path):
    jcode, code = codes
    with pytest.warns(UserWarning, match="streaming ET fast path is disabled"):
        sim = Simulator(code, DecoderParams(iterations=6), ChannelParams(),
                        SimulationParams(batch_size=8, error_log_file=str(tmp_path / "e.txt")),
                        device="cpu", verbose=False)
    with pytest.warns(UserWarning, match="streaming ET fast path is disabled"):
        jsim = JaxSimulator(jcode, JaxDecoder(iterations=6), JaxChannel(),
                            JaxSimParams(batch_size=8, error_log_file=str(tmp_path / "j.txt")),
                            verbose=False)
    assert sim.decode_path.endswith("streaming=off " + FALLBACK)
    assert jsim.decode_path.endswith(FALLBACK)
    plain = Simulator(code, DecoderParams(iterations=6), ChannelParams(),
                      SimulationParams(batch_size=8), device="cpu", verbose=False)
    assert "streaming=on" in plain.decode_path and "fallback" not in plain.decode_path


def test_forensic_planes_only_when_asked(codes):
    _, code = codes
    tables = kernel_tables(to_sorted_device(code, "cpu"))
    dec = DecoderParams(iterations=4)
    plain = make_sim_step(tables, "AWGN", dec, 16, "flooding")(make_generator("cpu", 2, 0, 0), 1.0)
    forensic = make_sim_step(tables, "AWGN", dec, 16, "flooding", forensics=True)(
        make_generator("cpu", 2, 0, 0), 1.0)
    assert type(plain) is StepCounters and type(forensic) is ForensicStepCounters
    assert all(torch.equal(a, b) for a, b in zip(plain, forensic[:4]))
    assert forensic.hard.dtype == forensic.codeword.dtype == torch.uint8
    assert forensic.hard.shape == forensic.codeword.shape == (code.nc, 16)
    tx = tables.code.bit_pos.long()
    assert torch.equal(forensic.frame_bit_errors,
                       (forensic.hard[tx] != forensic.codeword[tx]).sum(0))
    assert int(forensic.frame_bit_errors.sum()) == int(forensic.bit_errors)


@pytest.mark.parametrize("channel,x_range", [("AWGN", (1.0, 2.01, 1.0)), ("BEC", (0.40, 0.451, 0.05))])
def test_logged_sweep_lines_agree_with_its_counts(tmp_path, channel, x_range):
    code = make_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True)
    log = tmp_path / "e.txt"
    sim = Simulator(code, DecoderParams(iterations=10), ChannelParams(seed=2, x_range=x_range,
                                                                      type=channel),
                    SimulationParams(batch_size=32, fec=8, max_frames=4096,
                                     error_log_file=str(log), error_log_codewords=True),
                    device="cpu", verbose=False)
    res = sim.start()
    lines = log.read_text().splitlines()
    assert len(lines) == int(res.fec.sum()) > 0
    for ln in lines:
        x, frame, be, iscw, dE, dH, sw, bits, checks, dec_cw, true_cw = LINE.match(ln).groups()
        be, dH, sw = int(be), int(dH), int(sw)
        assert dH >= be >= 1 and int(iscw) == (sw == 0)
        assert float(dE) == pytest.approx(2 * np.sqrt(be), abs=5e-4)
        d, t = (np.unpackbits(np.frombuffer(bytes.fromhex(h), np.uint8))[:code.nc]
                for h in (dec_cw, true_cw))
        assert int((d != t).sum()) == dH
        assert sw == int(code.syndrome(d).sum())
        i = int(np.argmin(np.abs(res.x_values - float(x))))
        assert 0 <= int(frame) < res.frames[i]
