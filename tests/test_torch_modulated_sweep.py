"""The modulated sweep's front ends on the CPU: the forensic error log
through a constellation against the JAX package's ``_log_error_frames``
byte for byte (``dE`` included), the log's syndromes on a code of 32768
variables without a dense H, the checkpoint identity that keeps a resume
from crossing constellations (the JAX package does not keep it), and
``LDPC.simulate(modulation=...)`` on the fast layered engine."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from libldpc_tpu.models import wifi_code as jax_wifi_code
from libldpc_tpu.ops import modulation as jmod
from libldpc_tpu.parallel.mesh import ForensicStepCounters as JaxForensic
from libldpc_tpu.sim.driver import Simulator as JaxSimulator
from libldpc_tpu.utils import params as jparams
from libldpc_tpu_torch import LDPC
from libldpc_tpu_torch.convert import code_from_jax
from libldpc_tpu_torch.models import LDPCCode, make_benchmark_code, make_regular_code
from libldpc_tpu_torch.models.construct import make_qc_benchmark_code, qc_natural_layers
from libldpc_tpu_torch.ops import modulation as mod
from libldpc_tpu_torch.sim.driver import Simulator
from libldpc_tpu_torch.utils.params import ChannelParams, DecoderParams, SimulationParams

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def codes():
    """wifi 648 (irregular: sorted labels differ from the file's), two bits
    punctured (nct 646): the JAX code and the port's copy."""
    jcode = dataclasses.replace(jax_wifi_code(648, with_G=True),
                                puncture=np.array([3, 200], dtype=np.int32))
    return jcode, code_from_jax(jcode)


def _frames(code, vn_inv, B, rng):
    """Codewords and decisions ``[nc, B]`` in sorted labels: every fourth
    frame right, the others with a few, with 150, or with a codeword's
    worth of wrong bits."""
    vn_perm = np.argsort(vn_inv)
    u = rng.integers(0, 2, (B, code.G.shape[0]))
    cw = np.stack([code.encode(x) for x in u], 1)[vn_perm].astype(np.uint8)
    hard = cw.copy()
    for b in range(B):
        kind = b % 4
        if kind == 1:
            flip = rng.choice(code.nc, rng.integers(1, 9), replace=False)
        elif kind == 2:
            flip = rng.choice(code.nc, 150, replace=False)
        elif kind == 3:
            flip = np.nonzero(code.encode(rng.integers(0, 2, code.G.shape[0]))[vn_perm])[0]
        else:
            flip = []
        hard[flip, b] ^= 1
    tx = vn_inv[code.bit_pos]
    return hard, cw, (hard[tx] != cw[tx]).sum(0)


@pytest.mark.parametrize("M,labels", [(4, [0, 1, 3, 2]), (4, [0, 1, 2, 3]), (2, [0, 1])],
                         ids=["4ask-gray", "4ask-natural", "2ask"])
def test_modulated_log_equals_the_jax_package_byte_for_byte(codes, tmp_path, M, labels):
    jcode, code = codes
    bits = int(np.log2(M))
    rng = np.random.default_rng(M + labels[2 % M])
    mapper = rng.permutation(code.bit_pos).reshape(bits, -1)  # file labels, scrambled
    kw = dict(iterations=4, early_term=False)
    x = dict(seed=1, x_range=(1.5, 2.0, 1.0))
    jlog, plog = tmp_path / "jax.txt", tmp_path / "port.txt"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsim = JaxSimulator(jcode, jparams.DecoderParams(**kw), jparams.ChannelParams(**x),
                            jparams.SimulationParams(batch_size=8, error_log_file=str(jlog),
                                                     error_log_codewords=True),
                            modulation=(jmod.Constellation.mask(M, labels), mapper),
                            verbose=False)
    psim = Simulator(code, DecoderParams(**kw), ChannelParams(**x),
                     SimulationParams(batch_size=8, error_log_file=str(plog),
                                      error_log_codewords=True), device="cpu", verbose=False,
                     modulation=(mod.Constellation.mask(M, labels), mapper))
    hard, cw, errs = _frames(code, psim._vn_inv, 24, rng)
    for x_, frames in ((1.5, 24), (-0.25, 120)):
        jsim._log_error_frames(JaxForensic(0, 0, 24, 0, errs.astype(np.int32), hard, cw), x_,
                               frames)
        psim._log_error_frames(errs, hard, cw, x_, frames)
    text = plog.read_text()
    assert text == jlog.read_text()
    dEs = [float(ln.split(" dE=")[1].split()[0]) for ln in text.splitlines()]
    assert len(dEs) == 2 * int((errs > 0).sum()) and min(dEs) > 0
    if M == 4:  # 4-ASK distances are not BPSK's 2 sqrt(bit errors)
        bpsk = [2 * np.sqrt(int(ln.split(" bit_errors=")[1].split()[0]))
                for ln in text.splitlines()]
        assert any(abs(a - b) > 1e-3 for a, b in zip(dEs, bpsk))


def test_log_of_a_long_code_builds_no_dense_h(tmp_path, monkeypatch):
    """n = 32768: the log's syndromes come from the edge list; H_dense (and
    any ``mc x nc`` array) is never built.  The failed checks equal the
    checks with an odd count of flipped variables."""
    code = make_regular_code(32768, 3, 6, seed=0)

    def refuse(self):
        raise AssertionError("a dense H was built")

    monkeypatch.setattr(LDPCCode, "H_dense", property(refuse))
    sim = Simulator(code, DecoderParams(iterations=2, early_term=False), ChannelParams(),
                    SimulationParams(batch_size=4, error_log_file=str(tmp_path / "e.txt")),
                    device="cpu", verbose=False)
    rng = np.random.default_rng(2)
    cw = np.zeros((code.nc, 4), np.uint8)
    hard = cw.copy()
    flips = [rng.choice(code.nc, n, replace=False) for n in (1, 5, 0, 200)]
    sorted_of = sim._vn_inv  # original -> sorted label
    for b, f in enumerate(flips):
        hard[sorted_of[f], b] = 1
    tx = sorted_of[code.bit_pos]
    errs = (hard[tx] != cw[tx]).sum(0)
    sim._log_error_frames(errs, hard, cw, 1.0, 4)
    lines = (tmp_path / "e.txt").read_text().splitlines()
    assert len(lines) == 3
    for ln, f in zip(lines, [flips[0], flips[1], flips[3]]):
        odd = np.bincount(code.rows[np.isin(code.cols, f)], minlength=code.mc) % 2
        want = np.flatnonzero(odd)
        assert f" syndrome_weight={want.size} " in ln
        cut = ",".join(map(str, want[:64])) + (f",...({want.size} total)" if want.size > 64
                                                else "")
        assert ln.endswith(f"failed_checks={cut}")


def _sweep(code, ckpt, modulation):
    return Simulator(code, DecoderParams(iterations=8), ChannelParams(seed=2, x_values=(7.0, 8.0)),
                     SimulationParams(batch_size=64, fec=6, max_frames=1024,
                                      checkpoint_file=ckpt),
                     device="cpu", verbose=False, modulation=modulation)


def test_resume_under_another_constellation_starts_fresh(tmp_path):
    """The checkpoint identity holds the constellation's M and labels and
    the mapper's digest: a checkpoint of a BPSK sweep, of another labelling
    or of another mapper is not resumed (the JAX package would resume
    each), and the same modulation is, after its first point (120-bit
    (3,6) code, 4-ASK, streaming)."""
    code = make_benchmark_code(120, 3, 6, seed=2, with_G=True)
    mapper = code.bit_pos.reshape(-1, 2).T
    gray = (mod.Constellation.mask(4, [0, 1, 3, 2]), mapper)
    others = {"bpsk": None, "natural": (mod.Constellation.mask(4), mapper),
              "mapper": (gray[0], mapper[::-1])}
    for name, other in others.items():
        ckpt = str(tmp_path / f"{name}.json")
        first = _sweep(code, ckpt, other)
        first.start(stop_flag=lambda: first.results.frames[0] > 0)
        resumed = _sweep(code, ckpt, gray)
        with pytest.warns(UserWarning, match="different experiment"):
            res = resumed.start(resume=True)
        fresh = _sweep(code, None, gray).start()
        np.testing.assert_array_equal(res.frames, fresh.frames)
        np.testing.assert_array_equal(res.fer, fresh.fer)
    ckpt = str(tmp_path / "same.json")
    first = _sweep(code, ckpt, gray)
    first.start(stop_flag=lambda: first.results.fec[0] >= 6)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = _sweep(code, ckpt, gray).start(resume=True)
    np.testing.assert_array_equal(res.frames, _sweep(code, None, gray).start().frames)
    assert _sweep(code, None, gray)._checkpoint_config()["modulation"]["labels"] == [0, 1, 3, 2]
    assert "modulation" not in _sweep(code, None, None)._checkpoint_config()


def test_ldpc_simulate_modulated_on_the_fast_layered_engine():
    """``LDPC.simulate(modulation=..., usePallas=True, layered=True)`` on a
    QC code on its natural layers (Z = 128): the fast layered engine,
    streaming, as the ``Simulator`` runs it with the same constellation."""
    code = make_qc_benchmark_code(16 * 128, 128, dv=3, dc=6, seed=5, with_G=True)
    qc_natural_layers(code)
    mapping = (mod.Constellation.mask(16, [i ^ (i >> 1) for i in range(16)]),
               code.bit_pos[mod.default_bit_mapper(4, code.nct // 4)])
    kw = dict(snr=[17.0, 17.01, 1.0], fec=3, batchSize=32, iterations=6, maxFrames=96, seed=3,
              usePallas=True, layered=True)
    ldpc = LDPC(code=code, device="cpu")
    ldpc.simulate(blocking=True, modulation=mapping, **kw)
    sim = ldpc._simulator
    assert sim.schedule == "layered-fast" and "streaming=on" in sim.decode_path
    ref = Simulator(code, DecoderParams(iterations=6, layered=True),
                    ChannelParams(seed=3, x_range=(17.0, 17.01, 1.0)),
                    SimulationParams(batch_size=32, fec=3, max_frames=96), device="cpu",
                    verbose=False, use_pallas=True, modulation=mapping).start()
    got = ldpc.get_results()
    np.testing.assert_array_equal(got["frames"], ref.frames)
    np.testing.assert_array_equal(got["fer"], ref.fer)
    assert got["frames"][0] == 96
