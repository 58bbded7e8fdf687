"""M-ASK modulation on the CPU against the JAX package: the constellation,
bit mapping, amplitudes and demapping exactly, the bitwise LLRs within
``rtol 2e-5, atol 1e-4`` (clamped entries exactly), the M = 2 channel
against BPSK, the simfile and mapfile parsers, the file-driven simulator's
errors, and modulated sweeps (the ``sim_cuda`` command line, the
``Simulator``, ``LDPC.simulate``) against the JAX package's within FER
|z| < 3."""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libldpc_tpu import sim_cuda as jax_sim_cuda
from libldpc_tpu.models import io as jax_io
from libldpc_tpu.models import make_benchmark_code as jax_benchmark_code
from libldpc_tpu.ops import modulation as jmod
from libldpc_tpu.sim import gpu_compat as jax_gpu_compat
from libldpc_tpu_torch import sim_cuda
from libldpc_tpu_torch.convert import code_from_jax
from libldpc_tpu_torch.models import io, wifi_code, write_layerfile
from libldpc_tpu_torch.ops import channel, modulation as mod
from libldpc_tpu_torch.ops.sorted import to_sorted_device
from libldpc_tpu_torch.sim import gpu_compat
from libldpc_tpu_torch.sim.driver import Simulator
from libldpc_tpu_torch.utils.params import (
    MAX_LLR, MIN_LLR, ChannelParams, DecoderParams, SimulationParams,
)

torch.set_num_threads(2)

LABELS = {2: ([0, 1], [1, 0]), 4: ([0, 1, 2, 3], [0, 1, 3, 2]),
          8: (list(range(8)), [0, 1, 3, 2, 6, 7, 5, 4]),
          16: (list(range(16)), [i ^ (i >> 1) for i in range(16)])}
CASES = [(M, lab) for M in LABELS for lab in LABELS[M]]


@pytest.fixture(scope="module")
def codes():
    """The JAX fixture's 120-bit (3,6) code (nct divisible by 2) and the
    port's copy."""
    jcode = jax_benchmark_code(120, dv=3, dc=6, seed=2, with_G=True)
    return jcode, code_from_jax(jcode)


@pytest.mark.parametrize("M,labels", CASES)
def test_constellation_and_mapping_equal_jax(M, labels):
    c, jc = mod.Constellation.mask(M, labels), jmod.Constellation.mask(M, labels)
    for field in ("points", "priors", "labels", "labels_rev"):
        np.testing.assert_array_equal(getattr(c, field), getattr(jc, field))
    assert c.M == jc.M and c.bits_per_symbol == jc.bits_per_symbol
    bits, n_sym, B = c.bits_per_symbol, 24, 5
    np.testing.assert_array_equal(mod.default_bit_mapper(bits, n_sym),
                                  jmod.default_bit_mapper(bits, n_sym))
    rng = np.random.default_rng(M)
    nc = bits * n_sym + 7
    mapper = rng.permutation(nc)[: bits * n_sym].reshape(bits, n_sym).astype(np.int32)
    cw = rng.integers(0, 2, (nc, B)).astype(np.uint8)
    idx = mod.map_bits_to_symbols(c, torch.from_numpy(mapper), torch.from_numpy(cw))
    jidx = jmod.map_bits_to_symbols(jc, jnp.asarray(mapper), jnp.asarray(cw))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(mod.modulate(c, idx).numpy(),
                                  np.asarray(jmod.modulate(jc, jidx)))
    llr_bits = rng.normal(size=(bits, n_sym, B)).astype(np.float32)
    got = mod.demap_llrs_to_codeword(torch.from_numpy(llr_bits), torch.from_numpy(mapper), nc)
    want = jmod.demap_llrs_to_codeword(jnp.asarray(llr_bits), jnp.asarray(mapper), nc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_constellation_errors_equal_jax():
    for M, labels in ((3, None), (4, [0, 1, 2, 2]), (1, None)):
        msgs = []
        for cls in (mod.Constellation, jmod.Constellation):
            with pytest.raises(ValueError) as err:
                cls.mask(M, labels)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("M,labels", CASES)
def test_bitwise_llrs_agree_with_jax(M, labels):
    """Received amplitudes around the points at three noise levels, and
    far outside them at a tiny variance (clamped both ways)."""
    c, jc = mod.Constellation.mask(M, labels), jmod.Constellation.mask(M, labels)
    rng = np.random.default_rng(100 + M)
    for sigma2 in (0.5, 0.05, 0.002):
        y = (c.points[rng.integers(0, M, (40, 16))]
             + rng.normal(size=(40, 16)) * np.sqrt(sigma2)).astype(np.float32)
        s2 = np.float32(sigma2)
        got = mod.bitwise_llrs(c, torch.from_numpy(y), s2).numpy()
        want = np.asarray(jmod.bitwise_llrs(jc, jnp.asarray(y), jnp.float32(s2)))
        assert got.shape == want.shape == (c.bits_per_symbol, 40, 16)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)
    y = np.array([[-100.0, 100.0, 50.0, -3.0]], np.float32)
    got = mod.bitwise_llrs(c, torch.from_numpy(y), np.float32(1e-6)).numpy()
    want = np.asarray(jmod.bitwise_llrs(jc, jnp.asarray(y), jnp.float32(1e-6)))
    clamped = (np.abs(want) >= MAX_LLR * (1 - 1e-7))
    assert clamped.any()
    np.testing.assert_array_equal(got[clamped], want[clamped])
    assert got.max() <= np.float32(MAX_LLR) and got.min() >= np.float32(MIN_LLR)


def test_bpsk_constellation_channel_equals_awgn(codes):
    """M = 2 with labels [1, 0] and the transmitted bits as the mapper
    draws what :func:`awgn_channel` draws, from the same generator in the
    same order: equal codewords, LLRs to rounding (the JAX test's
    tolerance)."""
    _, code = codes
    sdc = to_sorted_device(code, "cpu")
    cstl = mod.Constellation.mask(2, labels=[1, 0])
    mapper = sdc.bit_pos.reshape(1, -1)
    for snr in (1.0, 3.0):
        out_m = channel.modulated_awgn_channel(sdc, channel.make_generator("cpu", 5, 1), 64, snr,
                                               cstl, mapper)
        out_b = channel.awgn_channel(sdc, channel.make_generator("cpu", 5, 1), 64, snr)
        assert torch.equal(out_m.codeword, out_b.codeword)
        torch.testing.assert_close(out_m.llr, out_b.llr, rtol=1e-4, atol=2e-2)


def test_shortened_and_punctured_bits(codes):
    """Shortened bits get ``SHORTEN_LLR``; a punctured bit that no mapper
    entry names stays 0."""
    import dataclasses

    from libldpc_tpu_torch.utils.params import SHORTEN_LLR

    _, code = codes
    code = dataclasses.replace(code, puncture=np.array([5, 9], np.int32),
                               shorten=np.array([0, 17], np.int32))
    sdc = to_sorted_device(code, "cpu")
    cstl = mod.Constellation.mask(4, labels=[0, 1, 3, 2])
    mapper = sdc.bit_pos[: code.nct // 2 * 2].reshape(-1, 2).T.contiguous()
    out = channel.simulate_channel(sdc, "AWGN", channel.make_generator("cpu", 3), 16, 5.0,
                                   modulation=(cstl, mapper))
    assert (out.llr[sdc.shorten.long()] == SHORTEN_LLR).all()
    assert (out.llr[sdc.puncture.long()] == 0).all()
    assert (out.llr[mapper.reshape(-1).long()] != 0).all()


def _write_files(tmp_path, jcode, M=4, labels="0, 1, 3, 2", snrs=(7.0, 8.0), bits=2,
                 fec=60, max_frames=4096, iters=20, name="res.txt"):
    """Codefile, generator, simfile and mapfile in the reference's formats
    (a consecutive map of the transmitted bits)."""
    h, g = tmp_path / "h.txt", tmp_path / "g.txt"
    h.write_text("".join(f"{r} {c}\n" for r, c in zip(jcode.rows, jcode.cols)))
    rr, cc = np.nonzero(jcode.G)
    g.write_text("".join(f"{r} {c}\n" for r, c in zip(rr, cc)))
    sim = tmp_path / "sim.txt"
    sim.write_text("\n".join([
        f"name: {tmp_path / name}", f"M: {M}", f"bits: {bits}", f"labels: {labels}",
        "snrs: " + ", ".join(map(str, snrs)), f"max frames: {max_frames}", f"min fec: {fec}",
        f"bp iter: {iters}", "early term: 1"]) + "\n")
    n_sym = jcode.nct // bits
    mapper = jcode.bit_pos[np.arange(bits * n_sym).reshape(n_sym, bits).T]
    mp = tmp_path / "map.txt"
    mp.write_text(", ".join(map(str, mapper.reshape(-1))) + "\n")
    return str(h), str(g), str(sim), str(mp)


def test_simfile_and_mapfile_parse_like_jax(codes, tmp_path):
    jcode, _ = codes
    _, _, simf, mapf = _write_files(tmp_path, jcode)
    sf, jsf = io.parse_simfile(simf), jax_io.parse_simfile(simf)
    for field in ("name", "M", "bits", "max_frames", "min_fec", "bp_iter", "early_term"):
        assert getattr(sf, field) == getattr(jsf, field)
    np.testing.assert_array_equal(sf.labels, jsf.labels)
    np.testing.assert_array_equal(sf.snrs, jsf.snrs)
    assert sf.labels.dtype == jsf.labels.dtype
    np.testing.assert_array_equal(io.parse_mapfile(mapf, 2, 60),
                                  jax_io.parse_mapfile(mapf, 2, 60))
    bad = tmp_path / "bad.txt"
    bad.write_text("name: x\nM: 4\nbits: 2\nlabels: 0, 1\nsnrs: 1\nmax frames: 10\n"
                   "min fec: 1\nbp iter: 5\nearly term: 1\n")
    for args, p, jp in (((str(bad),), io.parse_simfile, jax_io.parse_simfile),
                        ((mapf, 2, 61), io.parse_mapfile, jax_io.parse_mapfile)):
        msgs = []
        for fn in (p, jp):
            with pytest.raises(ValueError) as err:
                fn(*args)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


def test_file_driven_simulator_errors_like_jax(codes, tmp_path):
    jcode, code = codes
    h, g, simf, mapf = _write_files(tmp_path, jcode)
    text = open(simf).read()
    open(simf, "w").write(text.replace("bits: 2", "bits: 7"))  # 7 does not divide nct = 120
    msgs = []
    for build in (gpu_compat.build_simulator_from_files,
                  jax_gpu_compat.build_simulator_from_files):
        kw = dict(device="cpu") if build is gpu_compat.build_simulator_from_files else {}
        with pytest.raises(ValueError) as err:
            build(h, simf, mapf, gen_file=g, verbose=False, **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(NotImplementedError, match='"Multi-GPU"'):
        gpu_compat.build_simulator_from_files(h, simf, mapf, mesh=object(), device="cpu")
    # a mapper that misses a transmitted bit, and a channel other than AWGN
    cstl = mod.Constellation.mask(4)
    short = code.bit_pos[:118].reshape(2, 59)
    for kw, match in ((dict(modulation=(cstl, short)), "bit mapper covers 118 bits"),
                      (dict(modulation=(cstl, code.bit_pos.reshape(2, 60))), "AWGN")):
        ch = ChannelParams(type="BSC" if match == "AWGN" else "AWGN")
        with pytest.raises(ValueError, match=match):
            Simulator(code, DecoderParams(), ch, SimulationParams(batch_size=8), device="cpu",
                      verbose=False, **kw)


def _rows(path):
    """The results file's rows (after its provenance and column header)."""
    return np.array([ln.split() for ln in open(path).read().splitlines()[2:]], dtype=float)


def _assert_fer_agrees(rows_t, rows_j):
    assert rows_t.shape == rows_j.shape
    np.testing.assert_array_equal(rows_t[:, 0], rows_j[:, 0])
    for (_, fer_t, _, n_t, *_), (_, fer_j, _, n_j, *_) in zip(rows_t, rows_j):
        p = (fer_t * n_t + fer_j * n_j) / (n_t + n_j)
        z = (fer_t - fer_j) / np.sqrt(p * (1 - p) * (1 / n_t + 1 / n_j))
        assert abs(z) < 3, (fer_t, n_t, fer_j, n_j)


def test_sim_cuda_sweep_agrees_with_jax(codes, tmp_path):
    """The same files through both ``sim_cuda`` command lines (4-ASK Gray,
    7 and 8 dB, BP, ET, streaming): FER within |z| < 3, in file order,
    the same provenance line apart from the kernel and transport."""
    jcode, _ = codes
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    argv = {}
    for side in ("t", "j"):
        h, g, simf, mapf = _write_files(tmp_path / side, jcode)
        argv[side] = ["-code", h, "-sim", simf, "-map", mapf, "-G", g, "-threads", "256",
                      "-seed", "3"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert sim_cuda.main(argv["t"] + ["-device", "cpu"]) == 0
        assert jax_sim_cuda.main(argv["j"]) == 0
    rows_t, rows_j = _rows(tmp_path / "t" / "res.txt"), _rows(tmp_path / "j" / "res.txt")
    assert list(rows_t[:, 0]) == [7.0, 8.0]
    _assert_fer_agrees(rows_t, rows_j)
    assert rows_t[0, 1] > rows_t[1, 1]
    head = open(tmp_path / "t" / "res.txt").readline()
    assert head.startswith("# kernel=torch-plain dtype=float32 cn=BP schedule=flooding "
                           "streaming=on")


def test_layered_file_sweep_takes_the_exact_schedule(tmp_path):
    """``-layer`` without ``use_pallas``: the exact layered schedule,
    batch-stepped (K5's path), as the JAX package routes it; 8-ASK on
    wifi 648 (nct 648 = 3 * 216)."""
    code = wifi_code(648)
    h = tmp_path / "h.txt"
    h.write_text("".join(f"{r} {c}\n" for r, c in zip(code.rows, code.cols)))
    rr, cc = np.nonzero(code.G)
    (tmp_path / "g.txt").write_text("".join(f"{r} {c}\n" for r, c in zip(rr, cc)))
    write_layerfile(str(tmp_path / "l.txt"), code.layers)
    sim = tmp_path / "sim.txt"
    sim.write_text(f"name: {tmp_path / 'res.txt'}\nM: 8\nbits: 3\nlabels: 0 1 3 2 6 7 5 4\n"
                   "snrs: 14\nmax frames: 64\nmin fec: 5\nbp iter: 10\nearly term: 1\n")
    (tmp_path / "map.txt").write_text(" ".join(map(str, mod.default_bit_mapper(3, 216).ravel())))
    s = gpu_compat.build_simulator_from_files(
        str(h), str(sim), str(tmp_path / "map.txt"), layer_file=str(tmp_path / "l.txt"),
        gen_file=str(tmp_path / "g.txt"), batch_size=32, verbose=False, device="cpu")
    assert s.schedule == "layered" and "streaming=off" in s.decode_path
    res = s.start()
    assert res.frames[0] == 64 and 0 <= res.fer[0] < 1


def test_modulated_simulator_agrees_with_jax(codes):
    """The ``Simulator`` (batch-stepped, ET off: the batch kernel's path)
    against the JAX one with the same constellation and mapper."""
    from libldpc_tpu.sim import Simulator as JaxSimulator
    from libldpc_tpu.utils import params as jparams

    jcode, code = codes
    mapper = code.bit_pos[mod.default_bit_mapper(2, 60)]
    kw = dict(iterations=12, early_term=False)
    x = dict(seed=5, x_values=(7.5,))
    sp = dict(batch_size=256, fec=80, max_frames=8192)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = Simulator(code, DecoderParams(**kw), ChannelParams(**x), SimulationParams(**sp),
                        device="cpu", verbose=False,
                        modulation=(mod.Constellation.mask(4, [0, 1, 3, 2]), mapper)).start()
        jres = JaxSimulator(jcode, jparams.DecoderParams(**kw), jparams.ChannelParams(**x),
                            jparams.SimulationParams(**sp), verbose=False,
                            modulation=(jmod.Constellation.mask(4, [0, 1, 3, 2]), mapper)).start()
    _assert_fer_agrees(np.stack([res.x_values, res.fer, res.ber, res.frames], 1),
                       np.stack([jres.x_values, jres.fer, jres.ber, jres.frames], 1))
    assert (res.avg_iter == 12).all()
