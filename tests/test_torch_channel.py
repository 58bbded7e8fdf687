"""The port's channels: valid codewords and the right LLR statistics.  Its
random streams are torch's, not jax's threefry, so the channels are held to
the distributions, not to the JAX package's draws."""

import dataclasses

import numpy as np
import pytest
import torch

from libldpc_tpu.utils.params import SHORTEN_LLR
from libldpc_tpu_torch.models import make_benchmark_code
from libldpc_tpu_torch.ops import channel
from libldpc_tpu_torch.ops.modulation import Constellation
from libldpc_tpu_torch.ops.sorted import to_sorted_device

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def code():
    return make_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True)


@pytest.fixture(scope="module")
def sdc(code):
    return to_sorted_device(code, "cpu")


def test_codewords_satisfy_parity(code, sdc):
    cw = channel.encode_batch(sdc, channel.make_generator("cpu", 0, 0, 0), 256).numpy()
    orig = cw[sdc.vn_inv.numpy()]  # back to the code's own labelling
    assert not ((code.H_dense.astype(np.int64) @ orig) % 2).any()
    assert 0.45 < orig.mean() < 0.55  # random info words, not all-zero


@pytest.mark.parametrize("snr_db", [-1.0, 2.0])
def test_awgn_llr_moments(sdc, snr_db):
    out = channel.awgn_channel(sdc, channel.make_generator("cpu", 1, 2, 3), 2048, snr_db)
    tx = sdc.bit_pos.long()
    # sign-corrected LLRs of transmitted bits are N(2/s2, 4/s2)
    v = (out.llr[tx] * (1.0 - 2.0 * out.codeword[tx].float())).double().flatten()
    s2 = 10 ** (-snr_db / 10)
    n = v.numel()
    assert abs(v.mean().item() - 2 / s2) < 5 * np.sqrt(4 / s2 / n)
    assert abs(v.var().item() - 4 / s2) < 5 * (4 / s2) * np.sqrt(2 / (n - 1))


def test_puncture_and_shorten(code):
    pcode = dataclasses.replace(code, puncture=np.array([0, 1], np.int32),
                                shorten=np.array([5], np.int32))
    psdc = to_sorted_device(pcode, "cpu")
    out = channel.awgn_channel(psdc, channel.make_generator("cpu", 4), 64, 1.0)
    assert (out.llr[psdc.puncture.long()] == 0).all()
    assert (out.llr[psdc.shorten.long()] == np.float32(SHORTEN_LLR)).all()
    assert psdc.nct == code.nc - 3 and (out.llr[psdc.bit_pos.long()] != 0).all()


def test_bsc_flip_rate(sdc):
    eps = 0.07
    out = channel.bsc_channel(sdc, channel.make_generator("cpu", 9), 2048, eps)
    tx = sdc.bit_pos.long()
    flipped = ((out.llr[tx] < 0) != out.codeword[tx].bool()).double()
    n = flipped.numel()
    assert abs(flipped.mean().item() - eps) < 5 * np.sqrt(eps * (1 - eps) / n)
    delta = np.float32(np.log((1 - eps) / eps))
    assert set(out.llr[tx].abs().unique().tolist()) == {float(delta)}


def test_draws_follow_the_key(sdc):
    def draw(*key):
        return channel.simulate_channel(sdc, "AWGN", channel.make_generator("cpu", *key), 32, 1.0)

    a, b = draw(0, 1, 2), draw(0, 1, 2)
    assert torch.equal(a.llr, b.llr) and torch.equal(a.codeword, b.codeword)
    assert not torch.equal(a.llr, draw(0, 1, 3).llr)
    assert not torch.equal(a.llr, draw(0, 2, 2).llr)


def test_not_ported_channels_raise(sdc):
    """A constellation, once refused, turns AWGN into the M-ASK channel and
    leaves the BSC as it is (as in the JAX package); an unknown channel
    still raises."""
    cstl = Constellation.mask(4, labels=[0, 1, 3, 2])
    tx = sdc.bit_pos.long()
    mapper = tx[: tx.numel() // 2 * 2].reshape(-1, 2).T.contiguous()
    out = channel.simulate_channel(sdc, "AWGN", channel.make_generator("cpu", 0), 4, 1.0,
                                   modulation=(cstl, mapper))
    assert out.llr.shape == (sdc.nc, 4) and torch.isfinite(out.llr).all()
    assert (out.llr[tx] != 0).all()
    bsc = [channel.simulate_channel(sdc, "BSC", channel.make_generator("cpu", 0), 4, 0.1, **kw)
           for kw in ({}, dict(modulation=(cstl, mapper)))]
    assert torch.equal(bsc[0].llr, bsc[1].llr)
    with pytest.raises(ValueError, match="No channel"):
        channel.simulate_channel(sdc, "FOO", channel.make_generator("cpu", 0), 4, 1.0)
