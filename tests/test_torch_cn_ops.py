"""The port's CN forms against :mod:`libldpc_tpu.ops.cn_ops` on the same
numpy inputs, including 0, ±SHORTEN_LLR and PAD_LLR entries.  The min-sum
family is bit-exact; the transcendental forms agree within 1e-5 (the two
libraries' exp/log1p/tanh round differently) with the same non-finite
pattern."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libldpc_tpu.ops import cn_ops as jcn
from libldpc_tpu.utils.params import SHORTEN_LLR
from libldpc_tpu_torch.ops import cn_ops as tcn

torch.set_num_threads(2)

EXACT = ["BP_MS", ("BP_NMS", 0.75, 0.15), ("BP_OMS", 0.75, 0.15)]
CLOSE = ["BP", "BP_PHI", "BP_TANH", "BP_LIN", "SOMETHING_ELSE"]


def _messages(d, seed, scale=6.0):
    rng = np.random.default_rng(seed)
    M = (rng.normal(size=(5, d, 16)) * scale).astype(np.float32)
    specials = np.array([0.0, -0.0, SHORTEN_LLR, -SHORTEN_LLR, jcn.PAD_LLR], np.float32)
    M[0, :, : specials.size] = specials[None, :]
    M[1, 0, :] = 0.0
    return M


def _both(mode, M):
    j = np.asarray(jcn.cn_postprocess(_jax_excl(jnp.asarray(M), mode), mode))
    t = tcn.cn_postprocess(tcn.exclusion(torch.from_numpy(M), mode), mode).numpy()
    return j, t


def _jax_excl(M, mode):
    if jcn.is_tanh_mode(mode):
        return jcn.exclusion_combine_tanh(M)
    if jcn.is_phi_mode(mode):
        return jcn.exclusion_combine_phi(M)
    return jcn.exclusion_combine(M, jcn.get_op(mode))


@pytest.mark.parametrize("d", [1, 2, 3, 6, 7])
@pytest.mark.parametrize("mode", EXACT, ids=lambda m: m if isinstance(m, str) else m[0])
def test_minsum_family_bit_exact(mode, d):
    j, t = _both(mode, _messages(d, d))
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(np.signbit(t), np.signbit(j))


@pytest.mark.parametrize("d", [1, 2, 3, 6, 7])
@pytest.mark.parametrize("mode", CLOSE)
def test_transcendental_forms_close(mode, d):
    # the tanh form's inverse 2*atanh(t) multiplies a one-ulp difference of
    # tanh near ±1 by 2/(1-t^2), so its random inputs stay moderate (the
    # ±SHORTEN_LLR/PAD_LLR entries saturate exactly in both libraries)
    j, t = _both(mode, _messages(d, 10 + d, scale=2.0 if mode == "BP_TANH" else 6.0))
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(j))
    assert np.isfinite(t).all()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fn", ["boxplus", "minsum", "boxplus_linear"])
def test_pairwise_ops(fn):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=256) * 8).astype(np.float32)
    y = (rng.normal(size=256) * 8).astype(np.float32)
    x[:4] = [0.0, jcn.PAD_LLR, SHORTEN_LLR, -SHORTEN_LLR]
    j = np.asarray(getattr(jcn, fn)(jnp.asarray(x), jnp.asarray(y)))
    t = getattr(tcn, fn)(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    if fn == "minsum":
        np.testing.assert_array_equal(t, j)
    else:
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
    # PAD_LLR is an identity of every operator
    pad = getattr(tcn, fn)(torch.from_numpy(x), torch.full_like(torch.from_numpy(x), tcn.PAD_LLR))
    np.testing.assert_array_equal(pad.numpy(), x)


@pytest.mark.parametrize("fn", ["phi", "phi_out", "tanh_pre", "tanh_post"])
def test_domain_transforms(fn):
    # phi(x) = log1p(e^-x) - log1p(-e^-x) turns a one-ulp difference of exp
    # into a relative error ~1e-8/x for small x, so the grid starts at 1e-2
    # (below it only the floor values, which both clamp to 1e-6)
    x = np.concatenate([[0.0, 1e-6, 1e-31], np.geomspace(1e-2, 80.0, 61)]).astype(np.float32)
    if fn == "tanh_post":
        x = np.tanh(x * 0.5).astype(np.float32)
    j = np.asarray(getattr(jcn, fn)(jnp.asarray(x)))
    t = getattr(tcn, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


def test_mode_dispatch():
    assert tcn.get_op("BP_MS") is tcn.minsum
    assert tcn.get_op("NOT_A_FORM") is tcn.boxplus
    assert tcn.get_op(True) is tcn.minsum and tcn.get_op(False) is tcn.boxplus
    assert tcn.is_tanh_mode("BP_TANH") and tcn.is_phi_mode(("BP_PHI", 1.0, 0.0))
    for mode in ("BP_TANH", "BP_PHI"):
        with pytest.raises(ValueError, match=mode):
            tcn.get_op(mode)
    x = torch.tensor([1.0, -2.0])
    assert torch.equal(tcn.cn_postprocess(x, "BP_NMS"), x)
