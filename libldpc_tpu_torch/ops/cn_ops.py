"""Check-node combining operators and exclusion combines, in PyTorch.

The plain CN forms of :mod:`libldpc_tpu.ops.cn_ops`, operation for
operation: the same pairwise operators, the same forward/backward
association order in the exclusion combine, and the same float32
constants, so the min-sum family matches the JAX package bit for bit and
the transcendental forms differ only where the two libraries' ``exp``,
``log1p`` and ``tanh`` round differently.

Message tensors are ``[count, degree, batch]`` (checks, slots, frames);
padding slots hold :data:`PAD_LLR`, an exact identity of every operator.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

#: Large-but-finite LLR: the box-plus / min-sum identity on padding slots and
#: the output of a degree-1 check (the combine of zero messages).
PAD_LLR = 1e30

#: Largest float32 strictly below 1: tanh-domain products are clipped here
#: before the inverse transform (extrinsics cap at ``2*atanh`` of it ~ 17.3).
TANH_CLIP = float(np.nextafter(np.float32(1.0), np.float32(0.0)))

#: Floor for phi-domain sums before the inverse transform, so a sum of exact
#: zeros inverts to a finite extrinsic (~69.7) instead of ``inf``.
PHI_SUM_FLOOR = 1e-30

PairwiseOp = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar on ``like``'s device: the constant is rounded to
    float32 once, as the JAX package's weakly typed constants are."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _sign(x: torch.Tensor) -> torch.Tensor:
    """``1 - 2*signbit(x)``: sign with sign(+0) = +1 and sign(-0) = -1."""
    return 1.0 - 2.0 * torch.signbit(x).to(x.dtype)


def _softplus_neg(a: torch.Tensor) -> torch.Tensor:
    """``softplus(-a)`` for ``a >= 0``, as ``log1p(exp(-a))`` (what
    ``jax.nn.softplus`` reduces to there; 0 at large ``a``, never inf)."""
    return torch.log1p(torch.exp(-a))


def boxplus(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Exact pairwise box-plus (``jacobian``):
    ``sign(x)sign(y)min(|x|,|y|) + log((1+e^-|x+y|)/(1+e^-|x-y|))``."""
    m = torch.minimum(torch.abs(x), torch.abs(y))
    corr = _softplus_neg(torch.abs(x + y)) - _softplus_neg(torch.abs(x - y))
    return _sign(x) * _sign(y) * m + corr


def minsum(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise min-sum."""
    return _sign(x) * _sign(y) * torch.minimum(torch.abs(x), torch.abs(y))


def _lin_approx(L: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear approximation of ``log(1 + e^-|L|)``."""
    a = torch.abs(L)
    return torch.where(
        a < 1.0,
        _f32(-0.375, a) * a + _f32(0.6825, a),
        torch.where(a < 2.625, _f32(-0.1875, a) * a + _f32(0.5, a),
                    torch.zeros_like(a)),
    )


def boxplus_linear(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Box-plus with the piecewise-linear correction (``BP_LIN``)."""
    m = torch.minimum(torch.abs(x), torch.abs(y))
    return _sign(x) * _sign(y) * m + _lin_approx(x + y) - _lin_approx(x - y)


def tanh_pre(x: torch.Tensor) -> torch.Tensor:
    """LLR -> tanh domain; ``tanh(PAD_LLR/2) == 1`` exactly."""
    return torch.tanh(x * 0.5)


def tanh_post(t: torch.Tensor) -> torch.Tensor:
    """tanh domain -> LLR: ``2*atanh(t)`` as ``log1p(t) - log1p(-t)`` after
    clipping to ``±TANH_CLIP``."""
    p = torch.clamp(t, -TANH_CLIP, TANH_CLIP)
    return torch.log1p(p) - torch.log1p(-p)


def phi(x: torch.Tensor) -> torch.Tensor:
    """Gallager's ``φ(x) = -log(tanh(x/2))`` for ``x >= 0``, as
    ``log1p(e^-x) - log1p(-e^-x)`` with ``x`` floored at 1e-6."""
    e = torch.exp(-torch.clamp(x, min=1e-6))
    return torch.log1p(e) - torch.log1p(-e)


def phi_out(s: torch.Tensor) -> torch.Tensor:
    """Inverse transform of a φ-domain sum, floored at PHI_SUM_FLOOR."""
    return -torch.log(torch.tanh(torch.clamp(s, min=PHI_SUM_FLOOR) * 0.5))


def _kind(minsum_mode):
    return minsum_mode[0] if isinstance(minsum_mode, tuple) else minsum_mode


def is_tanh_mode(minsum_mode) -> bool:
    """True for the tanh-product sum-product form (``"BP_TANH"``)."""
    return _kind(minsum_mode) == "BP_TANH"


def is_phi_mode(minsum_mode) -> bool:
    """True for the φ-domain sum-product form (``"BP_PHI"``)."""
    return _kind(minsum_mode) == "BP_PHI"


#: Decoder-type string -> pairwise CN operator.  Unknown strings behave
#: like ``BP``; ``BP_TANH``/``BP_PHI`` have no pairwise operator.
OPS = {
    "BP": boxplus,
    "BP_MS": minsum,
    "BP_LIN": boxplus_linear,
    "BP_NMS": minsum,
    "BP_OMS": minsum,
}


def get_op(minsum_mode) -> PairwiseOp:
    """Operator lookup: the legacy bool (min-sum toggle), a decoder-type
    string, or a ``(type, scale, offset)`` tuple."""
    minsum_mode = _kind(minsum_mode)
    if minsum_mode in ("BP_TANH", "BP_PHI"):
        raise ValueError(
            f"{minsum_mode} has no pairwise operator; branch on "
            "is_tanh_mode()/is_phi_mode() and use the domain exclusion"
        )
    if isinstance(minsum_mode, str):
        return OPS.get(minsum_mode, boxplus)
    return minsum if minsum_mode else boxplus


def cn_postprocess(lc2v: torch.Tensor, minsum_mode) -> torch.Tensor:
    """Normalized (``BP_NMS``: times ``scale``) or offset (``BP_OMS``:
    magnitude minus ``offset``, floored at 0) min-sum correction; a no-op
    for every other mode."""
    if not isinstance(minsum_mode, tuple):
        return lc2v
    kind, scale, offset = minsum_mode
    if kind == "BP_NMS":
        return lc2v * _f32(scale, lc2v)
    if kind == "BP_OMS":
        mag = torch.clamp(torch.abs(lc2v) - _f32(offset, lc2v), min=0.0)
        return _sign(lc2v) * mag
    return lc2v


def exclusion_combine(M: torch.Tensor, op: PairwiseOp) -> torch.Tensor:
    """All-but-one combine along axis 1 of ``[count, dc, B]``: slot ``j`` is
    the combine of every other slot, built from forward and backward
    prefixes in the reference's left-to-right association order."""
    dc = M.shape[1]
    if dc == 1:
        return torch.full_like(M, PAD_LLR)
    fwd = [M[:, 0]]
    bwd = [M[:, dc - 1]]
    for j in range(1, dc):
        fwd.append(op(fwd[-1], M[:, j]))
        bwd.append(op(bwd[-1], M[:, dc - 1 - j]))
    out = [bwd[dc - 2]]
    for j in range(1, dc - 1):
        out.append(op(fwd[j - 1], bwd[dc - 2 - j]))
    out.append(fwd[dc - 2])
    return torch.stack(out, dim=1)


def exclusion_combine_tanh(M: torch.Tensor) -> torch.Tensor:
    """All-but-one combine in the tanh domain (``BP_TANH``)."""
    dc = M.shape[1]
    if dc == 1:
        return torch.full_like(M, PAD_LLR)
    T = tanh_pre(M)
    fwd = [T[:, 0]]
    bwd = [T[:, dc - 1]]
    for j in range(1, dc):
        fwd.append(fwd[-1] * T[:, j])
        bwd.append(bwd[-1] * T[:, dc - 1 - j])
    out = [bwd[dc - 2]]
    for j in range(1, dc - 1):
        out.append(fwd[j - 1] * bwd[dc - 2 - j])
    out.append(fwd[dc - 2])
    return tanh_post(torch.stack(out, dim=1))


def exclusion_combine_phi(M: torch.Tensor) -> torch.Tensor:
    """All-but-one combine in the φ domain (``BP_PHI``): sign chains are
    products of ±1, magnitude chains sums of ``φ(|L|)``."""
    dc = M.shape[1]
    if dc == 1:
        return torch.full_like(M, PAD_LLR)
    S = _sign(M)
    A = phi(torch.abs(M))
    fs, fa = [S[:, 0]], [A[:, 0]]
    bs, ba = [S[:, dc - 1]], [A[:, dc - 1]]
    for j in range(1, dc):
        fs.append(fs[-1] * S[:, j])
        fa.append(fa[-1] + A[:, j])
        bs.append(bs[-1] * S[:, dc - 1 - j])
        ba.append(ba[-1] + A[:, dc - 1 - j])
    out = [bs[dc - 2] * phi_out(ba[dc - 2])]
    for j in range(1, dc - 1):
        out.append(fs[j - 1] * bs[dc - 2 - j] * phi_out(fa[j - 1] + ba[dc - 2 - j]))
    out.append(fs[dc - 2] * phi_out(fa[dc - 2]))
    return torch.stack(out, dim=1)


def exclusion(M: torch.Tensor, minsum_mode) -> torch.Tensor:
    """The exclusion combine of ``minsum_mode``'s CN form, before
    :func:`cn_postprocess`."""
    if is_tanh_mode(minsum_mode):
        return exclusion_combine_tanh(M)
    if is_phi_mode(minsum_mode):
        return exclusion_combine_phi(M)
    return exclusion_combine(M, get_op(minsum_mode))
