"""Operation counts of one decoded frame, and the H100's roofline.

The port of :mod:`libldpc_tpu.utils.roofline` for the card: the per-frame
budget is counted as there (``decode_frame_cost``: the check combine, the
variable sums, the syndrome, the channel), and a measured rate is related
to the card's peak (``roofline_pct``).  The port has no transport: the
CN<->VN permutation is an indexed load from a static table, so the Beneš,
gather and MXU terms of the TPU model (``permute_ops``, ``mxu_flops``)
count 0.

Beside it, the per-slot counts and the bound that ``chip_smoke.py`` puts
beside each kernel's time: the least time the card could take, the larger
of the bytes a call must move over the HBM rate and the operations it does
over the float32 rate (H100 SXM, NVIDIA's data sheet; the byte and integer
operations of the decoders are counted against the float32 rate too).
"""

from __future__ import annotations

import dataclasses

#: H100 SXM: HBM3 bytes/s, and float32 operations/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
OPS_S = 67e12

#: Operations charged per transcendental, pairwise box-plus and min-sum, and
#: the tanh and phi forms' per-edge transforms, as the JAX model counts them.
TRANSCENDENTAL_OPS = 4
BOXPLUS_OPS = 8 + 2 * (1 + TRANSCENDENTAL_OPS)
MINSUM_OPS = 7
TANH_PRE_OPS = 2 + TRANSCENDENTAL_OPS
TANH_POST_OPS = 3 + TRANSCENDENTAL_OPS
PHI_IN_OPS = 2 + 3 * TRANSCENDENTAL_OPS
PHI_OUT_OPS = 2 + 2 * TRANSCENDENTAL_OPS

#: Operations per CN-space slot and iteration, counted from the kernels:
#: the check combine makes ~3 pairwise operations per slot (forward,
#: backward, exclusion), a BP box-plus ~10 (min, sign, two exp, two log1p,
#: adds), the VN sum and extrinsic 2, the syndrome 2.  The fast layered
#: engine adds the APP update (3); the exact layered schedule recomputes
#: every posterior and syndrome per layer.  The BEC peeling: 4 operations
#: per slot in the check phase, 4 in the variable phase, each of which can
#: be one 32-bit word operation for 32 frames (the batch kernel's
#: bit-sliced algebra), so a slot of one frame counts 8 / 32.
OPS_BP_SLOT = 3 * 10 + 2 + 2
OPS_MS_SLOT = 3 * 3 + 2 + 2  # a min-sum pair: min, sign, multiply
OPS_BP_FAST_SLOT = 3 * 10 + 3 + 2
OPS_MS_FAST_SLOT = 3 * 3 + 3 + 2
OPS_BEC_SLOT = 8 / 32


@dataclasses.dataclass(frozen=True)
class FrameCost:
    """Per-frame operation budget at a fixed iteration count."""

    cn_ops: float  # check-node exclusion combines
    permute_ops: float  # the CN<->VN transport: 0 here, an indexed load
    vn_ops: float  # VN sums + posterior + extrinsic
    syndrome_ops: float  # early-termination checks
    other_ops: float  # the channel (noise draw, BPSK map, LLR scale)
    iterations: float
    mxu_flops: float = 0.0  # the TPU's one-hot transport: 0 here

    @property
    def total_ops(self) -> float:
        return self.cn_ops + self.permute_ops + self.vn_ops + self.syndrome_ops + self.other_ops

    def as_dict(self) -> dict:
        return {
            "cn_ops": round(self.cn_ops),
            "permute_ops": round(self.permute_ops),
            "vn_ops": round(self.vn_ops),
            "syndrome_ops": round(self.syndrome_ops),
            "other_ops": round(self.other_ops),
            "total_ops": round(self.total_ops),
            "mxu_flops": round(self.mxu_flops),
            "iterations": self.iterations,
        }


def _cn_pairwise_ops(cn_classes) -> float:
    """Pairwise-op applications per CN-update sweep (all checks)."""
    return float(sum(count * (3 * d - 4) for count, d in cn_classes if d >= 2))


def decode_frame_cost(*, nc: int, nnz: int, cn_classes, iterations: float, minsum: bool = False,
                      cn_form: str = "auto", early_term: bool = True,
                      channel: bool = True) -> FrameCost:
    """Operation budget for one decoded frame: ``cn_form`` ``"minsum"``,
    ``"boxplus"`` (``"auto"`` by ``minsum``), ``"tanh"`` or ``"phi"``;
    ``cn_classes`` the ``(count, degree)`` blocks of the checks.  The
    counts are the JAX model's for its sorted path, without its transport."""
    if cn_form == "auto":
        cn_form = "minsum" if minsum else "boxplus"
    if cn_form in ("tanh", "phi"):
        pair = 1.0 if cn_form == "tanh" else 2.0
        pre, post = ((TANH_PRE_OPS, TANH_POST_OPS) if cn_form == "tanh"
                     else (PHI_IN_OPS, PHI_OUT_OPS))
        cn = _cn_pairwise_ops(cn_classes) * pair
        cn += sum(count * d * (pre + post) for count, d in cn_classes if d >= 2)
        cn *= iterations
    else:
        op_cost = MINSUM_OPS if cn_form == "minsum" else BOXPLUS_OPS
        cn = _cn_pairwise_ops(cn_classes) * op_cost * iterations
    return FrameCost(
        cn_ops=cn,
        permute_ops=0.0,
        vn_ops=(2 * nnz + nc) * iterations,
        syndrome_ops=3 * nnz * iterations if early_term else 3 * nnz,
        other_ops=12 * nc if channel else 0,
        iterations=iterations,
    )


def roofline_pct(frames_per_s: float, cost: FrameCost, peak_ops: float = OPS_S) -> float:
    """The share (in percent) of the card's float32 peak that a measured
    rate corresponds to."""
    return 100.0 * frames_per_s * cost.total_ops / peak_ops


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time the card could take (ms) for a call that moves
    ``nbytes`` and does ``ops`` operations, and what sets it: ``"bytes"``
    or ``"operations"``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
