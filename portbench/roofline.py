"""The yardstick of the roofline shares: the H100's published peaks and the
operations and bytes the algorithm needs, counted from shapes.

Frozen copies from ``libldpc_tpu_torch/utils/roofline.py`` at commit
c083e37 (``HBM_BYTES_S``, ``OPS_S``, the per-operation charges and
``decode_frame_cost``), so that a change of the program cannot move them.
A share is the least time the card could take (the larger of the bytes
over the HBM rate and the operations over the float32 rate) over the
device time the kernels took; what the algorithm needs is counted once,
whatever kernel or form does the work.
"""

from __future__ import annotations

#: H100 SXM (NVIDIA's data sheet, 700 W): HBM3 bytes/s, float32 operations/s
#: outside the tensor cores.  The byte and integer operations of the
#: decoders and the draw are charged against the float32 rate too.
HBM_BYTES_S = 3.35e12
OPS_S = 67e12

TRANSCENDENTAL_OPS = 4
BOXPLUS_OPS = 8 + 2 * (1 + TRANSCENDENTAL_OPS)
MINSUM_OPS = 7


def cn_pairwise_ops(cn_classes) -> float:
    """Pairwise operations of one sweep over every check (forward,
    backward and exclusion: ``3 d - 4`` a check of degree ``d``)."""
    return float(sum(count * (3 * d - 4) for count, d in cn_classes if d >= 2))


def decode_frame_ops(nc: int, nnz: int, cn_classes, iterations: float,
                     minsum: bool = False) -> float:
    """Operations one frame's decode needs at ``iterations`` (early
    termination on): the check combine, the variable sums and extrinsics,
    the syndrome, per iteration (``decode_frame_cost`` without the
    channel's share)."""
    op = MINSUM_OPS if minsum else BOXPLUS_OPS
    per_iter = cn_pairwise_ops(cn_classes) * op + (2 * nnz + nc) + 3 * nnz
    return per_iter * iterations


def decode_frame_bytes(nc: int) -> float:
    """Bytes one frame's decode must move: its LLRs (float32) read once,
    its iteration count and error count (int32) written once."""
    return 4.0 * nc + 8.0


def draw_frame_ops(nc: int, kc: int, nct: int = None) -> float:
    """Operations one frame's draw needs: 12 a transmitted bit (the noise,
    the BPSK map, the LLR scale: ``decode_frame_cost``'s channel share;
    ``nct`` of them, every bit when None: a punctured bit draws no noise)
    and the encode, an AND and a population count a 32-bit word of the
    info word for each of the ``nc - kc`` parity columns."""
    return 12.0 * (nc if nct is None else nct) + 2.0 * (-(-kc // 32)) * (nc - kc)


def draw_frame_bytes(nc: int) -> float:
    """Bytes one frame's draw must write: its LLRs (float32) and its
    codeword (one byte a bit), once."""
    return 5.0 * nc


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / OPS_S, nbytes / HBM_BYTES_S)
