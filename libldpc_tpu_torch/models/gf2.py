"""Dense bit-packed GF(2) linear algebra on the host (NumPy).

A copy of the NumPy paths of :mod:`libldpc_tpu.models.gf2` that the code
constructors use: 64 GF(2) elements per ``uint64`` word, XOR for row
addition.
"""

from __future__ import annotations

import numpy as np


def pack_rows(mat: np.ndarray) -> np.ndarray:
    """Pack a binary matrix ``[m, n]`` (0/1) into ``[m, ceil(n/64)]`` uint64."""
    mat = np.asarray(mat, dtype=np.uint8) & 1
    m, n = mat.shape
    pad = (-n) % 64
    if pad:
        mat = np.concatenate([mat, np.zeros((m, pad), dtype=np.uint8)], axis=1)
    bits = mat.reshape(m, -1, 64).astype(np.uint64)
    weights = (np.uint64(1) << np.arange(64, dtype=np.uint64))[None, None, :]
    return (bits * weights).sum(axis=2, dtype=np.uint64)


def unpack_rows(packed: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_rows`."""
    m, _ = packed.shape
    bits = (packed[:, :, None] >> np.arange(64, dtype=np.uint64)[None, None, :]) & np.uint64(1)
    return bits.reshape(m, -1)[:, :n].astype(np.uint8)


def mat_mat(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``A @ B`` over GF(2)."""
    return (np.asarray(a, dtype=np.int64) @ np.asarray(b, dtype=np.int64)) % 2
