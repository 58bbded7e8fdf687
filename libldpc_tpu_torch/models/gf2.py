"""Dense bit-packed GF(2) linear algebra on the host (NumPy).

A copy of the NumPy paths of :mod:`libldpc_tpu.models.gf2`: 64 GF(2)
elements per ``uint64`` word, XOR for row addition (the JAX package's
optional native rank kernel is not copied; this is its fallback).
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


def rank(mat: np.ndarray) -> int:
    """Rank of a binary matrix over GF(2): Gaussian elimination on packed
    words, a pivot per column."""
    mat = np.asarray(mat)
    packed = pack_rows(mat)
    m, n = packed.shape[0], mat.shape[1]
    r = 0
    for col in range(n):
        if r == m:
            break
        word, bit = divmod(col, 64)
        mask = np.uint64(1) << np.uint64(bit)
        # a pivot row at or below r with a 1 in this column
        col_bits = (packed[r:, word] & mask) != 0
        if not col_bits.any():
            continue
        pivot = r + int(np.argmax(col_bits))
        if pivot != r:
            packed[[r, pivot]] = packed[[pivot, r]]
        # clear the column from every other row
        sel = (packed[:, word] & mask) != 0
        sel[r] = False
        packed[sel] ^= packed[r]
        r += 1
    return r


def mat_vec(mat: np.ndarray, vec: np.ndarray) -> np.ndarray:
    """``H @ v`` over GF(2): the syndrome map."""
    return (np.asarray(mat, dtype=np.int64) @ (np.asarray(vec, dtype=np.int64) & 1)) % 2


def vec_mat(vec: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """``u @ G`` over GF(2): the encoding map."""
    return ((np.asarray(vec, dtype=np.int64) & 1) @ np.asarray(mat, dtype=np.int64)) % 2


def mat_mat(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``A @ B`` over GF(2)."""
    return (np.asarray(a, dtype=np.int64) @ np.asarray(b, dtype=np.int64)) % 2


def is_generator_matrix(H: np.ndarray, G: np.ndarray) -> bool:
    """``H @ G^T == 0`` over GF(2)."""
    return not mat_mat(H, G.T).any()
