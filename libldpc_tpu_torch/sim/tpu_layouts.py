"""Sizes of the JAX package's TPU layouts, computed in NumPy for routing.

The JAX driver (``libldpc_tpu/sim/driver.py`` ``_select_layout``) places a
code on one of its TPU layouts and widens the message dtype, or drops to
its float32 XLA decoder, past each layout's compile walls.  The port runs
the same command line on its CUDA kernels, which have no such walls, but
decodes in the dtype the JAX package would, so one command line gives one
dtype and one provenance in both packages (:func:`.driver.tpu_layout`).
This module copies only what that decision reads, never the transports:

* :func:`benes_size`: the power-of-two edge space of the Beneš network
  (``ops/pallas/benes.py`` ``build_benes``), the edge-major layout's
  ``n_pad``;
* :func:`mxu_pairs`: the number of 128 x 128 one-hot blocks of the
  edge-major layout's permutation plan (``ops/pallas/layout.py``
  ``_block_permute_plan``); the plan exists while
  ``pairs <= MXU_MAX_PAIRS_PER_DST * n_pad / 128``;
* :func:`lanes_space`: the generic lane layout's class-padded edge space
  (each degree class padded to 128 nodes) and its power-of-two ``n_pad``
  (``ops/pallas/lanes_layout.py`` ``to_lanes_device``);
* :func:`qc_lanes_pad`: the qc lane layout's ``n_pad``, or None where that
  layout does not build (``_derive_qc_segments``' conditions).

Both layouts number edge slots position-major within the degree classes
of the sorted labelling (``ops/sorted.py`` ``_degree_classes``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..models.code import LDPCCode

#: The one-hot plan's cap on blocks per destination block (the JAX
#: package's ``_MXU_MAX_PAIRS_PER_DST``).
MXU_MAX_PAIRS_PER_DST = 6.0


def _ceil128(x: int) -> int:
    return -(-x // 128) * 128


def benes_size(n: int) -> int:
    """The Beneš network's size for ``n`` slots: the next power of two,
    at least 2."""
    return 1 << max(1, (max(2, int(n)) - 1).bit_length())


def _classes(degrees: np.ndarray):
    """``(inv, classes)``: the sorted label of each node (stable by
    degree) and the ``(count, degree)`` classes in sorted order."""
    perm = np.argsort(degrees, kind="stable")
    inv = np.empty(degrees.size, dtype=np.int64)
    inv[perm] = np.arange(degrees.size)
    return inv, [(int((degrees == d).sum()), int(d)) for d in np.unique(degrees)]


def _position(inv_of_edge: np.ndarray, degrees: np.ndarray) -> np.ndarray:
    """Each edge's position within its node, in file order."""
    order = np.argsort(inv_of_edge, kind="stable")
    starts = np.concatenate([[0], np.cumsum(np.sort(degrees))[:-1]])
    pos = np.empty(inv_of_edge.size, dtype=np.int64)
    pos[order] = np.arange(inv_of_edge.size) - starts[inv_of_edge[order]]
    return pos


def _side_slots(nodes: np.ndarray, n: int, lanes):
    """Position-major slots of the edges on one side (checks or
    variables): ``(slot, end)``.  ``lanes(count, i_in_class)`` gives a
    class's padded node count and each node's offset in it."""
    degrees = np.bincount(nodes, minlength=n)
    inv, classes = _classes(degrees)
    lab = inv[nodes]
    pos = _position(lab, degrees)
    slot = np.empty(nodes.size, dtype=np.int64)
    base_e = base_n = 0
    for count, degree in classes:
        sel = (lab >= base_n) & (lab < base_n + count)
        cp, off = lanes(count, lab[sel] - base_n)
        slot[sel] = base_e + pos[sel] * cp + off
        base_e += cp * degree
        base_n += count
    return slot, base_e


def _slots(code: LDPCCode, lanes):
    rows, cols = code.rows.astype(np.int64), code.cols.astype(np.int64)
    cn_slot, cn_end = _side_slots(rows, code.mc, lanes)
    vn_slot, vn_end = _side_slots(cols, code.nc, lanes)
    return cn_slot, vn_slot, cn_end, vn_end


def mxu_pairs(code: LDPCCode) -> Optional[int]:
    """The one-hot block count of the edge-major layout's permutation
    (the distinct (destination block, source block) pairs of 128 slots),
    or None where that layout builds no plan (``n_pad < 256``)."""
    n = benes_size(code.nnz)
    if n < 256 or n % 128:
        return None
    cn_slot, vn_slot, _, _ = _slots(code, lambda count, off: (count, off))
    perm = np.arange(n, dtype=np.int64)
    perm[vn_slot] = cn_slot  # VN slot s receives the edge at CN slot perm[s]
    keys = (np.arange(n) // 128) * (n // 128) + perm // 128
    return int(np.unique(keys).size)


def has_mxu_plan(code: LDPCCode) -> bool:
    """Whether the edge-major layout ships the one-hot permutation plan."""
    pairs = mxu_pairs(code)
    return pairs is not None and pairs <= MXU_MAX_PAIRS_PER_DST * (benes_size(code.nnz) // 128)


def lanes_space(code: LDPCCode) -> tuple[int, int]:
    """``(fill, n_pad)`` of the generic (Beneš or Clos) lane layout: the
    class-padded edge space of the larger side and its power of two."""
    _, _, cn_end, vn_end = _slots(code, lambda count, off: (_ceil128(count), off))
    fill = max(cn_end, vn_end)
    return fill, benes_size(max(fill, 2))


def qc_lanes_pad(code: LDPCCode) -> Optional[int]:
    """The qc lane layout's ``n_pad`` for a code with QC metadata, or None
    where it does not build: lane inflation ``ceil128(Z) / Z`` past 2
    (``Z < 64``), a degree class that is not a whole number of lifts, or
    circulant diagonals that do not tile both slot spaces in aligned
    segments (each lift ``k`` of a diagonal at ``A + k``)."""
    if code.qc is None:
        return None
    Z = int(code.qc[0])
    Zq = _ceil128(Z)
    if Zq > 2 * Z or code.nnz % Z:
        return None

    def lanes(count, off):
        if count % Z:
            raise ValueError
        return count // Z * Zq, off // Z * Zq + off % Z

    try:
        cn_slot, vn_slot, cn_end, vn_end = _slots(code, lanes)
    except ValueError:
        return None
    rows, cols = code.rows.astype(np.int64), code.cols.astype(np.int64)
    k, i = rows % Z, cols % Z
    diag = (i - k) % Z
    group = ((rows // Z) * (code.nc // Z) + cols // Z) * Z + diag
    order = np.argsort(group, kind="stable")
    _, first, counts = np.unique(group[order], return_index=True, return_counts=True)
    if (counts != Z).any():
        return None
    ac_all, av_all = (cn_slot - k)[order], (vn_slot - i)[order]
    ac, av = ac_all[first], av_all[first]
    if (ac_all != np.repeat(ac, Z)).any() or (av_all != np.repeat(av, Z)).any():
        return None
    span = first.size * Zq
    tiles = np.arange(0, span, Zq)
    if not (np.array_equal(np.sort(ac), tiles) and np.array_equal(np.sort(av), tiles)):
        return None  # also catches a segment start off the 128-lane grid
    if span != cn_end or span != vn_end:
        return None
    return _ceil128(max(span, 2))
