"""Standard QC codes: IEEE 802.11n (Wi-Fi) rate-1/2 codes, base-matrix
tables, and the 5G-NR (TS 38.212 §5.3.2) lifting machinery.

A copy of :mod:`libldpc_tpu.models.standards`: :func:`wifi_code` and its
bundled base matrices (IEEE Std 802.11-2012 Annex F, Table F-1, rate-1/2
matrix prototypes; 12 x 24 base, ``n = 24 * Z`` for ``Z`` in {27, 54, 81}),
:func:`load_base_matrix`, the NR lifting sets, the NR shift-table parser
and :func:`make_nr_like_code`.  No NR shift table ships with the repo.
"""

from __future__ import annotations

import warnings

import numpy as np

from .code import LDPCCode
from .construct import expand_qc, qc_natural_layers, systematic_generator

_ = -1  # readability: empty (all-zero) Z x Z block

#: 802.11n n=648, Z=27, rate 1/2 (IEEE Std 802.11-2012 Annex F)
WIFI_648_12 = np.array([
    [ 0, _, _, _,  0,  0, _, _,  0, _, _,  0,  1,  0, _, _, _, _, _, _, _, _, _, _],
    [22, 0, _, _, 17, _,  0,  0, 12, _, _, _, _,  0,  0, _, _, _, _, _, _, _, _, _],
    [ 6, _, 0, _, 10, _, _, _, 24, _,  0, _, _, _,  0,  0, _, _, _, _, _, _, _, _],
    [ 2, _, _, 0, 20, _, _, _, 25,  0, _, _, _, _, _,  0,  0, _, _, _, _, _, _, _],
    [23, _, _, _,  3, _, _, _,  0, _,  9, 11, _, _, _, _,  0,  0, _, _, _, _, _, _],
    [24, _, 23, 1, 17, _,  3, _, 10, _, _, _, _, _, _, _, _,  0,  0, _, _, _, _, _],
    [25, _, _, _,  8, _, _, _,  7, 18, _, _,  0, _, _, _, _, _,  0,  0, _, _, _, _],
    [13, 24, _, _,  0, _,  8, _,  6, _, _, _, _, _, _, _, _, _, _,  0,  0, _, _, _],
    [ 7, 20, _, 16, 22, 10, _, _, 23, _, _, _, _, _, _, _, _, _, _, _,  0,  0, _, _],
    [11, _, _, _, 19, _, _, _, 13, _,  3, 17, _, _, _, _, _, _, _, _, _,  0,  0, _],
    [25, _,  8, _, 23, 18, _, 14,  9, _, _, _, _, _, _, _, _, _, _, _, _, _,  0,  0],
    [ 3, _, _, _, 16, _, _,  2, 25,  5, _, _,  1, _, _, _, _, _, _, _, _, _, _,  0],
], dtype=np.int64)

#: 802.11n n=1296, Z=54, rate 1/2 (IEEE Std 802.11-2012 Annex F)
WIFI_1296_12 = np.array([
    [40, _, _, _, 22, _, 49, 23, 43, _, _, _,  1,  0, _, _, _, _, _, _, _, _, _, _],
    [50, 1, _, _, 48, 35, _, _, 13, _, 30, _, _,  0,  0, _, _, _, _, _, _, _, _, _],
    [39, 50, _, _,  4, _,  2, _, _, _, _, 49, _, _,  0,  0, _, _, _, _, _, _, _, _],
    [33, _, _, 38, 37, _, _,  4,  1, _, _, _, _, _, _,  0,  0, _, _, _, _, _, _, _],
    [45, _, _, _,  0, 22, _, _, 20, 42, _, _, _, _, _, _,  0,  0, _, _, _, _, _, _],
    [51, _, _, 48, 35, _, _, _, 44, _, 18, _, _, _, _, _, _,  0,  0, _, _, _, _, _],
    [47, 11, _, _, _, 17, _, _, 51, _, _, _,  0, _, _, _, _, _,  0,  0, _, _, _, _],
    [ 5, _, 25, _,  6, _, 45, _, 13, 40, _, _, _, _, _, _, _, _, _,  0,  0, _, _, _],
    [33, _, _, 34, 24, _, _, _, 23, _, _, 46, _, _, _, _, _, _, _, _,  0,  0, _, _],
    [ 1, _, 27, _,  1, _, _, _, 38, _, 44, _, _, _, _, _, _, _, _, _, _,  0,  0, _],
    [ _, 18, _, _, 23, _, _,  8,  0, 35, _, _, _, _, _, _, _, _, _, _, _, _,  0,  0],
    [49, _, 17, _, 30, _, _, _, 34, _, _, 19,  1, _, _, _, _, _, _, _, _, _, _,  0],
], dtype=np.int64)

#: 802.11n n=1944, Z=81, rate 1/2 (IEEE Std 802.11-2012 Annex F)
WIFI_1944_12 = np.array([
    [57, _, _, _, 50, _, 11, _, 50, _, 79, _,  1,  0, _, _, _, _, _, _, _, _, _, _],
    [ 3, _, 28, _,  0, _, _, _, 55,  7, _, _, _,  0,  0, _, _, _, _, _, _, _, _, _],
    [30, _, _, _, 24, 37, _, _, 56, 14, _, _, _, _,  0,  0, _, _, _, _, _, _, _, _],
    [62, 53, _, _, 53, _, _,  3, 35, _, _, _, _, _, _,  0,  0, _, _, _, _, _, _, _],
    [40, _, _, 20, 66, _, _, 22, 28, _, _, _, _, _, _, _,  0,  0, _, _, _, _, _, _],
    [ 0, _, _, _,  8, _, 42, _, 50, _, _,  8, _, _, _, _, _,  0,  0, _, _, _, _, _],
    [69, 79, 79, _, _, _, 56, _, 52, _, _, _,  0, _, _, _, _, _,  0,  0, _, _, _, _],
    [65, _, _, _, 38, 57, _, _, 72, _, 27, _, _, _, _, _, _, _, _,  0,  0, _, _, _],
    [64, _, _, _, 14, 52, _, _, 30, _, _, 32, _, _, _, _, _, _, _, _,  0,  0, _, _],
    [ _, 45, _, 70,  0, _, _, _, 77,  9, _, _, _, _, _, _, _, _, _, _, _,  0,  0, _],
    [ 2, 56, _, 57, 35, _, _, _, _, _, 12, _, _, _, _, _, _, _, _, _, _, _,  0,  0],
    [24, _, 61, _, 60, _, _, 27, 51, _, _, 16,  1, _, _, _, _, _, _, _, _, _, _,  0],
], dtype=np.int64)

#: (n, rate numerator/denominator) -> (base matrix, Z)
_WIFI_TABLES = {
    (648, (1, 2)): (WIFI_648_12, 27),
    (1296, (1, 2)): (WIFI_1296_12, 54),
    (1944, (1, 2)): (WIFI_1944_12, 81),
}


def wifi_code(n: int = 1944, rate: tuple = (1, 2), with_G: bool = True,
              with_layers: bool = True) -> LDPCCode:
    """A bundled 802.11n code (``n`` in {648, 1296, 1944}, rate 1/2) with
    its QC metadata, by default its natural one-layer-per-base-row
    schedule and a systematic generator."""
    key = (n, tuple(rate))
    if key not in _WIFI_TABLES:
        raise ValueError(
            f"no bundled 802.11n table for n={n}, rate={rate[0]}/{rate[1]} "
            f"(bundled: n in {{648, 1296, 1944}} at rate 1/2)")
    base, Z = _WIFI_TABLES[key]
    code = expand_qc(base, Z)
    if with_layers:
        qc_natural_layers(code)
    if with_G:
        code.G = systematic_generator(code)
        if code.G is None:  # pragma: no cover - the tables are full rank
            raise RuntimeError("bundled table unexpectedly rank deficient")
    return code


def load_base_matrix(path: str) -> np.ndarray:
    """A QC base matrix from a whitespace table: one row per line, ``-1``
    or ``-`` for an empty block, shifts otherwise; ``#`` starts a comment
    line."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([-1 if tok == "-" else int(tok) for tok in line.split()])
    if not rows:
        raise ValueError(f"no base-matrix rows in {path!r}")
    if any(len(r) != len(rows[0]) for r in rows):
        raise ValueError(f"ragged base-matrix rows in {path!r}")
    return np.asarray(rows, dtype=np.int64)


#: The 51 NR lifting sizes ``Z = a * 2^j``, one set per ``a`` (TS 38.212
#: Table 5.3.2-1), by lifting-set index.
NR_LIFTING_SETS = {
    0: (2, 4, 8, 16, 32, 64, 128, 256),
    1: (3, 6, 12, 24, 48, 96, 192, 384),
    2: (5, 10, 20, 40, 80, 160, 320),
    3: (7, 14, 28, 56, 112, 224),
    4: (9, 18, 36, 72, 144, 288),
    5: (11, 22, 44, 88, 176, 352),
    6: (13, 26, 52, 104, 208),
    7: (15, 30, 60, 120, 240),
}

#: BG1: 46 x 68 base (22 info columns); BG2: 42 x 52 base (10 info columns).
NR_BG_SHAPE = {1: (46, 68), 2: (42, 52)}
NR_BG_INFO_COLS = {1: 22, 2: 10}


def nr_lifting_sizes() -> tuple:
    """All 51 NR lifting sizes, ascending."""
    return tuple(sorted(z for zs in NR_LIFTING_SETS.values() for z in zs))


def nr_set_index(Z: int) -> int:
    """The lifting-set index iLS of a lifting size (Table 5.3.2-1)."""
    for i, zs in NR_LIFTING_SETS.items():
        if Z in zs:
            return i
    raise ValueError(f"Z={Z} is not an NR lifting size")


def load_nr_shift_table(path: str, Z: int, bg: int = 1) -> np.ndarray:
    """The NR base matrix of lifting size ``Z`` from a shift-table file
    (TS 38.212 Table 5.3.2-2 for BG1, 5.3.2-3 for BG2): one line per
    base-graph edge, ``row col V0 .. V7`` (the shift of each lifting set)
    or ``row col V`` (already resolved), ``#`` comments; the shift applied is
    ``V[iLS(Z)] mod Z``.  Warns when the edge count is not the standard's
    (316 for BG1, 197 for BG2)."""
    mb, nb = NR_BG_SHAPE[bg]
    ils = nr_set_index(Z)
    base = np.full((mb, nb), -1, dtype=np.int64)
    n_edges = 0
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            toks = line.split()
            r, c = int(toks[0]), int(toks[1])
            vals = [int(t) for t in toks[2:]]
            if len(vals) == 1:
                v = vals[0]
            elif len(vals) == 8:
                v = vals[ils]
            else:
                raise ValueError(f"shift-table line needs 1 or 8 V values, got {len(vals)}: "
                                 f"{line!r}")
            if not (0 <= r < mb and 0 <= c < nb):
                raise ValueError(f"edge ({r}, {c}) outside BG{bg} shape")
            if base[r, c] >= 0:
                raise ValueError(f"duplicate edge ({r}, {c})")
            base[r, c] = v % Z
            n_edges += 1
    expect = {1: 316, 2: 197}[bg]
    if n_edges != expect:
        warnings.warn(f"BG{bg} shift table has {n_edges} edges, the standard has {expect} "
                      "— proceeding with the loaded set")
    return base


def make_nr_like_code(bg: int = 2, Z: int = 208, seed: int = 0, with_G: bool = True,
                      with_layers: bool = True, puncture_info: bool = True) -> LDPCCode:
    """A synthetic code with 5G-NR's skeleton, not the standard's
    connectivity: the BG1/BG2 shape, a 4-row core with pseudo-random info
    shifts over an encoding-friendly parity prototype (a column into all
    four core rows, then a dual diagonal), degree-1 extension parity rows,
    and, with ``puncture_info``, the first ``2Z`` info bits punctured.  Any
    NR lifting size; the same arguments give the JAX package's code.

    ``with_G`` raises ``ValueError`` when H has no systematic generator
    (the JAX copy leaves ``G`` None then)."""
    if Z not in nr_lifting_sizes():
        raise ValueError(f"Z={Z} is not an NR lifting size")
    mb, nb = NR_BG_SHAPE[bg]
    kb = NR_BG_INFO_COLS[bg]
    rng = np.random.default_rng(seed)
    base = np.full((mb, nb), -1, dtype=np.int64)
    for r in range(4):  # the core rows over ~3/4 of the info columns
        for c in rng.choice(kb, size=max(2, (3 * kb) // 4), replace=False):
            base[r, c] = int(rng.integers(0, Z))
    for c in range(kb):  # every info column in a core row
        if (base[:4, c] < 0).all():
            base[int(rng.integers(0, 4)), c] = int(rng.integers(0, Z))
    base[0:4, kb] = (1, 0, 0, 1)  # the core parity column, one shift-1 pin each end
    for r in range(3):  # the dual diagonal
        base[r, kb + 1 + r] = 0
        base[r + 1, kb + 1 + r] = 0
    for r in range(4, mb):  # extension rows: a few taps and the row's own parity column
        for c in rng.choice(kb + 4, size=int(rng.integers(2, 5)), replace=False):
            base[r, c] = int(rng.integers(0, Z))
        base[r, kb + r] = 0
    code = expand_qc(base, Z)
    if puncture_info:
        code.puncture = np.arange(2 * Z, dtype=np.int32)
    if with_layers:
        qc_natural_layers(code)
    if with_G:
        code.G = systematic_generator(code)
        if code.G is None:
            raise ValueError(f"make_nr_like_code(bg={bg}, Z={Z}, seed={seed}): H has no "
                             "systematic generator; pass with_G=False")
    return code
