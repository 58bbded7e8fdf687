"""The reference's on-disk formats, parsed and written on the host.

A copy of the NumPy paths of :mod:`libldpc_tpu.models.io` that the port
uses, plus :func:`write_layerfile`:

* **codefile**: one ``row col`` pair per nonzero of H; any line holding
  ``:`` is a header, from which ``puncture``/``shorten`` lists and the
  ``nc:/mc:/nnz:`` counts are taken (both dialects of the reference);
* **generator file**: ``row col`` pairs of G;
* **layerfile**: ``nl:`` and per layer ``cn[i]: <count>`` and its checks;
* **simfile** and **mapfile** (the reference's GPU simulator): the
  sweep and its M-ASK constellation, and the bit-to-symbol map;
* **alist** (MacKay's interchange format, not the reference's): ``n m``,
  ``max_dv max_dc``, the column and row degrees, then each column's and
  each row's 1-based lists, 0-padded;
* **results file**: ``snr fer ber frames avg_iter frame_time`` rows,
  rewritten whole on every update.

Dimensions are inferred from the largest indices (+1), widened by the
declared counts.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass
class ParsedCode:
    """Raw result of parsing a codefile."""

    rows: np.ndarray  # int32 [nnz] check index per edge
    cols: np.ndarray  # int32 [nnz] variable index per edge
    nc: int
    mc: int
    puncture: np.ndarray  # int32, variable indices
    shorten: np.ndarray  # int32, variable indices


def _parse_header_line(line: str, puncture: list, shorten: list, counts: dict) -> None:
    token, _, rest = line.partition(":")
    token = token.strip().lower()
    values = rest.split()
    if "puncture" in token:
        puncture.extend(int(v) for v in values)
    elif "shorten" in token:
        shorten.extend(int(v) for v in values)
    else:
        key = token.split("[")[0].strip()
        if key in ("nc", "mc", "nct", "mct", "nnz") and values:
            try:
                counts[key] = int(values[0])
            except ValueError:
                pass


def parse_codefile(path: str) -> ParsedCode:
    """Parse a parity-check codefile (either dialect)."""
    puncture: list[int] = []
    shorten: list[int] = []
    counts: dict[str, int] = {}
    data_lines: list[str] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if ":" in line:
                _parse_header_line(line, puncture, shorten, counts)
            else:
                data_lines.append(line)
    pairs = np.array([ln.split()[:2] for ln in data_lines], dtype=np.int32).reshape(-1, 2)
    rows, cols = pairs[:, 0].copy(), pairs[:, 1].copy()
    if rows.size == 0:
        raise ValueError(f"{path}: no matrix entries found")
    # declared nc:/mc: win if larger: trailing all-zero rows/columns are
    # invisible to the pair list
    mc = max(int(rows.max()) + 1, counts.get("mc", 0))
    nc = max(int(cols.max()) + 1, counts.get("nc", 0))
    if "nnz" in counts and counts["nnz"] != rows.size:
        raise ValueError(f"{path}: header declares nnz={counts['nnz']} but parsed {rows.size}")
    return ParsedCode(
        rows=rows.astype(np.int32),
        cols=cols.astype(np.int32),
        nc=nc,
        mc=mc,
        puncture=np.asarray(sorted(set(puncture)), dtype=np.int32),
        shorten=np.asarray(sorted(set(shorten)), dtype=np.int32),
    )


def parse_genfile(path: str, nc: Optional[int] = None) -> np.ndarray:
    """Parse a generator-matrix file into a dense uint8 ``[kc, nc]`` array,
    widened to ``nc`` columns when given."""
    pairs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or ":" in line:
                continue
            a = line.split()
            pairs.append((int(a[0]), int(a[1])))
    arr = np.asarray(pairs, dtype=np.int32).reshape(-1, 2)
    rows, cols = arr[:, 0], arr[:, 1]
    kc = int(rows.max()) + 1
    n = int(cols.max()) + 1
    if nc is not None:
        n = max(n, nc)
    G = np.zeros((kc, n), dtype=np.uint8)
    G[rows, cols] ^= 1
    return G


def parse_layerfile(path: str) -> list[np.ndarray]:
    """Parse a decoding-layer file: ``nl: <N>`` then per layer
    ``cn[i]: <count>`` followed by that many check indices."""
    with open(path) as f:
        tokens: list[str] = []
        for line in f:
            tokens.extend(line.replace(":", " : ").split())
    it = iter(tokens)
    layers: list[np.ndarray] = []

    def expect_count() -> int:
        next(it)  # name
        next(it)  # ':'
        return int(next(it))

    nl = expect_count()
    for _ in range(nl):
        lw = expect_count()
        layers.append(np.array([int(next(it)) for _ in range(lw)], dtype=np.int32))
    return layers


def write_layerfile(path: str, layers) -> None:
    """Write decoding layers (lists of check indices) in the format
    :func:`parse_layerfile` reads: ``nl: <N>``, then per layer
    ``cn[i]: <count>`` followed by its check indices, one per line."""
    lines = [f"nl: {len(layers)}"]
    for i, layer in enumerate(layers):
        lines.append(f"cn[{i}]: {len(layer)}")
        lines.extend(str(int(c)) for c in layer)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


@dataclasses.dataclass
class SimFile:
    """The simulation file of the reference's GPU simulator: results file
    name, constellation size M, bits per symbol, point labels, SNRs, max
    frames, min frame errors, BP iterations, early termination."""

    name: str
    M: int
    bits: int
    labels: np.ndarray
    snrs: np.ndarray
    max_frames: int
    min_fec: int
    bp_iter: int
    early_term: bool


def parse_simfile(path: str) -> SimFile:
    """Parse a simulation file: nine non-empty ``key: value`` lines in the
    order of :class:`SimFile`'s fields, lists comma- or space-separated."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]

    def value(i: int) -> str:
        return lines[i].partition(":")[2].strip()

    M = int(value(1))
    labels = np.array([int(t) for t in value(3).replace(",", " ").split()], dtype=np.int32)
    if labels.size != M:
        raise ValueError(f"{path}: number of constellation labels ({labels.size}) != M ({M})")
    return SimFile(
        name=value(0), M=M, bits=int(value(2)), labels=labels,
        snrs=np.array([float(t) for t in value(4).replace(",", " ").split()]),
        max_frames=int(value(5)), min_fec=int(value(6)), bp_iter=int(value(7)),
        early_term=bool(int(value(8))),
    )


def parse_mapfile(path: str, bits: int, n_sym: int) -> np.ndarray:
    """Parse a bit-to-symbol map: ``bits * n_sym`` codeword-bit indices,
    comma- or space-separated, row-major ``[bits, n_sym]`` (entries past
    them are ignored)."""
    with open(path) as f:
        vals = [int(t) for t in f.read().replace(",", " ").split()]
    if len(vals) < bits * n_sym:
        raise ValueError(f"{path}: expected {bits * n_sym} mapping entries, got {len(vals)}")
    return np.array(vals[: bits * n_sym], dtype=np.int32).reshape(bits, n_sym)


def write_codefile(
    path: str,
    rows: np.ndarray,
    cols: np.ndarray,
    nc: int,
    mc: int,
    puncture: Optional[np.ndarray] = None,
    shorten: Optional[np.ndarray] = None,
    headered: bool = True,
) -> None:
    """Write a codefile: with ``headered``, the ``nc:/mc:/nct:/mct:/nnz:``
    counts and the ``puncture``/``shorten`` lines, then the pairs."""
    puncture = np.asarray(puncture if puncture is not None else [], dtype=np.int64)
    shorten = np.asarray(shorten if shorten is not None else [], dtype=np.int64)
    with open(path, "w") as f:
        if headered:
            nct = nc - puncture.size - shorten.size
            mct = mc - puncture.size
            f.write(f"nc: {nc}\nmc: {mc}\nnct: {nct}\nmct: {mct}\n")
            f.write(f"nnz: {len(rows)}\n")
            f.write(f"puncture [{puncture.size}]: " + " ".join(map(str, puncture)) + "\n")
            f.write(f"shorten [{shorten.size}]: " + " ".join(map(str, shorten)) + "\n")
        for r, c in zip(rows, cols):
            f.write(f"{r} {c}\n")


def parse_alist(path: str) -> ParsedCode:
    """Parse an alist file; edges come out sorted by (row, column).  Only
    the column lists are read: the row lists repeat them."""
    with open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)
    n, m, max_dv = int(next(it)), int(next(it)), int(next(it))
    next(it)  # max_dc
    col_deg = [int(next(it)) for _ in range(n)]
    for _ in range(m):
        next(it)  # row degrees
    rows_list: list[int] = []
    cols_list: list[int] = []
    for v in range(n):
        for _ in range(max_dv):
            r = int(next(it))
            if r > 0:  # 0 entries are padding
                rows_list.append(r - 1)
                cols_list.append(v)
    if len(cols_list) != sum(col_deg):
        raise ValueError(f"{path}: alist degree lists inconsistent")
    order = np.lexsort((np.asarray(cols_list), np.asarray(rows_list)))
    return ParsedCode(
        rows=np.asarray(rows_list, dtype=np.int32)[order],
        cols=np.asarray(cols_list, dtype=np.int32)[order],
        nc=n,
        mc=m,
        puncture=np.zeros(0, np.int32),
        shorten=np.zeros(0, np.int32),
    )


def write_alist(path: str, rows: np.ndarray, cols: np.ndarray, nc: int, mc: int) -> None:
    """Write H in alist format."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    col_lists = [sorted(rows[cols == v].tolist()) for v in range(nc)]
    row_lists = [sorted(cols[rows == r].tolist()) for r in range(mc)]
    max_dv = max((len(x) for x in col_lists), default=0)
    max_dc = max((len(x) for x in row_lists), default=0)
    with open(path, "w") as f:
        f.write(f"{nc} {mc}\n{max_dv} {max_dc}\n")
        f.write(" ".join(str(len(x)) for x in col_lists) + "\n")
        f.write(" ".join(str(len(x)) for x in row_lists) + "\n")
        for lists, width in ((col_lists, max_dv), (row_lists, max_dc)):
            for lst in lists:
                padded = [v + 1 for v in lst] + [0] * (width - len(lst))
                f.write(" ".join(map(str, padded)) + "\n")


def write_results_file(
    path: str,
    rows: Sequence[str],
    header: str = "snr fer ber frames avg_iter frame_time",
    comment: str = "",
) -> None:
    """Atomically rewrite the whole results table; ``comment`` (the decode
    path's provenance) goes on a ``#`` line above the column header."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        if comment:
            f.write(f"# {comment}\n")
        f.write(header + "\n")
        for row in rows:
            if row:
                f.write(row + "\n")
    os.replace(tmp, path)


def format_result_row(
    x: float,
    fer: float,
    ber: float,
    frames: int,
    avg_iter: float,
    frame_time_s: Optional[float] = None,
) -> str:
    """One results-file row in the reference's column format."""
    base = f"{x:f} {fer:.3e} {ber:.3e} {frames} {avg_iter:.3e}"
    if frame_time_s is not None:
        base += f" {frame_time_s:.6f}"
    return base
