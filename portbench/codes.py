"""The benchmark's codes, built from their definitions in a configuration
file, and written in the reference simulator's file formats.

Frozen copies (from ``libldpc_tpu_torch/models`` at commit c083e37) of the
constructions the configurations name, so that the codes the program and
the reference both read are made here and never by the program:

* ``"regular"``: the (dv, dc)-regular configuration model with duplicate
  edges swapped away, ``make_regular_code``; with ``"with_G"``, the first
  seed ``seed + 1000 * attempt`` whose H gives a full-rank generator
  (``make_benchmark_code``);
* ``"qc"``: a quasi-cyclic base matrix expanded at lifting ``Z``
  (``expand_qc``), with its natural layers, one per base row;
* the generator: bit-packed GF(2) elimination of H, identity on the free
  columns (``systematic_generator``), checked over H's edges
  (:func:`satisfies_checks`: each check's variables' columns of G, bit-packed,
  XOR to zero), which takes a second where a dense ``H G^T`` would take
  hours at 5G NR sizes;
* ``"puncture"``: ``[[start, stop], ...]``, half-open ranges of variable
  indices in the code's own labels that are never transmitted (their
  priors are 0); the transmitted bits are the others, ascending.

:func:`write_code_files` writes the codefile (``row col`` pairs with the
``nc:``/``mc:`` header and the ``puncture [k]:`` line that
``libldpc_tpu_torch/models/io.py`` reads), the generator file and the layer file that
``ldpcsim``'s command line takes, so the program loads the code as its CLI
loads it.  :func:`cached_code` keeps a built code and its files under a
name made from its definition and this file, so that only a checkout's
first run builds it (the generator's elimination takes seconds).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Code:
    """A code as the benchmark holds it: edges sorted by (check, variable)."""

    rows: np.ndarray  # int64 [nnz]
    cols: np.ndarray  # int64 [nnz]
    nc: int
    mc: int
    G: np.ndarray  # uint8 [kc, nc]
    layers: Optional[list] = None  # check index arrays, or None
    #: int64 [p] punctured variables, ascending
    puncture: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int64))

    @property
    def nnz(self) -> int:
        return int(self.rows.size)

    @property
    def transmitted(self) -> np.ndarray:
        """int64 ``[nct]``: the variables sent over the channel, ascending."""
        return np.setdiff1d(np.arange(self.nc, dtype=np.int64), self.puncture)

    @property
    def nct(self) -> int:
        return self.nc - int(self.puncture.size)

    @property
    def kc(self) -> int:
        return int(self.G.shape[0])

    def cn_classes(self) -> list:
        """``(count, degree)`` of the checks, by degree."""
        deg = np.bincount(self.rows, minlength=self.mc)
        vals, counts = np.unique(deg, return_counts=True)
        return [(int(c), int(d)) for d, c in zip(vals, counts)]


def _regular_edges(nc: int, dv: int, dc: int, seed: int, max_tries: int = 100):
    if (nc * dv) % dc:
        raise ValueError(f"nc*dv ({nc * dv}) must be divisible by dc ({dc})")
    rng = np.random.default_rng(seed)
    cols = np.repeat(np.arange(nc, dtype=np.int64), dv)
    rows = rng.permutation(nc * dv) // dc
    for _ in range(max_tries):
        key = rows.astype(np.int64) * nc + cols
        _, inverse, counts = np.unique(key, return_inverse=True, return_counts=True)
        dup = np.nonzero(counts[inverse] > 1)[0]
        if dup.size == 0:
            order = np.argsort(key, kind="stable")
            return rows[order].astype(np.int64), cols[order].astype(np.int64)
        move, seen = [], set()
        for p in dup:
            g = inverse[p]
            if g in seen:
                move.append(p)
            else:
                seen.add(g)
        move = np.array(move, dtype=np.int64)
        partners = rng.integers(0, nc * dv, size=move.size)
        taken = np.zeros(nc * dv, dtype=bool)
        taken[move] = True
        for i, p in enumerate(partners):
            if taken[p]:
                free = np.nonzero(~taken)[0]
                partners[i] = p = free[rng.integers(0, free.size)]
            taken[p] = True
        rows[move], rows[partners] = rows[partners].copy(), rows[move].copy()
    raise RuntimeError(f"no simple ({dv}, {dc}) graph in {max_tries} tries")


def systematic_generator(rows: np.ndarray, cols: np.ndarray, nc: int, mc: int):
    """A full-rank G with ``H G^T = 0`` (identity on the free columns), or
    None when H leaves no information set of ``nc - mc`` columns."""
    H = np.zeros((mc, nc), dtype=np.uint8)
    H[rows, cols] = 1
    words = -(-nc // 64)
    packed = np.zeros((mc, 8 * words), dtype=np.uint8)
    packed[:, :-(-nc // 8)] = np.packbits(H, axis=1, bitorder="little")
    R = packed.view("<u8").copy()
    pivots, r = [], 0
    for col in range(nc):
        if r >= mc:
            break
        w, bit = divmod(col, 64)
        mask = np.uint64(1) << np.uint64(bit)
        colbits = (R[r:, w] & mask) != 0
        if not colbits.any():
            continue
        p = r + int(np.argmax(colbits))
        if p != r:
            R[[r, p]] = R[[p, r]]
        sel = (R[:, w] & mask) != 0
        sel[r] = False
        R[sel] ^= R[r]
        pivots.append(col)
        r += 1
    piv = set(pivots)
    free = np.array([c for c in range(nc) if c not in piv], dtype=np.int64)
    k = nc - r
    if free.size != k or k != nc - mc:
        return None
    bits = (R[:r, :, None] >> np.arange(64, dtype=np.uint64)[None, None, :]) & np.uint64(1)
    Rd = bits.reshape(r, -1)[:, :nc].astype(np.uint8)
    G = np.zeros((k, nc), dtype=np.uint8)
    G[np.arange(k), free] = 1
    G[:, np.array(pivots, dtype=np.int64)] = Rd[:, free].T
    if not satisfies_checks(rows, cols, G):
        raise RuntimeError("generator fails H G^T = 0")
    return G


def satisfies_checks(rows: np.ndarray, cols: np.ndarray, G: np.ndarray) -> bool:
    """``H G^T = 0`` over GF(2), by H's edges: for every check, the XOR of
    the columns of ``G`` at its variables (each column bit-packed over
    G's rows) is zero."""
    rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
    order = np.argsort(rows, kind="stable")
    rows, cols = rows[order], cols[order]
    packed = np.packbits(np.asarray(G, np.uint8).T, axis=1)  # [nc, ceil(k / 8)]
    starts = np.flatnonzero(np.r_[True, rows[1:] != rows[:-1]])
    return not np.bitwise_xor.reduceat(packed[cols], starts, axis=0).any()


def _qc_edges(base: np.ndarray, Z: int):
    B = np.asarray(base, dtype=np.int64)
    rows, cols = [], []
    i = np.arange(Z, dtype=np.int64)
    for bi in range(B.shape[0]):
        for bj in range(B.shape[1]):
            if B[bi, bj] >= 0:
                rows.append(bi * Z + i)
                cols.append(bj * Z + (i + B[bi, bj]) % Z)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    order = np.lexsort((cols, rows))
    return rows[order], cols[order], B.shape[1] * Z, B.shape[0] * Z


def puncture_of(spec: dict, nc: int) -> np.ndarray:
    """The punctured variables of a ``"code"`` entry's ``"puncture"`` ranges."""
    ranges = spec.get("puncture", [])
    if any(not 0 <= a < b <= nc for a, b in ranges):
        raise ValueError(f"puncture ranges {ranges} outside [0, {nc})")
    return np.unique(np.concatenate([np.arange(a, b, dtype=np.int64) for a, b in ranges]
                                    + [np.zeros(0, np.int64)]))


def build_code(spec: dict) -> Code:
    """The code of a configuration's ``"code"`` entry."""
    code = _build_graph(spec)
    code.puncture = puncture_of(spec, code.nc)
    return code


def _build_graph(spec: dict) -> Code:
    kind = spec["construction"]
    if kind == "regular":
        nc, dv, dc, seed = spec["nc"], spec["dv"], spec["dc"], spec["seed"]
        mc = nc * dv // dc
        for attempt in range(20):
            rows, cols = _regular_edges(nc, dv, dc, seed + 1000 * attempt)
            G = systematic_generator(rows, cols, nc, mc)
            if G is not None:
                return Code(rows, cols, nc, mc, G)
        raise RuntimeError("no full-rank generator in 20 attempts")
    if kind == "qc":
        Z = spec["Z"]
        rows, cols, nc, mc = _qc_edges(np.asarray(spec["base_matrix"]), Z)
        G = systematic_generator(rows, cols, nc, mc)
        if G is None:
            raise RuntimeError("the base matrix is rank deficient")
        layers = None
        if spec.get("layers") == "natural":
            layers = [np.arange(r * Z, (r + 1) * Z) for r in range(mc // Z)]
        return Code(rows, cols, nc, mc, G, layers)
    raise ValueError(f"unknown construction {kind!r}")


def write_code_files(code: Code, directory: pathlib.Path) -> dict:
    """The codefile, generator file and (with layers) layer file of
    ``code`` in ``directory``: ``{"codefile", "genfile", "layerfile"}``
    paths (``layerfile`` empty without layers)."""
    directory.mkdir(parents=True, exist_ok=True)
    codefile = directory / "code.txt"
    p = code.puncture
    header = (f"nc: {code.nc}\nmc: {code.mc}\nnct: {code.nc - p.size}\nmct: {code.mc - p.size}\n"
              f"nnz: {code.nnz}\npuncture [{p.size}]: {' '.join(map(str, p.tolist()))}\n"
              f"shorten [0]: \n")
    pairs = "\n".join(f"{r} {c}" for r, c in zip(code.rows.tolist(), code.cols.tolist()))
    codefile.write_text(header + pairs + "\n")
    genfile = directory / "gen.txt"
    gr, gc = np.nonzero(code.G)
    genfile.write_text("\n".join(f"{r} {c}" for r, c in zip(gr.tolist(), gc.tolist())) + "\n")
    layerfile = ""
    if code.layers is not None:
        lines = [f"nl: {len(code.layers)}"]
        for i, layer in enumerate(code.layers):
            lines.append(f"cn[{i}]: {len(layer)}")
            lines.extend(str(int(c)) for c in layer)
        layerfile = directory / "layers.txt"
        layerfile.write_text("\n".join(lines) + "\n")
    return {"codefile": str(codefile), "genfile": str(genfile), "layerfile": str(layerfile)}


def cached_code(spec: dict, directory: pathlib.Path) -> tuple:
    """``(code, files)`` of a configuration's ``"code"`` entry: read from
    ``directory/<key>/`` where an earlier run left them, else built and
    written there.  The key hashes the entry and this file's source, so a
    changed definition or construction is built afresh."""
    key = hashlib.sha256(json.dumps(spec, sort_keys=True).encode()
                         + pathlib.Path(__file__).read_bytes()).hexdigest()[:16]
    d = directory / key
    arrays = d / "code.npz"
    if arrays.exists():
        with np.load(arrays) as z:
            layers = [z[f"layer{i}"] for i in range(int(z["n_layers"]))]
            code = Code(z["rows"], z["cols"], int(z["nc"]), int(z["mc"]), z["G"],
                        layers if int(z["n_layers"]) >= 0 else None, z["puncture"])
        layerfile = d / "layers.txt"
        return code, {"codefile": str(d / "code.txt"), "genfile": str(d / "gen.txt"),
                      "layerfile": str(layerfile) if code.layers is not None else ""}
    code = build_code(spec)
    files = write_code_files(code, d)
    layers = code.layers if code.layers is not None else []
    tmp = d / "code.npz.partial"
    with open(tmp, "wb") as f:  # written last: its presence means the files are whole
        np.savez(f, rows=code.rows, cols=code.cols, nc=code.nc, mc=code.mc, G=code.G,
                 puncture=code.puncture,
                 n_layers=len(layers) if code.layers is not None else -1,
                 **{f"layer{i}": np.asarray(l) for i, l in enumerate(layers)})
    os.replace(tmp, arrays)
    return code, files
