"""The LDPC code model: H as an edge list, an optional generator G, the
puncture/shorten patterns, decoding layers and QC structure.

A copy of :class:`libldpc_tpu.models.code.LDPCCode` without the JAX
package's padded edge layout (the port builds its own sorted layout,
:mod:`..ops.sorted`).  Dimensions and ``bit_pos`` follow the reference's
``ldpc_code``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np

from . import gf2, io


@dataclasses.dataclass
class LDPCCode:
    """An LDPC code: parity-check matrix H (edges in file order), optional
    generator G, puncture/shorten patterns and derived sizes."""

    rows: np.ndarray  # int32 [nnz] check index per edge, file order
    cols: np.ndarray  # int32 [nnz] variable index per edge, file order
    nc: int
    mc: int
    puncture: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    shorten: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    G: Optional[np.ndarray] = None  # dense uint8 [kc, nc]
    layers: Optional[list[np.ndarray]] = None  # check index lists, layered schedule
    #: quasi-cyclic structure, when known: ``(Z, base_matrix)`` with
    #: ``base_matrix[mb, nb]`` of shifts (-1 = zero block)
    qc: Optional[tuple[int, np.ndarray]] = None

    @classmethod
    def from_files(cls, pc_file: str, gen_file: str = "", layer_file: str = "") -> "LDPCCode":
        """Load from a codefile (+ optional G file and layer file)."""
        parsed = io.parse_codefile(pc_file)
        return cls(
            rows=parsed.rows,
            cols=parsed.cols,
            nc=parsed.nc,
            mc=parsed.mc,
            puncture=parsed.puncture,
            shorten=parsed.shorten,
            G=io.parse_genfile(gen_file, nc=parsed.nc) if gen_file else None,
            layers=io.parse_layerfile(layer_file) if layer_file else None,
        )

    @classmethod
    def from_alist(cls, path: str) -> "LDPCCode":
        """Load H from an alist file (:func:`.io.parse_alist`)."""
        parsed = io.parse_alist(path)
        return cls(rows=parsed.rows, cols=parsed.cols, nc=parsed.nc, mc=parsed.mc)

    def save(self, path: str, headered: bool = True) -> None:
        """Write H in the reference's codefile format."""
        io.write_codefile(path, self.rows, self.cols, self.nc, self.mc,
                          puncture=self.puncture, shorten=self.shorten, headered=headered)

    def save_alist(self, path: str) -> None:
        io.write_alist(path, self.rows, self.cols, self.nc, self.mc)

    @classmethod
    def from_dense(cls, H: np.ndarray, **kwargs) -> "LDPCCode":
        H = np.asarray(H, dtype=np.uint8) & 1
        r, c = np.nonzero(H)
        return cls(rows=r.astype(np.int32), cols=c.astype(np.int32),
                   nc=H.shape[1], mc=H.shape[0], **kwargs)

    @property
    def nnz(self) -> int:
        return int(self.rows.size)

    @property
    def kc(self) -> int:
        return self.nc - self.mc

    @property
    def nct(self) -> int:
        """Transmitted block length."""
        return self.nc - len(self.puncture) - len(self.shorten)

    @property
    def mct(self) -> int:
        return self.mc - len(self.puncture)

    @property
    def kct(self) -> int:
        return self.nct - self.mct

    @functools.cached_property
    def bit_pos(self) -> np.ndarray:
        """Indices of the transmitted bits (neither punctured nor shortened),
        ascending."""
        keep = np.ones(self.nc, dtype=bool)
        keep[np.asarray(self.puncture, dtype=np.int64)] = False
        keep[np.asarray(self.shorten, dtype=np.int64)] = False
        return np.nonzero(keep)[0].astype(np.int32)

    @functools.cached_property
    def H_dense(self) -> np.ndarray:
        H = np.zeros((self.mc, self.nc), dtype=np.uint8)
        H[self.rows, self.cols] ^= 1
        return H

    def rank(self) -> int:
        """GF(2) rank of H."""
        return gf2.rank(self.H_dense)

    def encode(self, info_word: np.ndarray) -> np.ndarray:
        """The full codeword ``u @ G`` (length ``nc``) of an info word of
        G's row count."""
        if self.G is None:
            raise RuntimeError("No generator matrix provided for encoding")
        return gf2.vec_mat(info_word, self.G).astype(np.uint8)

    def syndrome(self, word: np.ndarray) -> np.ndarray:
        """``H @ v`` over GF(2), length ``mc``."""
        return gf2.mat_vec(self.H_dense, word).astype(np.uint8)

    @property
    def rate(self) -> float:
        """Rate of the transmitted code."""
        return 1.0 - self.mct / self.nct

    def summary(self) -> str:
        """Code summary in the reference's print format."""
        lines = [
            f"N : {self.nc}",
            f"M : {self.mc}",
            f"K : {self.kc}",
            f"NNZ : {self.nnz}",
            f"puncture[{len(self.puncture)}] : {list(self.puncture)}",
            f"shorten[{len(self.shorten)}] : {list(self.shorten)}",
            f"Rate : {self.rate:g}",
            f"N (transmitted) : {self.nct}",
            f"M (transmitted) : {self.mct}",
            f"K (transmitted) : {self.kct}",
        ]
        return "\n".join(lines)
