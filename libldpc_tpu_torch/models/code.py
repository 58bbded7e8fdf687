"""The LDPC code model: H as an edge list, an optional generator G, the
puncture/shorten patterns, decoding layers and QC structure.

A copy of :class:`libldpc_tpu.models.code.LDPCCode`.  Dimensions and
``bit_pos`` follow the reference's ``ldpc_code``.  Besides the sorted
layout the kernels walk (:mod:`..ops.sorted`), a code carries the JAX
package's **padded CN-major edge layout** (:class:`EdgeLayout`, ``.layout``):
row ``i`` owns the ``max_dc`` slots ``[i * max_dc, (i + 1) * max_dc)``,
edges in file order within a row, the unused slots padding; ``pad_col``
names each slot's variable (``nc``, a dummy, for padding) and
``vn_edges[nc, max_dv]`` each variable's slots in file order.  The padded
decoders (:mod:`..ops.decoder`, :mod:`..ops.bec`) run on it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np

from . import gf2, io


class EdgeLayout(NamedTuple):
    """Static (host, NumPy) index tables for the padded CN-major edge space."""

    pad_col: np.ndarray  # int32 [E]  VN index per padded edge slot (nc = dummy)
    pad_valid: np.ndarray  # bool [E]  True for real edges
    cn_mask: np.ndarray  # bool [mc, max_dc]
    vn_edges: np.ndarray  # int32 [nc, max_dv]  padded-slot index (E for padding)
    vn_mask: np.ndarray  # bool [nc, max_dv]
    edge_vslot: np.ndarray  # int32 [E]  padded slot -> index into the flattened
    #                        [nc * max_dv] VN-major space (nc * max_dv for padding)
    edge_perm: np.ndarray  # int32 [nnz]  file-order edge -> padded slot
    cn_degree: np.ndarray  # int32 [mc]
    vn_degree: np.ndarray  # int32 [nc]


def _build_layout(rows: np.ndarray, cols: np.ndarray, nc: int, mc: int) -> EdgeLayout:
    """The padded layout of H's edges (``rows``, ``cols`` in file order)."""
    nnz = rows.size
    cn_degree = np.bincount(rows, minlength=mc).astype(np.int32)
    vn_degree = np.bincount(cols, minlength=nc).astype(np.int32)
    max_dc = int(cn_degree.max()) if nnz else 0
    max_dv = int(vn_degree.max()) if nnz else 0
    E = mc * max_dc

    # stable sort by row keeps in-row file order (the reference's row order)
    order = np.argsort(rows, kind="stable")
    sorted_rows = rows[order]
    slot_in_row = np.arange(nnz) - np.concatenate([[0], np.cumsum(cn_degree)[:-1]])[sorted_rows]
    edge_perm = np.empty(nnz, dtype=np.int64)
    edge_perm[order] = sorted_rows.astype(np.int64) * max_dc + slot_in_row

    pad_col = np.full(E, nc, dtype=np.int32)
    pad_col[edge_perm] = cols
    pad_valid = np.zeros(E, dtype=bool)
    pad_valid[edge_perm] = True

    # per-VN padded slots, stable in file order; padding entries point at E
    vn_edges = np.full((nc, max_dv), E, dtype=np.int64)
    vn_mask = np.zeros((nc, max_dv), dtype=bool)
    corder = np.argsort(cols, kind="stable")
    slot_in_col = np.arange(nnz) - np.concatenate([[0], np.cumsum(vn_degree)[:-1]])[cols[corder]]
    vn_edges[cols[corder], slot_in_col] = edge_perm[corder]
    vn_mask[cols[corder], slot_in_col] = True

    # inverse: padded CN slot -> flattened VN-major slot
    edge_vslot = np.full(E, nc * max_dv, dtype=np.int64)
    edge_vslot[edge_perm[corder]] = cols[corder].astype(np.int64) * max_dv + slot_in_col

    return EdgeLayout(
        pad_col=pad_col,
        pad_valid=pad_valid,
        cn_mask=pad_valid.reshape(mc, max_dc),
        vn_edges=vn_edges.astype(np.int32),
        vn_mask=vn_mask,
        edge_vslot=edge_vslot.astype(np.int32),
        edge_perm=edge_perm.astype(np.int32),
        cn_degree=cn_degree,
        vn_degree=vn_degree,
    )


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
    def layout(self) -> EdgeLayout:
        """The padded CN-major edge layout (:class:`EdgeLayout`)."""
        return _build_layout(self.rows, self.cols, self.nc, self.mc)

    @property
    def max_dc(self) -> int:
        return self.layout.cn_mask.shape[1]

    @property
    def max_dv(self) -> int:
        return self.layout.vn_mask.shape[1]

    @property
    def max_degree(self) -> int:
        """Max over check and variable degrees."""
        return max(self.max_dc, self.max_dv)

    def layer_masks(self) -> np.ndarray:
        """bool ``[num_layers, mc]`` check membership of each layer; one
        all-true layer without layers."""
        if not self.layers:
            return np.ones((1, self.mc), dtype=bool)
        masks = np.zeros((len(self.layers), self.mc), dtype=bool)
        for i, layer in enumerate(self.layers):
            masks[i, layer] = True
        return masks

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
