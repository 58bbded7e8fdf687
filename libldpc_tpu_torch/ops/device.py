"""The padded layout's tables on a device (from :mod:`libldpc_tpu.ops.device`).

:class:`DeviceCode` holds the padded CN-major edge layout of
:class:`~..models.code.EdgeLayout` as tensors (``E = mc * max_dc`` slots,
padding slots naming the dummy variable ``nc``), the code's
``bit_pos``/``puncture``/``shorten``, its generator and, with layers, the
per-layer check masks, all in the code's own labelling.  The padded
decoders (:mod:`.decoder`, :mod:`.bec`) take it.

A CUDA ``DeviceCode`` also carries, privately, the kernel tables of the
code's sorted layout (:mod:`.kernels.layout`) and the variable
permutation between the two labellings, built once in :func:`to_device`:
on the card the padded decoders run the CUDA kernels on the sorted layout
and permute rows in and out.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models.code import LDPCCode

#: Large-but-finite LLR used as the box-plus / min-sum identity on padding
#: slots: ``boxplus(x, PAD_LLR) == x`` exactly in float32.
PAD_LLR = 1e30


@dataclasses.dataclass
class DeviceCode:
    """Static index tables as tensors on one device.

    Shapes: ``E = mc * max_dc`` padded CN-major edge slots."""

    pad_col: torch.Tensor  # int32 [E]  VN index per slot; nc = dummy VN
    cn_mask: torch.Tensor  # bool  [mc, max_dc]
    vn_edges: torch.Tensor  # int32 [nc, max_dv]  (E sentinel for padding)
    vn_mask: torch.Tensor  # bool  [nc, max_dv]
    edge_vslot: torch.Tensor  # int32 [E] -> flattened [nc * max_dv] slot (nc * max_dv: padding)
    bit_pos: torch.Tensor  # int32 [nct]
    puncture: torch.Tensor  # int32 [P]
    shorten: torch.Tensor  # int32 [S]
    G: Optional[torch.Tensor]  # float32 [kc, nc] 0/1 values, or None
    layer_masks: Optional[torch.Tensor]  # bool [nl, mc], or None
    #: the host code and ``with_layers`` (:meth:`to` rebuilds from them)
    _code: LDPCCode = dataclasses.field(repr=False, default=None)
    _with_layers: bool = dataclasses.field(repr=False, default=False)
    #: on CUDA: the sorted layout's kernel tables, ``vn_perm`` (sorted label
    #: -> code label) and ``vn_inv`` (code label -> sorted label), int64
    _tables: object = dataclasses.field(repr=False, default=None)
    _vn_perm: Optional[torch.Tensor] = dataclasses.field(repr=False, default=None)
    _vn_inv: Optional[torch.Tensor] = dataclasses.field(repr=False, default=None)

    # ------------------------------------------------------------ dimensions
    @property
    def E(self) -> int:
        return self.pad_col.shape[0]

    @property
    def mc(self) -> int:
        return self.cn_mask.shape[0]

    @property
    def max_dc(self) -> int:
        return self.cn_mask.shape[1]

    @property
    def nc(self) -> int:
        return self.vn_edges.shape[0]

    @property
    def max_dv(self) -> int:
        return self.vn_edges.shape[1]

    @property
    def nct(self) -> int:
        return self.bit_pos.shape[0]

    @property
    def kc(self) -> int:
        if self.G is None:
            raise RuntimeError("code has no generator matrix")
        return self.G.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pad_col.device

    def to(self, device) -> "DeviceCode":
        """The same code's tables on ``device``."""
        return to_device(self._code, self._with_layers, device)


def to_device(code: LDPCCode, with_layers: bool = False, device="cuda") -> DeviceCode:
    """Build the padded tables of ``code`` on ``device`` (the card unless
    the caller names another); ``with_layers`` adds the layer masks
    (:meth:`~..models.code.LDPCCode.layer_masks`).  On CUDA the kernel
    tables of the sorted layout are built too, once."""
    lay = code.layout
    dev = torch.device(device)

    def put(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(np.asarray(x, dtype=dtype))).to(dev)

    tables = vn_perm = vn_inv = None
    if dev.type == "cuda":
        from .kernels.layout import kernel_tables
        from .sorted import to_sorted_device

        tables = kernel_tables(to_sorted_device(code, dev, with_layers=with_layers))
        vn_perm = tables.code.vn_perm.long()
        vn_inv = tables.code.vn_inv.long()
    return DeviceCode(
        pad_col=put(lay.pad_col, np.int32),
        cn_mask=put(lay.cn_mask, bool),
        vn_edges=put(lay.vn_edges, np.int32),
        vn_mask=put(lay.vn_mask, bool),
        edge_vslot=put(lay.edge_vslot, np.int32),
        bit_pos=put(code.bit_pos, np.int32),
        puncture=put(code.puncture, np.int32),
        shorten=put(code.shorten, np.int32),
        G=None if code.G is None else put(code.G, np.float32),
        layer_masks=put(code.layer_masks(), bool) if with_layers else None,
        _code=code,
        _with_layers=with_layers,
        _tables=tables,
        _vn_perm=vn_perm,
        _vn_inv=vn_inv,
    )


def degrees_from_mask(mask: np.ndarray) -> np.ndarray:
    return mask.sum(axis=1).astype(np.int32)
