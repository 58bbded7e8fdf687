"""Index tables for the CUDA decode kernels.

The kernels walk the sorted layout (:mod:`..sorted`) node by node, one
thread per frame: a check's edges are a contiguous range of CN-space slots
(``row_ptr``), a variable's edges a contiguous range of VN-space slots
(``vn_ptr``) whose CN-space slots ``perm_c2v`` gives, and ``col_sorted``
names the variable on each CN-space slot.  On the GPU the CN<->VN
permutation is therefore an indexed load from these tables; the TPU
kernels' Beneš, Clos and one-hot transports have no counterpart here.

For the layered schedule the tables add each layer's checks (sorted
labels, CSR over ``layer_ptr``) and each layer's variables (CSR over
``layer_var_ptr``), built from the sorted code's per-slot layer masks by
:mod:`..layered`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import layered
from ..sorted import TorchSortedCode


@dataclasses.dataclass
class KernelTables:
    """int32 tables of one code on one device, plus the sorted code they
    were built from (the plain versions decode over it)."""

    code: TorchSortedCode
    row_ptr: torch.Tensor  # int32 [mc + 1] CN-space slot range per check
    vn_ptr: torch.Tensor  # int32 [nc + 1] VN-space slot range per variable
    col_sorted: torch.Tensor  # int32 [nnz] variable per CN-space slot
    perm_c2v: torch.Tensor  # int32 [nnz] CN-space slot per VN-space slot
    bit_pos: torch.Tensor  # int32 [nct] transmitted variables
    max_dc: int
    layer_ptr: torch.Tensor  # int32 [nl + 1] check range per layer ([0] without layers)
    layer_checks: torch.Tensor  # int32 [sum] sorted check labels, layer by layer
    layer_var_ptr: torch.Tensor  # int32 [nl + 1] variable range per layer ([0] without layers)
    layer_vars: torch.Tensor  # int32 [sum] sorted labels of the variables each layer reaches
    #: per layer, its checks' CN-space slots grouped by degree (int64
    #: ``[count, d]`` each): the plain fast engine's gather indices
    layer_slots: tuple
    #: no layer reaches a variable twice, so one layer's APP updates are
    #: independent: the fast engine's precondition
    layers_disjoint: bool

    @property
    def n_layers(self) -> int:
        return self.layer_ptr.shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device


def _node_ptr(classes) -> np.ndarray:
    degrees = np.repeat([d for _, d in classes], [c for c, _ in classes])
    return np.concatenate([[0], np.cumsum(degrees)]).astype(np.int32)


def kernel_tables(sdc: TorchSortedCode) -> KernelTables:
    """Build the kernels' tables on ``sdc``'s device."""
    if sdc.nnz >= 2**31:
        raise ValueError(f"nnz {sdc.nnz} overflows the kernels' int32 slot index")

    def dev(x):
        return torch.as_tensor(x).to(sdc.device)

    row_ptr = _node_ptr(sdc.cn_classes)
    masks = (np.zeros((0, sdc.nnz), dtype=bool) if sdc.layer_edge_masks is None
             else sdc.layer_edge_masks.cpu().numpy())
    layer_ptr, layer_checks = layered.layer_check_lists(row_ptr, masks)
    groups = layered.layer_slot_groups(row_ptr, layer_ptr, layer_checks)
    col = sdc.col_sorted.cpu().numpy()
    layer_var_ptr, layer_vars = layered.layer_variable_lists(row_ptr, col, layer_ptr, layer_checks)
    return KernelTables(
        code=sdc,
        row_ptr=dev(row_ptr),
        vn_ptr=dev(_node_ptr(sdc.vn_classes)),
        col_sorted=sdc.col_sorted.contiguous(),
        perm_c2v=sdc.perm_c2v.contiguous(),
        bit_pos=sdc.bit_pos.contiguous(),
        max_dc=sdc.max_dc,
        layer_ptr=dev(layer_ptr),
        layer_checks=dev(layer_checks),
        layer_var_ptr=dev(layer_var_ptr),
        layer_vars=dev(layer_vars),
        layer_slots=tuple(tuple(dev(g.astype(np.int64)) for g in layer) for layer in groups),
        layers_disjoint=layered.layers_touch_variables_once(col, groups),
    )
