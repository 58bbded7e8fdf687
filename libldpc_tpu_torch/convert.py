"""Carry the JAX package's state into the port.

The system has no weights: a code and its index tables are its parameters, and a
streaming sweep's state is the per-lane decode state.  These functions take
that state from the JAX package as NumPy arrays (``np.asarray`` of each
field) and build the port's counterparts, so both packages can compute from
identical tables and state: the sorted layout, the edge-major streaming
state (:func:`from_pstream_state`) and the lane-major one
(:func:`from_lstream_state`, the fast layered engine's), in every message
dtype.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .models.code import LDPCCode
from .ops.messages import TORCH_DTYPES
from .ops.sorted import TorchSortedCode
from .ops.streaming_fused import StreamState


def code_from_jax(jax_code) -> LDPCCode:
    """The port's :class:`LDPCCode` from the NumPy fields of a JAX
    ``LDPCCode``: ``rows``, ``cols``, ``nc``, ``mc``, ``G``, ``puncture``,
    ``shorten``, ``layers`` and ``qc``, each copied."""
    G, layers, qc = jax_code.G, jax_code.layers, jax_code.qc
    return LDPCCode(
        rows=np.array(jax_code.rows, dtype=np.int32),
        cols=np.array(jax_code.cols, dtype=np.int32),
        nc=int(jax_code.nc),
        mc=int(jax_code.mc),
        puncture=np.array(jax_code.puncture, dtype=np.int32),
        shorten=np.array(jax_code.shorten, dtype=np.int32),
        G=None if G is None else np.array(G, dtype=np.uint8),
        layers=None if layers is None else [np.array(l, dtype=np.int32) for l in layers],
        qc=None if qc is None else (int(qc[0]), np.array(qc[1], dtype=np.int64)),
    )


def from_sorted_device(arrays: Mapping, device="cpu") -> TorchSortedCode:
    """A :class:`TorchSortedCode` from the fields of JAX's
    ``SortedDeviceCode``: ``col_sorted``, ``perm_c2v``, ``bit_pos``,
    ``puncture``, ``shorten``, ``vn_perm``, ``vn_inv``, ``G`` (or None),
    ``layer_edge_masks`` (or None; optional) and the
    ``cn_classes``/``vn_classes`` tuples."""
    cn_classes = tuple((int(c), int(d)) for c, d in arrays["cn_classes"])
    vn_classes = tuple((int(c), int(d)) for c, d in arrays["vn_classes"])

    def idx(name):
        return torch.as_tensor(np.asarray(arrays[name], dtype=np.int32)).to(device)

    G = arrays.get("G")
    masks = arrays.get("layer_edge_masks")
    return TorchSortedCode(
        nc=sum(c for c, _ in vn_classes),
        mc=sum(c for c, _ in cn_classes),
        nnz=int(np.asarray(arrays["col_sorted"]).shape[0]),
        cn_classes=cn_classes,
        vn_classes=vn_classes,
        col_sorted=idx("col_sorted"),
        perm_c2v=idx("perm_c2v"),
        bit_pos=idx("bit_pos"),
        puncture=idx("puncture"),
        shorten=idx("shorten"),
        vn_perm=idx("vn_perm"),
        vn_inv=idx("vn_inv"),
        G=None if G is None else torch.as_tensor(np.asarray(G, dtype=np.float32)).to(device),
        layer_edge_masks=None if masks is None else torch.as_tensor(
            np.asarray(masks, dtype=bool)).to(device),
    )


def position_major_slots(cn_classes) -> np.ndarray:
    """For each CN-space slot of the sorted layout (check ``i`` of a class,
    edge ``j`` of the check at ``base + i*d + j``), the slot of the same
    edge in the JAX fused kernel's position-major layout
    (``base + j*count + i``)."""
    out = []
    base = 0
    for count, d in cn_classes:
        i, j = np.meshgrid(np.arange(count), np.arange(d), indexing="ij")
        out.append((base + j * count + i).ravel())
        base += count * d
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def from_pstream_state(arrays: Mapping, cn_classes, device="cpu") -> StreamState:
    """The port's :class:`StreamState` from the fields of JAX's
    ``PStreamState`` (single device).  ``lv2c`` moves from the
    position-major padded edge space to the sorted CN-space slots; the
    ``[8, B]`` flag planes give their row 0 and ``ctr8`` its rows 0-4;
    ``fresh_lv2c`` is dropped (the kernel gathers reload priors itself).
    ``lv2c`` keeps its message dtype (float32, bfloat16 or int8)."""

    def t(name, dtype):
        return torch.as_tensor(np.ascontiguousarray(arrays[name]).astype(dtype)).to(device)

    lv2c_j = np.asarray(arrays["lv2c"])
    # every stored value is exact in float32 (bf16 and int8 alike)
    lv2c = lv2c_j.astype(np.float32)[position_major_slots(cn_classes)]
    return StreamState(
        llr_in=t("llr_in", np.float32),
        codeword=t("codeword", np.uint8),
        lv2c=torch.as_tensor(np.ascontiguousarray(lv2c)).to(TORCH_DTYPES[str(lv2c_j.dtype)])
        .to(device),
        done=t("done8", np.int32)[0].contiguous(),
        iters=t("iters8", np.int32)[0].contiguous(),
        age=t("age8", np.int32)[0].contiguous(),
        avail=t("avail8", np.int32)[0].contiguous(),
        ctr=t("ctr8", np.int32)[:5].contiguous(),
        fresh_llr=t("fresh_llr", np.float32),
        fresh_cw=t("fresh_cw", np.uint8),
        started=torch.tensor([int(np.asarray(arrays["started"]).sum())], dtype=torch.int64,
                             device=device),
    )


def lanes_cn_slots(cn_classes, qc_z: int = 0, qc_zq: int = 0) -> np.ndarray:
    """For each CN-space slot of the sorted layout, the slot of the same
    edge in the JAX package's lane-major layout (``to_lanes_device``): a
    class of ``count`` checks of degree ``d`` takes ``d`` rows of ``cp``
    lanes, position ``j`` of check ``i`` at ``base + j*cp + lane(i)``.  The
    generic transports pad ``count`` to whole 128-lane blocks (``lane(i) =
    i``); the qc transport (``qc_z``, ``qc_zq``) gives each circulant of
    ``Z`` lifts ``Zq`` lanes (``lane(i) = (i // Z) * Zq + i % Z``)."""
    out = []
    base = 0
    for count, d in cn_classes:
        i = np.arange(count)
        if qc_z:
            cp, lane = count // qc_z * qc_zq, i // qc_z * qc_zq + i % qc_z
        else:
            cp, lane = -(-count // 128) * 128, i
        out.append((base + np.arange(d)[None, :] * cp + lane[:, None]).ravel())
        base += cp * d
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def from_lstream_state(arrays: Mapping, cn_classes, lane_of_vn, qc_z: int = 0, qc_zq: int = 0,
                       device="cpu") -> StreamState:
    """The port's :class:`StreamState` from the fields of JAX's lane-major
    ``LStreamState`` (single device; ``make_streaming_lanes_step``, the
    stream of the fast layered engine and of the lane-major flooding
    kernel).  The ``[B, nc_pad]`` planes move to ``[nc, B]`` through
    ``lane_of_vn`` (the layout's lane per sorted VN label), ``lv2c`` from
    the lane slots (:func:`lanes_cn_slots`, with the layout's ``qc_z`` and
    ``qc_zq`` on the qc transport) to the sorted CN-space slots in its
    message dtype; the ``[B, 128]`` planes give their column 0 and ``ctr``
    its columns 0-4; ``fresh_lv2c`` is dropped.  On the fast layered
    engine the ``llr_in`` plane is the APP (in lattice units for int8 once
    a lane has started) and ``lv2c`` its check messages, as in the port."""
    lanes = np.asarray(lane_of_vn, dtype=np.int64)

    def nodes(name, dtype):
        v = np.asarray(arrays[name])[:, lanes].T.astype(dtype)
        return torch.as_tensor(np.ascontiguousarray(v)).to(device)

    def col(name, cols=0):
        return torch.as_tensor(np.ascontiguousarray(
            np.asarray(arrays[name])[:, cols].T.astype(np.int32))).to(device)

    lv2c_j = np.asarray(arrays["lv2c"])
    # every stored value is exact in float32 (bf16 and int8 alike)
    lv2c = lv2c_j.astype(np.float32)[:, lanes_cn_slots(cn_classes, qc_z, qc_zq)].T
    return StreamState(
        llr_in=nodes("llr_in", np.float32),
        codeword=nodes("codeword", np.uint8),
        lv2c=torch.as_tensor(np.ascontiguousarray(lv2c)).to(TORCH_DTYPES[str(lv2c_j.dtype)])
        .to(device),
        done=col("done"),
        iters=col("iters"),
        age=col("age"),
        avail=col("avail"),
        ctr=col("ctr", slice(0, 5)),
        fresh_llr=nodes("fresh_llr", np.float32),
        fresh_cw=nodes("fresh_cw", np.uint8),
        started=torch.tensor([int(np.asarray(arrays["started"]).sum())], dtype=torch.int64,
                             device=device),
    )
