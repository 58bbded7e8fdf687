"""Message storage forms of the decoders: float32, bfloat16, int8.

The port of the ``message_dtype`` / ``quant_scale`` options of
``libldpc_tpu/ops/pallas/decode_fused.py`` and ``decode_lanes.py``
(``to_store``, ``to_msg``, ``prior``, the lattice OMS offset, the
dequantised output).  Arithmetic always runs in float32; a form only says
how messages and posteriors are *stored*:

* ``float32``: as they are;
* ``bfloat16``: rounded to nearest even (``.to(torch.bfloat16)``);
* ``int8``: on the integer lattice ``q = clip(round_half_even(L / s),
  -127, 127)`` with ``s = quant_scale``.  The decoder works on lattice
  values throughout: the channel prior enters multiplied by
  ``inv_q = float32(1 / s)`` (never divided by ``s``), the OMS offset is
  given in LLR units and shrinks to ``offset * (1 / s)``, and the output
  posterior is ``f32(q) * s``.  Min-sum is scale-invariant, so only the
  saturation and the NMS/OMS re-rounding approximate; the lattice is
  therefore refused for every CN form outside the min-sum family.

The store points, shared by the plain versions (``ops/sorted.py``) and the
CUDA kernels (``csrc/bp_phases.cuh``): ``lc2v = store(postprocess(combine))``
(a degree-1 check stores ``postprocess(1e30)``, +127 on the lattice);
``post = store(prior(llr) + (m0 + m1 + ...))`` with the prior in float32;
``lv2c = store(f32(post) - f32(lc2v))`` from the *stored* posterior; first
messages ``store(prior(llr))``; decisions and syndromes from the stored
posterior's signs (``<= 0``).  The exact layered schedule has the same
store points, with a stale layer's checks keeping their stored ``lc2v``.

The fast layered engine (``ops/layered.py``, ``_qc_engine``) keeps its
APP in float32, in decoder units (lattice units for int8), and never
rounds it: ``lv = round(app - load(lc2v))``, ``o = round(postprocess(
combine(lv)))``, ``app += o - load(lc2v)``, ``lc2v = store(o)``, where
``round`` (``to_msg``) rounds into the message domain and stays float32;
its output is ``dequant(app)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: The int8 lattice step in LLR units (spans LLRs +-23.8 at ~0.19).
DEFAULT_QUANT_SCALE = 0.1875

#: Message dtype -> its code in the kernels' C interface.
DTYPE_CODES = {"float32": 0, "bfloat16": 1, "int8": 2}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}

#: CN forms the int8 lattice is exact for (``True`` is the legacy min-sum toggle).
MINSUM_FAMILY = ("BP_MS", "BP_NMS", "BP_OMS", True)


def _f32(v: float) -> torch.Tensor:
    """A float32 scalar (0-dim, on the CPU: it combines with a tensor on any
    device without a copy to the card)."""
    return torch.tensor(v, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class MessageForm:
    """How messages are stored: ``dtype`` (``float32``, ``bfloat16`` or
    ``int8``) and, for int8, the lattice step ``quant_scale``."""

    dtype: str = "float32"
    quant_scale: float = DEFAULT_QUANT_SCALE

    def __post_init__(self):
        if self.dtype not in DTYPE_CODES:
            raise ValueError(f"message dtype {self.dtype!r}: expected one of {list(DTYPE_CODES)}")
        if self.dtype == "int8" and not self.quant_scale > 0:
            raise ValueError(f"quant_scale must be > 0, got {self.quant_scale}")

    @property
    def code(self) -> int:
        return DTYPE_CODES[self.dtype]

    @property
    def torch_dtype(self) -> torch.dtype:
        return TORCH_DTYPES[self.dtype]

    @property
    def lattice(self) -> bool:
        return self.dtype == "int8"

    @property
    def inv_q(self) -> float:
        """``float32(1 / quant_scale)``: the prior's lattice factor (5.3333335
        at the default step); 1.0 off the lattice."""
        return float(np.float32(1.0 / self.quant_scale)) if self.lattice else 1.0

    def check_cn_mode(self, minsum_mode, what: str = "int8 messages") -> None:
        """Raise for a CN form the lattice is not exact for (as the JAX
        package does)."""
        kind = minsum_mode[0] if isinstance(minsum_mode, tuple) else minsum_mode
        if self.lattice and kind not in MINSUM_FAMILY:
            raise ValueError(
                f"{what} require a min-sum-family CN form (BP_MS/BP_NMS/BP_OMS) — "
                "box-plus/tanh/phi forms are not scale-invariant"
            )

    def cn_mode(self, minsum_mode):
        """The CN form on this storage: on the lattice an OMS/NMS tuple's
        offset becomes ``offset * (1 / quant_scale)`` (in double; float32
        where it is used)."""
        if self.lattice and isinstance(minsum_mode, tuple) and len(minsum_mode) == 3:
            kind, scale, offset = minsum_mode
            return (kind, scale, offset * (1.0 / self.quant_scale))
        return minsum_mode

    def store(self, x: torch.Tensor) -> torch.Tensor:
        """float32 values -> the stored form."""
        if self.dtype == "int8":
            return torch.clamp(torch.round(x), -127.0, 127.0).to(torch.int8)
        return x.to(self.torch_dtype)

    @staticmethod
    def load(x: torch.Tensor) -> torch.Tensor:
        """Stored values -> float32 (lattice values stay in lattice units)."""
        return x.to(torch.float32)

    def round(self, x: torch.Tensor) -> torch.Tensor:
        """float32 values rounded into the message domain, kept in float32
        (``load(store(x))``): ``clip(round(x), -127, 127)`` on the lattice,
        ``f32(bf16(x))`` in bfloat16, ``x`` itself in float32."""
        if self.dtype == "int8":
            return torch.clamp(torch.round(x), -127.0, 127.0)
        if self.dtype == "bfloat16":
            return x.to(torch.bfloat16).to(torch.float32)
        return x

    def prior(self, llr: torch.Tensor) -> torch.Tensor:
        """Raw float32 channel LLRs -> the decoder's units."""
        return llr * _f32(self.inv_q) if self.lattice else llr

    def dequant(self, x: torch.Tensor) -> torch.Tensor:
        """Stored posteriors -> float32 LLRs: ``f32(q) * quant_scale`` on
        the lattice."""
        x = x.to(torch.float32)
        return x * _f32(self.quant_scale) if self.lattice else x


FLOAT32 = MessageForm()
