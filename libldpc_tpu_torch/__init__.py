"""libldpc_tpu_torch — the LDPC simulator of :mod:`libldpc_tpu` on PyTorch,
with hand-written CUDA decode kernels for NVIDIA Hopper (sm_90a).

The JAX package stays the reference: this package is tested against it
on the CPU, through the plain PyTorch version beside each kernel.  It
imports nothing of the JAX package: its host layer (code models, file
formats, parameters, the native host runtime) is its own copy
(:mod:`.models`, :mod:`.utils.params`, :mod:`.runtime`).  Kernels are built
with ``nvcc`` at first use (:mod:`.ops.kernels.build`), never at import.

The names of the JAX package's root: ``LDPC`` (the pyLDPC-style class,
:mod:`.api`), ``Simulator`` (the sweep driver, :mod:`.sim`), ``LDPCCode``
and its constructors, and the three parameter classes.  ``LDPC`` and
``Simulator`` are loaded at first use, so that importing the package loads
no kernel wrapper.
"""

from .models import LDPCCode, make_benchmark_code, make_regular_code
from .utils import ChannelParams, DecoderParams, SimulationParams

__all__ = [
    "LDPC",
    "LDPCCode",
    "ChannelParams",
    "DecoderParams",
    "SimulationParams",
    "Simulator",
    "make_benchmark_code",
    "make_regular_code",
]
__version__ = "0.1.0"

_LAZY = {
    "LDPC": ("api", "LDPC"),
    "Simulator": ("sim.driver", "Simulator"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(f".{mod}", __name__), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
