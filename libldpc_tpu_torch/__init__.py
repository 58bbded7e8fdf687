"""libldpc_tpu_torch — the LDPC simulator of :mod:`libldpc_tpu` on PyTorch,
with hand-written CUDA decode kernels for NVIDIA Hopper (sm_90a).

The JAX package stays the reference: this package is tested against it
on the CPU, through the plain PyTorch version beside each kernel.  It
imports nothing of the JAX package: its host layer (code models, file
formats, parameters) is its own copy (:mod:`.models`, :mod:`.utils.params`).  Kernels are built with
``nvcc`` at first use (:mod:`.ops.kernels.build`), never at import.
"""

__version__ = "0.1.0"
