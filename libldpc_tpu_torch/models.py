"""The code constructors and file formats the port shares with the JAX
package's jax-free host layer (:mod:`libldpc_tpu.models`)."""

from libldpc_tpu.models import LDPCCode, make_benchmark_code, wifi_code
from libldpc_tpu.models.io import write_codefile

__all__ = ["LDPCCode", "make_benchmark_code", "wifi_code", "write_codefile"]
