"""The code constructors and file formats the port shares with the JAX
package's jax-free host layer (:mod:`libldpc_tpu.models`), and a writer for
decoding-layer files."""

from libldpc_tpu.models import (
    LDPCCode,
    detect_qc,
    expand_qc,
    make_benchmark_code,
    make_qc_benchmark_code,
    qc_natural_layers,
    wifi_code,
)
from libldpc_tpu.models.io import parse_layerfile, write_codefile

__all__ = [
    "LDPCCode", "detect_qc", "expand_qc", "make_benchmark_code", "make_qc_benchmark_code",
    "parse_layerfile", "qc_natural_layers", "wifi_code", "write_codefile", "write_layerfile",
]


def write_layerfile(path: str, layers) -> None:
    """Write decoding layers (lists of check indices) in the format
    :func:`parse_layerfile` reads: ``nl: <N>``, then per layer
    ``cn[i]: <count>`` followed by its check indices, one per line."""
    lines = [f"nl: {len(layers)}"]
    for i, layer in enumerate(layers):
        lines.append(f"cn[{i}]: {len(layer)}")
        lines.extend(str(int(c)) for c in layer)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
