"""The port's host layer for codes: the code model, its file formats and
the constructors, in NumPy.

Copies of the parts of :mod:`libldpc_tpu.models` that the port uses (the
port imports nothing of the JAX package); with the same arguments they
build the same codes, array for array.
"""

from .code import LDPCCode
from .construct import (
    detect_qc,
    expand_qc,
    make_benchmark_code,
    make_qc_benchmark_code,
    make_regular_code,
    qc_natural_layers,
    systematic_generator,
)
from .io import (
    format_result_row,
    parse_codefile,
    parse_genfile,
    parse_layerfile,
    write_codefile,
    write_layerfile,
    write_results_file,
)
from .standards import wifi_code

__all__ = [
    "LDPCCode", "detect_qc", "expand_qc", "format_result_row", "make_benchmark_code",
    "make_qc_benchmark_code", "make_regular_code", "parse_codefile", "parse_genfile",
    "parse_layerfile", "qc_natural_layers", "systematic_generator", "wifi_code",
    "write_codefile", "write_layerfile", "write_results_file",
]
