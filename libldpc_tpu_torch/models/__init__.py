"""The port's host layer for codes: the code model, its file formats and
the constructors, in NumPy.

Copies of the parts of :mod:`libldpc_tpu.models` that the port uses (the
port imports nothing of the JAX package); with the same arguments they
build the same codes, array for array.
"""

from .code import LDPCCode
from .construct import (
    count_4cycles,
    detect_qc,
    expand_qc,
    girth,
    make_benchmark_code,
    make_peg_code,
    make_qc_benchmark_code,
    make_regular_code,
    qc_natural_layers,
    systematic_generator,
)
from .io import (
    SimFile,
    format_result_row,
    parse_alist,
    parse_codefile,
    parse_genfile,
    parse_layerfile,
    parse_mapfile,
    parse_simfile,
    write_alist,
    write_codefile,
    write_layerfile,
    write_results_file,
)
from .standards import (
    NR_LIFTING_SETS,
    load_base_matrix,
    load_nr_shift_table,
    make_nr_like_code,
    nr_lifting_sizes,
    nr_set_index,
    wifi_code,
)

__all__ = [
    "LDPCCode", "NR_LIFTING_SETS", "SimFile", "count_4cycles", "detect_qc", "expand_qc",
    "format_result_row", "girth", "load_base_matrix", "load_nr_shift_table",
    "make_benchmark_code", "make_nr_like_code", "make_peg_code", "make_qc_benchmark_code",
    "make_regular_code", "nr_lifting_sizes", "nr_set_index", "parse_alist", "parse_codefile",
    "parse_genfile", "parse_layerfile", "parse_mapfile", "parse_simfile", "qc_natural_layers",
    "systematic_generator", "wifi_code", "write_alist", "write_codefile", "write_layerfile",
    "write_results_file",
]
