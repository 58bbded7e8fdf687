"""The port's own host layer (code models, constructors, file formats,
parameters, the CLI parser) against the JAX package's originals: with the
same arguments they must give equal arrays, strings and defaults."""

import dataclasses

import numpy as np
import pytest

from libldpc_tpu import cli as jax_cli
from libldpc_tpu import models as jm
from libldpc_tpu.models import io as jio
from libldpc_tpu.utils import params as jparams
from libldpc_tpu_torch import cli
from libldpc_tpu_torch import models as tm
from libldpc_tpu_torch.convert import code_from_jax
from libldpc_tpu_torch.utils import params as tparams

FIELDS = ("rows", "cols", "puncture", "shorten", "G", "bit_pos")


def assert_same_code(a, b):
    assert (a.nc, a.mc, a.nnz, a.kc, a.nct, a.mct, a.kct) == (b.nc, b.mc, b.nnz, b.kc, b.nct,
                                                              b.mct, b.kct)
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f)
    assert (a.layers is None) == (b.layers is None)
    if a.layers is not None:
        assert len(a.layers) == len(b.layers)
        for la, lb in zip(a.layers, b.layers):
            np.testing.assert_array_equal(la, lb)
    assert (a.qc is None) == (b.qc is None)
    if a.qc is not None:
        assert a.qc[0] == b.qc[0]
        np.testing.assert_array_equal(a.qc[1], b.qc[1])
    assert a.summary() == b.summary()
    np.testing.assert_array_equal(a.H_dense, b.H_dense)


CONSTRUCTORS = {
    "bench96": lambda m: m.make_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True),
    "bench1152": lambda m: m.make_benchmark_code(1152, 3, 6, seed=0, with_G=True),
    "bench1152_noG": lambda m: m.make_benchmark_code(1152, 3, 6, seed=0),
    "regular_4_8": lambda m: m.make_regular_code(128, 4, 8, seed=3),
    "qc_bench": lambda m: m.make_qc_benchmark_code(1024, 64, seed=1, with_G=True),
    "expand_qc": lambda m: m.expand_qc(np.array([[0, 3, -1, 2], [1, -1, 4, 0]]), 5),
    "wifi648": lambda m: m.wifi_code(648),
    "wifi1296": lambda m: m.wifi_code(1296),
    "wifi1944": lambda m: m.wifi_code(1944),
    "wifi648_bare": lambda m: m.wifi_code(648, with_G=False, with_layers=False),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructors_equal_jax(name):
    assert_same_code(CONSTRUCTORS[name](tm), CONSTRUCTORS[name](jm))


def test_systematic_generator_and_natural_layers_equal_jax():
    jc = jm.make_qc_benchmark_code(512, 32, seed=4)
    tc = code_from_jax(jc)
    np.testing.assert_array_equal(tm.systematic_generator(tc), jm.systematic_generator(jc))
    for a, b in zip(tm.qc_natural_layers(tc), jm.qc_natural_layers(jc)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("Z", [None, "auto", 81, 27])
def test_detect_qc_equals_jax(Z):
    src = jm.wifi_code(1944, with_G=False, with_layers=False)
    src.qc = None
    jc, tc = src, code_from_jax(src)
    if Z == 27:
        with pytest.raises(ValueError):
            jm.detect_qc(jc, Z)
        with pytest.raises(ValueError):
            tm.detect_qc(tc, Z)
        return
    np.testing.assert_array_equal(tm.detect_qc(tc, Z), jm.detect_qc(jc, Z))
    assert tc.qc[0] == jc.qc[0] == 81


def test_detect_qc_rejects_random_code():
    tc = tm.make_benchmark_code(96, 3, 6, seed=7)
    with pytest.raises(ValueError, match="no QC structure"):
        tm.detect_qc(tc)


def test_code_from_jax_copies_every_field():
    jc = jm.wifi_code(648)
    jc.puncture = np.array([0, 5], np.int32)
    jc.shorten = np.array([7], np.int32)
    tc = code_from_jax(jc)
    assert isinstance(tc, tm.LDPCCode)
    assert_same_code(tc, jc)
    tc.rows[0] = 99  # a copy, not a view
    assert jc.rows[0] != 99


@pytest.mark.parametrize("headered", [True, False])
@pytest.mark.parametrize("with_layers", [True, False])
def test_from_files_round_trip_equals_jax(tmp_path, headered, with_layers):
    src = jm.wifi_code(648)
    src.puncture = np.array([3, 10], np.int32) if headered else np.zeros(0, np.int32)
    src.shorten = np.array([20], np.int32) if headered else np.zeros(0, np.int32)
    h, g, lay = tmp_path / "h.txt", tmp_path / "g.txt", tmp_path / "l.txt"
    tm.write_codefile(str(h), src.rows, src.cols, src.nc, src.mc, puncture=src.puncture,
                      shorten=src.shorten, headered=headered)
    r, c = np.nonzero(src.G)
    g.write_text("".join(f"{i} {j}\n" for i, j in zip(r, c)))
    tm.write_layerfile(str(lay), src.layers)
    layer_file = str(lay) if with_layers else ""
    tc = tm.LDPCCode.from_files(str(h), str(g), layer_file)
    jc = jm.LDPCCode.from_files(str(h), str(g), layer_file)
    assert_same_code(tc, jc)
    np.testing.assert_array_equal(tc.G, src.G)
    # the port's writer and the JAX package's writer give the same file
    jio.write_codefile(str(tmp_path / "hj.txt"), src.rows, src.cols, src.nc, src.mc,
                       puncture=src.puncture, shorten=src.shorten, headered=headered)
    assert h.read_text() == (tmp_path / "hj.txt").read_text()


def test_from_dense_equals_jax():
    H = np.array([[1, 1, 1, 0, 0], [0, 1, 1, 1, 0]], np.uint8)
    assert_same_code(tm.LDPCCode.from_dense(H), jm.LDPCCode.from_dense(H))


@pytest.mark.parametrize("row", [
    (1.5, 0.25, 1e-3, 1024, 12.5, None),
    (0.45, 8.086e-01, 2.879e-01, 512, 42.17, 0.000350),
    (-3.0, 0.0, 0.0, 0, 0.0, 1.25),
])
def test_format_result_row_equals_jax(row):
    assert tm.format_result_row(*row) == jio.format_result_row(*row)


def test_write_results_file_equals_jax(tmp_path):
    rows = [jio.format_result_row(1.0, 0.5, 0.1, 10, 3.0, 0.001), ""]
    tm.write_results_file(str(tmp_path / "a.txt"), rows, comment="kernel=x")
    jio.write_results_file(str(tmp_path / "b.txt"), rows, comment="kernel=x")
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()


@pytest.mark.parametrize("cls", ["DecoderParams", "ChannelParams", "SimulationParams"])
def test_params_fields_and_defaults_equal_jax(cls):
    t, j = getattr(tparams, cls), getattr(jparams, cls)
    tf = {f.name: f.default for f in dataclasses.fields(t)}
    jf = {f.name: f.default for f in dataclasses.fields(j)}
    assert tf == jf
    assert t.__dataclass_params__.frozen == j.__dataclass_params__.frozen


def test_params_behaviour_equals_jax():
    assert tparams.SHORTEN_LLR == jparams.SHORTEN_LLR
    for ty in ("BP", "BP_MS", "BP_NMS", "BP_OMS", "junk"):
        assert tparams.DecoderParams(type=ty).cn_mode == jparams.DecoderParams(type=ty).cn_mode
        assert (tparams.DecoderParams(type=ty).use_minsum
                == jparams.DecoderParams(type=ty).use_minsum)
    for ch in ("AWGN", "BSC", "BEC"):
        for rng in ((0.30, 0.451, 0.05), (1.0, 3.01, 0.5), (0.0, 0.0, 1.0)):
            assert (tparams.ChannelParams(x_range=rng, type=ch).sweep_values()
                    == jparams.ChannelParams(x_range=rng, type=ch).sweep_values())
    assert tparams.ChannelParams(x_values=(3, 1)).sweep_values() == [3.0, 1.0]


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_cli_parser_has_every_jax_flag():
    t, j = _actions(cli.build_parser()), _actions(jax_cli.build_parser())
    assert set(t) == set(j) | {"device", "trace_dir"}
    for dest, ja in j.items():
        ta = t[dest]
        assert ta.option_strings == ja.option_strings, dest
        assert ta.default == ja.default, dest
        assert ta.choices == ja.choices, dest
        assert ta.nargs == ja.nargs, dest
        assert ta.type == ja.type, dest
        assert type(ta) is type(ja), dest
    assert t["device"].default == "cuda"


@pytest.mark.parametrize("argv", [
    ["h.txt", "o.txt", "0.3", "0.451", "0.05", "-G", "g.txt", "--channel", "BEC"],
    ["h", "o", "1", "3", "0.5", "-i", "12", "-s", "3", "--batch-size", "64",
     "--max-frames", "2e4", "--frame-error-count", "20", "--no-early-term", "--pallas",
     "--layer-file", "l.txt", "--qc-z", "auto", "--decoding", "BP_MS", "-t", "8"],
])
def test_cli_parser_parses_like_jax(argv):
    t = vars(cli.build_parser().parse_args(argv))
    j = vars(jax_cli.build_parser().parse_args(argv))
    assert t.pop("device") == "cuda"
    assert t.pop("trace_dir") == ""
    assert t == j
