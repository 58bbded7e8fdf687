"""The port's code constructors and analysers that the other port tests do
not reach: PEG construction, the 4-cycle count and the girth, the QC
base-matrix table, the 5G-NR lifting sets, shift-table parser and
NR-like codes, each against the JAX package's copy on the same arguments
and files (errors included)."""

import warnings

import numpy as np
import pytest

from libldpc_tpu.models import construct as jax_construct
from libldpc_tpu.models import standards as jax_standards
from libldpc_tpu.models import wifi_code as jax_wifi_code
from libldpc_tpu_torch.convert import code_from_jax
from libldpc_tpu_torch.models import (
    NR_LIFTING_SETS,
    count_4cycles,
    girth,
    load_base_matrix,
    load_nr_shift_table,
    make_benchmark_code,
    make_nr_like_code,
    make_peg_code,
    nr_lifting_sizes,
    nr_set_index,
)
from libldpc_tpu_torch.models import standards

PEG_CASES = [
    dict(nc=96, dv=3, rate=0.5, seed=1),
    dict(nc=200, dv=3, mc=100, seed=0),
    dict(nc=150, dv=np.r_[[2] * 50, [3] * 60, [4] * 40], mc=75, seed=3),
    dict(nc=64, dv=2, mc=40, seed=9),
]


@pytest.mark.parametrize("case", range(len(PEG_CASES)))
def test_peg_code_equals_jax(case):
    kw = dict(PEG_CASES[case])
    nc, dv = kw.pop("nc"), kw.pop("dv")
    got, want = make_peg_code(nc, dv, **kw), jax_construct.make_peg_code(nc, dv, **kw)
    assert (got.nc, got.mc) == (want.nc, want.mc)
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(got.cols, want.cols)
    assert got.rows.dtype == got.cols.dtype == np.int32
    assert count_4cycles(got) == jax_construct.count_4cycles(want)
    assert girth(got) == jax_construct.girth(want)
    assert girth(got, cap=6) == jax_construct.girth(want, cap=6)


def test_peg_argument_errors_match_jax():
    for args, kw in (((96, 3), dict()), ((96, 3), dict(mc=48, rate=0.5)),
                     ((96, np.full(95, 3)), dict(mc=48)), ((96, 0), dict(mc=48)),
                     ((96, 49), dict(mc=48))):
        for fn in (make_peg_code, jax_construct.make_peg_code):
            with pytest.raises(ValueError) as err:
                fn(*args, **kw)
            if fn is make_peg_code:
                port_msg = str(err.value)
            else:
                assert port_msg == str(err.value)


@pytest.mark.parametrize("name", ["wifi648", "bench96", "bench_4cycles", "tree"])
def test_cycle_analysis_equals_jax(name):
    if name == "wifi648":
        jcode = jax_wifi_code(648, with_G=False)
    elif name == "bench96":
        jcode = jax_construct.make_benchmark_code(96, 3, 6, seed=7)
    elif name == "bench_4cycles":  # a random regular code: 4-cycles likely
        jcode = jax_construct.make_regular_code(60, 3, 6, seed=4)
    else:  # a path: no cycle at all, girth = cap
        from libldpc_tpu.models.code import LDPCCode as JaxCode

        jcode = JaxCode(rows=np.array([0, 0, 1, 1], np.int32),
                        cols=np.array([0, 1, 1, 2], np.int32), nc=3, mc=2)
    code = code_from_jax(jcode)
    assert count_4cycles(code) == jax_construct.count_4cycles(jcode)
    for cap in (16, 8):
        assert girth(code, cap) == jax_construct.girth(jcode, cap)
    if name == "tree":
        assert girth(code) == 16 and count_4cycles(code) == 0


def test_peg_beats_random_girth():
    peg = make_peg_code(96, 3, rate=0.5, seed=1)
    assert count_4cycles(peg) == 0 and girth(peg) >= 6
    assert girth(make_benchmark_code(96, 3, 6, seed=1)) <= girth(peg)


def test_base_matrix_file_equals_jax(tmp_path):
    p = tmp_path / "base.txt"
    p.write_text("# an 802.11n-style table\n0 - 3\n\n- 5 -1\n2 2 -\n")
    got = load_base_matrix(str(p))
    np.testing.assert_array_equal(got, jax_standards.load_base_matrix(str(p)))
    assert got.dtype == np.int64 and got.tolist() == [[0, -1, 3], [-1, 5, -1], [2, 2, -1]]
    for body in ("# nothing\n\n", "0 1\n2\n"):
        p.write_text(body)
        msgs = []
        for fn in (load_base_matrix, jax_standards.load_base_matrix):
            with pytest.raises(ValueError) as err:
                fn(str(p))
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


def test_nr_lifting_sets_equal_jax():
    assert NR_LIFTING_SETS == jax_standards.NR_LIFTING_SETS
    assert nr_lifting_sizes() == jax_standards.nr_lifting_sizes()
    assert len(nr_lifting_sizes()) == 51
    for Z in nr_lifting_sizes():
        assert nr_set_index(Z) == jax_standards.nr_set_index(Z)
    for fn in (nr_set_index, jax_standards.nr_set_index):
        with pytest.raises(ValueError, match="not an NR lifting size"):
            fn(100)


def _shift_table(path, bg, lines):
    path.write_text("# row col V0..V7\n" + "".join(lines))
    return str(path)


@pytest.mark.parametrize("bg", [1, 2])
def test_nr_shift_table_equals_jax(tmp_path, bg):
    """A table the test writes (no NR table ships with the repo): full
    eight-value lines and resolved one-value lines, for Z in every lifting
    set; the edge-count warning; the parser's errors."""
    rng = np.random.default_rng(bg)
    mb, nb = standards.NR_BG_SHAPE[bg]
    cells = rng.choice(mb * nb, size=40, replace=False)
    lines = []
    for i, cell in enumerate(cells):
        vals = rng.integers(0, 384, size=1 if i % 5 == 0 else 8)
        lines.append(f"{cell // nb} {cell % nb} {' '.join(map(str, vals))}  # edge {i}\n")
    path = _shift_table(tmp_path / "bg.txt", bg, lines)
    for Z in (2, 3, 10, 28, 36, 44, 104, 240, 384):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = load_nr_shift_table(path, Z, bg)
            want = jax_standards.load_nr_shift_table(path, Z, bg)
        np.testing.assert_array_equal(got, want)
        assert got.shape == (mb, nb) and (got[got >= 0] < Z).all()
        msgs = [str(w.message) for w in caught]
        assert len(msgs) == 2 and msgs[0] == msgs[1] and "40 edges" in msgs[0]
    for bad in ([f"0 0 {' '.join(['1'] * 3)}\n"], [f"{mb} 0 1\n"], ["0 0 1\n", "0 0 2\n"]):
        path = _shift_table(tmp_path / "bad.txt", bg, bad)
        errs = []
        for fn in (load_nr_shift_table, jax_standards.load_nr_shift_table):
            with pytest.raises(ValueError) as err:
                fn(path, 104, bg)
            errs.append(str(err.value))
        assert errs[0] == errs[1]


@pytest.mark.parametrize("Z,seed,puncture", [(13, 0, True), (26, 1, False), (52, 2, True)])
def test_nr_like_code_equals_jax(Z, seed, puncture):
    with_G = Z != 52  # the generator solve takes seconds at the larger sizes
    got = make_nr_like_code(2, Z, seed, with_G=with_G, puncture_info=puncture)
    want = jax_standards.make_nr_like_code(2, Z, seed, with_G=with_G, puncture_info=puncture)
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(got.cols, want.cols)
    np.testing.assert_array_equal(got.puncture, want.puncture)
    np.testing.assert_array_equal(got.bit_pos, want.bit_pos)
    assert got.qc[0] == want.qc[0] and np.array_equal(got.qc[1], want.qc[1])
    assert [list(layer) for layer in got.layers] == [list(layer) for layer in want.layers]
    if with_G:
        np.testing.assert_array_equal(got.G, want.G)
        assert not ((got.H_dense.astype(np.int64) @ got.G.T.astype(np.int64)) % 2).any()
    for fn in (make_nr_like_code, jax_standards.make_nr_like_code):
        with pytest.raises(ValueError, match="not an NR lifting size"):
            fn(2, 100)


def test_nr_like_code_raises_without_a_generator(monkeypatch):
    """Where the generator solve gives None, the JAX copy silently leaves
    ``G`` None; the port raises (a JAX-side fault not copied)."""
    monkeypatch.setattr(standards, "systematic_generator", lambda code: None)
    monkeypatch.setattr(jax_standards, "systematic_generator", lambda code: None)
    assert jax_standards.make_nr_like_code(2, 13, 0).G is None
    with pytest.raises(ValueError, match="no systematic generator"):
        make_nr_like_code(2, 13, 0)
    assert make_nr_like_code(2, 13, 0, with_G=False).G is None
