"""The port's native host runtime (``libldpc_tpu_torch.runtime``): the
codefile pair parser and the GF(2) rank, built with ``g++`` at first use,
against the port's NumPy paths and the JAX package's parser and rank on
the same files and matrices.  Skips where ``g++`` is absent."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import libldpc_tpu.models.gf2 as jax_gf2
import libldpc_tpu.models.io as jax_io
import libldpc_tpu_torch.runtime as runtime
from libldpc_tpu_torch.models import gf2, io, make_benchmark_code, wifi_code, write_codefile
from libldpc_tpu_torch.runtime import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ not available: the native runtime cannot be built")
    assert native.available(), runtime.last_build_error


CODES = {
    "bench1152": lambda: make_benchmark_code(1152, 3, 6, seed=0, with_G=True),
    "wifi1944": lambda: wifi_code(1944),
}


def _write(path, code, dialect):
    """``gpu``: the counts, puncture and shorten headers
    (``write_codefile``); ``cpu``: bare pairs with puncture and shorten
    lines among them, a third column, tabs, CRLF and blank lines."""
    puncture = np.arange(0, 24, 3)
    shorten = np.array([40, 41, 97])
    if dialect == "gpu":
        write_codefile(path, code.rows, code.cols, code.nc, code.mc, puncture, shorten)
        return
    lines = [f"{r}\t{c} 1\r" if i % 7 == 0 else f"{r} {c}" for i, (r, c) in
             enumerate(zip(code.rows, code.cols))]
    lines.insert(5, "puncture [8]: " + " ".join(map(str, puncture)))
    lines.insert(11, "")
    lines.insert(17, "shorten [3]: " + " ".join(map(str, shorten)))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n\n")


def _parsed(p):
    return (p.rows, p.cols, p.nc, p.mc, p.puncture, p.shorten)


def _assert_same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert np.asarray(x).dtype == np.asarray(y).dtype


@pytest.mark.parametrize("dialect", ["gpu", "cpu"])
@pytest.mark.parametrize("key", sorted(CODES))
def test_parse_matches_python_and_jax(gxx, tmp_path, monkeypatch, key, dialect):
    code = CODES[key]()
    path = str(tmp_path / "h.txt")
    _write(path, code, dialect)
    rows, cols = native.parse_pairs(path)
    np.testing.assert_array_equal(rows, code.rows)
    np.testing.assert_array_equal(cols, code.cols)
    assert rows.dtype == cols.dtype == np.int32
    got = _parsed(io.parse_codefile(path))
    _assert_same(got, _parsed(jax_io.parse_codefile(path)))
    np.testing.assert_array_equal(got[4], np.arange(0, 24, 3))
    np.testing.assert_array_equal(got[5], [40, 41, 97])
    monkeypatch.setattr(native, "available", staticmethod(lambda: False))
    _assert_same(io._pairs(path), (rows, cols))
    _assert_same(_parsed(io.parse_codefile(path)), got)


@pytest.mark.parametrize("key", sorted(CODES))
def test_genfile_matches_python_and_jax(gxx, tmp_path, monkeypatch, key):
    code = CODES[key]()
    path = str(tmp_path / "g.txt")
    r, c = np.nonzero(code.G)
    with open(path, "w") as f:
        f.write("".join(f"{i} {j}\n" for i, j in zip(r, c)))
    G = io.parse_genfile(path, code.nc)
    np.testing.assert_array_equal(G, code.G)
    np.testing.assert_array_equal(G, jax_io.parse_genfile(path, code.nc))
    monkeypatch.setattr(native, "available", staticmethod(lambda: False))
    np.testing.assert_array_equal(io.parse_genfile(path, code.nc), G)


def test_pair_capacity_bound(gxx, tmp_path):
    """The densest file, ``0 0`` on every line, fits the ``size // 3 + 16``
    pairs the parser allocates."""
    path = tmp_path / "dense.txt"
    path.write_text("0 0\n" * 5000 + "1 2")
    rows, cols = native.parse_pairs(str(path))
    assert rows.size == 5001 and rows[-1] == 1 and cols[-1] == 2


def _matrix(rng, m, n, deficient):
    """A seeded binary ``[m, n]`` matrix; ``deficient``: of rank at most
    ``min(m, n) // 2`` (a product of two thin random factors, mod 2)."""
    if not deficient:
        return rng.integers(0, 2, (m, n), dtype=np.uint8)
    k = max(1, min(m, n) // 2)
    a = rng.integers(0, 2, (m, k))
    b = rng.integers(0, 2, (k, n))
    return ((a @ b) % 2).astype(np.uint8)


@pytest.mark.parametrize("deficient", [False, True])
@pytest.mark.parametrize("m,n", [(1, 1), (5, 63), (40, 70), (130, 129), (200, 150), (97, 331)])
def test_gf2_rank_matches_numpy_and_jax(gxx, monkeypatch, m, n, deficient):
    rng = np.random.default_rng(1000 * m + n + deficient)
    mat = _matrix(rng, m, n, deficient)
    got = native.gf2_rank(gf2.pack_rows(mat), n)
    assert gf2.rank(mat) == got == jax_gf2.rank(mat)
    if deficient:
        assert got <= max(1, min(m, n) // 2)
    monkeypatch.setattr(native, "available", staticmethod(lambda: False))
    assert gf2.rank(mat) == got


@pytest.mark.parametrize("m,n", [(1, 1), (3, 64), (5, 65), (7, 129), (33, 200), (4, 0)])
def test_pack_rows_matches_jax(m, n):
    mat = np.random.default_rng(m * n + 1).integers(0, 2, (m, n), dtype=np.uint8)
    got = gf2.pack_rows(mat)
    want = jax_gf2.pack_rows(mat)
    assert got.dtype == want.dtype == np.uint64 and got.shape == (m, -(-n // 64))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gf2.unpack_rows(got, n), mat)


def test_gf2_rank_of_codes(gxx, monkeypatch):
    """H of wifi 648 and of the 1152 code (its rows dependent), natively,
    in NumPy and in the JAX package."""
    for code in (wifi_code(648), make_benchmark_code(1152, 3, 6, seed=0)):
        got = code.rank()
        monkeypatch.setattr(native, "available", staticmethod(lambda: False))
        assert code.rank() == got == jax_gf2.rank(code.H_dense)
        monkeypatch.undo()


def test_gf2_rank_refuses_short_rows(gxx):
    with pytest.raises(ValueError):
        native.gf2_rank(np.zeros((3, 1), dtype=np.uint64), 65)


def test_import_builds_nothing():
    code = (
        "import sys\n"
        "import libldpc_tpu_torch.runtime as r, libldpc_tpu_torch.models\n"
        "assert r._lib is None and not r._tried and r.last_build_error is None, 'built'\n"
        "assert 'jax' not in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, env={**os.environ, "PYTHONPATH": REPO}, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.fixture
def fresh_runtime(monkeypatch, tmp_path):
    """The runtime as before its first use, building into ``tmp_path``."""
    monkeypatch.setattr(runtime, "_lib", None)
    monkeypatch.setattr(runtime, "_tried", False)
    monkeypatch.setattr(runtime, "last_build_error", None)
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path / "runtime")


def test_refused_flag_falls_back_to_plain_o3(gxx, fresh_runtime, monkeypatch):
    monkeypatch.setattr(runtime, "FLAG_SETS", (("-O3", "-mno-such-flag"), ("-O3",)))
    assert native.available()
    assert "-mno-such-flag" in runtime.last_build_error
    libs = list((runtime.BUILD_DIR).glob("libldpc_native_*.so"))
    assert [p.name for p in libs] == [runtime.library_path(("-O3",)).name]
    assert native.gf2_rank(gf2.pack_rows(np.eye(70, dtype=np.uint8)), 70) == 70


def test_without_gxx_numpy_paths_run(fresh_runtime, monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert not native.available()
    assert "g++ not found" in runtime.last_build_error
    with pytest.raises(RuntimeError):
        native.parse_pairs(__file__)
    code = wifi_code(648)
    path = str(tmp_path / "h.txt")
    _write(path, code, "gpu")
    _assert_same(_parsed(io.parse_codefile(path)), _parsed(jax_io.parse_codefile(path)))
    assert code.rank() == jax_gf2.rank(code.H_dense)


def test_unwritable_build_dir_falls_back(gxx, fresh_runtime, monkeypatch, tmp_path):
    """A build directory that cannot be made (an installed package's tree)
    leaves the runtime unavailable; the parse runs on NumPy."""
    (tmp_path / "file").write_text("")
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path / "file" / "runtime")
    assert not native.available() and "file" in runtime.last_build_error
    code = wifi_code(648)
    path = str(tmp_path / "h.txt")
    _write(path, code, "cpu")
    _assert_same(_parsed(io.parse_codefile(path)), _parsed(jax_io.parse_codefile(path)))
