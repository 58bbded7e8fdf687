"""The native host runtime: the codefile pair parser and the GF(2) rank in
C++ (``native.cpp``), behind a plain C interface loaded with ``ctypes``.

The library is built with ``g++`` at the first parse or rank, never at
import, into ``build/runtime/`` at the root of the checkout.  Its file name
carries a hash of the source, the flags and, for ``-march=native``, the host
CPU's feature flags, so an edited source is rebuilt and a library built for
another CPU is not loaded.  ``-march=native`` is tried first (the rank's
word loop profits from wide vectors) and plain ``-O3`` where the toolchain
refuses it.  Without ``g++``, or when both builds fail, ``native.available()``
is False, :data:`last_build_error` holds the compiler's output, and the
callers (:func:`..models.io.parse_codefile`, :func:`..models.io.parse_genfile`,
:func:`..models.gf2.rank`) keep their NumPy paths.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

SRC = pathlib.Path(__file__).resolve().parent / "native.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "runtime"
#: The flag sets tried in turn; the first that builds is loaded.
FLAG_SETS = (("-O3", "-march=native"), ("-O3",))
COMMON_FLAGS = ("-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False
#: The compiler's output of the failed builds (None when nothing failed).
last_build_error: Optional[str] = None


def _cpu_flags() -> bytes:
    """The host CPU's feature flags (``/proc/cpuinfo``), empty where the
    file is missing."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"flags", b"Features")):
                    return line
    except OSError:
        pass
    return b""


def library_path(flags) -> pathlib.Path:
    h = hashlib.sha256(" ".join((*flags, *COMMON_FLAGS)).encode())
    h.update(SRC.read_bytes())
    if "-march=native" in flags:
        h.update(_cpu_flags())
    return BUILD_DIR / f"libldpc_native_{h.hexdigest()[:16]}.so"


def _build(flags, out: pathlib.Path) -> Optional[str]:
    """Compile the library into ``out``; None, or the compiler's output on
    failure.  The library is written under a temporary name and renamed,
    so processes building at once never load a partial file."""
    gxx = shutil.which("g++")
    if gxx is None:
        return "g++ not found on PATH"
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [gxx, *flags, *COMMON_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if proc.returncode == 0:
            os.replace(tmp, out)
            return None
        err = f"{' '.join(cmd)} ({proc.returncode})\n{proc.stderr}"
    except (OSError, subprocess.TimeoutExpired) as e:  # an unwritable build/, a hung g++
        err = f"{' '.join(cmd)}: {e}"
    with contextlib.suppress(OSError):
        tmp.unlink(missing_ok=True)
    return err


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.ldpc_parse_pairs.restype = ctypes.c_longlong
    lib.ldpc_parse_pairs.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_longlong,
    ]
    lib.ldpc_gf2_rank.restype = ctypes.c_int
    lib.ldpc_gf2_rank.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    return lib


def _load():
    """The library, built on the first call; None when it cannot be."""
    global _lib, _tried, last_build_error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        errors = []
        for flags in FLAG_SETS:
            path = library_path(flags)
            err = None if path.exists() else _build(flags, path)
            if err is None:
                try:
                    _lib = _declare(ctypes.CDLL(str(path)))
                    break
                except OSError as e:
                    err = f"loading {path}: {e}"
            errors.append(err)
        last_build_error = "\n".join(errors) if errors else None
        return _lib


class native:
    """The native entry points.  ``parse_pairs`` and ``gf2_rank`` raise
    where :meth:`available` is False."""

    @staticmethod
    def available() -> bool:
        """Whether the library is built and loaded (builds it on the first
        call)."""
        return _load() is not None

    @staticmethod
    def _require():
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native runtime not available: {last_build_error}")
        return lib

    @staticmethod
    def parse_pairs(path: str):
        """The ``row col`` integer pairs of every non-header line of a
        codefile (a line holding ``:`` is a header), as int32 arrays
        ``(rows, cols)``."""
        lib = native._require()
        cap = os.path.getsize(path) // 3 + 16  # a pair takes at least 4 bytes
        rows = np.empty(cap, dtype=np.int32)
        cols = np.empty(cap, dtype=np.int32)
        n = lib.ldpc_parse_pairs(
            os.fsencode(path),
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cap,
        )
        if n < 0:
            raise OSError(f"native parser failed on {path} (code {n})")
        return rows[:n].copy(), cols[:n].copy()

    @staticmethod
    def gf2_rank(packed: np.ndarray, n_cols: int) -> int:
        """Rank over GF(2) of bit-packed rows ``[m, words]`` (uint64, bit
        ``j`` of word ``w`` is column ``64 w + j``) covering ``n_cols``
        columns, as :func:`..models.gf2.pack_rows` packs them."""
        lib = native._require()
        packed = np.ascontiguousarray(packed, dtype=np.uint64)
        if packed.ndim != 2:
            raise ValueError(f"packed rows must be 2-D, got shape {packed.shape}")
        m, words = packed.shape
        if not 0 <= n_cols <= 64 * words:
            raise ValueError(f"{n_cols} columns do not fit {words} words a row")
        return int(lib.ldpc_gf2_rank(
            packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), m, words, n_cols))
