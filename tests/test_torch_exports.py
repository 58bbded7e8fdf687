"""The port's package-level names: every name of a JAX package's
``__all__`` is in its counterpart's ``__all__`` and resolves, in a fresh
interpreter that loads no jax and builds nothing; and the two public
helpers added with them, ``ops.cn_ops.total_combine`` and
``ops.sorted.sorted_vn_inv``, against the JAX functions."""

import importlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libldpc_tpu.ops import cn_ops as jax_cn
from libldpc_tpu.ops.sorted import sorted_vn_inv as jax_sorted_vn_inv
from libldpc_tpu_torch.models import (
    make_benchmark_code, make_peg_code, make_regular_code, wifi_code,
)
from libldpc_tpu_torch.ops import cn_ops
from libldpc_tpu_torch.ops.sorted import sorted_vn_inv, to_sorted_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PACKAGES = ["", ".models", ".sim", ".parallel", ".utils", ".ops"]


@pytest.mark.parametrize("sub", PACKAGES)
def test_jax_all_resolves_in_the_port(sub):
    names = list(importlib.import_module(f"libldpc_tpu{sub}").__all__)
    code = (
        "import importlib, sys\n"
        f"pkg = importlib.import_module('libldpc_tpu_torch{sub}')\n"
        f"names = {names!r}\n"
        "missing = [n for n in names if n not in pkg.__all__]\n"
        "assert not missing, f'not in __all__: {missing}'\n"
        "for n in names:\n"
        "    getattr(pkg, n)\n"
        "ns = {}\n"
        f"exec('from libldpc_tpu_torch{sub} import *', ns)\n"
        "assert set(names) <= set(ns), 'import * lacks names'\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'libldpc_tpu']\n"
        "b = sys.modules.get('libldpc_tpu_torch.ops.kernels.build')\n"
        "assert b is None or (b._lib is None and b.last_build_log is None), 'kernels built'\n"
        "r = sys.modules['libldpc_tpu_torch.runtime']\n"
        "assert r._lib is None and not r._tried, 'runtime built'\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": REPO}, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_root_names_are_the_submodules_objects():
    import libldpc_tpu_torch as root
    from libldpc_tpu_torch.api import LDPC
    from libldpc_tpu_torch.models.code import LDPCCode
    from libldpc_tpu_torch.parallel import mesh
    from libldpc_tpu_torch.sim.driver import Simulator

    assert root.LDPC is LDPC and root.Simulator is Simulator and root.LDPCCode is LDPCCode
    import libldpc_tpu_torch.parallel as parallel
    import libldpc_tpu_torch.sim as sim

    assert sim.Simulator is Simulator and parallel.make_sim_step is mesh.make_sim_step
    with pytest.raises(AttributeError):
        root.no_such_name


OPS = {"minsum": (cn_ops.minsum, jax_cn.minsum), "boxplus": (cn_ops.boxplus, jax_cn.boxplus)}


@pytest.mark.parametrize("dc", [1, 2, 6, 9])
@pytest.mark.parametrize("op", sorted(OPS))
def test_total_combine_matches_jax(op, dc):
    rng = np.random.default_rng(dc)
    M = (rng.normal(size=(37, dc, 50)) * 4).astype(np.float32)
    M[0, 0, :5] = 0.0
    port_op, jax_op = OPS[op]
    got = cn_ops.total_combine(torch.from_numpy(M), port_op).numpy()
    want = np.asarray(jax_cn.total_combine(jnp.asarray(M), jax_op))
    assert got.shape == (37, 50)
    if op == "minsum":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("key", ["bench1152", "wifi648", "peg", "regular"])
def test_sorted_vn_inv_matches_jax(key):
    code = {
        "bench1152": lambda: make_benchmark_code(1152, 3, 6, seed=0),
        "wifi648": lambda: wifi_code(648),
        "peg": lambda: make_peg_code(200, [2] * 60 + [3] * 100 + [6] * 40, mc=100, seed=3),
        "regular": lambda: make_regular_code(96, 3, 6, seed=7),
    }[key]()
    got = sorted_vn_inv(code)
    np.testing.assert_array_equal(got, jax_sorted_vn_inv(code))
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, to_sorted_device(code, "cpu").vn_inv.numpy())
