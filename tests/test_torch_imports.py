"""Importing any module of the port loads no jax and builds no kernel.

``tests/conftest.py`` imports jax in this process, so the check runs in a
fresh interpreter."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "libldpc_tpu_torch",
    "libldpc_tpu_torch.cli",
    "libldpc_tpu_torch.convert",
    "libldpc_tpu_torch.models",
    "libldpc_tpu_torch.ops.channel",
    "libldpc_tpu_torch.ops.cn_ops",
    "libldpc_tpu_torch.ops.kernels.build",
    "libldpc_tpu_torch.ops.kernels.decode_fused",
    "libldpc_tpu_torch.ops.kernels.decode_layered",
    "libldpc_tpu_torch.ops.kernels.layout",
    "libldpc_tpu_torch.ops.layered",
    "libldpc_tpu_torch.ops.sorted",
    "libldpc_tpu_torch.ops.streaming",
    "libldpc_tpu_torch.ops.streaming_fused",
    "libldpc_tpu_torch.parallel.mesh",
    "libldpc_tpu_torch.sim.driver",
    "libldpc_tpu_torch.sim.results",
]


@pytest.mark.parametrize("module", MODULES)
def test_import_is_jax_free_and_builds_nothing(module):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "b = sys.modules.get('libldpc_tpu_torch.ops.kernels.build')\n"
        "assert b is None or (b._lib is None and b.last_build_log is None), 'built'\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": REPO}, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
