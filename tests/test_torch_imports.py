"""Importing any module of the port loads no jax, nothing of the JAX
package ``libldpc_tpu``, and builds no kernel.

``tests/conftest.py`` imports jax in this process, so the check runs in a
fresh interpreter."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "libldpc_tpu_torch",
    "libldpc_tpu_torch.api",
    "libldpc_tpu_torch.cli",
    "libldpc_tpu_torch.convert",
    "libldpc_tpu_torch.models",
    "libldpc_tpu_torch.models.code",
    "libldpc_tpu_torch.models.construct",
    "libldpc_tpu_torch.models.gf2",
    "libldpc_tpu_torch.models.io",
    "libldpc_tpu_torch.models.standards",
    "libldpc_tpu_torch.ops.bec",
    "libldpc_tpu_torch.ops.bec_sorted",
    "libldpc_tpu_torch.ops.channel",
    "libldpc_tpu_torch.ops.cn_ops",
    "libldpc_tpu_torch.ops.kernels.build",
    "libldpc_tpu_torch.ops.kernels.decode_bec",
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
    "libldpc_tpu_torch.utils.params",
]


@pytest.mark.parametrize("module", MODULES)
def test_import_is_jax_free_and_builds_nothing(module):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "jax_pkg = [m for m in sys.modules if m == 'libldpc_tpu' or m.startswith('libldpc_tpu.')]\n"
        "assert not jax_pkg, f'the JAX package was imported: {jax_pkg}'\n"
        "b = sys.modules.get('libldpc_tpu_torch.ops.kernels.build')\n"
        "assert b is None or (b._lib is None and b.last_build_log is None), 'built'\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": REPO}, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


CARD_FILES = sorted(
    os.path.relpath(os.path.join(root, f), REPO)
    for root, _, files in os.walk(os.path.join(REPO, "tests_gpu"))
    for f in files if f.endswith(".py")
) + ["chip_smoke.py"]


@pytest.mark.parametrize("path", CARD_FILES)
def test_card_files_import_nothing_of_jax(path):
    """The card-only tests and the smoke run import neither jax nor the
    JAX package (the GPU machine has no jax)."""
    import ast

    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    bad = [m for m in names if m.split(".")[0] in ("jax", "libldpc_tpu")]
    assert not bad, bad
