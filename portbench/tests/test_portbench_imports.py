"""Nothing under ``portbench/`` imports JAX or the JAX package, and the
reference imports nothing of the program either: an AST walk over every
``import``, comparing whole top-level module names."""

import ast
import pathlib

import pytest

PB = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "libldpc_tpu"}


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(PB.rglob("*.py")), ids=lambda p: str(p.relative_to(PB)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PB / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "libldpc_tpu_torch" not in top_level_imports(path)
    assert "portbench" not in top_level_imports(path) or path.name == "__init__.py"


def test_the_walk_tells_the_port_from_the_jax_package(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import libldpc_tpu_torch.sim\nfrom libldpc_tpu_torch import cli\n")
    assert top_level_imports(f) == {"libldpc_tpu_torch"}
    f.write_text("from libldpc_tpu.ops import x\n")
    assert top_level_imports(f) & FORBIDDEN == {"libldpc_tpu"}
