"""No module of the benchmark imports JAX, flax or the JAX package (top-level
module names compared whole), and the reference imports nothing of the port."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "tvc_ai_tpu"}
MODULES = sorted(PKG.rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) and ":" in node.value:
            names.add(node.value.split(":")[0].split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_stands_alone(path):
    assert "tvc_ai_torch" not in top_level_imports(path)


def test_whole_names():
    # the port's name begins with the JAX package's: only whole names count
    assert "tvc_ai_torch" not in FORBIDDEN
