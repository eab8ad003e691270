"""No file of the benchmark imports JAX or the JAX package, compared by whole
top-level module names; the yardstick (traffic, reference, control) imports
nothing of the program either."""
import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
YARDSTICK = ("traffic.py", "reference.py", "control.py", "stats.py")


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_or_jax_package(path):
    assert not _top_level_imports(path) & FORBIDDEN


def test_the_yardstick_imports_nothing_of_the_program():
    for name in YARDSTICK:
        assert "repro_torch" not in _top_level_imports(PKG / name), name


def test_the_check_is_by_whole_names():
    from nbbench.harness import FORBIDDEN_MODULES, forbidden_loaded

    assert set(FORBIDDEN_MODULES) == FORBIDDEN
    fine = ["repro_torch.core", "reprox", "jax_like", "benchmarks_x", "numpy"]
    assert forbidden_loaded(fine) == []
    assert forbidden_loaded(fine + ["repro.core.jax_nbtree", "jax"]) == [
        "jax", "repro"]
