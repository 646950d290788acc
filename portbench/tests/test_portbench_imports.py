"""Nothing under ``portbench/`` imports JAX, Flax or the JAX package
``repro`` (top-level module names compared whole: ``repro_torch`` is the
port and allowed), and the reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(ROOT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package(path):
    assert not _imports(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "reference").rglob("*.py"):
        assert _imports(path) <= {"__future__", "math", "numpy"}, path


def test_top_level_names_are_compared_whole():
    from portbench import harness

    import sys
    sys.modules.setdefault("repro_torch_fake_probe", object())
    try:
        assert "repro" not in harness.forbidden_modules()
    finally:
        del sys.modules["repro_torch_fake_probe"]
