"""Nothing under portbench/ imports JAX, the JAX package or the JAX
package's benches, and the reference and the work counts import nothing
of the program under test (top-level module names compared whole)."""

from __future__ import annotations

import ast

import pytest

from portbench.tests.helpers import ROOT

FILES = sorted((ROOT / "portbench").rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__"):
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    found = set(_imports(path)) & FORBIDDEN
    assert not found, f"{path} imports {found}"
    assert "benchmarks" + "/" not in path.read_text()


@pytest.mark.parametrize("path", [p for p in FILES if p.parent.name in ("reference", "work")],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_reference_and_work_import_no_program(path):
    assert "repro_torch" not in set(_imports(path))
    assert "repro_torch" not in path.read_text()


def test_a_forbidden_module_is_found():
    import sys
    import types

    from portbench import run

    sys.modules["jax.numpy"] = types.ModuleType("jax.numpy")
    try:
        assert run.forbidden_modules() == ["jax"]
    finally:
        del sys.modules["jax.numpy"]
    assert run.forbidden_modules() == []
