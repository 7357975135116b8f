"""Nothing in portbench imports JAX or the JAX package, and the
reference imports nothing of the program; names compared whole, by their
top-level part ("repro_torch" is not "repro")."""
import ast

import pytest

from conftest import REPO

ROOT = REPO / "portbench"


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _files(sub=""):
    return sorted((ROOT / sub).rglob("*.py"))


@pytest.mark.parametrize("path", _files(), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_anywhere(path):
    assert not {"jax", "jaxlib", "flax", "repro"} & set(
        _top_level_imports(path))


@pytest.mark.parametrize("path", _files("reference"), ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert set(_top_level_imports(path)) <= {"__future__", "numpy", "torch"}


def test_only_the_adapter_imports_the_program():
    users = [p.relative_to(ROOT).as_posix() for p in _files()
             if "repro_torch" in set(_top_level_imports(p))
             and "tests" not in p.relative_to(ROOT).parts]
    assert users == ["systems.py"]


def test_the_check_is_by_whole_names():
    from portbench import harness
    import sys
    sys.modules.setdefault("repro_torch_lookalike", sys)
    assert "repro" not in harness.forbidden_modules()
    del sys.modules["repro_torch_lookalike"]
