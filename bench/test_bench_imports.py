"""No module of the benchmark imports the JAX package or JAX, compared by
whole top-level names (``repro_torch`` begins with ``repro``), and the
reference imports nothing of the program."""

import ast

import pytest

from bench.harness import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(manifest.BENCH.rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(manifest.BENCH))
                              for p in FILES])
def test_no_jax_and_no_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_reference_and_counts_import_nothing_of_the_program():
    for sub in ("reference", "counts"):
        for path in (manifest.BENCH / sub).rglob("*.py"):
            assert "repro_torch" not in set(_imports(path)), path
    for path in (manifest.BENCH / "harness").glob("*.py"):
        if path.name != "program.py":
            assert "repro_torch" not in set(_imports(path)), path
