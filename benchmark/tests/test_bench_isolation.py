"""The benchmark stands apart: no module under benchmark/ imports JAX or
the JAX package (top-level names compared whole: vartrix_tpu_torch is the
port), and the plain reference imports nothing of the port."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = sorted(os.path.join(d, f) for d, _, fs in os.walk(BENCH)
                 for f in fs if f.endswith(".py"))
REFERENCE = [p for p in SOURCES
             if os.path.dirname(p) == os.path.join(BENCH, "reference")]


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, BENCH) for p in SOURCES])
def test_no_jax_or_jax_package(path):
    for top in top_level_imports(path):
        assert top not in ("jax", "jaxlib", "flax", "vartrix_tpu"), (
            f"{path} imports {top}")


@pytest.mark.parametrize("path", REFERENCE,
                         ids=[os.path.basename(p) for p in REFERENCE])
def test_reference_imports_nothing_of_the_port(path):
    assert REFERENCE, "no reference modules found"
    for top in top_level_imports(path):
        assert top != "vartrix_tpu_torch", f"{path} imports {top}"


def test_the_checks_are_seen():
    assert any(p.endswith(os.path.join("reference", "vartrix.py"))
               for p in REFERENCE)
    assert len(SOURCES) > 20
