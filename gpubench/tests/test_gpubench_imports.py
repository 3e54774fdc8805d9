"""No module of the benchmark imports JAX, Flax or the JAX package, and
the reference imports nothing of the port: top-level names compared
whole (``segfusion_tpu_torch`` begins with ``segfusion_tpu``); a net's
file reaches the port only in its port-side functions. The
harness reads the port through its own spans and counters, and replaces
no attribute of it."""

import ast
from pathlib import Path

import pytest

from gpubench import harness

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))


def _imports(path):
    return _names(ast.parse(path.read_text(), str(path)))


def _names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax(path):
    assert not set(_imports(path)) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", [p for p in FILES if "tests" not in p.parts],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_attribute_replaced(path):
    tree = ast.parse(path.read_text(), str(path))
    calls = {n.func.id for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name)}
    assert not calls & {"setattr", "delattr"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob(
    "*.py")), ids=lambda p: p.name)
def test_reference_imports_no_port(path):
    names = set(_imports(path))
    assert "segfusion_tpu_torch" not in names
    assert "gpubench" not in names


@pytest.mark.parametrize("path", sorted((BENCH / "nets").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_net_reference_imports_no_port(path):
    """A net's file reaches the port only inside its port-side functions;
    its reference imports nothing of it."""
    tree = ast.parse(path.read_text(), str(path))
    port_side = {"port", "pipeline_segmenter"}
    rest = [n for n in tree.body if not (isinstance(n, ast.FunctionDef)
                                         and n.name in port_side)]
    assert "segfusion_tpu_torch" not in set(
        _names(ast.Module(body=rest, type_ignores=[])))


def test_forbidden_modules_compares_whole_names():
    mods = {"segfusion_tpu_torch.core": 1, "jaxtyping": 1, "numpy": 1}
    assert harness.forbidden_modules(mods) == []
    mods.update({"jax.numpy": 1, "segfusion_tpu.ops": 1, "flax": 1})
    assert harness.forbidden_modules(mods) == ["flax", "jax.numpy",
                                               "segfusion_tpu.ops"]


@pytest.mark.parametrize("var", harness.OVERRIDES)
def test_overrides_refused(var):
    assert harness.refuse_overrides({}) is None
    assert harness.refuse_overrides({var: "4"}) == var
