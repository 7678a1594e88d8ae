"""Import hygiene of the port: ``matchmaker_tpu_torch``, ``chip_smoke.py``,
``tools/train_step_ab.py``, ``tools/encoder_parts_ab.py``,
``tools/binmax_scan_ab.py``, ``tools/maxsim_ab.py``,
``tools/maxsim_shapes.py``, ``tools/mlp_rows_variants.py``, ``tools/probe_ab.py`` and its turn loop
``tools/ab_turns.py``, and ``tools/tasb_recipe_100k.py`` import nothing
of JAX, flax, optax or the JAX package ``matchmaker_tpu`` (the
port keeps its own copies of the host code it needs). An AST scan of every
source file catches an import wherever it sits: at module level, inside a
function, or behind a condition."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "optax", "matchmaker_tpu")


def _sources():
    paths = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "tools", "train_step_ab.py"),
             os.path.join(REPO, "tools", "encoder_parts_ab.py"), os.path.join(REPO, "tools", "binmax_scan_ab.py"),
             os.path.join(REPO, "tools", "maxsim_ab.py"), os.path.join(REPO, "tools", "maxsim_shapes.py"),
             os.path.join(REPO, "tools", "mlp_rows_variants.py"), os.path.join(REPO, "tools", "probe_ab.py"),
             os.path.join(REPO, "tools", "ab_turns.py"), os.path.join(REPO, "tools", "tasb_recipe_100k.py")]
    for root, _, files in os.walk(os.path.join(REPO, "matchmaker_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def forbidden_imports(source: str):
    """(line, module) of every import of a forbidden top-level package."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        found += [(node.lineno, n) for n in names if n.split(".")[0] in FORBIDDEN]
    return found


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_source_imports_nothing_of_jax_or_the_jax_package(path):
    with open(path, encoding="utf-8") as f:
        assert forbidden_imports(f.read()) == []


@pytest.mark.parametrize("source,found", [
    ("import jax.numpy as jnp", [(1, "jax.numpy")]),
    ("def f():\n    from matchmaker_tpu.config import get_config", [(2, "matchmaker_tpu.config")]),
    ("import os, optax", [(1, "optax")]),
    ("from matchmaker_tpu import metrics", [(1, "matchmaker_tpu")]),
    ("import matchmaker_tpu_torch.ops\nfrom matchmaker_tpu_torch import config", []),
    ("from . import loaders\nimport jaxlib_free_name", []),
])
def test_the_scan_finds_what_it_must(source, found):
    assert forbidden_imports(source) == found
