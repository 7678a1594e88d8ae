"""Import hygiene of the port: ``matchmaker_tpu_torch``, ``chip_smoke.py``,
``tools/train_step_ab.py``, ``tools/encoder_parts_ab.py``,
``tools/binmax_scan_ab.py``, ``tools/maxsim_ab.py``,
``tools/maxsim_shapes.py``, ``tools/mlp_rows_variants.py``, ``tools/probe_ab.py`` and its turn loop
``tools/ab_turns.py``, and ``tools/tasb_recipe_100k.py`` import nothing
of JAX, flax, optax or the JAX package ``matchmaker_tpu`` (the
port keeps its own copies of the host code it needs), nor ``transformers``
outside ``HuggingfaceTokenizer`` (the card's machine has none; checkpoints
are imported by models/hf_import.py without it). An AST scan of every
source file catches an import wherever it sits: at module level, inside a
function, or behind a condition; a fresh interpreter checks that importing
the entry points and the checkpoint import loads neither."""

import ast
import os
import subprocess
import sys

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


def transformers_imports(source: str, allowed_class: str = ""):
    """Lines of every ``transformers`` import outside the class ``allowed_class``."""
    tree = ast.parse(source)
    allowed = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == allowed_class:
            allowed |= {id(n) for n in ast.walk(node)}
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        if any(n.split(".")[0] == "transformers" for n in names) and id(node) not in allowed:
            found.append(node.lineno)
    return sorted(found)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_source_imports_transformers_only_in_the_hf_tokenizer(path):
    allowed = "HuggingfaceTokenizer" if path.endswith(os.path.join("data", "tokenization.py")) else ""
    with open(path, encoding="utf-8") as f:
        assert transformers_imports(f.read(), allowed) == []


def test_transformers_scan_finds_what_it_must():
    src = ("class HuggingfaceTokenizer:\n    def __init__(self):\n        from transformers import AutoTokenizer\n"
           "def f():\n    import transformers.models\n")
    assert transformers_imports(src, "HuggingfaceTokenizer") == [5]
    assert transformers_imports(src) == [3, 5]


def test_entry_points_and_checkpoint_import_load_no_jax_and_no_transformers():
    mods = ("matchmaker_tpu_torch.models", "matchmaker_tpu_torch.models.hf_import", "matchmaker_tpu_torch.cli.train",
            "matchmaker_tpu_torch.cli.score_teacher", "matchmaker_tpu_torch.cli.dense_retrieval",
            "matchmaker_tpu_torch.evaluation", "matchmaker_tpu_torch.distillation.score_files")
    code = (f"import sys, importlib; [importlib.import_module(m) for m in {mods!r}]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'transformers', 'matchmaker_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)
