"""What a run may load, and what the reference may import."""
import ast
import os
import subprocess
import sys

import pytest

from benchmark import harness

REF = harness.HERE / "reference"


@pytest.mark.parametrize("names,bad", [
    (["libstb_tpu_torch", "libstb_tpu_torch.core.stirling", "torch"], []),
    (["libstb_tpu"], ["libstb_tpu"]),
    (["libstb_tpu.core", "numpy"], ["libstb_tpu.core"]),
    (["jax", "jax.numpy", "jaxlib"], ["jax", "jax.numpy", "jaxlib"]),
    (["flax.linen", "jaxtyping"], ["flax.linen"]),
])
def test_forbidden_by_top_level_name(names, bad):
    assert harness.forbidden_modules(names) == bad


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(REF.glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "libstb_tpu",
                       "libstb_tpu_torch"}, tops


def test_harness_imports_no_jax():
    """Importing every file of the harness loads neither JAX nor the JAX
    package."""
    code = ("import sys, importlib, pathlib\n"
            "from benchmark import harness\n"
            "for p in sorted(pathlib.Path('benchmark').rglob('*.py')):\n"
            "    if p.parts[1] in ('drivers', 'layer_metrics'):\n"
            "        harness.load_module(p.resolve())\n"
            "    elif p.parts[1] != 'tests':\n"
            "        importlib.import_module('.'.join(p.with_suffix('')"
            ".parts))\n"
            "from libstb_tpu_torch.models import driver\n"
            "bad = harness.forbidden_modules(list(sys.modules))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                   check=True, env={**os.environ, "PYTHONPATH": ""})


def test_run_without_a_card_prints_no_result(tmp_path):
    """run.py on a machine without a card exits non-zero and prints no
    result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         "table.remake_n64k", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_run_without_the_program_fails(tmp_path):
    """A checkout that holds only BENCHMARK.json and benchmark/ fails."""
    import shutil

    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "table.remake_n64k", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": ""})
    assert p.returncode == 5, p.stderr
    assert p.stdout.strip() == ""
