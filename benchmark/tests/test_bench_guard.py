"""No run of the port may load JAX or the JAX package, and the plain
reference imports nothing of the program."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

from conftest import ROOT

from benchmark import harness

BANNED_IN_REFERENCE = ("raytracer_tpu_torch", "raytracer_tpu", "jax",
                       "jaxlib", "flax")


def test_forbidden_modules_compare_whole_top_level_names():
    loaded = ["raytracer_tpu_torch", "raytracer_tpu_torch.ops.kernels",
              "jaxtyping", "jax_like", "numpy", "jax", "jax.numpy", "jaxlib",
              "flax.linen", "raytracer_tpu", "raytracer_tpu.ops"]
    assert harness.forbidden_modules(loaded) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib", "raytracer_tpu",
        "raytracer_tpu.ops"]
    assert harness.forbidden_modules(["raytracer_tpu_torch.pipeline"]) == []


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_reference_sources_import_nothing_of_the_program():
    files = glob.glob(os.path.join(ROOT, "benchmark", "reference", "*.py"))
    assert files
    for path in files:
        assert not _imports(path) & set(BANNED_IN_REFERENCE), path


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; from benchmark.reference import train, whitted; "
            "from benchmark import harness; "
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{BANNED_IN_REFERENCE!r}]; print(bad); sys.exit(bool(bad))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_a_cpu_run_loads_no_jax(tmp_path):
    """A whole run of a cell (on the CPU, small) leaves no module of JAX
    or the JAX package behind in its process."""
    code = (
        "import sys; sys.path.insert(0, 'benchmark/tests'); "
        "from conftest import run_small; from benchmark.paths import Bench; "
        "from benchmark import harness; b = Bench(); "
        f"line = run_small(b, 'horse31k.frame-ssaa2', {str(tmp_path)!r}); "
        "assert line['correct'], line; "
        "found = harness.forbidden_modules(); print(found); "
        "sys.exit(bool(found))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
