"""No run imports JAX or the JAX package, judged by whole top-level
module names: ``plade_tpu_torch`` starts with ``plade_tpu`` and is not
it."""
import ast
import subprocess
import sys
from pathlib import Path

from regbench.harness import forbidden_held

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "regbench"


def test_whole_top_level_names():
    assert forbidden_held(["plade_tpu_torch", "plade_tpu_torch.pipeline",
                           "jaxtyping", "flaxen", "numpy"]) == []
    assert forbidden_held(["plade_tpu.core.config"]) == ["plade_tpu"]
    assert forbidden_held(["jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_benchmark_imports_no_jax_and_none_of_the_old_bench():
    """Outside its tests, the benchmark's sources import neither JAX, nor
    the JAX package, nor ``bench.py``, ``tools/`` or the suite's
    ``run_eval``; the reference imports nothing of the program."""
    for path in HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "plade_tpu",
                               "bench", "tools"), (path, name)
            assert "run_eval" not in name, (path, name)
            if "reference" in path.parts:
                assert top != "plade_tpu_torch", (path, name)


def test_a_run_holds_no_jax():
    """A small cell run on the CPU in a fresh interpreter leaves no
    forbidden module loaded."""
    code = (
        "import sys, time\n"
        "from regbench.harness import run_cell, forbidden_held\n"
        "from regbench.tests.small import small_spec\n"
        "spec = small_spec('batch8', rooms=1, pairs_per_call=1, "
        "batch_pairs=1, warmup_calls=0, check_calls=1)\n"
        "run_cell(spec, 7, 0.1, False, time.perf_counter(), device='cpu')\n"
        "print('HELD', forbidden_held(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert "HELD []" in out.stdout, out.stdout + out.stderr
