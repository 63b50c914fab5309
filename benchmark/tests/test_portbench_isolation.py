"""The benchmark measures the PyTorch port alone: the reference imports
nothing of the port and nothing of JAX, and a run loads none of JAX,
jaxlib, Flax or the JAX package (top-level module names compared
whole: centerpoly_tpu_torch is not centerpoly_tpu)."""
import ast
import glob
import os
import subprocess
import sys

from portbench_common import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "centerpoly_tpu"}


def imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_reference_imports_neither_the_port_nor_jax():
    files = glob.glob(os.path.join(ROOT, "benchmark", "reference", "**",
                                   "*.py"), recursive=True)
    assert len(files) >= 11
    for f in files:
        bad = imported_tops(f) & (FORBIDDEN | {"centerpoly_tpu_torch"})
        assert not bad, f"{f} imports {bad}"


def test_harness_imports_no_jax():
    files = glob.glob(os.path.join(ROOT, "benchmark", "**", "*.py"),
                      recursive=True)
    for f in files:
        assert not imported_tops(f) & FORBIDDEN, f


def test_a_run_loads_no_jax():
    """A CPU run of a small serving cell, in its own process, imports
    run.py and the port and leaves no forbidden module loaded."""
    code = (
        "import sys, time; sys.path[:0] = [%r, %r]\n"
        "from benchmark import run\n"
        "from portbench_common import small_cell\n"
        "from benchmark.harness import runner\n"
        "out = runner.run(small_cell('dla34.serve-batch4'), 5, 0.5, False,"
        " 'cpu', time.perf_counter())\n"
        "assert out['correct'], out\n"
        "print('FORBIDDEN', run.forbidden_modules())\n"
        % (ROOT, os.path.join(ROOT, "benchmark", "tests")))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "FORBIDDEN []" in p.stdout, p.stdout


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, ROOT)
    from benchmark import run
    try:
        sys.modules["centerpoly_tpu_torch_fake"] = sys
        assert "centerpoly_tpu" not in run.forbidden_modules()
        sys.modules["centerpoly_tpu.fake"] = sys
        assert "centerpoly_tpu" in run.forbidden_modules()
    finally:
        sys.modules.pop("centerpoly_tpu_torch_fake", None)
        sys.modules.pop("centerpoly_tpu.fake", None)
