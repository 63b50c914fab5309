"""The PyTorch port stands alone: importing it (every module) pulls in
neither JAX nor the JAX package, and no source names either; nor does
chip_smoke.py, which runs where JAX is not installed."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "centerpoly_tpu_torch")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import centerpoly_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax"))
             or m == "centerpoly_tpu" or m.startswith("centerpoly_tpu."))
print(len(names), bad)
assert not bad, bad
"""


def test_import_pulls_in_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 20


def _sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu")):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_source_names_no_jax(path):
    _assert_names_no_jax(path)


def test_chip_smoke_names_no_jax():
    _assert_names_no_jax(os.path.join(ROOT, "chip_smoke.py"))


def _assert_names_no_jax(path):
    with open(path) as f:
        for n, line in enumerate(f, 1):
            code = line.split("#", 1)[0]
            assert "import jax" not in code and "from jax" not in code, (
                f"{path}:{n}")
            assert "centerpoly_tpu." not in code.replace(
                "centerpoly_tpu_torch", ""), f"{path}:{n}"
