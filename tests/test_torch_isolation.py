"""The PyTorch port stands alone: importing it (every module) pulls in
neither JAX nor the JAX package, and no source names either; nor does
chip_smoke.py, which runs where JAX is not installed.  Every module
imports, and its eval path runs, without PIL and cv2, which that machine
lacks too."""
import os
import subprocess
import sys

import pytest

import torch_port_common  # noqa: F401  (caps torch's threads a worker)

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


def test_import_needs_no_cv2_or_pil():
    """Every module imports with cv2 and PIL unimportable: cv2 is imported
    only inside the functions that decode video or JPEG, write video or
    open a window."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = 'import sys\nsys.modules["PIL"] = sys.modules["cv2"] = None\n'
    proc = subprocess.run([sys.executable, "-c", code + _IMPORT_ALL],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


_EVAL_WITHOUT_PIL_CV2 = """
import sys
sys.modules["PIL"] = sys.modules["cv2"] = None
from centerpoly_tpu_torch import test
from centerpoly_tpu_torch.data.datasets import CityscapesMeta
from centerpoly_tpu_torch.data.fixture import write_rect_fixture
CityscapesMeta.eval_image_size = (128, 256)
root = write_rect_fixture(sys.argv[1], 2, 0, 128, 256, splits=("val",),
                          png=True)
out = test.main(["polydet", "--data_dir", root, "--save_dir", root + "/exp",
                 "--input_h", "64", "--input_w", "128", "--head_conv", "16",
                 "--K", "8", "--device", "cpu"])
assert out["ap"] is not None and out["frames"] == 2, out
print("AP", out["ap"]["allAp"])
"""


def test_eval_path_needs_no_pil_or_cv2(tmp_path):
    """test.main on a PNG fixture, with PIL and cv2 unimportable, writes
    the frames, reads them, rasterizes, reads the masks and GT back and
    reaches an AP."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _EVAL_WITHOUT_PIL_CV2,
                           str(tmp_path)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "AP " in proc.stdout


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
