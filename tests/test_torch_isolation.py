"""The PyTorch port stands alone: importing it (every module) pulls in
neither JAX nor the JAX package, and no source names either; nor does
chip_smoke.py, which runs where JAX is not installed.  Every module
imports, and the polydet, ctdet, exdet and multi_pose paths, the
experimental losses, the sampler's fg read and the host tools run,
without PIL, cv2 and matplotlib, which that machine lacks too."""
import os
import subprocess
import sys

import pytest
import torch

import torch_port_common  # noqa: F401  (caps torch's threads a worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "centerpoly_tpu_torch")


def _child_env():
    """A child process's environment: no PYTHONPATH, and torch on this
    worker's share of the cores, as tests/test_torch_ddd.py's children
    (a child would start one thread a core beside the other workers')."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = str(torch.get_num_threads())
    return env

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
    env = _child_env()
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 20


def test_import_needs_no_cv2_or_pil():
    """Every module imports with cv2, PIL and matplotlib unimportable: cv2
    is imported only inside the functions that decode video or JPEG,
    write video or open a window, matplotlib only inside
    tools/analysis.py's plot."""
    env = _child_env()
    code = ('import sys\nsys.modules["PIL"] = sys.modules["cv2"] = '
            'sys.modules["matplotlib"] = None\n')
    proc = subprocess.run([sys.executable, "-c", code + _IMPORT_ALL],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


_EVAL_WITHOUT_PIL_CV2 = """
import sys
sys.modules["PIL"] = sys.modules["cv2"] = sys.modules["matplotlib"] = None
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

# the experimental losses, the sampler's fg and the host tools
import csv, glob, json, os, shutil
import numpy as np, torch
from centerpoly_tpu_torch import tools
from centerpoly_tpu_torch.configs import Config
from centerpoly_tpu_torch.data import CocoPolyAnnotations, PolydetSampler
from centerpoly_tpu_torch.geometry import pil_fill
from centerpoly_tpu_torch.losses import experimental as ex
from centerpoly_tpu_torch.utils.png import write_png
rng = np.random.RandomState(0)
rows = rng.uniform(-20, 20, (1, 2, 17)).astype(np.float32)
assert ex.disk_loss(rows, np.ones((1, 2)), rows, 64, 96)[0] > 0
assert ex.area_poly_loss(rows[..., :16], np.ones((1, 2)),
                         np.zeros((1, 64, 96), np.float32),
                         np.full((1, 2, 2), 40, np.float32)) > 0
p = torch.from_numpy(rows).requires_grad_(True)
ex.disk_loss_device(p, torch.ones(1, 2), torch.from_numpy(rows),
                    64, 96).backward()
assert torch.isfinite(p.grad).all()
meta = CityscapesMeta(root)
ann = CocoPolyAnnotations(meta.annot_path("val"))
name = ann.load_img(ann.get_img_ids()[0])["file_name"]
inst = name.replace("leftImg8bit", "gtFine_instanceIds")
shutil.copy(os.path.join(root, "gtFine", "val", inst),
            os.path.join(meta.img_dir("val"), inst))
sampler = PolydetSampler(Config(input_h=64, input_w=128), meta, ann,
                         split="val", img_dir=meta.img_dir("val"))
assert sampler(0)["fg"].any() and sampler(0)["border_hm"].any()
gt = os.path.join(root, "x_gtFine_polygons.json")
json.dump({"imgHeight": 128, "imgWidth": 256, "objects": [
    {"label": "car", "polygon": [[30, 40], [90, 40], [90, 90], [30, 90]]},
    {"label": "person", "polygon": [[150, 30], [190, 60], [150, 100]]}]},
    open(gt, "w"))
with open(root + "/gt.csv", "w", newline="") as f:
    for row in tools.generate_annotations(gt, root + "/x.png", 16,
                                          height=128, width=256):
        csv.writer(f).writerow(row)
coco = tools.csv_to_coco(root + "/gt.csv", root + "/gt.json")
assert len(coco["annotations"]) == 2
tools.coco_poly_to_polar(root + "/gt.json", root + "/polar.json")
assert tools.polygon_coverage(root + "/gt.json")["n"] == 2
os.makedirs(root + "/masks")
for i in range(2):
    m = pil_fill.polygon(np.zeros((64, 96), np.uint8),
                         rng.uniform(0, 96, (9, 2)), fill=255)
    write_png(root + f"/masks/m{i}.png", m)
assert tools.simplify_masks(root + "/masks", root + "/simple") >= 0
assert sorted(os.listdir(root + "/simple")) == ["m0.png", "m1.png"]
results = glob.glob(root + "/exp/**/results.json", recursive=True)[0]
written = tools.visualize_results(
    results, meta.img_dir("val"), root + "/vis", vis_thresh=0.0,
    id_to_file={i: ann.load_img(i)["file_name"] for i in ann.get_img_ids()})
assert len(written) == 2
open(root + "/log.txt", "w").write("t: epoch 1 | 1 iters | 1s | loss 2.0\\n")
assert tools.parse_training_log(root + "/log.txt")[0]["loss"] == [(1, 2.0)]
assert tools.plot_training_log(root + "/log.txt") == []
print("tools ok")
"""


def test_eval_path_needs_no_pil_or_cv2(tmp_path):
    """test.main on a PNG fixture, with PIL, cv2 and matplotlib
    unimportable, writes the frames, reads them, rasterizes, reads the
    masks and GT back and reaches an AP; then the experimental losses,
    the sampler's fg from a 16-bit instance-id PNG, and the host tools
    (GT polygons, CSV and polar conversion, coverage, mask
    simplification, overlays, the log parser; the plot gives []) run."""
    env = _child_env()
    proc = subprocess.run([sys.executable, "-c", _EVAL_WITHOUT_PIL_CV2,
                           str(tmp_path)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "AP " in proc.stdout and "tools ok" in proc.stdout


_CTDET_WITHOUT_PIL_CV2 = """
import sys
sys.modules["PIL"] = sys.modules["cv2"] = None
from centerpoly_tpu_torch import main, test
from centerpoly_tpu_torch.data.fixture import write_box_fixture
root = write_box_fixture(sys.argv[1], {"train": 2, "val": 2}, 0, 96, 128,
                         categories=(1, 18), png=True)
args = ["ctdet", "--dataset", "coco", "--data_dir", root, "--save_dir",
        root + "/exp", "--input_h", "64", "--input_w", "64", "--head_conv",
        "16", "--K", "8", "--device", "cpu"]
main.main(args + ["--batch_size", "2", "--num_workers", "0",
                  "--num_epochs", "1", "--val_intervals", "1"])
out = test.main(args)
assert out["ap"] is not None and out["frames"] == 2, out
mods = ("centerpoly_tpu_torch.data.ctdet_sampler",
        "centerpoly_tpu_torch.eval.coco_eval", "centerpoly_tpu_torch.losses.ctdet")
assert all(m in sys.modules for m in mods)
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "centerpoly_tpu" or m.startswith("centerpoly_tpu.")]
assert not bad, bad
print("AP", out["ap"]["AP"])
"""


def test_ctdet_path_needs_no_pil_cv2_or_jax(tmp_path):
    """`main ctdet` (training, validation, the COCO evaluator) and test.py
    on a PNG box fixture, with PIL and cv2 unimportable: the frames read,
    an AP comes out, and neither JAX nor the JAX package was imported."""
    env = _child_env()
    proc = subprocess.run([sys.executable, "-c", _CTDET_WITHOUT_PIL_CV2,
                           str(tmp_path)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "AP " in proc.stdout


_TASKS_WITHOUT_PIL_CV2 = """
import sys
sys.modules["PIL"] = sys.modules["cv2"] = None
from centerpoly_tpu_torch import main, test
from centerpoly_tpu_torch.data.fixture import (write_box_fixture,
                                               write_keypoint_fixture)
task = sys.argv[2]
if task == "exdet":
    root = write_box_fixture(sys.argv[1], {"train": 2, "val": 2}, 0, 96, 128,
                             categories=(1, 18), png=True)
    dataset, extra = "coco", []
else:
    root = write_keypoint_fixture(sys.argv[1], {"train": 2, "val": 2}, 0, 96,
                                  128, png=True)
    dataset, extra = "coco_hp", ["--aug_rot", "1", "--rotate", "30"]
args = [task, "--dataset", dataset, "--data_dir", root, "--save_dir",
        root + "/exp", "--input_h", "64", "--input_w", "64", "--head_conv",
        "16", "--K", "8", "--device", "cpu"]
main.main(args + ["--batch_size", "2", "--num_workers", "0",
                  "--num_epochs", "1", "--val_intervals", "1"] + extra)
out = test.main(args)
assert out["ap"] is not None and out["frames"] == 2, out
mods = ("centerpoly_tpu_torch.infer.task_detectors",
        "centerpoly_tpu_torch.eval.coco_eval",
        f"centerpoly_tpu_torch.data.{task}_sampler",
        f"centerpoly_tpu_torch.losses.{task}")
assert all(m in sys.modules for m in mods)
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "centerpoly_tpu" or m.startswith("centerpoly_tpu.")]
assert not bad, bad
print("AP", out["ap"]["AP"])
"""


@pytest.mark.parametrize("task", ["exdet", "multi_pose"])
def test_exdet_and_multi_pose_need_no_pil_cv2_or_jax(tmp_path, task):
    """`main exdet` / `main multi_pose` (multi_pose with the rotated warp)
    and test.py on a PNG fixture, with PIL and cv2 unimportable: the
    frames read, an AP comes out, and neither JAX nor the JAX package was
    imported."""
    env = _child_env()
    proc = subprocess.run([sys.executable, "-c", _TASKS_WITHOUT_PIL_CV2,
                           str(tmp_path), task], cwd=ROOT, env=env,
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
