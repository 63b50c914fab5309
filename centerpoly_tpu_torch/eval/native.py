"""ctypes bindings of the repo's native eval components in cpp/ (the JAX
package's eval/native.py), built from the same sources into the port's
own build directory:

- `add_to_confusion_matrix`: pixel-level confusion accumulation (ref
  addToConfusionMatrix.pyx), by the native loop, or numpy where the
  library is not built;
- `run_kitti_eval`: the official-protocol KITTI detection AP (ref
  src/tools/kitti_eval/evaluate_object_3d_offline.cpp), a binary.

`ensure_built` runs `make -C cpp BUILD=<build dir>` (the Makefile's BUILD
is overridable), by default into centerpoly_tpu_torch/_build/native, under
an exclusive file lock, into a directory of its own that is renamed into
place, so a process that finds an artifact finds it whole however many
build at once.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
from typing import Dict, Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPP_DIR = os.path.join(os.path.dirname(_PKG), "cpp")
BUILD_DIR = os.path.join(_PKG, "_build", "native")
LIB_NAME = "libcenterpoly_native.so"
KITTI_EVAL_NAME = "kitti_eval"

# why the last build failed ("" when it did not): the missing tool or the
# compiler's message
last_build_error = ""
_libs: Dict[str, ctypes.CDLL] = {}


def artifact(name: str, build_dir: Optional[str] = None) -> str:
    return os.path.join(build_dir or BUILD_DIR, name)


def ensure_built(names=(LIB_NAME, KITTI_EVAL_NAME),
                 build_dir: Optional[str] = None) -> bool:
    """Build the cpp/ artifacts `names` into `build_dir` where missing.
    Returns True when every one of them is there; where not, the reason is
    in `last_build_error`.

    Under the lock, make writes into <build_dir>/tmp-<pid> and each
    artifact is renamed into `build_dir`: a rename is atomic, so no reader
    ever loads a half-written library."""
    global last_build_error
    build_dir = os.path.abspath(build_dir or BUILD_DIR)
    paths = [artifact(n, build_dir) for n in names]
    if all(os.path.exists(p) for p in paths):
        return True
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if all(os.path.exists(p) for p in paths):
            return True
        tmp = os.path.join(build_dir, f"tmp-{os.getpid()}")
        try:
            proc = subprocess.run(["make", "-C", CPP_DIR, f"BUILD={tmp}"],
                                  capture_output=True, text=True)
            last_build_error = ("" if proc.returncode == 0 else
                                f"make exited {proc.returncode}: "
                                f"{(proc.stderr or proc.stdout)[-2000:]}")
        except OSError as e:            # make itself is missing
            last_build_error = f"cannot run make: {e}"
        # what make did build is kept, each artifact on its own: the
        # library must not be missing because the binary failed, or back
        for name in (LIB_NAME, KITTI_EVAL_NAME):
            if os.path.exists(os.path.join(tmp, name)):
                os.replace(os.path.join(tmp, name), artifact(name, build_dir))
        shutil.rmtree(tmp, ignore_errors=True)
    return all(os.path.exists(p) for p in paths)


def _load(build_dir: Optional[str] = None):
    path = artifact(LIB_NAME, build_dir)
    if path not in _libs and ensure_built((LIB_NAME,), build_dir):
        lib = ctypes.CDLL(path)
        lib.add_to_confusion_matrix.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint32]
        lib.add_to_confusion_matrix.restype = None
        _libs[path] = lib
    return _libs.get(path)


def add_to_confusion_matrix(prediction: np.ndarray,
                            ground_truth: np.ndarray,
                            conf_matrix: np.ndarray,
                            build_dir: Optional[str] = None) -> np.ndarray:
    """Accumulate uint8 label images into conf_matrix (dim, dim) uint64:
    the native loop where the library builds, else numpy's bincount with
    the same rule (labels >= dim are dropped)."""
    pred = np.ascontiguousarray(prediction, np.uint8).reshape(-1)
    gt = np.ascontiguousarray(ground_truth, np.uint8).reshape(-1)
    assert pred.shape == gt.shape
    dim = conf_matrix.shape[0]
    assert conf_matrix.shape == (dim, dim)

    lib = _load(build_dir)
    if lib is not None:
        cm = np.ascontiguousarray(conf_matrix, np.uint64)
        lib.add_to_confusion_matrix(
            pred.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            gt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_uint64(pred.size),
            cm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.c_uint32(dim))
        conf_matrix[:] = cm
        return conf_matrix

    valid = (gt < dim) & (pred < dim)
    idx = gt[valid].astype(np.int64) * dim + pred[valid].astype(np.int64)
    conf_matrix += np.bincount(idx, minlength=dim * dim).reshape(
        dim, dim).astype(np.uint64)
    return conf_matrix


def run_kitti_eval(gt_dir: str, result_dir: str,
                   build_dir: Optional[str] = None
                   ) -> Optional[Dict[str, Dict[str, list]]]:
    """Run the native KITTI evaluator over KITTI txt files.  Returns
    {class: {metric: [easy, moderate, hard]}}, metrics in {'detection',
    'bev', '3d', 'aos'}; None when the binary does not build
    (`last_build_error` says why)."""
    if not ensure_built((KITTI_EVAL_NAME,), build_dir):
        return None
    proc = subprocess.run([artifact(KITTI_EVAL_NAME, build_dir), gt_dir,
                           result_dir], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"kitti_eval failed: {proc.stderr}")
    out: Dict[str, Dict[str, list]] = {}
    for line in proc.stdout.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "AP" and len(parts) == 6:
            _, cls, metric, e, m, h = parts
            out.setdefault(cls, {})[metric] = [float(e), float(m),
                                               float(h)]
        elif parts[0] == "AOS" and len(parts) == 5:
            _, cls, e, m, h = parts
            out.setdefault(cls, {})["aos"] = [float(e), float(m),
                                              float(h)]
    return out
