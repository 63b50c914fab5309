"""Build and load the csrc/ kernels: each source compiled by nvcc for
sm_90a at first use into a shared library with a plain C interface,
cached in BUILD_DIR by the contents of csrc/, and loaded with ctypes.
Every entry point returns the launch's cudaError (0 for none)."""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
KERNELS = ("dcn_fwd", "dcn_bwd", "upsample", "warp")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", CSRC]

_libs: dict = {}
_fns: dict = {}


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the csrc/ kernels")
    return found


def lib_path(name: str) -> str:
    """The library of csrc/<name>.cu, keyed on every *.cu and *.cuh file
    under csrc/ (any of them may be included) and on the nvcc flags, so an
    edited header cannot leave a stale library in BUILD_DIR."""
    h = hashlib.sha256(" ".join(f for f in NVCC_FLAGS if f != CSRC).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build() -> dict[str, tuple[str, str]]:
    """Compile every csrc/ source whose library is not yet in BUILD_DIR,
    one nvcc process per source, all started together.  Returns
    {name: (library path, nvcc's ptxas report)}."""
    procs = {}
    for name in KERNELS:
        lib = lib_path(name)
        if not os.path.exists(lib):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{lib}.{os.getpid()}.tmp"
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                 os.path.join(CSRC, f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc {name} failed ({proc.returncode}):\n{out}")
            continue
        with open(lib[:-3] + ".log", "w") as f:
            f.write(out)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    ret = {}
    for name in KERNELS:
        lib = lib_path(name)
        with open(lib[:-3] + ".log") as f:
            ret[name] = (lib, f.read())
    return ret


def load(name: str, fn: str, argtypes):
    """The C function `fn` of csrc/<name>.cu's library (every library
    built at the first load), taking `argtypes` and returning an int."""
    if (name, fn) not in _fns:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(build()[name][0])
        f = getattr(_libs[name], fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _fns[(name, fn)] = f
    return _fns[(name, fn)]


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count
