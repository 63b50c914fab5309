"""DCNv2 forward: the hand-written CUDA kernel and its plain PyTorch version.

`deform_conv2d` keeps the JAX package's layout and contract
(centerpoly_tpu/models/deform_conv.py::deform_conv2d):

  x        (B, H, W, Cin)
  offsets  (B, H, W, 18)  tap-major interleaved (dy, dx), row-major taps
  masks    (B, H, W, 9)   already passed through sigmoid
  weights  (3, 3, Cin, Cout)
  bias     (Cout,)

`max_offset_y=None` is the exact semantics of kernels/dcn_pallas.py; an
integer R is the `rowband:R` semantics of kernels/dcn_rowband.py: y-offsets
clamped to [-R, R], x exact, samples outside the image zero.

On a CUDA tensor the wrapper launches csrc/dcn_fwd.cu (built with nvcc for
sm_90a at first use, bound through a plain C interface) or raises; on a CPU
tensor it computes `deform_conv2d_ref`.  The kernel takes f32 or bf16
activations and weights and accumulates in f32.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "dcn_fwd.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel launches by clamp mode; only the CUDA branch of deform_conv2d
# counts, so a run can show that its DCN nodes went through the kernel
launches = {"exact": 0, "rowband": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build csrc/dcn_fwd.cu")
    return found


def build() -> tuple[str, str]:
    """Compile csrc/dcn_fwd.cu into BUILD_DIR unless a library of the same
    source is already there.  Returns (library path, nvcc's ptxas report)."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"libdcn_fwd-{digest}.so")
    log = lib[:-3] + ".log"
    if not os.path.exists(lib):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        with open(log, "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    with open(log) as f:
        return lib, f.read()


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()[0])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dcn_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                                ctypes.c_float, p]
        lib.dcn_fwd.restype = i
        _lib = lib
    return _lib


def _clamp_y(offsets: torch.Tensor, r: float) -> torch.Tensor:
    """Clamp only the y components ([..., 0::2]) to [-r, r]
    (kernels/dcn_rowband.py::_clamp_y)."""
    oy = offsets[..., 0::2].clamp(-r, r)
    ox = offsets[..., 1::2]
    return torch.stack([oy, ox], dim=-1).reshape(offsets.shape)


def deform_conv2d_ref(x, offsets, masks, weights, bias=None,
                      max_offset_y: int | None = None) -> torch.Tensor:
    """Plain PyTorch DCNv2 forward with the arithmetic of the JAX
    `deform_conv2d`, including the rounding of the fractions fy, fx to
    x.dtype; with `max_offset_y` the offsets are y-clamped first."""
    if max_offset_y is not None:
        offsets = _clamp_y(offsets, float(max_offset_y))
    b, h, w, cin = x.shape
    cout = weights.shape[-1]
    dev = x.device
    gy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    gx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    ky = torch.arange(-1, 2, dtype=torch.float32, device=dev).repeat_interleave(3)
    kx = torch.arange(-1, 2, dtype=torch.float32, device=dev).repeat(3)

    off = offsets.reshape(b, h, w, 9, 2).float()
    sy = gy[None, :, :, None] + ky + off[..., 0]
    sx = gx[None, :, :, None] + kx + off[..., 1]
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    fy = (sy - y0)[..., None].to(x.dtype)
    fx = (sx - x0)[..., None].to(x.dtype)
    y0 = y0.long()
    x0 = x0.long()

    bidx = torch.arange(b, device=dev)[:, None, None, None] * (h * w)
    xf = x.reshape(b * h * w, cin)

    def tap(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = bidx + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        v = xf[idx]
        return torch.where(inb[..., None], v, 0)

    sampled = (tap(y0, x0) * (1 - fy) * (1 - fx)
               + tap(y0, x0 + 1) * (1 - fy) * fx
               + tap(y0 + 1, x0) * fy * (1 - fx)
               + tap(y0 + 1, x0 + 1) * fy * fx)
    sampled = sampled * masks[..., None]
    out = torch.einsum("bhwkc,kco->bhwo", sampled,
                       weights.reshape(9, cin, cout).to(sampled.dtype))
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)


def _check(x, offsets, masks, weights, bias):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"dcn_fwd: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"dcn_fwd: x must be (B, H, W, Cin), got {tuple(x.shape)}")
    b, h, w, cin = x.shape
    cout = weights.shape[-1]
    want = {"offsets": (offsets, (b, h, w, 18), torch.float32),
            "masks": (masks, (b, h, w, 9), torch.float32),
            "weights": (weights, (3, 3, cin, cout), x.dtype),
            "bias": (bias, (cout,), x.dtype)}
    for name, (t, shape, dtype) in [("x", (x, tuple(x.shape), x.dtype)),
                                    *want.items()]:
        if t.device != x.device:
            raise ValueError(f"dcn_fwd: {name} on {t.device}, x on {x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"dcn_fwd: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"dcn_fwd: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"dcn_fwd: {name} must be contiguous")


def deform_conv2d(x, offsets, masks, weights, bias=None,
                  max_offset_y: int | None = None) -> torch.Tensor:
    """DCNv2 forward (see the module docstring for the contract)."""
    if x.device.type == "cpu":
        return deform_conv2d_ref(x, offsets, masks, weights, bias,
                                 max_offset_y)
    if x.device.type != "cuda":
        raise ValueError(f"dcn_fwd: no kernel for device {x.device}")
    if bias is None:
        bias = torch.zeros(weights.shape[-1], dtype=x.dtype, device=x.device)
    _check(x, offsets, masks, weights, bias)
    b, h, w, cin = x.shape
    cout = weights.shape[-1]
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    lib = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dcn_fwd(x.data_ptr(), offsets.data_ptr(), masks.data_ptr(),
                          weights.data_ptr(), bias.data_ptr(), out.data_ptr(),
                          b, h, w, cin, cout, _DTYPE_CODE[x.dtype],
                          int(max_offset_y is not None),
                          float(max_offset_y or 0), stream)
    if err != 0:
        raise RuntimeError(f"dcn_fwd launch failed: cudaError {err}")
    launches["exact" if max_offset_y is None else "rowband"] += 1
    return out
