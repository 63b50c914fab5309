"""DCNv2: the hand-written CUDA kernels and their plain PyTorch versions.

`deform_conv2d` keeps the JAX package's layout and contract
(centerpoly_tpu/models/deform_conv.py::deform_conv2d):

  x        (B, H, W, Cin)
  offsets  (B, H, W, 18)  tap-major interleaved (dy, dx), row-major taps
  masks    (B, H, W, 9)   already passed through sigmoid
  weights  (3, 3, Cin, Cout)
  bias     (Cout,)

The clamp is set by two keywords that exclude each other (both at once is
a ValueError):
  * neither given: the exact semantics of kernels/dcn_pallas.py;
  * `max_offset_y=R`: the `rowband:R` semantics of kernels/dcn_rowband.py,
    y-offsets clamped to [-R, R], x exact.  The clamp passes a y-offset
    gradient of 1 inside the band, 0.5 at exactly +-R and 0 beyond
    (jnp.clip's tie rule, dcn_rowband.py:458-465);
  * `max_offset=R`: the `halo:R` semantics of kernels/dcn_halo.py, both
    offset axes clamped to [-R, R].  Its offset gradients are those at the
    clamped offsets, zeroed on each component where |o| >= R, the exact
    bound included: the rule of the halo kernel's backward
    (dcn_halo.py:442-450).  The JAX oracle `deform_conv2d_halo_ref` and
    the JAX module's XLA fallback (what runs off the TPU) pass 0.5 of the
    one-sided derivative at exactly +-R instead (jnp.clip's tie rule).  The
    port follows the kernel on the card and in its plain CPU version alike,
    so the function does not depend on the device.
Samples outside the image read zero in every mode.

On a CUDA tensor the forward launches csrc/dcn_fwd.cu and the backward
csrc/dcn_bwd.cu (each built with nvcc for sm_90a at first use, bound
through a plain C interface) or raises; on a CPU tensor the forward is
`deform_conv2d_ref` and the backward is autograd through it
(`deform_conv2d_backward_ref`).  The kernels take f32 or bf16
activations and weights and accumulate in f32.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {name: os.path.join(_PKG, "csrc", f"{name}.cu")
           for name in ("dcn_fwd", "dcn_bwd")}
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel launches by kernel and clamp mode; only the CUDA branches count,
# so a run can show that its DCN nodes went through the kernels
launches = {"exact": 0, "rowband": 0, "halo": 0,
            "bwd_exact": 0, "bwd_rowband": 0, "bwd_halo": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# clamp mode -> the kernels' `clamp` argument (none / y / xy)
_CLAMP_CODE = {"exact": 0, "rowband": 1, "halo": 2}
_libs: dict = {}


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


def _lib_path(name: str) -> str:
    with open(SOURCES[name], "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build() -> dict[str, tuple[str, str]]:
    """Compile every csrc/ source whose library is not yet in BUILD_DIR,
    one nvcc process per source, all started together.  Returns
    {name: (library path, nvcc's ptxas report)}."""
    procs = {}
    for name, src in SOURCES.items():
        lib = _lib_path(name)
        if not os.path.exists(lib):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{lib}.{os.getpid()}.tmp"
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
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
    for name in SOURCES:
        lib = _lib_path(name)
        with open(lib[:-3] + ".log") as f:
            ret[name] = (lib, f.read())
    return ret


def _load(name: str):
    if name not in _libs:
        lib = ctypes.CDLL(build()[name][0])
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "dcn_fwd":
            lib.dcn_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                                    ctypes.c_float, p]
            lib.dcn_fwd.restype = i
        else:
            lib.dcn_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                                    ctypes.c_float, p]
            lib.dcn_bwd.restype = i
        _libs[name] = lib
    return _libs[name]


def clamp_y_keep(oy: torch.Tensor, r: float) -> torch.Tensor:
    """d clip(oy, -r, r) / d oy under jnp.clip's tie rule: 1 inside the
    band, 0.5 at exactly +-r, 0 beyond (dcn_rowband.py:458-465)."""
    one = torch.ones_like(oy)
    half, zero = 0.5 * one, torch.zeros_like(oy)
    return (torch.where(oy > -r, one, torch.where(oy == -r, half, zero))
            * torch.where(oy < r, one, torch.where(oy == r, half, zero)))


class _ClampY(torch.autograd.Function):
    """Clamp only the y components ([..., 0::2]) to [-r, r], with the
    JAX package's gradient at the bound (not Tensor.clamp's 1)."""

    @staticmethod
    def forward(ctx, offsets, r):
        ctx.save_for_backward(offsets)
        ctx.r = r
        out = offsets.clone()
        out[..., 0::2] = torch.minimum(torch.maximum(
            offsets[..., 0::2], offsets.new_tensor(-r)), offsets.new_tensor(r))
        return out

    @staticmethod
    def backward(ctx, g):
        (offsets,) = ctx.saved_tensors
        g = g.clone()
        g[..., 0::2] *= clamp_y_keep(offsets[..., 0::2], ctx.r)
        return g, None


def clamp_y(offsets: torch.Tensor, r: float) -> torch.Tensor:
    """y-clamp of kernels/dcn_rowband.py::_clamp_y with its tie rule."""
    return _ClampY.apply(offsets, float(r))


def halo_keep(offsets: torch.Tensor, r: float) -> torch.Tensor:
    """The halo clamp's pass-through: 1 where -r < o < r, else 0, the
    exact bound included (dcn_halo.py:442-450)."""
    return ((offsets > -r) & (offsets < r)).to(offsets.dtype)


class _ClampXY(torch.autograd.Function):
    """Clamp every offset component to [-r, r], with the halo kernel's
    gradient: 0 wherever the clamp saturates, at exactly +-r too."""

    @staticmethod
    def forward(ctx, offsets, r):
        ctx.save_for_backward(offsets)
        ctx.r = r
        return torch.minimum(torch.maximum(offsets, offsets.new_tensor(-r)),
                             offsets.new_tensor(r))

    @staticmethod
    def backward(ctx, g):
        (offsets,) = ctx.saved_tensors
        return g * halo_keep(offsets, ctx.r), None


def clamp_xy(offsets: torch.Tensor, r: float) -> torch.Tensor:
    """Both-axes clamp of the `halo:R` mode with its tie rule."""
    return _ClampXY.apply(offsets, float(r))


def clamp_mode(max_offset_y: int | None = None,
               max_offset: int | None = None) -> tuple[str, float | None]:
    """The clamp keywords -> (mode, R): ("exact", None), ("rowband", R) or
    ("halo", R).  The two keywords exclude each other."""
    if max_offset_y is not None and max_offset is not None:
        raise ValueError("dcn: give max_offset_y (rowband) or max_offset "
                         "(halo), not both")
    if max_offset is not None:
        return "halo", float(max_offset)
    if max_offset_y is not None:
        return "rowband", float(max_offset_y)
    return "exact", None


def deform_conv2d_ref(x, offsets, masks, weights, bias=None,
                      max_offset_y: int | None = None,
                      max_offset: int | None = None) -> torch.Tensor:
    """Plain PyTorch DCNv2 forward with the arithmetic of the JAX
    `deform_conv2d`, including the rounding of the fractions fy, fx to
    x.dtype; with `max_offset_y` the offsets are y-clamped first, with
    `max_offset` clamped on both axes.  Its autograd is the JAX package's:
    floor has no gradient, so a sample at an integer position
    differentiates on its floor cell (hat derivative -1 there, not 0); the
    clamps pass their gradients by their tie rules (module docstring)."""
    mode, r = clamp_mode(max_offset_y, max_offset)
    if mode == "rowband":
        offsets = clamp_y(offsets, r)
    elif mode == "halo":
        offsets = clamp_xy(offsets, r)
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
    y0 = torch.floor(sy).detach()
    x0 = torch.floor(sx).detach()
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


def deform_conv2d_backward_ref(x, offsets, masks, weights, bias, g,
                               max_offset_y: int | None = None,
                               max_offset: int | None = None):
    """Plain backward: (dx, doffsets, dmasks, dweights, dbias) by autograd
    through `deform_conv2d_ref`, on any device."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (x, offsets, masks, weights, bias)]
        out = deform_conv2d_ref(*leaves, max_offset_y=max_offset_y,
                                max_offset=max_offset)
        return torch.autograd.grad(out, leaves, g)


def _check(x, offsets, masks, weights, bias, g=None):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"dcn: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"dcn: x must be (B, H, W, Cin), got {tuple(x.shape)}")
    b, h, w, cin = x.shape
    cout = weights.shape[-1]
    want = {"offsets": (offsets, (b, h, w, 18), torch.float32),
            "masks": (masks, (b, h, w, 9), torch.float32),
            "weights": (weights, (3, 3, cin, cout), x.dtype),
            "bias": (bias, (cout,), x.dtype)}
    if g is not None:
        want["grad"] = (g, (b, h, w, cout), x.dtype)
    for name, (t, shape, dtype) in [("x", (x, tuple(x.shape), x.dtype)),
                                    *want.items()]:
        if t.device != x.device:
            raise ValueError(f"dcn: {name} on {t.device}, x on {x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"dcn: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"dcn: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"dcn: {name} must be contiguous")


def _forward(x, offsets, masks, weights, bias, max_offset_y, max_offset):
    """The forward on x's device: the kernel on CUDA, the plain version on
    the CPU."""
    mode, r = clamp_mode(max_offset_y, max_offset)
    if x.device.type == "cpu":
        return deform_conv2d_ref(x, offsets, masks, weights, bias,
                                 max_offset_y, max_offset)
    if x.device.type != "cuda":
        raise ValueError(f"dcn_fwd: no kernel for device {x.device}")
    _check(x, offsets, masks, weights, bias)
    b, h, w, cin = x.shape
    cout = weights.shape[-1]
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    lib = _load("dcn_fwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dcn_fwd(x.data_ptr(), offsets.data_ptr(), masks.data_ptr(),
                          weights.data_ptr(), bias.data_ptr(), out.data_ptr(),
                          b, h, w, cin, cout, _DTYPE_CODE[x.dtype],
                          _CLAMP_CODE[mode], r or 0.0, stream)
    if err != 0:
        raise RuntimeError(f"dcn_fwd launch failed: cudaError {err}")
    launches[mode] += 1
    return out


def deform_conv2d_backward(x, offsets, masks, weights, bias, g,
                           max_offset_y: int | None = None,
                           max_offset: int | None = None):
    """DCNv2 backward: (dx, doffsets, dmasks, dweights, dbias) for the
    cotangent g (B, H, W, Cout) of `deform_conv2d`; offsets are the raw
    (unclamped) ones.

    On CUDA: gk = W_k @ g for every tap (one f32 matmul,
    dcn_rowband.py:309, dcn_halo.py:385), then csrc/dcn_bwd.cu recomputes
    each tap's four bilinear corners at the clamped offsets and emits the
    samples, d offsets, d masks and dx by f32 atomics; dW and db are
    matmul / sum over those (dcn_rowband.py:353-355, dcn_halo.py:388-389),
    and the clamp's pass-through scales the offset gradients: the y
    components by `clamp_y_keep` (rowband, :458-465), every component by
    `halo_keep` (halo, dcn_halo.py:442-450)."""
    mode, r = clamp_mode(max_offset_y, max_offset)
    if x.device.type == "cpu":
        return deform_conv2d_backward_ref(x, offsets, masks, weights, bias,
                                          g, max_offset_y, max_offset)
    if x.device.type != "cuda":
        raise ValueError(f"dcn_bwd: no kernel for device {x.device}")
    _check(x, offsets, masks, weights, bias, g)
    b, h, w, cin = x.shape
    cout = weights.shape[-1]
    npix = b * h * w
    g2 = g.reshape(npix, cout).float()
    # (npix, 9*Cin) f32: 302 MB for the 128x256x64 node at batch 4
    gk = g2 @ weights.reshape(9 * cin, cout).float().T
    samp = torch.empty((npix, 9 * cin), dtype=torch.float32, device=x.device)
    doff = torch.empty((b, h, w, 18), dtype=torch.float32, device=x.device)
    dmask = torch.empty((b, h, w, 9), dtype=torch.float32, device=x.device)
    dx = torch.zeros((b, h, w, cin), dtype=torch.float32, device=x.device)
    lib = _load("dcn_bwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dcn_bwd(x.data_ptr(), offsets.data_ptr(), masks.data_ptr(),
                          gk.data_ptr(), samp.data_ptr(), doff.data_ptr(),
                          dmask.data_ptr(), dx.data_ptr(), b, h, w, cin,
                          _DTYPE_CODE[x.dtype], _CLAMP_CODE[mode], r or 0.0,
                          stream)
    if err != 0:
        raise RuntimeError(f"dcn_bwd launch failed: cudaError {err}")
    launches[f"bwd_{mode}"] += 1
    if mode == "rowband":
        doff[..., 0::2] *= clamp_y_keep(offsets[..., 0::2], r)
    elif mode == "halo":
        doff *= halo_keep(offsets, r)
    del gk      # stream-ordered: its memory is reused after the kernel
    # modulated samples in place: dW = (m S)^T g
    samp.view(npix, 9, cin).mul_(masks.reshape(npix, 9, 1))
    dw = (samp.T @ g2).reshape(3, 3, cin, cout)
    db = g2.sum(0)
    return (dx.to(x.dtype), doff, dmask, dw.to(weights.dtype),
            db.to(bias.dtype))


class _DeformConv2d(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient.  Saves
    the raw offsets and the clamp keywords: the kernels own the clamp and
    its tie rule."""

    @staticmethod
    def forward(ctx, x, offsets, masks, weights, bias, max_offset_y,
                max_offset):
        ctx.save_for_backward(x, offsets, masks, weights, bias)
        ctx.clamp = (max_offset_y, max_offset)
        return _forward(x, offsets, masks, weights, bias, max_offset_y,
                        max_offset)

    @staticmethod
    def backward(ctx, g):
        grads = deform_conv2d_backward(*ctx.saved_tensors, g.contiguous(),
                                       *ctx.clamp)
        return (*grads, None, None)


def deform_conv2d(x, offsets, masks, weights, bias=None,
                  max_offset_y: int | None = None,
                  max_offset: int | None = None) -> torch.Tensor:
    """DCNv2 forward (see the module docstring for the contract); when
    grad is enabled the result carries the backward of
    `deform_conv2d_backward`."""
    if bias is None:
        bias = torch.zeros(weights.shape[-1], dtype=x.dtype, device=x.device)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, offsets, masks, weights, bias)):
        return _DeformConv2d.apply(x, offsets, masks, weights, bias,
                                   max_offset_y, max_offset)
    return _forward(x, offsets, masks, weights, bias, max_offset_y,
                    max_offset)
