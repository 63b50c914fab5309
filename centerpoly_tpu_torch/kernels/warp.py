"""The serving input warp: uint8 (B, H, W, 3) frames -> the network's
normalised input (B, 3, h, w), channels-last, in the detector's type, for
an axis-aligned `trans` = [[ax, 0, tx], [0, ay, ty]] (source -> output).

`warp_normalize` launches csrc/warp.cu (built with nvcc for sm_90a at first
use, bound through a plain C interface), one launch for the whole batch:
a two-tap bilinear gather on each axis, / 255, - mean, / std, in f32, and
one rounding to the output type.  The six numbers of `trans` and the
channels' mean and std go to the kernel by value, from the host: no copy
to the card and no synchronisation.  `warp_normalize_ref` is the plain
version: geometry/affine.py::warp_axis_aligned a frame (two dense f32
sampling matrices), stacked, normalised and cast.  The detector runs the
plain version for frames on the CPU; for frames on the card it runs the
kernel, and `warp_normalize` raises where the kernel cannot compute the
call (`why_not` says why) rather than run anything else.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..geometry.affine import warp_axis_aligned
from . import nvcc

# kernel launches, so a run can show that its frames went through the kernel
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P, _P] + [_I] * 5 + [_F] * 10 + [_I, _I, _P]
# an off-diagonal entry of `trans` up to this share of its row's scale is
# rounding left by get_affine_transform's solve (~1e-17 at rot 0); the
# plain version, which reads only the diagonal and the shifts, ignores it
SHEAR_RTOL = 1e-6


def _trans_reason(trans) -> str | None:
    """None for an axis-aligned 2x3 affine on the host with finite entries
    and non-zero scales, else what it lacks."""
    if isinstance(trans, torch.Tensor) and trans.device.type != "cpu":
        return (f"trans on {trans.device}: the kernel takes its numbers "
                "from the host")
    t = np.asarray(trans, dtype=np.float32)
    if t.shape != (2, 3):
        return f"trans of shape {t.shape}, not (2, 3)"
    if not np.isfinite(t).all():
        return "trans not finite"
    if t[0, 0] == 0 or t[1, 1] == 0:
        return f"trans with a zero scale ({t[0, 0]}, {t[1, 1]})"
    if (abs(t[0, 1]) > SHEAR_RTOL * abs(t[0, 0])
            or abs(t[1, 0]) > SHEAR_RTOL * abs(t[1, 1])):
        return (f"trans not axis-aligned (off-diagonal {t[0, 1]}, "
                f"{t[1, 0]}): a rotation or shear")
    return None


def why_not(frames_u8: torch.Tensor, trans, size, mean, std,
            dtype: torch.dtype) -> str | None:
    """None where the kernel computes this call, else the first thing it
    lacks: uint8 frames; (B, H, W, 3) with 3 means and 3 stds; contiguous,
    16-byte aligned frames; an axis-aligned `trans` on the host with
    non-zero scales; a positive output size; an output type of f32 or
    bf16; frames on the card (last, so that the CPU tests see every other
    reason)."""
    if frames_u8.dtype != torch.uint8:
        return f"frames of {frames_u8.dtype}, not uint8"
    if (frames_u8.dim() != 4 or frames_u8.shape[3] != 3 or len(mean) != 3
            or len(std) != 3):
        return (f"frames {tuple(frames_u8.shape)} with {len(mean)} means and "
                f"{len(std)} stds: (B, H, W, 3) with 3 of each")
    if not frames_u8.is_contiguous():
        return "frames not contiguous"
    if frames_u8.data_ptr() % 16 != 0:
        return "frames not 16-byte aligned"
    why = _trans_reason(trans)
    if why is not None:
        return why
    if len(size) != 2 or min(size) < 1:
        return f"output size {tuple(size)}, not (h, w) of at least 1"
    if dtype not in _DTYPE_CODE:
        return f"output type {dtype}: float32 or bfloat16"
    if frames_u8.device.type != "cuda":
        return f"frames on {frames_u8.device}: a CUDA tensor"
    return None


def warp_normalize_ref(frames_u8: torch.Tensor, trans, size, mean, std,
                       dtype: torch.dtype) -> torch.Tensor:
    """The plain version: `warp_axis_aligned` a frame in f32, stacked,
    / 255, - mean, / std, then cast to `dtype` channels-last."""
    x = torch.stack([warp_axis_aligned(f.float(), trans, size)
                     for f in frames_u8])
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    x = ((x / 255.0 - mean) / std).permute(0, 3, 1, 2)
    return x.to(dtype, memory_format=torch.channels_last)


def warp_normalize(frames_u8: torch.Tensor, trans, size, mean, std,
                   dtype: torch.dtype) -> torch.Tensor:
    """uint8 (B, H, W, 3) frames -> (B, 3, h, w) for `size` = (h, w), in
    `dtype`, channels-last, by the kernel; ValueError where `why_not` names
    a reason."""
    global launches
    why = why_not(frames_u8, trans, size, mean, std, dtype)
    if why is not None:
        raise ValueError(
            f"warp_normalize: no kernel for frames {tuple(frames_u8.shape)} "
            f"{frames_u8.dtype} on {frames_u8.device}: {why}")
    b, h, w, _ = frames_u8.shape
    oh, ow = size
    t = np.asarray(trans, dtype=np.float32)
    out = torch.empty((b, 3, oh, ow), dtype=dtype, device=frames_u8.device,
                      memory_format=torch.channels_last)
    fn = nvcc.load("warp", "launch_warp_normalize", _ARGS)
    with torch.cuda.device(frames_u8.device):
        err = fn(frames_u8.data_ptr(), out.data_ptr(), b, h, w, oh, ow,
                 float(t[0, 0]), float(t[0, 2]), float(t[1, 1]),
                 float(t[1, 2]), *map(float, mean), *map(float, std),
                 _DTYPE_CODE[dtype],
                 nvcc.sm_count(torch.cuda.current_device()),
                 torch.cuda.current_stream(frames_u8.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"warp_normalize launch failed: cudaError {err}")
    launches += 1
    return out
