"""The IDA up-sampler: a depthwise stride-f transposed convolution (kernel
2f, padding f // 2, one group a channel, no bias) with the skip added, as
models/dla.py's `DepthwiseUpsample` runs it inside `IDAUp`.

`upsample_add` launches csrc/upsample.cu (built with nvcc for sm_90a at
first use, bound through a plain C interface); `upsample_add_ref` is the
plain version, `F.conv_transpose2d` then the add.  The kernel sums the (at
most 4) products of each output in f32, adds the skip and rounds once to
the tensors' type: the output does not change from run to run.  It has no
backward, so the module runs the plain version where autograd records
(`records`), and on the CPU; every other call goes to the kernel, and
`upsample_add` raises where the kernel cannot compute it (`why_not` says
why) rather than run anything else.  Under autocast, x and the weight go
to autocast's type first, as autocast casts conv_transpose2d's inputs.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import nvcc

# kernel launches, so a run can show that its up-samplers went through the
# kernel
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernel holds the whole weight, in f32, in static shared memory
SMEM_BYTES = 48 * 1024
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 4 + [_I] * 7 + [_P]


def out_size(n: int, factor: int) -> int:
    """ConvTranspose2d's output length for input length `n` at kernel 2f,
    stride f, padding f // 2: f n for an even f, f n + 1 for an odd one."""
    return (n - 1) * factor - 2 * (factor // 2) + 2 * factor


def records(*ts: torch.Tensor) -> bool:
    """Whether autograd records an operation on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def why_not(x: torch.Tensor, weight: torch.Tensor, factor: int,
            skip: torch.Tensor) -> str | None:
    """None where the kernel computes this call, else the first thing it
    lacks: autograd recording nothing; x, weight and skip of one type, f32
    or bf16; C a whole number of 16-byte vectors and the weight, in f32,
    within the kernel's shared memory; skip of the output's shape; x and
    skip channels-last, contiguous so and 16-byte aligned; all three
    CUDA tensors on one device (last, so that the CPU tests see every
    other reason)."""
    if records(x, weight, skip):
        return "autograd records (the kernel has no backward)"
    if x.dtype not in _DTYPE_CODE or any(t.dtype != x.dtype
                                         for t in (weight, skip)):
        return (f"types {x.dtype}, {weight.dtype}, {skip.dtype}: one of "
                "float32 or bfloat16 for all three")
    if x.dim() != 4:
        return f"x of {x.dim()} dimensions"
    b, c, h, w = x.shape
    k = 2 * factor
    if tuple(weight.shape) != (c, 1, k, k):
        return f"weight {tuple(weight.shape)}, not ({c}, 1, {k}, {k})"
    if c % (16 // x.element_size()) != 0:
        return f"{c} channels, no whole number of 16-byte vectors"
    if c * k * k * 4 > SMEM_BYTES:
        return f"weight of {c * k * k * 4} bytes in f32 over {SMEM_BYTES}"
    want = (b, c, out_size(h, factor), out_size(w, factor))
    if tuple(skip.shape) != want:
        return f"skip {tuple(skip.shape)}, not {want}"
    for name, t in (("x", x), ("skip", skip)):
        if not t.is_contiguous(memory_format=torch.channels_last):
            return f"{name} not channels-last contiguous"
        if t.data_ptr() % 16 != 0:
            return f"{name} not 16-byte aligned"
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in (weight, skip)):
        return (f"x on {x.device}, weight on {weight.device}, skip on "
                f"{skip.device}: CUDA tensors on one device")
    return None


def upsample_add_ref(x: torch.Tensor, weight: torch.Tensor, factor: int,
                     skip: torch.Tensor) -> torch.Tensor:
    """The plain version: the grouped transposed convolution, then + skip."""
    return F.conv_transpose2d(x, weight, stride=factor, padding=factor // 2,
                              groups=x.shape[1]) + skip


def upsample_add(x: torch.Tensor, weight: torch.Tensor, factor: int,
                 skip: torch.Tensor) -> torch.Tensor:
    """x (B, C, H, W) and skip (B, C, Ho, Wo), both channels-last, weight
    (C, 1, 2f, 2f) -> the up-sampled x plus skip, (B, C, Ho, Wo)
    channels-last, by the kernel; ValueError where `why_not` names a
    reason."""
    global launches
    if x.device.type == "cuda" and torch.is_autocast_enabled("cuda"):
        dt = torch.get_autocast_dtype("cuda")
        x, weight = x.to(dt), weight.to(dt)
    why = why_not(x, weight, factor, skip)
    if why is not None:
        raise ValueError(
            f"upsample_add: no kernel for x {tuple(x.shape)} {x.dtype} on "
            f"{x.device}, factor {factor}: {why}")
    b, c, h, w = x.shape
    wt = weight.detach().reshape(c, -1).contiguous()
    out = torch.empty((b, c, out_size(h, factor), out_size(w, factor)),
                      dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    fn = nvcc.load("upsample", "upsample_add", _ARGS)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), wt.data_ptr(), skip.data_ptr(),
                 out.data_ptr(), b, h, w, c, factor, _DTYPE_CODE[x.dtype],
                 nvcc.sm_count(torch.cuda.current_device()),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"upsample_add launch failed: cudaError {err}")
    launches += 1
    return out
