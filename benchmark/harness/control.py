"""The controls of `correct`: the plain reference in the program's place,
in the precision just below the configuration's.  Serving (bf16, where
the program keeps every weight and activation in bf16): a detector whose
weights, and every activation that a convolution, transposed
convolution, DCN node or BatchNorm takes or gives, are rounded to fp8
(e4m3, one scale a tensor), with the products in f32; the decode and
post-process are the reference's.  Training (f32 with TF32 off): the
program with its TF32 path switched on (PyTorch's switches, readings.py),
and, where no card runs TF32 (the CPU tests), the reference with the
operands of every convolution and transposed convolution rounded to
TF32's 10-bit mantissa, forward and backward (`emulate_tf32`)."""
from __future__ import annotations

import types

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..reference import detect, nets
from ..reference.dcn import DCNv2
from . import cells


def fp8(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8_e4m3fn under one scale (its largest
    magnitude at 448), back in its own dtype."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class Fp8Detector:
    """`run_batch(frames)` of the reference at fp8 products: per frame
    {"results": {class id: rows}}, as the task serves them."""

    def __init__(self, conf: dict, state_dict: dict, device):
        self.conf = conf
        self.device = torch.device(device)
        net = nets.build(conf, conf["serve"]["dcn_kernel"])
        net.load_state_dict(state_dict)
        net.to(self.device).eval()
        for m in net.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, DCNv2,
                              nn.BatchNorm2d)):
                with torch.no_grad():
                    m.weight.copy_(fp8(m.weight))
                m.register_forward_pre_hook(
                    lambda mod, args: (fp8(args[0]),) + tuple(args[1:]))
                m.register_forward_hook(lambda mod, args, out: fp8(out))
        self.net = net
        self.trans, self.to_frame = detect.frame_geometry(
            conf["frame_h"], conf["frame_w"], conf["input_h"],
            conf["input_w"], conf["down_ratio"])

    @torch.no_grad()
    def run_batch(self, images):
        conf = self.conf
        u8 = torch.from_numpy(np.stack(images)).to(self.device)
        heads = self.net(detect.preprocess(u8, self.trans, conf["input_h"],
                                           conf["input_w"], conf["mean"],
                                           conf["std"]))[-1]
        return cells.task(conf["task"]).served_results(heads, self.to_frame,
                                                       conf)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 `t` rounded to the nearest value with a 10-bit mantissa."""
    if t.dtype != torch.float32:
        return t
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _Round(torch.autograd.Function):
    """TF32 rounding forward, the gradient passed as it is."""

    @staticmethod
    def forward(ctx, x):
        return tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    """The identity forward, TF32 rounding of the gradient backward."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return tf32(g)


def _conv(self, x):
    return _RoundGrad.apply(self._conv_forward(
        _Round.apply(x), _Round.apply(self.weight), self.bias))


def _deconv(self, x):
    return _RoundGrad.apply(F.conv_transpose2d(
        _Round.apply(x), _Round.apply(self.weight), self.bias, self.stride,
        self.padding, self.output_padding, self.groups, self.dilation))


def emulate_tf32(net: nn.Module):
    """Run every convolution and transposed convolution of `net` (what
    cuDNN computes in TF32 when it may) with its input and weight rounded
    to TF32, and the gradient of its output rounded too; the DCN nodes
    stay f32, as the port's kernels compute them either way."""
    for m in net.modules():
        if isinstance(m, nn.ConvTranspose2d):
            m.forward = types.MethodType(_deconv, m)
        elif isinstance(m, nn.Conv2d):
            m.forward = types.MethodType(_conv, m)
