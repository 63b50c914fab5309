"""The IDA up-sampler on the CPU: DepthwiseUpsample's fused forward and
IDAUp's call of it against today's two operations (the transposed
convolution, then the add), the tap rule csrc/upsample.cu computes, and
the rule that decides where the kernel runs (kernels/upsample.py).  The
kernel itself runs only on the card: tests/test_torch_gpu_upsample.py.

On the CPU the module runs the same PyTorch operations as before, in the
same order, so every comparison here is bit-for-bit."""
import copy

import numpy as np
import pytest
import torch
from torch import nn

from torch_port_common import threads

from centerpoly_tpu_torch.kernels import upsample
from centerpoly_tpu_torch.models import create_model
from centerpoly_tpu_torch.models.dla import DepthwiseUpsample, IDAUp


def _nhwc(t):
    return t.contiguous(memory_format=torch.channels_last)


def _pair(c, f, h, w, b=2, dtype=torch.float32, seed=0):
    """Seeded x (B, C, H, W) and skip of the up-sampled shape, both
    channels-last."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, c, h, w, generator=g)
    skip = torch.randn(b, c, upsample.out_size(h, f),
                       upsample.out_size(w, f), generator=g)
    return _nhwc(x.to(dtype)), _nhwc(skip.to(dtype))


def _up(c, f, seed=0):
    """A DepthwiseUpsample with seeded weights (not the bilinear init, so
    every tap carries its own value)."""
    up = DepthwiseUpsample(c, f)
    with torch.no_grad():
        up.weight.copy_(torch.randn(up.weight.shape,
                                    generator=torch.Generator().manual_seed(
                                        seed + 1)))
    return up


def _taps(x, w, f, skip):
    """The kernel's sum in numpy: each output reads input iy0 = (oy + p) // f
    at kernel row (oy + p) % f and iy0 - 1 at that row + f (the same in x),
    taps outside the input left out, then the skip added."""
    b, c, h, wd = x.shape
    p = f // 2
    out = skip.astype(np.float64).copy()
    for oy in range(out.shape[2]):
        iy0, ky0 = divmod(oy + p, f)
        for ox in range(out.shape[3]):
            ix0, kx0 = divmod(ox + p, f)
            for ty in (0, 1):
                for tx in (0, 1):
                    iy, ix = iy0 - ty, ix0 - tx
                    if 0 <= iy < h and 0 <= ix < wd:
                        out[:, :, oy, ox] += (
                            x[:, :, iy, ix]
                            * w[:, 0, ky0 + ty * f, kx0 + tx * f])
    return out


@pytest.mark.parametrize("f", [1, 2, 3, 4])
@pytest.mark.parametrize("h,w", [(3, 5), (4, 4)])
def test_tap_rule_is_the_transposed_convolution(f, h, w):
    """Two taps an axis, at the kernel rows the kernel reads, give
    F.conv_transpose2d(stride f, padding f // 2, groups C) + skip, at odd
    and even sizes and odd factors (whose padding is not f / 2)."""
    x, skip = _pair(4, f, h, w)
    wt = torch.randn(4, 1, 2 * f, 2 * f,
                     generator=torch.Generator().manual_seed(3))
    ref = upsample.upsample_add_ref(x.double(), wt.double(), f,
                                    skip.double())
    assert ref.shape == skip.shape
    got = _taps(x.double().numpy(), wt.double().numpy(), f,
                skip.double().numpy())
    np.testing.assert_allclose(got, ref.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("grad", [False, True])
def test_forward_with_skip_is_the_two_operations(f, grad):
    """DepthwiseUpsample(x, skip) is nn.ConvTranspose2d's forward plus the
    skip, bit for bit, with autograd recording and without; so are the
    gradients."""
    up = _up(8, f)
    x, skip = _pair(8, f, 5, 7)
    ref_up = copy.deepcopy(up)
    xr, sr = x.clone(), skip.clone()
    for t in (x, skip, xr, sr):
        t.requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        got = up(x, skip)
        ref = nn.ConvTranspose2d.forward(ref_up, xr) + sr
    assert torch.equal(got, ref)
    assert got.requires_grad == grad
    if grad:
        r = torch.randn(ref.shape, generator=torch.Generator().manual_seed(9))
        (got * r).sum().backward()
        (ref * r).sum().backward()
        for a, b in ((x.grad, xr.grad), (skip.grad, sr.grad),
                     (up.weight.grad, ref_up.weight.grad)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("f", [2, 4])
def test_forward_without_skip_is_the_transposed_convolution(f):
    up = _up(8, f)
    x, _ = _pair(8, f, 5, 7)
    with torch.no_grad():
        assert torch.equal(up(x), nn.ConvTranspose2d.forward(up, x))


def _two_op_forward(ida, layers):
    """IDAUp.forward as it was: up-sample, then add the previous layer."""
    out = [layers[0]]
    for i in range(1, ida.n):
        x = nn.ConvTranspose2d.forward(getattr(ida, f"up_{i}"),
                                       getattr(ida, f"proj_{i}")(layers[i]))
        out.append(getattr(ida, f"node_{i}")(x + out[i - 1]))
    return out


@pytest.mark.parametrize("plain", [True, False])
def test_idaup_output_and_gradients_unchanged(plain):
    """IDAUp with the skip handed to the up-sampler: the same outputs and
    the same gradients (parameters and inputs) as the two-operation form,
    bit for bit, on DCN and on plain (dlav0) nodes.  On one thread: the
    CPU DCN backward's scatter-add sums in another order on several, so
    its last bits change from run to run."""
    with threads(1):
        _idaup_against_two_ops(plain)


def _idaup_against_two_ops(plain):
    torch.manual_seed(0)
    ida = IDAUp(8, [8, 16, 16], [1, 2, 4], plain=plain).eval()
    ref_ida = copy.deepcopy(ida)
    g = torch.Generator().manual_seed(1)
    shapes = [(2, 8, 16, 16), (2, 16, 8, 8), (2, 16, 4, 4)]
    layers = [_nhwc(torch.randn(s, generator=g)).requires_grad_()
              for s in shapes]
    ref_layers = [t.detach().clone().requires_grad_() for t in layers]
    got = ida(layers)
    ref = _two_op_forward(ref_ida, ref_layers)
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    r = torch.randn(got[-1].shape, generator=g)
    (got[-1] * r).sum().backward()
    (ref[-1] * r).sum().backward()
    for a, b in zip(layers, ref_layers):
        assert torch.equal(a.grad, b.grad)
    for (name, p), q in zip(ida.named_parameters(), ref_ida.parameters()):
        assert (p.grad is None) == (q.grad is None), name
        if p.grad is not None:
            assert torch.equal(p.grad, q.grad), name


@pytest.mark.parametrize("dtype,c", [(torch.float32, 4), (torch.float32, 8),
                                     (torch.bfloat16, 8),
                                     (torch.bfloat16, 64)])
def test_rule_takes_what_the_kernel_computes_but_not_on_the_cpu(dtype, c):
    """An eligible call on CPU tensors: the only thing it lacks is the
    card (the kernel is CUDA's), and `upsample_add` raises rather than
    run anything else."""
    up = _up(c, 2).to(dtype)
    x, skip = _pair(c, 2, 3, 5, dtype=dtype)
    with torch.no_grad():
        assert "CUDA tensors" in upsample.why_not(x, up.weight, 2, skip)
        with pytest.raises(ValueError, match="no kernel.*CUDA tensors"):
            upsample.upsample_add(x, up.weight, 2, skip)


def _case(name):
    """(x, weight, skip) of a call the rule declines for reason `name`,
    under no_grad unless the reason is autograd."""
    c, dtype = 16, torch.bfloat16
    if name in ("channels_bf16", "channels_f32"):
        c = 12 if name == "channels_bf16" else 6
        dtype = torch.bfloat16 if name == "channels_bf16" else torch.float32
    x, skip = _pair(c, 2, 3, 5, dtype=dtype)
    w = _up(c, 2).weight.detach().to(dtype)
    if name == "grad_x":
        x.requires_grad_()
    elif name == "grad_weight":
        w.requires_grad_()
    elif name == "nchw_x":
        x = x.contiguous()
    elif name == "nchw_skip":
        skip = skip.contiguous()
    elif name == "dtype":
        skip = skip.float()
    elif name == "skip_shape":
        skip = skip[:, :, :-1]
    elif name == "f16":
        x, w, skip = x.half(), w.half(), skip.half()
    elif name == "smem":
        x, skip = _pair(1024, 4, 2, 2, b=1, dtype=dtype)
        w = torch.zeros(1024, 1, 8, 8, dtype=dtype)
    elif name == "unaligned":
        # channels-last contiguous, one element past a 16-byte boundary
        flat = torch.zeros(x.numel() + 1, dtype=dtype)[1:]
        x = flat.view(2, 3, 5, c).permute(0, 3, 1, 2)
    return x, w, skip


# the reason's words in `why_not`'s answer
DECLINED = {"grad_x": "autograd", "grad_weight": "autograd",
            "nchw_x": "x not channels-last",
            "nchw_skip": "skip not channels-last",
            "channels_bf16": "16-byte vectors",
            "channels_f32": "16-byte vectors", "dtype": "types",
            "skip_shape": "skip (", "f16": "types",
            "unaligned": "x not 16-byte aligned",
            "smem": "bytes in f32 over"}


@pytest.mark.parametrize("name", list(DECLINED))
def test_rule_declines(name):
    """Grad-recording inputs or weights, NCHW-contiguous x or skip, C not
    a whole number of 16-byte vectors (8 bf16, 4 f32), mixed or other
    types, a skip of another shape, a misaligned x and a weight larger
    than the kernel's shared memory (1024 channels at f = 4: 256 KB in
    f32): `why_not` names the reason, and `upsample_add` raises with it
    (on the card the module runs the two operations only where autograd
    records)."""
    x, w, skip = _case(name)
    f = 4 if name == "smem" else 2
    with torch.set_grad_enabled(name.startswith("grad")):
        assert DECLINED[name] in upsample.why_not(x, w, f, skip)
        with pytest.raises(ValueError, match="no kernel"):
            upsample.upsample_add(x, w, f, skip)


def test_rule_takes_grad_free_tensors_with_grad_enabled():
    """Autograd enabled but nothing that requires grad: nothing to record,
    so the call lacks only the card."""
    x, skip = _pair(8, 2, 3, 5)
    w = _up(8, 2).weight.detach()
    assert torch.is_grad_enabled()
    assert not upsample.records(x, w, skip)
    assert "CUDA tensors" in upsample.why_not(x, w, 2, skip)


def test_cpu_autocast_forward_is_the_two_operations():
    """Under the CPU's bf16 autocast, with f32 weights, the module runs
    the transposed convolution (cast by autocast) and the add, bit for
    bit as before; no kernel launches."""
    up = _up(8, 2)
    x, skip = _pair(8, 2, 5, 7, dtype=torch.bfloat16)
    before = upsample.launches
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = up(x, skip)
        ref = nn.ConvTranspose2d.forward(up, x) + skip
    assert got.dtype == ref.dtype and torch.equal(got, ref)
    assert upsample.launches == before


@pytest.mark.parametrize("arch", ["dla_34", "dlav0_34"])
def test_cpu_forward_launches_no_kernel(arch):
    """A no-grad DLA forward on the CPU runs the two operations: the
    counter stays where it was."""
    torch.manual_seed(0)
    model = create_model(arch, {"hm": 2, "wh": 2}, 8).eval()
    model = model.to(memory_format=torch.channels_last)
    before = upsample.launches
    with torch.no_grad():
        out = model(_nhwc(torch.randn(1, 3, 64, 64)))[-1]
    assert out["hm"].shape == (1, 2, 16, 16)
    assert upsample.launches == before


def test_out_size_is_conv_transpose2d():
    for f in (1, 2, 3, 4):
        for n in (1, 2, 5, 16):
            y = torch.nn.functional.conv_transpose2d(
                torch.zeros(1, 1, n, n), torch.zeros(1, 1, 2 * f, 2 * f),
                stride=f, padding=f // 2)
            assert y.shape[-1] == upsample.out_size(n, f), (f, n)
