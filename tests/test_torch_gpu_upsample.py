"""The IDA up-sampler's kernel (csrc/upsample.cu) on the card (marker
`gpu`).

Skipped where there is no CUDA device; on the card run
    python -m pytest --noconftest -m gpu tests/test_torch_gpu_upsample.py
(this file imports no JAX).

Tolerances: f32 (TF32 off), 1e-5 relative maximum against cuDNN's
transposed convolution plus the add (at most 4 products and the skip,
summed in another order).  bf16: each output within the largest distance
of cuDNN + add (which rounds to bf16 twice, after the convolution and
after the add) from the f32 result, plus one bf16 ulp of that result (the
kernel rounds once).  A whole DLA-34 bf16 forward, and the eval step
under bf16 autocast, with the kernel against the plain version in its
place: 2e-2 relative maximum a head, the bf16 tolerance of the DCN tests
in test_torch_gpu.py.
"""
import pytest
import torch

from centerpoly_tpu_torch.kernels import upsample
from centerpoly_tpu_torch.models import create_model

pytestmark = pytest.mark.gpu

HEADS = {"hm": 8, "poly": 32, "pseudo_depth": 1, "reg": 2}
# DLA-34's 8 up-samplers at 512x1024 input: (module, C, f, input H, W)
DLA34_UPSAMPLERS = [("dla_up.ida_0.up_1", 256, 2, 16, 32),
                    ("dla_up.ida_1.up_1", 128, 2, 32, 64),
                    ("dla_up.ida_1.up_2", 128, 2, 32, 64),
                    ("dla_up.ida_2.up_1", 64, 2, 64, 128),
                    ("dla_up.ida_2.up_2", 64, 2, 64, 128),
                    ("dla_up.ida_2.up_3", 64, 2, 64, 128),
                    ("ida_up.up_1", 64, 2, 64, 128),
                    ("ida_up.up_2", 64, 4, 32, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


def _inputs(dev, dtype, b, c, f, h, w, seed=0):
    """Seeded channels-last x, skip and a weight (C, 1, 2f, 2f) on the
    card."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, c, h, w, generator=g)
    skip = torch.randn(b, c, upsample.out_size(h, f), upsample.out_size(w, f),
                       generator=g)
    wt = torch.randn(c, 1, 2 * f, 2 * f, generator=g) / 2
    cl = torch.channels_last
    return (x.to(dev, dtype, memory_format=cl), wt.to(dev, dtype),
            skip.to(dev, dtype, memory_format=cl))


def _rel(got, ref):
    diff = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    return diff / scale if scale > 0 else (0.0 if diff == 0 else float("inf"))


def _bf16_ulp(t):
    """The spacing of bf16 values at |t| (8 significant bits)."""
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def _check(x, wt, f, skip):
    """The kernel against cuDNN's transposed convolution + skip, by the
    module docstring's tolerances; one launch."""
    before = upsample.launches
    got = upsample.upsample_add(x, wt, f, skip)
    torch.cuda.synchronize()
    assert upsample.launches == before + 1
    lib = upsample.upsample_add_ref(x, wt, f, skip)
    assert got.shape == lib.shape and got.dtype == x.dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    if x.dtype == torch.float32:
        assert _rel(got, lib) < 1e-5
        return
    ref = upsample.upsample_add_ref(x.float(), wt.float(), f, skip.float())
    lib_err = (lib.float() - ref).abs().max()
    err = (got.float() - ref).abs()
    assert bool((err <= lib_err + _bf16_ulp(ref)).all()), (
        err.max().item(), lib_err.item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [2, 3, 4])
@pytest.mark.parametrize("b", [1, 4])
def test_kernel_matches_cudnn_at_odd_sizes(cuda, dtype, f, b):
    """Odd H and W, C = 24 (3 bf16 / 6 f32 vectors), f = 3 for the odd
    padding (f // 2 = 1, an output 3 H + 1 long)."""
    x, wt, skip = _inputs(cuda, dtype, b, 24, f, 7, 9)
    _check(x, wt, f, skip)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,c,f,h,w", DLA34_UPSAMPLERS)
def test_kernel_matches_cudnn_at_dla34_shapes(cuda, dtype, name, c, f, h, w):
    x, wt, skip = _inputs(cuda, dtype, 4, c, f, h, w)
    _check(x, wt, f, skip)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_is_deterministic(cuda, dtype):
    """The same bits from run to run, at the widest and at the f = 4
    up-sampler."""
    for _, c, f, h, w in (DLA34_UPSAMPLERS[0], DLA34_UPSAMPLERS[-1]):
        x, wt, skip = _inputs(cuda, dtype, 4, c, f, h, w, seed=5)
        a = upsample.upsample_add(x, wt, f, skip)
        b = upsample.upsample_add(x, wt, f, skip)
        assert torch.equal(a, b)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    """NCHW memory, a grad-recording input and a C that is no whole number
    of bf16 vectors raise; nothing launches."""
    x, wt, skip = _inputs(cuda, torch.bfloat16, 1, 16, 2, 4, 4)
    before = upsample.launches
    with pytest.raises(ValueError, match="no kernel"):
        upsample.upsample_add(x.contiguous(), wt, 2, skip)
    with pytest.raises(ValueError, match="no kernel"):
        upsample.upsample_add(x.detach().requires_grad_(), wt, 2, skip)
    x12, wt12, skip12 = _inputs(cuda, torch.bfloat16, 1, 12, 2, 4, 4)
    with pytest.raises(ValueError, match="no kernel"):
        upsample.upsample_add(x12, wt12, 2, skip12)
    assert upsample.launches == before


def _random_model(arch, dev, dtype):
    torch.manual_seed(0)
    model = create_model(arch, HEADS, 64, dcn_kernel="rowband:6").eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "conv_offset_mask" in name:
                p.normal_(0, 0.3)
            elif ".up_" in name:    # off the bilinear init
                p.add_(0.1 * torch.randn_like(p))
    return model.to(dev, dtype, memory_format=torch.channels_last)


@pytest.mark.parametrize("arch,launches", [("dla_34", 8), ("dlav0_34", 8),
                                           ("smallhourglass", 0)])
def test_counter_in_a_no_grad_forward(cuda, arch, launches):
    """One launch an up-sampler: 8 in a DLA-34 or DLAv0 forward, none on
    smallhourglass (which has no DepthwiseUpsample)."""
    model = _random_model(arch, cuda, torch.bfloat16)
    x = torch.randn(1, 3, 128, 256, device=cuda, dtype=torch.bfloat16)
    before = upsample.launches
    with torch.no_grad():
        model(x.contiguous(memory_format=torch.channels_last))
    torch.cuda.synchronize()
    assert upsample.launches - before == launches


def test_counter_in_a_train_step(cuda, tmp_path):
    """A train step records autograd through the up-samplers: the
    transposed convolution runs, the kernel never."""
    from centerpoly_tpu_torch.losses import PolydetLossConfig
    from centerpoly_tpu_torch.train import state as tstate
    from centerpoly_tpu_torch.train.step import make_train_step, to_device
    from test_torch_gpu import DP_LOSS, DP_LR, _dp_host_batch
    batch = _dp_host_batch(str(tmp_path))
    torch.manual_seed(0)
    model = create_model("dla_34", HEADS, 16).to(
        cuda, memory_format=torch.channels_last)
    st = tstate.create_train_state(model, base_lr=DP_LR)
    step = make_train_step(PolydetLossConfig(**DP_LOSS))
    before = upsample.launches
    st, stats = step(st, to_device(batch, cuda))
    torch.cuda.synchronize()
    assert torch.isfinite(stats["loss"]).item()
    assert upsample.launches == before


def test_dla34_bf16_forward_kernel_against_two_operations(cuda, monkeypatch):
    """A whole DLA-34 bf16 forward at 256x512 with the kernel against the
    same module with the plain version in the kernel's place: every head
    within 2e-2 relative maximum."""
    model = _random_model("dla_34", cuda, torch.bfloat16)
    x = torch.randn(2, 3, 256, 512, generator=torch.Generator().manual_seed(1))
    x = x.to(cuda, torch.bfloat16, memory_format=torch.channels_last)
    before = upsample.launches
    with torch.no_grad():
        got = model(x)[-1]
        assert upsample.launches - before == 8
        monkeypatch.setattr(upsample, "upsample_add",
                            upsample.upsample_add_ref)
        ref = model(x)[-1]
    torch.cuda.synchronize()
    assert upsample.launches - before == 8
    for k in HEADS:
        assert got[k].dtype == torch.bfloat16
        assert _rel(got[k], ref[k]) < 2e-2, k


def test_eval_step_under_bf16_autocast_runs_the_kernel(cuda, tmp_path,
                                                       monkeypatch):
    """Trainer's AP validation in bf16: make_eval_step runs the f32 model
    under bf16 autocast with no grad.  The weights go to bf16 as autocast
    takes them to conv_transpose2d, and the kernel runs: 8 launches a
    forward; the head maps within 2e-2 relative maximum of the same step
    with the plain version in the kernel's place."""
    from centerpoly_tpu_torch.losses import PolydetLossConfig
    from centerpoly_tpu_torch.train import state as tstate
    from centerpoly_tpu_torch.train.step import make_eval_step, to_device
    from test_torch_gpu import DP_LOSS, DP_LR, _dp_host_batch
    batch = to_device(_dp_host_batch(str(tmp_path)), cuda)
    model = _random_model("dla_34", cuda, torch.float32)
    st = tstate.create_train_state(model, base_lr=DP_LR)
    step = make_eval_step(PolydetLossConfig(**DP_LOSS),
                          dtype=torch.bfloat16)
    before = upsample.launches
    got, stats = step(st, batch)
    torch.cuda.synchronize()
    assert upsample.launches - before == 8
    assert torch.isfinite(stats["loss"]).item()
    monkeypatch.setattr(upsample, "upsample_add", upsample.upsample_add_ref)
    ref, _ = step(st, batch)
    torch.cuda.synchronize()
    assert upsample.launches - before == 8
    for k in HEADS:
        assert _rel(got[k], ref[k]) < 2e-2, k


def test_module_raises_rather_than_fall_back(cuda):
    """On the card the module runs the plain version only where autograd
    records: NCHW memory under no grad raises, and a grad-recording call
    runs the two operations with no launch."""
    from centerpoly_tpu_torch.models.dla import DepthwiseUpsample
    up = DepthwiseUpsample(16, 2).to(cuda)
    x, _, skip = _inputs(cuda, torch.float32, 2, 16, 2, 4, 6)
    before = upsample.launches
    with torch.no_grad(), pytest.raises(ValueError, match="channels-last"):
        up(x.contiguous(), skip)
    y = up(x, skip)
    assert y.requires_grad
    assert upsample.launches == before
    with torch.no_grad():
        assert _rel(y, upsample.upsample_add_ref(x, up.weight, 2, skip)) < 1e-6
