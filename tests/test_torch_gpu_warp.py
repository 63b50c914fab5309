"""The serving input warp's kernel (csrc/warp.cu) on the card (marker
`gpu`).

Skipped where there is no CUDA device; on the card run
    python -m pytest --noconftest -m gpu tests/test_torch_gpu_warp.py
(this file imports no JAX).

The kernel is held to its plain version (kernels/warp.py::
warp_normalize_ref: two dense f32 sampling-matrix products by cuBLAS with
TF32 off, then / 255, - mean, / std) on the same frames on the card.
f32: within 1e-5 absolute on normalised values (~-7 to ~18 at the
Cityscapes constants).  Both sum the same (at most 2 x 2) non-zero
products of the same weights; cuBLAS adds them, and its zeros, in an
order the kernel does not control, and PyTorch's `/ 255.0` multiplies by
the reciprocal where the kernel divides: each is ~1 f32 ulp of a value up
to 255 before the normalisation scales it by 1 / (255 std) ~ 0.1.  bf16:
the kernel's bf16 output is its own f32 output rounded once, and equals
the plain version's bf16 output except where their f32 values differ;
there the two bf16 values lie no further apart than the f32 values plus
one bf16 ulp at the larger of them (neighbours across a rounding
boundary; near 0, where bf16 keeps f32's exponents, the f32 distance).
"""
import types

import numpy as np
import pytest
import torch

from centerpoly_tpu_torch.configs import Config
from centerpoly_tpu_torch.geometry.affine import get_affine_transform
from centerpoly_tpu_torch.infer.detector import BaseDetector, create_detector
from centerpoly_tpu_torch.infer.task_detectors import DddDetector
from centerpoly_tpu_torch.kernels import warp

pytestmark = pytest.mark.gpu

F32_TOL = 1e-5
CITY = Config(task="polydet", dataset="cityscapes")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _frames(dev, b, h, w, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, 256, (b, h, w, 3), dtype=np.uint8)).to(dev)


def _meta(cfg, h, w, cls=BaseDetector):
    """(trans, (inp_h, inp_w)) of the detector class's pre-process for an
    h x w frame at scale 1."""
    trans, meta = cls.pre_process_meta(types.SimpleNamespace(cfg=cfg), h, w,
                                       1.0)
    return trans, (meta["inp_h"], meta["inp_w"])


def _window(h, w, out, scale, shift=(0.0, 0.0)):
    c = np.array([w / 2.0, h / 2.0], np.float32)
    return get_affine_transform(c, max(h, w) * scale, 0, (out[1], out[0]),
                                shift=shift)


def _bf16_ulp(t):
    """The spacing of bf16 values at |t| (8 significant bits)."""
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def _check(frames, trans, size, cfg=CITY):
    """The kernel in f32 and bf16 against the plain version by the module
    docstring's rules; one launch a call."""
    args = (frames, trans, size, cfg.mean, cfg.std)
    before = warp.launches
    got32 = warp.warp_normalize(*args, torch.float32)
    got16 = warp.warp_normalize(*args, torch.bfloat16)
    torch.cuda.synchronize()
    assert warp.launches == before + 2
    ref32 = warp.warp_normalize_ref(*args, torch.float32)
    ref16 = warp.warp_normalize_ref(*args, torch.bfloat16)
    for got, ref in ((got32, ref32), (got16, ref16)):
        assert got.shape == ref.shape == (len(frames), 3, *size)
        assert got.dtype == ref.dtype
        assert got.is_contiguous(memory_format=torch.channels_last)
    err = (got32 - ref32).abs().max().item()
    assert err <= F32_TOL, err
    assert torch.equal(got16, got32.to(torch.bfloat16))
    differ = got16 != ref16
    assert bool((got32[differ] != ref32[differ]).all())
    d16 = (got16.float() - ref16.float()).abs()[differ]
    d32 = (got32 - ref32).abs()[differ]
    big = torch.maximum(got32.abs(), ref32.abs())[differ]
    assert bool((d16 <= d32 + _bf16_ulp(big)).all())


@pytest.mark.parametrize("b", [1, 4])
def test_serving_shape(cuda, b):
    """The benchmark's 2048x1024 frames onto the 512x1024 input (a 2:1
    warp whose second taps all weigh 0)."""
    trans, size = _meta(CITY, 1024, 2048)
    assert size == (512, 1024)
    _check(_frames(cuda, b, 1024, 2048, seed=b), trans, size)


@pytest.mark.parametrize("scale,shift", [(0.83, (0.07, -0.05)),
                                         (1.37, (-0.11, 0.04)),
                                         (0.5, (0.013, 0.021))])
def test_non_integer_scales_and_shifts(cuda, scale, shift):
    """Fractional taps on both axes, the frame larger than the window or
    not, shifted off the centre."""
    trans = _window(1024, 2048, (512, 1024), scale, shift)
    _check(_frames(cuda, 2, 1024, 2048, seed=3), trans, (512, 1024))


@pytest.mark.parametrize("hw,out", [((37, 51), (64, 96)),
                                    ((40, 60), (23, 41)),
                                    ((1, 1), (5, 7))])
def test_taps_off_every_border_and_odd_sizes(cuda, hw, out):
    """A window 1.7x the frame's larger side, so taps fall off all four
    edges; odd output widths, so a thread's 8 pixels cross row ends and
    the last group is partial; a 1x1 frame."""
    trans = _window(*hw, out, 1.7, (0.03, -0.02))
    _check(_frames(cuda, 3, *hw, seed=5), trans, out)


def test_ctdet_geometry(cuda):
    """ctdet's 512x512 input from a 640x480 frame (rows off the top and
    bottom), fix_res and keep-res (a padded 512x672 canvas)."""
    cfg = Config(task="ctdet", dataset="coco")
    _check(_frames(cuda, 2, 480, 640, seed=7), *_meta(cfg, 480, 640), cfg)
    keep = Config(task="ctdet", dataset="coco", fix_res=False)
    trans, size = _meta(keep, 480, 640)
    assert size == (512, 672)
    _check(_frames(cuda, 2, 480, 640, seed=8), trans, size, keep)


def test_ddd_geometry(cuda):
    """ddd's KITTI 1242x375 frame onto 384x1280 (a non-integer upscale,
    rows off both edges)."""
    cfg = Config(task="ddd", dataset="kitti")
    trans, size = _meta(cfg, 375, 1242, DddDetector)
    assert size == (384, 1280)
    _check(_frames(cuda, 2, 375, 1242, seed=9), trans, size, cfg)


def test_flip_test_doubles_the_kernel_output(cuda):
    """Under flip_test `_pre_device` runs one launch and appends the
    flipped copy: [x; x.flip(3)] channels-last, x the kernel's output;
    within the f32 tolerance of the CPU's `_pre_device`."""
    cfg = Config(task="polydet", dataset="cityscapes", flip_test=True)
    trans, size = _meta(cfg, 1024, 2048)
    frames = _frames(cuda, 2, 1024, 2048, seed=11)
    for dtype in (torch.float32, torch.bfloat16):
        det = types.SimpleNamespace(cfg=cfg, flip_tta=True, dtype=dtype)
        before = warp.launches
        got = BaseDetector._pre_device(det, frames, trans, size)
        torch.cuda.synchronize()
        assert warp.launches == before + 1
        x = warp.warp_normalize(frames, trans, size, cfg.mean, cfg.std, dtype)
        assert got.shape == (4, 3, *size) and got.dtype == dtype
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(got, torch.cat([x, x.flip(3)]))
    cpu = types.SimpleNamespace(cfg=cfg, flip_tta=True, dtype=torch.float32)
    ref = BaseDetector._pre_device(cpu, frames.cpu(), trans, size)
    det = types.SimpleNamespace(cfg=cfg, flip_tta=True, dtype=torch.float32)
    got = BaseDetector._pre_device(det, frames, trans, size).cpu()
    assert (got - ref).abs().max().item() <= F32_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_is_deterministic(cuda, dtype):
    frames = _frames(cuda, 4, 1024, 2048, seed=13)
    trans = _window(1024, 2048, (512, 1024), 0.83, (0.07, -0.05))
    a = warp.warp_normalize(frames, trans, (512, 1024), CITY.mean, CITY.std,
                            dtype)
    b = warp.warp_normalize(frames, trans, (512, 1024), CITY.mean, CITY.std,
                            dtype)
    assert torch.equal(a, b)


def test_one_launch_a_call(cuda):
    """One launch a `run_batch` call, a `run` frame and a `run_stream`
    frame; two traced `run_batch` calls run `warp_normalize` twice and
    none of the old warp's f32 cuBLAS GEMMs (a kernel first, as the
    trace of a process that has traced before can miss its first
    events)."""
    cfg = Config(task="polydet", dataset="cityscapes", input_h=128,
                 input_w=256, head_conv=16, K=16)
    det = create_detector(cfg)
    frames = [np.random.RandomState(s).randint(0, 256, (256, 512, 3),
                                               dtype=np.uint8)
              for s in range(4)]
    before = warp.launches
    det.run_batch(frames)
    torch.cuda.synchronize()
    assert warp.launches == before + 1
    for i, f in enumerate(frames[:2]):
        det.run(f)
        assert warp.launches == before + 2 + i
    list(det.run_stream(frames))
    assert warp.launches == before + 3 + len(frames)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device=cuda).add_(1)
        torch.cuda.synchronize()
        for _ in range(2):
            det.run_batch(frames)
        torch.cuda.synchronize()
    counts = {e.key: e.count for e in prof.key_averages()}
    assert sum(c for n, c in counts.items()
               if "warp_normalize" in n) == 2, counts
    assert not any("xmma_gemm_f32f32" in n for n in counts), counts


def test_a_permuted_frame_is_served(cuda):
    """A frame made from an HWC view of a CHW array keeps its strides on
    the card; `_pre_device` lays it out densely for the kernel, and `run`
    gives the results of the same frame made contiguous (cuDNN on its
    deterministic algorithms for both), one launch each."""
    cfg = Config(task="polydet", dataset="cityscapes", input_h=128,
                 input_w=256, head_conv=16, K=16)
    det = create_detector(cfg)
    chw = np.random.RandomState(17).randint(0, 256, (3, 256, 512),
                                            dtype=np.uint8)
    hwc = chw.transpose(1, 2, 0)
    frame = torch.from_numpy(hwc).to(cuda)[None]
    assert not frame.is_contiguous()
    trans, size = _meta(cfg, 256, 512)
    got = det._pre_device(frame, trans, size)
    want = det._pre_device(frame.contiguous(), trans, size)
    assert torch.equal(got, want)
    flags = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    before = warp.launches
    try:
        a = det.run(hwc)["results"]
        b = det.run(np.ascontiguousarray(hwc))["results"]
    finally:
        torch.backends.cudnn.deterministic = flags
    assert warp.launches == before + 2
    assert set(a) == set(b) and all(
        np.array_equal(np.asarray(a[j]), np.asarray(b[j])) for j in b)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    """Non-uint8, strided or misaligned frames, a trans on the card or
    rotated raise, in `warp_normalize` and, but for the strided frame
    (which `_pre_device` lays out densely first), in `_pre_device` on the
    card; nothing launches."""
    frames = _frames(cuda, 1, 64, 128)
    trans, size = _window(64, 128, (32, 64), 1.0), (32, 64)
    raw = torch.zeros(64 * 128 * 3 + 1, dtype=torch.uint8, device=cuda)
    bad = [(frames.float(), trans, "not uint8"),
           (_frames(cuda, 1, 64, 256)[:, :, ::2], trans, "not contiguous"),
           (raw[1:].view(1, 64, 128, 3), trans, "16-byte aligned"),
           (frames, torch.as_tensor(trans, device=cuda), "from the host"),
           (frames, get_affine_transform(np.array([64.0, 32.0], np.float32),
                                         128.0, 15, (64, 32)),
            "not axis-aligned")]
    det = types.SimpleNamespace(cfg=CITY, flip_tta=True,
                                dtype=torch.bfloat16)
    before = warp.launches
    for f, t, words in bad:
        with pytest.raises(ValueError, match=words):
            warp.warp_normalize(f, t, size, CITY.mean, CITY.std,
                                torch.bfloat16)
        if words == "not contiguous":
            continue
        with pytest.raises(ValueError, match=words):
            BaseDetector._pre_device(det, f, t, size)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        warp.warp_normalize(frames, trans, size, CITY.mean, CITY.std,
                            torch.float16)
    assert warp.launches == before
