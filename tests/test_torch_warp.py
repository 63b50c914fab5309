"""The serving input warp's wrapper (kernels/warp.py) on the CPU: the
kernel's refusals, the plain version the CPU path runs, and the detector's
`_pre_device` on it.  The kernel itself runs only on the card
(tests/test_torch_gpu_warp.py).

`_pre_device` on the CPU must return the bits of the code it replaced (a
warp of each frame, stacked, normalised, flipped under flip_test, cast),
kept here as `_replaced_pre_device`; the plain version must agree with
the JAX package's warp and normalisation at test_torch_detector.py's
tolerance for the network input (1e-4 absolute on normalised values).
"""
import types

import numpy as np
import pytest
import torch

import torch_port_common  # noqa: F401  (caps torch's threads)
import jax.numpy as jnp

from centerpoly_tpu.geometry import affine as jaff
from centerpoly_tpu_torch.configs import Config
from centerpoly_tpu_torch.geometry.affine import (get_affine_transform,
                                                  warp_axis_aligned)
from centerpoly_tpu_torch.infer.detector import BaseDetector, create_detector
from centerpoly_tpu_torch.kernels import warp

CITY = Config(task="polydet", dataset="cityscapes")
MEAN, STD = CITY.mean, CITY.std


def _frames(b, h, w, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, 256, (b, h, w, 3), dtype=np.uint8))


def _trans(h, w, out_hw, scale=1.0, shift=(0.0, 0.0)):
    """The detector's fix_res transform of an h x w frame onto out_hw,
    with the frame scaled by `scale` about its centre and moved by
    `shift` (a share of its side)."""
    c = np.array([w / 2.0, h / 2.0], np.float32)
    return get_affine_transform(c, max(h, w) * scale, 0,
                                (out_hw[1], out_hw[0]), shift=shift)


def _replaced_pre_device(cfg, flip_tta, dtype, frames_u8, trans, size):
    """BaseDetector._pre_device as it was before the kernel: a warp of
    each frame, stacked, / 255, - mean, / std, flipped, cast."""
    mean = torch.tensor(cfg.mean, dtype=torch.float32)
    std = torch.tensor(cfg.std, dtype=torch.float32)
    x = torch.stack([warp_axis_aligned(f.float(), trans, size)
                     for f in frames_u8])
    x = ((x / 255.0 - mean) / std).permute(0, 3, 1, 2)
    if cfg.flip_test and flip_tta:
        x = torch.cat([x, x.flip(3)])
    return x.to(dtype, memory_format=torch.channels_last)


# (what is wrong, the call's arguments changed from a good call, the
# reason's words)
def _misaligned():
    return torch.zeros(8 * 8 * 3 + 1, dtype=torch.uint8)[1:].view(1, 8, 8, 3)


REFUSALS = [
    ("float frames", dict(frames=lambda: _frames(1, 8, 8).float()),
     "not uint8"),
    ("4 channels", dict(frames=lambda: torch.zeros(1, 8, 8, 4,
                                                   dtype=torch.uint8)),
     "(B, H, W, 3)"),
    ("2 means", dict(mean=MEAN[:2]), "2 means"),
    ("HWC frame", dict(frames=lambda: _frames(1, 8, 8)[0]), "(B, H, W, 3)"),
    ("strided frames", dict(frames=lambda: _frames(1, 8, 16)[:, :, ::2]),
     "not contiguous"),
    ("misaligned frames", dict(frames=_misaligned), "16-byte aligned"),
    ("trans on another device", dict(trans=torch.zeros(2, 3,
                                                       device="meta")),
     "from the host"),
    ("3x3 trans", dict(trans=np.eye(3)), "not (2, 3)"),
    ("nan trans", dict(trans=np.array([[0.5, 0, np.nan], [0, 0.5, 0]])),
     "not finite"),
    ("zero scale", dict(trans=np.array([[0.0, 0, 0], [0, 0.5, 0]])),
     "zero scale"),
    ("rotation", dict(trans=get_affine_transform(
        np.array([4.0, 4.0], np.float32), 8.0, 30, (4, 4))),
     "not axis-aligned"),
    ("empty size", dict(size=(0, 4)), "output size"),
    ("float16 output", dict(dtype=torch.float16), "float32 or bfloat16"),
    ("CPU frames", dict(), "a CUDA tensor"),
]


@pytest.mark.parametrize("what,change,words", REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_refusals_are_named_and_raised(what, change, words):
    """`why_not` names each thing a call lacks (the card last), and
    `warp_normalize` raises it as a ValueError, with no launch."""
    args = dict(frames=_frames(1, 8, 8), trans=_trans(8, 8, (4, 4)),
                size=(4, 4), mean=MEAN, std=STD, dtype=torch.bfloat16)
    args.update({k: v() if callable(v) else v for k, v in change.items()})
    call = (args["frames"], args["trans"], args["size"], args["mean"],
            args["std"], args["dtype"])
    why = warp.why_not(*call)
    assert why is not None and words in why, why
    before = warp.launches
    with pytest.raises(ValueError, match="no kernel") as info:
        warp.warp_normalize(*call)
    assert words in str(info.value)
    assert warp.launches == before


def test_rounding_left_by_the_solve_is_axis_aligned():
    """get_affine_transform's solve leaves off-diagonals of ~1e-17 at
    rot 0 (ddd's 1242x375 frame, ctdet's 512x512, a scaled frame): not
    a reason."""
    for h, w, out, scale in ((375, 1242, (384, 1280), 1.0),
                             (480, 640, (512, 512), 1.0),
                             (1024, 2048, (512, 1024), 0.75)):
        why = warp.why_not(_frames(1, 8, 8), _trans(h, w, out, scale), out,
                           MEAN, STD, torch.bfloat16)
        assert why is not None and why.startswith("frames on cpu"), why


@pytest.mark.parametrize("hw,out,scale,shift", [
    ((32, 64), (16, 32), 1.0, (0.0, 0.0)),       # the serving 2:1 warp
    ((37, 51), (24, 40), 0.83, (0.07, -0.05)),   # non-integer, borders
    ((20, 30), (48, 64), 1.7, (0.0, 0.0)),       # upscale, off every edge
])
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("b", [1, 3])
def test_pre_device_on_the_cpu_is_the_replaced_code(hw, out, scale, shift,
                                                    flip, b):
    """On the CPU `_pre_device` returns the replaced code's bits, values,
    shape and channels-last strides, with and without flip_test."""
    cfg = Config(task="polydet", dataset="cityscapes", flip_test=flip)
    det = types.SimpleNamespace(cfg=cfg, flip_tta=True,
                                dtype=torch.float32)
    frames = _frames(b, *hw, seed=b)
    trans = _trans(*hw, out, scale, shift)
    got = BaseDetector._pre_device(det, frames, trans, out)
    want = _replaced_pre_device(cfg, True, torch.float32, frames, trans,
                                out)
    assert got.shape == (b * (1 + flip), 3, *out)
    assert got.stride() == want.stride()
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


def test_pre_device_without_flip_tta_keeps_one_copy():
    """A task with `flip_tta` False (exdet) is not doubled under
    flip_test, as before."""
    cfg = Config(task="polydet", dataset="cityscapes", flip_test=True)
    det = types.SimpleNamespace(cfg=cfg, flip_tta=False,
                                dtype=torch.float32)
    frames = _frames(2, 32, 64)
    trans = _trans(32, 64, (16, 32))
    got = BaseDetector._pre_device(det, frames, trans, (16, 32))
    want = _replaced_pre_device(cfg, False, torch.float32, frames, trans,
                                (16, 32))
    assert got.shape == (2, 3, 16, 32) and torch.equal(got, want)


def test_pre_device_takes_a_permuted_frame():
    """A frame with the strides of an HWC view of a CHW array gives the
    bits of the same frame laid out densely."""
    cfg = Config(task="polydet", dataset="cityscapes")
    det = types.SimpleNamespace(cfg=cfg, flip_tta=True,
                                dtype=torch.float32)
    frames = _frames(1, 32, 64, seed=4)
    permuted = frames[0].permute(2, 0, 1).contiguous().permute(1, 2, 0)[None]
    assert not permuted.is_contiguous() and torch.equal(permuted, frames)
    trans = _trans(32, 64, (16, 32))
    assert torch.equal(BaseDetector._pre_device(det, permuted, trans,
                                                (16, 32)),
                       BaseDetector._pre_device(det, frames, trans, (16, 32)))


def test_no_launch_on_the_cpu():
    """`run`, `run_batch` and `run_stream` on the CPU run the plain
    version: `launches` does not move."""
    cfg = Config(task="polydet", dataset="cityscapes", input_h=32,
                 input_w=64, head_conv=16, K=8, mixed_precision=False)
    det = create_detector(cfg, device="cpu")
    frames = [_frames(1, 64, 128, seed=s)[0].numpy() for s in (1, 2)]
    before = warp.launches
    det.run(frames[0])
    det.run_batch(frames)
    list(det.run_stream(frames))
    assert warp.launches == before == 0


@pytest.mark.parametrize("hw,out,scale,shift", [
    ((128, 256), (64, 128), 1.0, (0.0, 0.0)),
    ((50, 70), (64, 96), 1.0, (0.0, 0.0)),
    ((45, 77), (40, 56), 0.9, (0.11, -0.06)),
])
def test_plain_version_matches_jax(hw, out, scale, shift):
    """`warp_normalize_ref` against the JAX package's warp_axis_aligned and
    its detector's normalisation, frame by frame."""
    frames = _frames(2, *hw, seed=7)
    trans = _trans(*hw, out, scale, shift)
    got = warp.warp_normalize_ref(frames, trans, out, MEAN, STD,
                                  torch.float32)
    assert got.shape == (2, 3, *out) and got.dtype == torch.float32
    for f, g in zip(frames.numpy(), got):
        ref = ((jaff.warp_axis_aligned(jnp.asarray(f, jnp.float32),
                                       jnp.asarray(trans), out) / 255.0
                - jnp.asarray(MEAN)) / jnp.asarray(STD))
        np.testing.assert_allclose(g.permute(1, 2, 0).numpy(),
                                   np.asarray(ref), rtol=0, atol=1e-4)


def test_plain_version_casts_once_to_bf16():
    """In bf16 the plain version is the f32 result rounded once."""
    frames = _frames(2, 37, 51, seed=3)
    trans = _trans(37, 51, (24, 40), 0.83, (0.07, -0.05))
    f32 = warp.warp_normalize_ref(frames, trans, (24, 40), MEAN, STD,
                                  torch.float32)
    bf16 = warp.warp_normalize_ref(frames, trans, (24, 40), MEAN, STD,
                                   torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    assert bf16.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(bf16, f32.to(torch.bfloat16))
