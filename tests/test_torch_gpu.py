"""The port's CUDA kernel and slice on the card (marker `gpu`).

Skipped where there is no CUDA device; on the card run
    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
(`--noconftest`: tests/conftest.py sets up JAX, which the card's machine
does not have; this file imports no JAX).

Tolerances, as relative maxima max|got - ref| / max|ref|: 1e-4 in f32
with TF32 off (the same f32 arithmetic summed in another order); 2e-2 in
bf16, where the plain version rounds the bilinear fractions and corner
products to bf16 (deform_conv.py:122) and the kernel keeps them in f32.
The backward kernel: 1e-4 (dx, dW, dmask, db) and 1e-3 (d offsets,
differences of neighbouring samples, so their relative error is that of
the samples over the size of the difference) in f32; 3e-2 in bf16.  The
same tolerances hold in every clamp mode (exact, rowband:R, halo:R).
"""
import datetime

import numpy as np
import pytest
import torch

from centerpoly_tpu_torch.configs import Config
from centerpoly_tpu_torch.infer.detector import create_detector
from centerpoly_tpu_torch.kernels import dcn

pytestmark = pytest.mark.gpu


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


def _inputs(dev, dtype, b, h, w, c, cout, seed=0, scale=4.0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, c, generator=g)
    off = torch.randn(b, h, w, 18, generator=g) * scale
    mask = torch.sigmoid(torch.randn(b, h, w, 9, generator=g))
    wt = torch.randn(3, 3, c, cout, generator=g) / (3 * c ** 0.5)
    bias = torch.randn(cout, generator=g)
    return (x.to(dev, dtype), off.to(dev), mask.to(dev), wt.to(dev, dtype),
            bias.to(dev, dtype))


def _rel(got, ref):
    """max |got - ref| / max |ref|; 0 where both are all 0."""
    diff = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if scale > 0:
        return diff / scale
    return 0.0 if diff == 0 else float("inf")


# ragged shapes: pixel tiles, Cin chunks and Cout tiles that do not divide
@pytest.mark.parametrize("shape", [(2, 5, 7, 40, 70), (1, 16, 32, 64, 64),
                                   (1, 9, 13, 3, 5)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("r", [None, 2])
def test_kernel_matches_plain(cuda, shape, dtype, tol, r):
    args = _inputs(cuda, dtype, *shape)
    before = dcn.launches["exact" if r is None else "rowband"]
    got = dcn.deform_conv2d(*args, max_offset_y=r)
    torch.cuda.synchronize()
    assert dcn.launches["exact" if r is None else "rowband"] == before + 1
    ref = dcn.deform_conv2d_ref(*args, max_offset_y=r)
    assert got.dtype == dtype and got.shape == ref.shape
    assert _rel(got, ref) < tol


CLAMPS = {"exact": {}, "rowband": {"max_offset_y": 2},
          "halo": {"max_offset": 2}}
TOLS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the forward's tiles and K splits: the 16x32 512->256 node (split K), one
# pixel, Cout above 256 and not a multiple of 8 (two channel tiles, the
# second ragged), and a train step's batch of 4 in f32
TILE_CASES = [((1, 16, 32, 512, 256), torch.float32),
              ((1, 16, 32, 512, 256), torch.bfloat16),
              ((1, 1, 1, 64, 64), torch.float32),
              ((1, 1, 1, 64, 64), torch.bfloat16),
              ((1, 8, 8, 40, 300), torch.float32),
              ((1, 8, 8, 40, 300), torch.bfloat16),
              ((4, 64, 128, 128, 64), torch.float32)]


@pytest.mark.parametrize("shape,dtype", TILE_CASES)
@pytest.mark.parametrize("mode", sorted(CLAMPS))
def test_kernel_tiles_and_splits_match_plain(cuda, shape, dtype, mode):
    args = _inputs(cuda, dtype, *shape)
    before = dict(dcn.launches)
    got = dcn.deform_conv2d(*args, **CLAMPS[mode])
    torch.cuda.synchronize()
    after = dict(dcn.launches)
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {mode: 1}
    ref = dcn.deform_conv2d_ref(*args, **CLAMPS[mode])
    assert got.dtype == dtype and got.shape == ref.shape
    assert _rel(got, ref) < TOLS[dtype]


@pytest.mark.parametrize("shape,split", [((1, 16, 32, 512, 256), True),
                                         ((1, 128, 256, 64, 64), False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_is_deterministic(cuda, shape, split, dtype):
    """Two calls on the same inputs are bit-equal, with K split (partial
    sums reduced in a fixed order) and unsplit."""
    args = _inputs(cuda, dtype, *shape)
    b, h, w, cin, cout = shape
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert (dcn.fwd_plan(b * h * w, cin, cout, n_sm, dtype).splits > 1
            ) == split
    first = dcn.deform_conv2d(*args, max_offset=4)
    second = dcn.deform_conv2d(*args, max_offset=4)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_kernel_edges(cuda):
    """Every sample off the image gives the bias alone."""
    x, off, mask, wt, bias = _inputs(cuda, torch.float32, 1, 6, 6, 8, 8)
    for fill in (40.0, -40.0):
        got = dcn.deform_conv2d(x, torch.full_like(off, fill), mask, wt, bias)
        torch.testing.assert_close(got, bias.expand_as(got), rtol=0, atol=0)


def test_wrapper_rejects(cuda):
    x, off, mask, wt, bias = _inputs(cuda, torch.float32, 1, 4, 4, 8, 8)
    with pytest.raises(TypeError):
        dcn.deform_conv2d(x, off.bfloat16(), mask, wt, bias)
    with pytest.raises(TypeError):
        dcn.deform_conv2d(x.half(), off, mask, wt.half(), bias.half())
    with pytest.raises(ValueError):
        dcn.deform_conv2d(x.transpose(1, 2), off, mask, wt, bias)
    with pytest.raises(ValueError):
        dcn.deform_conv2d(x, off.cpu(), mask, wt, bias)
    with pytest.raises(ValueError):
        dcn.deform_conv2d(x, off[..., :9].contiguous(), mask, wt, bias)


BWD_NAMES = ("dx", "doffsets", "dmasks", "dweights", "dbias")


def _bwd_rel(got, ref):
    return {n: _rel(a, b) for n, a, b in zip(BWD_NAMES, got, ref)}


@pytest.mark.parametrize("shape", [(2, 5, 7, 40, 70), (1, 16, 32, 64, 64),
                                   (1, 9, 13, 3, 5)])
@pytest.mark.parametrize("dtype,tol,tol_off", [(torch.float32, 1e-4, 1e-3),
                                               (torch.bfloat16, 3e-2, 3e-2)])
@pytest.mark.parametrize("r", [None, 2])
def test_backward_kernel_matches_plain(cuda, shape, dtype, tol, tol_off, r):
    args = _inputs(cuda, dtype, *shape)
    g = torch.randn(*shape[:3], shape[4], generator=torch.Generator()
                    .manual_seed(1)).to(cuda, dtype)
    key = "bwd_exact" if r is None else "bwd_rowband"
    before = dcn.launches[key]
    got = dcn.deform_conv2d_backward(*args, g, max_offset_y=r)
    torch.cuda.synchronize()
    assert dcn.launches[key] == before + 1
    ref = dcn.deform_conv2d_backward_ref(*args, g, max_offset_y=r)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
    rel = _bwd_rel(got, ref)
    assert rel["doffsets"] < tol_off, rel
    assert max(v for k, v in rel.items() if k != "doffsets") < tol, rel


@pytest.mark.parametrize("case", ["zero", "at_r", "beyond_r"])
def test_backward_kernel_tie_rules(cuda, case):
    """All offsets 0 (the offset convs' init: every sample at an integer
    position), y-offsets exactly at +-R (gradient 0.5), beyond R (0)."""
    x, off, mask, wt, bias = _inputs(cuda, torch.float32, 2, 6, 9, 16, 8)
    off = {"zero": torch.zeros_like(off),
           "at_r": torch.where(off > 0, 2.0, -2.0),
           "beyond_r": off * 3}[case]
    g = torch.randn(2, 6, 9, 8, generator=torch.Generator()
                    .manual_seed(2)).to(cuda)
    for r in (None, 2):
        got = dcn.deform_conv2d_backward(x, off, mask, wt, bias, g, r)
        ref = dcn.deform_conv2d_backward_ref(x, off, mask, wt, bias, g, r)
        rel = _bwd_rel(got, ref)
        assert max(rel.values()) < 1e-3, (r, rel)


def test_dcnv2_on_card_carries_autograd(cuda):
    """A CUDA DCNv2 output has a grad_fn; backward() launches the backward
    kernel and reaches the weights and the offset conv."""
    from centerpoly_tpu_torch.models.deform_conv import DCNv2
    layer = DCNv2(16, 8, dcn_kernel="rowband:2").to(cuda)
    x = torch.randn(2, 16, 6, 9, device=cuda, requires_grad=True)
    out = layer(x)
    assert out.grad_fn is not None
    before = dict(dcn.launches)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert dcn.launches["bwd_rowband"] == before["bwd_rowband"] + 1
    assert dcn.launches["bwd_exact"] == before["bwd_exact"]
    for p in (layer.weight, layer.bias, layer.conv_offset_mask.weight,
              layer.conv_offset_mask.bias, x):
        assert p.grad is not None and bool(torch.isfinite(p.grad).all())
    assert float(layer.weight.grad.abs().max()) > 0
    assert float(layer.conv_offset_mask.weight.grad.abs().max()) > 0


@pytest.mark.parametrize("mode,key", [("rowband:6", "rowband"),
                                      ("off", "exact")])
def test_detector_on_card(cuda, mode, key):
    cfg = Config(input_h=64, input_w=128, head_conv=32, K=16,
                 dcn_kernel=mode)
    det = create_detector(cfg)
    assert det.device.type == "cuda" and det.dtype == torch.bfloat16
    frame = np.random.RandomState(0).randint(0, 256, (128, 256, 3), np.uint8)
    before = dcn.launches[key]
    ret = det.run(frame)
    assert dcn.launches[key] == before + 16
    rows = np.concatenate([np.asarray(v) for v in ret["results"].values()])
    assert rows.shape == (16, 38) and np.isfinite(rows).all()


@pytest.mark.parametrize("shape", [(2, 5, 7, 40, 70), (1, 9, 13, 3, 5)])
@pytest.mark.parametrize("dtype,tol_fwd,tol,tol_off", [
    (torch.float32, 1e-4, 1e-4, 1e-3), (torch.bfloat16, 2e-2, 3e-2, 3e-2)])
def test_halo_kernels_match_plain(cuda, shape, dtype, tol_fwd, tol, tol_off):
    """dcn_fwd and dcn_bwd in the xy clamp mode (halo:2; offsets of std 4
    px, most beyond R) against their plain versions; each launch counts
    once under its own key."""
    args = _inputs(cuda, dtype, *shape)
    g = torch.randn(*shape[:3], shape[4], generator=torch.Generator()
                    .manual_seed(1)).to(cuda, dtype)
    before = dict(dcn.launches)
    got = dcn.deform_conv2d(*args, max_offset=2)
    torch.cuda.synchronize()
    assert _rel(got, dcn.deform_conv2d_ref(*args, max_offset=2)) < tol_fwd
    grads = dcn.deform_conv2d_backward(*args, g, max_offset=2)
    torch.cuda.synchronize()
    after = dict(dcn.launches)
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == {"halo": 1, "bwd_halo": 1}
    rel = _bwd_rel(grads, dcn.deform_conv2d_backward_ref(*args, g,
                                                         max_offset=2))
    assert rel["doffsets"] < tol_off, rel
    assert max(v for k, v in rel.items() if k != "doffsets") < tol, rel


@pytest.mark.parametrize("case", ["zero", "y_at_r", "x_at_r", "beyond_r"])
def test_halo_backward_tie_rule(cuda, case):
    """Offsets all 0, exactly at +-R on one axis, or beyond R: the kernel
    matches the plain backward, and every saturated offset gradient is
    exactly 0."""
    x, off, mask, wt, bias = _inputs(cuda, torch.float32, 2, 6, 9, 16, 8)
    at_r = torch.where(off > 0, 2.0, -2.0)
    off = {"zero": torch.zeros_like(off),
           "y_at_r": torch.stack([at_r[..., 0::2], off[..., 1::2]], -1)
           .reshape(off.shape),
           "x_at_r": torch.stack([off[..., 0::2], at_r[..., 1::2]], -1)
           .reshape(off.shape),
           "beyond_r": off * 3}[case].contiguous()
    g = torch.randn(2, 6, 9, 8, generator=torch.Generator()
                    .manual_seed(2)).to(cuda)
    got = dcn.deform_conv2d_backward(x, off, mask, wt, bias, g, max_offset=2)
    ref = dcn.deform_conv2d_backward_ref(x, off, mask, wt, bias, g,
                                         max_offset=2)
    assert max(_bwd_rel(got, ref).values()) < 1e-3
    saturated = off.abs() >= 2
    assert bool((got[1][saturated] == 0).all())


# the backward's tiles and splits: one pixel, Cout above 256 and not a
# multiple of 8 (two dW channel tiles and two g slabs, the second ragged),
# Cin 3 / Cout 5 (one ragged chunk and tile), and a train step's batch of 4
# in f32 (dW split over 4 pixel ranges)
BWD_TILE_CASES = [((1, 1, 1, 64, 64), torch.float32),
                  ((1, 1, 1, 64, 64), torch.bfloat16),
                  ((1, 8, 8, 40, 300), torch.float32),
                  ((1, 8, 8, 40, 300), torch.bfloat16),
                  ((2, 9, 13, 3, 5), torch.float32),
                  ((2, 9, 13, 3, 5), torch.bfloat16),
                  ((4, 64, 128, 128, 64), torch.float32)]
BWD_TOLS = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (3e-2, 3e-2)}


@pytest.mark.parametrize("shape,dtype", BWD_TILE_CASES)
@pytest.mark.parametrize("mode", sorted(CLAMPS))
def test_backward_tiles_and_splits_match_plain(cuda, shape, dtype, mode):
    # offsets of std 0.5 px on one pixel, so some corners land on it
    args = _inputs(cuda, dtype, *shape,
                   scale=0.5 if shape[1:3] == (1, 1) else 4.0)
    g = torch.randn(*shape[:3], shape[4], generator=torch.Generator()
                    .manual_seed(3)).to(cuda, dtype)
    before = dict(dcn.launches)
    got = dcn.deform_conv2d_backward(*args, g, **CLAMPS[mode])
    torch.cuda.synchronize()
    after = dict(dcn.launches)
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {f"bwd_{mode}": 1}
    ref = dcn.deform_conv2d_backward_ref(*args, g, **CLAMPS[mode])
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
    tol, tol_off = BWD_TOLS[dtype]
    rel = _bwd_rel(got, ref)
    assert rel["doffsets"] < tol_off, rel
    assert max(v for k, v in rel.items() if k != "doffsets") < tol, rel


@pytest.mark.parametrize("shape", [(4, 16, 32, 512, 256),
                                   (4, 64, 128, 128, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_is_deterministic(cuda, shape, dtype):
    """Two calls give bit-equal d offsets, d masks, dW and db (dW split
    over pixel ranges and reduced in a fixed order; d offsets and d masks
    split over tap ranges, each summed by one block); only dx is summed by
    atomics."""
    args = _inputs(cuda, dtype, *shape)
    g = torch.randn(*shape[:3], shape[4], generator=torch.Generator()
                    .manual_seed(4)).to(cuda, dtype)
    b, h, w, cin, cout = shape
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = dcn.bwd_plan(b * h * w, cin, cout, n_sm)
    assert plan.splits > 1 or plan.data_splits > 1
    first = dcn.deform_conv2d_backward(*args, g, max_offset=4)
    second = dcn.deform_conv2d_backward(*args, g, max_offset=4)
    torch.cuda.synchronize()
    for name, a, b in zip(BWD_NAMES, first, second):
        if name != "dx":
            assert torch.equal(a, b), name


def test_backward_allocates_no_sample_buffer(cuda):
    """The backward of the 128x256 64->64 node at batch 4 (f32) raises the
    peak device memory over its inputs by less than its outputs plus one
    (npix, 9 Cin) f32 buffer (302 MB): gk and the samples stay on chip."""
    args = _inputs(cuda, torch.float32, 4, 128, 256, 64, 64)
    g = torch.randn(4, 128, 256, 64, generator=torch.Generator()
                    .manual_seed(5)).to(cuda)
    dcn.deform_conv2d_backward(*args, g)      # build, load, first launch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    grads = dcn.deform_conv2d_backward(*args, g)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(cuda) - base
    outputs = sum(t.numel() * t.element_size() for t in grads)
    assert extra - outputs < 4 * 128 * 256 * 9 * 64 * 4, (extra, outputs)


def test_dcnv2_halo_on_card_carries_autograd(cuda):
    from centerpoly_tpu_torch.models.deform_conv import DCNv2
    layer = DCNv2(16, 8, dcn_kernel="halo:2").to(cuda)
    with torch.no_grad():
        layer.conv_offset_mask.weight.normal_(0, 0.5)
    x = torch.randn(2, 16, 6, 9, device=cuda, requires_grad=True)
    before = dict(dcn.launches)
    out = layer(x)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert dcn.launches["halo"] == before["halo"] + 1
    assert dcn.launches["bwd_halo"] == before["bwd_halo"] + 1
    for p in (layer.weight, layer.bias, layer.conv_offset_mask.weight,
              layer.conv_offset_mask.bias, x):
        assert p.grad is not None and bool(torch.isfinite(p.grad).all())
    assert float(layer.conv_offset_mask.weight.grad.abs().max()) > 0


def test_halo_model_forward_on_card(cuda):
    """A halo:6 DLA-34 forward launches the halo kernel once a node."""
    from centerpoly_tpu_torch.models import create_model
    heads = {"hm": 8, "poly": 32, "pseudo_depth": 1, "reg": 2}
    model = create_model("dla_34", heads, 32, dcn_kernel="halo:6").eval()
    model.to(cuda, memory_format=torch.channels_last)
    x = torch.randn(1, 3, 64, 128, device=cuda).to(
        memory_format=torch.channels_last)
    before = dict(dcn.launches)
    with torch.no_grad():
        out = model(x)[-1]
    torch.cuda.synchronize()
    after = dict(dcn.launches)
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == {"halo": 16}
    assert all(bool(torch.isfinite(v).all()) for v in out.values())


def test_f32_model_on_card_matches_cpu(cuda):
    from centerpoly_tpu_torch.models import create_model
    heads = {"hm": 8, "poly": 32, "pseudo_depth": 1, "reg": 2}
    torch.manual_seed(0)
    model = create_model("dla_34", heads, 32, dcn_kernel="rowband:6").eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "conv_offset_mask" in name:
                p.normal_(0, 0.3)
    x = torch.randn(1, 3, 64, 128)
    with torch.no_grad():
        ref = model(x)[-1]
        model.to(cuda, memory_format=torch.channels_last)
        got = model(x.to(cuda, memory_format=torch.channels_last))[-1]
    for k in heads:
        assert _rel(got[k].cpu(), ref[k]) < 2e-3, k


def test_smallhourglass_f32_on_card_matches_cpu(cuda):
    """smallhourglass at full width, f32 (TF32 off): every head on the card
    within 2e-3 relative max of the port on the CPU, and no DCN launch."""
    from centerpoly_tpu_torch.models import create_model
    heads = {"hm": 8, "poly": 32, "pseudo_depth": 1, "reg": 2}
    torch.manual_seed(0)
    model = create_model("smallhourglass", heads, 256).eval()
    x = torch.randn(1, 3, 128, 256)
    before = dict(dcn.launches)
    with torch.no_grad():
        ref = model(x)[-1]
        model.to(cuda, memory_format=torch.channels_last)
        got = model(x.to(cuda, memory_format=torch.channels_last))[-1]
    torch.cuda.synchronize()
    assert dcn.launches == before
    for k in heads:
        assert _rel(got[k].cpu(), ref[k]) < 2e-3, k


@pytest.mark.parametrize("arch", ["resdcn_18", "res_18", "dlav0_34"])
def test_resnet_and_dlav0_on_card_match_cpu(cuda, arch):
    """chip_smoke.py phases 15 and 16 in small: the model at 128x256, f32
    (TF32 off), rowband:6, heads on the card within 2e-3 relative max of
    the port on the CPU; resdcn_18 launches `dcn_fwd` once a DCN node (3),
    the others never."""
    from centerpoly_tpu_torch.models import create_model
    heads = {"hm": 8, "poly": 32, "pseudo_depth": 1, "reg": 2}
    torch.manual_seed(0)
    model = create_model(arch, heads, 64, dcn_kernel="rowband:6").eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "conv_offset_mask" in name:
                p.normal_(0, 0.3)
    x = torch.randn(1, 3, 128, 256)
    before = dict(dcn.launches)
    with torch.no_grad():
        ref = model(x)[-1]
        model.to(cuda, memory_format=torch.channels_last)
        got = model(x.to(cuda, memory_format=torch.channels_last))[-1]
    torch.cuda.synchronize()
    nodes = 3 if arch.startswith("resdcn") else 0
    assert dcn.launches["rowband"] == before["rowband"] + nodes
    assert sum(dcn.launches.values()) == sum(before.values()) + nodes
    for k in heads:
        assert _rel(got[k].cpu(), ref[k]) < 2e-3, k


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("dtype,tol,tol_off", [(torch.float32, 1e-4, 1e-3),
                                               (torch.bfloat16, 3e-2, 3e-2)])
@pytest.mark.parametrize("mode", sorted(CLAMPS))
def test_kernels_at_the_resdcn101_node(cuda, batch, dtype, tol, tol_off,
                                       mode):
    """Both kernels at resdcn_101's first node, (16, 32, 2048, 256): 4x the
    input width of any DLA-34 node, so 4x the forward's K chunks and the
    backward's K tiles; against the plain versions with this file's
    tolerances (the forward's bf16 one is 2e-2)."""
    args = _inputs(cuda, dtype, batch, 16, 32, 2048, 256)
    kw = CLAMPS[mode]
    got = dcn.deform_conv2d(*args, **kw)
    ref = dcn.deform_conv2d_ref(*args, **kw)
    torch.cuda.synchronize()
    assert _rel(got, ref) < TOLS[dtype]
    g = torch.randn(batch, 16, 32, 256, generator=torch.Generator()
                    .manual_seed(1)).to(cuda, dtype)
    rel = _bwd_rel(dcn.deform_conv2d_backward(*args, g, **kw),
                   dcn.deform_conv2d_backward_ref(*args, g, **kw))
    assert rel["doffsets"] < tol_off, rel
    assert max(v for k, v in rel.items() if k != "doffsets") < tol, rel


@pytest.mark.parametrize("dtype,tol,tol_off", [(torch.float32, 1e-4, 1e-3),
                                               (torch.bfloat16, 3e-2, 3e-2)])
@pytest.mark.parametrize("mode", sorted(CLAMPS))
def test_kernels_at_a_kitti_node(cuda, dtype, tol, tol_off, mode):
    """Both kernels at DLA-34's stride-32 node of a 384x1280 KITTI input,
    (12, 40, 512, 256), batch 2: a 12-row map, whose 960 pixels leave the
    last 64-pixel tile ragged, against the plain versions with this file's
    tolerances (the forward's bf16 one is 2e-2)."""
    args = _inputs(cuda, dtype, 2, 12, 40, 512, 256)
    kw = CLAMPS[mode]
    got = dcn.deform_conv2d(*args, **kw)
    ref = dcn.deform_conv2d_ref(*args, **kw)
    torch.cuda.synchronize()
    assert _rel(got, ref) < TOLS[dtype]
    g = torch.randn(2, 12, 40, 256, generator=torch.Generator()
                    .manual_seed(1)).to(cuda, dtype)
    rel = _bwd_rel(dcn.deform_conv2d_backward(*args, g, **kw),
                   dcn.deform_conv2d_backward_ref(*args, g, **kw))
    assert rel["doffsets"] < tol_off, rel
    assert max(v for k, v in rel.items() if k != "doffsets") < tol, rel


def test_ctdet_run_on_card_matches_cpu(cuda):
    """chip_smoke.py phase 20 in small: the ctdet detector (80 classes,
    DLA-34, head_conv 64, 128x128 input, f32, TF32 off, rowband:6) on a
    160x120 frame: 16 `dcn_fwd` launches a frame, every head on the card
    within 2e-3 relative max of the CPU's, K finite box rows."""
    cfg = Config(task="ctdet", dataset="coco", input_h=128, input_w=128,
                 head_conv=64, K=32, mixed_precision=False)
    assert cfg.prefer_fast_inference_dcn()
    det_cpu = create_detector(cfg, device="cpu")
    sd = det_cpu.model.state_dict()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, v in sd.items():
            if "conv_offset_mask" in name:
                v.normal_(0, 0.3, generator=gen)
    det = create_detector(cfg, sd)
    det_cpu = create_detector(cfg, sd, device="cpu")
    frame = np.random.RandomState(0).randint(0, 256, (120, 160, 3),
                                             dtype=np.uint8)
    before = dict(dcn.launches)
    ret = det.run(frame)
    torch.cuda.synchronize()
    assert dcn.launches["rowband"] == before["rowband"] + 16
    rows = np.concatenate([np.asarray(v) for v in ret["results"].values()])
    assert rows.shape == (32, 5) and np.isfinite(rows).all()
    trans, meta = det_cpu._scaled_trans(120, 160, 1.0)
    with torch.no_grad():
        x = det_cpu._pre_device(torch.from_numpy(frame)[None], trans,
                                (meta["inp_h"], meta["inp_w"]))
        ref = det_cpu._heads(x)
        got = det._heads(x.to(cuda, memory_format=torch.channels_last))
    assert set(got) == {"hm", "wh", "reg"}
    for k in ref:
        assert _rel(got[k].cpu(), ref[k]) < 2e-3, k


@pytest.mark.parametrize("task,dataset", [("exdet", "coco"),
                                          ("multi_pose", "coco_hp"),
                                          ("ddd", "kitti")])
def test_task_heads_and_launches_on_card(cuda, tmp_path, task, dataset):
    """chip_smoke.py phases 21, 22 and 23 in small: the exdet, multi_pose
    and ddd detectors (DLA-34, head_conv 64, 128x128 input, f32, TF32 off,
    rowband:6) on a 160x120 frame: 16 `dcn_fwd` launches a frame (also
    under flip_test: exdet and ddd a batch of 1, multi_pose a doubled batch),
    every head on the card within 2e-3 relative max of the CPU's; then
    one train step of `main` at batch 2 (`off`): 16 exact forward and 16
    backward launches."""
    from centerpoly_tpu_torch import main as tmain
    from centerpoly_tpu_torch.data.fixture import (write_box_fixture,
                                                   write_keypoint_fixture,
                                                   write_kitti3d_fixture)
    cfg = Config(task=task, dataset=dataset, input_h=128, input_w=128,
                 head_conv=64, K=32, mixed_precision=False)
    assert cfg.prefer_fast_inference_dcn()
    det_cpu = create_detector(cfg, device="cpu")
    sd = det_cpu.model.state_dict()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, v in sd.items():
            if "conv_offset_mask" in name:
                v.normal_(0, 0.3, generator=gen)
    det_cpu = create_detector(cfg, sd, device="cpu")
    frame = np.random.RandomState(0).randint(0, 256, (120, 160, 3),
                                             dtype=np.uint8)
    for flip in (False, True):
        cfg.flip_test = flip
        det = create_detector(cfg, sd)
        batches = []
        det.model.register_forward_pre_hook(
            lambda mod, args: batches.append(args[0].shape[0]))
        before = dict(dcn.launches)
        ret = det.run(frame)
        torch.cuda.synchronize()
        assert dcn.launches["rowband"] == before["rowband"] + 16
        assert batches == [2 if flip and task == "multi_pose" else 1]
        for rows in ret["results"].values():
            assert np.isfinite(rows).all()
    trans, meta = det_cpu._scaled_trans(120, 160, 1.0)
    with torch.no_grad():
        x = det_cpu._pre_device(torch.from_numpy(frame)[None], trans,
                                (meta["inp_h"], meta["inp_w"]))
        ref = det_cpu._heads(x)
        got = det._heads(x.to(cuda, memory_format=torch.channels_last))
    assert set(got) == set(cfg.heads)
    for k in ref:
        assert _rel(got[k].cpu(), ref[k]) < 2e-3, k
    root = str(tmp_path)
    if task == "exdet":
        write_box_fixture(root, {"train": 2}, 0, 120, 160, categories=(1,))
    elif task == "ddd":
        write_kitti3d_fixture(root, {"train": 2}, 0)
    else:
        write_keypoint_fixture(root, {"train": 2}, 0, 120, 160)
    before = dict(dcn.launches)
    tr = tmain.main([task, "--dataset", dataset, "--data_dir", root,
                     "--save_dir", root + "/exp", "--input_h", "128",
                     "--input_w", "128", "--head_conv", "64", "--batch_size",
                     "2", "--num_workers", "0", "--num_epochs", "1",
                     "--dcn_kernel", "off"], device="cuda")
    torch.cuda.synchronize()
    assert tr.state.step == 1
    assert dcn.launches["exact"] - before["exact"] == 16
    assert dcn.launches["bwd_exact"] - before["bwd_exact"] == 16


@pytest.mark.parametrize("eval_batch", [1, 2])
def test_eval_cli_on_card(cuda, tmp_path, monkeypatch, eval_batch):
    """`python -m centerpoly_tpu_torch.test` on the card (bf16, the
    rowband:6 default) over a 4-frame PNG fixture: 16 rowband launches a
    forward, and an AP from the evaluator."""
    from centerpoly_tpu_torch import test as ttest
    from centerpoly_tpu_torch.data.datasets import CityscapesMeta
    from centerpoly_tpu_torch.data.fixture import write_rect_fixture
    monkeypatch.setattr(CityscapesMeta, "eval_image_size", (128, 256))
    root = write_rect_fixture(str(tmp_path), 4, 0, 128, 256,
                              splits=("val",), png=True)
    before = dict(dcn.launches)
    out = ttest.main(["polydet", "--data_dir", root, "--save_dir",
                      str(tmp_path / "exp"), "--input_h", "64", "--input_w",
                      "128", "--head_conv", "32", "--K", "16",
                      "--eval_batch", str(eval_batch)])
    torch.cuda.synchronize()
    assert dcn.launches["rowband"] == before["rowband"] + 16 * 4 // eval_batch
    assert out["frames"] == 4 and out["ap"] is not None
    assert np.isfinite(out["ap"]["allAp"])


@pytest.mark.parametrize("batch,stream", [(1, False), (2, False), (1, True)],
                         ids=["per_frame", "batched", "pipelined"])
def test_video_loops_on_card(cuda, batch, stream):
    """The demo's video loops on the card (bf16, rowband:6) over an
    in-memory capture: 16 rowband launches a forward, frames in order,
    the per-frame and pipelined loops equal to `run`."""
    from centerpoly_tpu_torch.infer import demo
    cfg = Config(input_h=64, input_w=128, head_conv=32, K=16)
    assert cfg.prefer_fast_inference_dcn()      # the CLIs' rowband:6
    det = create_detector(cfg)
    rng = np.random.RandomState(0)
    frames = [rng.randint(0, 256, (128, 256, 3), dtype=np.uint8)
              for _ in range(4)]
    flags = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = [det.run(f)["results"] for f in frames]
        before = dcn.launches["rowband"]
        got = list(demo.video_results(det, demo.MemoryCapture(frames), batch,
                                      stream))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = flags
    assert dcn.launches["rowband"] == before + 16 * 4 // batch
    assert all(np.array_equal(img, f) for (img, _), f in zip(got, frames))
    for (_, ret), want in zip(got, runs):
        for j in want:
            if batch == 1:
                np.testing.assert_array_equal(ret["results"][j], want[j])
            else:
                assert ret["results"][j].shape == want[j].shape


def test_image_demo_and_csv_on_card(cuda, tmp_path):
    """`read_image` frames (PNG, .npy) through the image demo with
    --save_overlay --debug 4 and through run_on_csv on the card."""
    from centerpoly_tpu_torch.infer import demo, run_on_csv
    from centerpoly_tpu_torch.utils.png import read_frame, read_image, \
        write_frame
    frame = np.random.RandomState(1).randint(0, 256, (128, 256, 3),
                                             dtype=np.uint8)
    png, npy = str(tmp_path / "f.png"), str(tmp_path / "f.npy")
    write_frame(png, frame)
    np.save(npy, frame)
    assert np.array_equal(read_image(png), frame)
    assert np.array_equal(read_image(npy), frame)
    args = ["polydet", "--input_h", "64", "--input_w", "128", "--head_conv",
            "32", "--K", "16"]
    before = dcn.launches["rowband"]
    demo.main(args + ["--demo", png, "--save_overlay", "--debug", "4",
                      "--debug_dir", str(tmp_path / "dbg")])
    assert dcn.launches["rowband"] == before + 16
    assert read_frame(str(tmp_path / "f_polydet.png")).shape == frame.shape
    assert read_frame(str(tmp_path / "dbg" / "detections.png")).shape == \
        frame.shape
    src = tmp_path / "in.csv"
    src.write_text(f"{png}\n{npy}\n")
    run_on_csv.main(args + ["--source_csv", str(src), "--target_csv",
                            str(tmp_path / "out.csv"), "--eval_batch", "2"])
    rows = (tmp_path / "out.csv").read_text().splitlines()
    assert len(rows) == 2 * 16 and {r.split(",")[0] for r in rows} == {png,
                                                                     npy}


# -- data parallelism on the card ---------------------------------------------

DP_LR = 2e-4
DP_LOSS = dict(rep="polar", poly_loss="l1+iou", poly_order=True)


def _dp_host_batch(root):
    """A global batch of 4 at 64x128 from the rectangle fixture."""
    from centerpoly_tpu_torch.data import (CityscapesMeta, CocoPolyAnnotations,
                                           Loader, PolydetSampler)
    from centerpoly_tpu_torch.data.fixture import write_rect_fixture
    write_rect_fixture(root, 4, 0, 128, 256)
    cfg = Config(input_h=64, input_w=128, head_conv=16, **DP_LOSS)
    meta = CityscapesMeta(root)
    sampler = PolydetSampler(cfg, meta, CocoPolyAnnotations(
        meta.annot_path("train")), img_dir=meta.img_dir("train"))
    batch = next(iter(Loader(sampler, 4, 4, shuffle=False)))
    return {k: v for k, v in batch.items() if k != "meta"}


def _dp_step(sd, batch, group=None, perturb=False):
    """One f32 step of the narrow DLA-34 on the card from `sd` (`perturb`:
    every weight moved by a seeded relative 1e-6 first): (loss,
    parameters, BatchNorm statistics, launches, gradients) on the host."""
    from centerpoly_tpu_torch.losses import PolydetLossConfig
    from centerpoly_tpu_torch.models import create_model
    from centerpoly_tpu_torch.train import state as tstate
    from centerpoly_tpu_torch.train.step import make_train_step, to_device
    model = create_model("dla_34", {"hm": 8, "poly": 32, "pseudo_depth": 1,
                                    "reg": 2}, 16)
    model.load_state_dict(sd)
    if perturb:
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + 1e-6 * torch.randn(p.shape, generator=gen))
    model.to("cuda:0", memory_format=torch.channels_last)
    st = tstate.create_train_state(model, base_lr=DP_LR)
    step = make_train_step(PolydetLossConfig(**DP_LOSS), group=group)
    before = dict(dcn.launches)
    st, stats = step(st, to_device(batch, "cuda:0"))
    torch.cuda.synchronize()
    return (float(stats["loss"]),
            {n: p.detach().cpu() for n, p in model.named_parameters()},
            {n: b.cpu() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))},
            {k: dcn.launches[k] - before[k] for k in before},
            {n: p.grad.cpu().double() for n, p in model.named_parameters()
             if p.grad is not None})


def _dp_rank(rank, port, sd, batch, out):
    """A rank of the two-ranks-on-one-card gloo group."""
    import torch.distributed as dist
    from centerpoly_tpu_torch.train.mesh import shard_batch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    try:
        torch.save(_dp_step(sd, shard_batch(batch, rank, 2),
                            dist.group.WORLD), f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def _grad_errors(got, ref, floor_ref):
    """Per gradient: (relative L2 distance of `got` to `ref`, the floor:
    that of `floor_ref`, the step after a 1e-6 weight change); tensors
    whose exact gradient is 0 (DCN biases before train-mode BatchNorm,
    norm under 1e-6 of the largest) left out."""
    assert got.keys() == ref.keys() == floor_ref.keys()
    top = max(g.norm().item() for g in ref.values())
    out = {}
    for n, r in ref.items():
        norm = r.norm().item()
        if norm >= 1e-6 * top:
            out[n] = ((got[n] - r).norm().item() / norm,
                      (floor_ref[n] - r).norm().item() / norm)
    return out


def test_two_ranks_on_one_card_match_one_process(cuda, tmp_path):
    """The global-batch data-parallel step in two gloo ranks that share the
    card, one sample pair each, against the one-process batch-4 step on
    the card (TF32 off): loss rtol 1e-4; every gradient within 4x the
    one-process step's own move under a 1e-6 weight change (+1e-3) in
    relative L2 (a random net in train mode is ill-conditioned,
    tests/test_torch_train.py); BatchNorm statistics within 1e-3 relative
    max; gradients and statistics equal on both ranks; parameters after
    Adam within 2 lr + 1e-6 (Adam's first step moves a weight by ~lr
    sign(g) whatever the gradient: a sanity check only); 16 + 16 DCN
    launches on each rank."""
    from centerpoly_tpu_torch.models import create_model
    from centerpoly_tpu_torch.train import mesh
    batch = _dp_host_batch(str(tmp_path))
    torch.manual_seed(0)
    sd = create_model("dla_34", {"hm": 8, "poly": 32, "pseudo_depth": 1,
                                 "reg": 2}, 16).state_dict()
    loss, params, bufs, _, grads = _dp_step(sd, batch)
    moved = _dp_step(sd, batch, perturb=True)[4]
    out, port = str(tmp_path / "rank"), mesh.free_port()
    torch.multiprocessing.spawn(_dp_rank, args=(port, sd, batch, out),
                                nprocs=2)
    ranks = [torch.load(f"{out}.{r}") for r in range(2)]
    for r_loss, r_params, r_bufs, launches, r_grads in ranks:
        assert launches["exact"] == 16 and launches["bwd_exact"] == 16
        assert abs(r_loss - loss) <= 1e-4 * abs(loss)
        errs = _grad_errors(r_grads, grads, moved)
        assert sum("conv_offset_mask" in n for n in errs) == 32
        for n, (err, floor) in errs.items():
            assert err <= 4 * floor + 1e-3, (n, err, floor)
        for n, g in r_grads.items():
            assert torch.equal(g, ranks[0][4][n]), n
        for n, p in params.items():
            assert (r_params[n] - p).abs().max().item() <= 2 * DP_LR + 1e-6, n
        for n, b in bufs.items():
            assert _rel(r_bufs[n], b) <= 1e-3, n
            assert torch.equal(r_bufs[n], ranks[0][2][n]), n


def _top_rows(results, n):
    """The n highest-scoring detection rows of a frame, with their class."""
    rows = [(j, np.asarray(r, np.float64)) for j, v in results.items()
            for r in v]
    return sorted(rows, key=lambda t: -t[1][4])[:n]


def test_run_batch_over_two_replicas_on_one_card(cuda):
    """run_batch of 3 frames (bf16, rowband:6) over [cuda:0, cuda:0], the
    last frame padded once: 16 rowband launches a replica, and each
    frame's 8 best rows of one-device run_batch found in the same class,
    score within 1e-3, box and vertices within 1 px (a replica's batch of
    2 may run other convolution algorithms than one batch of 3)."""
    cfg = Config(input_h=64, input_w=128, head_conv=32, K=16,
                 dcn_kernel="rowband:6")
    torch.manual_seed(0)
    one = create_detector(cfg)
    two = create_detector(cfg, one.model.state_dict(),
                          devices=["cuda:0", "cuda:0"])
    frames = [np.random.RandomState(s).randint(0, 256, (128, 256, 3),
                                               np.uint8) for s in range(3)]
    ref = one.run_batch(frames)
    before = dcn.launches["rowband"]
    got = two.run_batch(frames)
    assert dcn.launches["rowband"] == before + 32
    assert len(got) == 3
    for g, r in zip(got, ref):
        cand = _top_rows(g["results"], 16)
        for j, row in _top_rows(r["results"], 8):
            assert any(cj == j and abs(c[4] - row[4]) <= 1e-3
                       and np.abs(np.delete(c - row, [4, len(row) - 1])
                                  ).max() <= 1.0 for cj, c in cand), row


@pytest.mark.parametrize("rep", ["cartesian", "polar", "polar_fixed"])
def test_experimental_device_losses_on_card(cuda, rep):
    """`disk_loss_device` and `area_poly_loss_device` at 64x96 on the card
    against the port on the CPU: losses within 1e-5 relative, the
    gradients of pred within 1e-5 of their largest (the same elementwise
    ops, summed in another order)."""
    from centerpoly_tpu_torch.losses import experimental as ex
    g = torch.Generator().manual_seed(3)
    b, k, n, h, w = 2, 6, 8, 64, 96
    if rep == "cartesian":
        rows = torch.rand(b, k, 2 * n, generator=g) * 40 - 20
    else:
        rows = torch.zeros(b, k, 2 * n)
        rows[..., 0::2] = torch.rand(b, k, n, generator=g) * 18 + 4
        rows[..., 1::2] = torch.sort(torch.rand(b, k, n, generator=g)
                                     * 6.28, -1)[0]
    radius = torch.rand(b, k, 1, generator=g) * 8 - 4
    pred = torch.cat([torch.rand(b, k, 2 * n, generator=g) * 40 - 20,
                      radius], -1)
    target = torch.cat([rows, radius], -1)
    mask = (torch.rand(b, k, generator=g) > 0.3).float()
    centers = torch.rand(b, k, 2, generator=g) * 50 + 20
    gt_mask = (torch.rand(b, h, w, generator=g) > 0.6).float()

    def run(dev):
        p = pred.to(dev).requires_grad_(True)
        q = rows.to(dev).requires_grad_(True)
        d = ex.disk_loss_device(p, mask.to(dev), target.to(dev), h, w, rep)
        a = ex.area_poly_loss_device(q, mask.to(dev), gt_mask.to(dev),
                                     centers.to(dev), rep)
        (d + a).backward()
        return d.item(), a.item(), p.grad.cpu(), q.grad.cpu()

    got, ref = run(cuda), run("cpu")
    for x, y in zip(got[:2], ref[:2]):
        assert abs(x - y) <= 1e-5 * abs(y)
    for x, y in zip(got[2:], ref[2:]):
        assert _rel(x, y) <= 1e-5 and y.abs().max() > 0


def test_run_times_its_stages_without_a_fence(cuda, monkeypatch):
    """`run` waits for the card only in its D2H copy: no
    torch.cuda.synchronize between its stages, and `pre` and `net` are
    the card's time between CUDA events at their boundaries."""
    det = create_detector(Config(input_h=256, input_w=512, head_conv=64,
                                 K=32))
    frame = np.random.RandomState(0).randint(0, 256, (512, 1024, 3),
                                             np.uint8)
    det.run(frame)
    calls = []
    real = torch.cuda.synchronize

    def counted(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    ret = det.run(frame)
    assert calls == []
    assert ret["pre"] > 0 and ret["net"] > 0
    assert ret["tot"] >= ret["load"] + ret["dec"] + ret["post"] + ret["merge"]


def test_a_device_only_profile_counts_no_span(cuda, monkeypatch):
    """The benchmark's device-only trace of `run_batch` (the window of its
    serving runs) holds no `cp.*` range among its kernels, and its busy
    time is that of the same calls with the spans patched out, within 2 %
    (the end-to-end bound), median of three profiles each, in turns."""
    import contextlib
    import statistics
    from benchmark.harness import trace
    from centerpoly_tpu_torch.utils import timers
    det = create_detector(Config(input_h=512, input_w=1024, head_conv=64,
                                 K=128))
    rng = np.random.RandomState(0)
    frames = [rng.randint(0, 256, (1024, 2048, 3), np.uint8)
              for _ in range(4)]

    def calls():
        for _ in range(8):
            det.run_batch(frames)

    calls()
    real = timers.record_function
    busy = {True: [], False: []}
    for on in (True, False, False, True, True, False):
        monkeypatch.setattr(timers, "record_function", real if on else
                            (lambda name, args=None: contextlib.nullcontext()))
        tr = trace.profile(calls, with_host=False)
        assert not [n for n, _, _ in tr.kernels if n.startswith("cp.")]
        busy[on].append(tr.busy_s)
    with_spans, without = (statistics.median(busy[k]) for k in (True, False))
    assert abs(with_spans - without) <= 0.02 * without, busy


def test_resdcn101_run_batch_on_card(cuda):
    """resdcn_101 served as the benchmark's resdcn101.serve-batch4 cell
    serves it (`create_detector(cfg).run_batch` of 4 seeded
    2048x1024 frames, bf16 rowband:6, the cell's seeded weights): 3
    `dcn.launches` a call, no up-sampler launch, and the served rows
    within the cell's limits of the plain f32 reference."""
    from benchmark.harness import cells
    from centerpoly_tpu_torch.kernels import upsample
    cell = cells.load("resdcn101.serve-batch4")
    drv = cells.driver("serve_batch")(cell, 3000000101, cuda)
    drv.warm_up()
    d0, u0 = sum(dcn.launches.values()), upsample.launches
    drv.call(drv._next())
    torch.cuda.synchronize()
    assert sum(dcn.launches.values()) - d0 == 3
    assert upsample.launches == u0
    assert drv.window(1.0)["failed"] == 0
    drv.release()
    numbers = drv.check()
    for name, limit in cell["limits"].items():
        assert numbers[name] <= limit, (name, numbers)
