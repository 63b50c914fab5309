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
