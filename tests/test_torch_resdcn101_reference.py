"""The benchmark's plain ResNet-101-DCN (benchmark/reference/resnet.py,
`--arch resdcn_101`) against the port's `ResNetDet`, on the CPU.

One seeded state dict (benchmark/harness/weights.py, the benchmark's
own draw) loads strictly into both.  Heads are compared relative to each
head's largest value: 1e-4, as the port's f32 tests hold f32 results
(the same f32 arithmetic summed in another order); the reference run in
bf16 parts from f32 by ~1e-2, so the bound also fails a network computed
one precision below the configuration's f32 reference."""
import numpy as np
import pytest
import torch

import torch_port_common  # noqa: F401  (torch's threads capped)
from benchmark import roofline
from benchmark.harness import cells, weights
from benchmark.reference import nets
from centerpoly_tpu_torch.models import create_model

CELL = "resdcn101.serve-batch4"
TOL = 1e-4
# offset convolutions at gain 2, and the later nodes' scaled up (their
# inputs are ~20x smaller at this random init): y-offsets up to ~10 px at
# each of the three nodes at 64x128, past the rowband:6 band at some
# taps, so the two modes differ
OFFSET_GAIN = 2.0
OFFSET_SCALE = {"deconv_layers.6": 20.0, "deconv_layers.12": 30.0}


def _conf():
    return cells.load(CELL)["config"]


def _state_dict(conf, seed=5):
    with torch.device("meta"):
        shapes = weights.shapes_of(nets.build(conf))
    sd = weights.make(shapes, seed, conf["weights"]["conv_gain"],
                      OFFSET_GAIN, "cpu")
    sd.update(weights.counters(shapes, "cpu"))
    for node, scale in OFFSET_SCALE.items():
        for part in ("weight", "bias"):
            sd[f"{node}.conv_offset_mask.{part}"] *= scale
    return sd


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


@pytest.fixture(scope="module")
def nets_and_input():
    conf = _conf()
    sd = _state_dict(conf)
    x = torch.randn(2, 3, 64, 128, generator=torch.Generator().manual_seed(3))
    return conf, sd, x


@pytest.mark.parametrize("mode", ["off", "rowband:6"])
def test_port_matches_the_plain_reference(nets_and_input, mode):
    conf, sd, x = nets_and_input
    ref = nets.build(conf, mode).eval()
    port = create_model(conf["arch"], conf["heads"], conf["head_conv"],
                        dcn_kernel=mode).eval()
    ref.load_state_dict(sd)
    port.load_state_dict(sd, strict=True)
    offsets = []
    hooks = [ref.deconv_layers[i].conv_offset_mask.register_forward_hook(
        lambda m, inp, o: offsets.append(o[:, 0:18:2].abs().max().item()))
        for i in (0, 6, 12)]
    with torch.no_grad():
        want = ref(x)[-1]
        got = port(x)[-1]
        ref16 = nets.build(conf, mode).eval()
        ref16.load_state_dict(sd)
        low = ref16.to(torch.bfloat16)(x.bfloat16())[-1]
    for h in hooks:
        h.remove()
    assert min(offsets) > 6.0        # the clamp has taps at every node
    assert set(got) == set(want) == set(conf["heads"])
    for name in want:
        assert got[name].shape == want[name].shape
        assert _rel(got[name], want[name]) < TOL, name
    # one precision below f32 fails the bound on some head
    assert max(_rel(low[n], want[n]) for n in want) > 10 * TOL


def test_modes_differ_where_offsets_pass_the_band(nets_and_input):
    """rowband:6 clamps the y-offsets: with offsets past 6 px the heads
    move, so the test above compares each mode on its own."""
    conf, sd, x = nets_and_input
    out = {}
    for mode in ("off", "rowband:6"):
        net = nets.build(conf, mode).eval()
        net.load_state_dict(sd)
        with torch.no_grad():
            out[mode] = net(x)[-1]["hm"]
    assert _rel(out["rowband:6"], out["off"]) > 10 * TOL


def test_state_dicts_have_the_same_keys_and_shapes():
    conf = _conf()
    with torch.device("meta"):
        ref = nets.build(conf).state_dict()
        port = create_model(conf["arch"], conf["heads"],
                            conf["head_conv"]).state_dict()
    assert list(ref) == list(port)
    assert {k: tuple(v.shape) for k, v in ref.items()} == {
        k: tuple(v.shape) for k, v in port.items()}
    params = sum(v.numel() for k, v in ref.items()
                 if v.is_floating_point() and "running" not in k)
    assert abs(params / 1e6 - 49.71) < 0.01


def test_published_widths():
    """ResNet-101's 3 / 4 / 23 / 3 bottlenecks, up stages 256 / 128 / 64,
    heads 64 wide, and nothing listed as cut."""
    conf = _conf()
    assert conf["reduced"] == [] and conf["head_conv"] == 64
    with torch.device("meta"):
        net = nets.build(conf)
    assert [len(getattr(net, f"layer{i}")) for i in range(1, 5)] == [
        3, 4, 23, 3]
    assert [m.weight.shape[0] for m in net.deconv_layers
            if isinstance(m, torch.nn.ConvTranspose2d)] == [256, 128, 64]
    assert net.hm[0].out_channels == 64


def test_forward_operations_of_a_512x1024_frame():
    c = roofline.forward_flops(_conf(), 512, 1024)
    for part, gflop in (("conv", 174.1), ("deconv", 3.22), ("dcn", 7.25)):
        assert c[part] / 1e9 == pytest.approx(gflop, rel=1e-3), part
    assert sum(c.values()) / 1e9 == pytest.approx(184.6, rel=1e-3)
    assert np.isclose(c["dcn"], 2.0 * 9 * (16 * 32 * 2048 * 256
                                           + 32 * 64 * 256 * 128
                                           + 64 * 128 * 128 * 64))
