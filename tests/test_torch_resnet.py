"""The ResNet family (res_18, res_101, resdcn_18, resdcn_101) and DLAv0 of
the PyTorch port against the JAX package: model, weights and tools.

One set of random JAX variables drives both sides (carried into the port
by weights.state_dict_from_jax).  Heads 8/32/1/2 wide at head_conv 16, f32
on the CPU, eval mode: every head within 2e-3 relative maximum of JAX's
(of its own largest value), the tolerance of tests/test_torch_dla.py (the two frameworks sum the
convolutions in different orders).  The 18-layer nets and DLAv0 run at
64x128, the 101-layer ones at 32x64; the resdcn offset convs at gain 0.3
(offsets of about a pixel on maps of 2x4 to 8x16, so most samples stay
inside the map).  The train step and the detector are in
tests/test_torch_resnet_train.py.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import jax_variables, port_model, rel_max

from centerpoly_tpu.configs import Config as JaxConfig
from centerpoly_tpu.tools import analyze_dcn_offsets as jtool
from centerpoly_tpu.train.checkpoint import flatten_params
from centerpoly_tpu.train.torch_import import (import_state_dict,
                                               name_map_for_arch)
from centerpoly_tpu_torch import weights
from centerpoly_tpu_torch.configs import Config
from centerpoly_tpu_torch.models import create_model
from centerpoly_tpu_torch.models.deform_conv import DCNv2
from centerpoly_tpu_torch.tools import analyze_dcn_offsets as tool

HEADS = {"hm": 8, "poly": 32, "pseudo_depth": 1, "reg": 2}
HEAD_CONV = 16
# arch -> input (h, w)
SHAPES = {"res_18": (64, 128), "resdcn_18": (64, 128), "dlav0_34": (64, 128),
          "res_101": (32, 64), "resdcn_101": (32, 64)}
ARCHS = list(SHAPES)


@pytest.fixture(scope="module")
def jax_side():
    """arch -> (flax model, random variables), made once."""
    return {arch: jax_variables(arch, HEADS, HEAD_CONV, *hw, seed=1,
                                offset_gain=0.3)
            for arch, hw in SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_heads_match_jax(jax_side, arch):
    model, variables = jax_side[arch]
    h, w = SHAPES[arch]
    x = np.random.RandomState(0).randn(1, h, w, 3).astype(np.float32)
    ref = jax.jit(lambda v, a: model.apply(v, a, train=False))(
        variables, jnp.asarray(x))[-1]
    port = port_model(variables, HEADS, HEAD_CONV, arch=arch)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))[-1]
    assert set(got) == set(HEADS)
    for head, r in ref.items():
        g = got[head].permute(0, 2, 3, 1).numpy()
        assert g.shape == r.shape == (1, h // 4, w // 4, HEADS[head])
        # relative to the head's own largest value, where rel_max takes
        # max(1, it): resdcn's heads come out ~0.05 from random weights
        scale = float(np.abs(r).max())
        assert scale > 0 and rel_max(g, r) < 2e-3, (arch, head)
        assert float(np.abs(g - r).max()) < 2e-3 * scale, (arch, head)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_dict_round_trips_through_jax_import(jax_side, arch):
    """state_dict_from_jax inverts the JAX package's name map of the
    arch: importing its output back reproduces every JAX leaf bit for
    bit.  dlav0_34: the JAX package maps it with dla_name_map, which
    knows the IDAUp projections and nodes only as DCN blocks, so it skips
    their ConvBN keys (`proj_i.{0,1}`, `node_i.{0,1}`) and leaves those
    leaves as they were; every other leaf comes back."""
    _, variables = jax_side[arch]
    sd = {k: v.numpy() for k, v in weights.state_dict_from_jax(
        variables, arch).items()}
    zeros = jax.tree.map(np.zeros_like, variables)
    back, report = import_state_dict(sd, zeros, arch)
    want = flatten_params(variables["params"])
    want.update(flatten_params(variables["batch_stats"]))
    got = flatten_params(back["params"])
    got.update(flatten_params(back["batch_stats"]))
    assert set(got) == set(want)
    plain = {k for k in sd if arch == "dlav0_34" and ".proj_" in k
             or arch == "dlav0_34" and ".node_" in k}
    assert sorted(report["skipped"]) == sorted(plain)
    assert len(report["loaded"]) == len(sd) - len(plain)
    for k in want:
        if arch == "dlav0_34" and ("/proj_" in k or "/node_" in k):
            assert not got[k].any(), k
            continue
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_keys_are_reference_keys(jax_side, arch):
    """The carried state_dict has exactly the port model's keys
    (BatchNorm's counter aside), and JAX's name map of the arch accepts
    each of them (dlav0's ConvBN nodes aside, see above)."""
    _, variables = jax_side[arch]
    sd = weights.state_dict_from_jax(variables, arch)
    own = create_model(arch, HEADS, HEAD_CONV).state_dict()
    assert set(sd) == {k for k in own if not k.endswith("num_batches_tracked")}
    name_map = name_map_for_arch(arch)
    rejected = sorted(k for k in sd if name_map(k) is None)
    if arch == "dlav0_34":
        assert rejected and all(".proj_" in k or ".node_" in k
                                for k in rejected)
    else:
        assert rejected == []


@pytest.mark.parametrize("arch,dcn_nodes,names", [
    ("res_18", 0, ["conv1.weight", "layer4.1.bn2.running_var",
                   "layer2.0.downsample.0.weight", "deconv_layers.7.weight"]),
    ("res_101", 0, ["layer3.22.conv3.weight", "layer1.0.downsample.1.bias",
                    "deconv_layers.6.weight"]),
    ("resdcn_18", 3, ["deconv_layers.0.conv_offset_mask.weight",
                      "deconv_layers.15.weight", "deconv_layers.16.bias"]),
    ("resdcn_101", 3, ["deconv_layers.12.bias", "deconv_layers.13.weight"]),
    ("dlav0_34", 0, ["dla_up.ida_0.proj_1.0.weight", "ida_up.node_2.1.bias",
                     "dla_up.ida_2.up_3.weight"]),
])
def test_model_structure(arch, dcn_nodes, names):
    """The reference's names; resdcn's 3 DCNv2 nodes (widths 256, 128, 64),
    none in res_* and dlav0; res_* default to head_conv 64 (Config)."""
    model = create_model(arch, HEADS, HEAD_CONV)
    sd = model.state_dict()
    assert all(n in sd for n in names), [n for n in names if n not in sd]
    nodes = [m for m in model.modules() if isinstance(m, DCNv2)]
    assert len(nodes) == dcn_nodes
    if dcn_nodes:
        assert [m.weight.shape[0] for m in nodes] == [256, 128, 64]
    assert torch.all(model.hm[2].bias == -2.19)
    assert torch.all(model.poly[2].bias == 0)
    assert Config(arch=arch).head_conv == (256 if "dla" in arch else 64)


def test_resnet_init_follows_jax():
    """A seeded init means the same in both packages: lecun-normal kernels
    (std 1/sqrt(fan_in)), zero biases, DCN offset convs at zero."""
    torch.manual_seed(0)
    model = create_model("resdcn_18", HEADS, 64)
    w = model.layer3[0].conv2.weight
    assert abs(w.std().item() * (9 * 256) ** 0.5 - 1) < 0.05
    up = model.deconv_layers[3].weight            # (Cin, Cout, 4, 4)
    assert abs(up.std().item() * (16 * 256) ** 0.5 - 1) < 0.05
    assert not model.hm[0].bias.any()
    assert not model.deconv_layers[0].conv_offset_mask.weight.any()


@pytest.mark.parametrize("arch", ["res_18", "resdcn_18", "dlav0_34"])
def test_load_reference_checkpoint(tmp_path, arch):
    """A reference .pth with DataParallel prefixes loads as it is."""
    model = create_model(arch, HEADS, HEAD_CONV)
    sd = {f"module.{k}": v + 1 if v.is_floating_point() else v
          for k, v in model.state_dict().items()}
    torch.save({"epoch": 1, "state_dict": sd}, tmp_path / "m.pth")
    fresh = create_model(arch, HEADS, HEAD_CONV)
    report = weights.load_weights(fresh, weights.load_reference_checkpoint(
        str(tmp_path / "m.pth")), strict=True)
    assert report["skipped"] == [] and report["missing"] == []
    torch.testing.assert_close(fresh.hm[2].bias, model.hm[2].bias + 1)


def test_unknown_archs_raise():
    for arch in ("resnet_18", "res_19", "dla_18", "res_x"):
        with pytest.raises(KeyError):
            create_model(arch, HEADS, HEAD_CONV)
    with pytest.raises(KeyError):
        weights.state_dict_from_jax({"params": {}}, "vgg_16")


def test_offset_tool_finds_the_three_resdcn_nodes(jax_side, monkeypatch):
    """tools/analyze_dcn_offsets on resdcn_18 finds its 3 DCNv2 nodes, and
    their raw offsets equal the JAX tool's (rtol 1e-4, atol 1e-4, as
    tests/test_torch_tools.py)."""
    monkeypatch.delenv("CENTERPOLY_PALLAS_DCN", raising=False)
    _, variables = jax_side["resdcn_18"]
    kw = dict(arch="resdcn_18", input_h=64, input_w=128,
              head_conv=HEAD_CONV, mixed_precision=False)
    frame = np.random.RandomState(1).randint(0, 256, (128, 256, 3), np.uint8)
    inter = jtool.collect(JaxConfig(**kw), variables, frame)
    JaxConfig(input_h=64, input_w=128)  # restores the variable's prior value
    offsets = tool.collect(Config(**kw), variables, frame, device="cpu")
    assert list(offsets) == ["deconv_layers.0", "deconv_layers.6",
                             "deconv_layers.12"]
    assert [o.shape for o in offsets.values()] == [
        (1, 2, 4, 18), (1, 4, 8, 18), (1, 8, 16, 18)]
    # 'intermediates/dcn_1/[0]' -> the Sequential's DCNv2 of stage 1
    ref = {f"deconv_layers.{6 * int(re.search(r'dcn_(\d+)', row['node'])[1])}":
           np.asarray(leaf) for row, leaf in zip(
               jtool.offset_stats(inter, 4.0), jax.tree_util.tree_leaves(inter))}
    for name, got in offsets.items():
        np.testing.assert_allclose(got, ref[name], rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    rows = tool.offset_stats(offsets, 4.0)
    assert [row["node"] for row in rows] == list(offsets)
