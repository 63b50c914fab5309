"""DLA-34 polydet model: the PyTorch port against the JAX package.

One set of random JAX variables drives both sides (carried into the port
by weights.state_dict_from_jax); at 64x128 input and head_conv 32 every
head must agree within 2e-3 relative maximum in f32 on the CPU (the
tolerance of tests/test_torch_parity.py's reference-import checks: the
two frameworks sum 30+ convolutions in different orders).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_common import HEADS, jax_dla_variables, port_model, rel_max

from centerpoly_tpu.train.checkpoint import flatten_params
from centerpoly_tpu.train.torch_import import import_state_dict
from centerpoly_tpu_torch import weights
from centerpoly_tpu_torch.models import create_model
from centerpoly_tpu_torch.models.dla import DepthwiseUpsample

H, W, HEAD_CONV = 64, 128, 32


@pytest.fixture(scope="module")
def jax_side():
    return jax_dla_variables(HEADS, HEAD_CONV, H, W, seed=1)


def test_heads_match_jax(jax_side):
    model, variables = jax_side
    x = np.random.RandomState(0).randn(1, H, W, 3).astype(np.float32)
    ref = jax.jit(lambda v, a: model.apply(v, a, train=False))(
        variables, jnp.asarray(x))[-1]
    port = port_model(variables, HEADS, HEAD_CONV)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))[-1]
    assert set(got) == set(HEADS)
    for head, r in ref.items():
        g = got[head].permute(0, 2, 3, 1).numpy()
        assert g.shape == r.shape
        assert rel_max(g, r) < 2e-3, head


def test_state_dict_round_trips_through_jax_import(jax_side):
    """state_dict_from_jax is the inverse of the JAX package's reference
    name map: importing its output back loads every leaf, skips no key,
    and reproduces every array exactly."""
    _, variables = jax_side
    sd = {k: v.numpy() for k, v in weights.state_dict_from_jax(
        variables).items()}
    zeros = jax.tree.map(np.zeros_like, variables)
    back, report = import_state_dict(sd, zeros, "dla_34")
    assert report["skipped"] == []
    want = flatten_params(variables["params"])
    want.update(flatten_params(variables["batch_stats"]))
    got = flatten_params(back["params"])
    got.update(flatten_params(back["batch_stats"]))
    assert len(report["loaded"]) == len(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_names_are_the_reference_names(jax_side):
    """Every parameter and buffer of the port (BatchNorm's counter aside)
    comes from a JAX leaf, and no JAX leaf is left over."""
    _, variables = jax_side
    sd = weights.state_dict_from_jax(variables)
    own = create_model("dla_34", HEADS, HEAD_CONV).state_dict()
    own = {k for k in own if not k.endswith("num_batches_tracked")}
    assert set(sd) == own
    assert "dla_up.ida_0.proj_1.conv.conv_offset_mask.weight" in own
    assert "hm.2.bias" in own and "base.level1.0.weight" in own


def test_dcn_node_count():
    """16 DCNv2 nodes: ida_0 2, ida_1 4, ida_2 6, ida_up 4."""
    from centerpoly_tpu_torch.models.deform_conv import DCNv2
    model = create_model("dla_34", HEADS, HEAD_CONV)
    names = [n for n, m in model.named_modules() if isinstance(m, DCNv2)]
    assert len(names) == 16
    for prefix, n in (("dla_up.ida_0.", 2), ("dla_up.ida_1.", 4),
                      ("dla_up.ida_2.", 6), ("ida_up.", 4)):
        assert sum(x.startswith(prefix) for x in names) == n


def test_hm_bias_init():
    model = create_model("dla_34", HEADS, HEAD_CONV)
    assert torch.all(model.hm[2].bias == -2.19)
    assert torch.all(model.poly[2].bias == 0)


def test_depthwise_upsample_flip_matches_jax():
    """The JAX kernel is the ConvTranspose2d weight flipped; carried back
    it must give the same upsample."""
    from centerpoly_tpu.models.dla import DepthwiseUpsample as JaxUp
    rng = np.random.RandomState(3)
    c, f = 4, 2
    x = rng.randn(1, 5, 7, c).astype(np.float32)
    kernel = rng.randn(2 * f, 2 * f, 1, c).astype(np.float32)
    ref = JaxUp(f).apply({"params": {"kernel": kernel}}, jnp.asarray(x))
    sd = weights.state_dict_from_jax(
        {"params": {"ida_up": {"up_1": {"kernel": kernel}}}})
    up = DepthwiseUpsample(c, f)
    up.weight.data.copy_(sd["ida_up.up_1.weight"])
    with torch.no_grad():
        got = up(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_load_reference_checkpoint(tmp_path):
    """A reference .pth ({'epoch', 'state_dict'}, DataParallel `module.`
    prefixes, an imagenet `base.fc`) loads tolerantly: the classifier is
    skipped, every model entry is set."""
    model = create_model("dla_34", HEADS, HEAD_CONV)
    sd = {f"module.{k}": v.clone() + 1 if v.is_floating_point() else v
          for k, v in model.state_dict().items()}
    sd["module.base.fc.weight"] = torch.zeros(10, 512, 1, 1)
    path = tmp_path / "model_best.pth"
    torch.save({"epoch": 3, "state_dict": sd}, path)
    loaded = weights.load_reference_checkpoint(str(path))
    assert not any(k.startswith("module.") for k in loaded)
    fresh = create_model("dla_34", HEADS, HEAD_CONV)
    report = weights.load_weights(fresh, loaded)
    assert report["skipped"] == ["base.fc.weight"]
    assert report["missing"] == []
    torch.testing.assert_close(fresh.hm[2].bias, model.hm[2].bias + 1)
    with pytest.raises(KeyError):
        weights.load_weights(create_model("dla_34", HEADS, HEAD_CONV),
                             loaded, strict=True)


def test_other_archs_raise():
    """Every arch of the JAX registry is ported; an unknown one raises
    KeyError, as the JAX factory does."""
    for arch in ("vgg_16", "dla_18", "res_x"):
        with pytest.raises(KeyError, match="arch|DLA"):
            create_model(arch, HEADS, 64)
