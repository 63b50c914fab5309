"""The port's tools/analyze_dcn_offsets against the JAX package's.

Same weights (random JAX variables carried in by `state_dict_from_jax`),
same frame, 64x128 input, f32 on the CPU.  The JAX tool sows each DCNv2
node's raw offsets (flax `intermediates`); the port collects them with
forward hooks on each `DCNv2.conv_offset_mask`.  Nodes are paired through
the name map that `weights.py` inverts.  Raw offsets agree to rtol 1e-4,
atol 1e-4 (the heads agree to ~1e-5, tests/test_torch_detector.py), and
every statistic of a row within 1e-4 absolute.  Both tools round their
rows to 3 decimals for printing; the comparison takes them unrounded (a
difference of 1e-6 can round 1e-3 apart).
"""
import json

import jax
import numpy as np
import pytest

from torch_port_common import HEADS, jax_dla_variables

from centerpoly_tpu.configs import Config as JaxConfig
from centerpoly_tpu.tools import analyze_dcn_offsets as jtool
from centerpoly_tpu_torch.configs import Config
from centerpoly_tpu_torch.tools import analyze_dcn_offsets as tool
from centerpoly_tpu_torch.weights import _torch_key

KW = dict(input_h=64, input_w=128, head_conv=32, mixed_precision=False)
R = 4.0


@pytest.fixture(scope="module")
def variables():
    return jax_dla_variables(HEADS, 32, 64, 128, seed=8, offset_gain=0.3)[1]


def _port_node(jax_node: str) -> str:
    """'intermediates/dla_up_ida_0/node_1/DCNv2_0/[0]' -> the port's DCNv2
    module name 'dla_up.ida_0.node_1.conv'."""
    path = jax_node.removeprefix("intermediates/").removesuffix("/[0]")
    key, _ = _torch_key(f"{path}/conv_offset_mask/kernel")
    return key.removesuffix(".conv_offset_mask.weight")


@pytest.mark.parametrize("mode", ["off", "halo:4"])
def test_offset_stats_match_jax(monkeypatch, variables, mode):
    monkeypatch.delenv("CENTERPOLY_PALLAS_DCN", raising=False)
    for module in (jtool, tool):
        monkeypatch.setattr(module, "round", lambda v, n: v, raising=False)
    inter = jtool.collect(JaxConfig(dcn_kernel=mode, **KW), variables)
    ref = {_port_node(row["node"]): row
           for row in jtool.offset_stats(inter, R)}
    JaxConfig(**KW)  # dcn_kernel auto: restores the variable's prior value
    offsets = tool.collect(Config(dcn_kernel=mode, **KW), variables,
                           device="cpu")
    rows = {row["node"]: row for row in tool.offset_stats(offsets, R)}
    assert set(rows) == set(ref) and len(rows) == 16

    leaves = {_port_node(jax_row["node"]): np.asarray(leaf)
              for jax_row, leaf in zip(jtool.offset_stats(inter, R),
                                       jax.tree_util.tree_leaves(inter))}
    for name, got in offsets.items():
        np.testing.assert_allclose(got, leaves[name], rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    for name, row in rows.items():
        assert row["shape"] == ref[name]["shape"], name
        for k, v in row.items():
            if k not in ("node", "shape"):
                assert abs(v - ref[name][k]) <= 1e-4, (name, k, v,
                                                       ref[name][k])
    # the clamp is exercised: some offsets lie beyond R
    assert max(row["xy_frac_clamped_at_r"] for row in rows.values()) > 0


def test_main_on_a_npy_frame(tmp_path, capsys):
    frame = np.random.RandomState(1).randint(0, 256, (128, 256, 3), np.uint8)
    np.save(tmp_path / "f.npy", frame)
    rows = tool.main(["polydet", "--demo", str(tmp_path / "f.npy"), "--r",
                      "6", "--device", "cpu", "--input_h", "64",
                      "--input_w", "128", "--head_conv", "32",
                      "--dcn_kernel", "halo:6"])
    lines = [json.loads(line) for line in
             capsys.readouterr().out.strip().splitlines()]
    assert lines[:-1] == rows and len(rows) == 16
    summary = lines[-1]
    assert summary["r"] == 6.0 and all(row["r"] == 6.0 for row in rows)
    # a fresh init's offset convs are zero: no offset is clamped
    assert summary["lossless_halo"] and summary["lossless_rowband"]
    assert summary["worst_node_frac_xy"] == 0.0


def test_main_on_an_arch_without_dcn(tmp_path):
    """smallhourglass has no DCNv2 node: the tool exits with a message
    that says so, and prints no (empty) table."""
    with pytest.raises(SystemExit, match="no DCNv2 node"):
        tool.main(["polydet", "--arch", "smallhourglass", "--device", "cpu",
                   "--input_h", "128", "--input_w", "256"])


def test_remap_extremenet_keys_matches_jax():
    """The ExtremeNet -> CenterNet key remap equals the JAX package's on a
    key set with every head key, `ct_heats` beside `t_heats`, and keys the
    remap leaves alone."""
    from centerpoly_tpu.tools.hourglass_weights import (
        remap_extremenet_keys as jremap)
    from centerpoly_tpu_torch.tools.hourglass_weights import (
        KEY_MAP, remap_extremenet_keys)
    keys = [f"module.{k}.{s}.1.weight" for k in KEY_MAP for s in (0, 1)]
    keys += ["module.kps.0.low2.low2.up1.0.conv1.weight", "module.pre.0.conv"
             ".weight", "ct_heats.0.0.conv.bias", "t_heats.1.1.bias"]
    sd = {k: i for i, k in enumerate(keys)}
    got = remap_extremenet_keys(sd)
    assert got == jremap(sd)
    assert got["hm_c.0.0.conv.bias"] == sd["ct_heats.0.0.conv.bias"]
    assert got["hm_t.1.1.bias"] == sd["t_heats.1.1.bias"]
