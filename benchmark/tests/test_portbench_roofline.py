"""The frozen counts of benchmark/roofline.py."""
import pytest

import portbench_common  # noqa: F401  (the checkout on sys.path)
from benchmark import roofline
from benchmark.harness import cells

CONF = {"heads": {"hm": 8, "poly": 32, "pseudo_depth": 1, "reg": 2},
        "head_conv": 256}


def flops(arch, training=False):
    return roofline.forward_flops(dict(CONF, arch=arch), 512, 1024,
                                  training)


@pytest.mark.parametrize("arch, gflop", [("dla_34", 141.4),
                                         ("smallhourglass", 613.0)])
def test_forward_operations_of_a_512x1024_frame(arch, gflop):
    c = flops(arch, training=True)
    assert abs(sum(c.values()) / 1e9 - gflop) < 0.1, c


def test_dcn_part_is_the_nodes_products():
    c = flops("dla_34")
    want = sum(2.0 * h * w * 9 * ci * co * n
               for (h, w, ci, co), n in roofline.NODE_SHAPES.items())
    assert c["dcn"] == want
    assert c["deconv"] > 0
    none = flops("smallhourglass")
    assert none["dcn"] == 0 and none["deconv"] == 0


def test_eval_forward_skips_the_unread_projections():
    train = flops("dla_34", True)
    infer = flops("dla_34")
    assert 0 < train["conv"] - infer["conv"] < 0.5e9
    assert train["dcn"] == infer["dcn"]


def test_bounds_match_the_ones_the_kernel_table_was_kept_with():
    """chip_smoke.py's bounds (PERF.md's kernel table): the forward over a
    frame's 16 nodes at batch 1, 0.0345 ms by bytes; the backward over a
    batch-4 step's, 0.4588 ms by operations."""
    assert abs(roofline.forward_bound_ms(1) - 0.034505) < 1e-5
    assert abs(roofline.backward_bound_ms(4) - 0.4588) < 1e-4
    # linear in the batch where the products bind
    assert roofline.backward_bound_ms(16) == pytest.approx(
        4 * roofline.backward_bound_ms(4), rel=1e-3)


@pytest.mark.parametrize("name", [c["name"] for c in
                                  cells.manifest()["configs"]])
def test_the_configuration_files_give_the_same_counts(name):
    """The counter on a configuration's own file, as mfu_pct reads it."""
    conf = next(cells.load(w["name"])["config"]
                for w in cells.manifest()["workloads"]
                if w["config"] == name)
    got = roofline.forward_flops(conf, conf["input_h"], conf["input_w"])
    assert got == flops(conf["arch"])
