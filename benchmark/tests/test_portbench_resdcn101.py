"""The resdcn101.serve-batch4 cell on the CPU at a small size, and its two
readers: dcn_node_roofline.infer (the configuration's own DCN nodes'
bound over the dcn_fwd kernels' time) and deconv_ms_per_frame.infer
(cuDNN's dgrad kernels, the up stages' transposed convolutions)."""
import time
from types import SimpleNamespace

import pytest

from portbench_common import small_cell
from benchmark import roofline
from benchmark.harness import cells, runner
from benchmark.harness.trace import Trace

CELL = "resdcn101.serve-batch4"
DCN = ["void (anonymous namespace)::dcn_fwd_kernel<__nv_bfloat16, 64>",
       "void (anonymous namespace)::dcn_fwd_reduce<__nv_bfloat16>"]
DGRAD = ["sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"]
OTHERS = ["void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop>",
          "void at::native::batch_norm_transform_input_channels_last_kernel",
          "void at::native::vectorized_elementwise_kernel<8, add>"]


def _roofline():
    return cells.module("metrics", "dcn_node_roofline")


def _ctx(kernels, units=4, cell=CELL):
    return SimpleNamespace(trace=Trace(kernels, []), units=units,
                           mode="serve", cell=cells.load(cell))


def _timed(names, us=100.0):
    return [(n, i * us, (i + 1) * us) for i, n in enumerate(names)]


@pytest.mark.parametrize("traced", [False, True])
def test_a_small_serving_run_on_the_cpu(traced):
    cell = small_cell(CELL)
    out = runner.run(cell, 2 ** 31 + 11, 0.5, traced, "cpu",
                     time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["checks"]) == set(cell["limits"])
    if traced:
        # the CPU runs no dcn_fwd or dgrad kernel: both readers are silent
        assert not {"dcn_node_roofline.infer",
                    "deconv_ms_per_frame.infer"} & set(out["metrics"])
        assert out["metrics"]["dcn_launches.infer"]["value"] == 0
    else:
        assert set(out["metrics"]) == {"setup_s"}


def test_bound_is_dla34s_frozen_bound_on_dla34():
    conf = cells.load("dla34.serve-batch4")["config"]
    assert _roofline().node_shapes(conf) == roofline.NODE_SHAPES
    for batch in (1, 4, 16):
        assert (_roofline().bound_ms(conf, batch)
                == roofline.forward_bound_ms(batch))


def test_resdcn101_has_its_three_nodes():
    conf = cells.load(CELL)["config"]
    assert _roofline().node_shapes(conf) == {
        (16, 32, 2048, 256): 1, (32, 64, 256, 128): 1, (64, 128, 128, 64): 1}
    # the 2048-channel node is bounded by its operations at batch 4
    h, w, cin, cout = 16, 32, 2048, 256
    ops_ms = 1e3 * 2.0 * 4 * h * w * 9 * cin * cout / roofline.PEAK_BF16_FLOPS
    assert roofline.node_bound_ms((h, w, cin, cout), 4) == ops_ms
    assert _roofline().bound_ms(conf, 4) == pytest.approx(0.029313, rel=1e-4)


def test_roofline_reads_the_dcn_kernels_per_forward():
    # 2 dcn kernels of 100 us among 3 others, 8 frames = 2 forwards of 4:
    # 0.1 ms a forward against the bound
    kernels = _timed(OTHERS[:1] + DCN + OTHERS[1:] + DGRAD)
    got = cells.reader("dcn_node_roofline.infer")(_ctx(kernels, units=8))
    bound = _roofline().bound_ms(cells.load(CELL)["config"], 4)
    assert got == pytest.approx(100.0 * bound / 0.1)
    assert cells.reader("dcn_node_roofline.infer")(
        _ctx(_timed(OTHERS + DGRAD))) is None


def test_deconv_reads_the_dgrad_kernels_a_frame():
    kernels = _timed(DGRAD * 3 + OTHERS + DCN)
    got = cells.reader("deconv_ms_per_frame.infer")(_ctx(kernels, units=4))
    assert got == pytest.approx(0.3 / 4)
    assert cells.reader("deconv_ms_per_frame.infer")(
        _ctx(_timed(OTHERS + DCN))) is None
    assert cells.reader("deconv_ms_per_frame.infer")(_ctx([])) is None
