"""upsample_ms_per_frame.infer on hand-built traces: cuDNN's no-grad
transposed convolution (its dgrad kernels, the parent's up-sampler) and
the port's fused kernel, each counted once, no other kernel counted."""
from types import SimpleNamespace

import pytest

from benchmark.harness import cells
from benchmark.harness.trace import Trace, kind_of

CUDNN = ["dgrad2d_c1_k1_nhwc",
         "void cudnn::cnn::dgrad2d_grouped_direct_kernel<__nv_bfloat16, "
         "int, float, float, true, false, 0, 1>(...)"]
PORT = ("void (anonymous namespace)::ida_upsample_add<__nv_bfloat16, 2>("
        "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
        "__nv_bfloat16*, int, int, int, int, int, int, int, int)")
OTHERS = ["void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop>",
          "void (anonymous namespace)::dcn_fwd_kernel<__nv_bfloat16, 64>",
          "void at::native::vectorized_elementwise_kernel<8, add>"]


def _read(kernels, units=4):
    ctx = SimpleNamespace(trace=Trace(kernels, []), units=units,
                          mode="serve")
    return cells.reader("upsample_ms_per_frame.infer")(ctx)


def _timed(names, t0=0.0, us=100.0):
    return [(n, t0 + i * us, t0 + (i + 1) * us) for i, n in enumerate(names)]


def test_reads_the_cudnn_and_the_port_kernels():
    # 2 cuDNN dgrad kernels and 1 port kernel of 100 us among 3 others:
    # 300 us over 4 frames
    kernels = _timed(OTHERS[:1] + CUDNN + OTHERS[1:] + [PORT])
    assert _read(kernels) == pytest.approx(0.3 / 4)
    assert _read(_timed([PORT] * 8)) == pytest.approx(0.8 / 4)
    assert _read(_timed(CUDNN * 4)) == pytest.approx(0.8 / 4)


def test_nothing_to_read_without_an_upsampler():
    """smallhourglass's trace (no transposed convolution) and an empty one
    read None."""
    assert _read(_timed(OTHERS)) is None
    assert _read([]) is None


def test_port_kernel_is_no_convolution_kind():
    """The port's kernel falls under no kind of the trace, so
    conv_ms_per_frame.infer loses cuDNN's share and does not take the
    kernel's."""
    assert kind_of(PORT) == "other"
    assert all(kind_of(n) == "convolution" for n in CUDNN)
    ctx = SimpleNamespace(trace=Trace(_timed(CUDNN + [PORT]), []), units=1,
                          mode="serve")
    assert cells.reader("conv_ms_per_frame.infer")(ctx) == pytest.approx(0.2)
