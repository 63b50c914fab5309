"""warp_ms_per_frame.infer on hand-built traces: the plain warp's two f32
cuBLAS GEMMs a frame and the port's kernel each counted, no other kernel
counted."""
from types import SimpleNamespace

import pytest

from benchmark.harness import cells
from benchmark.harness.trace import Trace, kind_of

GEMMS = ["sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_"
         "warpsize1x4x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas",
         "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_"
         "warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas"]
PORT = ("void (anonymous namespace)::warp_normalize<__nv_bfloat16>("
        "unsigned char const*, __nv_bfloat16*, int, int, int, int, long long, "
        "(anonymous namespace)::Affine, (anonymous namespace)::Norm)")
OTHERS = ["nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT",
          "void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop>",
          "void (anonymous namespace)::dcn_fwd_kernel<__nv_bfloat16, 64>",
          "sm80_xmma_gemm_cf32cf32_f32f32_cf32_nt_n_tilesize32x64x8_stage3",
          # another layer's f32 GEMMs: the same family, other tiles
          "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_"
          "warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas",
          "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x64x8_stage3_"
          "warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas",
          "void at::native::vectorized_elementwise_kernel<8, add>",
          "void at::native::elementwise_kernel<128, 4, div_true_kernel_cuda>",
          "void at::native::unrolled_elementwise_kernel<direct_copy_kernel>",
          "Memcpy HtoD (Pinned -> Device)"]


def _read(kernels, units=4):
    ctx = SimpleNamespace(trace=Trace(kernels, []), units=units,
                          mode="serve")
    return cells.reader("warp_ms_per_frame.infer")(ctx)


def _timed(names, t0=0.0, us=100.0):
    return [(n, t0 + i * us, t0 + (i + 1) * us) for i, n in enumerate(names)]


def test_reads_the_gemms_and_the_port_kernel():
    """A traced call of 4 frames on the plain warp: 8 GEMMs of 100 us
    among the others, 800 us over 4 frames; on the kernel one launch."""
    kernels = _timed(OTHERS[:2] + GEMMS * 4 + OTHERS[2:])
    assert _read(kernels) == pytest.approx(0.8 / 4)
    assert _read(_timed(OTHERS + [PORT])) == pytest.approx(0.1 / 4)
    assert _read(_timed([PORT] * 8), units=32) == pytest.approx(0.8 / 32)


def test_nothing_else_is_read():
    """cuBLASLt's nvjet GEMMs, CUTLASS convolutions, the DCN kernel, the
    complex GEMM of cuDNN's FFT convolutions, f32 cuBLAS GEMMs of other
    tiles than the plain warp's two, elementwise kernels and copies read
    None."""
    assert _read(_timed(OTHERS)) is None
    assert _read([]) is None


def test_port_kernel_is_no_kind():
    """The port's kernel falls under no kind of the trace (as the plain
    warp's GEMMs did not), so no other reader takes it."""
    assert kind_of(PORT) == "other"
    assert all(kind_of(n) == "other" for n in GEMMS)
