"""warp_ms_per_frame.infer: device ms of the serving input warp a served
frame, over the traced sub-window: the port's kernel ("warp_normalize", one
launch a call for the whole batch, the normalisation and the cast fused),
or, on a port without it, the two cuBLAS f32 GEMMs a frame by which that
warp multiplied each frame by its dense sampling matrices, matched by
their whole names on an H100 (`GEMMS`), so that no other f32 GEMM, of an
f32 serving configuration or of another layer, is read as the warp.
The plain warp's other passes (the sampling matrices built each frame, the
uint8 -> f32 cast, the permuted copy, the stack, the normalisation and the
bf16 cast) are elementwise kernels that cannot be told apart from the
network's by name, and are not counted: on the plain warp this reads the
GEMMs alone."""

GEMMS = ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_"
         "warpsize1x4x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas",
         "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_"
         "warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas")
WORDS = GEMMS + ("warp_normalize",)


def read(ctx):
    ms = 1e3 * ctx.trace.kernel_s(WORDS)
    return ms / ctx.units if ms > 0 else None
