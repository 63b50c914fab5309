// DCNv2 backward (modulated deformable 3x3 conv, stride 1, zero padding).
//
// Replaces the TPU kernels
//   centerpoly_tpu/kernels/dcn_rowband.py::_rowband_bwd_kernel
//     (the fused row-band backward; its XLA remainder is _pallas_bwd)
//   centerpoly_tpu/kernels/dcn_halo.py:173 _samp_kernel (the `halo:R`
//     backward's three sweeps: value samples and the two hat-derivative
//     samples that _pallas_bwd's einsums turn into dW, dmask, d offsets)
//   centerpoly_tpu/kernels/dcn_halo.py:231 _dx_kernel (its dx sweep)
// and, with the clamp off, the exact mode's backward, which the JAX
// package takes from XLA autodiff of models/deform_conv.py::deform_conv2d
// (_dc_bwd).  One kernel templated on the clamp mode (none / y / xy)
// computes what they compute, not how: the band tensor, the one-hot
// column matrices B2 and the D shifted slice-adds of kernel #3, and the
// (2R+3)^2 rolls and reverse rolls of the halo sweeps, exist only because
// Mosaic could not gather or scatter; on Hopper each tap's four bilinear
// corners are read directly and dx is a scatter-add with f32 atomics.
//
// Inputs: x (npix, C) in T, the raw f32 offsets (npix, 18) (clamped here
// to [-R, R], y only or both axes, exactly as csrc/dcn_fwd.cu does), the
// masks (npix, 9), and gk (npix, 9, C) f32 = W_k @ g for every tap (one
// matmul on the caller's side, dcn_rowband.py:309).  Per (pixel, tap):
//   S_c      = sum_q w_q x[corner_q, c]          (unmodulated sample)
//   samp     <- S                                 (for dW = (m S)^T g)
//   dmask    <- sum_c gk_c S_c
//   d oy     <- m sum_c gk_c [(1-fx)(x10-x00) + fx (x11-x01)]
//   d ox     <- m sum_c gk_c [(1-fy)(x01-x00) + fy (x11-x10)]
//   dx[corner_q, c] += m w_q gk_c                 (f32 atomics)
// Out-of-image corners read as 0.  fy, fx are the fractions of floor():
// at an integer position the derivative is that of the floor cell (the
// hat derivative is -1 there, not 0, dcn_rowband.py:246-253), which is
// what autodiff of the JAX oracle gives and the one-sided hat derivative
// of the halo sweeps (dcn_halo.py:207-222).  The clamp's pass-through is
// applied on the caller's side: y-offset gradients times 1 / 0.5 at +-R /
// 0 beyond (rowband), or every offset gradient zeroed where |o| >= R
// (halo, dcn_halo.py:442-450).
//
// Design (simple first): one warp per (pixel, tap), lanes on consecutive
// channels, so the NHWC corner rows, the gk row, the samp row and the dx
// atomics are all warp-coalesced; the three channel sums are warp
// shuffles.  A corner whose bilinear weight is 0 (every corner but one at
// integer offsets, e.g. at the zero init of the offset convs) issues no
// atomics.
//
// What bounds it on an H100 (in every mode: the clamp moves no byte): per
// (pixel, tap) it reads 4 corner rows and one f32 gk row and writes one
// f32 samp row plus 4 atomic rows: the f32 gk and samp rows (2 x 36 B a pixel-channel) dominate the bytes, and
// the ~36 atomics that land on each dx element are served by the L2.  It
// sits far below the ~295 FLOP/byte ridge, so bytes bound it.  The whole
// backward (this kernel and the f32 GEMMs gk = W_k @ g and dW around it)
// is bound by those GEMMs' operations: 3.7185 ms a step of the 16 DLA-34
// nodes at 512x1024, batch 4, f32.  Fusing gk and dW into the kernel (no
// gk or samp in device memory, `wgmma`) is the later step.
//
// Plain C interface, bound from Python with ctypes
// (centerpoly_tpu_torch/kernels/dcn.py).  Pointers are device pointers;
// the kernel runs on the caller's stream and allocates nothing; dx must
// be zeroed by the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps, one (pixel, tap) each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// clamp modes: which offset axes are clamped to [-R, R]
constexpr int CLAMP_NONE = 0, CLAMP_Y = 1, CLAMP_XY = 2;

template <typename T, int CLAMP>
__global__ void __launch_bounds__(THREADS)
dcn_bwd_kernel(const T* __restrict__ x,        // (B, H, W, C)
               const float* __restrict__ off,  // (B, H, W, 18) raw (dy, dx)
               const float* __restrict__ mask, // (B, H, W, 9)
               const float* __restrict__ gk,   // (B, H, W, 9, C)
               float* __restrict__ samp,       // (B, H, W, 9, C)
               float* __restrict__ doff,       // (B, H, W, 18)
               float* __restrict__ dmask,      // (B, H, W, 9)
               float* __restrict__ dx,         // (B, H, W, C), zeroed
               int npix, int H, int W, int C, float R) {
  const long long item =
      ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (item >= (long long)npix * 9) return;  // whole warps leave together
  const int n = (int)(item / 9);
  const int k = (int)(item % 9);

  const int hw = n % (H * W);
  const int base = n - hw;  // first pixel of this image
  const int yy = hw / W;
  const int xx = hw % W;
  float oy = off[(size_t)n * 18 + 2 * k];
  float ox = off[(size_t)n * 18 + 2 * k + 1];
  if (CLAMP != CLAMP_NONE) oy = fminf(fmaxf(oy, -R), R);
  if (CLAMP == CLAMP_XY) ox = fminf(fmaxf(ox, -R), R);
  // same association as the forward and the JAX oracle
  const float sy = (float)(yy + k / 3 - 1) + oy;
  const float sx = (float)(xx + k % 3 - 1) + ox;
  const float y0 = floorf(sy);
  const float x0 = floorf(sx);
  const float fy = sy - y0;
  const float fx = sx - x0;
  const float m = mask[(size_t)n * 9 + k];
  const float cw[4] = {(1.f - fy) * (1.f - fx), (1.f - fy) * fx,
                       fy * (1.f - fx), fy * fx};
  int id[4];
  bool in[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float yf = y0 + (float)(q >> 1);
    const float xf = x0 + (float)(q & 1);
    // compare in float: a wild offset must not overflow an int
    in[q] = yf >= 0.f && yf < (float)H && xf >= 0.f && xf < (float)W;
    id[q] = in[q] ? base + (int)yf * W + (int)xf : 0;
  }

  const size_t row = (size_t)item * C;  // (n, k) row of gk and samp
  float acc_m = 0.f, acc_y = 0.f, acc_x = 0.f;
  for (int c = lane; c < C; c += 32) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // unconditional load (index 0 when outside), select after it, so
      // the four loads go out together
      const float xv = to_f32(x[(size_t)id[q] * C + c]);
      v[q] = in[q] ? xv : 0.f;
    }
    const float g = gk[row + c];
    const float s = cw[0] * v[0] + cw[1] * v[1] + cw[2] * v[2] + cw[3] * v[3];
    samp[row + c] = s;
    acc_m = fmaf(g, s, acc_m);
    acc_y = fmaf(g, (1.f - fx) * (v[2] - v[0]) + fx * (v[3] - v[1]), acc_y);
    acc_x = fmaf(g, (1.f - fy) * (v[1] - v[0]) + fy * (v[3] - v[2]), acc_x);
    const float gm = g * m;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (in[q] && cw[q] != 0.f)  // uniform across the warp
        atomicAdd(&dx[(size_t)id[q] * C + c], gm * cw[q]);
  }
  acc_m = warp_sum(acc_m);
  acc_y = warp_sum(acc_y);
  acc_x = warp_sum(acc_x);
  if (lane == 0) {
    dmask[(size_t)n * 9 + k] = acc_m;
    doff[(size_t)n * 18 + 2 * k] = m * acc_y;
    doff[(size_t)n * 18 + 2 * k + 1] = m * acc_x;
  }
}

template <typename T, int CLAMP>
void launch_mode(const void* x, const void* off, const void* mask,
                 const void* gk, void* samp, void* doff, void* dmask,
                 void* dx, int npix, int H, int W, int C, float R,
                 cudaStream_t stream) {
  const long long warps = (long long)npix * 9;
  const dim3 grid((unsigned)((warps * 32 + THREADS - 1) / THREADS));
  dcn_bwd_kernel<T, CLAMP><<<grid, THREADS, 0, stream>>>(
      (const T*)x, (const float*)off, (const float*)mask, (const float*)gk,
      (float*)samp, (float*)doff, (float*)dmask, (float*)dx, npix, H, W, C,
      R);
}

template <typename T>
void launch(const void* x, const void* off, const void* mask, const void* gk,
            void* samp, void* doff, void* dmask, void* dx, int npix, int H,
            int W, int C, int clamp, float R, cudaStream_t stream) {
  if (clamp == CLAMP_XY)
    launch_mode<T, CLAMP_XY>(x, off, mask, gk, samp, doff, dmask, dx, npix,
                             H, W, C, R, stream);
  else if (clamp == CLAMP_Y)
    launch_mode<T, CLAMP_Y>(x, off, mask, gk, samp, doff, dmask, dx, npix, H,
                            W, C, R, stream);
  else
    launch_mode<T, CLAMP_NONE>(x, off, mask, gk, samp, doff, dmask, dx, npix,
                               H, W, C, R, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x only; everything else is f32).
// clamp: 0 = exact sampling, 1 = y-offsets clamped to [-R, R], 2 = both
// axes clamped to [-R, R]; another value is refused (cudaErrorInvalidValue).
// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int dcn_bwd(const void* x, const void* off, const void* mask,
                       const void* gk, void* samp, void* doff, void* dmask,
                       void* dx, int B, int H, int W, int C, int dtype,
                       int clamp, float R, void* stream) {
  if (clamp < CLAMP_NONE || clamp > CLAMP_XY)
    return (int)cudaErrorInvalidValue;
  const int npix = B * H * W;
  if (npix > 0 && C > 0) {
    if (dtype == 1)
      launch<__nv_bfloat16>(x, off, mask, gk, samp, doff, dmask, dx, npix, H,
                            W, C, clamp, R, (cudaStream_t)stream);
    else
      launch<float>(x, off, mask, gk, samp, doff, dmask, dx, npix, H, W, C,
                    clamp, R, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
