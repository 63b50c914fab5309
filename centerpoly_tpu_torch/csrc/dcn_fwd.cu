// DCNv2 forward (modulated deformable 3x3 conv, stride 1, zero padding).
//
// Replaces three TPU kernels of the JAX package:
//   centerpoly_tpu/kernels/dcn_pallas.py::_kernel        (exact sampling)
//   centerpoly_tpu/kernels/dcn_rowband.py::_rowband_kernel (y-offsets
//     clamped to [-R, R], x exact; the `rowband:R` inference default)
//   centerpoly_tpu/kernels/dcn_halo.py:124 _fwd_kernel   (both offset axes
//     clamped to [-R, R]; the opt-in `halo:R` mode)
// as one kernel templated on the clamp mode (none / y / xy).  It computes
// what they compute, not how: the row-band kernel's one-hot column matmul,
// its band tensor and its lane packing, and the halo kernel's sweep of
// (2R+3)^2 rolled copies of a zero-padded flat map weighted by separable
// hat functions, exist only because Mosaic could not compile a gather
// (dcn_rowband.py:3-7, dcn_halo.py:5-8).  The hat sum over integer
// displacements is zero-padded bilinear sampling, and Hopper gathers
// natively, so every mode samples the four bilinear corners directly; the
// halo mode adds one clamp of the x-offset.  (The halo kernel rounds the
// masked samples to the activation type before its contraction; this one
// contracts them in f32 in every mode.)
//
// Design (simple first):
//   * a block owns TP output pixels (flattened over B*H*W) and TC output
//     channels;
//   * it first computes, for its pixels and all 9 taps, the flat index of
//     each of the 4 bilinear corners (-1 outside the image) and its weight
//     bilinear * mask, in f32 from the f32 offsets;
//   * then for each tap and each chunk of CK input channels it gathers the
//     modulated sample S[c][p] = sum_corners w * x[corner][c] into shared
//     memory (one warp per pixel row, lanes on consecutive channels, so the
//     NHWC row reads coalesce), stages W_k[c0:c0+CK, o0:o0+TC] beside it,
//     and contracts the two in an f32 register accumulator (4x4 outputs a
//     thread, float4 shared loads);
//   * it adds the bias and writes the NHWC output in the input's type.
//
// What bounds it on an H100, in every mode (the clamp costs two
// instructions a tap and moves no byte): the 16 DCN nodes of DLA-34 at
// 512x1024 need ~28 GFLOP a frame (~28 us at the bf16 tensor-core peak)
// and move ~85 MB (~25 us at 3.35 TB/s); node by node the larger of the
// two sums to 0.0345 ms a bf16 frame at batch 1, mostly bytes: the
// wide-channel nodes sit above the ~295 FLOP/byte ridge, the 64-channel
// stride-4 nodes below it, where the f32 offsets and masks (108 B a
// pixel) outweigh the bf16 activations.  This version contracts on the
// CUDA cores in f32 (67 TFLOP/s peak, less the shared-memory operand
// traffic), not on the tensor cores, so it runs far from that bound; the
// gather is also redone once per output-channel tile.  Later work: stage
// the sampled tile in bf16 and contract it with `wgmma` (tile of 64 pixels
// x Cout, K = CK), keep all of Cout in one block so each sample is gathered
// once, and double-buffer the W_k slices with TMA while the warps gather
// the next chunk.
//
// Plain C interface, bound from Python with ctypes
// (centerpoly_tpu_torch/kernels/dcn.py).  Pointers are device pointers;
// the kernel runs on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TP = 64;        // output pixels per block
constexpr int TC = 64;        // output channels per block
constexpr int CK = 32;        // input channels per staged chunk
constexpr int THREADS = 256;  // 8 warps
constexpr int SP = TP + 4;    // padded row of the sampled tile (float4-aligned)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// clamp modes: which offset axes are clamped to [-R, R]
constexpr int CLAMP_NONE = 0, CLAMP_Y = 1, CLAMP_XY = 2;

template <typename T, int CLAMP>
__global__ void __launch_bounds__(THREADS)
dcn_fwd_kernel(const T* __restrict__ x,        // (B, H, W, C)
               const float* __restrict__ off,  // (B, H, W, 18) (dy, dx) per tap
               const float* __restrict__ mask, // (B, H, W, 9)
               const T* __restrict__ w,        // (9, C, Cout)
               const T* __restrict__ bias,     // (Cout,)
               T* __restrict__ out,            // (B, H, W, Cout)
               int npix, int H, int W, int C, int Cout, float R) {
  __shared__ int s_idx[9][4][TP];    // flat pixel of each corner, -1 outside
  __shared__ float s_wgt[9][4][TP];  // bilinear weight * mask
  __shared__ __align__(16) float s_samp[CK][SP];
  __shared__ __align__(16) float s_w[CK][TC];

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * TP;
  const int o0 = blockIdx.y * TC;

  // corner indices and weights of every (tap, pixel) of the tile
  for (int e = tid; e < 9 * TP; e += THREADS) {
    const int k = e / TP;
    const int p = e % TP;
    const int n = p0 + p;
    int id[4] = {-1, -1, -1, -1};
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    if (n < npix) {
      const int hw = n % (H * W);
      const int base = n - hw;  // first pixel of this image
      const int yy = hw / W;
      const int xx = hw % W;
      float oy = off[(size_t)n * 18 + 2 * k];
      float ox = off[(size_t)n * 18 + 2 * k + 1];
      if (CLAMP != CLAMP_NONE) oy = fminf(fmaxf(oy, -R), R);
      if (CLAMP == CLAMP_XY) ox = fminf(fmaxf(ox, -R), R);
      // same association as the JAX oracle: (grid + tap) + offset
      const float sy = (float)(yy + k / 3 - 1) + oy;
      const float sx = (float)(xx + k % 3 - 1) + ox;
      const float y0 = floorf(sy);
      const float x0 = floorf(sx);
      const float fy = sy - y0;
      const float fx = sx - x0;
      const float m = mask[(size_t)n * 9 + k];
      const float cw[4] = {(1.f - fy) * (1.f - fx) * m, (1.f - fy) * fx * m,
                           fy * (1.f - fx) * m, fy * fx * m};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float yf = y0 + (float)(q >> 1);
        const float xf = x0 + (float)(q & 1);
        // compare in float: a wild offset must not overflow an int
        if (yf >= 0.f && yf < (float)H && xf >= 0.f && xf < (float)W) {
          id[q] = base + (int)yf * W + (int)xf;
          wt[q] = cw[q];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s_idx[k][q][p] = id[q];
      s_wgt[k][q][p] = wt[q];
    }
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ty = tid / 16;  // pixels ty*4 .. ty*4+3
  const int tx = tid % 16;  // channels tx*4 .. tx*4+3

  for (int k = 0; k < 9; ++k) {
    for (int c0 = 0; c0 < C; c0 += CK) {
      __syncthreads();  // previous chunk fully consumed (and corners written)
      // gather: warp `warp` fills pixels warp*8 .. warp*8+7, lane = channel.
      // Every load is unconditional (indices clamped into the tensor) and
      // the select comes after it, so a thread issues its 32 corner loads
      // together instead of one latency at a time behind a branch.
      const int c = c0 + lane;
      const size_t cl = c < C ? c : C - 1;
#pragma unroll
      for (int r = 0; r < TP / 8; ++r) {
        const int p = warp * (TP / 8) + r;
        float v = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int id = s_idx[k][q][p];
          const float xv = to_f32(x[(size_t)(id < 0 ? 0 : id) * C + cl]);
          v += id >= 0 ? s_wgt[k][q][p] * xv : 0.f;
        }
        s_samp[lane][p] = c < C ? v : 0.f;
      }
      // stage W_k[c0:c0+CK, o0:o0+TC], zero outside Cin x Cout
      for (int e = tid; e < CK * TC; e += THREADS) {
        const int ci = c0 + e / TC;
        const int oi = o0 + e % TC;
        const float v = to_f32(w[((size_t)k * C + (ci < C ? ci : C - 1)) * Cout
                                 + (oi < Cout ? oi : Cout - 1)]);
        s_w[e / TC][e % TC] = ci < C && oi < Cout ? v : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int cc = 0; cc < CK; ++cc) {
        const float4 a = *reinterpret_cast<const float4*>(&s_samp[cc][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&s_w[cc][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = p0 + ty * 4 + i;
    if (n >= npix) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx * 4 + j;
      if (o < Cout)
        out[(size_t)n * Cout + o] = from_f32<T>(acc[i][j] + to_f32(bias[o]));
    }
  }
}

template <typename T, int CLAMP>
void launch_mode(const void* x, const void* off, const void* mask,
                 const void* w, const void* bias, void* out, int npix, int H,
                 int W, int C, int Cout, float R, cudaStream_t stream) {
  const dim3 grid((npix + TP - 1) / TP, (Cout + TC - 1) / TC);
  dcn_fwd_kernel<T, CLAMP><<<grid, THREADS, 0, stream>>>(
      (const T*)x, (const float*)off, (const float*)mask, (const T*)w,
      (const T*)bias, (T*)out, npix, H, W, C, Cout, R);
}

template <typename T>
void launch(const void* x, const void* off, const void* mask, const void* w,
            const void* bias, void* out, int npix, int H, int W, int C,
            int Cout, int clamp, float R, cudaStream_t stream) {
  if (clamp == CLAMP_XY)
    launch_mode<T, CLAMP_XY>(x, off, mask, w, bias, out, npix, H, W, C, Cout,
                             R, stream);
  else if (clamp == CLAMP_Y)
    launch_mode<T, CLAMP_Y>(x, off, mask, w, bias, out, npix, H, W, C, Cout,
                            R, stream);
  else
    launch_mode<T, CLAMP_NONE>(x, off, mask, w, bias, out, npix, H, W, C,
                               Cout, R, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, bias and out share it).
// clamp: 0 = exact sampling, 1 = y-offsets clamped to [-R, R], 2 = both
// axes clamped to [-R, R]; another value is refused (cudaErrorInvalidValue).
// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int dcn_fwd(const void* x, const void* off, const void* mask,
                       const void* w, const void* bias, void* out, int B,
                       int H, int W, int C, int Cout, int dtype, int clamp,
                       float R, void* stream) {
  if (clamp < CLAMP_NONE || clamp > CLAMP_XY)
    return (int)cudaErrorInvalidValue;
  const int npix = B * H * W;
  if (npix > 0 && Cout > 0) {
    if (dtype == 1)
      launch<__nv_bfloat16>(x, off, mask, w, bias, out, npix, H, W, C, Cout,
                            clamp, R, (cudaStream_t)stream);
    else
      launch<float>(x, off, mask, w, bias, out, npix, H, W, C, Cout, clamp,
                    R, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
