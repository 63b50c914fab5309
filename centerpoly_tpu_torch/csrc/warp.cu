// Serving input warp: the axis-aligned bilinear resample of uint8 HWC frames
// onto the network's input, normalised and cast, in one pass:
//
//   out[b, y, x, c] = (sum_{i, j} wy(y, i) wx(x, j) in[b, i, j, c] / 255
//                      - mean[c]) / std[c]
//
// for trans = [[ax, 0, tx], [0, ay, ty]] (source -> output).  On each axis
// the source coordinate of output o is s = (o - t) / a; its taps are
// floor(s) and floor(s) + 1, each weighted max(0, 1 - |s - i|), and a tap
// outside the frame adds nothing (constant-0 border, no renormalisation).
// It is what geometry/affine.py::warp_axis_aligned (two dense sampling
// matrices, rows contracted before columns) and the normalisation after it
// (kernels/warp.py::warp_normalize_ref) compute, rounded once to T.
//
// Replaces no TPU kernel: the JAX package runs the warp as two XLA matmuls
// by dense sampling matrices.  It was added because on the card that form is
// two f32 cuBLAS GEMMs (~12.9 GFLOP a 2048x1024 frame, all but ~0.1 % of it
// on zeros) plus separate cast, normalise, permute and stack passes: ~0.31
// ms of the 2.2-2.5 ms of device time of every served frame.
//
// What bounds it on an H100 SXM: bytes.  A 2048x1024 frame is 6.3 MB of uint8
// in, its 512x1024 input 3.1 MB of bf16 out: 0.0028 ms at 3.35 TB/s, against
// a few operations a byte.
//
// Design:
//   * 8 neighbouring output pixels (24 values) to a thread, in the flat
//     (b, y, x) order of the NHWC output, so a thread writes 3 (bf16) or 6
//     (f32) 16-byte vectors and a warp's stores are one contiguous run.  A
//     group that runs past a row's end takes the next row's taps.
//   * Source bytes are read one at a time through L1 (read-only loads): a
//     pixel's <= 2 rows and <= 2 columns of taps lie beside its neighbours',
//     so a warp's loads fall on a few cache lines.
//   * A tap of weight 0 is not read: it adds exactly 0.  At an integer scale
//     (the serving 2:1 warp) every second source row is never fetched.
//   * Coordinates and weights in f32 with IEEE division (no fast math), by
//     the expressions of _sampling_matrix; the vertical blend first, then the
//     horizontal, each as a product and then an fma, in tap order; then
//     / 255, - mean[c], / std[c]; one rounding to T.  No atomics: the output
//     is bit-equal from run to run.
//   * A grid of as many blocks as the SMs hold at once walks the groups.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PIX = 8;  // output pixels a thread
constexpr int C = 3;    // channels

// the axis-aligned affine, source -> output: o = a s + t on each axis
struct Affine {
  float ax, tx, ay, ty;
};

struct Norm {
  float mean[C], sd[C];
};

// the two taps of output coordinate o on an axis of n source samples: the
// first's index and both weights, a weight 0 where its tap lies outside
// [0, n) (the sampling matrix has no column there)
struct Taps {
  int i0;
  float w0, w1;
};

__device__ inline Taps taps(int o, float a, float t, int n) {
  const float s = ((float)o - t) / a;
  const float f = floorf(s), g = f + 1.f;
  Taps r;
  r.w0 = (f >= 0.f && f < (float)n) ? fmaxf(0.f, 1.f - fabsf(s - f)) : 0.f;
  r.w1 = (g >= 0.f && g < (float)n) ? fmaxf(0.f, 1.f - fabsf(s - g)) : 0.f;
  r.i0 = (r.w0 != 0.f || r.w1 != 0.f) ? (int)f : 0;
  return r;
}

// an output row's source rows: the first tap row's start and both weights
struct Rows {
  const uint8_t* r0;
  float w0, w1;
};

__device__ inline Rows rows_of(const uint8_t* in, long long row, int H, int W,
                               int OH, const Affine& tr) {
  const long long b = row / OH;
  const Taps t = taps((int)(row - b * OH), tr.ay, tr.ty, H);
  return {in + (b * H + t.i0) * (long long)W * C, t.w0, t.w1};
}

// 24 values (PIX pixels of C channels) to 16-byte aligned T
template <typename T>
struct Store;

template <>
struct Store<float> {
  __device__ static void vec(float* p, const float* v) {
#pragma unroll
    for (int i = 0; i < PIX * C / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
  __device__ static void one(float* p, float v) { *p = v; }
};

template <>
struct Store<__nv_bfloat16> {
  __device__ static void vec(__nv_bfloat16* p, const float* v) {
#pragma unroll
    for (int i = 0; i < PIX * C / 8; ++i) {
      uint4 a;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        h[j] = __floats2bfloat162_rn(v[8 * i + 2 * j], v[8 * i + 2 * j + 1]);
      reinterpret_cast<uint4*>(p)[i] = a;
    }
  }
  __device__ static void one(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
    warp_normalize(const uint8_t* __restrict__ in, T* __restrict__ out, int H,
                   int W, int OH, int OW, long long npix, Affine tr,
                   Norm nm) {
  const long long row_bytes = (long long)W * C;
  for (long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
       g * PIX < npix; g += (long long)gridDim.x * THREADS) {
    const long long p0 = g * PIX;
    long long row = p0 / OW;  // b * OH + y
    int x = (int)(p0 - row * OW);
    Rows rw = rows_of(in, row, H, W, OH, tr);
    float v[PIX * C];
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      if (p0 + k >= npix) break;
      if (x == OW) {
        x = 0;
        rw = rows_of(in, ++row, H, W, OH, tr);
      }
      const Taps tc = taps(x++, tr.ax, tr.tx, W);
      float acc[C] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int jt = 0; jt < 2; ++jt) {
        const float wx = jt ? tc.w1 : tc.w0;
        if (wx == 0.f) continue;
        const uint8_t* p = rw.r0 + (long long)(tc.i0 + jt) * C;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          // the column's vertical blend, then its share of the horizontal
          float col = 0.f;
          if (rw.w0 != 0.f) col = rw.w0 * (float)__ldg(p + c);
          if (rw.w1 != 0.f)
            col = fmaf(rw.w1, (float)__ldg(p + row_bytes + c), col);
          acc[c] = jt && tc.w0 != 0.f ? fmaf(wx, col, acc[c]) : wx * col;
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c)
        v[k * C + c] = (acc[c] / 255.f - nm.mean[c]) / nm.sd[c];
    }
    T* dst = out + p0 * C;
    if (p0 + PIX <= npix) {
      Store<T>::vec(dst, v);
    } else {
      // the last, partial group; v's indices fixed, so it stays in registers
      const int n = (int)(npix - p0) * C;
#pragma unroll
      for (int i = 0; i < PIX * C; ++i)
        if (i < n) Store<T>::one(dst + i, v[i]);
    }
  }
}

template <typename T>
int launch(const void* in, void* out, int B, int H, int W, int OH, int OW,
           const Affine& tr, const Norm& nm, int n_sm, cudaStream_t stream) {
  const long long npix = (long long)B * OH * OW;
  if (npix == 0) return (int)cudaGetLastError();
  const long long blocks = ((npix + PIX - 1) / PIX + THREADS - 1) / THREADS;
  // as many blocks as the SMs hold at once, so none waits for a second wave
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, warp_normalize<T>, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  const long long cap = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(blocks < cap ? blocks : cap);
  warp_normalize<T><<<grid, THREADS, 0, stream>>>(
      (const uint8_t*)in, (T*)out, H, W, OH, OW, npix, tr, nm);
  return (int)cudaGetLastError();
}

}  // namespace

// in (B, H, W, 3) uint8, contiguous; out (B, OH, OW, 3) of dtype 0 (f32) or
// 1 (bf16), contiguous (a channels-last (B, 3, OH, OW) tensor), 16-byte
// aligned; trans [[ax, 0, tx], [0, ay, ty]] with ax, ay non-zero; the
// per-channel mean and std.  Returns the launch's cudaError.
extern "C" int launch_warp_normalize(const void* in, void* out, int B, int H,
                                     int W, int OH, int OW, float ax,
                                     float tx, float ay, float ty, float m0,
                                     float m1, float m2, float s0, float s1,
                                     float s2, int dtype, int n_sm,
                                     void* stream) {
  if (B < 0 || H < 1 || W < 1 || OH < 0 || OW < 1 || n_sm < 1 ||
      ax == 0.f || ay == 0.f || (dtype != 0 && dtype != 1) ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const Affine tr{ax, tx, ay, ty};
  const Norm nm{{m0, m1, m2}, {s0, s1, s2}};
  if (dtype == 1)
    return launch<__nv_bfloat16>(in, out, B, H, W, OH, OW, tr, nm, n_sm,
                                 (cudaStream_t)stream);
  return launch<float>(in, out, B, H, W, OH, OW, tr, nm, n_sm,
                       (cudaStream_t)stream);
}
