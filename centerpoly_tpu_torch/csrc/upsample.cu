// IDA up-sampler: a depthwise stride-f transposed convolution (kernel 2f,
// padding p = f / 2, one group a channel, no bias) with the skip added, in
// NHWC memory:
//
//   out[b, oy, ox, c] = skip[b, oy, ox, c]
//       + sum_{iy, ix} x[b, iy, ix, c] * w[c, oy + p - iy f, ox + p - ix f]
//
// over the taps with 0 <= oy + p - iy f < 2f (and the same in x) that fall
// inside the input.  It is what models/dla.py's DepthwiseUpsample and the
// add after it in IDAUp compute (F.conv_transpose2d(x, w, stride=f,
// padding=p, groups=C) + skip).
//
// Replaces no TPU kernel: the JAX package runs the up-sampler as XLA's
// lhs-dilated grouped convolution.  It was added because cuDNN runs a no-grad
// grouped transposed convolution as a generic direct dgrad kernel that does
// (2f)^2 multiply-adds an output where at most 4 taps are non-zero, with no
// channel vectorisation: the 8 up-samplers of a DLA-34 forward took 0.432 ms
// of a 2.838 ms bf16 frame at 512x1024 (PERF.md).
//
// What bounds it on an H100 SXM: bytes.  Each output reads 2 taps an axis,
// 4 products, against ~32 bytes moved (bf16: the skip read and the output
// written, 2 bytes each a channel), far below the ~295 FLOP/byte ridge.  A
// DLA-34 frame's 8 up-samplers write 13.1 M outputs (26.2 MB in bf16) and
// read 2.9 M inputs (5.8 MB): 0.0096 ms at 3.35 TB/s alone, 0.0174 ms with
// the 26.2 MB skip read (the add's separate write and re-read are gone).
//
// Design:
//   * Output (row, pixel, 8 bf16 / 4 f32 channels) to a thread: 16-byte
//     loads of the skip and of each of the (at most 4) input taps, one
//     16-byte store.  The two taps an axis are input iy0 = (oy + p) / f at
//     kernel row ky0 = (oy + p) mod f and iy0 - 1 at ky0 + f; a tap outside
//     the input adds nothing.  Products are summed in f32 in a fixed order,
//     the skip added last, then rounded once to T: the output is bit-equal
//     from run to run.
//   * The whole weight (C x (2f)^2, 16 KB in f32 at DLA-34's shapes) is read
//     once a block, in 16-byte loads, into shared memory in f32 as
//     [tap][C], so a thread reads each tap's channels as 16-byte vectors,
//     conflict-free, with no conversion in the loop.
//   * Work items are (output row, 256-vector chunk of the row): a row shares
//     its y taps.  A grid of as many blocks as the SMs hold at once walks
//     them (grid stride), so the weight fill is paid once a block.
//   * The input taps are re-read by the (2f)^2 outputs around each input
//     pixel from L1/L2; the bound counts each input byte once.
// The factors DLA-34 uses (2 and 4) are compiled in; any other runs with f
// read at run time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// the static shared-memory limit; the wrapper sends nothing larger
constexpr size_t SMEM_BYTES = 48 * 1024;

// 16 bytes of T: V channels, widened to f32 and rounded back
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int V = 4;
  __device__ static void load(const float* p, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 a;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = a;
  }
};

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// F > 0: the factor at compile time; F == 0: `f` at run time
template <typename T, int F>
__global__ void __launch_bounds__(THREADS)
    ida_upsample_add(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ skip, T* __restrict__ out, int H,
                     int W, int C, int Ho, int Wo, int f_rt, int chunks,
                     int items) {
  constexpr int V = Pack<T>::V;
  const int f = F > 0 ? F : f_rt;
  const int k = 2 * f, p = f / 2;
  extern __shared__ __align__(16) float sw[];
  // w is (C, k, k): read in its order, 16 bytes (V taps of a channel) at
  // a time where the taps split into vectors, stored in f32 as [tap][C]
  const int taps = k * k;
  if (taps % V == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0) {
    for (int i = threadIdx.x; i < C * (taps / V); i += THREADS) {
      const int ch = i / (taps / V), t0 = (i - ch * (taps / V)) * V;
      float e[V];
      Pack<T>::load(w + i * V, e);
#pragma unroll
      for (int j = 0; j < V; ++j) sw[(t0 + j) * C + ch] = e[j];
    }
  } else {
    for (int i = threadIdx.x; i < C * taps; i += THREADS) {
      const int ch = i / taps;
      sw[(i - ch * taps) * C + ch] = to_f32(w[i]);
    }
  }
  __syncthreads();

  const int cv = C / V;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int row = item / chunks;  // b * Ho + oy
    const int v = (item - row * chunks) * THREADS + threadIdx.x;
    if (v >= Wo * cv) continue;
    const int b = row / Ho, oy = row - b * Ho;
    const int ox = v / cv, c0 = (v - ox * cv) * V;
    const int iy0 = (oy + p) / f, ky0 = oy + p - iy0 * f;
    const int ix0 = (ox + p) / f, kx0 = ox + p - ix0 * f;
    const T* xb = x + (size_t)b * H * W * C + c0;
    const size_t o = ((size_t)row * Wo + ox) * C + c0;
    // the skip's load first, so its trip to memory overlaps the taps'
    float s[V];
    Pack<T>::load(skip + o, s);
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
#pragma unroll
    for (int ty = 0; ty < 2; ++ty) {
      const int iy = iy0 - ty;
      if (iy < 0 || iy >= H) continue;
#pragma unroll
      for (int tx = 0; tx < 2; ++tx) {
        const int ix = ix0 - tx;
        if (ix < 0 || ix >= W) continue;
        float xv[V];
        Pack<T>::load(xb + ((size_t)iy * W + ix) * C, xv);
        const float4* wv = reinterpret_cast<const float4*>(
            sw + ((ky0 + ty * f) * k + kx0 + tx * f) * C + c0);
#pragma unroll
        for (int j = 0; j < V / 4; ++j) {
          const float4 wj = wv[j];
          acc[4 * j] = fmaf(xv[4 * j], wj.x, acc[4 * j]);
          acc[4 * j + 1] = fmaf(xv[4 * j + 1], wj.y, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(xv[4 * j + 2], wj.z, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(xv[4 * j + 3], wj.w, acc[4 * j + 3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] += s[j];
    Pack<T>::store(out + o, acc);
  }
}

template <typename T, int F>
int launch(const void* x, const void* w, const void* skip, void* out, int B,
           int H, int W, int C, int f, int n_sm, cudaStream_t stream) {
  constexpr int V = Pack<T>::V;
  const size_t smem = (size_t)C * 4 * f * f * sizeof(float);
  if (C % V != 0 || smem > SMEM_BYTES) return (int)cudaErrorInvalidValue;
  const int p = f / 2;
  const long long Ho = (long long)(H - 1) * f - 2 * p + 2 * f;
  const long long Wo = (long long)(W - 1) * f - 2 * p + 2 * f;
  const long long chunks = (Wo * (C / V) + THREADS - 1) / THREADS;
  const long long items = B * Ho * chunks;
  if (items > INT32_MAX || Wo * (C / V) > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (items == 0) return (int)cudaGetLastError();
  // as many blocks as the SMs hold at once (registers and shared memory
  // may allow fewer than 8 an SM), so none waits for a second wave
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ida_upsample_add<T, F>, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  const long long cap = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(items < cap ? items : cap);
  ida_upsample_add<T, F><<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const T*)w, (const T*)skip, (T*)out, H, W, C, (int)Ho,
      (int)Wo, f, (int)chunks, (int)items);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_f(const void* x, const void* w, const void* skip, void* out, int B,
             int H, int W, int C, int f, int n_sm, cudaStream_t stream) {
  if (f == 2)
    return launch<T, 2>(x, w, skip, out, B, H, W, C, f, n_sm, stream);
  if (f == 4)
    return launch<T, 4>(x, w, skip, out, B, H, W, C, f, n_sm, stream);
  return launch<T, 0>(x, w, skip, out, B, H, W, C, f, n_sm, stream);
}

}  // namespace

// x (B, H, W, C) and skip / out (B, Ho, Wo, C) in NHWC memory, 16-byte
// aligned, Ho = (H - 1) f - 2 (f / 2) + 2f (the same for Wo); w (C, 2f, 2f);
// all of dtype 0 (f32) or 1 (bf16).  C a multiple of 4 (f32) or 8 (bf16),
// C (2f)^2 f32 weights within 48 KB.
// Returns the launch's cudaError.
extern "C" int upsample_add(const void* x, const void* w, const void* skip,
                            void* out, int B, int H, int W, int C, int f,
                            int dtype, int n_sm, void* stream) {
  if (B < 0 || H < 1 || W < 1 || C < 1 || f < 1 || n_sm < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch_f<__nv_bfloat16>(x, w, skip, out, B, H, W, C, f, n_sm,
                                   (cudaStream_t)stream);
  return launch_f<float>(x, w, skip, out, B, H, W, C, f, n_sm,
                         (cudaStream_t)stream);
}
