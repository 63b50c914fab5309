// DCNv2 forward (modulated deformable 3x3 conv, stride 1, zero padding), v3.
//
// Replaces three TPU kernels of the JAX package:
//   centerpoly_tpu/kernels/dcn_pallas.py::_kernel        (exact sampling)
//   centerpoly_tpu/kernels/dcn_rowband.py::_rowband_kernel (y-offsets
//     clamped to [-R, R], x exact; the `rowband:R` inference default)
//   centerpoly_tpu/kernels/dcn_halo.py:124 _fwd_kernel   (both offset axes
//     clamped to [-R, R]; the opt-in `halo:R` mode)
// as one kernel with a clamp mode (none / y / xy).  It computes what they
// compute, not how: the row-band kernel's one-hot column matmul and the
// halo kernel's sweep of (2R+3)^2 rolled copies weighted by hat functions
// exist only because Mosaic could not compile a gather (dcn_rowband.py:3-7,
// dcn_halo.py:5-8).  Their sum over integer displacements is zero-padded
// bilinear sampling, and Hopper gathers natively, so every mode samples the
// four bilinear corners directly; the halo mode adds one clamp of x.  Like
// the TPU kernels (dcn_pallas.py:85-87: `g.astype(cdt) * scale` into a
// bf16 dot), the bf16 kernel rounds the modulated sample to bf16 before
// the product; the f32 kernel keeps f32 accuracy (3xTF32, below).
//
// What bounds it on an H100 SXM (computed from the shapes, node by node,
// the larger of bytes over 3.35 TB/s and operations over the tensor-core
// peak): the 16 DCN nodes of DLA-34 at 512x1024 take at least 0.0345 ms a
// bf16 frame at batch 1, mostly bytes (the f32 offsets and masks, 108 B a
// pixel, and the activations; the wide-channel nodes sit just above the
// ~295 FLOP/byte ridge); in f32 at batch 4 (a train step's forward) at
// least 0.253 ms, mostly operations: 113.5 GFLOP at the TF32 rate of 495
// TFLOP/s (counting each product once; 3xTF32 issues three).  The gather
// reads four corner rows for every (pixel, tap) sample, from L1/L2, which
// the bound does not count.
//
// Design, against what held v2 (a SIMT kernel at ~1 % of the bound):
//   * One block owns TP = 64 output pixels and a tile of BN = 64, 128 or
//     256 output channels: all of Cout up to 256 (wider Cout walks N tiles
//     of 256 on the grid's y axis).  So each (pixel, tap, channel) sample
//     is gathered once per block; v2 gathered it once per 64 channels.
//   * As in v2 the block first computes, for its pixels and the taps of
//     its K range, the flat index of each bilinear corner (-1 outside the
//     image) and its weight bilinear * mask, in f32 from the f32 offsets,
//     with v2's arithmetic ((grid + tap) + offset, floorf fractions).
//   * K runs over chunks of one tap and CK channels (CK * sizeof(T) = 128
//     bytes: 64 bf16 or 32 f32 channels).  For each chunk every thread
//     loads 16 bytes (8 bf16 / 4 f32 channels) of each of the four corner
//     rows of two pixels, unconditionally (indices clamped into the tensor,
//     the select after the load; a scalar path where Cin is not a multiple
//     of the vector width), blends them in f32 and rounds once to the
//     operand type, into the A tile [pixel][channel] in shared memory.
//     W_k's (CK x BN) slice comes in by cp.async (zero-filled outside
//     Cin x Cout).  Rows of both tiles are padded by 16 bytes (bf16) or by
//     16 / 32 bytes (f32 A / B), so the tensor cores' fragment loads hit 32
//     distinct banks: the padding plays the part of a swizzle.
//   * The contraction runs on the tensor cores with mma.sync: 8 warps,
//     2 along the pixels x 4 along the channels, each a 32 x BN/4 tile of
//     m16n8 products (64 f32 accumulators a thread at BN = 256).  bf16:
//     m16n8k16 from ldmatrix fragments.  f32: m16n8k8 TF32, each operand
//     split by masks into a TF32 high and low part as its fragment is
//     loaded, and hi*lo + lo*hi + hi*hi summed in f32: f32 accuracy
//     (a relative error of a few 1e-6 against the plain version) at three
//     tensor-core products, where plain TF32 (~1e-3) would break the 1e-4
//     tolerance.
//     Why mma.sync and not wgmma: (1) TF32 wgmma reads both operands
//     K-major from shared memory, while W_k is [Cin][Cout] (N-major);
//     mma.sync takes B from registers, so one [k][n] tile and one layout
//     serve both types with no transposed weight copy; (2) the A tile is
//     built by the same threads that multiply (TMA cannot gather), and
//     wgmma's 64 x BN accumulator held by one warpgroup (128 registers a
//     thread at BN = 256) leaves no room for the gather's in-flight loads,
//     where mma.sync spreads it over 8 warps; (3) in bf16 the products are
//     a small share of the time, which the gathers and the latency of each
//     chunk set.  In f32 the 3xTF32 products and their splits are about
//     half of the time: wgmma, with both operands split once into
//     K-major shared-memory tiles, is the next step there.
//   * Chunk i+1 is gathered while chunk i is contracted: its corner loads
//     and its W_k cp.async are issued before chunk i's MMAs and blended and
//     stored after them, into the other stage of a two-stage ring.  Every
//     thread both produces and consumes, so one __syncthreads a chunk is
//     the ring's full and empty barrier at once (v2 had two a chunk and no
//     overlap).
//   * Split K, deterministically: where the (pixel, Cout) tiles do not
//     cover the SMs, the wrapper (kernels/dcn.py::fwd_plan) cuts the
//     chunks into `splits` contiguous ranges, one per blockIdx.z.  Each
//     split writes its f32 partial sums to its own slice of a workspace;
//     dcn_fwd_reduce then sums the slices in split order, adds the bias
//     and casts.  No atomics: the output is bit-equal from run to run.
//     With one split the bias and the cast run in this kernel's epilogue.
//
// Plain C interface, bound from Python with ctypes
// (centerpoly_tpu_torch/kernels/dcn.py).  Pointers are device pointers;
// the kernels run on the caller's stream and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dcn_tile.cuh"

namespace {

using namespace dcn_tile;

constexpr int TP = 64;          // output pixels per block
constexpr int THREADS = 256;    // 8 warps: 2 (pixels) x 4 (channels)
constexpr int ROW_BYTES = 128;  // one pixel's channels of a K chunk
constexpr int MAX_TAPS = 9;
constexpr int CORNER_BYTES = MAX_TAPS * 4 * TP * 4;  // s_idx, and s_wgt

template <typename T>
struct Geom {
  static constexpr int VEC = 16 / sizeof(T);        // channels a 16-byte load
  static constexpr int CK = ROW_BYTES / sizeof(T);  // channels a K chunk
  static constexpr int SA = CK + VEC;               // A row stride (elements)
};

template <typename T, int BN>
constexpr int smem_bytes() {
  return 2 * CORNER_BYTES +
         2 * (TP * Geom<T>::SA + Geom<T>::CK * (BN + 8)) * (int)sizeof(T);
}

template <typename T, int BN>
__global__ void __launch_bounds__(THREADS, BN == 256 ? 1 : 2)
dcn_fwd_kernel(const T* __restrict__ x,        // (B, H, W, C)
               const float* __restrict__ off,  // (B, H, W, 18) (dy, dx)
               const float* __restrict__ mask, // (B, H, W, 9)
               const T* __restrict__ w,        // (9, C, Cout)
               const T* __restrict__ bias,     // (Cout,)
               T* __restrict__ out,            // (B, H, W, Cout)
               float* __restrict__ ws,         // (splits, B*H*W, Cout) or null
               int npix, int H, int W, int C, int Cout, int clamp, float R,
               int vec_x, int vec_w) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int VEC = Geom<T>::VEC, CK = Geom<T>::CK, SA = Geom<T>::SA;
  constexpr int SB = BN + 8;           // B row stride (elements)
  constexpr int WN = BN / 4;           // a warp's channels
  constexpr int NT = WN / 8;           // its n8 tiles
  constexpr int A_STAGE = TP * SA;     // elements
  constexpr int B_STAGE = CK * SB;

  extern __shared__ __align__(128) unsigned char smem[];
  int(*s_idx)[4][TP] = reinterpret_cast<int(*)[4][TP]>(smem);
  float(*s_wgt)[4][TP] =
      reinterpret_cast<float(*)[4][TP]>(smem + CORNER_BYTES);
  T* sA = reinterpret_cast<T*>(smem + 2 * CORNER_BYTES);
  T* sB = sA + 2 * A_STAGE;

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * TP;
  const int n0 = blockIdx.y * BN;
  const int cpt = (C + CK - 1) / CK;  // chunks a tap
  const long long kchunks = 9LL * cpt;
  const int kc_begin = (int)(blockIdx.z * kchunks / gridDim.z);
  const int kc_end = (int)((blockIdx.z + 1) * kchunks / gridDim.z);
  const int tap_lo = kc_begin / cpt;
  const int ntaps = (kc_end - 1) / cpt - tap_lo + 1;

  // corner indices and weights of every (tap, pixel) of the K range
  for (int e = tid; e < ntaps * TP; e += THREADS) {
    const int kt = e / TP;
    const int k = tap_lo + kt;
    const int p = e % TP;
    const int n = p0 + p;
    int id[4] = {-1, -1, -1, -1};
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    if (n < npix) {
      float fy, fx;
      tap_corners(n, k, off[(size_t)n * 18 + 2 * k],
                  off[(size_t)n * 18 + 2 * k + 1], H, W, clamp, R, id, fy, fx);
      bilinear(fy, fx, mask[(size_t)n * 9 + k], wt);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s_idx[kt][q][p] = id[q];
      s_wgt[kt][q][p] = wt[q];
    }
  }
  __syncthreads();

  // the gather: thread -> 16-byte group `grp` of pixel rows prow, prow + 32
  const int grp = tid & 7;
  const int prow = tid >> 3;

  // issue the 8 corner loads of chunk kc into registers
  auto load_x = [&](int kc, uint4 (&raw)[2][4]) {
    const int tap = kc / cpt;
    const int c = (kc - tap * cpt) * CK + grp * VEC;
    const int kt = tap - tap_lo;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = prow + 32 * h;
      const int id[4] = {s_idx[kt][0][p], s_idx[kt][1][p], s_idx[kt][2][p],
                         s_idx[kt][3][p]};
      load_corners(x, id, c, C, vec_x, raw[h]);
    }
  };

  // blend the corners of chunk kc in f32 and store the modulated samples,
  // rounded once to T, into the A tile
  auto store_a = [&](int kc, const uint4 (&raw)[2][4], T* As) {
    const int tap = kc / cpt;
    const int c = (kc - tap * cpt) * CK + grp * VEC;
    const int kt = tap - tap_lo;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = prow + 32 * h;
      const int id[4] = {s_idx[kt][0][p], s_idx[kt][1][p], s_idx[kt][2][p],
                         s_idx[kt][3][p]};
      const float wq[4] = {s_wgt[kt][0][p], s_wgt[kt][1][p], s_wgt[kt][2][p],
                           s_wgt[kt][3][p]};
      float v[VEC];
      blend<T>(raw[h], id, wq, c, C, v);
      *reinterpret_cast<uint4*>(As + p * SA + grp * VEC) = pack(v);
    }
  };

  // W_k[c0:c0+CK, n0:n0+BN] into a B stage, zero outside Cin x Cout
  auto stage_w = [&](int kc, T* Bs) {
    const int tap = kc / cpt;
    const int c0 = (kc - tap * cpt) * CK;
    if (vec_w) {
      constexpr int GPR = BN / VEC;  // 16-byte groups a row
      for (int e = tid; e < CK * GPR; e += THREADS) {
        const int r = e / GPR;
        const int o = n0 + (e % GPR) * VEC;
        const bool ok = c0 + r < C && o < Cout;
        cp_async16(Bs + r * SB + (e % GPR) * VEC,
                   ok ? w + ((size_t)tap * C + c0 + r) * Cout + o : w, ok);
      }
      cp_async_commit();
    } else {
      for (int e = tid; e < CK * BN; e += THREADS) {
        const int r = e / BN;
        const int o = n0 + e % BN;
        Bs[r * SB + e % BN] = c0 + r < C && o < Cout
                                  ? w[((size_t)tap * C + c0 + r) * Cout + o]
                                  : from_f32<T>(0.f);
      }
    }
  };

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp & 1;   // pixels wm*32 .. +32
  const int wn = warp >> 1;  // channels wn*WN .. +WN of the tile
  const int g = lane >> 2;
  const int t = lane & 3;
  float acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < NT; ++nj)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][nj][i] = 0.f;

  // acc += A (TP x CK) B (CK x BN) on the tensor cores
  auto mma_chunk = [&](const T* As, const T* Bs) {
    if constexpr (BF16) {
#pragma unroll
      for (int ks = 0; ks < CK / 16; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4(a[mi], As + (wm * 32 + mi * 16 + (lane & 15)) * SA +
                                 ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nj = 0; nj < NT; nj += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, Bs + (ks * 16 + (lane & 15)) * SB + wn * WN +
                                   nj * 8 + (lane >> 4) * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16(acc[mi][nj], a[mi], b[0], b[1]);
            mma_bf16(acc[mi][nj + 1], a[mi], b[2], b[3]);
          }
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < CK / 8; ++ks) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float* a = As + (wm * 32 + mi * 16 + g) * SA + ks * 8 + t;
          split_tf32(a[0], ah[mi][0], al[mi][0]);
          split_tf32(a[8 * SA], ah[mi][1], al[mi][1]);
          split_tf32(a[4], ah[mi][2], al[mi][2]);
          split_tf32(a[8 * SA + 4], ah[mi][3], al[mi][3]);
        }
#pragma unroll
        for (int nj = 0; nj < NT; ++nj) {
          const float* b = Bs + (ks * 8 + t) * SB + wn * WN + nj * 8 + g;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(b[0], bh0, bl0);
          split_tf32(b[4 * SB], bh1, bl1);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            mma_3xtf32(acc[mi][nj], ah[mi], al[mi], bh0, bh1, bl0, bl1);
        }
      }
    }
  };

  // the two-stage ring: chunk kc+1 is loaded and staged around chunk kc's
  // products; one barrier a chunk
  uint4 raw[2][4];
  load_x(kc_begin, raw);
  stage_w(kc_begin, sB);
  store_a(kc_begin, raw, sA);
  cp_async_wait_all();
  __syncthreads();
  for (int kc = kc_begin; kc < kc_end; ++kc) {
    const int s = (kc - kc_begin) & 1;
    const bool more = kc + 1 < kc_end;
    if (more) {
      load_x(kc + 1, raw);
      stage_w(kc + 1, sB + (s ^ 1) * B_STAGE);
    }
    mma_chunk(sA + s * A_STAGE, sB + s * B_STAGE);
    if (more) store_a(kc + 1, raw, sA + (s ^ 1) * A_STAGE);
    cp_async_wait_all();
    __syncthreads();
  }

  // epilogue: bias and cast (one split), or this split's f32 partial sums
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int n = p0 + wm * 32 + mi * 16 + g + 8 * hf;
      if (n >= npix) continue;
#pragma unroll
      for (int nj = 0; nj < NT; ++nj) {
        const int o = n0 + wn * WN + nj * 8 + 2 * t;
        const float v0 = acc[mi][nj][2 * hf];
        const float v1 = acc[mi][nj][2 * hf + 1];
        if (ws != nullptr) {
          store_pair(ws + ((size_t)blockIdx.z * npix + n) * Cout, o, Cout, v0,
                     v1);
        } else {
          const float b0 = o < Cout ? to_f32(bias[o]) : 0.f;
          const float b1 = o + 1 < Cout ? to_f32(bias[o + 1]) : 0.f;
          store_pair(out + (size_t)n * Cout, o, Cout, v0 + b0, v1 + b1);
        }
      }
    }
}

// out = sum over splits, in split order, of the partial sums, + bias
template <typename T>
__global__ void __launch_bounds__(256)
dcn_fwd_reduce(const float* __restrict__ ws, const T* __restrict__ bias,
               T* __restrict__ out, long long total, int Cout, int splits) {
  const long long e0 = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (e0 >= total) return;
  float s[4];
  if ((total & 3) == 0) {  // 16-byte aligned slices
    const float4 v = *reinterpret_cast<const float4*>(ws + e0);
    s[0] = v.x, s[1] = v.y, s[2] = v.z, s[3] = v.w;
    for (int k = 1; k < splits; ++k) {
      const float4 u = *reinterpret_cast<const float4*>(ws + k * total + e0);
      s[0] += u.x, s[1] += u.y, s[2] += u.z, s[3] += u.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i] = 0.f;
      if (e0 + i < total)
        for (int k = 0; k < splits; ++k) s[i] += ws[k * total + e0 + i];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (e0 + i < total)
      out[e0 + i] = from_f32<T>(s[i] + to_f32(bias[(e0 + i) % Cout]));
}

template <typename T, int BN>
int launch(const void* x, const void* off, const void* mask, const void* w,
           const void* bias, void* out, float* ws, int npix, int H, int W,
           int C, int Cout, int clamp, float R, int splits,
           cudaStream_t stream) {
  constexpr int VEC = Geom<T>::VEC;
  constexpr int smem = smem_bytes<T, BN>();
  // above 48 KB of dynamic shared memory a launch is refused unless the
  // kernel allows it, once per device (not again while a graph captures)
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !allowed[dev]) {
    err = cudaFuncSetAttribute(dcn_fwd_kernel<T, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) allowed[dev] = true;
  }
  const int vec_x = C % VEC == 0 && ((uintptr_t)x & 15) == 0;
  const int vec_w = Cout % VEC == 0 && ((uintptr_t)w & 15) == 0;
  const dim3 grid((npix + TP - 1) / TP, (Cout + BN - 1) / BN, splits);
  dcn_fwd_kernel<T, BN><<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const float*)off, (const float*)mask, (const T*)w,
      (const T*)bias, (T*)out, splits > 1 ? ws : nullptr, npix, H, W, C,
      Cout, clamp, R, vec_x, vec_w);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long total = (long long)npix * Cout;
  dcn_fwd_reduce<T><<<(unsigned)((total + 1023) / 1024), 256, 0, stream>>>(
      ws, (const T*)bias, (T*)out, total, Cout, splits);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bn(const void* x, const void* off, const void* mask, const void* w,
              const void* bias, void* out, float* ws, int npix, int H, int W,
              int C, int Cout, int clamp, float R, int bn, int splits,
              cudaStream_t stream) {
  if (bn == 64)
    return launch<T, 64>(x, off, mask, w, bias, out, ws, npix, H, W, C, Cout,
                         clamp, R, splits, stream);
  if (bn == 128)
    return launch<T, 128>(x, off, mask, w, bias, out, ws, npix, H, W, C,
                          Cout, clamp, R, splits, stream);
  return launch<T, 256>(x, off, mask, w, bias, out, ws, npix, H, W, C, Cout,
                        clamp, R, splits, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, bias and out share it).
// clamp: 0 = exact sampling, 1 = y-offsets clamped to [-R, R], 2 = both
// axes clamped to [-R, R].  bn: the output-channel tile, 64, 128 or 256.
// splits: K ranges, 1 .. 9 * ceil(C / CK); with more than one, ws holds
// splits * B*H*W * Cout f32 partial sums and a second kernel reduces them.
// Another value of any of these is refused (cudaErrorInvalidValue).
// Returns cudaGetLastError() after the launches (0 = cudaSuccess).
extern "C" int dcn_fwd(const void* x, const void* off, const void* mask,
                       const void* w, const void* bias, void* out, void* ws,
                       int B, int H, int W, int C, int Cout, int dtype,
                       int clamp, float R, int bn, int splits, void* stream) {
  const int ck = dtype == 1 ? Geom<__nv_bfloat16>::CK : Geom<float>::CK;
  if (clamp < CLAMP_NONE || clamp > CLAMP_XY || (dtype != 0 && dtype != 1) ||
      (bn != 64 && bn != 128 && bn != 256) || C <= 0 || splits < 1 ||
      splits > 9 * ((C + ck - 1) / ck) || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int npix = B * H * W;
  if (npix <= 0 || Cout <= 0) return (int)cudaGetLastError();
  if (dtype == 1)
    return launch_bn<__nv_bfloat16>(x, off, mask, w, bias, out, (float*)ws,
                                    npix, H, W, C, Cout, clamp, R, bn, splits,
                                    (cudaStream_t)stream);
  return launch_bn<float>(x, off, mask, w, bias, out, (float*)ws, npix, H, W,
                          C, Cout, clamp, R, bn, splits, (cudaStream_t)stream);
}
