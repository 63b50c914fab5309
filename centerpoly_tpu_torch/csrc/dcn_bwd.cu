// DCNv2 backward (modulated deformable 3x3 conv, stride 1, zero padding), v2.
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
// (_dc_bwd).  Two kernels with a clamp mode (none / y / xy) compute what
// they compute, not how: the band tensor, the one-hot column matrices B2
// and the D shifted slice-adds of kernel #3, and the (2R+3)^2 rolls and
// reverse rolls of the halo sweeps, exist only because Mosaic could not
// gather or scatter; on Hopper each tap's four bilinear corners are read
// directly and dx is a scatter-add with f32 atomics.
//
// For the cotangent g (npix, Cout), per (pixel, tap k), with the corners
// at the offsets clamped exactly as csrc/dcn_fwd.cu clamps them:
//   gk_c     = sum_o g_o W_k[c, o]                (dcn_rowband.py:309)
//   S_c      = sum_q w_q x[corner_q, c]           (unmodulated sample)
//   dmask    = sum_c gk_c S_c
//   d oy     = m sum_c gk_c [(1-fx)(x10-x00) + fx (x11-x01)]
//   d ox     = m sum_c gk_c [(1-fy)(x01-x00) + fy (x11-x10)]
//   dx[corner_q, c] += m w_q gk_c                 (f32 atomics)
//   dW_k     = sum_pixels (m S)^T g               (dcn_rowband.py:353)
// Out-of-image corners read as 0.  fy, fx are the fractions of floor():
// at an integer position the derivative is that of the floor cell (the
// hat derivative is -1 there, not 0, dcn_rowband.py:246-253), which is
// what autodiff of the JAX oracle gives and the one-sided hat derivative
// of the halo sweeps (dcn_halo.py:207-222).  The corner differences are
// taken in f32 from the raw corners, not from the blended sample.  The
// clamp's pass-through (1 / 0.5 at +-R / 0 beyond on y for rowband; 0 at
// |o| >= R on both axes for halo, dcn_halo.py:442-450) and db = sum g are
// applied by the caller (kernels/dcn.py).
//
// What bounds it on an H100 SXM (the 16 DLA-34 nodes of a train step,
// 512x1024, batch 4, f32; chip_smoke.py::bwd_bound_tf32_ms): the two
// products gk and dW, 4 npix 9 Cin Cout operations, at the TF32 rate of
// 495 TFLOP/s (each product counted once; 3xTF32 issues three), the ~32
// operations per (pixel, tap, channel) for the corners, the three sums
// and the four scatter products at 67 TFLOP/s on the f32 units, which run
// beside the tensor cores, and the bytes (0.324 ms): at least 0.459 ms a
// step, the largest of the three, bound by operations (0.788 ms with the
// two operation times added).  Counted on the f32 CUDA cores alone, as v1
// ran its products (cuBLAS f32 GEMMs), the bound is 3.7185 ms
// (chip_smoke.py::bwd_bound_ms).
//
// Design, against the four things that held v1 (a SIMT warp per (pixel,
// tap) beside two f32 cuBLAS GEMMs; 15.8-19.7 ms a step of eager calls):
//   1. v1 wrote gk = g W^T (cuBLAS) and the samples to two (npix, 9 Cin)
//      f32 buffers, modulated the samples in place and read them again for
//      dW: six passes over 302 MB at the 128x256x64 node, more than the
//      whole backward's bound.  v2 keeps gk in shared memory one chunk at a
//      time and the modulated samples one pixel tile at a time: no such
//      buffer exists.
//   2. v1's products ran on the f32 CUDA cores (training turns TF32 off).
//      v2 runs both on the tensor cores with mma.sync, as dcn_fwd v3 does:
//      bf16 operands with f32 accumulators, or 3xTF32 in f32 (f32
//      accuracy: hi*lo + lo*hi + hi*hi of masked splits).
//   3. v1 gathered channel by channel with scalar loads, staged nothing and
//      ended every channel in four scalar atomics.  v2 gathers 16 bytes a
//      thread per corner row (the select after the load), stages g and W
//      by cp.async into padded tiles whose fragment loads hit 32 banks,
//      and scatters dx 16 bytes an atomic (sm_90's float4 atomicAdd).
//   4. v1 was timed by eager wrapper calls; chip_smoke.py times v2 by CUDA
//      graph replay (device time), as it does the forward.
// The two kernels:
//   * dcn_bwd_data (dx, d offsets, d masks): a block owns 64 pixels and a
//     range of taps (the grid's y axis cuts the 9 taps into ranges where
//     the pixel tiles alone do not fill the card; each (pixel, tap) still
//     belongs to one block, so no sum crosses blocks).  It computes its
//     corners once, stages its rows of g for a slab of up to 128 output
//     channels, then walks (tap, channel chunk of 128 bytes): gk = g_tile
//     W_k[chunk]^T on the tensor cores into shared memory (the B operand
//     W_k[c][o] is already "col" for row.col, so bf16 loads it with
//     ldmatrix, no .trans), then each thread takes the four corner rows of
//     two pixels, sums its share of dmask, d oy, d ox in f32 from the raw
//     corners and scatters m w_q gk into dx for the corners inside the
//     image with a nonzero weight.  The next chunk's W slice comes in by
//     cp.async and its corner loads go out while this chunk is contracted
//     (two-stage ring).  A tap's sums are reduced over the 8 threads of a
//     pixel by shuffles and kept in shared memory; dmask and d offsets are
//     written once.  Wider Cout walks slabs of 128, each adding its share
//     in slab order.  dx stays a scatter with f32 atomics (~36 adds land on
//     each element), so its last bits may differ from call to call; dmask
//     and d offsets are summed in a fixed order and are bit-equal.
//   * dcn_bwd_weight (dW): a block owns (tap k, 64 input channels, Cout
//     tile of 64 / 128 / 256) and runs over a contiguous range of 64-pixel
//     tiles: it gathers the modulated sample tile m S_k (64 pixels x 64
//     channels) with the forward's gather and blend (dcn_tile.cuh), stages
//     the g tile by cp.async, and accumulates (m S_k)^T g with the pixels
//     as the contraction; the A operand is read transposed (ldmatrix.trans
//     in bf16; scalar loads in TF32 from rows padded to 8 words mod 32, so
//     they hit 32 banks).  64 channels a block, not the forward's 128
//     bytes, halve the re-reads of g (it is read once per (tap, channel
//     block)).  The corners of the next tile but one are computed, and the
//     offsets of the tile after, while this tile is contracted, into
//     shared memory, so the registers hold only the in-flight corner rows.
//     The output tiles number 9 ceil(Cin/64) ceil(Cout/BN), under one wave
//     at most nodes, so kernels/dcn.py::bwd_plan splits the pixels into
//     ranges until the grid holds 4 blocks an SM; each split writes its
//     f32 partial dW to its own workspace slice and dcn_bwd_reduce adds
//     them in split order and casts: dW is bit-equal from call to call.
// Measured on the H100 (PERF.md): the gathers, four 16-byte corner
// rows per sample served by L1/L2, set the time of each kernel much as
// they set the forward's; the dx scatter is ~14 % of dcn_bwd_data.  One
// gather shared by both products (per-block dmask / d offset partials in
// a small workspace) is the next step.
//
// Plain C interface, bound from Python with ctypes
// (centerpoly_tpu_torch/kernels/dcn.py).  Pointers are device pointers;
// the kernels run on the caller's stream and allocate nothing; dx must be
// zeroed by the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dcn_tile.cuh"

namespace {

using namespace dcn_tile;

constexpr int TP = 64;          // pixels a tile
constexpr int THREADS = 256;    // 8 warps
constexpr int ROW_BYTES = 128;  // one pixel's channels of a channel chunk
constexpr int SLAB = 128;       // output channels of dcn_bwd_data's g slab
constexpr int MAX_TAPS = 9;
constexpr int IDX_BYTES = MAX_TAPS * 4 * TP * 4;  // corner indices
constexpr int TAP_BYTES = MAX_TAPS * 3 * TP * 4;  // 3 floats a (tap, pixel)
constexpr int WCK = 64;  // dcn_bwd_weight's channels a block (its M)
constexpr int META_BYTES = 2 * 4 * TP * 4;  // corner indices or weights

template <typename T>
struct Geom {
  static constexpr int VEC = 16 / sizeof(T);        // channels a 16-byte load
  static constexpr int CK = ROW_BYTES / sizeof(T);  // channels a chunk
};

// dcn_bwd_data's slab of output channels: Cout rounded up to whole
// 128-byte rows, at most SLAB
template <typename T>
__host__ __device__ int data_slab(int Cout) {
  constexpr int CK = Geom<T>::CK;
  const int bo = (Cout + CK - 1) / CK * CK;
  return bo < SLAB ? bo : SLAB;
}

template <typename T>
int data_smem_bytes(int bo) {
  constexpr int CK = Geom<T>::CK, VEC = Geom<T>::VEC;
  return IDX_BYTES + 2 * TAP_BYTES + TP * (CK + 4) * 4 +
         (TP + 2 * CK) * (bo + VEC) * (int)sizeof(T);
}

// 16 bytes of f32 into dx by one atomic (float4 atomicAdd, sm_90)
__device__ __forceinline__ void add4(float* p, float a, float b, float c,
                                     float d) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
dcn_bwd_data(const T* __restrict__ x,        // (B, H, W, C)
             const float* __restrict__ off,  // (B, H, W, 18) raw (dy, dx)
             const float* __restrict__ mask, // (B, H, W, 9)
             const T* __restrict__ w,        // (9, C, Cout)
             const T* __restrict__ g,        // (B, H, W, Cout)
             float* __restrict__ dx,         // (B, H, W, C), zeroed
             float* __restrict__ doff,       // (B, H, W, 18)
             float* __restrict__ dmask,      // (B, H, W, 9)
             int npix, int H, int W, int C, int Cout, int clamp, float R,
             int vec_x, int vec_w, int vec_g) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int VEC = Geom<T>::VEC, CK = Geom<T>::CK;
  constexpr int SK = CK + 4;   // gk row stride (f32)
  constexpr int WNC = CK / 2;  // a warp's channels of gk
  constexpr int NT = WNC / 8;  // its n8 tiles
  const int BO = data_slab<T>(Cout);
  const int SO = BO + VEC;     // g and W row stride (elements)
  const int W_STAGE = CK * SO;

  extern __shared__ __align__(128) unsigned char smem[];
  int(*s_idx)[4][TP] = reinterpret_cast<int(*)[4][TP]>(smem);
  // fy, fx, m of each (tap, pixel), and its dmask, d oy, d ox sums
  float(*s_tap)[3][TP] = reinterpret_cast<float(*)[3][TP]>(smem + IDX_BYTES);
  float(*s_acc)[3][TP] =
      reinterpret_cast<float(*)[3][TP]>(smem + IDX_BYTES + TAP_BYTES);
  float* s_gk = reinterpret_cast<float*>(smem + IDX_BYTES + 2 * TAP_BYTES);
  T* sG = reinterpret_cast<T*>(s_gk + TP * SK);
  T* sW = sG + TP * SO;

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * TP;
  const int tap_lo = blockIdx.y * MAX_TAPS / gridDim.y;
  const int tap_hi = (blockIdx.y + 1) * MAX_TAPS / gridDim.y;
  const int ntaps = tap_hi - tap_lo;
  const int cpt = (C + CK - 1) / CK;  // chunks a tap
  const int kc_begin = tap_lo * cpt;
  const int kc_end = tap_hi * cpt;

  // corners, fractions and mask of every (tap, pixel) of the block
  for (int e = tid; e < ntaps * TP; e += THREADS) {
    const int kt = e / TP;
    const int k = tap_lo + kt;
    const int p = e % TP;
    const int n = p0 + p;
    int id[4] = {-1, -1, -1, -1};
    float fy = 0.f, fx = 0.f, m = 0.f;
    if (n < npix) {
      tap_corners(n, k, off[(size_t)n * 18 + 2 * k],
                  off[(size_t)n * 18 + 2 * k + 1], H, W, clamp, R, id, fy, fx);
      m = mask[(size_t)n * 9 + k];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) s_idx[kt][q][p] = id[q];
    s_tap[kt][0][p] = fy;
    s_tap[kt][1][p] = fx;
    s_tap[kt][2][p] = m;
#pragma unroll
    for (int i = 0; i < 3; ++i) s_acc[kt][i][p] = 0.f;
  }
  __syncthreads();

  // the gather: thread -> 16-byte group `grp` of pixel rows prow, prow + 32
  const int grp = tid & 7;
  const int prow = tid >> 3;

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

  // rows p0.. of g, output channels o0..o0+BO, zero outside npix x Cout
  auto stage_g = [&](int o0) {
    if (vec_g) {
      const int gpr = BO / VEC;  // 16-byte groups a row
      for (int e = tid; e < TP * gpr; e += THREADS) {
        const int r = e / gpr;
        const int o = o0 + (e % gpr) * VEC;
        const bool ok = p0 + r < npix && o < Cout;
        cp_async16(sG + r * SO + (e % gpr) * VEC,
                   ok ? g + (size_t)(p0 + r) * Cout + o : g, ok);
      }
      cp_async_commit();
    } else {
      for (int e = tid; e < TP * BO; e += THREADS) {
        const int r = e / BO;
        const int o = o0 + e % BO;
        sG[r * SO + e % BO] = p0 + r < npix && o < Cout
                                  ? g[(size_t)(p0 + r) * Cout + o]
                                  : from_f32<T>(0.f);
      }
    }
  };

  // W_k[c0:c0+CK, o0:o0+BO] into a W stage, zero outside Cin x Cout
  auto stage_w = [&](int kc, int o0, T* Ws) {
    const int tap = kc / cpt;
    const int c0 = (kc - tap * cpt) * CK;
    if (vec_w) {
      const int gpr = BO / VEC;
      for (int e = tid; e < CK * gpr; e += THREADS) {
        const int r = e / gpr;
        const int o = o0 + (e % gpr) * VEC;
        const bool ok = c0 + r < C && o < Cout;
        cp_async16(Ws + r * SO + (e % gpr) * VEC,
                   ok ? w + ((size_t)tap * C + c0 + r) * Cout + o : w, ok);
      }
      cp_async_commit();
    } else {
      for (int e = tid; e < CK * BO; e += THREADS) {
        const int r = e / BO;
        const int o = o0 + e % BO;
        Ws[r * SO + e % BO] = c0 + r < C && o < Cout
                                  ? w[((size_t)tap * C + c0 + r) * Cout + o]
                                  : from_f32<T>(0.f);
      }
    }
  };

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp & 3;   // pixels wm*16 .. +16
  const int wn = warp >> 2;  // channels wn*WNC .. +WNC of the chunk
  const int gq = lane >> 2;
  const int t = lane & 3;

  // gk (TP x CK) = g tile (TP x BO) W stage^T on the tensor cores, into
  // s_gk
  auto gk_chunk = [&](const T* Ws) {
    float acc[NT][4];
#pragma unroll
    for (int nj = 0; nj < NT; ++nj)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nj][i] = 0.f;
    if constexpr (BF16) {
      const int j = lane >> 3;
      for (int ks = 0; ks < BO / 16; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, sG + (wm * 16 + (lane & 15)) * SO + ks * 16 +
                           (lane >> 4) * 8);
#pragma unroll
        for (int nj = 0; nj < NT; nj += 2) {
          // rows n of W_k[c][o] are B's columns: no .trans
          uint32_t b[4];
          ldmatrix_x4(b, Ws + (wn * WNC + nj * 8 + (j >> 1) * 8 + (lane & 7)) *
                                  SO +
                             ks * 16 + (j & 1) * 8);
          mma_bf16(acc[nj], a, b[0], b[1]);
          mma_bf16(acc[nj + 1], a, b[2], b[3]);
        }
      }
    } else {
      for (int ks = 0; ks < BO / 8; ++ks) {
        uint32_t ah[4], al[4];
        const float* a = sG + (wm * 16 + gq) * SO + ks * 8 + t;
        split_tf32(a[0], ah[0], al[0]);
        split_tf32(a[8 * SO], ah[1], al[1]);
        split_tf32(a[4], ah[2], al[2]);
        split_tf32(a[8 * SO + 4], ah[3], al[3]);
#pragma unroll
        for (int nj = 0; nj < NT; ++nj) {
          const float* b = Ws + (wn * WNC + nj * 8 + gq) * SO + ks * 8 + t;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(b[0], bh0, bl0);
          split_tf32(b[4], bh1, bl1);
          mma_3xtf32(acc[nj], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }
#pragma unroll
    for (int nj = 0; nj < NT; ++nj) {
      float* row = s_gk + (wm * 16 + gq) * SK + wn * WNC + nj * 8 + 2 * t;
      *reinterpret_cast<float2*>(row) = make_float2(acc[nj][0], acc[nj][1]);
      *reinterpret_cast<float2*>(row + 8 * SK) =
          make_float2(acc[nj][2], acc[nj][3]);
    }
  };

  // this thread's partial dmask, d oy, d ox sums of its two pixels
  float am[2] = {0.f, 0.f}, ay[2] = {0.f, 0.f}, ax[2] = {0.f, 0.f};

  // chunk kc's corners against its gk: the three sums and the dx scatter
  auto consume = [&](int kc, const uint4 (&raw)[2][4]) {
    const int tap = kc / cpt;
    const int c = (kc - tap * cpt) * CK + grp * VEC;
    const int kt = tap - tap_lo;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = prow + 32 * h;
      const int id[4] = {s_idx[kt][0][p], s_idx[kt][1][p], s_idx[kt][2][p],
                         s_idx[kt][3][p]};
      const float fy = s_tap[kt][0][p];
      const float fx = s_tap[kt][1][p];
      const float m = s_tap[kt][2][p];
      float cw[4];
      bilinear(fy, fx, 1.f, cw);
      float gk[VEC];
#pragma unroll
      for (int j = 0; j < VEC; j += 4) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(s_gk + p * SK + grp * VEC + j);
        gk[j] = v4.x, gk[j + 1] = v4.y, gk[j + 2] = v4.z, gk[j + 3] = v4.w;
      }
      float v[4][VEC];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        unpack(raw[h][q], v[q]);
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          if (id[q] < 0 || c + j >= C) v[q][j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float s = cw[0] * v[0][j] + cw[1] * v[1][j] + cw[2] * v[2][j] +
                        cw[3] * v[3][j];
        am[h] = fmaf(gk[j], s, am[h]);
        ay[h] = fmaf(gk[j],
                     (1.f - fx) * (v[2][j] - v[0][j]) +
                         fx * (v[3][j] - v[1][j]),
                     ay[h]);
        ax[h] = fmaf(gk[j],
                     (1.f - fy) * (v[1][j] - v[0][j]) +
                         fy * (v[3][j] - v[2][j]),
                     ax[h]);
        gk[j] *= m;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (id[q] < 0 || cw[q] == 0.f) continue;
        float* row = dx + (size_t)id[q] * C;
        if (vec_x) {
          if (c < C) {
#pragma unroll
            for (int j = 0; j < VEC; j += 4)
              add4(row + c + j, gk[j] * cw[q], gk[j + 1] * cw[q],
                   gk[j + 2] * cw[q], gk[j + 3] * cw[q]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            if (c + j < C) atomicAdd(row + c + j, gk[j] * cw[q]);
        }
      }
    }
    if (kc - tap * cpt == cpt - 1) {  // the tap's last chunk
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int s = 1; s < 8; s <<= 1) {
          am[h] += __shfl_xor_sync(0xffffffffu, am[h], s);
          ay[h] += __shfl_xor_sync(0xffffffffu, ay[h], s);
          ax[h] += __shfl_xor_sync(0xffffffffu, ax[h], s);
        }
        if (grp == 0) {
          const int p = prow + 32 * h;
          s_acc[kt][0][p] += am[h];
          s_acc[kt][1][p] += ay[h];
          s_acc[kt][2][p] += ax[h];
        }
        am[h] = ay[h] = ax[h] = 0.f;
      }
    }
  };

  // per slab: the two-stage ring over the chunks, chunk kc+1's W slice and
  // corner loads in flight while chunk kc is contracted
  uint4 raw[2][4];
  for (int o0 = 0; o0 < Cout; o0 += BO) {
    stage_g(o0);
    load_x(kc_begin, raw);
    stage_w(kc_begin, o0, sW);
    cp_async_wait_all();
    __syncthreads();
    for (int kc = kc_begin; kc < kc_end; ++kc) {
      const int s = (kc - kc_begin) & 1;
      const bool more = kc + 1 < kc_end;
      if (more) stage_w(kc + 1, o0, sW + (s ^ 1) * W_STAGE);
      gk_chunk(sW + s * W_STAGE);
      __syncthreads();
      consume(kc, raw);
      if (more) load_x(kc + 1, raw);
      cp_async_wait_all();
      __syncthreads();
    }
  }

  for (int e = tid; e < ntaps * TP; e += THREADS) {
    const int kt = e / TP;
    const int k = tap_lo + kt;
    const int p = e % TP;
    const int n = p0 + p;
    if (n >= npix) continue;
    const float m = s_tap[kt][2][p];
    dmask[(size_t)n * 9 + k] = s_acc[kt][0][p];
    doff[(size_t)n * 18 + 2 * k] = m * s_acc[kt][1][p];
    doff[(size_t)n * 18 + 2 * k + 1] = m * s_acc[kt][2][p];
  }
}

template <typename T, int BN>
constexpr int weight_smem_bytes() {
  return 2 * TP * (WCK + 8 + BN + 8) * (int)sizeof(T) + 2 * META_BYTES;
}

template <typename T, int BN>
__global__ void __launch_bounds__(THREADS, BN == 256 ? 1 : 2)
dcn_bwd_weight(const T* __restrict__ x,        // (B, H, W, C)
               const float* __restrict__ off,  // (B, H, W, 18) raw (dy, dx)
               const float* __restrict__ mask, // (B, H, W, 9)
               const T* __restrict__ g,        // (B, H, W, Cout)
               T* __restrict__ dw,             // (9, C, Cout)
               float* __restrict__ ws,         // (splits, 9, C, Cout) or null
               int npix, int H, int W, int C, int Cout, int clamp, float R,
               int vec_x, int vec_g) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int VEC = Geom<T>::VEC;
  constexpr int GROUPS = WCK / VEC;      // 16-byte groups of a pixel's row
  constexpr int RPP = THREADS / GROUPS;  // pixel rows a pass
  constexpr int PASSES = TP / RPP;       // passes over the tile (2 or 4)
  constexpr int SA = WCK + 8;  // A row stride: [pixel][channel]
  constexpr int SB = BN + 8;   // B row stride: [pixel][output channel]
  constexpr int MI = WCK / 32; // a warp's m16 tiles (channels)
  constexpr int WN = BN / 4;   // a warp's output channels
  constexpr int NT = WN / 8;   // its n8 tiles
  constexpr int A_STAGE = TP * SA;
  constexpr int B_STAGE = TP * SB;

  extern __shared__ __align__(128) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = sA + 2 * A_STAGE;
  // corner indices and modulated weights of a tile's pixels, two stages
  int(*s_id)[4][TP] = reinterpret_cast<int(*)[4][TP]>(sB + 2 * B_STAGE);
  float(*s_w)[4][TP] =
      reinterpret_cast<float(*)[4][TP]>(smem + 2 * TP * (SA + SB) *
                                                   (int)sizeof(T) +
                                        META_BYTES);

  const int tid = threadIdx.x;
  const int cpt = (C + WCK - 1) / WCK;
  const int tap = blockIdx.x / cpt;
  const int c0 = (blockIdx.x % cpt) * WCK;
  const int n0 = blockIdx.y * BN;
  const int m_tiles = (npix + TP - 1) / TP;
  const int t_begin = (int)((long long)blockIdx.z * m_tiles / gridDim.z);
  const int t_end = (int)((long long)(blockIdx.z + 1) * m_tiles / gridDim.z);

  // the gather: thread -> 16-byte group `grp` of pixel rows prow + RPP h
  const int grp = tid % GROUPS;
  const int prow = tid / GROUPS;
  const int c = c0 + grp * VEC;

  // thread p < TP: the raw offsets and mask of pixel p of a tile, fetched
  // two tiles ahead, and its corners and weights one tile ahead
  float po[3] = {0.f, 0.f, 0.f};
  auto fetch = [&](int tile) {
    const int n = tile * TP + tid;
    if (tid < TP && tile < t_end && n < npix) {
      po[0] = off[(size_t)n * 18 + 2 * tap];
      po[1] = off[(size_t)n * 18 + 2 * tap + 1];
      po[2] = mask[(size_t)n * 9 + tap];
    }
  };
  auto corners = [&](int tile, int st) {
    const int n = tile * TP + tid;
    if (tid >= TP) return;
    int id[4] = {-1, -1, -1, -1};
    float wq[4] = {0.f, 0.f, 0.f, 0.f};
    if (tile < t_end && n < npix) {
      float fy, fx;
      tap_corners(n, tap, po[0], po[1], H, W, clamp, R, id, fy, fx);
      bilinear(fy, fx, po[2], wq);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s_id[st][q][tid] = id[q];
      s_w[st][q][tid] = wq[q];
    }
  };

  auto load_x = [&](int st, uint4 (&raw)[PASSES][4]) {
#pragma unroll
    for (int h = 0; h < PASSES; ++h) {
      const int p = prow + RPP * h;
      const int id[4] = {s_id[st][0][p], s_id[st][1][p], s_id[st][2][p],
                         s_id[st][3][p]};
      load_corners(x, id, c, C, vec_x, raw[h]);
    }
  };

  // the modulated samples m S, blended in f32 and rounded once to T, as
  // the forward's A tile
  auto store_a = [&](int st, const uint4 (&raw)[PASSES][4], T* As) {
#pragma unroll
    for (int h = 0; h < PASSES; ++h) {
      const int p = prow + RPP * h;
      const int id[4] = {s_id[st][0][p], s_id[st][1][p], s_id[st][2][p],
                         s_id[st][3][p]};
      const float wq[4] = {s_w[st][0][p], s_w[st][1][p], s_w[st][2][p],
                           s_w[st][3][p]};
      float v[VEC];
      blend<T>(raw[h], id, wq, c, C, v);
      *reinterpret_cast<uint4*>(As + p * SA + grp * VEC) = pack(v);
    }
  };

  // g[tile rows, n0:n0+BN] into a B stage, zero outside npix x Cout
  auto stage_g = [&](int tile, T* Bs) {
    const int r0 = tile * TP;
    if (vec_g) {
      constexpr int GPR = BN / VEC;
      for (int e = tid; e < TP * GPR; e += THREADS) {
        const int r = e / GPR;
        const int o = n0 + (e % GPR) * VEC;
        const bool ok = r0 + r < npix && o < Cout;
        cp_async16(Bs + r * SB + (e % GPR) * VEC,
                   ok ? g + (size_t)(r0 + r) * Cout + o : g, ok);
      }
      cp_async_commit();
    } else {
      for (int e = tid; e < TP * BN; e += THREADS) {
        const int r = e / BN;
        const int o = n0 + e % BN;
        Bs[r * SB + e % BN] = r0 + r < npix && o < Cout
                                  ? g[(size_t)(r0 + r) * Cout + o]
                                  : from_f32<T>(0.f);
      }
    }
  };

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp & 1;   // channels wm*WCK/2 .. +WCK/2
  const int wn = warp >> 1;  // output channels wn*WN .. +WN of the tile
  const int gq = lane >> 2;
  const int t = lane & 3;
  float acc[MI][NT][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < NT; ++nj)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][nj][i] = 0.f;

  // acc += A^T (WCK x TP) B (TP x BN), A stored [pixel][channel]
  auto mma_tile = [&](const T* As, const T* Bs) {
    if constexpr (BF16) {
      const int j = lane >> 3;
#pragma unroll
      for (int ks = 0; ks < TP / 16; ++ks) {
        uint32_t a[MI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          ldmatrix_x4_trans(a[mi], As + (ks * 16 + (j >> 1) * 8 + (lane & 7)) *
                                            SA +
                                       wm * (WCK / 2) + mi * 16 + (j & 1) * 8);
#pragma unroll
        for (int nj = 0; nj < NT; nj += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, Bs + (ks * 16 + (lane & 15)) * SB + wn * WN +
                                   nj * 8 + (lane >> 4) * 8);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            mma_bf16(acc[mi][nj], a[mi], b[0], b[1]);
            mma_bf16(acc[mi][nj + 1], a[mi], b[2], b[3]);
          }
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < TP / 8; ++ks) {
        uint32_t ah[MI][4], al[MI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const float* a =
              As + (ks * 8 + t) * SA + wm * (WCK / 2) + mi * 16 + gq;
          split_tf32(a[0], ah[mi][0], al[mi][0]);
          split_tf32(a[8], ah[mi][1], al[mi][1]);
          split_tf32(a[4 * SA], ah[mi][2], al[mi][2]);
          split_tf32(a[4 * SA + 8], ah[mi][3], al[mi][3]);
        }
#pragma unroll
        for (int nj = 0; nj < NT; ++nj) {
          const float* b = Bs + (ks * 8 + t) * SB + wn * WN + nj * 8 + gq;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(b[0], bh0, bl0);
          split_tf32(b[4 * SB], bh1, bl1);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
            mma_3xtf32(acc[mi][nj], ah[mi], al[mi], bh0, bh1, bl0, bl1);
        }
      }
    }
  };

  // the two-stage ring over the split's pixel tiles: tile i+1's corner
  // loads and g tile in flight, tile i+2's corners computed and tile i+3's
  // offsets fetched, while tile i is contracted; stage s holds tile i
  if (t_begin < t_end) {
    uint4 raw[PASSES][4];
    fetch(t_begin);
    corners(t_begin, 0);
    fetch(t_begin + 1);
    corners(t_begin + 1, 1);
    fetch(t_begin + 2);
    __syncthreads();
    load_x(0, raw);
    stage_g(t_begin, sB);
    store_a(0, raw, sA);
    cp_async_wait_all();
    __syncthreads();
    for (int i = t_begin; i < t_end; ++i) {
      const int s = (i - t_begin) & 1;
      const bool more = i + 1 < t_end;
      if (more) {
        load_x(s ^ 1, raw);
        stage_g(i + 1, sB + (s ^ 1) * B_STAGE);
      }
      corners(i + 2, s);  // stage s was last read by tile i's store_a
      fetch(i + 3);
      mma_tile(sA + s * A_STAGE, sB + s * B_STAGE);
      if (more) store_a(s ^ 1, raw, sA + (s ^ 1) * A_STAGE);
      cp_async_wait_all();
      __syncthreads();
    }
  }

  // epilogue: dW_k rows c, cast (one split), or this split's f32 partials
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int cc = c0 + wm * (WCK / 2) + mi * 16 + gq + 8 * hf;
      if (cc >= C) continue;
      const size_t row = ((size_t)tap * C + cc) * Cout;
#pragma unroll
      for (int nj = 0; nj < NT; ++nj) {
        const int o = n0 + wn * WN + nj * 8 + 2 * t;
        const float v0 = acc[mi][nj][2 * hf];
        const float v1 = acc[mi][nj][2 * hf + 1];
        if (ws != nullptr)
          store_pair(ws + (size_t)blockIdx.z * 9 * C * Cout + row, o, Cout,
                     v0, v1);
        else
          store_pair(dw + row, o, Cout, v0, v1);
      }
    }
}

// dW = sum over splits, in split order, of the partial sums, cast to T
template <typename T>
__global__ void __launch_bounds__(256)
dcn_bwd_reduce(const float* __restrict__ ws, T* __restrict__ dw,
               long long total, int splits) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float s = ws[e];
  for (int k = 1; k < splits; ++k) s += ws[k * total + e];
  dw[e] = from_f32<T>(s);
}

// above 48 KB of dynamic shared memory a launch is refused unless the
// kernel allows it: once per device and kernel (never while a graph
// captures, since the first call of a shape runs eagerly)
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool (&allowed)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && allowed[dev])) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) allowed[dev] = true;
  return err;
}

template <typename T, int BN>
int launch_weight(const void* x, const void* off, const void* mask,
                  const void* g, void* dw, float* ws, int npix, int H, int W,
                  int C, int Cout, int clamp, float R, int splits,
                  cudaStream_t stream) {
  constexpr int VEC = Geom<T>::VEC;
  constexpr int smem = weight_smem_bytes<T, BN>();
  static bool allowed[64] = {};
  cudaError_t err = allow_smem(dcn_bwd_weight<T, BN>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const int vec_x = C % VEC == 0 && ((uintptr_t)x & 15) == 0;
  const int vec_g = Cout % VEC == 0 && ((uintptr_t)g & 15) == 0;
  const dim3 grid(9 * ((C + WCK - 1) / WCK), (Cout + BN - 1) / BN, splits);
  dcn_bwd_weight<T, BN><<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const float*)off, (const float*)mask, (const T*)g,
      (T*)dw, splits > 1 ? ws : nullptr, npix, H, W, C, Cout, clamp, R,
      vec_x, vec_g);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long total = 9LL * C * Cout;
  dcn_bwd_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      ws, (T*)dw, total, splits);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* off, const void* mask, const void* w,
           const void* g, void* dx, void* doff, void* dmask, void* dw,
           float* ws, int npix, int H, int W, int C, int Cout, int clamp,
           float R, int data_splits, int bn, int splits,
           cudaStream_t stream) {
  constexpr int VEC = Geom<T>::VEC;
  if (npix > 0) {
    static bool allowed[64] = {};
    cudaError_t err = allow_smem(dcn_bwd_data<T>,
                                 data_smem_bytes<T>(SLAB), allowed);
    if (err != cudaSuccess) return (int)err;
    const int vec_x = C % VEC == 0 && ((uintptr_t)x & 15) == 0 &&
                      ((uintptr_t)dx & 15) == 0;
    const int vec_w = Cout % VEC == 0 && ((uintptr_t)w & 15) == 0;
    const int vec_g = Cout % VEC == 0 && ((uintptr_t)g & 15) == 0;
    const dim3 grid((npix + TP - 1) / TP, data_splits);
    dcn_bwd_data<T><<<grid, THREADS, data_smem_bytes<T>(data_slab<T>(Cout)),
                      stream>>>(
        (const T*)x, (const float*)off, (const float*)mask, (const T*)w,
        (const T*)g, (float*)dx, (float*)doff, (float*)dmask, npix, H, W, C,
        Cout, clamp, R, vec_x, vec_w, vec_g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (Cout == 0) return (int)cudaSuccess;
  if (bn == 64)
    return launch_weight<T, 64>(x, off, mask, g, dw, ws, npix, H, W, C, Cout,
                                clamp, R, splits, stream);
  if (bn == 128)
    return launch_weight<T, 128>(x, off, mask, g, dw, ws, npix, H, W, C,
                                 Cout, clamp, R, splits, stream);
  return launch_weight<T, 256>(x, off, mask, g, dw, ws, npix, H, W, C, Cout,
                               clamp, R, splits, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, g and dw share it; offsets,
// masks, dx, doff and dmask are f32).  clamp: 0 = exact sampling, 1 =
// y-offsets clamped to [-R, R], 2 = both axes clamped to [-R, R].
// data_splits: dcn_bwd_data's tap ranges, 1 .. 9.  bn: dcn_bwd_weight's
// output-channel tile, 64, 128 or 256.  splits: its pixel ranges, 1 ..
// ceil(B*H*W / 64) (1 with no pixels); with more than one, ws holds
// splits * 9 * C * Cout f32 partial sums and dcn_bwd_reduce adds them.
// Another value of any of these is refused (cudaErrorInvalidValue).
// Returns cudaGetLastError() after the launches (0 = cudaSuccess).
extern "C" int dcn_bwd(const void* x, const void* off, const void* mask,
                       const void* w, const void* g, void* dx, void* doff,
                       void* dmask, void* dw, void* ws, int B, int H, int W,
                       int C, int Cout, int dtype, int clamp, float R,
                       int data_splits, int bn, int splits, void* stream) {
  const int npix = B * H * W;
  const int m_tiles = (npix + TP - 1) / TP;
  if (clamp < CLAMP_NONE || clamp > CLAMP_XY || (dtype != 0 && dtype != 1) ||
      (bn != 64 && bn != 128 && bn != 256) || C <= 0 || Cout < 0 ||
      npix < 0 || data_splits < 1 || data_splits > MAX_TAPS || splits < 1 ||
      splits > (m_tiles > 0 ? m_tiles : 1) || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, off, mask, w, g, dx, doff, dmask, dw,
                                 (float*)ws, npix, H, W, C, Cout, clamp, R,
                                 data_splits, bn, splits,
                                 (cudaStream_t)stream);
  return launch<float>(x, off, mask, w, g, dx, doff, dmask, dw, (float*)ws,
                       npix, H, W, C, Cout, clamp, R, data_splits, bn, splits,
                       (cudaStream_t)stream);
}
