// Building blocks of the DCN kernels on Hopper (sm_90a): the bilinear
// gather shared by the forward (csrc/dcn_fwd.cu) and the backward
// (csrc/dcn_bwd.cu), asynchronous 16-byte copies into shared memory,
// ldmatrix fragment loads, mma.sync products in bf16 and in TF32, and the
// split of an f32 value into two TF32 parts (3xTF32: hi*hi + hi*lo + lo*hi
// keeps f32 accuracy).
//
// Fragment layouts are those of the PTX ISA for mma.m16n8k16 (bf16) and
// mma.m16n8k8 (tf32), row.col: with g = lane / 4 and t = lane % 4,
//   A (16 x K, row-major)  a0: (g, k lo)  a1: (g+8, k lo)  a2: (g, k hi)
//                          a3: (g+8, k hi)
//   B (K x 8, column)      b0: (k lo, n g)  b1: (k hi, n g)
//   C/D (16 x 8, f32)      d0, d1: (g, 2t, 2t+1)  d2, d3: (g+8, 2t, 2t+1)
// where "k lo" is k 2t, 2t+1 (bf16) or t (tf32) and "k hi" adds 8 (bf16)
// or 4 (tf32).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace dcn_tile {

// clamp modes: which offset axes are clamped to [-R, R]
constexpr int CLAMP_NONE = 0, CLAMP_Y = 1, CLAMP_XY = 2;

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

// 16 bytes <-> 4 f32 or 8 bf16 values in f32
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
  __nv_bfloat162 h[4];
  memcpy(h, &u, 16);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  __nv_bfloat162 h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  uint4 u;
  memcpy(&u, h, 16);
  return u;
}

// an output pair (o, o + 1) of one row of `cols` values; vector store
// where cols is even (o is even, so the pair is aligned and lies inside
// the row)
template <typename D>
__device__ __forceinline__ void store_pair(D* row, int o, int cols, float v0,
                                           float v1) {
  if ((cols & 1) == 0 && o < cols) {
    if constexpr (std::is_same<D, float>::value)
      *reinterpret_cast<float2*>(row + o) = make_float2(v0, v1);
    else
      *reinterpret_cast<__nv_bfloat162*>(row + o) =
          __floats2bfloat162_rn(v0, v1);
  } else {
    if (o < cols) row[o] = from_f32<D>(v0);
    if (o + 1 < cols) row[o + 1] = from_f32<D>(v1);
  }
}

// Tap k of pixel n (flat over B*H*W) at the raw offsets (oy, ox): the
// flat pixel index of each of the four bilinear corners (-1 outside the
// image) and the fractions of floor(), at the offsets clamped by the
// mode.  The JAX oracle's association, (grid + tap) + offset; at an
// integer position the floor cell is the one taken.
__device__ __forceinline__ void tap_corners(int n, int k, float oy, float ox,
                                            int H, int W, int clamp, float R,
                                            int (&id)[4], float& fy,
                                            float& fx) {
  const int hw = n % (H * W);
  const int base = n - hw;  // first pixel of this image
  const int yy = hw / W;
  const int xx = hw % W;
  if (clamp != CLAMP_NONE) oy = fminf(fmaxf(oy, -R), R);
  if (clamp == CLAMP_XY) ox = fminf(fmaxf(ox, -R), R);
  const float sy = (float)(yy + k / 3 - 1) + oy;
  const float sx = (float)(xx + k % 3 - 1) + ox;
  const float y0 = floorf(sy);
  const float x0 = floorf(sx);
  fy = sy - y0;
  fx = sx - x0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float yf = y0 + (float)(q >> 1);
    const float xf = x0 + (float)(q & 1);
    // compare in float: a wild offset must not overflow an int
    id[q] = yf >= 0.f && yf < (float)H && xf >= 0.f && xf < (float)W
                ? base + (int)yf * W + (int)xf
                : -1;
  }
}

// the four corners' bilinear weights, times m
__device__ __forceinline__ void bilinear(float fy, float fx, float m,
                                         float (&cw)[4]) {
  cw[0] = (1.f - fy) * (1.f - fx) * m;
  cw[1] = (1.f - fy) * fx * m;
  cw[2] = fy * (1.f - fx) * m;
  cw[3] = fy * fx * m;
}

// The 16 bytes (16 / sizeof(T) channels) from channel c of each corner
// row, loaded unconditionally (a corner outside the image reads row 0, the
// select comes after the load), so the four loads go out together.  With
// vec the rows are 16-byte vectors (C a multiple of the width, x aligned)
// and c past the row reads its last vector; else channel by channel,
// clamped to C - 1.
template <typename T>
__device__ __forceinline__ void load_corners(const T* __restrict__ x,
                                             const int (&id)[4], int c, int C,
                                             bool vec, uint4 (&raw)[4]) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const T* row = x + (size_t)(id[q] < 0 ? 0 : id[q]) * C;
    if (vec) {
      raw[q] = __ldg(reinterpret_cast<const uint4*>(
          row + (c < C ? c : C - VEC)));
    } else {
      T v[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = row[min(c + j, C - 1)];
      memcpy(&raw[q], v, 16);
    }
  }
}

// sum_q w_q x[corner_q, c + j] in f32: 0 for a corner outside the image
// and for channels at or past C
template <typename T>
__device__ __forceinline__ void blend(const uint4 (&raw)[4],
                                      const int (&id)[4],
                                      const float (&w)[4], int c, int C,
                                      float (&v)[16 / sizeof(T)]) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const bool in = id[q] >= 0;
    float xv[VEC];
    unpack(raw[q], xv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] += in ? w[q] * xv[j] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    if (c + j >= C) v[j] = 0.f;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid (src
// must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 b16 matrices; lanes 8j..8j+7 give the row addresses of matrix j
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// the same, each matrix transposed (B fragments from a [k][n] tile)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a b: m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b: m16n8k8, tf32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo + e, |e| < 2^-20 |x|, both parts TF32: hi is x with its low
// 13 mantissa bits cleared, x - hi is exact in f32, lo is that remainder
// cleared the same way.  Two masks and a subtraction instead of two
// cvt.rna.tf32: the f32 product loop is bound by its instructions, and the
// rounding mode of hi does not matter since lo carries the remainder.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d += a b in 3xTF32 (f32 accuracy): a and b split into TF32 high and low
// parts, lo*hi + hi*lo + hi*hi summed into f32 accumulators
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

}  // namespace dcn_tile
