// Building blocks of the DCN kernels' tensor-core tiles on Hopper (sm_90a):
// asynchronous 16-byte copies into shared memory, ldmatrix fragment loads,
// mma.sync products in bf16 and in TF32, and the split of an f32 value into
// two TF32 parts (3xTF32: hi*hi + hi*lo + lo*hi keeps f32 accuracy).
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

namespace dcn_tile {

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

}  // namespace dcn_tile
