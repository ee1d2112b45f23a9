// Tensor-core building blocks shared by the flash-attention, int8 matmul
// and streaming-NNS kernels (sm_90a): asynchronous 16-byte copies into
// shared memory, `ldmatrix` and the warp-level `mma.sync` products, as
// inline PTX.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16 / k32"),
// with g = lane / 4 and t = lane % 4:
//   A (16 x K, row-major), 4 registers: a0 row g, a1 row g + 8, a2 row g,
//     a3 row g + 8; a0/a1 hold the first half of K, a2/a3 the second;
//     within a half, lane t holds the 4 bytes at 4t (two bf16 or four s8).
//   B (K x 8, "col": K contiguous for each column), 2 registers: column g,
//     b0 the first half of K and b1 the second, 4 bytes at 4t as above.
//   C (16 x 8, f32 or s32), 4 registers: c0, c1 row g, columns 2t, 2t + 1;
//     c2, c3 row g + 8, the same columns.
// `ldmatrix.x4` reads four 8 x 8 matrices of 16-bit elements, rows given
// by lanes 0-7, 8-15, 16-23 and 24-31; lane l receives row l / 4, elements
// 2 (l % 4) and 2 (l % 4) + 1 of each (transposed with `.trans`).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing through registers; the
// `src_bytes` first bytes are read and the rest zero-filled (0: all zero).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Two 8 x 8 matrices, rows given by lanes 0-7 and 8-15 (the addresses of
// lanes 16-31 are not read).
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a . b on one 16 x 8 x 16 tile: bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b on one 16 x 8 x 32 tile: s8 operands, s32 accumulator that
// wraps on overflow (no .satfinite), as an int32 sum does.
__device__ __forceinline__ void mma_s8_16832(int (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a . b + c on one 16 x 8 x 32 tile, s8 operands, with the
// accumulator taken from c (which is left as it is).
__device__ __forceinline__ void mma_s8_16832(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1,
                                             const int (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]));
}

}  // namespace repro
