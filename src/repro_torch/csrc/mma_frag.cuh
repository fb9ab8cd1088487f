// Tensor-core fragment helpers: ldmatrix loads of 8 x 8 bf16 sub-matrices
// from shared memory and the warp-wide mma.sync m16n8k16 product with
// fp32 sums (PTX ISA, "Warp-level matrix multiply-accumulate").
//
// Fragment layouts of mma.m16n8k16 (.row.col), for lane l, g = l / 4 and
// t = l % 4:
//   A (16 x 16, row-major): a[0] = rows g, k 2t..2t+1; a[1] = row g + 8;
//     a[2] = row g, k 8 + 2t..; a[3] = row g + 8, k 8 + 2t..
//   B (16 x 8, k-major "col"): b[0] = k 2t..2t+1, column g; b[1] = k + 8
//   C (16 x 8, fp32): c[0..1] = row g, columns 2t..2t+1; c[2..3] = row g+8
// ldmatrix.x4 takes one 16-byte row address from each lane: lanes 0-7
// address the rows of sub-matrix 0, lanes 8-15 of 1, 16-23 of 2, 24-31
// of 3, and sub-matrix i lands in register i.  So for A, lane l supplies
// row (l & 15) of the m16 tile at k-half (l >> 4); with .trans on a
// k-major B tile, lane l supplies k-row (l & 15) at column half (l >> 4),
// and registers {0, 1} and {2, 3} are the fragments of two n8 tiles.
// Every row address must be 16-byte aligned; the 8 rows of one
// sub-matrix hit distinct bank groups when their byte strides are odd
// multiples of 16.
#pragma once

#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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

// the first two sub-matrices of ldmatrix_x4 (lanes 0-15 address them):
// one n8 tile's B fragment from rows of reduction elements
__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

// the first two sub-matrices of ldmatrix_x4_trans (lanes 0-15 address
// them): one n8 tile's B fragment
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

// d += a (16 x 16 bf16) * b (16 x 8 bf16), fp32 sums
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace mma
