// The tensor-core building blocks of the bf16 counting products
// (csrc/block_ops.cu's count_matmul, csrc/probes.cu's one-hot product):
// one mma.sync m16n8k16 product and one ldmatrix.x4.trans, in PTX.

#pragma once

#include <cstdint>

namespace tc {

// d = a x b + c, one m16n8k16 product on the tensor cores: bf16 operands,
// f32 accumulators, in the PTX ISA's fragment layouts (lane = 4g + t):
//   a (16 x 16): a[0] row g, columns 2t, 2t + 1 (low, high half); a[1] row
//     g + 8, the same columns; a[2] row g, columns 2t + 8, 2t + 9; a[3] row
//     g + 8, those columns;
//   b (16 x 8): b0 rows 2t, 2t + 1 of column g; b1 rows 2t + 8, 2t + 9;
//   c, d (16 x 8): [0], [1] row g, columns 2t, 2t + 1; [2], [3] row g + 8.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1, const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
      " {%8, %9}, {%10, %11, %12, %13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]),
        "f"(c[2]), "f"(c[3]));
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lanes 8q .. 8q +
// 7 give the row addresses (16 bytes each) of matrix q, and lane 4g + t
// receives in r[q] that matrix's elements (2t, g) and (2t + 1, g).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

}  // namespace tc
