// The counting product of 0/1 planes on the tensor cores, for
// csrc/probes.cu (the one-hot product): one 16 x 16 tile of a^T . b with
// bf16 m16n16k16 wmma fragments and f32 accumulators.
//
// a is K x lda row-major, so a^T loads as a col_major matrix_a: element (m,
// k) of a^T sits at a[k * lda + m]. b is K x ldb row-major. With 0/1
// operands every partial sum is an integer of at most K, exact in f32 for K
// below 2^24. The accumulator goes out through store_matrix_sync: no
// fragment layout is assumed (csrc/filter4.cu does the same in fp16).
//
// Preconditions: K a multiple of 16; lda and ldb multiples of 16; ldo a
// multiple of 8; a, b and out 32-byte aligned. Every tile start then stays
// 32-byte aligned, as load_matrix_sync and store_matrix_sync require.

#pragma once

#include <cuda_bf16.h>
#include <mma.h>

namespace onehot {

using FragAT = nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                                      nvcuda::wmma::col_major>;
using FragB = nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                                     nvcuda::wmma::row_major>;
using FragC = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

// out[m0 .. m0+15][n0 .. n0+15] (row-major, leading dimension ldo) =
// sum over k < K of a[k][m] * b[k][n]. Called by a whole warp.
__device__ __forceinline__ void at_b_tile(const __nv_bfloat16* a, int lda,
                                          const __nv_bfloat16* b, int ldb, int K, int m0,
                                          int n0, float* out, int ldo) {
  FragAT fa;
  FragB fb;
  FragC fc;
  nvcuda::wmma::fill_fragment(fc, 0.0f);
  for (int k = 0; k < K; k += 16) {
    nvcuda::wmma::load_matrix_sync(fa, a + (size_t)k * lda + m0, lda);
    nvcuda::wmma::load_matrix_sync(fb, b + (size_t)k * ldb + n0, ldb);
    nvcuda::wmma::mma_sync(fc, fa, fb, fc);
  }
  nvcuda::wmma::store_matrix_sync(out + (size_t)m0 * ldo + n0, fc, ldo,
                                  nvcuda::wmma::mem_row_major);
}

}  // namespace onehot
