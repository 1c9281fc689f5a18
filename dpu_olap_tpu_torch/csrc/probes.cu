// The TPU primitive probes' Hopper counterparts: four small kernels, each
// the function of one Pallas probe.
//
//   row_gather_kernel  <- scripts/measure_r3.py gk (measure_take2, :219):
//                         o = take_along_axis(x, i, axis=1), and the wide
//                         gather of measurements/_probe_v4_lowering.py
//                         k_gather_wide (idx (128, 256) over values (128,
//                         128); also _proto_lower.py, _proto_lower2.py).
//   transpose_kernel   <- _probe_v4_lowering.py k_transpose ((128, 128) u32
//                         and i32) and _proto_lower.py k_transpose ((512,
//                         128) -> (128, 512)).
//   onehot_kernel      <- _probe_v4_lowering.py k_onehot_mm: (K, M)^T @ (K,
//                         N) of bf16 planes, f32 accumulation.
//   dyn_row_kernel     <- _proto_lower.py k_dynrow: one row of a (rows, W)
//                         plane at a row index held in SMEM; here the index
//                         stays in device memory and the kernel reads it.
//
// Contracts, all on 32-bit words (int32 and uint32 move the same bits):
//   row gather  o[r][j] = x[r][i[r][j]] for x (rows, W_v), i (rows, W_i)
//               int32, o (rows, W_i); an index outside [0, W_v) reads 0 (the
//               TPU probes' indices are always in range).
//   transpose   out (cols, rows) = in (rows, cols)^T.
//   one-hot     out (M, N) f32 = a^T . b for a (K, M), b (K, N) bf16, K, M
//               and N multiples of 16; exact for 0/1 operands (every sum an
//               integer <= K), as the TPU's f32 accumulation is.
//   dyn row     out (W) = x[*row] (W words); a row outside [0, rows) reads 0.
//
// What bounds them on the H100: device-memory bytes, each input read once
// and each output written once (row gather 4 (W_v + 2 W_i) bytes a row,
// transpose 8 bytes an element, one-hot 2 (K M + K N) + 4 M N bytes against
// 2 K M N flops, dyn row 8 W bytes). The row gather stages its rows in
// shared memory, so x is read once and coalesced; the transpose goes
// through a padded 32 x 32 shared-memory tile, so both its reads and its
// writes are coalesced and free of bank conflicts. The probes' shapes are
// small (at most 4 MiB a plane at 8192 rows): launch latency, not bytes,
// sets their times.

#include <cstdint>
#include <cuda_runtime.h>

#include "onehot_mma.cuh"

namespace {

constexpr int GATHER_THREADS = 256;
constexpr int GATHER_WORDS = 2048;  // values a gather block stages (8 KiB)
constexpr int TT = 32;              // transpose tile edge
constexpr int TROWS = 8;            // transpose block: TT x TROWS threads
constexpr int ONEHOT_WARPS = 4;

__global__ void __launch_bounds__(GATHER_THREADS)
row_gather_kernel(const uint32_t* __restrict__ x, const int32_t* __restrict__ idx,
                  uint32_t* __restrict__ out, long long rows, int wv, int wi, int rows_per_block) {
  extern __shared__ uint32_t srow[];
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const int nr = (int)min((long long)rows_per_block, rows - r0);
  const uint32_t* xs = x + r0 * wv;
  for (int e = threadIdx.x; e < nr * wv; e += GATHER_THREADS) srow[e] = xs[e];
  __syncthreads();
  const int32_t* is = idx + r0 * wi;
  uint32_t* os = out + r0 * wi;
  for (int e = threadIdx.x; e < nr * wi; e += GATHER_THREADS) {
    const int32_t i = is[e];
    os[e] = (uint32_t)i < (uint32_t)wv ? srow[(e / wi) * wv + i] : 0u;
  }
}

__global__ void __launch_bounds__(TT * TROWS)
transpose_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, long long rows,
                 long long cols) {
  __shared__ uint32_t tile[TT][TT + 1];
  const long long c0 = (long long)blockIdx.x * TT;
  const long long r0 = (long long)blockIdx.y * TT;
  for (int k = threadIdx.y; k < TT; k += TROWS) {
    const long long r = r0 + k, c = c0 + threadIdx.x;
    if (r < rows && c < cols) tile[k][threadIdx.x] = in[r * cols + c];
  }
  __syncthreads();
  for (int k = threadIdx.y; k < TT; k += TROWS) {
    const long long orow = c0 + k, ocol = r0 + threadIdx.x;
    if (orow < cols && ocol < rows) out[orow * rows + ocol] = tile[threadIdx.x][k];
  }
}

// one warp a 16 x 16 output tile
__global__ void __launch_bounds__(32 * ONEHOT_WARPS)
onehot_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
              float* __restrict__ out, int K, int M, int N) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int tiles_n = N / 16;
  if (warp >= (M / 16) * tiles_n) return;  // a whole warp leaves together
  onehot::at_b_tile(a, M, b, N, K, (warp / tiles_n) * 16, (warp % tiles_n) * 16, out, N);
}

__global__ void dyn_row_kernel(const uint32_t* __restrict__ x, const int32_t* __restrict__ row,
                               uint32_t* __restrict__ out, long long rows, long long w) {
  const int32_t r = *row;
  const bool in = r >= 0 && r < rows;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < w;
       j += (long long)gridDim.x * blockDim.x)
    out[j] = in ? x[(long long)r * w + j] : 0u;
}

}  // namespace

// out (rows, wi) = x (rows, wv) gathered along each row at idx (rows, wi,
// int32). wv at most GATHER_WORDS. Device pointers; launches on `stream`,
// does not synchronise; returns 0 or the first CUDA error.
extern "C" int dpu_lane_gather_u32(const void* x, const void* idx, void* out, long long rows,
                                   long long wv, long long wi, void* stream) {
  if (rows < 0 || wv < 1 || wv > GATHER_WORDS || wi < 1 || wi > GATHER_WORDS)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int per = (int)(GATHER_WORDS / wv);
  const long long blocks = (rows + per - 1) / per;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  row_gather_kernel<<<(unsigned)blocks, GATHER_THREADS, per * wv * sizeof(uint32_t),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const int32_t*>(idx),
      static_cast<uint32_t*>(out), rows, (int)wv, (int)wi, per);
  return (int)cudaGetLastError();
}

// out (cols, rows) = in (rows, cols)^T, 32-bit words. rows / 32 below
// 65536. Launches on `stream`, does not synchronise.
extern "C" int dpu_transpose_u32(const void* in, void* out, long long rows, long long cols,
                                 void* stream) {
  const long long gx = (cols + TT - 1) / TT, gy = (rows + TT - 1) / TT;
  if (rows < 0 || cols < 0 || gy > 65535 || gx > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return 0;
  transpose_kernel<<<dim3((unsigned)gx, (unsigned)gy), dim3(TT, TROWS), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), rows, cols);
  return (int)cudaGetLastError();
}

// out (m, n) f32 = a (k, m)^T . b (k, n), bf16 row-major planes; k, m and
// n positive multiples of 16, pointers 32-byte aligned. Launches on
// `stream`, does not synchronise.
extern "C" int dpu_onehot_matmul_bf16(const void* a, const void* b, void* out, long long k,
                                      long long m, long long n, void* stream) {
  if (k < 16 || m < 16 || n < 16 || k % 16 || m % 16 || n % 16 || k > (1 << 24) ||
      m > (1 << 20) || n > (1 << 20) || (m / 16) * (n / 16) > 0x7FFFFFFFLL / 32)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (m / 16) * (n / 16);
  onehot_kernel<<<(unsigned)((tiles + ONEHOT_WARPS - 1) / ONEHOT_WARPS), 32 * ONEHOT_WARPS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<float*>(out), (int)k, (int)m, (int)n);
  return (int)cudaGetLastError();
}

// out (w) = row *row of x (rows, w), 32-bit words; the row index is one
// int32 in device memory. Launches on `stream`, does not synchronise.
extern "C" int dpu_dyn_row_u32(const void* x, const void* row, void* out, long long rows,
                               long long w, void* stream) {
  if (rows < 1 || w < 0) return (int)cudaErrorInvalidValue;
  if (w == 0) return 0;
  const long long blocks = w < 1024 * 256 ? (w + 255) / 256 : 1024;
  dyn_row_kernel<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const int32_t*>(row),
      static_cast<uint32_t*>(out), rows, w);
  return (int)cudaGetLastError();
}
