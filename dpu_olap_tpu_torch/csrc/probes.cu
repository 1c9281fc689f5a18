// The TPU primitive probes' Hopper counterparts: the kernels that compute
// the function of one Pallas probe each, and a kernel that does nothing.
//
//   row_gather_kernel,  <- scripts/measure_r3.py gk (measure_take2, :219):
//   warp_row_gather_      o = take_along_axis(x, i, axis=1), and the wide
//   kernel                gather of measurements/_probe_v4_lowering.py
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
//   noop_kernel           replaces nothing: the least time a launch on this
//                         path takes (the probes' launch floor).
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
// What bounds them on the H100. Device-memory bytes, each input read once
// and each output written once (row gather 4 (W_v + 2 W_i) bytes a row,
// transpose 8 bytes an element, one-hot 2 (K M + K N) + 4 M N bytes against
// 2 K M N flops, dyn row 8 W bytes), and, at the probes' own shapes (at
// most 320 KiB moved, 8 MFLOP), the time of a launch itself: the lowering
// probes are read against the larger of their bytes bound and the noop's
// time. The row gather gives every row of at most 128 values a warp
// (warp_row_gather_kernel): one 16-byte load a lane of the values and of
// each 128 indices, all in flight before any is used, so that a row costs one
// round trip to memory, and 128 rows are 32 blocks where the staged grid
// had 8. Wider rows go to row_gather_kernel, which stages each block's
// rows in shared memory (ops/probes_cuda.py gather_plan chooses). The
// warp-a-row kernel was no slower at measure_r3's 8192 and 32768 rows
// either (PERF.md §6). The transpose goes through a padded 32 x 32
// shared-memory tile, so both its reads and its writes are coalesced and
// free of bank conflicts. The one-hot product is a chain of loads, products
// and a store at a size where latency, not rate, counts: onehot_kernel
// below.

#include <cstdint>
#include <cuda_runtime.h>
#ifndef PROBES_WITHOUT_ONEHOT
#include <cuda_bf16.h>

#include "mma_bf16.cuh"
#endif

namespace {

constexpr int GATHER_THREADS = 256;
constexpr int GATHER_WORDS = 2048;  // values a gather block stages (8 KiB)
constexpr int ROW_WARPS = 4;        // rows a warp_row_gather_kernel block: one a warp
constexpr int ROW_WORDS = 128;      // widest value row it takes: 4 a lane
constexpr int TT = 32;              // transpose tile edge
constexpr int TROWS = 8;            // transpose block: TT x TROWS threads
enum : int { STAGED = 0, WARP_ROWS = 1 };  // kernel codes: ops/probes_cuda.py GATHER_KERNELS

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

// d = p[j .. j + 3], fill past n: one 16-byte load where vec (p 16-byte
// aligned, n a multiple of 4), else 4-byte ones
template <class T>
__device__ __forceinline__ void load4(T (&d)[4], const T* p, int j, int n, bool vec, T fill) {
  if (vec && j < n) {
    const uint4 u = *reinterpret_cast<const uint4*>(p + j);
    d[0] = (T)u.x, d[1] = (T)u.y, d[2] = (T)u.z, d[3] = (T)u.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] = j + e < n ? p[j + e] : fill;
  }
}

// p[j .. j + 3] = d, up to n, as load4
__device__ __forceinline__ void store4(uint32_t* p, int j, int n, bool vec, const uint32_t (&d)[4]) {
  if (vec && j < n) {
    *reinterpret_cast<uint4*>(p + j) = make_uint4(d[0], d[1], d[2], d[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (j + e < n) p[j + e] = d[e];
  }
}

// One warp a row, W_v <= 128: lane l loads values 4l .. 4l + 3 and, a pass,
// indices 4l .. 4l + 3 of each of two 128-index halves, all before any is
// used (the wide probe's 256 indices are one pass); the row goes through
// the warp's own 512 B of shared memory, and each output is one read of
// it. A view whose row is not 16-byte aligned, or a width that is not a
// multiple of 4, takes 4-byte loads and stores: the same branch for the
// whole warp.
__global__ void __launch_bounds__(32 * ROW_WARPS)
warp_row_gather_kernel(const uint32_t* __restrict__ x, const int32_t* __restrict__ idx,
                       uint32_t* __restrict__ out, long long rows, int wv, int wi) {
  __shared__ __align__(16) uint32_t srow[ROW_WARPS][ROW_WORDS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long r = (long long)blockIdx.x * ROW_WARPS + w;
  if (r >= rows) return;  // a whole warp leaves together
  const uint32_t* xr = x + r * wv;
  const int32_t* ir = idx + r * wi;
  uint32_t* orow = out + r * wi;
  const bool xvec = wv % 4 == 0 && (uintptr_t)xr % 16 == 0;
  const bool ivec = wi % 4 == 0 && (uintptr_t)ir % 16 == 0;
  const bool ovec = wi % 4 == 0 && (uintptr_t)orow % 16 == 0;
  uint32_t* s = srow[w];
  uint32_t v[4];
  load4(v, xr, 4 * lane, wv, xvec, 0u);
  for (int j0 = 0; j0 < wi; j0 += 2 * ROW_WORDS) {
    int32_t i[2][4];
    load4(i[0], ir, j0 + 4 * lane, wi, ivec, -1);
    load4(i[1], ir, j0 + ROW_WORDS + 4 * lane, wi, ivec, -1);
    if (j0 == 0) {
      *reinterpret_cast<uint4*>(s + 4 * lane) = make_uint4(v[0], v[1], v[2], v[3]);
      __syncwarp();
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = (uint32_t)i[h][e] < (uint32_t)wv ? s[i[h][e]] : 0u;
      store4(orow, j0 + ROW_WORDS * h + 4 * lane, wi, ovec, o);
    }
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

__global__ void dyn_row_kernel(const uint32_t* __restrict__ x, const int32_t* __restrict__ row,
                               uint32_t* __restrict__ out, long long rows, long long w) {
  const int32_t r = *row;
  const bool in = r >= 0 && r < rows;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < w;
       j += (long long)gridDim.x * blockDim.x)
    out[j] = in ? x[(long long)r * w + j] : 0u;
}

__global__ void noop_kernel() {}

}  // namespace

// The one-hot product (onehot_kernel). One block an output tile of TM x TN
// = 32 x 32, a warp a 16 x 32 part of it and a 1/KS share of its k-steps
// (the probe's 128 x 256 is 32 tiles, 8 warps each: 2 parts x 4 shares).
// The old design, a warp a 16 x 16 tile loading its wmma fragments from
// device memory k-step by k-step, waited on 8 round trips to L2 in a row
// at K = 128. Here the block starts a 16-byte cp.async for every piece of
// its strips of a (K x TM) and b (K x TN) before it waits on any: one round
// trip, then one barrier. Each warp then reads its a^T and b fragments from
// shared memory with ldmatrix.x4.trans and runs mma.sync m16n8k16 (bf16 in,
// f32 accumulators in registers), 4 independent products a k-step; the
// shares' sums meet in shared memory after one more barrier. Rows in shared
// memory are padded by 16 bytes, to an odd number of 16-byte chunks, so
// that the 8 rows an ldmatrix phase reads lie in 8 different bank groups.
// The accumulators go out as float2 straight from their fragment layout
// (row g and g + 8, columns 2t, 2t + 1 of each 8-column part). K runs in
// chunks of KC rows (the probe's K = 128 is one); from two chunks on, two
// buffers hold them, the next chunk's copies in flight while this chunk's
// products run. Pieces of a tile past M or N are not loaded, and their
// outputs are not stored. Exact for 0/1 planes: every partial sum is an
// integer below 2^24, so the shares add up to the same sum in any order. At
// the probe's size the kernel is a chain of latencies (a launch, a round
// trip, the products, a barrier, the stores) and ties torch.matmul's
// kernel; the tile was chosen from the readings of 12 tilings (PERF.md §6).
#ifndef PROBES_WITHOUT_ONEHOT
namespace oh {

constexpr int TM = 32, TN = 32;                     // the output tile a block
constexpr int KS = 4;                               // warps a part, each a share of K
constexpr int KC = 128;                             // rows of a and b a k-chunk
constexpr int PARTS = TM / 16 * (TN / 32);          // 16 x 32 parts of the tile
constexpr int THREADS = 32 * PARTS * KS;
constexpr int PA = 2 * TM + 16, PB = 2 * TN + 16;   // bytes a row of the a and b strips, padded
constexpr int STAGE = KC * (PA + PB);               // bytes of one chunk's strips
static_assert((KS - 1) * PARTS * 32 * 16 * 4 <= STAGE, "the k-split's sums fit a stage");
static_assert(2 * STAGE <= 48 * 1024, "two stages fit the shared memory a block takes unasked");

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int PENDING>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

__global__ void __launch_bounds__(THREADS)
onehot_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
              float* __restrict__ out, int K, int M, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  const int tiles_n = (N + TN - 1) / TN;
  const int m0 = blockIdx.x / tiles_n * TM, n0 = blockIdx.x % tiles_n * TN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int part = warp % PARTS, ks = warp / PARTS;  // ks: the warp's share of K
  const int wm = part / (TN / 32) * 16, wn = part % (TN / 32) * 32;  // in the tile
  const int chunks = (K + KC - 1) / KC;

  // every 16-byte piece of chunk c's strips, into buffer c & 1
  auto fetch = [&](int c) {
    const int k0 = c * KC, kc = min(KC, K - k0);
    const uint32_t sa = sbase + (c & 1) * STAGE, sb = sa + KC * PA;
    for (int p = threadIdx.x; p < kc * (TM / 8); p += THREADS) {
      const int row = p / (TM / 8), q = p % (TM / 8);
      if (m0 + 8 * q < M) cp_async16(sa + row * PA + 16 * q, a + (size_t)(k0 + row) * M + m0 + 8 * q);
    }
    for (int p = threadIdx.x; p < kc * (TN / 8); p += THREADS) {
      const int row = p / (TN / 8), q = p % (TN / 8);
      if (n0 + 8 * q < N) cp_async16(sb + row * PB + 16 * q, b + (size_t)(k0 + row) * N + n0 + 8 * q);
    }
    cp_commit();
  };

  // ldmatrix rows: lane 8q + i gives row i (+ 8) of 16-byte chunk (+ 1) of
  // matrix q; for a^T the matrices are (m 0-7, k 0-7), (m 8-15, k 0-7), (m
  // 0-7, k 8-15), (m 8-15, k 8-15), the fragment a[0..3]; for b (k 0-7, n
  // 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15): b0, b1 of two
  // 8-column parts
  const int q8 = lane >> 3, i8 = lane & 7;
  const uint32_t a_off = (i8 + 8 * (q8 >> 1)) * PA + 2 * wm + 16 * (q8 & 1);
  const uint32_t b_off = KC * PA + (i8 + 8 * (q8 & 1)) * PB + 2 * wn + 16 * (q8 >> 1);
  const bool live = m0 + wm < M && n0 + wn < N;  // the part has outputs to store
  float acc[4][4] = {};
  fetch(0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      fetch(c + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int kc = min(KC, K - c * KC);
    const uint32_t st = sbase + (c & 1) * STAGE;
    if (live) {
      for (int kk = 16 * ks; kk < kc; kk += 16 * KS) {  // k-steps ks, ks + KS, ...
        uint32_t fa[4], fb[2][4];
        tc::ldmatrix_x4_trans(fa, st + kk * PA + a_off);
        tc::ldmatrix_x4_trans(fb[0], st + kk * PB + b_off);
        tc::ldmatrix_x4_trans(fb[1], st + kk * PB + b_off + 32);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          tc::mma16816(acc[j], fa, fb[j >> 1][2 * (j & 1)], fb[j >> 1][2 * (j & 1) + 1], acc[j]);
      }
    }
    __syncthreads();  // buffer c & 1 is refilled with chunk c + 2, or holds the sums below
  }
  // the other shares' sums go through shared memory to share 0
  float* red = reinterpret_cast<float*>(smem) + (size_t)part * 32 * 16;
  if (ks > 0 && live) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(size_t)(ks - 1) * PARTS * 32 * 16 + (4 * j + e) * 32 + lane] = acc[j][e];
  }
  __syncthreads();
  if (ks > 0 || !live) return;
  for (int q = 0; q < KS - 1; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] += red[(size_t)q * PARTS * 32 * 16 + (4 * j + e) * 32 + lane];
  const int g = lane >> 2, t = lane & 3;
  float* o = out + (size_t)(m0 + wm + g) * N;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn + 8 * j + 2 * t;
    if (col < N) {
      *reinterpret_cast<float2*>(o + col) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(o + (size_t)8 * N + col) = make_float2(acc[j][2], acc[j][3]);
    }
  }
}

}  // namespace oh

// out (m, n) f32 = a (k, m)^T . b (k, n), bf16 row-major planes; k, m and
// n positive multiples of 16; a and b 16-byte aligned, out 8-byte aligned.
// Launches on `stream`, does not synchronise.
extern "C" int dpu_onehot_matmul_bf16(const void* a, const void* b, void* out, long long k,
                                      long long m, long long n, void* stream) {
  if (k < 16 || m < 16 || n < 16 || k % 16 || m % 16 || n % 16 || k > (1 << 24) ||
      m > (1 << 20) || n > (1 << 20) || ((uintptr_t)a | (uintptr_t)b) % 16 ||
      (uintptr_t)out % 8)
    return (int)cudaErrorInvalidValue;
  const long long grid = ((m + oh::TM - 1) / oh::TM) * ((n + oh::TN - 1) / oh::TN);
  const int smem = (k > oh::KC ? 2 : 1) * oh::STAGE;
  oh::onehot_kernel<<<(unsigned)grid, oh::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<float*>(out), (int)k, (int)m, (int)n);
  return (int)cudaGetLastError();
}
#endif  // PROBES_WITHOUT_ONEHOT

// out (rows, wi) = x (rows, wv) gathered along each row at idx (rows, wi,
// int32): ops/probes_cuda.py gather_plan's launch, `kernel` (WARP_ROWS for
// rows of at most ROW_WORDS values, one row a warp, ROW_WARPS a block;
// STAGED for any wv up to GATHER_WORDS, `per` rows a block) on `grid`
// blocks. Device pointers, 4-byte aligned; launches on `stream`, does not
// synchronise; returns 0 or the first CUDA error.
extern "C" int dpu_lane_gather_u32(const void* x, const void* idx, void* out, long long rows,
                                   long long wv, long long wi, int kernel, long long grid, int per,
                                   void* stream) {
  const bool fits = kernel == WARP_ROWS ? wv <= ROW_WORDS && per == ROW_WARPS
                    : kernel == STAGED  ? per >= 1 && per * wv <= GATHER_WORDS
                                        : false;
  if (rows < 0 || wv < 1 || wi < 1 || wi > GATHER_WORDS || !fits)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  if (grid < 1 || grid > 0x7FFFFFFFLL || grid < (rows + per - 1) / per)  // every row a block
    return (int)cudaErrorInvalidValue;
  const auto* xs = static_cast<const uint32_t*>(x);
  const auto* is = static_cast<const int32_t*>(idx);
  auto* os = static_cast<uint32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == WARP_ROWS)
    warp_row_gather_kernel<<<(unsigned)grid, 32 * ROW_WARPS, 0, s>>>(xs, is, os, rows, (int)wv,
                                                                     (int)wi);
  else
    row_gather_kernel<<<(unsigned)grid, GATHER_THREADS, per * wv * sizeof(uint32_t), s>>>(
        xs, is, os, rows, (int)wv, (int)wi, per);
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

// One launch of a kernel that does nothing, one warp, on `stream`.
extern "C" int dpu_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
