// Stable filter compaction, v4: the scan and the inverse map on the tensor
// cores. The Hopper counterpart of dpu_olap_tpu/ops/filter_pallas4.py
// (_call, _filter4_kernel; filter_compact_pallas4, filter_pallas4_padded,
// filter_with_indices_pallas4).
//
// Contract (the same function as csrc/filter.cu): out[:count] holds the
// values v < thr in input order and out[count:] holds `fill`; with indices,
// sel[:count] holds their row numbers and sel[count:] holds n; count is one
// device uint32. Any n below 2^32.
//
// The TPU kernel gets the in-row prefix and each output slot's source row
// from counting matrix products on 0/1 bf16 operands, exact in f32, and
// then gathers. Here the same counts come from wmma 16x16x16 products (fp16
// 0/1 or small-count operands, f32 accumulate) on fragments of 256 values,
// seen as a 16x16 mask M (row r = values 16r .. 16r + 15 of the fragment):
//   P = M x U, U[k][c] = [k <= c]: the in-row inclusive prefix;
//   E = Lstrict x B, Lstrict[r][k] = [k < r], B[k][c] = P[k][15] (row k's
//     count): every column of row r holds g_r, the row's exclusive start
//     in the fragment's run;
//   stage A: each row's kept values go to the front of the row, at rank
//     P - 1 (a store within the row, the TPU's stage A);
//   S = [OH | GT] x [LE ; 1] (K = 32, two products into one accumulator),
//     with g_r = 16 q_r + s_r, OH[a][r] = [q_r == a], GT[a][r] = [q_r < a],
//     LE[r][b] = [s_r <= b]: S[a][b] = #{r : g_r <= 16a + b}, so the source
//     row of output slot t = 16a + b is sr = S - 1 (the TPU's sr(p)), and
//     the value is row sr's front-compacted entry t - g_sr.
// Exactness: the operands are 0/1 except B, whose entries are row counts
// <= 16; fp16 holds every integer up to 2048. The products' partial sums
// over one k-fragment are at most 16 (P, S) and 16 * 15 = 240 (E), all far
// below 2^24, so f32 accumulation is exact and every count is an integer.
// The accumulators go to shared memory through store_matrix_sync; no
// fragment layout is assumed.
//
// A block of 4 warps takes a tile of TILE values (16 fragments, 4 per warp).
// The fragments' counts come from warp ballots first, so every warp knows
// where its fragments' runs start in the tile's; the tile's offset comes
// from the tile count and scan passes of csrc/filter_tiles.cuh (the TPU's
// sequential offset carry). Each fragment's run is written by one warp,
// lanes on consecutive slots. The triangular constants are built in shared
// memory once per block.
//
// What bounds it on the H100: device-memory traffic, 8n bytes (12n with
// indices): each input read once, each output written once; the products
// are 16 * 256 * 4 multiply-adds a fragment (64 a value), far below the
// tensor cores' rate. This kernel reads the input twice (count pass, tile).

#include <cuda_fp16.h>
#include <mma.h>

#include "filter_tiles.cuh"

namespace {

using namespace nvcuda;

constexpr int WARPS4 = 4;
constexpr int THREADS4 = 32 * WARPS4;
constexpr int FRAG = 256;  // values of one 16 x 16 fragment
constexpr int FRAGS = TILE / FRAG;
constexpr int FRAGS_PER_WARP = FRAGS / WARPS4;
constexpr int PER_LANE = FRAG / 32;

// One warp's shared memory (wmma pointers need 32-byte alignment).
struct __align__(32) WarpSmem {
  __half m[FRAG];       // the mask M, then the row counts B
  __half a2[16 * 32];   // [OH | GT], row-major, 32 columns
  __half b2[32 * 16];   // [LE ; ones], row-major, 16 columns
  float acc[FRAG];      // the products, row-major
  uint32_t cv[FRAG];    // each row's kept values at its front
  uint16_t ci[FRAG];    // and their positions in the tile
  int g[16];            // each row's start in the fragment's run
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __half, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __half, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ __half bit(bool b) { return __float2half(b ? 1.0f : 0.0f); }

__global__ void __launch_bounds__(THREADS4)
    mma_kernel(const uint32_t* __restrict__ x, long long n, uint32_t thr, uint32_t fill,
               const uint32_t* __restrict__ offs, const uint32_t* __restrict__ count,
               uint32_t* __restrict__ out, uint32_t* __restrict__ sel) {
  __shared__ __align__(32) __half s_u[FRAG];  // U[k][c] = [k <= c]
  __shared__ __align__(32) __half s_l[FRAG];  // Lstrict[r][k] = [k < r]
  __shared__ WarpSmem s_w[WARPS4];
  __shared__ unsigned s_fc[FRAGS + 1];  // fragment counts, then their exclusive scan
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * TILE;
  WarpSmem& w = s_w[warp];

  for (int e = threadIdx.x; e < FRAG; e += THREADS4) {
    const int r = e >> 4, c = e & 15;
    s_u[e] = bit(r <= c);
    s_l[e] = bit(c < r);
  }
  for (int e = lane; e < 16 * 16; e += 32) w.b2[16 * 16 + e] = bit(true);

  // the warp's values in registers; each fragment's count by ballots
  uint32_t vals[FRAGS_PER_WARP][PER_LANE];
#pragma unroll
  for (int h = 0; h < FRAGS_PER_WARP; ++h) {
    const long long fb = base + (long long)(warp * FRAGS_PER_WARP + h) * FRAG;
    unsigned c = 0;
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const long long i = fb + lane + 32 * k;
      vals[h][k] = i < n ? x[i] : 0xFFFFFFFFu;
      c += __popc(__ballot_sync(FULL, i < n && vals[h][k] < thr));
    }
    if (lane == 0) s_fc[warp * FRAGS_PER_WARP + h] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned run = 0;
    for (int f = 0; f < FRAGS; ++f) {
      const unsigned c = s_fc[f];
      s_fc[f] = run;
      run += c;
    }
    s_fc[FRAGS] = run;
  }
  __syncthreads();
  const unsigned long long tile_off = offs[blockIdx.x];

  FragA fa;
  FragB fb;
  FragC fc;
#pragma unroll
  for (int h = 0; h < FRAGS_PER_WARP; ++h) {
    const int f = warp * FRAGS_PER_WARP + h;
    const long long fbase = base + (long long)f * FRAG;
    const unsigned total = s_fc[f + 1] - s_fc[f];
    bool keep[PER_LANE];
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const int e = lane + 32 * k;
      keep[k] = fbase + e < n && vals[h][k] < thr;
      w.m[e] = bit(keep[k]);
    }
    __syncwarp();
    // P = M x U
    wmma::load_matrix_sync(fa, w.m, 16);
    wmma::load_matrix_sync(fb, s_u, 16);
    wmma::fill_fragment(fc, 0.0f);
    wmma::mma_sync(fc, fa, fb, fc);
    wmma::store_matrix_sync(w.acc, fc, 16, wmma::mem_row_major);
    __syncwarp();
    int pre[PER_LANE];
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const int e = lane + 32 * k;
      pre[k] = (int)w.acc[e];
      w.m[e] = __float2half(w.acc[(e & ~15) + 15]);  // B: the row's count
    }
    __syncwarp();
    // E = Lstrict x B
    wmma::load_matrix_sync(fa, s_l, 16);
    wmma::load_matrix_sync(fb, w.m, 16);
    wmma::fill_fragment(fc, 0.0f);
    wmma::mma_sync(fc, fa, fb, fc);
    wmma::store_matrix_sync(w.acc, fc, 16, wmma::mem_row_major);
    __syncwarp();
    if (lane < 16) w.g[lane] = (int)w.acc[lane * 16];
    // stage A: front-compact each row
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      if (keep[k]) {
        const int e = lane + 32 * k;
        const int slot = (e & ~15) + pre[k] - 1;
        w.cv[slot] = vals[h][k];
        w.ci[slot] = (uint16_t)(f * FRAG + e);
      }
    }
    __syncwarp();
    // the counting operands [OH | GT] and [LE ; ones]
    for (int e = lane; e < 16 * 32; e += 32) {
      const int a = e >> 5, col = e & 31;
      const int q = w.g[col & 15] >> 4;
      w.a2[e] = bit(col < 16 ? q == a : q < a);
    }
    for (int e = lane; e < 16 * 16; e += 32) w.b2[e] = bit((w.g[e >> 4] & 15) <= (e & 15));
    __syncwarp();
    wmma::fill_fragment(fc, 0.0f);
    wmma::load_matrix_sync(fa, w.a2, 32);
    wmma::load_matrix_sync(fb, w.b2, 16);
    wmma::mma_sync(fc, fa, fb, fc);
    wmma::load_matrix_sync(fa, w.a2 + 16, 32);
    wmma::load_matrix_sync(fb, w.b2 + 16 * 16, 16);
    wmma::mma_sync(fc, fa, fb, fc);
    wmma::store_matrix_sync(w.acc, fc, 16, wmma::mem_row_major);
    __syncwarp();
    // the gather: slot t takes row sr's entry t - g_sr
    const unsigned long long dst = tile_off + s_fc[f];
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const int t = lane + 32 * k;
      if ((unsigned)t < total) {
        const int sr = (int)w.acc[t] - 1;
        const int slot = sr * 16 + t - w.g[sr];
        out[dst + t] = w.cv[slot];
        if (sel) sel[dst + t] = (uint32_t)(base + w.ci[slot]);
      }
    }
    __syncwarp();
  }

  // this tile's share of the tail [count, n)
  const long long cnt = *count;
  for (int j = threadIdx.x; j < TILE; j += THREADS4) {
    const long long p = base + j;
    if (p < n && p >= cnt) {
      out[p] = fill;
      if (sel) sel[p] = (uint32_t)n;
    }
  }
}

}  // namespace

// Compact the n uint32 values at x that are < thr into out (tail = fill)
// and, when sel is not null, their row numbers into sel (tail = n); write
// the count to *count. tile_offs is scratch of ceil(n / TILE) uint32. All
// pointers are device pointers; n must be below 2^32. Launches on `stream`,
// does not synchronise; returns 0 or the first CUDA error.
extern "C" int dpu_filter4_u32(const void* x, long long n, unsigned thr, unsigned fill,
                               void* out, void* sel, void* tile_offs, void* count,
                               void* stream) {
  if (n < 0 || n > 0xFFFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return (int)cudaMemsetAsync(count, 0, sizeof(uint32_t), s);
  const uint32_t* xs = static_cast<const uint32_t*>(x);
  uint32_t* offs = static_cast<uint32_t*>(tile_offs);
  uint32_t* cnt = static_cast<uint32_t*>(count);
  const cudaError_t err = count_and_scan(xs, n, thr, offs, cnt, s);
  if (err != cudaSuccess) return (int)err;
  mma_kernel<<<(unsigned)tiles_of(n), THREADS4, 0, s>>>(
      xs, n, thr, fill, offs, cnt, static_cast<uint32_t*>(out), static_cast<uint32_t*>(sel));
  return (int)cudaGetLastError();
}
