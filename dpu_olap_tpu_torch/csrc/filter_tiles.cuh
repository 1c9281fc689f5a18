// The two passes that give the filter kernels their tile offsets: a tile
// count and a one-block exclusive scan of the counts. filter3.cu and
// filter4.cu take their offsets from them, and csrc/filter.cu's stage
// ablation times them; they stand in for the TPU kernels' sequential SMEM
// offset carry (blocks here run in no order). v1 itself (csrc/filter.cu)
// carries its offsets by a look-back instead and uses only TILE and
// tiles_of. Included by each of those sources: the kernels are per file.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int COUNT_THREADS = 256;
constexpr int COUNT_ITEMS = 16;  // elements per thread per tile
constexpr int TILE = COUNT_THREADS * COUNT_ITEMS;  // ops/filter_cuda.py TILE
constexpr int SCAN_THREADS = 1024;
constexpr unsigned FULL = 0xFFFFFFFFu;

// tile_counts[t] = the values < thr among tile t's TILE elements.
__global__ void tile_count_kernel(const uint32_t* __restrict__ x, long long n,
                                  uint32_t thr, uint32_t* __restrict__ tile_counts) {
  constexpr int WARPS = COUNT_THREADS / 32;
  __shared__ unsigned warp_count[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * TILE;
  unsigned c = 0;
#pragma unroll
  for (int j = 0; j < COUNT_ITEMS; ++j) {
    const long long i = base + j * COUNT_THREADS + threadIdx.x;
    const bool keep = i < n && x[i] < thr;
    c += __popc(__ballot_sync(FULL, keep));
  }
  if (lane == 0) warp_count[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned t = 0;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) t += warp_count[k];
    tile_counts[blockIdx.x] = t;
  }
}

// One block: exclusive scan of ntiles counts in place; *count = the total.
__global__ void tile_scan_kernel(uint32_t* __restrict__ offs, long long ntiles,
                                 uint32_t* __restrict__ count) {
  __shared__ unsigned part[SCAN_THREADS];
  const int t = threadIdx.x;
  const long long per = (ntiles + SCAN_THREADS - 1) / SCAN_THREADS;
  const long long lo = t * per;
  const long long hi = lo + per < ntiles ? lo + per : ntiles;
  unsigned s = 0;
  for (long long i = lo; i < hi; ++i) s += offs[i];
  part[t] = s;
  __syncthreads();
  for (int d = 1; d < SCAN_THREADS; d <<= 1) {  // inclusive Hillis-Steele scan
    const unsigned v = t >= d ? part[t - d] : 0u;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  unsigned run = t ? part[t - 1] : 0u;
  for (long long i = lo; i < hi; ++i) {
    const unsigned c = offs[i];
    offs[i] = run;
    run += c;
  }
  if (t == SCAN_THREADS - 1) *count = part[t];
}

long long tiles_of(long long n) { return (n + TILE - 1) / TILE; }

// Both passes on `s`: offs[t] = the kept values of the tiles before t,
// *count = all kept values. Returns the first launch error.
cudaError_t count_and_scan(const uint32_t* x, long long n, uint32_t thr, uint32_t* offs,
                           uint32_t* count, cudaStream_t s) {
  const long long ntiles = tiles_of(n);
  tile_count_kernel<<<(unsigned)ntiles, COUNT_THREADS, 0, s>>>(x, n, thr, offs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tile_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(offs, ntiles, count);
  return cudaGetLastError();
}

}  // namespace
