// Stable filter compaction of uint32 values below a threshold, optionally
// with their row indices. The Hopper counterpart of the TPU filter
// dpu_olap_tpu/ops/filter_pallas.py: filter_compact_pallas,
// filter_with_indices_pallas and filter_pallas_padded (_filter_kernel).
//
// Contract (dpu_olap_tpu/ops/filter.py:71-85, 144-155): out[:count] holds
// the values v < threshold in input order, out[count:] holds `fill`; with
// indices, sel[:count] holds their row numbers and sel[count:] holds n;
// count is written to a device uint32.
//
// The TPU kernel runs its grid in order and carries the running output
// offset from block to block, and it builds the in-block compaction out of
// what Mosaic offers: a butterfly concentrator network, an MXU prefix scan
// with triangular matrices, a landing strip and a lane-phase
// read-modify-write of the partial row blocks share. None of it is needed
// here. Blocks run in parallel and in no order, so the offsets come from a
// second pass instead of a carry, and a warp ballot gives each kept value
// its slot directly:
//   1. tile_count: each block counts the kept values of one tile of TILE
//      elements (__ballot_sync + __popc per warp);
//   2. tile_scan: one block turns the tile counts into exclusive tile
//      offsets in place and writes the total count;
//   3. tile_compact: each block re-reads its tile in order and writes each
//      kept value (and its row) at tile offset + kept values before it in
//      the tile (running count + earlier warps of the round + ballot
//      prefix); it also writes `fill` (and n) over its own share of the
//      tail [count, n).
//
// What bounds it on the H100: device-memory traffic. The input is read
// twice (count, compact), the kept values are written once and the tail
// once: about 3 passes over n at 25% selectivity, all coalesced. The
// single-pass decoupled look-back scan, which reads the input once, is
// later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;  // elements per thread per tile
constexpr int TILE = THREADS * ITEMS;  // ops/filter_cuda.py TILE
constexpr int SCAN_THREADS = 1024;
constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void tile_count_kernel(const uint32_t* __restrict__ x, long long n,
                                  uint32_t thr, uint32_t* __restrict__ tile_counts) {
  __shared__ unsigned warp_count[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * TILE;
  unsigned c = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j * THREADS + threadIdx.x;
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

__global__ void tile_compact_kernel(const uint32_t* __restrict__ x, long long n,
                                    uint32_t thr, uint32_t fill,
                                    const uint32_t* __restrict__ offs,
                                    const uint32_t* __restrict__ count,
                                    uint32_t* __restrict__ out,
                                    uint32_t* __restrict__ sel) {
  // double-buffered per-warp counts: one barrier per round suffices, since
  // a warp writes buffer j&1 only after every thread passed round j-1's
  // barrier, that is after every read of round j-2
  __shared__ unsigned warp_count[2][WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const long long base = (long long)blockIdx.x * TILE;
  unsigned run = offs[blockIdx.x];
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j * THREADS + threadIdx.x;
    uint32_t v = 0;
    bool keep = false;
    if (i < n) {
      v = x[i];
      keep = v < thr;
    }
    const unsigned ballot = __ballot_sync(FULL, keep);
    if (lane == 0) warp_count[j & 1][warp] = __popc(ballot);
    __syncthreads();
    unsigned before = 0, total = 0;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
      const unsigned c = warp_count[j & 1][k];
      before += k < warp ? c : 0u;
      total += c;
    }
    if (keep) {
      const unsigned pos = run + before + __popc(ballot & lanes_below);
      out[pos] = v;
      if (sel) sel[pos] = (uint32_t)i;
    }
    run += total;
  }
  // this tile's share of the tail: positions in [base, base + TILE) that
  // lie at or past the total count (kept values land below it)
  const long long cnt = *count;
  for (int j = 0; j < ITEMS; ++j) {
    const long long p = base + j * THREADS + threadIdx.x;
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
// pointers are device pointers; n must be below 2^32. Launches on `stream`
// and does not synchronise. Returns 0 or the first CUDA error.
extern "C" int dpu_filter_u32(const void* x, long long n, unsigned thr,
                              unsigned fill, void* out, void* sel,
                              void* tile_offs, void* count, void* stream) {
  if (n < 0 || n > 0xFFFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return (int)cudaMemsetAsync(count, 0, sizeof(uint32_t), s);
  const long long ntiles = (n + TILE - 1) / TILE;
  const uint32_t* xs = static_cast<const uint32_t*>(x);
  uint32_t* offs = static_cast<uint32_t*>(tile_offs);
  uint32_t* cnt = static_cast<uint32_t*>(count);
  tile_count_kernel<<<(unsigned)ntiles, THREADS, 0, s>>>(xs, n, thr, offs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(offs, ntiles, cnt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_compact_kernel<<<(unsigned)ntiles, THREADS, 0, s>>>(
      xs, n, thr, fill, offs, cnt, static_cast<uint32_t*>(out),
      static_cast<uint32_t*>(sel));
  return (int)cudaGetLastError();
}
