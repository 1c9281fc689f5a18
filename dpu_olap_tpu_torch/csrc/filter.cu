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

#include "filter_tiles.cuh"

namespace {

constexpr int THREADS = COUNT_THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = COUNT_ITEMS;  // elements per thread per tile

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
  const long long ntiles = tiles_of(n);
  const uint32_t* xs = static_cast<const uint32_t*>(x);
  uint32_t* offs = static_cast<uint32_t*>(tile_offs);
  uint32_t* cnt = static_cast<uint32_t*>(count);
  const cudaError_t err = count_and_scan(xs, n, thr, offs, cnt, s);
  if (err != cudaSuccess) return (int)err;
  tile_compact_kernel<<<(unsigned)ntiles, THREADS, 0, s>>>(
      xs, n, thr, fill, offs, cnt, static_cast<uint32_t*>(out),
      static_cast<uint32_t*>(sel));
  return (int)cudaGetLastError();
}

// ---- the stage ablation ----------------------------------------------------
// Counterpart of the TPU filter's stage-ablated variants
// (scripts/measure_filter.py _variant_kernel/_variant, section `parts`): the
// v1 skeleton above cut at a stage, so that differences of stage times
// attribute v1's time. Every stage writes what its caller reads:
//   STAGE_COPY  reads each tile and writes it to out (pure IO, 8n bytes);
//               *count = 0;
//   STAGE_COUNT the tile-count pass: tile_offs[t] = tile t's kept values
//               (4n bytes read); *count = 0;
//   STAGE_SCAN  count + the tile scan: tile_offs = exclusive tile offsets,
//               *count = the total (the TPU's `prefix` stage);
//   STAGE_FULL  the whole v1 filter into out (fill 0, no indices).
// The TPU stages `lane_levels` and `row_levels` time the butterfly network's
// levels, which this kernel does not have; they have no counterpart.

namespace {

enum Stage { STAGE_COPY = 0, STAGE_COUNT = 1, STAGE_SCAN = 2, STAGE_FULL = 3 };
constexpr uint32_t STAGE_THRESHOLD = 1u << 30;  // the TPU variants' predicate v < 2^30

// The compaction's read and write pattern with no selection.
__global__ void tile_copy_kernel(const uint32_t* __restrict__ x, long long n,
                                 uint32_t* __restrict__ out) {
  const long long base = (long long)blockIdx.x * TILE;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j * THREADS + threadIdx.x;
    if (i < n) out[i] = x[i];
  }
}

}  // namespace

// Run the v1 filter of the n values at x (predicate v < 2^30) up to `stage`
// (0 copy, 1 count, 2 scan, 3 full; see above). out (n uint32) is written by
// copy and full and may be null for count and scan; tile_offs holds
// ceil(n / TILE) uint32; count is one device uint32. Launches on `stream`,
// does not synchronise; returns 0 or the first CUDA error.
extern "C" int dpu_filter_stage_u32(const void* x, long long n, int stage, void* out,
                                    void* tile_offs, void* count, void* stream) {
  if (n < 0 || n > 0xFFFFFFFFLL || stage < STAGE_COPY || stage > STAGE_FULL)
    return (int)cudaErrorInvalidValue;
  if ((stage == STAGE_COPY || stage == STAGE_FULL) && out == nullptr)
    return (int)cudaErrorInvalidValue;
  const uint32_t thr = STAGE_THRESHOLD;
  if (stage == STAGE_FULL)
    return dpu_filter_u32(x, n, thr, 0u, out, nullptr, tile_offs, count, stream);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* xs = static_cast<const uint32_t*>(x);
  uint32_t* offs = static_cast<uint32_t*>(tile_offs);
  uint32_t* cnt = static_cast<uint32_t*>(count);
  if (n == 0 || stage != STAGE_SCAN) {
    const cudaError_t err = cudaMemsetAsync(cnt, 0, sizeof(uint32_t), s);
    if (err != cudaSuccess || n == 0) return (int)err;
  }
  const long long ntiles = tiles_of(n);
  if (stage == STAGE_COPY) {
    tile_copy_kernel<<<(unsigned)ntiles, THREADS, 0, s>>>(xs, n, static_cast<uint32_t*>(out));
  } else if (stage == STAGE_COUNT) {
    tile_count_kernel<<<(unsigned)ntiles, COUNT_THREADS, 0, s>>>(xs, n, thr, offs);
  } else {
    return (int)count_and_scan(xs, n, thr, offs, cnt, s);
  }
  return (int)cudaGetLastError();
}
