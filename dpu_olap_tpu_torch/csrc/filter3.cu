// Stable filter compaction, v3: compaction staged in shared memory, then
// written out whole. The Hopper counterpart of
// dpu_olap_tpu/ops/filter_pallas3.py (_call, _filter3_kernel;
// filter_compact_pallas3, filter_pallas3_padded, filter_with_indices_pallas3).
//
// Contract (the same function as csrc/filter.cu): out[:count] holds the
// values v < thr in input order and out[count:] holds `fill`; with indices,
// sel[:count] holds their row numbers and sel[count:] holds n; count is one
// device uint32. Any n below 2^32.
//
// The TPU kernel front-compacts each row in fast memory, rotates it to the
// global lane phase and then moves only whole rows. Here a block stages its
// tile's compaction in shared memory and stores the result in one sweep,
// on v1's skeleton (csrc/filter.cu: a ticket, a warp look-back, a tail
// pass) around v3's own in-tile design:
//   sweep_kernel, a tile of TILE values a block, taken by an atomic ticket:
//     stage A: each warp owns a contiguous slice of SLICE values. A lane
//       issues all of its loads of the slice (16 bytes each where the tile
//       is whole and the input aligned) before the first is ranked; then
//       for each load, four ballots and __popc give each kept value its
//       place at the front of the warp's own slice of shared memory;
//     the tile publishes its count as soon as the warps' runs are counted;
//     stage B: the warps' runs move to their block-exclusive offsets, so
//       the tile's run lies packed at the front of shared memory (through
//       registers and a barrier, since a run may move over another warp's
//       slice);
//     one warp takes the tile's offset from the look-back
//       (csrc/lookback.cuh look_back_warp);
//     stage C: the run goes to out[offset, + run) in one coalesced sweep
//       (csrc/lookback.cuh store_run: scalar stores up to the first 16-byte
//       boundary, uint4 stores in between, scalar stores for the rest); the
//       last tile writes the count;
//   tail_kernel (csrc/lookback.cuh) writes `fill` (and n) over [count, n).
// Work memory (ops/filter_cuda.py filter_plan): one 64-bit status word a
// tile and the ticket, cleared by one cudaMemsetAsync: a call is one
// memset and two launches (csrc/lookback.cuh launch_filter), with no host
// decision, so it replays from a CUDA graph. Shared memory: one TILE of
// values, and one of row numbers only with indices (16 or 32 KB).
//
// What bounds it on the H100: device-memory traffic, 8n bytes (12n with
// indices): the input is read once and each output lane written once, by
// the sweep or by the tail.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 4096;           // ops/filter_alt_cuda.py TILE
constexpr int SLICE = TILE / WARPS;  // values a warp owns
constexpr int LOADS = SLICE / 128;   // 16-byte loads a lane makes in its slice
constexpr int ROUNDS = SLICE / 32;   // values a lane moves in stage B
constexpr unsigned FULL = 0xFFFFFFFFu;

// Stage B for one plane of shared memory: the warp's run buf[wbase, +run)
// moves to buf[off, +run). Every warp reads its run before any writes.
__device__ __forceinline__ void pack_run(uint32_t* buf, int wbase, unsigned run, unsigned off) {
  const int lane = threadIdx.x & 31;
  const bool moves = off != (unsigned)wbase;
  uint32_t r[ROUNDS];
#pragma unroll
  for (int q = 0; q < ROUNDS; ++q) {
    const unsigned k = q * 32 + lane;
    if (moves && k < run) r[q] = buf[wbase + k];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < ROUNDS; ++q) {
    const unsigned k = q * 32 + lane;
    if (moves && k < run) buf[off + k] = r[q];
  }
}

// One tile (see the note at the top). Lane l of warp w loads the values
// w * SLICE + 128 j + 4 l + (0..3) of the tile, j < LOADS. status: ntiles
// words and the ticket, zero at the start. The register caps were measured
// at 64Mi beside four, six and eight blocks an SM (PERF.md §6): without
// indices 40 registers (six blocks, as v1) were the fastest; with them 32
// (eight by registers, six by the 32 KB of shared memory).
template <bool IDX>
__global__ void __launch_bounds__(THREADS, IDX ? 8 : 6)
sweep_kernel(const uint32_t* __restrict__ x, long long n, uint32_t thr, bool vec,
             long long ntiles, uint32_t* __restrict__ out, uint32_t* __restrict__ sel,
             uint32_t* __restrict__ count, unsigned* ticket, unsigned long long* status) {
  __shared__ uint32_t s_v[TILE];
  __shared__ uint32_t s_i[IDX ? TILE : 1];
  __shared__ unsigned s_run[WARPS];
  __shared__ unsigned s_tile, s_before;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const long long base = tile * TILE;
  const bool whole = vec && base + TILE <= n;
  const int wbase = warp * SLICE;
  const long long first = base + wbase + 4 * lane;

  // stage A: every load of the slice started, then the front-compaction
  uint4 w[LOADS];
#pragma unroll
  for (int j = 0; j < LOADS; ++j) w[j] = load4(x, first + 128 * j, n, whole);
  unsigned run = 0;
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const long long i = first + 128 * j;
    const uint32_t v[4] = {w[j].x, w[j].y, w[j].z, w[j].w};
    bool keep[4];
    unsigned b[4];
    unsigned r = run;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      keep[e] = v[e] < thr && i + e < n;
      b[e] = __ballot_sync(FULL, keep[e]);
      r += __popc(b[e] & below);
      run += __popc(b[e]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (keep[e]) {
        s_v[wbase + r] = v[e];
        if constexpr (IDX) s_i[wbase + r] = (uint32_t)(i + e);
        ++r;
      }
    }
  }
  if (lane == 0) s_run[warp] = run;
  __syncthreads();
  unsigned off = 0, total = 0;
#pragma unroll
  for (int k = 0; k < WARPS; ++k) {
    const unsigned c = s_run[k];
    off += k < warp ? c : 0u;
    total += c;
  }
  unsigned long long* word = status + tile;
  if (threadIdx.x == 0) publish(word, tile == 0 ? FLAG_PREFIX : FLAG_AGG, total);

  // stage B, while the earlier tiles publish
  pack_run(s_v, wbase, run, off);
  if constexpr (IDX) pack_run(s_i, wbase, run, off);
  if (warp == 0) {
    unsigned before = 0;  // kept values in the earlier tiles
    if (tile > 0) {
      before = look_back_warp(status, tile);
      if (lane == 0) publish(word, FLAG_PREFIX, before + total);
    }
    if (lane == 0) {
      s_before = before;
      if (tile == ntiles - 1) *count = before + total;
    }
  }
  __syncthreads();

  // stage C
  const unsigned before = s_before;
  store_run<THREADS>(out, before, s_v, total);
  if constexpr (IDX) store_run<THREADS>(sel, before, s_i, total);
}

}  // namespace

// Compact the n uint32 values at x that are < thr into out (tail = fill)
// and, when sel is not null, their row numbers into sel (tail = n); write
// the count to *count. work holds ops/filter_cuda.py filter_plan's words:
// one uint64 a tile of 4096 and the ticket, which the function clears on
// the stream. out and sel must be 16-byte aligned. All pointers are device
// pointers; n must be below 2^32. Launches on `stream`, does not
// synchronise; returns 0 or the first CUDA error.
extern "C" int dpu_filter3_u32(const void* x, long long n, unsigned thr, unsigned fill,
                               void* out, void* sel, void* work, void* count, void* stream) {
  return launch_filter<THREADS>(sweep_kernel<false>, sweep_kernel<true>, TILE, x, n, thr, fill,
                                out, sel, work, count, stream);
}
