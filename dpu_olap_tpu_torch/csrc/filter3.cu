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
// tile's compaction in shared memory and stores the result in one sweep:
//   stage A: each warp owns a contiguous slice of SLICE elements, reads it
//     in rounds of 32 (one 128-byte load a round) and writes its kept values
//     to the front of its own slice of shared memory (ballot + __popc rank);
//   stage B: the warps' runs move to their block-exclusive offsets, so the
//     tile's run lies packed at the front of shared memory (through
//     registers and a barrier, since a run may move over a lower warp's
//     slice);
//   stage C: the run goes to out[tile offset, + run) in one coalesced sweep:
//     scalar stores up to the first 16-byte boundary, uint4 stores in
//     between, scalar stores for the rest; then the block writes `fill` (and
//     n) over its own share of the tail [count, n).
// Tile offsets come from the tile count and scan passes of
// csrc/filter_tiles.cuh, the counterpart of the TPU's sequential offset
// carry. Shared memory: one TILE of values and one of row numbers (32 KB).
//
// What bounds it on the H100: device-memory traffic, 8n bytes (12n with
// indices): each input read once, each output written once. This kernel
// reads the input twice (count pass, stage A), as v1 does.

#include "filter_tiles.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SLICE = TILE / WARPS;  // elements a warp owns
constexpr int ROUNDS = SLICE / 32;

// g[o + k] = s[k] for k < total, 16-byte stores where g + o + k is aligned.
__device__ __forceinline__ void store_run(uint32_t* __restrict__ g, unsigned long long o,
                                          const uint32_t* s, unsigned total) {
  const unsigned lead = (unsigned)((4u - (unsigned)(o & 3u)) & 3u);
  const unsigned head = total < lead ? total : lead;
  if (threadIdx.x < head) g[o + threadIdx.x] = s[threadIdx.x];
  const unsigned nvec = (total - head) / 4;
  uint4* gv = reinterpret_cast<uint4*>(g + o + head);
  for (unsigned q = threadIdx.x; q < nvec; q += THREADS) {
    const unsigned k = head + 4 * q;
    gv[q] = make_uint4(s[k], s[k + 1], s[k + 2], s[k + 3]);
  }
  for (unsigned k = head + 4 * nvec + threadIdx.x; k < total; k += THREADS) g[o + k] = s[k];
}

__global__ void __launch_bounds__(THREADS)
    stage_kernel(const uint32_t* __restrict__ x, long long n, uint32_t thr, uint32_t fill,
                 const uint32_t* __restrict__ offs, const uint32_t* __restrict__ count,
                 uint32_t* __restrict__ out, uint32_t* __restrict__ sel) {
  __shared__ uint32_t s_v[TILE];
  __shared__ uint32_t s_i[TILE];
  __shared__ unsigned s_run[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const long long base = (long long)blockIdx.x * TILE;
  const int wbase = warp * SLICE;

  // stage A: front-compact the warp's slice
  unsigned run = 0;
#pragma unroll 4
  for (int r = 0; r < ROUNDS; ++r) {
    const long long i = base + wbase + r * 32 + lane;
    uint32_t v = 0;
    bool keep = false;
    if (i < n) {
      v = x[i];
      keep = v < thr;
    }
    const unsigned ballot = __ballot_sync(FULL, keep);
    if (keep) {
      const unsigned k = run + __popc(ballot & lanes_below);
      s_v[wbase + k] = v;
      if (sel) s_i[wbase + k] = (uint32_t)i;
    }
    run += __popc(ballot);
  }
  if (lane == 0) s_run[warp] = run;
  __syncthreads();

  // stage B: each warp's run to its offset in the block's run
  unsigned off = 0, total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const unsigned c = s_run[w];
    off += w < warp ? c : 0u;
    total += c;
  }
  uint32_t rv[ROUNDS], ri[ROUNDS];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const unsigned k = r * 32 + lane;
    if (k < run) {
      rv[r] = s_v[wbase + k];
      if (sel) ri[r] = s_i[wbase + k];
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const unsigned k = r * 32 + lane;
    if (k < run) {
      s_v[off + k] = rv[r];
      if (sel) s_i[off + k] = ri[r];
    }
  }
  __syncthreads();

  // stage C: the tile's run, then this tile's share of the tail
  const unsigned long long o = offs[blockIdx.x];
  store_run(out, o, s_v, total);
  if (sel) store_run(sel, o, s_i, total);
  const long long cnt = *count;
  for (int j = 0; j < TILE / THREADS; ++j) {
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
// the count to *count. tile_offs is scratch of ceil(n / TILE) uint32; out
// and sel must be 16-byte aligned. All pointers are device pointers; n must
// be below 2^32. Launches on `stream`, does not synchronise; returns 0 or
// the first CUDA error.
extern "C" int dpu_filter3_u32(const void* x, long long n, unsigned thr, unsigned fill,
                               void* out, void* sel, void* tile_offs, void* count,
                               void* stream) {
  if (n < 0 || n > 0xFFFFFFFFLL) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(sel)) & 15u)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return (int)cudaMemsetAsync(count, 0, sizeof(uint32_t), s);
  const uint32_t* xs = static_cast<const uint32_t*>(x);
  uint32_t* offs = static_cast<uint32_t*>(tile_offs);
  uint32_t* cnt = static_cast<uint32_t*>(count);
  const cudaError_t err = count_and_scan(xs, n, thr, offs, cnt, s);
  if (err != cudaSuccess) return (int)err;
  stage_kernel<<<(unsigned)tiles_of(n), THREADS, 0, s>>>(
      xs, n, thr, fill, offs, cnt, static_cast<uint32_t*>(out), static_cast<uint32_t*>(sel));
  return (int)cudaGetLastError();
}
