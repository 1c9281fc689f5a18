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
// here. Blocks run in parallel and in no order, so the offsets cross tiles
// by a decoupled look-back (csrc/lookback.cuh), in one sweep:
//   1. sweep_kernel:
//      - a block takes its tile of TILE values by an atomic ticket, so that
//        every tile it waits on belongs to a block that is already running;
//      - it reads the tile once, 16 bytes a thread a row: a thread holds
//        four runs of four consecutive values;
//      - a run's kept count (0-4) goes out in three ballots, one a bit, so
//        that the popcounts of the lanes below give each run its offset in
//        the warp, and a sum over the warps the rest;
//      - it publishes its count, stages its kept values (and their row
//        numbers) in shared memory in input order, then takes its offset
//        from the look-back (one warp reads 32 earlier words a step), and
//        writes them out as one contiguous run, 16 bytes a store where the
//        run's address allows;
//      - the last tile writes the count.
//   2. csrc/lookback.cuh's tail_kernel writes `fill` (and n) over [count,
//      n), 16 bytes a store where aligned (fill_lanes, as in
//      csrc/partition.cu's pad).
// Work memory (ops/filter_cuda.py filter_plan): one 64-bit status word a
// tile and the ticket, cleared by one cudaMemsetAsync: a call is one memset
// and two launches, with no host decision, so it replays from a CUDA graph.
// csrc/filter3.cu runs the same skeleton around its own in-tile design.
// A tile that is not whole, or an input that is not 16-byte aligned (a
// view), reads with 4-byte loads.
//
// What bounds it on the H100: device-memory traffic. The input is read
// once and every output lane written once, by the sweep or by the tail: 8n
// bytes, 12n with indices.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 4;              // values of a 16-byte access
constexpr int ROWS = 4;             // 16-byte accesses a thread makes
constexpr int ROW = THREADS * VEC;  // values of a row of the tile
constexpr int TILE = ROWS * ROW;    // ops/filter_cuda.py TILE
constexpr int SWEEP_BLOCKS_PER_SM = 6;  // see sweep_kernel
constexpr unsigned FULL = 0xFFFFFFFFu;

// How far sweep_kernel runs: the whole filter, or one of the stage
// ablation's cuts of it (see the end of the file).
enum Stage { STAGE_COPY = 0, STAGE_COUNT = 1, STAGE_PREFIX = 2, STAGE_LOOKBACK = 3, STAGE_FULL = 4 };

long long tiles_of(long long n) { return (n + TILE - 1) / TILE; }

// The four values of w to out + i: one 16-byte store when `vec`, else a
// store for each position below n.
__device__ __forceinline__ void store4(uint32_t* __restrict__ out, long long i, long long n,
                                       bool vec, uint4 w) {
  if (vec) {
    *reinterpret_cast<uint4*>(out + i) = w;
    return;
  }
  const uint32_t v[VEC] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    if (i + e < n) out[i + e] = v[e];
}

// dst[j] = src[j] for j < count by the block: a scalar head up to 16-byte
// alignment of dst, then 16-byte stores, then a scalar tail.
__device__ __forceinline__ void write_run(uint32_t* __restrict__ dst, const uint32_t* src,
                                          int count) {
  const int t = threadIdx.x;
  const uintptr_t word = reinterpret_cast<uintptr_t>(dst) >> 2;  // 4-byte word address
  const int head = min(count, (int)((4 - word) & 3));
  if (t < head) dst[t] = src[t];
  const int vecs = (count - head) / 4;
  uint4* vd = reinterpret_cast<uint4*>(dst + head);
  for (int j = t; j < vecs; j += THREADS) {
    const uint32_t* s = src + head + 4 * j;
    vd[j] = make_uint4(s[0], s[1], s[2], s[3]);
  }
  const int rest = head + 4 * vecs;
  if (t < count - rest) dst[rest + t] = src[rest + t];
}

// dst[j] = 0 for j < count by the block, stored as write_run stores.
__device__ __forceinline__ void zero_run(uint32_t* __restrict__ dst, int count) {
  const int t = threadIdx.x;
  const uintptr_t word = reinterpret_cast<uintptr_t>(dst) >> 2;
  const int head = min(count, (int)((4 - word) & 3));
  if (t < head) dst[t] = 0u;
  const int vecs = (count - head) / 4;
  uint4* vd = reinterpret_cast<uint4*>(dst + head);
  for (int j = t; j < vecs; j += THREADS) vd[j] = make_uint4(0u, 0u, 0u, 0u);
  const int rest = head + 4 * vecs;
  if (t < count - rest) dst[rest + t] = 0u;
}

// One tile of the sweep (see the note at the top), up to STAGE. Value (k,
// e) of a thread is tile position k * ROW + threadIdx.x * VEC + e. status:
// ntiles words and the ticket, zero at the start. tile_offs, when not
// null, receives each tile's exclusive offset (the stage ablation's
// output; its cut stages write the tile's count there). At most 40
// registers a thread, so that six blocks share an SM: a tile holds its
// loads in flight only until its look-back, and more tiles an SM keep more
// bytes in flight. Measured beside four blocks at 52 registers and eight at
// 32 (PERF.md §6), it was the fastest. The cut stages keep the bounds, the
// ticket and the grid, and end where the stage ends: copy stores the loaded
// tile back in place, count stores it back too (before its ballots, so that
// the tile is not held across the barrier), prefix writes the tile's
// compaction at the tile's own base.
template <bool IDX, int STAGE>
__global__ void __launch_bounds__(THREADS, SWEEP_BLOCKS_PER_SM)
sweep_kernel(const uint32_t* __restrict__ x, long long n, uint32_t thr, bool vec,
             long long ntiles, uint32_t* __restrict__ out, uint32_t* __restrict__ sel,
             uint32_t* __restrict__ count, uint32_t* __restrict__ tile_offs, unsigned* ticket,
             unsigned long long* status) {
  __shared__ uint32_t s_val[STAGE >= STAGE_PREFIX ? TILE : 1];
  __shared__ uint32_t s_row[IDX ? TILE : 1];
  __shared__ unsigned s_warp[ROWS][WARPS];  // a warp's kept values in a row
  __shared__ unsigned s_tile, s_before;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const long long base = tile * TILE;
  const bool whole = vec && base + TILE <= n;
  const int mine0 = threadIdx.x * VEC;  // the thread's first position in a row

  uint4 w[ROWS];  // every load started before any is used
#pragma unroll
  for (int k = 0; k < ROWS; ++k) w[k] = load4(x, base + k * ROW + mine0, n, whole);
  if constexpr (STAGE == STAGE_COPY) {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) store4(out, base + k * ROW + mine0, n, whole, w[k]);
    if (threadIdx.x == 0 && tile == ntiles - 1) *count = 0;
    return;
  }
  uint32_t v[ROWS][VEC];
  unsigned keep = 0;  // bit 4k + e
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const long long i = base + k * ROW + mine0;
    v[k][0] = w[k].x, v[k][1] = w[k].y, v[k][2] = w[k].z, v[k][3] = w[k].w;
#pragma unroll
    for (int e = 0; e < VEC; ++e) keep |= v[k][e] < thr && i + e < n ? 1u << (VEC * k + e) : 0u;
  }
  if constexpr (STAGE == STAGE_COUNT) {  // stored as loaded, before the ballots
#pragma unroll
    for (int k = 0; k < ROWS; ++k) store4(out, base + k * ROW + mine0, n, whole, w[k]);
  }

  // rank[k]: the kept values of the warp's row k before the thread's run
  const unsigned below = (1u << lane) - 1u;
  unsigned rank[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const unsigned c = __popc((keep >> (VEC * k)) & 0xFu);
    const unsigned b0 = __ballot_sync(FULL, c & 1u);
    const unsigned b1 = __ballot_sync(FULL, c & 2u);
    const unsigned b2 = __ballot_sync(FULL, c & 4u);
    rank[k] = __popc(b0 & below) + 2 * __popc(b1 & below) + 4 * __popc(b2 & below);
    if (lane == 0) s_warp[k][warp] = __popc(b0) + 2 * __popc(b1) + 4 * __popc(b2);
  }
  __syncthreads();
  unsigned total = 0;  // over the rows and warps in tile order
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    unsigned pre = total;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const unsigned c = s_warp[k][w];
      pre += w < warp ? c : 0u;
      total += c;
    }
    rank[k] += pre;
  }
  if constexpr (STAGE == STAGE_COUNT) {
    if (threadIdx.x == 0) {
      tile_offs[tile] = total;
      if (tile == ntiles - 1) *count = 0;
    }
    return;
  }
  unsigned long long* word = status + tile;
  if (STAGE == STAGE_FULL && threadIdx.x == 0)
    publish(word, tile == 0 ? FLAG_PREFIX : FLAG_AGG, total);

  // stage the kept values in input order while the earlier tiles publish
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    unsigned r = rank[k];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      if ((keep >> (VEC * k + e)) & 1u) {
        s_val[r] = v[k][e];
        if constexpr (IDX) s_row[r] = (uint32_t)(base + k * ROW + mine0 + e);
        ++r;
      }
    }
  }
  if constexpr (STAGE == STAGE_PREFIX) {
    if (threadIdx.x == 0) {
      tile_offs[tile] = total;
      if (tile == ntiles - 1) *count = 0;
    }
    __syncthreads();
    const int len = (int)min((long long)TILE, n - base);
    write_run(out + base, s_val, (int)total);
    zero_run(out + base + total, len - (int)total);
    return;
  }
  if (warp == 0) {
    unsigned before = 0;  // kept values in the earlier tiles
    if (tile > 0) {
      before = look_back_warp(status, tile);
      if (lane == 0) publish(word, FLAG_PREFIX, before + total);
    }
    if (lane == 0) {
      s_before = before;
      if (tile_offs) tile_offs[tile] = before;
      if (tile == ntiles - 1) *count = before + total;
    }
  }
  __syncthreads();
  const unsigned before = s_before;
  write_run(out + before, s_val, (int)total);
  if constexpr (IDX) write_run(sel + before, s_row, (int)total);
}

// One memset of the work words, then the sweep up to STAGE (STAGE_FULL:
// the whole sweep); n > 0.
template <int STAGE>
cudaError_t run_sweep(const uint32_t* x, long long n, uint32_t thr, bool vec, uint32_t* out,
                      uint32_t* sel, unsigned long long* work, uint32_t* count,
                      uint32_t* tile_offs, cudaStream_t s) {
  const long long ntiles = tiles_of(n);
  cudaError_t err = cudaMemsetAsync(work, 0, (size_t)(ntiles + 1) * 8, s);
  if (err != cudaSuccess) return err;
  unsigned* ticket = reinterpret_cast<unsigned*>(work + ntiles);
  if (STAGE == STAGE_FULL && sel)
    sweep_kernel<true, STAGE_FULL><<<(unsigned)ntiles, THREADS, 0, s>>>(
        x, n, thr, vec, ntiles, out, sel, count, tile_offs, ticket, work);
  else
    sweep_kernel<false, STAGE><<<(unsigned)ntiles, THREADS, 0, s>>>(
        x, n, thr, vec, ntiles, out, sel, count, tile_offs, ticket, work);
  return cudaGetLastError();
}

cudaError_t run_filter(const uint32_t* x, long long n, uint32_t thr, uint32_t fill,
                       uint32_t* out, uint32_t* sel, unsigned long long* work, uint32_t* count,
                       uint32_t* tile_offs, cudaStream_t s) {
  if (n == 0) return cudaMemsetAsync(count, 0, sizeof(uint32_t), s);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const cudaError_t err = run_sweep<STAGE_FULL>(x, n, thr, vec, out, sel, work, count,
                                                tile_offs, s);
  if (err != cudaSuccess) return err;
  return launch_tail<THREADS>(count, n, fill, out, sel, s);
}

}  // namespace

// Compact the n uint32 values at x that are < thr into out (tail = fill)
// and, when sel is not null, their row numbers into sel (tail = n); write
// the count to *count. work holds ops/filter_cuda.py filter_plan's words:
// one uint64 a tile of 4096 and the ticket, which the function clears on
// the stream. All pointers are device pointers; n must be below 2^32.
// Launches on `stream` and does not synchronise. Returns 0 or the first
// CUDA error.
extern "C" int dpu_filter_u32(const void* x, long long n, unsigned thr,
                              unsigned fill, void* out, void* sel,
                              void* work, void* count, void* stream) {
  if (n < 0 || n > 0xFFFFFFFFLL) return (int)cudaErrorInvalidValue;
  return (int)run_filter(static_cast<const uint32_t*>(x), n, thr, fill,
                         static_cast<uint32_t*>(out), static_cast<uint32_t*>(sel),
                         static_cast<unsigned long long*>(work), static_cast<uint32_t*>(count),
                         nullptr, static_cast<cudaStream_t>(stream));
}

// ---- the stage ablation ----------------------------------------------------
// Counterpart of the TPU filter's stage-ablated variants
// (scripts/measure_filter.py _variant_kernel/_variant, section `parts`):
// the filter cut at a stage of its own kernel. Every stage is one memset of
// filter_plan's work words and one sweep_kernel launch with v1's ticket,
// launch bounds and grid (full adds the tail pass), reads the input once
// and writes n values (lookback: count of them), so the differences
// between consecutive stages split v1's time. The predicate is v < 2^30.
//   STAGE_COPY     the tile's loads, stored back in place: out = the
//                  values; *count = 0;
//   STAGE_COUNT    + the predicate, the three ballots a row and the tile
//                  total: out = the values; tile_offs[t] = tile t's kept
//                  values; *count = 0;
//   STAGE_PREFIX   + the ranks and the kept values staged in shared memory,
//                  written at the tile's own base with zeros up to the
//                  tile's end: out = each tile's own compaction; tile_offs =
//                  the counts; *count = 0;
//   STAGE_LOOKBACK + publish and the warp look-back, the run written at its
//                  global offset (v1's sweep, no tail pass): out[:count] =
//                  v1's, out[count:] not written; tile_offs = exclusive
//                  offsets; *count = the total;
//   STAGE_FULL     v1 with fill 0 (sweep + tail pass), tile_offs as above.
// The TPU stages `lane_levels` and `row_levels` time the butterfly network's
// levels, which this kernel does not have; they have no counterpart.

namespace {
constexpr uint32_t STAGE_THRESHOLD = 1u << 30;  // the TPU variants' predicate v < 2^30
}  // namespace

// Run the v1 filter of the n values at x (predicate v < 2^30) up to `stage`
// (0 copy, 1 count, 2 prefix, 3 lookback, 4 full; see above). out holds n
// uint32, tile_offs ceil(n / 4096) uint32, work filter_plan's words, count
// one device uint32; none may be null. Launches on `stream`, does not
// synchronise; returns 0 or the first CUDA error.
extern "C" int dpu_filter_stage_u32(const void* x, long long n, int stage, void* out,
                                    void* tile_offs, void* work, void* count, void* stream) {
  if (n < 0 || n > 0xFFFFFFFFLL || stage < STAGE_COPY || stage > STAGE_FULL)
    return (int)cudaErrorInvalidValue;
  if (out == nullptr || tile_offs == nullptr || work == nullptr || count == nullptr)
    return (int)cudaErrorInvalidValue;
  const uint32_t thr = STAGE_THRESHOLD;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* xs = static_cast<const uint32_t*>(x);
  uint32_t* o = static_cast<uint32_t*>(out);
  uint32_t* offs = static_cast<uint32_t*>(tile_offs);
  unsigned long long* w = static_cast<unsigned long long*>(work);
  uint32_t* cnt = static_cast<uint32_t*>(count);
  if (stage == STAGE_FULL) return (int)run_filter(xs, n, thr, 0u, o, nullptr, w, cnt, offs, s);
  if (n == 0) return (int)cudaMemsetAsync(cnt, 0, sizeof(uint32_t), s);
  // the cut stages store whole tiles with 16-byte stores only where out is aligned too
  const bool vec = reinterpret_cast<uintptr_t>(xs) % 16 == 0;
  const bool vec_io = vec && reinterpret_cast<uintptr_t>(o) % 16 == 0;
  switch (stage) {
    case STAGE_COPY:
      return (int)run_sweep<STAGE_COPY>(xs, n, thr, vec_io, o, nullptr, w, cnt, offs, s);
    case STAGE_COUNT:
      return (int)run_sweep<STAGE_COUNT>(xs, n, thr, vec_io, o, nullptr, w, cnt, offs, s);
    case STAGE_PREFIX:
      return (int)run_sweep<STAGE_PREFIX>(xs, n, thr, vec, o, nullptr, w, cnt, offs, s);
    default:  // STAGE_LOOKBACK: v1's whole sweep, without the tail pass
      return (int)run_sweep<STAGE_FULL>(xs, n, thr, vec, o, nullptr, w, cnt, offs, s);
  }
}
