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
//   2. tail_kernel writes `fill` (and n) over [count, n), 16 bytes a store
//      where aligned: csrc/lookback.cuh's fill_lanes, as in
//      csrc/partition.cu's pad.
// Work memory (ops/filter_cuda.py filter_plan): one 64-bit status word a
// tile and the ticket, cleared by one cudaMemsetAsync: a call is one memset
// and two launches, with no host decision, so it replays from a CUDA graph.
// A tile that is not whole, or an input that is not 16-byte aligned (a
// view), reads with 4-byte loads.
//
// What bounds it on the H100: device-memory traffic. The input is read
// once and every output lane written once, by the sweep or by the tail: 8n
// bytes, 12n with indices.

#include "filter_tiles.cuh"
#include "lookback.cuh"

namespace {

constexpr int THREADS = COUNT_THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 4;              // values of a 16-byte access
constexpr int ROWS = 4;             // 16-byte accesses a thread makes
constexpr int ROW = THREADS * VEC;  // values of a row of the tile
constexpr int TAIL_BLOCKS = 1024;
constexpr int SWEEP_BLOCKS_PER_SM = 6;  // see sweep_kernel

static_assert(ROWS * ROW == TILE, "a tile is the count pass's tile");

// Four values at x + i: one 16-byte load when `vec`, else four loads of the
// positions below n.
__device__ __forceinline__ uint4 load4(const uint32_t* __restrict__ x, long long i, long long n,
                                       bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(x + i);
  uint32_t v[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) v[e] = i + e < n ? x[i + e] : 0u;
  return make_uint4(v[0], v[1], v[2], v[3]);
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

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
}

// csrc/lookback.cuh's look_back<1> by one warp, 32 status words a step: the
// kept values of the tiles before `tile`. It adds the counts of the
// published words up to and including the nearest inclusive prefix, and
// waits where a word before it is not published yet.
__device__ __forceinline__ unsigned look_back_warp(const unsigned long long* status,
                                                   long long tile) {
  const int lane = threadIdx.x & 31;
  const volatile unsigned long long* words = status;
  unsigned before = 0;
  long long t = tile - 1;  // the nearest tile not added yet
  for (;;) {
    const long long j = t - lane;
    const unsigned long long w = j >= 0 ? words[j] : FLAG_PREFIX;
    const unsigned long long flag = w & ~0xFFFFFFFFull;
    const unsigned pre = __ballot_sync(FULL, flag == FLAG_PREFIX);
    const unsigned unpub = __ballot_sync(FULL, flag == 0);
    const unsigned stop = pre & (0u - pre);  // the nearest inclusive prefix
    if (pre && !(unpub & (stop - 1u)))
      return before + warp_sum(lane < __ffs(pre) ? (unsigned)w : 0u);
    const int passed = unpub ? __ffs(unpub) - 1 : 32;  // aggregates before the first gap
    before += warp_sum(lane < passed ? (unsigned)w : 0u);
    t -= passed;
    if (passed == 0) __nanosleep(32);
  }
}

// One tile of the sweep (see the note at the top). Value (k, e) of a thread
// is tile position k * ROW + threadIdx.x * VEC + e. status: ntiles words and
// the ticket, zero at the start. tile_offs, when not null, receives each
// tile's exclusive offset (the stage ablation's output). At most 40
// registers a thread, so that six blocks share an SM: a tile holds its
// loads in flight only until its look-back, and more tiles an SM keep more
// bytes in flight. Measured beside four blocks at 52 registers and eight at
// 32 (PERF.md §6), it was the fastest.
template <bool IDX>
__global__ void __launch_bounds__(THREADS, SWEEP_BLOCKS_PER_SM)
sweep_kernel(const uint32_t* __restrict__ x, long long n, uint32_t thr, bool vec,
             long long ntiles, uint32_t* __restrict__ out, uint32_t* __restrict__ sel,
             uint32_t* __restrict__ count, uint32_t* __restrict__ tile_offs, unsigned* ticket,
             unsigned long long* status) {
  __shared__ uint32_t s_val[TILE];
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
  uint32_t v[ROWS][VEC];
  unsigned keep = 0;  // bit 4k + e
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const long long i = base + k * ROW + mine0;
    v[k][0] = w[k].x, v[k][1] = w[k].y, v[k][2] = w[k].z, v[k][3] = w[k].w;
#pragma unroll
    for (int e = 0; e < VEC; ++e) keep |= v[k][e] < thr && i + e < n ? 1u << (VEC * k + e) : 0u;
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
  unsigned long long* word = status + tile;
  if (threadIdx.x == 0) publish(word, tile == 0 ? FLAG_PREFIX : FLAG_AGG, total);

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

// out[count:] = fill, sel[count:] = n.
__global__ void __launch_bounds__(THREADS)
tail_kernel(const uint32_t* __restrict__ count, long long n, uint32_t fill,
            uint32_t* __restrict__ out, uint32_t* __restrict__ sel) {
  const long long from = *count;
  if (from >= n) return;
  fill_lanes<THREADS>(out, from, n, fill);
  if (sel) fill_lanes<THREADS>(sel, from, n, (uint32_t)n);
}

cudaError_t run_filter(const uint32_t* x, long long n, uint32_t thr, uint32_t fill,
                       uint32_t* out, uint32_t* sel, unsigned long long* work, uint32_t* count,
                       uint32_t* tile_offs, cudaStream_t s) {
  if (n == 0) return cudaMemsetAsync(count, 0, sizeof(uint32_t), s);
  const long long ntiles = tiles_of(n);
  cudaError_t err = cudaMemsetAsync(work, 0, (size_t)(ntiles + 1) * 8, s);
  if (err != cudaSuccess) return err;
  unsigned* ticket = reinterpret_cast<unsigned*>(work + ntiles);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (sel)
    sweep_kernel<true><<<(unsigned)ntiles, THREADS, 0, s>>>(x, n, thr, vec, ntiles, out, sel,
                                                            count, tile_offs, ticket, work);
  else
    sweep_kernel<false><<<(unsigned)ntiles, THREADS, 0, s>>>(x, n, thr, vec, ntiles, out, sel,
                                                             count, tile_offs, ticket, work);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long blocks = (n / 4 + THREADS - 1) / THREADS + 1;
  tail_kernel<<<(unsigned)(blocks < TAIL_BLOCKS ? blocks : TAIL_BLOCKS), THREADS, 0, s>>>(
      count, n, fill, out, sel);
  return cudaGetLastError();
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
// the filter cut at a stage. The first three stages are the two-pass
// skeleton of csrc/filter_tiles.cuh (a count pass, then a one-block scan)
// that filter3.cu and filter4.cu use; v1 is the one sweep above, so their
// differences do not split v1's time. Every stage writes what its caller
// reads:
//   STAGE_COPY  reads each tile and writes it to out (pure IO, 8n bytes);
//               *count = 0;
//   STAGE_COUNT the tile-count pass: tile_offs[t] = tile t's kept values
//               (4n bytes read); *count = 0;
//   STAGE_SCAN  count + the tile scan: tile_offs = exclusive tile offsets,
//               *count = the total (the TPU's `prefix` stage);
//   STAGE_FULL  the whole v1 filter into out (fill 0, no indices), with
//               each tile's exclusive offset in tile_offs.
// The TPU stages `lane_levels` and `row_levels` time the butterfly network's
// levels, which this kernel does not have; they have no counterpart.

namespace {

enum Stage { STAGE_COPY = 0, STAGE_COUNT = 1, STAGE_SCAN = 2, STAGE_FULL = 3 };
constexpr uint32_t STAGE_THRESHOLD = 1u << 30;  // the TPU variants' predicate v < 2^30

// The two-pass skeleton's read and write pattern with no selection.
__global__ void tile_copy_kernel(const uint32_t* __restrict__ x, long long n,
                                 uint32_t* __restrict__ out) {
  const long long base = (long long)blockIdx.x * TILE;
#pragma unroll
  for (int j = 0; j < COUNT_ITEMS; ++j) {
    const long long i = base + j * THREADS + threadIdx.x;
    if (i < n) out[i] = x[i];
  }
}

}  // namespace

// Run the v1 filter of the n values at x (predicate v < 2^30) up to `stage`
// (0 copy, 1 count, 2 scan, 3 full; see above). out (n uint32) is written by
// copy and full and may be null for count and scan; tile_offs holds
// ceil(n / TILE) uint32; work (filter_plan's words) is read by full only and
// may be null for the others; count is one device uint32. Launches on
// `stream`, does not synchronise; returns 0 or the first CUDA error.
extern "C" int dpu_filter_stage_u32(const void* x, long long n, int stage, void* out,
                                    void* tile_offs, void* work, void* count, void* stream) {
  if (n < 0 || n > 0xFFFFFFFFLL || stage < STAGE_COPY || stage > STAGE_FULL)
    return (int)cudaErrorInvalidValue;
  if ((stage == STAGE_COPY || stage == STAGE_FULL) && out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (stage == STAGE_FULL && work == nullptr) return (int)cudaErrorInvalidValue;
  const uint32_t thr = STAGE_THRESHOLD;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* xs = static_cast<const uint32_t*>(x);
  uint32_t* offs = static_cast<uint32_t*>(tile_offs);
  uint32_t* cnt = static_cast<uint32_t*>(count);
  if (stage == STAGE_FULL)
    return (int)run_filter(xs, n, thr, 0u, static_cast<uint32_t*>(out), nullptr,
                           static_cast<unsigned long long*>(work), cnt, offs, s);
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
