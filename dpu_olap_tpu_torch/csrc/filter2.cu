// Stable filter compaction, v2: an output-driven gather in one pass. The
// Hopper counterpart of dpu_olap_tpu/ops/filter_pallas2.py (_call,
// _filter2_kernel; filter_compact_pallas2 and filter_with_indices_pallas2).
//
// Contract (the same function as csrc/filter.cu): out[:count] holds the
// values v < thr in input order and out[count:] holds `fill`; with indices,
// sel[:count] holds their row numbers and sel[count:] holds n; count is one
// device uint32. Any n below 2^32.
//
// The TPU kernel computes out[t] = in[sel(t)] from the output side: each
// output slot searches the in-row prefix for its source, and the offset
// across blocks rides a sequential SMEM carry. Here:
//   1. a block takes its tile by an atomic ticket (not by blockIdx, so that
//      every tile it waits on belongs to a block that is already running),
//      loads the tile into shared memory and builds the tile's inclusive
//      kept-value prefix there: one warp ballot per round, then one warp's
//      scan of the 128 ballot counts;
//   2. it gets its exclusive output offset by a decoupled look-back: it
//      publishes its count (flag AGG), then walks back over its
//      predecessors' published words, adding aggregates, until it meets an
//      inclusive prefix (flag PREFIX), and publishes its own. Flag and value
//      share one 64-bit word, so one store publishes both; it is written
//      after a __threadfence() and read as volatile;
//   3. each thread takes output slots t of the tile's run and binary-
//      searches the shared prefix for the first position whose prefix
//      exceeds t: that position's value goes to out[offset + t], so the
//      writes are contiguous;
//   4. a second launch writes the tail [count, n), which only the total
//      fixes; it writes nothing below count.
// The ticket and the flags are scratch from the wrapper, cleared by
// cudaMemsetAsync on the stream (capture-safe).
//
// What bounds it on the H100: device-memory traffic, 8n bytes (12n with
// indices): each input read once, each output written once. Unlike v1
// (csrc/filter.cu), it reads its input once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;  // elements per thread per tile
constexpr int TILE = THREADS * ITEMS;  // ops/filter_alt_cuda.py TILE
constexpr int SLOTS = ITEMS * WARPS;  // ballot counts of a tile, in element order
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned long long FLAG_AGG = 1ull;
constexpr unsigned long long FLAG_PREFIX = 2ull;
constexpr int TAIL_THREADS = 256;
constexpr long long TAIL_BLOCKS = 132 * 8;

__device__ __forceinline__ void publish(unsigned long long* word, unsigned long long flag,
                                        unsigned value) {
  __threadfence();
  *reinterpret_cast<volatile unsigned long long*>(word) = (flag << 32) | value;
}

__global__ void __launch_bounds__(THREADS)
    gather_kernel(const uint32_t* __restrict__ x, long long n, uint32_t thr, long long ntiles,
                  unsigned* ticket, unsigned long long* status, uint32_t* __restrict__ out,
                  uint32_t* __restrict__ sel, uint32_t* __restrict__ count) {
  __shared__ uint32_t s_val[TILE];
  __shared__ uint16_t s_pre[TILE];  // inclusive kept prefix, at most TILE
  __shared__ unsigned s_slot[SLOTS];
  __shared__ unsigned s_tile, s_total, s_excl;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const long long base = tile * TILE;

  // 1. the tile into shared memory, one ballot per warp and round
  unsigned ballots[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j * THREADS + threadIdx.x;
    uint32_t v = 0;
    bool keep = false;
    if (i < n) {
      v = x[i];
      keep = v < thr;
    }
    s_val[j * THREADS + threadIdx.x] = v;
    ballots[j] = __ballot_sync(FULL, keep);
    if (lane == 0) s_slot[j * WARPS + warp] = __popc(ballots[j]);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the SLOTS counts, SLOTS / 32 a lane
    constexpr int PER = SLOTS / 32;
    unsigned c[PER];
    unsigned sum = 0;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      c[q] = s_slot[lane * PER + q];
      sum += c[q];
    }
    unsigned incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned up = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += up;
    }
    unsigned run = incl - sum;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      s_slot[lane * PER + q] = run;
      run += c[q];
    }
    if (lane == 31) s_total = incl;
  }
  __syncthreads();
  const unsigned lanes_upto = (2u << lane) - 1u;  // this lane and those below
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    s_pre[j * THREADS + threadIdx.x] =
        (uint16_t)(s_slot[j * WARPS + warp] + __popc(ballots[j] & lanes_upto));

  // 2. decoupled look-back for the tile's exclusive output offset
  if (threadIdx.x == 0) {
    const unsigned total = s_total;
    unsigned excl = 0;
    if (tile == 0) {
      publish(status, FLAG_PREFIX, total);
    } else {
      publish(status + tile, FLAG_AGG, total);
      for (long long j = tile - 1;;) {
        const unsigned long long w = *reinterpret_cast<volatile unsigned long long*>(status + j);
        const unsigned long long flag = w >> 32;
        if (flag == 0) {  // not published yet: its block is running, wait
          __nanosleep(32);
          continue;
        }
        excl += (unsigned)w;
        if (flag == FLAG_PREFIX) break;
        --j;
      }
      publish(status + tile, FLAG_PREFIX, excl + total);
    }
    s_excl = excl;
    if (tile == ntiles - 1) *count = excl + total;
  }
  __syncthreads();

  // 3. each output slot t finds its source: the first position whose
  // inclusive prefix exceeds t (a branchless search over the TILE prefixes)
  const unsigned total = s_total;
  const unsigned long long dst = s_excl;
  for (unsigned t = threadIdx.x; t < total; t += THREADS) {
    int p = 0;
#pragma unroll
    for (int step = TILE / 2; step > 0; step >>= 1)
      if (s_pre[p + step - 1] <= t) p += step;
    out[dst + t] = s_val[p];
    if (sel) sel[dst + t] = (uint32_t)(base + p);
  }
}

// 4. the tail [count, n): fill and n
__global__ void tail_kernel(uint32_t* __restrict__ out, uint32_t* __restrict__ sel, long long n,
                            const uint32_t* __restrict__ count, uint32_t fill) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = *count + (long long)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += stride) {
    out[p] = fill;
    if (sel) sel[p] = (uint32_t)n;
  }
}

}  // namespace

// Compact the n uint32 values at x that are < thr into out (tail = fill)
// and, when sel is not null, their row numbers into sel (tail = n); write
// the count to *count. scratch holds ceil(n / TILE) + 1 uint64 (the ticket,
// then one status word per tile). All pointers are device pointers; n must
// be below 2^32. Launches on `stream`, does not synchronise; returns 0 or
// the first CUDA error.
extern "C" int dpu_filter2_u32(const void* x, long long n, unsigned thr, unsigned fill,
                               void* out, void* sel, void* scratch, void* count,
                               void* stream) {
  if (n < 0 || n > 0xFFFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return (int)cudaMemsetAsync(count, 0, sizeof(uint32_t), s);
  const long long ntiles = (n + TILE - 1) / TILE;
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)(ntiles + 1) * 8, s);
  if (err != cudaSuccess) return (int)err;
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  uint32_t* o = static_cast<uint32_t*>(out);
  uint32_t* sl = static_cast<uint32_t*>(sel);
  uint32_t* cnt = static_cast<uint32_t*>(count);
  gather_kernel<<<(unsigned)ntiles, THREADS, 0, s>>>(
      static_cast<const uint32_t*>(x), n, thr, ntiles, reinterpret_cast<unsigned*>(words),
      words + 1, o, sl, cnt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n + TAIL_THREADS - 1) / TAIL_THREADS;
  tail_kernel<<<(unsigned)(blocks < TAIL_BLOCKS ? blocks : TAIL_BLOCKS), TAIL_THREADS, 0, s>>>(
      o, sl, n, cnt, fill);
  return (int)cudaGetLastError();
}
