// Stable filter compaction, v2: an output-driven gather. The Hopper
// counterpart of dpu_olap_tpu/ops/filter_pallas2.py (_call,
// _filter2_kernel; filter_compact_pallas2 and filter_with_indices_pallas2).
//
// Contract (the same function as csrc/filter.cu): out[:count] holds the
// values v < thr in input order and out[count:] holds `fill`; with indices,
// sel[:count] holds their row numbers and sel[count:] holds n; count is one
// device uint32. Any n below 2^32.
//
// The TPU kernel computes out[t] = in[sel(t)] from the output side, in two
// levels: a rank over the rows' kept-count prefix picks each output slot's
// source row (P2), and a 7-step search within the 128-lane row its lane
// (P1). Here the levels are words of 32 positions: the tile's keep bits in
// element order, 32 to a word, and an exclusive prefix of the words'
// counts. Output slot t of the tile's run finds its word by a 7-step
// search over the 128 prefixes, its position as the (t - prefix)-th set
// bit of the word (a popcount bisection), and reads the value from the
// tile staged in shared memory. On csrc/filter.cu's one-sweep skeleton
// (csrc/lookback.cuh):
//   sweep_kernel, a tile of TILE values a block, taken by an atomic ticket:
//     a thread issues all of its loads (16 bytes each where the tile is
//     whole and the input aligned) before the first is used, then stores
//     them to shared memory as they came;
//     each load's four keep bits go to the word of its 32 positions by
//     three shuffles (the eight lanes of a word OR their nibbles together);
//     one warp scans the 128 word counts, publishes the tile's count and
//     takes the tile's offset from the look-back (look_back_warp);
//     each thread takes four consecutive output slots and writes them with
//     one 16-byte store (the row numbers beside them with indices); a
//     scalar head up to the first 16-byte boundary and a scalar tail; the
//     last tile writes the count;
//   tail_kernel writes `fill` (and n) over [count, n).
// Work memory (ops/filter_cuda.py filter_plan): one 64-bit status word a
// tile and the ticket, cleared by one cudaMemsetAsync: a call is one
// memset and two launches (launch_filter), with no host decision, so it
// replays from a CUDA graph. Shared memory: the tile's values (16 KB) and
// the words and their prefixes (1 KB); a kept value's row number is its
// position, so indices need no plane of their own.
//
// What bounds it on the H100: device-memory traffic, 8n bytes (12n with
// indices): the input is read once and each output lane written once, by
// the sweep or by the tail.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 4096;                   // ops/filter_alt_cuda.py TILE
constexpr int LOADS = TILE / (4 * THREADS);  // 16-byte loads a thread makes
constexpr int WORDS = TILE / 32;             // keep words of a tile
constexpr int BLOCKS_PER_SM = 8;             // the sweep's launch bounds, see sweep_kernel
constexpr unsigned FULL = 0xFFFFFFFFu;

// The tile position of output slot t: the word whose prefix is the last
// one <= t (a word that holds slot t is never empty), then the
// (t - prefix)-th set bit of that word.
__device__ __forceinline__ unsigned source(const unsigned* pre, const unsigned* words,
                                           unsigned t) {
  unsigned w = 0;
#pragma unroll
  for (int step = WORDS / 2; step > 0; step >>= 1)
    if (pre[w + step] <= t) w += step;
  unsigned bits = words[w], r = t - pre[w], p = 0;
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    const unsigned c = __popc(bits & ((1u << half) - 1u));
    if (r >= c) {
      r -= c;
      bits >>= half;
      p += half;
    }
  }
  return 32 * w + p;
}

// One tile (see the note at the top). Thread i loads the tile positions
// 4 * THREADS * k + 4 i + (0..3), k < LOADS. status: ntiles words and the
// ticket, zero at the start. Eight blocks an SM (32 registers, none
// spilled, with and without indices) were the fastest at 64Mi, measured
// beside four (54 registers) and six (40; PERF.md §6).
template <bool IDX>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
sweep_kernel(const uint32_t* __restrict__ x, long long n, uint32_t thr, bool vec,
             long long ntiles, uint32_t* __restrict__ out, uint32_t* __restrict__ sel,
             uint32_t* __restrict__ count, unsigned* ticket, unsigned long long* status) {
  __shared__ __align__(16) uint32_t s_v[TILE];
  __shared__ __align__(16) unsigned s_word[WORDS];  // keep bits, position 32 w + b at bit b
  __shared__ __align__(16) unsigned s_pre[WORDS];   // the words' exclusive count prefix
  __shared__ unsigned s_tile, s_total, s_before;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const long long base = tile * TILE;
  const bool whole = vec && base + TILE <= n;
  const long long first = base + 4 * threadIdx.x;

  uint4 w[LOADS];  // every load started before any is used
#pragma unroll
  for (int k = 0; k < LOADS; ++k) w[k] = load4(x, first + 4 * THREADS * k, n, whole);
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    reinterpret_cast<uint4*>(s_v)[THREADS * k + threadIdx.x] = w[k];
    const long long i = first + 4 * THREADS * k;
    const uint32_t v[4] = {w[k].x, w[k].y, w[k].z, w[k].w};
    unsigned bits = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) bits |= v[e] < thr && i + e < n ? 1u << e : 0u;
    bits <<= 4 * (lane & 7);  // the lane's nibble in the word of its 32 positions
    bits |= __shfl_xor_sync(FULL, bits, 1);
    bits |= __shfl_xor_sync(FULL, bits, 2);
    bits |= __shfl_xor_sync(FULL, bits, 4);
    if ((lane & 7) == 0) s_word[(THREADS * k + threadIdx.x) / 8] = bits;
  }
  __syncthreads();

  if (warp == 0) {  // the words' prefix, four words a lane, then the look-back
    const uint4 q = reinterpret_cast<const uint4*>(s_word)[lane];
    const unsigned c0 = __popc(q.x), c1 = __popc(q.y), c2 = __popc(q.z), c3 = __popc(q.w);
    const unsigned own = c0 + c1 + c2 + c3;
    unsigned incl = own;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned up = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += up;
    }
    const unsigned excl = incl - own;
    reinterpret_cast<uint4*>(s_pre)[lane] =
        make_uint4(excl, excl + c0, excl + c0 + c1, excl + c0 + c1 + c2);
    const unsigned total = __shfl_sync(FULL, incl, 31);
    unsigned long long* word = status + tile;
    if (lane == 0) publish(word, tile == 0 ? FLAG_PREFIX : FLAG_AGG, total);
    unsigned before = 0;  // kept values in the earlier tiles
    if (tile > 0) {
      before = look_back_warp(status, tile);
      if (lane == 0) publish(word, FLAG_PREFIX, before + total);
    }
    if (lane == 0) {
      s_total = total;
      s_before = before;
      if (tile == ntiles - 1) *count = before + total;
    }
  }
  __syncthreads();

  // the tile's run to out[before, + total): four slots a thread and one
  // 16-byte store, between a scalar head and tail
  const unsigned total = s_total;
  const unsigned long long before = s_before;
  const unsigned lead = (unsigned)((4u - (unsigned)(before & 3u)) & 3u);
  const unsigned head = total < lead ? total : lead;
  const unsigned nvec = (total - head) / 4;
  const unsigned rest = head + 4 * nvec;
  if (threadIdx.x < head + (total - rest)) {  // the head and the tail, at most 3 slots each
    const unsigned t = threadIdx.x < head ? threadIdx.x : rest + threadIdx.x - head;
    const unsigned p = source(s_pre, s_word, t);
    out[before + t] = s_v[p];
    if constexpr (IDX) sel[before + t] = (uint32_t)(base + p);
  }
  for (unsigned q = threadIdx.x; q < nvec; q += THREADS) {
    const unsigned t = head + 4 * q;
    unsigned p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = source(s_pre, s_word, t + e);
    *reinterpret_cast<uint4*>(out + before + t) =
        make_uint4(s_v[p[0]], s_v[p[1]], s_v[p[2]], s_v[p[3]]);
    if constexpr (IDX) {
      const uint32_t b = (uint32_t)base;
      *reinterpret_cast<uint4*>(sel + before + t) =
          make_uint4(b + p[0], b + p[1], b + p[2], b + p[3]);
    }
  }
}

}  // namespace

// Compact the n uint32 values at x that are < thr into out (tail = fill)
// and, when sel is not null, their row numbers into sel (tail = n); write
// the count to *count. work holds ops/filter_cuda.py filter_plan's words:
// one uint64 a tile of 4096 and the ticket, which the function clears on
// the stream. out and sel must be 16-byte aligned. All pointers are device
// pointers; n must be below 2^32. Launches on `stream`, does not
// synchronise; returns 0 or the first CUDA error.
extern "C" int dpu_filter2_u32(const void* x, long long n, unsigned thr, unsigned fill,
                               void* out, void* sel, void* work, void* count, void* stream) {
  return launch_filter<THREADS>(sweep_kernel<false>, sweep_kernel<true>, TILE, x, n, thr, fill,
                                out, sel, work, count, stream);
}
