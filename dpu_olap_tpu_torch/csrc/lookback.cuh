// The decoupled look-back (Merrill and Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back", 2016) of the one-sweep kernels:
// csrc/radix_sort.cu (256 buckets a tile) and csrc/partition.cu (P
// buckets a tile); csrc/filter.cu (one count a tile) shares the word
// layout and walks the words with a whole warp. (csrc/scan.cu's look-back
// combines positions by max, in a layout of its own.) Each tile publishes
// one 64-bit status word per bucket, flag in the high 32 bits and count in
// the low 32, so that one store publishes both: FLAG_AGG with the tile's own count, then FLAG_PREFIX with
// the count of the bucket in every tile up to and including it. The words
// start at zero (not published). Tiles are taken by an atomic ticket, so a
// tile waits only on tiles whose blocks are already running. fill_lanes is
// the pad pass that follows the partition's and the filter's sweeps.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned long long FLAG_AGG = 1ull << 32;
constexpr unsigned long long FLAG_PREFIX = 2ull << 32;
constexpr int LOOKBACK = 8;  // status words a look-back step reads at once

__device__ __forceinline__ void publish(unsigned long long* word, unsigned long long flag,
                                        unsigned count) {
  *reinterpret_cast<volatile unsigned long long*>(word) = flag | count;
}

// Bucket b's count in the tiles before `tile`, where status[t * STRIDE + b]
// is tile t's word for bucket b: walks back over the words LOOKBACK at a
// time, adding counts up to and including the nearest inclusive prefix,
// waiting where a word is not published yet. Tile 0 always publishes a
// prefix, so the walk ends there.
template <int STRIDE>
__device__ __forceinline__ unsigned look_back(const unsigned long long* status, long long tile,
                                              unsigned b) {
  unsigned before = 0;
  long long t = tile - 1;
  for (;;) {
    const volatile unsigned long long* words = status + b;
    unsigned long long w[LOOKBACK];
#pragma unroll
    for (int u = 0; u < LOOKBACK; ++u) w[u] = t - u >= 0 ? words[(t - u) * STRIDE] : FLAG_PREFIX;
    int u = 0;
    for (; u < LOOKBACK; ++u) {
      const unsigned long long flag = w[u] & ~0xFFFFFFFFull;
      if (flag == 0) break;  // not published yet: its block is running
      before += (unsigned)w[u];
      if (flag == FLAG_PREFIX) return before;
    }
    t -= u;
    if (u < LOOKBACK) __nanosleep(32);
  }
}

// plane[j] = v for j in [from, end): a scalar head up to 16-byte alignment,
// then 16-byte stores, then a scalar tail, grid-strided over the blocks of
// x, each of BLOCK threads.
template <int BLOCK>
__device__ __forceinline__ void fill_lanes(uint32_t* plane, long long from, long long end,
                                           uint32_t v) {
  const long long stride = (long long)gridDim.x * BLOCK;
  const long long t0 = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const uintptr_t word = reinterpret_cast<uintptr_t>(plane + from) >> 2;  // 4-byte word address
  const long long head = min(end - from, (long long)((4 - word) & 3));
  if (t0 < head) plane[from + t0] = v;
  const long long body = from + head;
  const long long vecs = (end - body) / 4;
  uint4* vp = reinterpret_cast<uint4*>(plane + body);
  const uint4 vv = make_uint4(v, v, v, v);
  for (long long i = t0; i < vecs; i += stride) vp[i] = vv;
  const long long tail = body + vecs * 4;
  if (t0 < end - tail) plane[tail + t0] = v;
}

}  // namespace
