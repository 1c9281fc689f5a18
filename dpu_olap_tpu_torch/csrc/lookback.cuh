// The decoupled look-back (Merrill and Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back", 2016) of the one-sweep kernels:
// csrc/radix_sort.cu (256 buckets a tile) and csrc/partition.cu (P
// buckets a tile) walk the words with look_back; csrc/filter.cu and
// csrc/filter3.cu (one count a tile) walk them with a whole warp,
// look_back_warp. (csrc/scan.cu's look-back combines positions by max, in
// a layout of its own.) Each tile publishes one 64-bit status word per
// bucket, flag in the high 32 bits and count in the low 32, so that one
// store publishes both: FLAG_AGG with the tile's own count, then
// FLAG_PREFIX with the count of the bucket in every tile up to and
// including it. The words start at zero (not published). Tiles are taken
// by an atomic ticket, so a tile waits only on tiles whose blocks are
// already running. fill_lanes is the pad pass that follows the
// partition's and the filters' sweeps; load4 and tail_kernel are the two
// filter sweeps' shared load and tail pass.

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

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
  return v;
}

// look_back<1> by one warp, 32 status words a step: the count of the tiles
// before `tile`. It adds the counts of the published words up to and
// including the nearest inclusive prefix, and waits where a word before it
// is not published yet.
__device__ __forceinline__ unsigned look_back_warp(const unsigned long long* status,
                                                   long long tile) {
  constexpr unsigned all = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  const volatile unsigned long long* words = status;
  unsigned before = 0;
  long long t = tile - 1;  // the nearest tile not added yet
  for (;;) {
    const long long j = t - lane;
    const unsigned long long w = j >= 0 ? words[j] : FLAG_PREFIX;
    const unsigned long long flag = w & ~0xFFFFFFFFull;
    const unsigned pre = __ballot_sync(all, flag == FLAG_PREFIX);
    const unsigned unpub = __ballot_sync(all, flag == 0);
    const unsigned stop = pre & (0u - pre);  // the nearest inclusive prefix
    if (pre && !(unpub & (stop - 1u)))
      return before + warp_sum(lane < __ffs(pre) ? (unsigned)w : 0u);
    const int passed = unpub ? __ffs(unpub) - 1 : 32;  // aggregates before the first gap
    before += warp_sum(lane < passed ? (unsigned)w : 0u);
    t -= passed;
    if (passed == 0) __nanosleep(32);
  }
}

// Four values at x + i: one 16-byte load when `vec`, else four loads of the
// positions below n (0 past n).
__device__ __forceinline__ uint4 load4(const uint32_t* __restrict__ x, long long i, long long n,
                                       bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(x + i);
  uint32_t v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = i + e < n ? x[i + e] : 0u;
  return make_uint4(v[0], v[1], v[2], v[3]);
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

// The filters' tail pass: out[count:] = fill and, when sel is not null,
// sel[count:] = n, count read from the device.
template <int BLOCK>
__global__ void __launch_bounds__(BLOCK)
tail_kernel(const uint32_t* __restrict__ count, long long n, uint32_t fill,
            uint32_t* __restrict__ out, uint32_t* __restrict__ sel) {
  const long long from = *count;
  if (from >= n) return;
  fill_lanes<BLOCK>(out, from, n, fill);
  if (sel) fill_lanes<BLOCK>(sel, from, n, (uint32_t)n);
}

// tail_kernel on `s`, one BLOCK-thread block for every 4 * BLOCK lanes up
// to 1024 blocks. Returns the launch error.
template <int BLOCK>
cudaError_t launch_tail(const uint32_t* count, long long n, uint32_t fill, uint32_t* out,
                        uint32_t* sel, cudaStream_t s) {
  const long long blocks = (n / 4 + BLOCK - 1) / BLOCK + 1;
  tail_kernel<BLOCK><<<(unsigned)(blocks < 1024 ? blocks : 1024), BLOCK, 0, s>>>(count, n, fill,
                                                                                  out, sel);
  return cudaGetLastError();
}

}  // namespace
