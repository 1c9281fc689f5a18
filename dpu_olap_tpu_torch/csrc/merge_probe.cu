// Merge-probe of a sorted uint32 probe column against a sorted build column:
// the Hopper counterpart of the TPU kernel
// dpu_olap_tpu/ops/merge_pallas.py:merge_probe_pallas (_merge_probe_kernel).
//
// For each probe element x: the last build position j with build[j] <= x
// (the greatest build key <= x; build keys are unique apart from an EMPTY
// tail), has = whether there is one, pkey = build[j] or 0xFFFFFFFF (EMPTY)
// where there is none, and each payload plane's value at j, or 0. The TPU
// kernel pads the build side with (EMPTY, 0) rows to its block size; the
// port reads the build column as it is (ops/merge_cuda.py says where that
// shows).
//
// The TPU kernel streams probe blocks against build chunks with an SMEM
// carry, bitonic-merges the two blocks in VMEM and extracts the probe rows
// with a butterfly, because Mosaic has no dynamic gather. Hopper has one.
// Here the sorted probe column is cut into tiles, and a tile is merged with
// the build range its keys can reach (a tiled range merge):
//   - a block takes a tile of TILE consecutive probe keys, ITEMS a thread,
//     loaded 16 bytes at a time where the column is aligned;
//   - two warps find the tile's build range [a, b): a is the number of
//     build keys <= the tile's first key, b that of its last key, so every
//     key of the tile finds its j in [a - 1, b). Each is a 32-ary search
//     (a warp probes 32 evenly spaced keys a step), about five dependent
//     loads at 2Mi instead of the 21 of a binary search;
//   - where b - a fits STAGE keys, the block stages build[a - 1 .. b) in
//     shared memory with coalesced loads, and each key counts the staged
//     keys <= it by a branchless binary search there (the same number of
//     steps for every thread, its ITEMS keys interleaved). Where the range
//     is wider (a probe much sparser than the build side: a tile's keys
//     spread over more than STAGE build keys), each key binary-searches the
//     narrowed range [a, b) in device memory. The tile decides on the
//     device: there is no host decision, and a call replays from a CUDA
//     graph;
//   - the payloads are read at j; the j of consecutive keys ascend, so a
//     warp's reads fall on few lines;
//   - has, pkey and the payloads leave as ITEMS consecutive values a thread
//     (4 bytes of has, 16 of each plane) where the outputs are aligned.
// Positions are 32-bit (the build side is shorter than 2^32); probe offsets
// are 64-bit.
//
// What bounds it on the H100: device-memory traffic, the probe read once,
// has, pkey and the payloads written once, the build keys and payloads
// read about once (a build key at a tile's edge is staged by both tiles).
// The searches are latency, hidden by the other blocks on the SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;                // probe keys a thread
constexpr int TILE = THREADS * ITEMS;   // probe keys a block (ops/merge_cuda.py TILE)
constexpr int STAGE = 4096;             // build keys a tile may stage (ops/merge_cuda.py STAGE)
constexpr int MAX_PAYLOADS = 8;  // ops/merge_cuda.py MAX_PAYLOADS
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint32_t EMPTY = 0xFFFFFFFFu;

static_assert(ITEMS % 4 == 0, "a thread's keys move 16 bytes at a time");

struct InPlanes {
  const uint32_t* p[MAX_PAYLOADS];
};

struct OutPlanes {
  uint32_t* p[MAX_PAYLOADS];
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ITEMS consecutive words, 16 bytes a load or store (p 16-byte aligned).
__device__ __forceinline__ void load_items(const uint32_t* p, uint32_t (&v)[ITEMS]) {
#pragma unroll
  for (int u = 0; u < ITEMS; u += 4) {
    const uint4 t = *reinterpret_cast<const uint4*>(p + u);
    v[u] = t.x;
    v[u + 1] = t.y;
    v[u + 2] = t.z;
    v[u + 3] = t.w;
  }
}

__device__ __forceinline__ void store_items(uint32_t* p, const uint32_t (&v)[ITEMS]) {
#pragma unroll
  for (int u = 0; u < ITEMS; u += 4)
    *reinterpret_cast<uint4*>(p + u) = make_uint4(v[u], v[u + 1], v[u + 2], v[u + 3]);
}

// lo plus the number of keys <= x in r[lo, hi), where every key before lo
// is <= x: a 32-ary search by the calling warp (all 32 lanes call it and
// get the same result). A step probes the last key of each of 32 equal
// parts of the range; the probes that hold keys <= x form a prefix of the
// lanes, and the range shrinks to the part after it.
__device__ uint32_t warp_upper_bound(const uint32_t* __restrict__ r, uint32_t lo, uint32_t hi,
                                     uint32_t x) {
  const unsigned long long lane = threadIdx.x & 31;
  while (lo < hi) {
    const uint32_t len = hi - lo;
    const unsigned long long step = len / 32 + (len % 32 != 0);
    const unsigned long long q = lo + (lane + 1) * step - 1;
    const bool le = q < hi && __ldg(r + q) <= x;
    const unsigned long long t = __popc(__ballot_sync(FULL, le));
    const unsigned long long top = lo + (t + 1) * step - 1;  // > x where it is < hi
    lo = (uint32_t)(lo + t * step);
    if (top < hi) hi = (uint32_t)top;
  }
  return lo;
}

// lo plus the number of keys <= x in r[lo, lo + len), where every key
// before lo is <= x: one thread's binary search.
__device__ __forceinline__ uint32_t upper_bound(const uint32_t* __restrict__ r, uint32_t lo,
                                                uint32_t len, uint32_t x) {
  while (len > 0) {
    const uint32_t half = len >> 1;
    if (__ldg(r + lo + half) <= x) {
      lo += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return lo;
}

template <int NP>
__global__ void __launch_bounds__(THREADS)
merge_probe_kernel(const uint32_t* __restrict__ left, long long nl,
                   const uint32_t* __restrict__ right, uint32_t nr, InPlanes pay,
                   uint8_t* __restrict__ has, uint32_t* __restrict__ pkey, OutPlanes out) {
  __shared__ uint32_t s_build[STAGE + 1];  // s_build[i] = right[a - 1 + i]
  __shared__ uint32_t s_range[2];          // a, b
  __shared__ uint32_t s_edge[2];           // the tile's first and last key

  const long long base = (long long)blockIdx.x * TILE;
  const int valid = (int)min((long long)TILE, nl - base);
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {  // warp 0: the tile's first key; warp 1: its last
    const uint32_t edge = __ldg(left + base + (warp == 0 ? 0 : valid - 1));
    const uint32_t u = warp_upper_bound(right, 0, nr, edge);
    if ((threadIdx.x & 31) == 0) {
      s_range[warp] = u;
      s_edge[warp] = edge;
    }
  }

  const int first = threadIdx.x * ITEMS;  // this thread's keys: tile positions first ..
  const bool full = first + ITEMS <= valid;
  uint32_t x[ITEMS];
  if (full && aligned16(left + base + first)) {
    load_items(left + base + first, x);
  } else {
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) x[u] = first + u < valid ? __ldg(left + base + first + u) : 0u;
  }
  __syncthreads();
  const uint32_t a = s_range[0];
  // b >= a for a sorted probe; an unsorted one may give b < a, and then
  // every key of the tile takes the whole-range search below
  const uint32_t m = s_range[1] >= a ? s_range[1] - a : 0u;

  uint32_t cnt[ITEMS];  // j + 1: the number of build keys <= x[u]
  uint32_t pk[ITEMS];   // right[j]; unused where cnt is 0
  if (m <= STAGE) {
    for (uint32_t i = threadIdx.x; i <= m; i += THREADS)
      s_build[i] = i > 0 || a > 0 ? __ldg(right + a - 1 + i) : EMPTY;
    __syncthreads();
    uint32_t c[ITEMS];  // staged keys <= x[u], in [0, m]
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) c[u] = 0;
    if (m > 0) {
      for (uint32_t step = 1u << (31 - __clz(m)); step; step >>= 1) {
#pragma unroll
        for (int u = 0; u < ITEMS; ++u)
          if (c[u] + step <= m && s_build[c[u] + step] <= x[u]) c[u] += step;
      }
    }
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      cnt[u] = a + c[u];
      pk[u] = s_build[c[u]];
    }
  } else {
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      cnt[u] = upper_bound(right, a, m, x[u]);
      pk[u] = cnt[u] > 0 ? __ldg(right + cnt[u] - 1) : EMPTY;
    }
  }
  // a key outside [first key, last key] of the tile (only an unsorted probe
  // has one) searches the whole build side: any order gets the right answer
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    if (first + u < valid && (x[u] < s_edge[0] || x[u] > s_edge[1])) {
      cnt[u] = upper_bound(right, 0, nr, x[u]);
      pk[u] = cnt[u] > 0 ? __ldg(right + cnt[u] - 1) : EMPTY;
    }
  }

  const long long o = base + first;
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) pk[u] = cnt[u] ? pk[u] : EMPTY;
  if (full && aligned16(pkey + o) && (reinterpret_cast<uintptr_t>(has + o) & 3) == 0) {
#pragma unroll
    for (int w = 0; w < ITEMS; w += 4) {  // 4 flags a 32-bit store
      uint32_t h = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) h |= (uint32_t)(cnt[w + u] > 0) << (8 * u);
      *reinterpret_cast<uint32_t*>(has + o + w) = h;
    }
    store_items(pkey + o, pk);
  } else {
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      if (first + u < valid) {
        has[o + u] = cnt[u] > 0;
        pkey[o + u] = pk[u];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    uint32_t v[ITEMS];
#pragma unroll
    for (int u = 0; u < ITEMS; ++u)
      v[u] = cnt[u] && first + u < valid ? __ldg(pay.p[q] + cnt[u] - 1) : 0u;
    if (full && aligned16(out.p[q] + o)) {
      store_items(out.p[q] + o, v);
    } else {
#pragma unroll
      for (int u = 0; u < ITEMS; ++u)
        if (first + u < valid) out.p[q][o + u] = v[u];
    }
  }
}

template <int NP>
cudaError_t launch(const uint32_t* left, long long nl, const uint32_t* right, uint32_t nr,
                   InPlanes pay, uint8_t* has, uint32_t* pkey, OutPlanes out, cudaStream_t s) {
  const unsigned blocks = (unsigned)((nl + TILE - 1) / TILE);
  merge_probe_kernel<NP><<<blocks, THREADS, 0, s>>>(left, nl, right, nr, pay, has, pkey, out);
  return cudaGetLastError();
}

}  // namespace

// For nl >= 1 probe keys (sorted: an unsorted probe gets the same answers,
// slower) and 0 <= nr < 2^32 sorted build keys with
// n_pay payload planes (0..8; host arrays of device pointers, nr uint32
// each in, nl each out): has (nl bytes), pkey (nl uint32) and the payloads of the
// last build position <= each probe key. Launches on `stream` and does not
// synchronise. Returns 0 or the CUDA error of the launch.
extern "C" int dpu_merge_probe_u32(const void* left, long long nl, const void* right, long long nr,
                                   void* const* payloads, int n_pay, void* has, void* pkey,
                                   void* const* out_pays, void* stream) {
  if (nl < 1 || nr < 0 || nr > 0xFFFFFFFFll || n_pay < 0 || n_pay > MAX_PAYLOADS ||
      (nl + TILE - 1) / TILE > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  InPlanes pay{};
  OutPlanes out{};
  for (int q = 0; q < n_pay; ++q) {
    pay.p[q] = static_cast<const uint32_t*>(payloads[q]);
    out.p[q] = static_cast<uint32_t*>(out_pays[q]);
  }
  const uint32_t* l = static_cast<const uint32_t*>(left);
  const uint32_t* r = static_cast<const uint32_t*>(right);
  uint8_t* h = static_cast<uint8_t*>(has);
  uint32_t* k = static_cast<uint32_t*>(pkey);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_pay) {
    case 0: return (int)launch<0>(l, nl, r, nr, pay, h, k, out, s);
    case 1: return (int)launch<1>(l, nl, r, nr, pay, h, k, out, s);
    case 2: return (int)launch<2>(l, nl, r, nr, pay, h, k, out, s);
    case 3: return (int)launch<3>(l, nl, r, nr, pay, h, k, out, s);
    case 4: return (int)launch<4>(l, nl, r, nr, pay, h, k, out, s);
    case 5: return (int)launch<5>(l, nl, r, nr, pay, h, k, out, s);
    case 6: return (int)launch<6>(l, nl, r, nr, pay, h, k, out, s);
    case 7: return (int)launch<7>(l, nl, r, nr, pay, h, k, out, s);
    default: return (int)launch<8>(l, nl, r, nr, pay, h, k, out, s);
  }
}
