// Stable LSD radix sort of a uint32 key plane with up to MAX_PAYLOADS uint32
// payload planes following it: the Hopper counterpart of the TPU merge-tree
// sort dpu_olap_tpu/ops/sort_pallas.py:sort_bitonic (the XLA leaf sort and
// its three Pallas kernels, _cascade_rounds_kernel, _xblock_kernel and
// _cascade_kernel).
//
// The TPU sort is a bitonic network because Mosaic has no dynamic scatter.
// Hopper has scatter, so this is a radix sort on the one-sweep design
// (Adinets and Merrill, "Onesweep: A Faster Least Significant Digit Radix
// Sort for GPUs", 2022; Merrill and Garland's decoupled look-back, 2016):
//   1. histogram_kernel reads the keys once and counts all four 8-bit digits
//      at once, into per-warp shared-memory counters, then adds each block's
//      counts to the global histograms with one atomic per bucket.
//   2. digit_pass_kernel, once per digit (least significant first), reads
//      key and carried planes once and writes them once:
//      - a block takes its tile of TILE keys by an atomic ticket, not by
//        blockIdx, so that every tile it waits on belongs to a block that
//        is already running (as csrc/filter2.cu does);
//      - it turns the pass's histogram into the buckets' global starts, an
//        exclusive scan over the 256 buckets, on the device;
//      - each key's rank among the tile's keys of its digit comes from a
//        warp multi-split: __match_any_sync groups the lanes of one digit,
//        the group's lowest lane adds the group's size to the warp's
//        shared counter of that digit and broadcasts the count before it,
//        and a scan over the warps joins them. Stable: a warp holds ITEMS
//        runs of 32 consecutive keys and ranks them in order. CHUNK items
//        go through each step together, so that no item waits on the one
//        before it;
//      - the tile's 256 bucket counts go out through a decoupled look-back
//        (csrc/lookback.cuh), thread b for bucket b: it publishes its count
//        (flag AGG), walks back over the earlier tiles' words, adding
//        counts, until it meets an inclusive prefix (flag PREFIX), and
//        publishes its own. Flag and count share one 64-bit word, so one
//        store publishes both;
//      - the tile's keys and first carried plane (loaded with the keys)
//        are re-ordered by digit in shared memory before the look-back
//        waits, and written after it, so that each bucket's run leaves as
//        consecutive addresses of consecutive threads; further planes
//        follow one at a time through the same buffer;
//      - a pass whose digit is the same for every key (its bucket holds all
//        n) skips the ranking and the look-back and copies the tile: the
//        order is already right. The device decides this; every pass runs.
// The passes ping-pong between the outputs and one set of scratch planes:
// in -> alt, alt -> out, out -> alt, alt -> out, so after four passes the
// outputs hold the result (ops/sort_cuda.py PASS_PLANES).
//
// Every payload plane rides every pass. Carrying a 32-bit row index instead,
// and reading each payload at its row in the last pass, measured slower at
// 2 to 8 payloads (PERF.md): a row read is a random 32-byte sector for 4
// bytes.
//
// Contract (ops/sort_cuda.py): keys come out in ascending unsigned order,
// stable, with their payloads; every key is an ordinary key, 0xFFFFFFFF
// included; outputs are n long, with no pad; 1 <= n <= 2^32 - 1. Offsets
// are 64-bit. Work memory (ops/sort_cuda.py radix_plan): one 64-bit status
// word per (pass, tile, bucket), four 256-bucket histograms and four
// tickets, cleared by one cudaMemsetAsync on the stream, then the
// ping-pong planes. The whole sort is one memset and five launches, with
// no host synchronisation, so it can be captured in a CUDA graph.
//
// What bounds it on the H100: device-memory traffic. Each pass reads and
// writes key and payload planes once, and the histogram reads the keys
// once: 4 + 4 * 8 * (1 + payloads) bytes a key, against the bitonic
// network's 28 passes of 8 * (1 + payloads) at 2Mi.
// At 2Mi keys the data sits in the 50 MB L2, and a pass is bound by the
// latency of its tiles (two waves of them) instead.

#include <cstdint>

#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int RADIX_BITS = 8;
constexpr int RADIX = 1 << RADIX_BITS;  // buckets a digit
constexpr int PASSES = 32 / RADIX_BITS;
constexpr int THREADS = 256;  // == RADIX: thread b scans and looks back for bucket b
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;  // keys a thread holds
constexpr int CHUNK = 8;  // items ranked together (see digit_pass_kernel)
constexpr int WARP_KEYS = ITEMS * 32;
constexpr int TILE = THREADS * ITEMS;  // ops/sort_cuda.py RADIX_TILE
constexpr int HIST_UNROLL = 4;
constexpr int HIST_BLOCKS_PER_SM = 4;
constexpr int MAX_PAYLOADS = 8;  // ops/sort_cuda.py MAX_PAYLOADS
constexpr unsigned FULL = 0xFFFFFFFFu;

static_assert(THREADS == RADIX, "one thread a bucket");

struct Planes {
  uint32_t* p[MAX_PAYLOADS];
};

struct ConstPlanes {
  const uint32_t* p[MAX_PAYLOADS];
};

__device__ __forceinline__ unsigned digit_of(uint32_t key, int shift) {
  return (key >> shift) & (RADIX - 1);
}

// Exclusive sum of v over the block's threads in thread order. s_warp
// holds WARPS words; the block may call it again right after it returns.
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v, unsigned* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned up = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  unsigned off = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w)
    if (w < warp) off += s_warp[w];
  __syncthreads();
  return off + incl - v;
}

// All four digit histograms of the n keys: hist[pass * RADIX + bucket].
__global__ void __launch_bounds__(THREADS)
histogram_kernel(const uint32_t* __restrict__ key, long long n, unsigned* __restrict__ hist) {
  __shared__ unsigned s_hist[WARPS][PASSES * RADIX];
  for (int i = threadIdx.x; i < WARPS * PASSES * RADIX; i += THREADS) (&s_hist[0][0])[i] = 0;
  __syncthreads();
  unsigned* mine = s_hist[threadIdx.x >> 5];
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i0 = (long long)blockIdx.x * THREADS + threadIdx.x; i0 < n;
       i0 += HIST_UNROLL * stride) {
    uint32_t k[HIST_UNROLL];
#pragma unroll
    for (int u = 0; u < HIST_UNROLL; ++u) {
      const long long i = i0 + u * stride;
      k[u] = i < n ? key[i] : 0u;
    }
#pragma unroll
    for (int u = 0; u < HIST_UNROLL; ++u) {
      if (i0 + u * stride >= n) break;
#pragma unroll
      for (int p = 0; p < PASSES; ++p)
        atomicAdd(&mine[p * RADIX + digit_of(k[u], p * RADIX_BITS)], 1u);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < PASSES * RADIX; b += THREADS) {
    unsigned s = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += s_hist[w][b];
    if (s) atomicAdd(&hist[b], s);
  }
}

// One digit pass, a tile per block in ticket order: keys from key_in to
// key_out and the CP payload planes from `in` to `out`. hist:
// this pass's 256 counts; status: this pass's ntiles * RADIX words, zero at
// the start.
template <int CP>
__global__ void __launch_bounds__(THREADS)
digit_pass_kernel(const uint32_t* __restrict__ key_in, ConstPlanes in,
                  uint32_t* __restrict__ key_out, Planes out, long long n, int shift,
                  const unsigned* __restrict__ hist, unsigned* ticket,
                  unsigned long long* status) {
  __shared__ uint32_t s_key[TILE];
  __shared__ uint32_t s_val[CP > 0 ? TILE : 1];
  __shared__ unsigned s_wcnt[WARPS][RADIX];  // per warp and bucket: count, then offset
  __shared__ unsigned s_start[RADIX];        // the bucket's first position in the tile
  __shared__ long long s_goff[RADIX];        // global row of the tile's position 0 of bucket b
  __shared__ unsigned s_scan[WARPS];
  __shared__ unsigned s_tile;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned b = threadIdx.x;  // the bucket this thread scans and looks back for
  const unsigned total = hist[b];
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
  const bool constant = __syncthreads_or((long long)total == n);
  const long long tile = s_tile;
  const long long base = tile * TILE;
  const int valid = (int)min((long long)TILE, n - base);

  // keys, and the first carried plane, in warp-striped runs: item j of a
  // lane sits at tile position warp * WARP_KEYS + j * 32 + lane
  uint32_t k[ITEMS];
  uint32_t v0[CP > 0 ? ITEMS : 1];
  unsigned pos[ITEMS];  // tile-local sorted position
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int li = warp * WARP_KEYS + j * 32 + lane;
    k[j] = li < valid ? key_in[base + li] : 0u;
    if constexpr (CP > 0) v0[j] = li < valid ? in.p[0][base + li] : 0u;
    pos[j] = li;
  }

  unsigned gstart = 0, count = 0, start = 0;
  unsigned long long* word = status + tile * RADIX + b;
  if (!constant) {
    for (int i = threadIdx.x; i < WARPS * RADIX; i += THREADS) (&s_wcnt[0][0])[i] = 0;
    gstart = block_exclusive_scan(total, s_scan);  // also a barrier
    unsigned* wc = s_wcnt[warp];
    const unsigned below = (1u << lane) - 1u;
    // CHUNK items at a time: their matches, then the leaders' counter
    // updates, then the broadcasts, so that no item waits on the one before
#pragma unroll
    for (int c = 0; c < ITEMS; c += CHUNK) {
      unsigned peers[CHUNK];
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        const int j = c + u;
        const bool ok = warp * WARP_KEYS + j * 32 + lane < valid;
        // the empty lanes make a group of their own
        peers[u] = __match_any_sync(FULL, ok ? digit_of(k[j], shift) : RADIX);
      }
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        const int j = c + u;
        const bool ok = warp * WARP_KEYS + j * 32 + lane < valid;
        pos[j] = 0;
        if (ok && lane == __ffs(peers[u]) - 1)
          pos[j] = atomicAdd(&wc[digit_of(k[j], shift)], (unsigned)__popc(peers[u]));
      }
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        const int j = c + u;  // rank among the warp's keys of digit d
        pos[j] = __shfl_sync(FULL, pos[j], __ffs(peers[u]) - 1) + __popc(peers[u] & below);
      }
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {  // bucket b's keys in this tile; each warp's offset in it
      const unsigned c = s_wcnt[w][b];
      s_wcnt[w][b] = count;
      count += c;
    }
    publish(word, tile == 0 ? FLAG_PREFIX : FLAG_AGG, count);
    start = block_exclusive_scan(count, s_scan);
    s_start[b] = start;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const unsigned d = digit_of(k[j], shift);
      pos[j] += s_start[d] + s_wcnt[warp][d];  // the empty lanes' positions go unused
    }
  }

  // keys and the first plane re-ordered in shared memory while the earlier
  // tiles publish; then the look-back
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (warp * WARP_KEYS + j * 32 + lane < valid) {
      s_key[pos[j]] = k[j];
      if constexpr (CP > 0) s_val[pos[j]] = v0[j];
    }
  }
  if (constant) {
    s_goff[b] = base;  // every key stays where it is
  } else {
    unsigned before = 0;  // bucket b's keys in the earlier tiles
    if (tile > 0) {
      before = look_back<RADIX>(status, tile, b);
      publish(word, FLAG_PREFIX, before + count);
    }
    s_goff[b] = (long long)gstart + before - start;
  }
  __syncthreads();

  // each run of a bucket leaves as consecutive addresses
#pragma unroll
  for (int m = 0; m < ITEMS; ++m) {
    const int i = m * THREADS + threadIdx.x;
    if (i < valid) {
      const uint32_t key = s_key[i];
      key_out[s_goff[digit_of(key, shift)] + i] = key;
    }
  }
#pragma unroll
  for (int q = 0; q < CP; ++q) {
    if (q > 0) {
      __syncthreads();  // the previous plane's reads of s_val are done
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const int li = warp * WARP_KEYS + j * 32 + lane;
        if (li < valid) s_val[pos[j]] = in.p[q][base + li];
      }
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < ITEMS; ++m) {
      const int i = m * THREADS + threadIdx.x;
      if (i < valid) {
        out.p[q][s_goff[digit_of(s_key[i], shift)] + i] = s_val[i];
      }
    }
  }
}

template <int CP>
cudaError_t launch_pass(long long ntiles, const uint32_t* key_in, const ConstPlanes& in,
                        uint32_t* key_out, const Planes& out, long long n, int pass,
                        const unsigned* hist, unsigned* tickets, unsigned long long* status,
                        cudaStream_t s) {
  digit_pass_kernel<CP><<<(unsigned)ntiles, THREADS, 0, s>>>(
      key_in, in, key_out, out, n, pass * RADIX_BITS, hist + pass * RADIX, tickets + pass,
      status + (long long)pass * ntiles * RADIX);
  return cudaGetLastError();
}

// A pass with cp payload planes: the kernels are templated on the count so
// that the plane pointers stay in registers.
cudaError_t carry_pass(int cp, long long ntiles, const uint32_t* key_in, const ConstPlanes& in,
                       uint32_t* key_out, const Planes& out, long long n, int pass,
                       const unsigned* hist, unsigned* tickets, unsigned long long* status,
                       cudaStream_t s) {
#define DPU_CARRY(C) \
  case C:            \
    return launch_pass<C>(ntiles, key_in, in, key_out, out, n, pass, hist, tickets, status, s);
  switch (cp) {
    DPU_CARRY(0)
    DPU_CARRY(1)
    DPU_CARRY(2)
    DPU_CARRY(3)
    DPU_CARRY(4)
    DPU_CARRY(5)
    DPU_CARRY(6)
    DPU_CARRY(7)
    DPU_CARRY(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef DPU_CARRY
}

ConstPlanes as_const(const Planes& p) {
  ConstPlanes c{};
  for (int q = 0; q < MAX_PAYLOADS; ++q) c.p[q] = p.p[q];
  return c;
}

}  // namespace

// Sorts in_planes[0] (the key) ascending and stably, in_planes[1:] following
// it (n_planes device pointers, length n), into `out`: n_planes planes of n
// uint32, one after the other. `work` holds the words of ops/sort_cuda.py
// radix_plan: PASSES * ceil(n / TILE) * RADIX status words (uint64), then
// PASSES * RADIX histogram counts and PASSES tickets (uint32), which the
// function clears on the stream, then the n_planes ping-pong planes of n
// uint32. Launches on `stream` and does not synchronise. Returns 0 or the
// first CUDA error.
extern "C" int dpu_sort_u32(void* const* in_planes, int n_planes, long long n, void* out_base,
                            void* work, void* stream) {
  if (n_planes < 1 || n_planes > 1 + MAX_PAYLOADS || n < 1 || n > 0xFFFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_pay = n_planes - 1;
  const long long ntiles = (n + TILE - 1) / TILE;
  unsigned long long* status = static_cast<unsigned long long*>(work);
  unsigned* hist = reinterpret_cast<unsigned*>(status + (long long)PASSES * ntiles * RADIX);
  unsigned* tickets = hist + PASSES * RADIX;
  const size_t bytes = (size_t)PASSES * ntiles * RADIX * 8 + (PASSES * RADIX + PASSES) * 4;
  cudaError_t err = cudaMemsetAsync(work, 0, bytes, s);
  if (err != cudaSuccess) return (int)err;

  static int sms[64] = {};  // SM count of each device, read once
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const long long per_block = (long long)THREADS * HIST_UNROLL;
  const long long want = (n + per_block - 1) / per_block;
  const long long cap = (long long)sms[dev] * HIST_BLOCKS_PER_SM;
  const uint32_t* key = static_cast<const uint32_t*>(in_planes[0]);
  histogram_kernel<<<(unsigned)(want < cap ? want : cap), THREADS, 0, s>>>(key, n, hist);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // the four passes: in -> alt, alt -> out, out -> alt, alt -> out
  uint32_t* out_key = static_cast<uint32_t*>(out_base);
  // the planes start after the status words and the 4 * (RADIX + 1) counts
  uint32_t* alt_key = reinterpret_cast<uint32_t*>(tickets + PASSES);
  Planes out{}, alt{};
  ConstPlanes user{};
  for (int q = 0; q < n_pay; ++q) {
    user.p[q] = static_cast<const uint32_t*>(in_planes[1 + q]);
    out.p[q] = out_key + (q + 1) * n;
    alt.p[q] = alt_key + (q + 1) * n;
  }
  for (int pass = 0; pass < PASSES; ++pass) {
    const bool to_alt = pass % 2 == 0;
    const uint32_t* src_key = pass == 0 ? key : to_alt ? out_key : alt_key;
    uint32_t* dst_key = to_alt ? alt_key : out_key;
    const ConstPlanes src = pass == 0 ? user : as_const(to_alt ? out : alt);
    const Planes& dst = to_alt ? alt : out;
    err = carry_pass(n_pay, ntiles, src_key, src, dst_key, dst, n, pass, hist, tickets, status,
                     s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
