// Segmented forward fill of uint32 planes: the Hopper counterpart of the TPU
// kernels dpu_olap_tpu/ops/scan_pallas.py:propagate_fill
// (_propagate_fill_kernel) and propagate_last (_propagate_kernel).
//
// out[q][i] = in[q][src(i)], where src(i) is the largest position j <= i
// that is live: in fill mode plane 0 is the key and j is live when
// in[0][j] != sentinel; in mask mode j is live when alive[j] != 0 and every
// plane is a value plane. Positions with no live position at or before them
// take the sentinel in every plane (fill mode) or 0 in every plane and
// has = 0 (mask mode); the plain versions write the same values, so the two
// agree bit for bit on every lane.
//
// The TPU kernel runs its grid in order and carries the last live pair in
// SMEM from block to block. Hopper blocks run in no order, so the carry
// becomes two extra small passes:
//   1. tile_last: each block finds the last live position of one tile of
//      TILE elements (a warp ballot, then a max over the warps);
//   2. tile_carry_scan: one block turns the per-tile last positions into an
//      exclusive max-scan in place: tile t's carry is the last live position
//      before it, or -1;
//   3. fill: each block walks its tile in rounds of THREADS elements; a warp
//      ballot gives each element the last live lane at or below it, earlier
//      warps of the round and earlier rounds give the rest, and each output
//      plane gathers from that source position.
// The source index is computed once and every plane gathers through it, so
// the payload count costs only its own bytes.
//
// What bounds it on the H100: device-memory traffic. Pass 1 reads the key
// (or the alive bytes) once; pass 3 reads the key again, gathers every plane
// from a source position that is almost always in the same or a recently
// read cache line, and writes every plane once: at 8Mi elements with one
// payload about 32 + 64 + 64 MiB. Pass 2 touches 8 bytes per tile. The
// single-pass decoupled look-back, which reads the key once, is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;              // rounds of THREADS elements per tile
constexpr int TILE = THREADS * ITEMS;  // ops/scan_cuda.py TILE
constexpr int SCAN_THREADS = 1024;
constexpr int MAX_PLANES = 9;  // key + 8 payloads (ops/scan_cuda.py MAX_PLANES)
constexpr unsigned FULL = 0xFFFFFFFFu;

struct InPlanes {
  const uint32_t* p[MAX_PLANES];
};

struct OutPlanes {
  uint32_t* p[MAX_PLANES];
};

__device__ __forceinline__ bool is_live(const uint32_t* __restrict__ key,
                                        const uint8_t* __restrict__ alive,
                                        uint32_t sentinel, long long i) {
  return alive ? alive[i] != 0 : key[i] != sentinel;
}

// tile_last[b] = the last live position of tile b, or -1.
__global__ void tile_last_kernel(const uint32_t* __restrict__ key,
                                 const uint8_t* __restrict__ alive,
                                 uint32_t sentinel, long long n,
                                 long long* __restrict__ tile_last) {
  __shared__ int warp_last[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * TILE;
  int last = -1;  // offset in the tile
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j * THREADS + threadIdx.x;
    const unsigned ballot = __ballot_sync(FULL, i < n && is_live(key, alive, sentinel, i));
    if (ballot) last = j * THREADS + warp * 32 + 31 - __clz(ballot);
  }
  if (lane == 0) warp_last[warp] = last;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = -1;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) t = max(t, warp_last[k]);
    tile_last[blockIdx.x] = t < 0 ? -1LL : base + t;
  }
}

// One block: exclusive max-scan of ntiles last positions in place (-1 first).
__global__ void tile_carry_scan_kernel(long long* __restrict__ last, long long ntiles) {
  __shared__ long long part[SCAN_THREADS];
  const int t = threadIdx.x;
  const long long per = (ntiles + SCAN_THREADS - 1) / SCAN_THREADS;
  const long long lo = t * per;
  const long long hi = lo + per < ntiles ? lo + per : ntiles;
  long long m = -1;
  for (long long i = lo; i < hi; ++i) m = max(m, last[i]);
  part[t] = m;
  __syncthreads();
  for (int d = 1; d < SCAN_THREADS; d <<= 1) {  // inclusive Hillis-Steele max-scan
    const long long v = t >= d ? part[t - d] : -1LL;
    __syncthreads();
    part[t] = max(part[t], v);
    __syncthreads();
  }
  long long run = t ? part[t - 1] : -1LL;
  for (long long i = lo; i < hi; ++i) {
    const long long v = last[i];
    last[i] = run;
    run = max(run, v);
  }
}

// MASK: alive bytes mark live positions and `has` is written; otherwise
// in.p[0] != sentinel does. NP planes are gathered.
template <int NP, bool MASK>
__global__ void __launch_bounds__(THREADS)
fill_kernel(InPlanes in, const uint8_t* __restrict__ alive, uint32_t sentinel,
            long long n, const long long* __restrict__ tile_carry, OutPlanes out,
            uint8_t* __restrict__ has) {
  // double-buffered per-warp last positions: one barrier per round suffices
  // (a warp writes buffer j&1 only after every thread passed round j-1's
  // barrier, that is after every read of round j-2)
  __shared__ long long warp_last[2][WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanes_le = FULL >> (31 - lane);
  const long long base = (long long)blockIdx.x * TILE;
  long long carry = tile_carry[blockIdx.x];
  const uint32_t dead = MASK ? 0u : sentinel;
  for (int j = 0; j < ITEMS; ++j) {
    const long long w0 = base + j * THREADS + warp * 32;  // the warp's first position
    const long long i = w0 + lane;
    const bool live = i < n && is_live(MASK ? nullptr : in.p[0], alive, sentinel, i);
    const unsigned ballot = __ballot_sync(FULL, live);
    if (lane == 0) warp_last[j & 1][warp] = ballot ? w0 + 31 - __clz(ballot) : -1LL;
    __syncthreads();
    long long before = carry;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
      const long long v = warp_last[j & 1][k];
      if (k < warp) before = max(before, v);
      carry = max(carry, v);
    }
    const unsigned mine = ballot & lanes_le;
    const long long src = mine ? w0 + 31 - __clz(mine) : before;
    if (i < n) {
#pragma unroll
      for (int q = 0; q < NP; ++q) out.p[q][i] = src >= 0 ? in.p[q][src] : dead;
      if (MASK) has[i] = src >= 0;
    }
  }
}

template <int NP, bool MASK>
cudaError_t launch_fill(InPlanes in, const uint8_t* alive, uint32_t sentinel, long long n,
                        long long ntiles, long long* scratch, OutPlanes out, uint8_t* has,
                        cudaStream_t s) {
  tile_last_kernel<<<(unsigned)ntiles, THREADS, 0, s>>>(MASK ? nullptr : in.p[0], alive,
                                                         sentinel, n, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tile_carry_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(scratch, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fill_kernel<NP, MASK><<<(unsigned)ntiles, THREADS, 0, s>>>(in, alive, sentinel, n, scratch,
                                                             out, has);
  return cudaGetLastError();
}

template <bool MASK>
cudaError_t dispatch_fill(int n_planes, InPlanes in, const uint8_t* alive, uint32_t sentinel,
                          long long n, long long ntiles, long long* scratch, OutPlanes out,
                          uint8_t* has, cudaStream_t s) {
  switch (n_planes) {
    case 1: return launch_fill<1, MASK>(in, alive, sentinel, n, ntiles, scratch, out, has, s);
    case 2: return launch_fill<2, MASK>(in, alive, sentinel, n, ntiles, scratch, out, has, s);
    case 3: return launch_fill<3, MASK>(in, alive, sentinel, n, ntiles, scratch, out, has, s);
    case 4: return launch_fill<4, MASK>(in, alive, sentinel, n, ntiles, scratch, out, has, s);
    case 5: return launch_fill<5, MASK>(in, alive, sentinel, n, ntiles, scratch, out, has, s);
    case 6: return launch_fill<6, MASK>(in, alive, sentinel, n, ntiles, scratch, out, has, s);
    case 7: return launch_fill<7, MASK>(in, alive, sentinel, n, ntiles, scratch, out, has, s);
    case 8: return launch_fill<8, MASK>(in, alive, sentinel, n, ntiles, scratch, out, has, s);
    default: return launch_fill<9, MASK>(in, alive, sentinel, n, ntiles, scratch, out, has, s);
  }
}

}  // namespace

// Forward-fill n_planes uint32 planes of length n (1 <= n_planes <= 9) from
// in_planes into out_planes (host arrays of device pointers). With alive
// null, position j is live when in_planes[0][j] != sentinel and dead lanes
// take the sentinel; otherwise alive (n bytes) marks live positions, dead
// lanes take 0 and has (n bytes) receives 0/1. scratch holds ceil(n / TILE)
// int64. Launches on `stream` and does not synchronise. Returns 0 or the
// first CUDA error.
extern "C" int dpu_fill_u32(void* const* in_planes, void* const* out_planes, int n_planes,
                            long long n, unsigned sentinel, const void* alive, void* has,
                            void* scratch, void* stream) {
  if (n_planes < 1 || n_planes > MAX_PLANES || n < 1 || (alive == nullptr) != (has == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  InPlanes in{};
  OutPlanes out{};
  for (int q = 0; q < n_planes; ++q) {
    in.p[q] = static_cast<const uint32_t*>(in_planes[q]);
    out.p[q] = static_cast<uint32_t*>(out_planes[q]);
  }
  const long long ntiles = (n + TILE - 1) / TILE;
  long long* sc = static_cast<long long*>(scratch);
  const uint8_t* al = static_cast<const uint8_t*>(alive);
  uint8_t* h = static_cast<uint8_t*>(has);
  const cudaError_t err =
      al ? dispatch_fill<true>(n_planes, in, al, sentinel, n, ntiles, sc, out, h, s)
         : dispatch_fill<false>(n_planes, in, al, sentinel, n, ntiles, sc, out, h, s);
  return (int)err;
}
