// Radix hash partition of a uint32 key column into P padded cells: the
// Hopper counterpart of the TPU kernel
// dpu_olap_tpu/ops/partition_pallas.py:partition_cells_pallas
// (_partition_kernel).
//
// bucket(key) = wang_hash(key) >> (1 + clz(P)), the top log2(P) bits of the
// reference's Wang hash (dpu/shared/kernels/partition.c:20-49); it must stay
// bit-identical to ops/hashing.py:radix_bucket, or the two sides of a join
// stop co-partitioning. Bucket p's rows land in cells[p, :count_p] in input
// order, with their payload planes and, unless the caller drops it, their
// input row index (the selection plane). counts is the true histogram and
// overflow = any(count_p > cell); a bucket beyond its cell keeps its first
// `cell` rows. Padded lanes get one defined value that the plain version
// (ops/partition_cuda.py:partition_cells_ref) also writes: key 0xFFFFFFFF,
// payloads 0, selection 0xFFFFFFFF. Keys equal to 0xFFFFFFFF are ordinary
// keys here.
//
// The TPU kernel walks its grid in order, carries running per-bucket
// offsets in SMEM and routes each bucket through a butterfly network with
// read-modify-write of partial rows, because Mosaic has no scatter. Hopper
// has scatter but runs blocks in no order, so the carry becomes a scan:
//   1. hist: each block counts the buckets of one tile of TILE elements
//      (a warp ballot per bucket) into tile_counts[p][tile];
//   2. scan: one block per bucket turns its column of tile counts into
//      exclusive offsets in place, writes counts[p], and raises overflow;
//   3. pad: the lanes [count_p, cell) of every cell take the pad values;
//   4. scatter: each block walks its tile again in rounds of THREADS
//      elements. An element's rank in its bucket is the popcount of the
//      bucket's ballot below its lane, plus the counts of the earlier warps
//      of the round and of the earlier rounds of the tile, plus the tile's
//      offset: stable without atomics.
// Offsets into the cells are 64-bit (P * cell may pass 2^31).
//
// What bounds it on the H100: device-memory traffic. The keys are read
// twice (hist and scatter), each payload once, and every cell lane is
// written once, by the scatter or by the pad pass. The scatter's writes go
// to P streams; a warp's lanes of one bucket write neighbouring addresses.
// Staging each tile by bucket in shared memory, to write whole runs, is
// later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;              // rounds of THREADS elements per tile
constexpr int TILE = THREADS * ITEMS;  // ops/partition_cuda.py TILE
constexpr int SCAN_THREADS = 1024;
constexpr int MAX_PAYLOADS = 8;  // ops/partition_cuda.py MAX_PAYLOADS
constexpr int PAD_BLOCKS = 1024;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint32_t EMPTY = 0xFFFFFFFFu;

struct InPlanes {
  const uint32_t* p[MAX_PAYLOADS];
};

struct OutPlanes {
  uint32_t* p[MAX_PAYLOADS];
};

// ops/hashing.py:wang_hash, in native uint32 arithmetic.
__device__ __forceinline__ uint32_t wang_hash(uint32_t key) {
  key = key + ~(key << 15);
  key = key ^ (key >> 10);
  key = key + (key << 3);
  key = key ^ (key >> 6);
  key = key + ~(key << 11);
  key = key ^ (key >> 16);
  return key;
}

template <int P>
__device__ __forceinline__ int bucket_of(uint32_t key) {
  constexpr int LOG2P = P == 2 ? 1 : P == 4 ? 2 : P == 8 ? 3 : 4;
  return (int)(wang_hash(key) >> (32 - LOG2P));  // 1 + clz(P) = 32 - log2(P)
}

// tile_counts[p * ntiles + tile] = rows of bucket p in the tile.
template <int P>
__global__ void __launch_bounds__(THREADS)
hist_kernel(const uint32_t* __restrict__ keys, long long n, long long ntiles,
            uint32_t* __restrict__ tile_counts) {
  __shared__ uint32_t warp_cnt[WARPS][P];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * TILE;
  uint32_t mine = 0;  // lane p counts bucket p over the warp's elements
#pragma unroll 4
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j * THREADS + threadIdx.x;
    const int b = i < n ? bucket_of<P>(keys[i]) : P;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const unsigned bal = __ballot_sync(FULL, b == p);
      if (lane == p) mine += __popc(bal);
    }
  }
  if (lane < P) warp_cnt[warp][lane] = mine;
  __syncthreads();
  if (threadIdx.x < P) {
    uint32_t t = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += warp_cnt[w][threadIdx.x];
    tile_counts[threadIdx.x * ntiles + blockIdx.x] = t;
  }
}

// Block p: exclusive scan of bucket p's tile counts in place; counts[p] is
// the total, and overflow is set when it passes the cell.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(uint32_t* __restrict__ tile_counts, long long ntiles, long long cell,
            uint32_t* __restrict__ counts, int* __restrict__ overflow) {
  __shared__ uint32_t part[SCAN_THREADS];
  uint32_t* col = tile_counts + blockIdx.x * ntiles;
  const int t = threadIdx.x;
  const long long per = (ntiles + SCAN_THREADS - 1) / SCAN_THREADS;
  const long long lo = t * per;
  const long long hi = lo + per < ntiles ? lo + per : ntiles;
  uint32_t s = 0;
  for (long long i = lo; i < hi; ++i) s += col[i];
  part[t] = s;
  __syncthreads();
  for (int d = 1; d < SCAN_THREADS; d <<= 1) {  // inclusive Hillis-Steele scan
    const uint32_t v = t >= d ? part[t - d] : 0u;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  uint32_t run = t ? part[t - 1] : 0u;
  for (long long i = lo; i < hi; ++i) {
    const uint32_t v = col[i];
    col[i] = run;
    run += v;
  }
  if (t == SCAN_THREADS - 1) {
    counts[blockIdx.x] = part[t];
    if ((long long)part[t] > cell) *overflow = 1;
  }
}

// Lanes [counts[p], cell) of cell p (p = blockIdx.y) take the pad values.
template <int NP>
__global__ void __launch_bounds__(THREADS)
pad_kernel(const uint32_t* __restrict__ counts, long long cell, uint32_t* __restrict__ cells_k,
           OutPlanes cells_pay, uint32_t* __restrict__ cells_sel) {
  const long long p = blockIdx.y;
  const long long row = p * cell;
  for (long long j = counts[p] + (long long)blockIdx.x * THREADS + threadIdx.x; j < cell;
       j += (long long)gridDim.x * THREADS) {
    cells_k[row + j] = EMPTY;
#pragma unroll
    for (int q = 0; q < NP; ++q) cells_pay.p[q][row + j] = 0u;
    if (cells_sel) cells_sel[row + j] = EMPTY;
  }
}

template <int P, int NP>
__global__ void __launch_bounds__(THREADS)
scatter_kernel(const uint32_t* __restrict__ keys, InPlanes pay, long long n,
               const uint32_t* __restrict__ tile_offs, long long ntiles, long long cell,
               uint32_t* __restrict__ cells_k, OutPlanes cells_pay,
               uint32_t* __restrict__ cells_sel) {
  // double-buffered per-warp bucket counts: the running counts are updated
  // from buffer j&1 after round j's second barrier, and round j+1 writes the
  // other buffer, so two barriers a round suffice
  __shared__ uint32_t wcnt[2][WARPS][P];
  __shared__ uint32_t run[P];    // rows of each bucket in the earlier rounds
  __shared__ uint32_t tbase[P];  // the tile's offset in each cell
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanes_lt = (1u << lane) - 1u;
  const long long base = (long long)blockIdx.x * TILE;
  if (threadIdx.x < P) {
    run[threadIdx.x] = 0u;
    tbase[threadIdx.x] = tile_offs[threadIdx.x * ntiles + blockIdx.x];
  }
  for (int j = 0; j < ITEMS; ++j) {
    const int buf = j & 1;
    const long long i = base + j * THREADS + threadIdx.x;
    const bool valid = i < n;
    const uint32_t key = valid ? keys[i] : 0u;
    const int b = valid ? bucket_of<P>(key) : P;
    unsigned same = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const unsigned bal = __ballot_sync(FULL, b == p);
      if (lane == p) wcnt[buf][warp][p] = __popc(bal);
      if (b == p) same = bal;
    }
    __syncthreads();
    if (valid) {
      uint32_t off = run[b] + __popc(same & lanes_lt);
      for (int w = 0; w < warp; ++w) off += wcnt[buf][w][b];
      const long long pos = (long long)tbase[b] + off;
      if (pos < cell) {
        const long long dst = (long long)b * cell + pos;
        cells_k[dst] = key;
#pragma unroll
        for (int q = 0; q < NP; ++q) cells_pay.p[q][dst] = pay.p[q][i];
        if (cells_sel) cells_sel[dst] = (uint32_t)i;
      }
    }
    __syncthreads();
    if (threadIdx.x < P) {
      uint32_t t = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) t += wcnt[buf][w][threadIdx.x];
      run[threadIdx.x] += t;
    }
  }
}

template <int P, int NP>
cudaError_t run_partition(const uint32_t* keys, InPlanes pay, long long n, long long cell,
                          uint32_t* cells_k, OutPlanes cells_pay, uint32_t* cells_sel,
                          uint32_t* counts, int* overflow, uint32_t* scratch, cudaStream_t s) {
  const long long ntiles = (n + TILE - 1) / TILE;
  cudaError_t err = cudaMemsetAsync(overflow, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  hist_kernel<P><<<(unsigned)ntiles, THREADS, 0, s>>>(keys, n, ntiles, scratch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_kernel<<<P, SCAN_THREADS, 0, s>>>(scratch, ntiles, cell, counts, overflow);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long pad_x = (cell + THREADS - 1) / THREADS;
  const dim3 pad_grid((unsigned)(pad_x < PAD_BLOCKS ? pad_x : PAD_BLOCKS), P);
  pad_kernel<NP><<<pad_grid, THREADS, 0, s>>>(counts, cell, cells_k, cells_pay, cells_sel);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scatter_kernel<P, NP><<<(unsigned)ntiles, THREADS, 0, s>>>(keys, pay, n, scratch, ntiles, cell,
                                                           cells_k, cells_pay, cells_sel);
  return cudaGetLastError();
}

template <int P>
cudaError_t dispatch_payloads(int n_pay, const uint32_t* keys, InPlanes pay, long long n,
                              long long cell, uint32_t* cells_k, OutPlanes cells_pay,
                              uint32_t* cells_sel, uint32_t* counts, int* overflow,
                              uint32_t* scratch, cudaStream_t s) {
#define DPU_PARTITION_CASE(NP)                                                            \
  case NP:                                                                                \
    return run_partition<P, NP>(keys, pay, n, cell, cells_k, cells_pay, cells_sel, counts, \
                                overflow, scratch, s);
  switch (n_pay) {
    DPU_PARTITION_CASE(0)
    DPU_PARTITION_CASE(1)
    DPU_PARTITION_CASE(2)
    DPU_PARTITION_CASE(3)
    DPU_PARTITION_CASE(4)
    DPU_PARTITION_CASE(5)
    DPU_PARTITION_CASE(6)
    DPU_PARTITION_CASE(7)
    default:
      return run_partition<P, 8>(keys, pay, n, cell, cells_k, cells_pay, cells_sel, counts,
                                 overflow, scratch, s);
  }
#undef DPU_PARTITION_CASE
}

}  // namespace

// Partition n uint32 keys (1 <= n <= 2^32 - 1) with n_pay payload planes
// (0..8; host arrays of device pointers) into `parts` cells of `cell` rows
// (parts a power of two in [2, 16], cell >= 1): cells_k and each of
// cells_pay hold parts * cell uint32, cells_sel the same or NULL to drop the
// selection plane. counts receives parts uint32, overflow one int32 (0/1);
// scratch holds parts * ceil(n / 4096) uint32. Launches on `stream` and does
// not synchronise. Returns 0 or the first CUDA error.
extern "C" int dpu_partition_u32(const void* keys, void* const* payloads, int n_pay, long long n,
                                 int parts, long long cell, void* cells_k, void* const* cells_pay,
                                 void* cells_sel, void* counts, void* overflow, void* scratch,
                                 void* stream) {
  if (n < 1 || n > 0xFFFFFFFFLL || cell < 1 || n_pay < 0 || n_pay > MAX_PAYLOADS)
    return (int)cudaErrorInvalidValue;
  InPlanes pay{};
  OutPlanes out{};
  for (int q = 0; q < n_pay; ++q) {
    pay.p[q] = static_cast<const uint32_t*>(payloads[q]);
    out.p[q] = static_cast<uint32_t*>(cells_pay[q]);
  }
  const uint32_t* k = static_cast<const uint32_t*>(keys);
  uint32_t* ck = static_cast<uint32_t*>(cells_k);
  uint32_t* cs = static_cast<uint32_t*>(cells_sel);
  uint32_t* cnt = static_cast<uint32_t*>(counts);
  int* ovf = static_cast<int*>(overflow);
  uint32_t* sc = static_cast<uint32_t*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (parts) {
    case 2: return (int)dispatch_payloads<2>(n_pay, k, pay, n, cell, ck, out, cs, cnt, ovf, sc, s);
    case 4: return (int)dispatch_payloads<4>(n_pay, k, pay, n, cell, ck, out, cs, cnt, ovf, sc, s);
    case 8: return (int)dispatch_payloads<8>(n_pay, k, pay, n, cell, ck, out, cs, cnt, ovf, sc, s);
    case 16: return (int)dispatch_payloads<16>(n_pay, k, pay, n, cell, ck, out, cs, cnt, ovf, sc, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
