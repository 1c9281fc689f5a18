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
// has scatter but runs blocks in no order. The carry becomes a one-sweep
// pass, the design of csrc/radix_sort.cu with one digit of log2(P) bits
// taken from the hash (Adinets and Merrill, "Onesweep", 2022):
//   1. sweep_kernel reads each key and payload once:
//      - a block takes its tile of TILE rows by an atomic ticket, so that
//        every tile it waits on belongs to a block that is already running;
//      - a row's rank among the tile's rows of its bucket comes from
//        log2(P) ballots, one a bucket bit: a lane ANDs them into the mask
//        of the lanes that share its bucket, and lane b into that of bucket
//        b, whose popcount it adds to the warp's running count of b. A warp
//        holds ITEMS runs of 32 consecutive rows and ranks them in order,
//        and the warps' counts are joined in warp order: stable, with no
//        shared-memory atomics;
//      - the tile's P bucket counts go out through a decoupled look-back
//        (csrc/lookback.cuh), thread b for bucket b, flag and count in one
//        64-bit word;
//      - the tile's keys and first payload plane are staged by bucket in
//        shared memory before the look-back waits, and written after it,
//        so that each bucket's run leaves as consecutive addresses of
//        consecutive threads, at bucket * cell + (the bucket's rows in the
//        earlier tiles) + rank; rows at or past `cell` are cut off. Further
//        planes and the selection follow one at a time through one buffer;
//      - the last tile's inclusive prefixes are the histogram: it writes
//        counts and overflow.
//   2. pad_kernel fills the lanes [count_p, cell) of every cell, 16 bytes
//      a store where aligned.
// Why the pad follows the sweep: the trace of the earlier kernel (a
// histogram, a scan, the pad, then a scatter; PERF.md §6) put the
// scatter first (70% and 49% of a call at 16Mi rows with P = 8 and at one
// SF=64 side), then the pad (21%, 39%), then the histogram pass (8%, 9%).
// The pad writes the same bytes before or after the sweep; a histogram
// pass before it would only let it go first, at the cost of a second read
// of the keys. So there is none, the keys are read once, and the pad takes
// its counts from the sweep's last tile.
// Work memory (ops/partition_cuda.py partition_plan): one 64-bit status word
// per (tile, bucket) and the ticket, cleared by one cudaMemsetAsync on the
// stream. The call is one memset and two launches with no host decision or
// synchronisation, so it replays from a CUDA graph. Offsets into the cells
// are 64-bit (P * cell may pass 2^31).
//
// What bounds it on the H100: device-memory traffic. The keys and each
// payload are read once, and every cell lane is written once, by the sweep
// or by the pad.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;              // rows a thread holds
constexpr int WARP_ROWS = ITEMS * 32;  // a warp's run of consecutive rows
constexpr int TILE = THREADS * ITEMS;  // ops/partition_cuda.py TILE
constexpr int MAX_PAYLOADS = 8;  // ops/partition_cuda.py MAX_PAYLOADS
constexpr int SWEEP_BLOCKS_PER_SM = 3;  // see sweep_kernel
constexpr int PAD_BLOCKS = 1024;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint32_t EMPTY = 0xFFFFFFFFu;

static_assert(ITEMS * 4 <= 64, "a thread packs its ITEMS 4-bit buckets in 64 bits");

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
__host__ __device__ constexpr int log2_parts() {
  return P == 2 ? 1 : P == 4 ? 2 : P == 8 ? 3 : 4;
}

template <int P>
__device__ __forceinline__ unsigned bucket_of(uint32_t key) {
  return wang_hash(key) >> (32 - log2_parts<P>());  // 1 + clz(P) = 32 - log2(P)
}

// One tile of the sweep (see the note at the top). status: ntiles * P words
// and ticket, zero at the start. At most 80 registers a thread, so that
// three blocks share an SM: a tile's load, ranking, look-back and stores
// run one after another, and a third block overlaps them. Measured beside
// two blocks of 104 registers, and beside tiles of 2048 rows (PERF.md
// §6), it was the fastest at one SF=64 side.
template <int P, int NP>
__global__ void __launch_bounds__(THREADS, SWEEP_BLOCKS_PER_SM)
sweep_kernel(const uint32_t* __restrict__ keys, InPlanes pay, long long n, long long ntiles,
             long long cell, uint32_t* __restrict__ cells_k, OutPlanes cells_pay,
             uint32_t* __restrict__ cells_sel, uint32_t* __restrict__ counts,
             int* __restrict__ overflow, unsigned* ticket, unsigned long long* status) {
  constexpr int BITS = log2_parts<P>();
  __shared__ uint32_t s_key[TILE];
  __shared__ uint32_t s_val[TILE];    // a payload plane or the selection, by staged position
  __shared__ unsigned s_wcnt[WARPS][P];  // per warp and bucket: count, then offset in the bucket
  __shared__ unsigned s_start[P];        // the bucket's first staged position
  __shared__ long long s_dst[P];         // cell lane of staged position 0 of the bucket
  __shared__ long long s_end[P];         // staged positions of the bucket below it are written
  __shared__ unsigned s_tile;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const long long base = tile * TILE;
  const int valid = (int)min((long long)TILE, n - base);

  // rows in warp-striped runs: item j of a lane is tile row
  // warp * WARP_ROWS + j * 32 + lane
  uint32_t k[ITEMS];
  uint32_t v0[NP > 0 ? ITEMS : 1];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int li = warp * WARP_ROWS + j * 32 + lane;
    k[j] = li < valid ? keys[base + li] : 0u;
    if constexpr (NP > 0) v0[j] = li < valid ? pay.p[0][base + li] : 0u;
  }

  // rank: pos[j] = (rank among the warp's rows of its bucket) | bucket << 16
  unsigned pos[ITEMS];
  unsigned run = 0;  // lane b < P: bucket b's rows in the warp's earlier items
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const bool ok = warp * WARP_ROWS + j * 32 + lane < valid;
    const unsigned b = bucket_of<P>(k[j]);
    unsigned same = __ballot_sync(FULL, ok);  // lanes of this lane's bucket
    unsigned mine = same;                     // lanes of bucket `lane`
#pragma unroll
    for (int bit = 0; bit < BITS; ++bit) {
      const unsigned bal = __ballot_sync(FULL, (b >> bit) & 1u);
      same &= (b >> bit) & 1u ? bal : ~bal;
      mine &= (lane >> bit) & 1 ? bal : ~bal;
    }
    pos[j] = (__shfl_sync(FULL, run, b) + __popc(same & below)) | b << 16;
    run += __popc(mine);
  }
  if (lane < P) s_wcnt[warp][lane] = run;
  __syncthreads();

  const unsigned bt = threadIdx.x;  // the bucket this thread scans and looks back for
  unsigned count = 0;               // bucket bt's rows in the tile
  unsigned long long* word = status + tile * P + bt;
  if (bt < P) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const unsigned c = s_wcnt[w][bt];
      s_wcnt[w][bt] = count;
      count += c;
    }
    publish(word, tile == 0 ? FLAG_PREFIX : FLAG_AGG, count);
  }
  if (warp == 0) {  // the buckets' first staged positions: an exclusive scan over P lanes
    unsigned incl = lane < P ? count : 0u;
#pragma unroll
    for (int d = 1; d < P; d <<= 1) {
      const unsigned up = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane < P) s_start[lane] = incl - count;
  }
  __syncthreads();

  // keys and the first plane staged by bucket while the earlier tiles
  // publish; then the look-back
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (warp * WARP_ROWS + j * 32 + lane < valid) {
      const unsigned b = pos[j] >> 16;
      pos[j] = s_start[b] + s_wcnt[warp][b] + (pos[j] & 0xFFFFu);
      s_key[pos[j]] = k[j];
      if constexpr (NP > 0) s_val[pos[j]] = v0[j];
    }
  }
  if (bt < P) {
    unsigned before = 0;  // bucket bt's rows in the earlier tiles
    if (tile > 0) {
      before = look_back<P>(status, tile, bt);
      publish(word, FLAG_PREFIX, before + count);
    }
    const long long start = s_start[bt];
    s_dst[bt] = (long long)bt * cell + before - start;
    // the bucket's rows and, of them, those before the cell's end
    s_end[bt] = start + min((long long)count, cell - (long long)before);
    if (tile == ntiles - 1) {  // inclusive prefixes of the last tile: the histogram
      const unsigned total = before + count;
      counts[bt] = total;
      const unsigned over = __ballot_sync((1u << P) - 1u, (long long)total > cell);
      if (bt == 0) *overflow = over != 0;
    }
  }
  __syncthreads();

  // each bucket's run leaves as consecutive addresses; a thread keeps the
  // buckets of its ITEMS staged positions for the later planes
  unsigned long long bks = 0;
#pragma unroll
  for (int m = 0; m < ITEMS; ++m) {
    const int i = m * THREADS + threadIdx.x;
    if (i < valid) {
      const uint32_t key = s_key[i];
      const unsigned b = bucket_of<P>(key);
      bks |= (unsigned long long)b << (4 * m);
      if (i < s_end[b]) cells_k[s_dst[b] + i] = key;
    }
  }
  auto write_plane = [&](uint32_t* __restrict__ dst) {
#pragma unroll
    for (int m = 0; m < ITEMS; ++m) {
      const int i = m * THREADS + threadIdx.x;
      const unsigned b = (unsigned)(bks >> (4 * m)) & 15u;
      if (i < valid && i < s_end[b]) dst[s_dst[b] + i] = s_val[i];
    }
  };
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    if (q > 0) {
      __syncthreads();  // the previous plane's reads of s_val are done
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const int li = warp * WARP_ROWS + j * 32 + lane;
        if (li < valid) s_val[pos[j]] = pay.p[q][base + li];
      }
      __syncthreads();
    }
    write_plane(cells_pay.p[q]);
  }
  if (cells_sel) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int li = warp * WARP_ROWS + j * 32 + lane;
      if (li < valid) s_val[pos[j]] = (uint32_t)(base + li);
    }
    __syncthreads();
    write_plane(cells_sel);
  }
}

// Lanes [counts[p], cell) of cell p (p = blockIdx.y) take the pad values.
template <int NP>
__global__ void __launch_bounds__(THREADS)
pad_kernel(const uint32_t* __restrict__ counts, long long cell, uint32_t* __restrict__ cells_k,
           OutPlanes cells_pay, uint32_t* __restrict__ cells_sel) {
  const long long row = (long long)blockIdx.y * cell;
  const long long from = min((long long)counts[blockIdx.y], cell);
  if (from >= cell) return;
  fill_lanes<THREADS>(cells_k + row, from, cell, EMPTY);
#pragma unroll
  for (int q = 0; q < NP; ++q) fill_lanes<THREADS>(cells_pay.p[q] + row, from, cell, 0u);
  if (cells_sel) fill_lanes<THREADS>(cells_sel + row, from, cell, EMPTY);
}

template <int P, int NP>
cudaError_t run_partition(const uint32_t* keys, InPlanes pay, long long n, long long cell,
                          uint32_t* cells_k, OutPlanes cells_pay, uint32_t* cells_sel,
                          uint32_t* counts, int* overflow, unsigned long long* work,
                          cudaStream_t s) {
  const long long ntiles = (n + TILE - 1) / TILE;
  unsigned long long* status = work;
  unsigned* ticket = reinterpret_cast<unsigned*>(work + ntiles * P);
  cudaError_t err = cudaMemsetAsync(work, 0, (size_t)(ntiles * P + 1) * 8, s);
  if (err != cudaSuccess) return err;
  sweep_kernel<P, NP><<<(unsigned)ntiles, THREADS, 0, s>>>(
      keys, pay, n, ntiles, cell, cells_k, cells_pay, cells_sel, counts, overflow, ticket, status);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long pad_x = (cell / 4 + THREADS - 1) / THREADS + 1;
  const dim3 pad_grid((unsigned)(pad_x < PAD_BLOCKS ? pad_x : PAD_BLOCKS), P);
  pad_kernel<NP><<<pad_grid, THREADS, 0, s>>>(counts, cell, cells_k, cells_pay, cells_sel);
  return cudaGetLastError();
}

template <int P>
cudaError_t dispatch_payloads(int n_pay, const uint32_t* keys, InPlanes pay, long long n,
                              long long cell, uint32_t* cells_k, OutPlanes cells_pay,
                              uint32_t* cells_sel, uint32_t* counts, int* overflow,
                              unsigned long long* work, cudaStream_t s) {
#define DPU_PARTITION_CASE(NP)                                                            \
  case NP:                                                                                \
    return run_partition<P, NP>(keys, pay, n, cell, cells_k, cells_pay, cells_sel, counts, \
                                overflow, work, s);
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
                                 overflow, work, s);
  }
#undef DPU_PARTITION_CASE
}

}  // namespace

// Partition n uint32 keys (1 <= n <= 2^32 - 1) with n_pay payload planes
// (0..8; host arrays of device pointers) into `parts` cells of `cell` rows
// (parts a power of two in [2, 16], cell >= 1): cells_k and each of
// cells_pay hold parts * cell uint32, cells_sel the same or NULL to drop the
// selection plane. counts receives parts uint32, overflow one int32 (0/1).
// work holds ops/partition_cuda.py partition_plan's words: parts *
// ceil(n / 4096) status words (uint64) and the ticket, which the function
// clears on the stream. Launches on `stream` and does not synchronise.
// Returns 0 or the first CUDA error.
extern "C" int dpu_partition_u32(const void* keys, void* const* payloads, int n_pay, long long n,
                                 int parts, long long cell, void* cells_k, void* const* cells_pay,
                                 void* cells_sel, void* counts, void* overflow, void* work,
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
  unsigned long long* w = static_cast<unsigned long long*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (parts) {
    case 2: return (int)dispatch_payloads<2>(n_pay, k, pay, n, cell, ck, out, cs, cnt, ovf, w, s);
    case 4: return (int)dispatch_payloads<4>(n_pay, k, pay, n, cell, ck, out, cs, cnt, ovf, w, s);
    case 8: return (int)dispatch_payloads<8>(n_pay, k, pay, n, cell, ck, out, cs, cnt, ovf, w, s);
    case 16: return (int)dispatch_payloads<16>(n_pay, k, pay, n, cell, ck, out, cs, cnt, ovf, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
