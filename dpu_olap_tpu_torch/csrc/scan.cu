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
// crosses tiles by a decoupled look-back (Merrill and Garland, 2016) that
// combines by max, in one sweep:
//   - a block takes its tile of TILE elements by an atomic ticket, so that
//     every tile it waits on belongs to a block that is already running;
//   - it reads the key (or the alive bytes) once, 16 bytes a thread a row,
//     and stages plane 0 (and plane 1) in shared memory as it goes;
//   - a thread holds four runs of four consecutive elements; a ballot over
//     the warp and a shuffle give each run the last live position before
//     it in the warp, and a max over the warps' last positions the rest;
//   - a tile with a live element knows its inclusive prefix at once (its
//     own last live position) and publishes it as PREFIX; a dead tile
//     publishes AGG, and then PREFIX once its look-back has its carry. So
//     the look-back stops at the first PREFIX: a live tile, or a dead one
//     that has finished, never tile 0 across a long dead stretch. One warp
//     reads 32 earlier words at a time;
//   - the carry's value in each plane is one global read a plane a tile;
//     sources inside the tile come from shared memory; each plane leaves
//     with 16-byte stores.
// A status word is a flag in its top two bits and, below, the live position
// plus 1 (0 for none), so positions past 2^32 fit. The work memory (ops/
// scan_cuda.py fill_plan) is one word a tile and the ticket, cleared by one
// cudaMemsetAsync: a call is one memset and one launch, with no host
// decision, so it replays from a CUDA graph. A tile that is not whole, or a
// pointer that is not 16-byte aligned (a view into a plane), takes the same
// steps with 4-byte accesses.
//
// What bounds it on the H100: device-memory traffic. The key (or the alive
// bytes) and each plane are read once and each plane written once: 16n
// bytes for a key and one payload, 10n in mask mode with one plane.
//
// The same sweep, with the co-sort joins' decode and match around it, is
// fill_match_kernel (see the note above it).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 4;                 // elements of a 16-byte access
constexpr int ROWS = 4;                // 16-byte accesses a thread makes to a plane
constexpr int ROW = THREADS * VEC;     // elements of a row of the tile
constexpr int TILE = ROWS * ROW;       // ops/scan_cuda.py TILE
constexpr int MAX_PLANES = 9;  // key + 8 payloads (ops/scan_cuda.py MAX_PLANES)
constexpr int FILL_BLOCKS_PER_SM = 5;  // see fill_kernel
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned long long FLAG_AGG = 1ull << 62;     // a dead tile, look-back running
constexpr unsigned long long FLAG_PREFIX = 2ull << 62;  // last live position + 1 up to the tile
constexpr unsigned long long FLAG_MASK = 3ull << 62;

struct InPlanes {
  const uint32_t* p[MAX_PLANES];
};

struct OutPlanes {
  uint32_t* p[MAX_PLANES];
};

// Four elements at p + i: one 16-byte load when `vec`, else four loads of
// the positions below n (0 past it).
__device__ __forceinline__ uint4 load4(const uint32_t* __restrict__ p, long long i, long long n,
                                       bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p + i);
  uint32_t v[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) v[e] = i + e < n ? p[i + e] : 0u;
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(uint32_t* __restrict__ p, long long i, long long n,
                                       bool vec, const uint32_t (&v)[VEC]) {
  if (vec) {
    *reinterpret_cast<uint4*>(p + i) = make_uint4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    if (i + e < n) p[i + e] = v[e];
}

// The four alive bytes at i as bit e = alive[i + e] != 0.
__device__ __forceinline__ unsigned alive4(const uint8_t* __restrict__ alive, long long i,
                                           long long n, bool vec) {
  unsigned m = 0;
  if (vec) {
    const unsigned w = *reinterpret_cast<const unsigned*>(alive + i);
#pragma unroll
    for (int e = 0; e < VEC; ++e) m |= ((w >> (8 * e)) & 0xFFu) ? 1u << e : 0u;
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) m |= i + e < n && alive[i + e] ? 1u << e : 0u;
  }
  return m;
}

// The inclusive prefix (last live position + 1, or 0) of the tiles before
// `tile`, by one warp: it reads 32 earlier words at a time, passes AGG words
// (dead tiles) and stops at the nearest PREFIX, waiting where a word before
// it is not published yet. Words before tile 0 count as PREFIX 0.
__device__ __forceinline__ unsigned long long look_back_last(const unsigned long long* status,
                                                             long long tile) {
  const int lane = threadIdx.x & 31;
  const volatile unsigned long long* words = status;
  long long t = tile - 1;  // the nearest tile not passed yet
  for (;;) {
    const long long j = t - lane;
    const unsigned long long w = j >= 0 ? words[j] : FLAG_PREFIX;
    const unsigned pre = __ballot_sync(FULL, (w & FLAG_MASK) == FLAG_PREFIX);
    const unsigned unpub = __ballot_sync(FULL, (w & FLAG_MASK) == 0);
    const unsigned stop = pre & (0u - pre);  // the nearest PREFIX
    if (pre && !(unpub & (stop - 1u))) return __shfl_sync(FULL, w, __ffs(pre) - 1) & ~FLAG_MASK;
    const int passed = unpub ? __ffs(unpub) - 1 : 32;  // AGG words before the first gap
    t -= passed;
    if (passed == 0) __nanosleep(64);
  }
}

// The thread's before[k] (the last live position in the tile before its run
// of row k, or -1) and the tile's last live position (returned, or -1), from
// its live bits (bit 4k + e for element (k, e)): first within the warp (a
// ballot of the runs with a live element, then the nearest such lane
// below), then over the warps. Every thread of the block calls it.
__device__ __forceinline__ int tile_before(unsigned live, int (&before)[ROWS],
                                           int (*s_warp)[WARPS]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int mine0 = threadIdx.x * VEC;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const unsigned m = (live >> (VEC * k)) & 0xFu;
    const int own = m ? k * ROW + mine0 + 31 - __clz(m) : -1;
    const unsigned lower = __ballot_sync(FULL, m != 0) & below;  // lanes below with a live run
    const int from = __shfl_sync(FULL, own, lower ? 31 - __clz(lower) : 0);
    before[k] = lower ? from : -1;
    if (lane == 31) s_warp[k][warp] = m ? own : before[k];
  }
  __syncthreads();
  int last = -1;  // over the rows and warps in tile order: positions ascend
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    int pre = last;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int v = s_warp[k][w];
      if (w < warp) pre = max(pre, v);
      last = max(last, v);
    }
    before[k] = max(before[k], pre);
  }
  return last;
}

// By warp 0: publish the tile's status word (PREFIX with its own last live
// position where it has one, else AGG until the look-back ends) and return
// the carry, the last live position before the tile + 1, or 0.
__device__ __forceinline__ unsigned long long publish_carry(unsigned long long* status,
                                                            long long tile, long long base,
                                                            int last) {
  const int lane = threadIdx.x & 31;
  const unsigned long long own = last >= 0 ? (unsigned long long)(base + last) + 1 : 0ull;
  volatile unsigned long long* word = status + tile;
  if (lane == 0) *word = (own || tile == 0 ? FLAG_PREFIX : FLAG_AGG) | own;
  unsigned long long carry = 0;
  if (tile > 0) {
    carry = look_back_last(status, tile);
    if (lane == 0 && !own) *word = FLAG_PREFIX | carry;
  }
  return carry;
}

// One tile of the sweep (see the note at the top). Element (k, e) of a
// thread is tile position k * ROW + threadIdx.x * VEC + e. MASK: alive bytes
// mark live positions and `has` is written; otherwise in.p[0] != sentinel.
// `vec`: every pointer is 16-byte aligned (4-byte for the bytes). Up to
// three planes, at most 48 registers a thread, so that five blocks share an
// SM (the shared memory's limit is six): a tile holds its loads in flight
// only until its look-back, and more tiles an SM keep more bytes in flight.
// Measured beside four blocks at 63 registers (PERF.md §6), it was faster at
// both the 8Mi and the SF=64 round's shapes; wider calls keep their
// registers, which a cap would spill.
template <int NP, bool MASK>
__global__ void __launch_bounds__(THREADS, NP <= 3 ? FILL_BLOCKS_PER_SM : 1)
fill_kernel(InPlanes in, const uint8_t* __restrict__ alive, uint32_t sentinel, long long n,
            bool vec, OutPlanes out, uint8_t* __restrict__ has, unsigned* ticket,
            unsigned long long* status) {
  __shared__ __align__(16) uint32_t s_buf[2][TILE];  // planes q staged in s_buf[q & 1]
  __shared__ int s_warp[ROWS][WARPS];  // a warp's last live position in a row, or -1
  __shared__ uint32_t s_carry[NP];     // each plane's value at the carry (or the dead value)
  __shared__ int s_has_carry;
  __shared__ unsigned s_tile;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const long long base = tile * TILE;
  const bool whole = vec && base + TILE <= n;
  const uint32_t dead = MASK ? 0u : sentinel;
  const int mine0 = threadIdx.x * VEC;  // the thread's first position in a row

  // read: every load started before any is used, then the live bits (bit
  // 4k + e) and planes 0 and 1 staged
  uint4 v0[ROWS], v1[ROWS];
  unsigned runs[ROWS];  // a run's live bits
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const long long i = base + k * ROW + mine0;
    v0[k] = load4(in.p[0], i, n, whole);
    if constexpr (NP > 1) v1[k] = load4(in.p[1], i, n, whole);
    if constexpr (MASK) runs[k] = alive4(alive, i, n, whole);
  }
  unsigned live = 0;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int off = k * ROW + mine0;
    *reinterpret_cast<uint4*>(&s_buf[0][off]) = v0[k];
    if constexpr (NP > 1) *reinterpret_cast<uint4*>(&s_buf[1][off]) = v1[k];
    if constexpr (!MASK) {
      const uint32_t x[VEC] = {v0[k].x, v0[k].y, v0[k].z, v0[k].w};
      runs[k] = 0;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        runs[k] |= x[e] != sentinel && base + off + e < n ? 1u << e : 0u;
    }
    live |= runs[k] << (VEC * k);
  }

  int before[ROWS];
  const int last = tile_before(live, before, s_warp);

  if (warp == 0) {  // publish, look back for the carry, read its values
    const unsigned long long carry = publish_carry(status, tile, base, last);
#pragma unroll
    for (int q = 0; q < NP; ++q)
      if (lane == q) s_carry[q] = carry ? in.p[q][carry - 1] : dead;
    if (lane == 0) s_has_carry = carry != 0;
  }
  __syncthreads();

  // each plane from the staged tile, or the carry's value, 16 bytes a store
  auto write_plane = [&](int q, const uint32_t* buf) {
    const uint32_t cv = s_carry[q];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int off = k * ROW + mine0;
      const unsigned m = (live >> (VEC * k)) & 0xFu;
      uint32_t o[VEC];
      if (m == 0xFu) {
        const uint4 v = *reinterpret_cast<const uint4*>(&buf[off]);
        o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
      } else {
        int src = before[k];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          if ((m >> e) & 1u) src = off + e;
          o[e] = src >= 0 ? buf[src] : cv;
        }
      }
      store4(out.p[q], base + off, n, whole, o);
    }
  };
  write_plane(0, s_buf[0]);
  if constexpr (NP > 1) write_plane(1, s_buf[1]);
#pragma unroll
  for (int q = 2; q < NP; ++q) {
    uint4 v[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) v[k] = load4(in.p[q], base + k * ROW + mine0, n, whole);
    __syncthreads();  // the reads of plane q - 2 from this buffer are done
#pragma unroll
    for (int k = 0; k < ROWS; ++k)
      *reinterpret_cast<uint4*>(&s_buf[q & 1][k * ROW + mine0]) = v[k];
    __syncthreads();
    write_plane(q, s_buf[q & 1]);
  }
  if constexpr (MASK) {
    const bool carried = s_has_carry;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const long long i = base + k * ROW + mine0;
      const unsigned m = (live >> (VEC * k)) & 0xFu;
      unsigned h = 0;  // byte e: a live position at or before element e
      bool any = carried || before[k] >= 0;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        any = any || ((m >> e) & 1u);
        h |= (unsigned)any << (8 * e);
      }
      if (whole) {
        *reinterpret_cast<unsigned*>(has + i) = h;
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (i + e < n) has[i + e] = (uint8_t)(h >> (8 * e));
      }
    }
  }
}

template <int NP, bool MASK>
cudaError_t launch_fill(InPlanes in, const uint8_t* alive, uint32_t sentinel, long long n,
                        bool vec, OutPlanes out, uint8_t* has, unsigned long long* work,
                        cudaStream_t s) {
  const long long ntiles = (n + TILE - 1) / TILE;
  cudaError_t err = cudaMemsetAsync(work, 0, (size_t)(ntiles + 1) * 8, s);
  if (err != cudaSuccess) return err;
  unsigned* ticket = reinterpret_cast<unsigned*>(work + ntiles);
  fill_kernel<NP, MASK><<<(unsigned)ntiles, THREADS, 0, s>>>(in, alive, sentinel, n, vec, out,
                                                             has, ticket, work);
  return cudaGetLastError();
}

template <bool MASK>
cudaError_t dispatch_fill(int n_planes, InPlanes in, const uint8_t* alive, uint32_t sentinel,
                          long long n, bool vec, OutPlanes out, uint8_t* has,
                          unsigned long long* work, cudaStream_t s) {
#define DPU_FILL_CASE(NP) \
  case NP: return launch_fill<NP, MASK>(in, alive, sentinel, n, vec, out, has, work, s);
  switch (n_planes) {
    DPU_FILL_CASE(1)
    DPU_FILL_CASE(2)
    DPU_FILL_CASE(3)
    DPU_FILL_CASE(4)
    DPU_FILL_CASE(5)
    DPU_FILL_CASE(6)
    DPU_FILL_CASE(7)
    DPU_FILL_CASE(8)
    default: return launch_fill<9, MASK>(in, alive, sentinel, n, vec, out, has, work, s);
  }
#undef DPU_FILL_CASE
}

// ---------------------------------------------------------------------------
// The co-sort joins' fill and match in one sweep (ops/fill_match_cuda.py
// fill_match_k2). No TPU kernel of its own: it fuses
// dpu_olap_tpu/ops/scan_pallas.py:178 propagate_fill with the JAX package's
// fill and match glue around it (dpu_olap_tpu/ops/merge_xla.py:62
// join_shard_sorted_build, dpu_olap_tpu/ops/join.py:128 join_shard_fused),
// which the port ran as int64 elementwise passes before and after the fill.
//
// Input: the sorted planes (k2, payload 0 .. M-1), k2 = key << 1 | side (pk
// rows 0). A lane is live, a pk row that starts a carry, when k2 is even and
// below 0xFFFFFFFE (EMPTY << 1 is a masked-out build row); its carry is the
// nearest live lane at or before it. A lane is matched when k2 is odd and the
// carry's k2 is k2 ^ 1: the same key, which is then not EMPTY, since
// 0xFFFFFFFE is never live. Output, each of the length n: key = k2 >> 1,
// out_l[q] = payload q (q < m_l), out_r[q] = the carry's payload q (q <
// m_r) and matched = 1 where matched; 0 in every plane elsewhere.
//
// What bounds it on the H100: device-memory traffic. k2 and each payload
// are read once and every output written once: 4(1 + M) + 4(1 + m_l + m_r)
// + 1 bytes a lane, 21 at m_l = m_r = 1 (3.36 ms at 2^29 lanes). The design
// keeps every intermediate of the glue (the decoded key, the side mask, the
// filled key and payloads) out of device memory: the sweep is fill_kernel's
// (ticket, live bits in registers, a warp's ballot, the max look-back), the
// live bits come from k2 as it is read, the match is decided from k2 staged
// in shared memory, and each output leaves with 16-byte stores (the mask
// with 4-byte ones). A payload is staged only where a carry reads it (q <
// m_r); payload 0 is read with k2, before the look-back, as fill_kernel
// reads plane 1. Up to two payloads it keeps fill_kernel's budget of five
// blocks an SM (ptxas: 48 registers, 32 and 20 bytes spilled at one and two
// payloads; 74% of the bound at 2^29 lanes and one payload on an H100).
//
// The compacting form (COMPACT; ops/fill_match_cuda.py
// fill_match_compact_k2) takes the same steps up to the match and then
// writes only the matched lanes, in lane order: row i of key, out_l and
// out_r is the i-th matched lane's, no mask. Output row r is written only
// below `cap`. A tile ranks its hits (each thread's count in a row, a byte a
// row, summed over the warp by shuffles and over the warps in shared
// memory) and finds its first row by a second decoupled look-back, over the
// tiles' matched counts: a word a tile after the carry's words and the
// ticket, AGG with the tile's own count, then PREFIX with the count up to
// and including it. The last tile writes the total after them. Each plane
// is gathered in output order into shared memory (the key from k2's buffer,
// which it then reuses, the payloads from theirs) and leaves with 16-byte
// stores, aligned to the plane's address. Bytes: 4(1 + M) a lane and
// 4(1 + m_l + m_r) a matched lane, 14 a lane at m_l = m_r = 1 with half the
// lanes matched (2.24 ms at 2^29 lanes): the padded form's planes, the
// mask and the compaction's passes over them never reach device memory.
// It keeps the budget of five blocks an SM (ptxas: 48 registers, 4 bytes
// spilled at one payload; 60% of the bound at 2^29 lanes on an H100, where
// the stores and the second look-back are not all hidden behind other
// tiles' loads: fewer or more blocks an SM, per-warp or unstaged stores and
// blocks that prefetch their next tile were each slower).
constexpr uint32_t K2_DEAD = 0xFFFFFFFFu;  // the carry's k2 where there is none: odd

struct JoinOut {
  uint32_t* key;
  uint32_t* l[MAX_PLANES - 1];
  uint32_t* r[MAX_PLANES - 1];
  uint8_t* matched;
};

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_sync(FULL, v, lane ^ d);
  return v;
}

// The matched count of the tiles before `tile`, by one warp: the compacting
// form's second look-back. It adds the published counts up to and including
// the nearest PREFIX, 32 words a step, and waits where a word before it is
// not published yet. Words before tile 0 count as PREFIX 0.
__device__ __forceinline__ unsigned long long look_back_count(const unsigned long long* counts,
                                                              long long tile) {
  const int lane = threadIdx.x & 31;
  const volatile unsigned long long* words = counts;
  unsigned long long before = 0;
  long long t = tile - 1;  // the nearest tile not added yet
  for (;;) {
    const long long j = t - lane;
    const unsigned long long w = j >= 0 ? words[j] : FLAG_PREFIX;
    const unsigned pre = __ballot_sync(FULL, (w & FLAG_MASK) == FLAG_PREFIX);
    const unsigned unpub = __ballot_sync(FULL, (w & FLAG_MASK) == 0);
    const unsigned stop = pre & (0u - pre);  // the nearest PREFIX
    if (pre && !(unpub & (stop - 1u)))
      return before + warp_sum(lane < __ffs(pre) ? w & ~FLAG_MASK : 0ull);
    const int passed = unpub ? __ffs(unpub) - 1 : 32;  // AGG words before the first gap
    before += warp_sum(lane < passed ? w & ~FLAG_MASK : 0ull);
    t -= passed;
    if (passed == 0) __nanosleep(64);
  }
}

// By warp 0: publish the tile's matched count (PREFIX at tile 0, else AGG
// and, once the look-back ends, PREFIX with the inclusive count) and return
// the count of the tiles before it.
__device__ __forceinline__ unsigned long long publish_count(unsigned long long* counts,
                                                            long long tile, unsigned own) {
  const int lane = threadIdx.x & 31;
  volatile unsigned long long* word = counts + tile;
  if (lane == 0) *word = (tile == 0 ? FLAG_PREFIX : FLAG_AGG) | own;
  if (tile == 0) return 0;
  const unsigned long long before = look_back_count(counts, tile);
  if (lane == 0) *word = FLAG_PREFIX | (before + own);
  return before;
}

template <int M, bool COMPACT>
__global__ void __launch_bounds__(THREADS, M <= 2 ? FILL_BLOCKS_PER_SM : 1)
fill_match_kernel(InPlanes in, int m_l, int m_r, long long n, bool vec, JoinOut out,
                  unsigned long long cap, unsigned* ticket, unsigned long long* status) {
  // k2 in s_buf[0], payload q in s_buf[(q + 1) & 1]; the compacting form
  // gathers each output plane into s_buf[0], a group of four past the tile
  __shared__ __align__(16) uint32_t s_buf[2][TILE + (COMPACT ? VEC : 0)];
  __shared__ int s_warp[ROWS][WARPS];
  __shared__ uint32_t s_carry[1 + M];  // the carry's k2 (K2_DEAD where none) and payloads
  __shared__ unsigned s_tile;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const long long base = tile * TILE;
  const bool whole = vec && base + TILE <= n;
  const int mine0 = threadIdx.x * VEC;

  uint4 v0[ROWS], v1[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const long long i = base + k * ROW + mine0;
    v0[k] = load4(in.p[0], i, n, whole);
    if constexpr (M > 0) v1[k] = load4(in.p[1], i, n, whole);
  }
  unsigned live = 0;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int off = k * ROW + mine0;
    *reinterpret_cast<uint4*>(&s_buf[0][off]) = v0[k];
    if constexpr (M > 0) *reinterpret_cast<uint4*>(&s_buf[1][off]) = v1[k];
    const uint32_t x[VEC] = {v0[k].x, v0[k].y, v0[k].z, v0[k].w};
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      live |= !(x[e] & 1u) && x[e] < K2_DEAD - 1u && base + off + e < n ? 1u << (VEC * k + e)
                                                                        : 0u;
  }

  int before[ROWS];
  const int last = tile_before(live, before, s_warp);
  if (warp == 0) {
    const unsigned long long carry = publish_carry(status, tile, base, last);
#pragma unroll
    for (int q = 0; q <= M; ++q)
      if (lane == q && q <= m_r) s_carry[q] = carry ? in.p[q][carry - 1] : K2_DEAD;
  }
  __syncthreads();

  // the match (bit 4k + e); the padded form writes the key and the mask
  unsigned hit = 0;
  const uint32_t ck = s_carry[0];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int off = k * ROW + mine0;
    const unsigned m = (live >> (VEC * k)) & 0xFu;
    const uint4 v = *reinterpret_cast<const uint4*>(&s_buf[0][off]);
    const uint32_t own[VEC] = {v.x, v.y, v.z, v.w};
    int src = before[k];
    uint32_t o[VEC];
    unsigned h = 0;  // byte e: element e matched
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      if ((m >> e) & 1u) src = off + e;
      const uint32_t pk = src >= 0 ? s_buf[0][src] : ck;
      const bool hit_e = (own[e] & 1u) && pk == (own[e] ^ 1u);
      o[e] = hit_e ? own[e] >> 1 : 0u;
      hit |= (unsigned)hit_e << (VEC * k + e);
      h |= (unsigned)hit_e << (8 * e);
    }
    if constexpr (!COMPACT) {
      const long long i = base + off;
      store4(out.key, i, n, whole, o);
      if (whole) {
        *reinterpret_cast<unsigned*>(out.matched + i) = h;
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (i + e < n) out.matched[i + e] = (uint8_t)(h >> (8 * e));
      }
    }
  }

  if constexpr (COMPACT) {
    __shared__ unsigned s_count[WARPS];  // a warp's hits in each row, a byte a row
    __shared__ unsigned long long s_first;
    // the thread's hits a row, a byte each; their sum over the lanes up to it
    unsigned mine = 0;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) mine |= (unsigned)__popc((hit >> (VEC * k)) & 0xFu) << (8 * k);
    unsigned upto = mine;  // at most 128 a byte: no carry between bytes
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned v = __shfl_sync(FULL, upto, lane - d);
      if (lane >= d) upto += v;
    }
    if (lane == 31) s_count[warp] = upto;
    __syncthreads();
    int rank[ROWS];  // the tile's hits before the thread's first in row k
    int total = 0;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      int pre = 0, row = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const int c = (int)((s_count[w] >> (8 * k)) & 0xFFu);
        if (w < warp) pre += c;
        row += c;
      }
      rank[k] = total + pre + (int)(((upto - mine) >> (8 * k)) & 0xFFu);
      total += row;
    }
    const long long ntiles = (n + TILE - 1) / TILE;
    unsigned long long* counts = status + ntiles + 1;  // a word a tile, then the total
    if (warp == 0) {
      const unsigned long long first = publish_count(counts, tile, (unsigned)total);
      if (lane == 0) {
        s_first = first;
        if (tile == ntiles - 1) counts[ntiles] = first + total;
      }
    }
    __syncthreads();
    const unsigned long long first = s_first;
    const int rows = first >= cap ? 0 : (int)(cap - first < (unsigned long long)total
                                                  ? cap - first : (unsigned long long)total);
    if (rows == 0) return;  // the same in every thread

    uint32_t* const a = s_buf[0];
    // where g[first] sits in its group of four: a[phase + r] holds row first + r
    auto phase = [&](const uint32_t* g) {
      return (int)((reinterpret_cast<uintptr_t>(g + first) >> 2) & 3u);
    };
    // a[ph + the hit's rank] = value(k, e) for each of the thread's hits
    auto gather = [&](int ph, auto value) {
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const unsigned mk = (hit >> (VEC * k)) & 0xFu;
        int r = ph + rank[k];
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if ((mk >> e) & 1u) a[r++] = value(k, e);
      }
    };
    // g[first + r] = a[ph + r] for r < rows: 16 bytes a store where a whole
    // group of four is in range, 4 at the two ends; streaming stores (evict
    // first), which no later read of the sweep wants in L2 (60.0% of the
    // bound against 57.5% with plain stores at 2^29 lanes on an H100)
    auto put = [&](uint32_t* g, int ph) {
      uint32_t* const at = g + first;
      const int end = ph + rows;
      for (int j = VEC * threadIdx.x; j < end; j += VEC * THREADS) {
        if (j >= ph && j + VEC <= end) {
          __stcs(reinterpret_cast<uint4*>(at + (j - ph)), *reinterpret_cast<const uint4*>(&a[j]));
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            if (j + e >= ph && j + e < end) __stcs(at + (j + e - ph), a[j + e]);
        }
      }
    };

    // the key: k2 >> 1 out of a before a takes the gathered rows
    uint32_t key[ROWS][VEC];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const uint4 v = *reinterpret_cast<const uint4*>(&a[k * ROW + mine0]);
      key[k][0] = v.x >> 1, key[k][1] = v.y >> 1, key[k][2] = v.z >> 1, key[k][3] = v.w >> 1;
    }
    __syncthreads();
    int ph = phase(out.key);
    gather(ph, [&](int k, int e) { return key[k][e]; });
    __syncthreads();
    put(out.key, ph);

    // each payload q from its staged tile: the carry's (q < m_r), then the
    // lane's own (q < m_l)
#pragma unroll
    for (int q = 0; q < M; ++q) {
      uint32_t* const b = s_buf[1];
      if (q > 0) {
        uint4 v[ROWS];
#pragma unroll
        for (int k = 0; k < ROWS; ++k) v[k] = load4(in.p[1 + q], base + k * ROW + mine0, n, whole);
        __syncthreads();  // the gathers from payload q - 1 are done
#pragma unroll
        for (int k = 0; k < ROWS; ++k) *reinterpret_cast<uint4*>(&b[k * ROW + mine0]) = v[k];
      }
      if (q < m_r) {
        const uint32_t cv = s_carry[1 + q];
        __syncthreads();  // the last put from a, and b's stores, are done
        ph = phase(out.r[q]);
        gather(ph, [&](int k, int e) {
          // the nearest live lane at or before (k, e), in the tile or the carry
          const unsigned m = (live >> (VEC * k)) & ((2u << e) - 1u);
          const int src = m ? k * ROW + mine0 + 31 - __clz(m) : before[k];
          return src >= 0 ? b[src] : cv;
        });
        __syncthreads();
        put(out.r[q], ph);
      }
      if (q < m_l) {
        __syncthreads();
        ph = phase(out.l[q]);
        gather(ph, [&](int k, int e) { return b[k * ROW + mine0 + e]; });
        __syncthreads();
        put(out.l[q], ph);
      }
    }
  } else {
    // each payload: its own values where matched (q < m_l), and the carry's
    // from the staged tile or s_carry (q < m_r)
#pragma unroll
    for (int q = 0; q < M; ++q) {
      const bool carried = q < m_r;
      const bool staged = q == 0 || carried;  // the lane's own values are read from buf
      uint32_t* buf = s_buf[(q + 1) & 1];
      uint4 v[ROWS];
      if (q > 0) {
#pragma unroll
        for (int k = 0; k < ROWS; ++k) v[k] = load4(in.p[1 + q], base + k * ROW + mine0, n, whole);
        if (carried) {
          __syncthreads();  // the reads of k2 or of payload q - 2 from this buffer are done
#pragma unroll
          for (int k = 0; k < ROWS; ++k)
            *reinterpret_cast<uint4*>(&buf[k * ROW + mine0]) = v[k];
          __syncthreads();
        }
      }
      const uint32_t cv = s_carry[1 + q];
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const int off = k * ROW + mine0;
        const long long i = base + off;
        const unsigned mk = (hit >> (VEC * k)) & 0xFu;
        const uint4 w = staged ? *reinterpret_cast<const uint4*>(&buf[off]) : v[k];
        const uint32_t own[VEC] = {w.x, w.y, w.z, w.w};
        uint32_t o[VEC];
        if (q < m_l) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) o[e] = (mk >> e) & 1u ? own[e] : 0u;
          store4(out.l[q], i, n, whole, o);
        }
        if (carried) {
          const unsigned m = (live >> (VEC * k)) & 0xFu;
          int src = before[k];
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            if ((m >> e) & 1u) src = off + e;
            o[e] = (mk >> e) & 1u ? (src >= 0 ? buf[src] : cv) : 0u;
          }
          store4(out.r[q], i, n, whole, o);
        }
      }
    }
  }
}

template <int M, bool COMPACT>
cudaError_t launch_fill_match(InPlanes in, int m_l, int m_r, long long n, bool vec, JoinOut out,
                              unsigned long long cap, unsigned long long* work,
                              cudaStream_t s) {
  const long long ntiles = (n + TILE - 1) / TILE;
  // the carry's words and the ticket; the compacting form's counts and total after them
  const size_t words = (size_t)(ntiles + 1) * (COMPACT ? 2 : 1);
  cudaError_t err = cudaMemsetAsync(work, 0, words * 8, s);
  if (err != cudaSuccess) return err;
  unsigned* ticket = reinterpret_cast<unsigned*>(work + ntiles);
  fill_match_kernel<M, COMPACT><<<(unsigned)ntiles, THREADS, 0, s>>>(in, m_l, m_r, n, vec, out,
                                                                     cap, ticket, work);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t to) { return reinterpret_cast<uintptr_t>(p) % to == 0; }

template <bool COMPACT>
int dispatch_fill_match(void* const* in_planes, int m_l, int m_r, long long n,
                        unsigned long long cap, void* key, void* const* out_l,
                        void* const* out_r, void* matched, void* work, void* stream) {
  if (m_l < 0 || m_r < 0 || m_l >= MAX_PLANES || m_r >= MAX_PLANES || n < 1)
    return (int)cudaErrorInvalidValue;
  const int m = m_l > m_r ? m_l : m_r;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  InPlanes in{};
  JoinOut out{};
  out.key = static_cast<uint32_t*>(key);
  out.matched = static_cast<uint8_t*>(matched);
  // the compacting form aligns its stores to each output's own address
  bool vec = COMPACT || (aligned(key, 16) && aligned(matched, 4));
  for (int q = 0; q <= m; ++q) {
    in.p[q] = static_cast<const uint32_t*>(in_planes[q]);
    vec = vec && aligned(in.p[q], 16);
  }
  for (int q = 0; q < m_l; ++q) {
    out.l[q] = static_cast<uint32_t*>(out_l[q]);
    vec = vec && (COMPACT || aligned(out.l[q], 16));
  }
  for (int q = 0; q < m_r; ++q) {
    out.r[q] = static_cast<uint32_t*>(out_r[q]);
    vec = vec && (COMPACT || aligned(out.r[q], 16));
  }
  unsigned long long* w = static_cast<unsigned long long*>(work);
#define DPU_FILL_MATCH_CASE(M) \
  case M: return (int)launch_fill_match<M, COMPACT>(in, m_l, m_r, n, vec, out, cap, w, s);
  switch (m) {
    DPU_FILL_MATCH_CASE(0)
    DPU_FILL_MATCH_CASE(1)
    DPU_FILL_MATCH_CASE(2)
    DPU_FILL_MATCH_CASE(3)
    DPU_FILL_MATCH_CASE(4)
    DPU_FILL_MATCH_CASE(5)
    DPU_FILL_MATCH_CASE(6)
    DPU_FILL_MATCH_CASE(7)
    default: return (int)launch_fill_match<8, COMPACT>(in, m_l, m_r, n, vec, out, cap, w, s);
  }
#undef DPU_FILL_MATCH_CASE
}

}  // namespace

// Forward-fill n_planes uint32 planes of length n (1 <= n_planes <= 9) from
// in_planes into out_planes (host arrays of device pointers). With alive
// null, position j is live when in_planes[0][j] != sentinel and dead lanes
// take the sentinel; otherwise alive (n bytes) marks live positions, dead
// lanes take 0 and has (n bytes) receives 0/1. work holds ops/scan_cuda.py
// fill_plan's words: one uint64 a tile of 4096 and the ticket, which the
// function clears on the stream. Launches on `stream` and does not
// synchronise. Returns 0 or the first CUDA error.
extern "C" int dpu_fill_u32(void* const* in_planes, void* const* out_planes, int n_planes,
                            long long n, unsigned sentinel, const void* alive, void* has,
                            void* work, void* stream) {
  if (n_planes < 1 || n_planes > MAX_PLANES || n < 1 || (alive == nullptr) != (has == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  InPlanes in{};
  OutPlanes out{};
  bool vec = aligned(alive, 4) && aligned(has, 4);
  for (int q = 0; q < n_planes; ++q) {
    in.p[q] = static_cast<const uint32_t*>(in_planes[q]);
    out.p[q] = static_cast<uint32_t*>(out_planes[q]);
    vec = vec && aligned(in.p[q], 16) && aligned(out.p[q], 16);
  }
  unsigned long long* w = static_cast<unsigned long long*>(work);
  const uint8_t* al = static_cast<const uint8_t*>(alive);
  uint8_t* h = static_cast<uint8_t*>(has);
  const cudaError_t err =
      al ? dispatch_fill<true>(n_planes, in, al, sentinel, n, vec, out, h, w, s)
         : dispatch_fill<false>(n_planes, in, al, sentinel, n, vec, out, h, w, s);
  return (int)err;
}


// The co-sort joins' fill and match (fill_match_kernel): in_planes holds k2
// and max(m_l, m_r) payload planes of length n (0 <= m_l, m_r <= 8),
// out_l and out_r m_l and m_r uint32 planes, key a uint32 plane and matched
// n bytes (host arrays of device pointers where plural). work holds
// ops/scan_cuda.py fill_plan's words, which the function clears on the
// stream. Launches on `stream` and does not synchronise. Returns 0 or the
// first CUDA error.
extern "C" int dpu_fill_match_u32(void* const* in_planes, int m_l, int m_r, long long n,
                                  void* key, void* const* out_l, void* const* out_r,
                                  void* matched, void* work, void* stream) {
  return dispatch_fill_match<false>(in_planes, m_l, m_r, n, (unsigned long long)n, key, out_l,
                                    out_r, matched, work, stream);
}

// The same, compacted (fill_match_kernel's compacting form): key, out_l and
// out_r receive the matched lanes' rows in lane order, rows below cap only.
// work holds twice fill_plan's words (ops/fill_match_cuda.py
// compact_words): the carry's words and the ticket, then a count word a tile
// and, in the last word, the number of matched lanes (uint64), which may
// exceed cap. The function clears them on the stream, launches on it and
// does not synchronise. Returns 0 or the first CUDA error.
extern "C" int dpu_fill_match_compact_u32(void* const* in_planes, int m_l, int m_r, long long n,
                                          long long cap, void* key, void* const* out_l,
                                          void* const* out_r, void* work, void* stream) {
  if (cap < 0) return (int)cudaErrorInvalidValue;
  return dispatch_fill_match<true>(in_planes, m_l, m_r, n, (unsigned long long)cap, key, out_l,
                                   out_r, nullptr, work, stream);
}
