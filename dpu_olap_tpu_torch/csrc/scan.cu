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

  // before[k]: the last live position in the tile before the thread's run
  // of row k, or -1; first within the warp (a ballot of the runs with a
  // live element, then the nearest such lane below), then over the warps
  const unsigned below = (1u << lane) - 1u;
  int before[ROWS];
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

  if (warp == 0) {  // publish, look back for the carry, read its values
    const unsigned long long own = last >= 0 ? (unsigned long long)(base + last) + 1 : 0ull;
    volatile unsigned long long* word = status + tile;
    if (lane == 0) *word = (own || tile == 0 ? FLAG_PREFIX : FLAG_AGG) | own;
    unsigned long long carry = 0;  // last live position before the tile + 1, or 0
    if (tile > 0) {
      carry = look_back_last(status, tile);
      if (lane == 0 && !own) *word = FLAG_PREFIX | carry;
    }
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

bool aligned(const void* p, uintptr_t to) { return reinterpret_cast<uintptr_t>(p) % to == 0; }

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
