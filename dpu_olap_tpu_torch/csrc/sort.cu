// Bitonic network kernels over a uint32 key plane with up to MAX_PAYLOADS
// uint32 payload planes following it: the two entry points that are bitonic
// by contract. The whole sort (dpu_sort_u32) is the radix sort of
// csrc/radix_sort.cu.
//
//   tile_sort_kernel  <- the TPU merge-tree sort's XLA leaf row sort and
//                        bitonic_cascade_rounds (dpu_olap_tpu/ops/
//                        sort_pallas.py:286, 103): every merge round whose
//                        segment fits one 4096-element tile. It makes
//                        dpu_sort_tiles_u32, the counterpart of
//                        scripts/measure_filter.py measure_sort's
//                        `upto_inblock` (the leaf sort plus the cascade up to
//                        one VMEM block of 128Ki on the TPU).
//   merge_pass_kernel <- dpu_olap_tpu/ops/bitonic_pallas.py:91
//                        bitonic_merge_blocks (_merge_block_kernel) and the
//                        cross-block pass that merge_xla.py runs through
//                        sort_pallas.py:327 bitonic_xblock. Two or more
//                        launches make dpu_merge_blocks_u32.
//
// The tile stage. The host pads the length to a power of two npow >=
// max(n, MIN_LEN); rows >= n read as key and payload 0xFFFFFFFF. Each tile
// of min(npow, 4096) elements comes out sorted, ascending at even tile
// indices and descending at odd ones (ascending when one tile covers npow),
// unstable. A block of 256 threads holds its tile's keys in registers, 16 a
// thread, in one of two layouts: A (thread t holds elements 16t .. 16t+15)
// runs the stages d <= 8 inside a thread and d = 16 .. 256 across the lanes
// of a warp with shuffles; B (thread t holds t + 256r) runs the stages d >=
// 256 inside a thread. Only the rounds k >= 1024 switch layouts, through a
// swizzled shared-memory transposition each way: 12 barriers for the 78
// stages. Directions are folded into the keys (each held complemented while
// its segment sorts descending), so that every compare-exchange is a min
// and a max: the network is bound by the integer pipe, and this halves its
// instructions against compare-and-select with a direction. The network
// carries each key's position in the tile, two 16-bit positions a word
// moved by one byte permutation; each payload plane is then staged in
// shared memory and gathered by those positions once.
//
// The block merge: the ascending half-cleaner cascade d = block/2 .. 1 on
// each block of a sequence whose blocks are bitonic. A compare-exchange
// swaps only when the lower slot's key is strictly greater, so each slot
// keeps its own pair on a tie, as the TPU kernel's selects do
// (bitonic_pallas.py:71-72); the network is kept stage for stage, so ties
// leave the payloads where the TPU kernel leaves them. Every pass gives a
// block of 512 threads a set of SET (16Ki) elements, staged in shared memory
// with a 16-bit position each (96 KB: two blocks an SM), and runs all its
// stages there, three to a barrier:
//   * a strided pass runs up to MAX_STRIDED (9) stages d >= SET: its set is
//     2^S rows of SET >> S consecutive elements at stride low_d, so the
//     stages d = low_d << (S-1) .. low_d are the set's own stages at
//     distances SET/2 .. SET >> S. Rows are at least 128 bytes, read and
//     written with 16-byte accesses. One pass covers blocks up to 8Mi, two
//     up to 4Gi.
//   * the tile pass runs the stages d < SET on tiles of min(SET, n & -n)
//     elements: d >= 32 in shared memory, the last five in registers, four
//     consecutive elements a thread (d = 2, 1 inside it, d = 16, 8, 4 by
//     shuffles).
// The first pass reads the input planes and every later one works in
// place on the outputs, so there is no copy. At the sorted-build join's 8Mi
// block with one payload: two passes over two planes. merge_plan in
// ops/bitonic_cuda.py mirrors run_merge's plan.
//
// What bounds them on the H100: the merge, device-memory passes (16n bytes
// a pass at one payload) and, inside a set, the integer pipe and shared
// memory; the tile stage, the integer pipe (its 16 MiB at 2Mi take a tenth
// of its time). The tile stage runs three blocks an SM: at 85 registers
// without spills they measured faster than four at 64 with them, though 512
// tiles then take 1.3 waves. Kernels are templated on the payload count so
// that the payload pointers stay in registers.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int MAX_PAYLOADS = 8;
constexpr int MIN_LEN = 128;  // smallest padded length / block: one full warp a tile

constexpr int TILE = 4096;  // elements of one tile-stage tile (power of two)
constexpr int SORT_THREADS = 256;
constexpr int SORT_E = TILE / SORT_THREADS;  // 16 elements a thread
constexpr int SORT_BLOCKS_PER_SM = 3;

constexpr int SET_SHIFT = 14;
constexpr int SET = 1 << SET_SHIFT;  // elements of a merge pass's set
constexpr int MERGE_THREADS = 512;
constexpr int MERGE_BLOCKS_PER_SM = 2;
// stages of one strided pass: rows of at least 32 elements (128 bytes)
constexpr int MAX_STRIDED = SET_SHIFT - 5;

struct Planes {
  uint32_t* p[1 + MAX_PAYLOADS];
};

struct ConstPlanes {
  const uint32_t* p[1 + MAX_PAYLOADS];
};

// ---------------------------------------------------------------- tile stage

// Positions in the tile sort travel packed, two 16-bit positions a word:
// pp[i] holds those of registers 2i (low half) and 2i + 1 (high half).
constexpr int SORT_W = SORT_E / 2;

// The ascending compare-exchanges of registers r and r + d, and (d > 1) of
// r + 1 and r + 1 + d (r even): keys by min and max, and one byte
// permutation moves both positions.
template <bool POS>
__device__ __forceinline__ void cx_pair(uint32_t (&kv)[SORT_E], uint32_t (&pp)[SORT_W], int r,
                                        int d) {
  const int e = d == 1 ? 1 : 2;  // compare-exchanges in this call
  bool sw[2];
#pragma unroll
  for (int j = 0; j < e; ++j) {
    const uint32_t a = kv[r + j], b = kv[r + j + d];
    sw[j] = a > b;
    kv[r + j] = min(a, b);
    kv[r + j + d] = max(a, b);
  }
  if constexpr (POS) {
    if (d == 1) {
      pp[r / 2] = sw[0] ? __byte_perm(pp[r / 2], 0, 0x1032) : pp[r / 2];
    } else {
      const uint32_t sel = 0x3210u | (sw[0] ? 0x44u : 0u) | (sw[1] ? 0x4400u : 0u);
      const uint32_t p = pp[r / 2], q = pp[(r + d) / 2];
      pp[r / 2] = __byte_perm(p, q, sel);
      pp[(r + d) / 2] = __byte_perm(p, q, sel ^ 0x4444u);
    }
  }
}

// Stages d = d0 .. 1 (d0 < 16) inside a thread, ascending: layout A's
// stages d < 16, or (as d = j for 256 j) layout B's.
template <bool POS>
__device__ __forceinline__ void thread_stages(uint32_t (&kv)[SORT_E], uint32_t (&pp)[SORT_W],
                                              int d0) {
#pragma unroll
  for (int d = SORT_E / 2; d >= 1; d >>= 1) {
    if (d > d0) continue;
#pragma unroll
    for (int r = 0; r < SORT_E; r += 2)
      if (!(r & d)) cx_pair<POS>(kv, pp, r, d);
  }
}

// Stage d = 16 m (m < 32), layout A, ascending: every element against the
// same register of lane ^ m, the lower lane keeping the minimum; a pair of
// positions travels in one shuffle.
template <bool POS>
__device__ __forceinline__ void shuffle_stage(uint32_t (&kv)[SORT_E], uint32_t (&pp)[SORT_W],
                                              int m) {
  const bool lower = (threadIdx.x & m) == 0;
#pragma unroll
  for (int r = 0; r < SORT_E; r += 2) {
    const uint32_t o0 = __shfl_xor_sync(0xFFFFFFFFu, kv[r], m);
    const uint32_t o1 = __shfl_xor_sync(0xFFFFFFFFu, kv[r + 1], m);
    const uint32_t n0 = lower ? min(kv[r], o0) : max(kv[r], o0);
    const uint32_t n1 = lower ? min(kv[r + 1], o1) : max(kv[r + 1], o1);
    if constexpr (POS) {  // a slot takes its partner's position iff its key changed
      const uint32_t op = __shfl_xor_sync(0xFFFFFFFFu, pp[r / 2], m);
      pp[r / 2] = __byte_perm(pp[r / 2], op,
                              0x3210u | (n0 != kv[r] ? 0x44u : 0u) | (n1 != kv[r + 1] ? 0x4400u : 0u));
    }
    kv[r] = n0;
    kv[r + 1] = n1;
  }
}

// Direction by complement: during round k each key is held as key ^ (bit k
// of its index ? ~0 : 0), so that every compare-exchange is ascending and a
// segment whose bit is set comes out descending in the key. remask moves
// layout A's registers from round k's mask to round `next`'s (0: no mask);
// the index of register r is i0 + r with i0 a multiple of 16, so from k = 16
// on a thread's mask is one word.
__device__ __forceinline__ uint32_t round_mask(long long i, int k) {
  return k && (i & k) ? 0xFFFFFFFFu : 0u;
}

template <int K, int NEXT>
__device__ __forceinline__ void remask_low(uint32_t (&kv)[SORT_E], long long i0) {
#pragma unroll
  for (int r = 0; r < SORT_E; ++r) kv[r] ^= round_mask(i0 + r, K) ^ round_mask(i0 + r, NEXT);
}

__device__ __forceinline__ void remask(uint32_t (&kv)[SORT_E], long long i0, int k, int next) {
  const uint32_t m = round_mask(i0, k) ^ round_mask(i0, next);
#pragma unroll
  for (int r = 0; r < SORT_E; ++r) kv[r] ^= m;
}

// Shared-memory word of tile element l in the layout transpositions: rows
// of 32 words whose 16-byte groups are XORed with the row's low two bits, so
// that layout A's 16-byte accesses and layout B's word accesses are both
// free of bank conflicts.
__device__ __forceinline__ int swz(int l) { return l ^ (((l >> 5) & 3) << 2); }

// Moves the registers from layout A to B (to_b) or back through shared
// memory, positions unpacked there.
template <bool POS>
__device__ __forceinline__ void transpose(uint32_t (&kv)[SORT_E], uint32_t (&pp)[SORT_W],
                                          uint32_t* skey, uint32_t* spos, bool to_b) {
  const int t = threadIdx.x;
  __syncthreads();  // the last reads of the arrays are done
  if (to_b) {
#pragma unroll
    for (int v = 0; v < SORT_E; v += 4) {
      *reinterpret_cast<uint4*>(skey + swz(t * SORT_E + v)) =
          make_uint4(kv[v], kv[v + 1], kv[v + 2], kv[v + 3]);
      if constexpr (POS)
        *reinterpret_cast<uint4*>(spos + swz(t * SORT_E + v)) =
            make_uint4(pp[v / 2] & 0xFFFFu, pp[v / 2] >> 16, pp[v / 2 + 1] & 0xFFFFu,
                       pp[v / 2 + 1] >> 16);
    }
  } else {
#pragma unroll
    for (int r = 0; r < SORT_E; ++r) {
      skey[swz(t + SORT_THREADS * r)] = kv[r];
      if constexpr (POS)
        spos[swz(t + SORT_THREADS * r)] = r & 1 ? pp[r / 2] >> 16 : pp[r / 2] & 0xFFFFu;
    }
  }
  __syncthreads();
  if (to_b) {
#pragma unroll
    for (int r = 0; r < SORT_E; r += 2) {
      kv[r] = skey[swz(t + SORT_THREADS * r)];
      kv[r + 1] = skey[swz(t + SORT_THREADS * (r + 1))];
      if constexpr (POS)
        pp[r / 2] = __byte_perm(spos[swz(t + SORT_THREADS * r)],
                                spos[swz(t + SORT_THREADS * (r + 1))], 0x5410);
    }
  } else {
#pragma unroll
    for (int v = 0; v < SORT_E; v += 4) {
      const uint4 a = *reinterpret_cast<const uint4*>(skey + swz(t * SORT_E + v));
      kv[v] = a.x, kv[v + 1] = a.y, kv[v + 2] = a.z, kv[v + 3] = a.w;
      if constexpr (POS) {
        const uint4 b = *reinterpret_cast<const uint4*>(spos + swz(t * SORT_E + v));
        pp[v / 2] = __byte_perm(b.x, b.y, 0x5410);
        pp[v / 2 + 1] = __byte_perm(b.z, b.w, 0x5410);
      }
    }
  }
}

// Reads 16 consecutive elements (from g, 16-aligned in the plane) of a
// plane of length n with the 0xFFFFFFFF pad: 16-byte loads when vec and the
// whole run lies below n.
__device__ __forceinline__ void load16(const uint32_t* plane, long long g, long long n, bool vec,
                                       uint32_t (&v)[SORT_E]) {
  if (vec && g + SORT_E <= n) {
#pragma unroll
    for (int j = 0; j < SORT_E; j += 4) {
      const uint4 a = *reinterpret_cast<const uint4*>(plane + g + j);
      v[j] = a.x, v[j + 1] = a.y, v[j + 2] = a.z, v[j + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < SORT_E; ++j) v[j] = g + j < n ? plane[g + j] : 0xFFFFFFFFu;
  }
}

// Writes 16 consecutive elements (from g) of a plane of length npow: the
// first `left` of them (all when left >= 16).
__device__ __forceinline__ void store16(uint32_t* plane, long long g, int left, bool vec,
                                        const uint32_t (&v)[SORT_E]) {
  if (vec && left >= SORT_E) {
#pragma unroll
    for (int j = 0; j < SORT_E; j += 4)
      *reinterpret_cast<uint4*>(plane + g + j) = make_uint4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < SORT_E; ++j)
      if (j < left) plane[g + j] = v[j];
  }
}

// Rounds k = 2 .. tile on one tile a block (see the file's head). A tile
// shorter than TILE (npow < TILE: one block) runs in the first tile elements
// of the registers; the rest hold pad and are not written.
template <int NPAY>
__global__ void __launch_bounds__(SORT_THREADS, SORT_BLOCKS_PER_SM)
tile_sort_kernel(ConstPlanes in, Planes out, long long n, int tile, bool vec) {
  constexpr bool POS = NPAY > 0;
  __shared__ __align__(16) uint32_t skey[TILE];
  __shared__ __align__(16) uint32_t spos[POS ? TILE : 4];
  const int t = threadIdx.x;
  const int l0 = t * SORT_E;
  const long long base = (long long)blockIdx.x * tile;
  const long long i0 = base + l0;
  uint32_t kv[SORT_E], pp[SORT_W];
  load16(in.p[0], i0, n, vec, kv);
#pragma unroll
  for (int i = 0; i < SORT_W; ++i) pp[i] = (l0 + 2 * i) | (l0 + 2 * i + 1) << 16;

  // rounds 2 .. 16 inside a thread (a tile holds at least 128 elements)
  remask_low<0, 2>(kv, i0);
  thread_stages<POS>(kv, pp, 1);
  remask_low<2, 4>(kv, i0);
  thread_stages<POS>(kv, pp, 2);
  remask_low<4, 8>(kv, i0);
  thread_stages<POS>(kv, pp, 4);
  remask_low<8, 16>(kv, i0);
  thread_stages<POS>(kv, pp, 8);
  remask_low<16, 32>(kv, i0);
  const int k_a = tile < 2 * SORT_THREADS ? tile : 2 * SORT_THREADS;
  for (int k = 2 * SORT_E; k <= k_a; k <<= 1) {  // every stage in layout A
    for (int d = k >> 1; d >= SORT_E; d >>= 1) shuffle_stage<POS>(kv, pp, d / SORT_E);
    thread_stages<POS>(kv, pp, SORT_E / 2);
    remask(kv, i0, k, 2 * k <= tile ? 2 * k : 0);
  }
  for (int k = 4 * SORT_THREADS; k <= tile; k <<= 1) {
    transpose<POS>(kv, pp, skey, spos, true);
    thread_stages<POS>(kv, pp, k / (2 * SORT_THREADS));  // d = k/2 .. 256: register distance d / 256
    transpose<POS>(kv, pp, skey, spos, false);
    for (int d = SORT_THREADS / 2; d >= SORT_E; d >>= 1) shuffle_stage<POS>(kv, pp, d / SORT_E);
    thread_stages<POS>(kv, pp, SORT_E / 2);
    remask(kv, i0, k, 2 * k <= tile ? 2 * k : 0);
  }

  const int left = tile - l0;  // elements of this thread's run inside the tile
  store16(out.p[0], i0, left, vec, kv);
#pragma unroll
  for (int q = 1; q <= NPAY; ++q) {
    __syncthreads();  // skey is free
    uint32_t w[SORT_E];  // this thread's four runs of four, all loads issued first
#pragma unroll
    for (int j = 0; j < SORT_E; j += 4) {
      const long long g = base + (t + j / 4 * SORT_THREADS) * 4;
      if (vec && g + 4 <= n) {
        const uint4 a = *reinterpret_cast<const uint4*>(in.p[q] + g);
        w[j] = a.x, w[j + 1] = a.y, w[j + 2] = a.z, w[j + 3] = a.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) w[j + e] = g + e < n ? in.p[q][g + e] : 0xFFFFFFFFu;
      }
    }
#pragma unroll
    for (int j = 0; j < SORT_E; j += 4)
      *reinterpret_cast<uint4*>(skey + (t + j / 4 * SORT_THREADS) * 4) =
          make_uint4(w[j], w[j + 1], w[j + 2], w[j + 3]);
    __syncthreads();
    uint32_t v[SORT_E];
#pragma unroll
    for (int r = 0; r < SORT_E; ++r) v[r] = skey[r & 1 ? pp[r / 2] >> 16 : pp[r / 2] & 0xFFFFu];
    store16(out.p[q], i0, left, vec, v);
  }
}

// ---------------------------------------------------------------- block merge

// Ascending compare-exchange of two slots: the first keeps the smaller key,
// and a tie keeps both. With POS, a position follows its key.
template <bool POS>
__device__ __forceinline__ void cx(uint32_t& a, uint32_t& b, uint32_t& pa, uint32_t& pb) {
  const bool sw = a > b;
  const uint32_t x = sw ? b : a, y = sw ? a : b;
  a = x;
  b = y;
  if constexpr (POS) {
    const uint32_t px = sw ? pb : pa, py = sw ? pa : pb;
    pa = px;
    pb = py;
  }
}

// Stages d = low << (S-1) .. low (low >= 32) of the ascending cascade over
// the set in shared memory: each thread exchanges 2^S elements in
// registers, so S stages cost one barrier. Neighbouring threads take
// neighbouring slots, which keeps the accesses free of bank conflicts.
template <int S, bool POS>
__device__ __forceinline__ void smem_steps(uint32_t* key, uint16_t* pos, int set, int low) {
  constexpr int M = 1 << S;
  const int ls = __ffs(low) - 1;
  for (int g = threadIdx.x; g < (set >> S); g += blockDim.x) {
    const int lb = ((g >> ls) << (ls + S)) | (g & (low - 1));
    uint32_t kv[M], pv[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      kv[m] = key[lb + m * low];
      if constexpr (POS) pv[m] = pos[lb + m * low];
    }
#pragma unroll
    for (int j = S - 1; j >= 0; --j) {
#pragma unroll
      for (int m = 0; m < M; ++m)
        if (!(m & (1 << j))) cx<POS>(kv[m], kv[m | (1 << j)], pv[m], pv[m | (1 << j)]);
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      key[lb + m * low] = kv[m];
      if constexpr (POS) pos[lb + m * low] = (uint16_t)pv[m];
    }
  }
  __syncthreads();
}

// Where one pass's set lies: local element l (row l >> w_shift, column
// l & (width - 1)) is global element g0 + (row << low_shift) + column.
struct SetMap {
  long long g0;
  int w_shift, low_shift;
  __device__ __forceinline__ long long at(int l) const {
    return g0 + ((long long)(l >> w_shift) << low_shift) + (l & ((1 << w_shift) - 1));
  }
};

// Loads plane elements of the set into shared memory, four a thread a step
// (four consecutive set elements are consecutive in the plane).
__device__ __forceinline__ void load_set(const uint32_t* plane, uint32_t* dst, const SetMap& map,
                                         int set, bool vec) {
  for (int i = threadIdx.x * 4; i < set; i += 4 * blockDim.x) {
    const long long g = map.at(i);
    if (vec) {
      *reinterpret_cast<uint4*>(dst + i) = *reinterpret_cast<const uint4*>(plane + g);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[i + j] = plane[g + j];
    }
  }
}

__device__ __forceinline__ void store4(uint32_t* plane, long long g, uint4 v, bool vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(plane + g) = v;
  } else {
    plane[g] = v.x, plane[g + 1] = v.y, plane[g + 2] = v.z, plane[g + 3] = v.w;
  }
}

// One pass of the block merge (see the file's head) on the set of `set`
// elements that this block's map gives: the cascade's stages at set
// distances d_hi .. d_lo, all ascending. Reads `in`, writes `out` (which may
// be the same planes: a block reads its whole set before it writes).
template <int NPAY>
__global__ void __launch_bounds__(MERGE_THREADS, MERGE_BLOCKS_PER_SM)
merge_pass_kernel(ConstPlanes in, Planes out, int set, int w_shift, int low_shift,
                  int rows_shift, int d_hi, int d_lo, bool vec) {
  constexpr bool POS = NPAY > 0;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* key = smem;
  uint16_t* pos = reinterpret_cast<uint16_t*>(smem + set);
  const int per_shift = low_shift - w_shift;  // blocks a row's span holds
  const long long b = blockIdx.x;
  const SetMap map{((b >> per_shift) << (low_shift + rows_shift)) +
                       ((b & ((1LL << per_shift) - 1)) << w_shift),
                   w_shift, low_shift};
  load_set(in.p[0], key, map, set, vec);
  if constexpr (POS)
    for (int i = threadIdx.x; i < set; i += blockDim.x) pos[i] = (uint16_t)i;
  __syncthreads();

  const int d_end = d_lo > 32 ? d_lo : 32;
  int d = d_hi;
  while (d >= d_end) {
    if ((d >> 2) >= d_end) {
      smem_steps<3, POS>(key, pos, set, d >> 2);
      d >>= 3;
    } else if ((d >> 1) >= d_end) {
      smem_steps<2, POS>(key, pos, set, d >> 1);
      d >>= 2;
    } else {
      smem_steps<1, POS>(key, pos, set, d);
      d >>= 1;
    }
  }
  // The keys out; in the tile pass after the stages d = 16 .. 1, four
  // consecutive elements a thread (a warp holds 128 of them).
  for (int i = threadIdx.x * 4; i < set; i += 4 * blockDim.x) {
    const uint4 k4 = *reinterpret_cast<const uint4*>(key + i);
    uint32_t kv[4] = {k4.x, k4.y, k4.z, k4.w}, pv[4] = {0, 0, 0, 0};
    if (d_lo < 32) {
      if constexpr (POS) {
        const uint2 p2 = *reinterpret_cast<const uint2*>(pos + i);
        pv[0] = p2.x & 0xFFFFu, pv[1] = p2.x >> 16, pv[2] = p2.y & 0xFFFFu, pv[3] = p2.y >> 16;
      }
      for (int m = 4; m >= 1; m >>= 1) {  // d = 4m, against lane ^ m
        const bool lower = (threadIdx.x & m) == 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t o = __shfl_xor_sync(0xFFFFFFFFu, kv[j], m);
          uint32_t op = 0;
          if constexpr (POS) op = __shfl_xor_sync(0xFFFFFFFFu, pv[j], m);
          if (lower ? o < kv[j] : o > kv[j]) {
            kv[j] = o;
            pv[j] = op;
          }
        }
      }
      cx<POS>(kv[0], kv[2], pv[0], pv[2]);
      cx<POS>(kv[1], kv[3], pv[1], pv[3]);
      cx<POS>(kv[0], kv[1], pv[0], pv[1]);
      cx<POS>(kv[2], kv[3], pv[2], pv[3]);
      if constexpr (POS)
        *reinterpret_cast<uint2*>(pos + i) = make_uint2(pv[0] | (pv[1] << 16), pv[2] | (pv[3] << 16));
    }
    store4(out.p[0], map.at(i), make_uint4(kv[0], kv[1], kv[2], kv[3]), vec);
  }
#pragma unroll
  for (int q = 1; q <= NPAY; ++q) {
    __syncthreads();  // key and pos are final and key is free
    load_set(in.p[q], key, map, set, vec);
    __syncthreads();
    for (int i = threadIdx.x * 4; i < set; i += 4 * blockDim.x)
      store4(out.p[q], map.at(i),
             make_uint4(key[pos[i]], key[pos[i + 1]], key[pos[i + 2]], key[pos[i + 3]]), vec);
  }
}

// Stages d = block/2 .. 1, ascending, on each block of n elements, from in
// into out. The plan (mirrored by ops/bitonic_cuda.py merge_plan): strided
// passes of up to MAX_STRIDED stages each, from the top, for the stages d
// >= SET; then the tile pass on tiles of min(SET, n & -n).
template <int NPAY>
cudaError_t run_merge(const ConstPlanes& in, const Planes& out, long long n, long long block,
                      bool vec, cudaStream_t s) {
  constexpr size_t elem_bytes = NPAY > 0 ? 6 : 4;
  static bool opted_in = false;  // above 48 KB needs the opt-in, once per kernel
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_pass_kernel<NPAY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(SET * elem_bytes));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  ConstPlanes src = in;
  int top = __builtin_ctzll((unsigned long long)block) - 1;  // log2 of the next stage d
  while (top >= SET_SHIFT) {
    const int stages = top - SET_SHIFT + 1 < MAX_STRIDED ? top - SET_SHIFT + 1 : MAX_STRIDED;
    const int low_shift = top - stages + 1;
    merge_pass_kernel<NPAY><<<(unsigned)(n / SET), MERGE_THREADS, SET * elem_bytes, s>>>(
        src, out, SET, SET_SHIFT - stages, low_shift, stages, SET / 2, SET >> stages, vec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    for (int q = 0; q <= NPAY; ++q) src.p[q] = out.p[q];
    top = low_shift - 1;
  }
  const long long low_bit = n & -n;
  const int tile = low_bit < SET ? (int)low_bit : SET;
  const int t_shift = __builtin_ctz((unsigned)tile);
  merge_pass_kernel<NPAY><<<(unsigned)(n / tile), MERGE_THREADS, tile * elem_bytes, s>>>(
      src, out, tile, t_shift, t_shift, 0, (block < tile ? (int)block : tile) / 2, 1, vec);
  return cudaGetLastError();
}

// Calls f(std::integral_constant<int, NPAY>{}) for a payload count n_pay in
// [0, MAX_PAYLOADS]: the kernels are templated on it.
template <typename F>
cudaError_t with_payloads(int n_pay, F&& f) {
  switch (n_pay) {
    case 0: return f(std::integral_constant<int, 0>{});
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    default: return f(std::integral_constant<int, 8>{});
  }
}

// The planes as the kernels take them, and whether every one of them is
// 16-byte aligned (the kernels' 16-byte accesses).
bool collect(void* const* in_planes, void* const* out_planes, int n_planes, ConstPlanes& in,
             Planes& out) {
  bool vec = true;
  for (int q = 0; q < n_planes; ++q) {
    in.p[q] = static_cast<const uint32_t*>(in_planes[q]);
    out.p[q] = static_cast<uint32_t*>(out_planes[q]);
    vec = vec && (reinterpret_cast<uintptr_t>(in_planes[q]) & 15) == 0 &&
          (reinterpret_cast<uintptr_t>(out_planes[q]) & 15) == 0;
  }
  return vec;
}

}  // namespace

// The TPU sort's tile stage (its XLA leaf sort plus bitonic_cascade_rounds
// up to its leaf): every merge round whose segment fits one tile of
// min(npow, TILE) elements, from in_planes (length n) into out_planes
// (length npow, a power of two >= max(n, MIN_LEN)), both host arrays of
// n_planes device pointers, planes[0] the key. Each tile of out_planes comes
// out sorted, ascending at even tile indices and descending at odd ones
// (ascending when one tile covers npow), the payloads following their keys,
// unstable; rows >= n read as 0xFFFFFFFF. Launches on `stream` and does not
// synchronise. Returns 0 or the first CUDA error.
extern "C" int dpu_sort_tiles_u32(void* const* in_planes, void* const* out_planes,
                                  int n_planes, long long n, long long npow, void* stream) {
  if (n_planes < 1 || n_planes > 1 + MAX_PAYLOADS || npow < MIN_LEN ||
      (npow & (npow - 1)) != 0 || n < 1 || n > npow)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ConstPlanes in{};
  Planes out{};
  const bool vec = collect(in_planes, out_planes, n_planes, in, out);
  const int tile = npow < TILE ? (int)npow : TILE;
  return (int)with_payloads(n_planes - 1, [&](auto np) {
    tile_sort_kernel<decltype(np)::value><<<(unsigned)(npow / tile), SORT_THREADS, 0, s>>>(
        in, out, n, tile, vec);
    return cudaGetLastError();
  });
}

// Runs the ascending half-cleaner cascade d = block/2 .. 1 on each block of
// the planes (planes[0] the key, planes[1:] following it), from in_planes
// into out_planes (host arrays of n_planes device pointers, length n). block
// is a power of two >= MIN_LEN and divides n; each block of the input must
// be bitonic for the output blocks to come out sorted. in and out may be the
// same planes. Launches on `stream` and does not synchronise. Returns 0 or
// the first CUDA error.
extern "C" int dpu_merge_blocks_u32(void* const* in_planes, void* const* out_planes,
                                    int n_planes, long long n, long long block,
                                    void* stream) {
  if (n_planes < 1 || n_planes > 1 + MAX_PAYLOADS || block < MIN_LEN ||
      (block & (block - 1)) != 0 || n < block || n % block != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ConstPlanes in{};
  Planes out{};
  const bool vec = collect(in_planes, out_planes, n_planes, in, out);
  return (int)with_payloads(n_planes - 1, [&](auto np) {
    return run_merge<decltype(np)::value>(in, out, n, block, vec, s);
  });
}

extern "C" const char* dpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
