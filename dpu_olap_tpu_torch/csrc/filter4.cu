// Stable filter compaction, v4: the scan and the inverse map on the tensor
// cores. The Hopper counterpart of dpu_olap_tpu/ops/filter_pallas4.py
// (_call, _filter4_kernel; filter_compact_pallas4, filter_pallas4_padded,
// filter_with_indices_pallas4).
//
// Contract (the same function as csrc/filter.cu): out[:count] holds the
// values v < thr in input order and out[count:] holds `fill`; with indices,
// sel[:count] holds their row numbers and sel[count:] holds n; count is one
// device uint32. Any n below 2^32.
//
// The TPU kernel gets the in-row prefix and each output slot's source row
// from counting matrix products on 0/1 bf16 operands, exact in f32, and
// then gathers. Here the same counts come from mma.sync m16n8k16 products
// (f16 0/1 or small-count operands, f32 accumulate) on fragments of 256
// values, seen as a 16x16 mask M (row r = values 16r .. 16r + 15 of the
// fragment):
//   P = M x U, U[k][c] = [k <= c]: the in-row inclusive prefix;
//   E = Lstrict x B, Lstrict[r][k] = [k < r], B[k][c] = P[k][15] (row k's
//     count): every column of row r holds g_r, the row's exclusive start
//     in the fragment's run;
//   stage A: each row's kept values go to the front of the row, at rank
//     P - 1 (a store within the row, the TPU's stage A);
//   S = [OH | GT] x [LE ; 1] (K = 32, two products into one accumulator),
//     with g_r = 16 q_r + s_r, OH[a][r] = [q_r == a], GT[a][r] = [q_r < a],
//     LE[r][b] = [s_r <= b]: S[a][b] = #{r : g_r <= 16a + b}, so the source
//     row of output slot t = 16a + b is sr = S - 1 (the TPU's sr(p)), and
//     the value is row sr's front-compacted entry t - g_sr.
// Exactness: the operands are 0/1 except B, whose entries are row counts
// <= 16; fp16 holds every integer up to 2048. The products' partial sums
// over one k-fragment are at most 16 (P, S) and 16 * 15 = 240 (E), all far
// below 2^24, so f32 accumulation is exact and every count is an integer.
//
// The operands are built in registers, in the fragment layouts of the PTX
// ISA (mma16816 below), and the accumulators are read where they land. A
// lane's 16-byte load of four consecutive values is its share of M: lane
// 4g + t of a fragment's first load holds row g, positions 4t .. 4t + 3,
// and of its second row g + 8; M's columns are the positions in the order
// 0, 1, 4, 5, ..., 12, 13, 2, 3, 6, 7, ..., 14, 15 (column 2t + i is
// position 4t + i, column 2t + 8 + i position 4t + 2 + i), and U follows
// that order, so P lands on the lane that holds each value. Lstrict, U,
// [LE ; 1] and the counting operands are functions of the lane's
// coordinates and of four row counts or row starts, which two shuffles
// bring. No fragment passes through shared memory but the front-compacted
// rows.
//
// On csrc/filter.cu's one-sweep skeleton (csrc/lookback.cuh):
//   sweep_kernel, a tile of TILE values a block, taken by an atomic ticket:
//     each warp owns WARP_FRAGS consecutive fragments; a lane issues all of
//     its loads (16 bytes each where the tile is whole and the input
//     aligned) before the first is ranked;
//     the fragments' counts come from ballots, and the tile publishes its
//     count as soon as they are summed, before any product;
//     per fragment the three products, stage A into the warp's row buffer,
//     and the gather of the fragment's run into the tile's run in shared
//     memory, at the fragment's offset in the tile (the TPU's VMEM output
//     rows);
//     one warp takes the tile's offset from the look-back (look_back_warp);
//     the run goes out whole with 16-byte stores (store_run, the TPU's
//     chunked output DMA); the last tile writes the count;
//   tail_kernel writes `fill` (and n) over [count, n).
// Work memory (ops/filter_cuda.py filter_plan): one 64-bit status word a
// tile and the ticket, cleared by one cudaMemsetAsync: a call is one
// memset and two launches (launch_filter), with no host decision, so it
// replays from a CUDA graph.
//
// What bounds it on the H100: device-memory traffic, 8n bytes (12n with
// indices): the input is read once and each output lane written once, by
// the sweep or by the tail; the products are 7 mma.sync a fragment (64
// multiply-adds a value), far below the tensor cores' rate.

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 4096;                   // ops/filter_alt_cuda.py TILE
constexpr int FRAG = 256;                    // values of one 16 x 16 fragment
constexpr int WARP_FRAGS = TILE / FRAG / WARPS;  // fragments a warp owns
constexpr int LOADS = 2 * WARP_FRAGS;        // 16-byte loads a lane makes, two a fragment
constexpr int SLICE = WARP_FRAGS * FRAG;     // values a warp owns
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint32_t ONE = 0x3C00u;            // 1.0 in fp16
constexpr uint32_t ONES = ONE | ONE << 16;   // an f16x2 register of two ones
constexpr int BLOCKS_PER_SM = 4;             // the sweep's launch bounds, see sweep_kernel

// An f16x2 operand register of two 0/1 entries, lo in the low half.
__device__ __forceinline__ uint32_t bits2(bool lo, bool hi) {
  return (lo ? ONE : 0u) | (hi ? ONE << 16 : 0u);
}

// An f16x2 operand register of two counts below 2048, lo in the low half.
__device__ __forceinline__ uint32_t counts2(unsigned lo, unsigned hi) {
  return __half_as_ushort(__uint2half_rn(lo)) |
         (uint32_t)__half_as_ushort(__uint2half_rn(hi)) << 16;
}

// d = a x b + c, one m16n8k16 product on the tensor cores: f16 operands,
// f32 accumulators, in the PTX ISA's fragment layouts (lane = 4g + t):
//   a (16 x 16): a[0] row g, columns 2t, 2t + 1 (low, high half); a[1] row
//     g + 8, the same columns; a[2] row g, columns 2t + 8, 2t + 9; a[3] row
//     g + 8, those columns;
//   b (16 x 8): b0 rows 2t, 2t + 1 of column g; b1 rows 2t + 8, 2t + 9;
//   c, d (16 x 8): [0], [1] row g, columns 2t, 2t + 1; [2], [3] row g + 8.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1, const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
      " {%8, %9}, {%10, %11, %12, %13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]),
        "f"(c[2]), "f"(c[3]));
}

// One tile (see the note at the top). Lane l = 4g + t of warp w loads the
// values w * SLICE + 128 j + 4 l + (0..3) of the tile, j < LOADS;
// fragment h of the warp is loads 2h (its rows 0-7) and 2h + 1 (rows
// 8-15). status: ntiles words and the ticket, zero at the start. Four
// blocks an SM (64 registers; 36 B spilled, 44 B with indices) were the
// fastest at 64Mi, measured beside three (80 registers, none spilled),
// five (48, 108-132 B) and, compact, six (40, 204 B; PERF.md §6).
template <bool IDX>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
sweep_kernel(const uint32_t* __restrict__ x, long long n, uint32_t thr, bool vec,
             long long ntiles, uint32_t* __restrict__ out, uint32_t* __restrict__ sel,
             uint32_t* __restrict__ count, unsigned* ticket, unsigned long long* status) {
  __shared__ __align__(16) uint32_t s_v[TILE];  // the tile's run
  __shared__ __align__(16) uint32_t s_i[IDX ? TILE : 1];
  __shared__ uint32_t s_cv[WARPS][FRAG];  // a fragment's rows, each front-compacted
  __shared__ uint16_t s_ci[WARPS][IDX ? FRAG : 1];  // and their positions in the tile
  __shared__ unsigned s_fc[WARPS * WARP_FRAGS];  // the fragments' counts
  __shared__ unsigned s_tile, s_before;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const long long base = tile * TILE;
  const bool whole = vec && base + TILE <= n;
  const int wbase = warp * SLICE;
  const long long first = base + wbase + 4 * lane;

  uint4 w[LOADS];  // every load started before any is used
#pragma unroll
  for (int j = 0; j < LOADS; ++j) w[j] = load4(x, first + 128 * j, n, whole);
  unsigned keep = 0;  // bit 4j + e: value e of load j
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const long long i = first + 128 * j;
    const uint32_t v[4] = {w[j].x, w[j].y, w[j].z, w[j].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) keep |= v[e] < thr && i + e < n ? 1u << (4 * j + e) : 0u;
  }
  // each fragment's count: the lane's count (0-8) in four ballots, a bit each
#pragma unroll
  for (int h = 0; h < WARP_FRAGS; ++h) {
    const unsigned c = __popc((keep >> (8 * h)) & 0xFFu);
    unsigned frag = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) frag += (unsigned)__popc(__ballot_sync(FULL, (c >> b) & 1u)) << b;
    if (lane == 0) s_fc[warp * WARP_FRAGS + h] = frag;
  }
  __syncthreads();
  unsigned total = 0, foff[WARP_FRAGS] = {};  // the tile's count, the warp's fragments' offsets
#pragma unroll
  for (int f = 0; f < WARPS * WARP_FRAGS; ++f) {
    const unsigned c = s_fc[f];
#pragma unroll
    for (int h = 0; h < WARP_FRAGS; ++h) foff[h] += f < warp * WARP_FRAGS + h ? c : 0u;
    total += c;
  }
  unsigned long long* word = status + tile;
  if (threadIdx.x == 0) publish(word, tile == 0 ? FLAG_PREFIX : FLAG_AGG, total);

  // the constant operands: U in M's column order, where column c is
  // position 4 ((c & 7) >> 1) + 2 (c >> 3) + (c & 1), and Lstrict
  uint32_t u[2][2];  // [n-half][b0, b1]
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int pos = 4 * (g >> 1) + 2 * hh + (g & 1);  // of column g + 8 hh
    u[hh][0] = bits2(4 * t <= pos, 4 * t + 1 <= pos);
    u[hh][1] = bits2(4 * t + 2 <= pos, 4 * t + 3 <= pos);
  }
  const uint32_t below = bits2(2 * t < g, 2 * t + 1 < g);
  const uint32_t lstrict[4] = {below, ONES, 0u, below};
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  uint32_t* cv = s_cv[warp];
  uint16_t* ci = s_ci[warp];

#pragma unroll
  for (int h = 0; h < WARP_FRAGS; ++h) {
    const unsigned k = (keep >> (8 * h)) & 0xFFu;  // bits e: load 2h; bits 4 + e: load 2h + 1
    // P = M x U: p[hh][i + 2j] is the prefix of value 2hh + i of load 2h + j
    const uint32_t m[4] = {bits2(k & 1u, k & 2u), bits2(k & 16u, k & 32u),
                           bits2(k & 4u, k & 8u), bits2(k & 64u, k & 128u)};
    float p[2][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) mma16816(p[hh], m, u[hh][0], u[hh][1], zero);
    // E = Lstrict x B: the row counts (column 15: p[1][1], p[1][3] of the
    // lanes t = 3) of rows 2t, 2t + 1, 2t + 8, 2t + 9
    const unsigned rc = (unsigned)p[1][1] | (unsigned)p[1][3] << 16;
    const unsigned c0 = __shfl_sync(FULL, rc, 8 * t + 3);  // rows 2t, 2t + 8
    const unsigned c1 = __shfl_sync(FULL, rc, 8 * t + 7);  // rows 2t + 1, 2t + 9
    float e[4];
    mma16816(e, lstrict, counts2(c0 & 0xFFFFu, c1 & 0xFFFFu), counts2(c0 >> 16, c1 >> 16), zero);
    const unsigned starts = (unsigned)e[0] | (unsigned)e[2] << 16;  // g_g, g_{g+8}

    // stage A: each row's kept values to the front of its 16 slots
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint4 wv = w[2 * h + j];
      const uint32_t v[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if ((k >> (4 * j + q)) & 1u) {
          const int slot = 16 * (g + 8 * j) + (int)p[q >> 1][2 * j + (q & 1)] - 1;
          cv[slot] = v[q];
          if constexpr (IDX) ci[slot] = (uint16_t)(wbase + FRAG * h + 128 * j + 4 * lane + q);
        }
      }
    }
    __syncwarp();

    // S = [OH | GT] x [LE ; 1], from the starts of rows 2t, 2t + 1, 2t + 8, 2t + 9
    const unsigned s0 = __shfl_sync(FULL, starts, 8 * t);      // rows 2t, 2t + 8
    const unsigned s1 = __shfl_sync(FULL, starts, 8 * t + 4);  // rows 2t + 1, 2t + 9
    const unsigned ra = s0 & 0xFFFFu, rb = s1 & 0xFFFFu, rc8 = s0 >> 16, rd = s1 >> 16;
    const unsigned qa = ra >> 4, qb = rb >> 4, qc = rc8 >> 4, qd = rd >> 4;
    const uint32_t oh[4] = {bits2(qa == (unsigned)g, qb == (unsigned)g),
                            bits2(qa == (unsigned)g + 8, qb == (unsigned)g + 8),
                            bits2(qc == (unsigned)g, qd == (unsigned)g),
                            bits2(qc == (unsigned)g + 8, qd == (unsigned)g + 8)};
    const uint32_t gt[4] = {bits2(qa < (unsigned)g, qb < (unsigned)g),
                            bits2(qa < (unsigned)g + 8, qb < (unsigned)g + 8),
                            bits2(qc < (unsigned)g, qd < (unsigned)g),
                            bits2(qc < (unsigned)g + 8, qd < (unsigned)g + 8)};
    float sm[2][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const unsigned b = g + 8 * hh;
      mma16816(sm[hh], oh, bits2((ra & 15u) <= b, (rb & 15u) <= b),
               bits2((rc8 & 15u) <= b, (rd & 15u) <= b), zero);
      mma16816(sm[hh], gt, ONES, ONES, sm[hh]);
    }

    // the gather: slot u = 16a + b takes row sr's entry u - g_sr, into the
    // tile's run at the fragment's offset
    const unsigned run = s_fc[warp * WARP_FRAGS + h];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned slot = 16 * (g + 8 * (i >> 1)) + 2 * t + 8 * hh + (i & 1);
        const int sr = (int)sm[hh][i] - 1;
        const unsigned gs = __shfl_sync(FULL, starts, 4 * (sr & 7));
        const unsigned start = sr < 8 ? gs & 0xFFFFu : gs >> 16;
        if (slot < run) {
          const unsigned from = 16 * sr + slot - start;
          s_v[foff[h] + slot] = cv[from];
          if constexpr (IDX) s_i[foff[h] + slot] = (uint32_t)base + ci[from];
        }
      }
    }
    __syncwarp();
  }

  if (warp == 0) {
    unsigned before = 0;  // kept values in the earlier tiles
    if (tile > 0) {
      before = look_back_warp(status, tile);
      if (lane == 0) publish(word, FLAG_PREFIX, before + total);
    }
    if (lane == 0) {
      s_before = before;
      if (tile == ntiles - 1) *count = before + total;
    }
  }
  __syncthreads();
  const unsigned before = s_before;
  store_run<THREADS>(out, before, s_v, total);
  if constexpr (IDX) store_run<THREADS>(sel, before, s_i, total);
}

}  // namespace

// Compact the n uint32 values at x that are < thr into out (tail = fill)
// and, when sel is not null, their row numbers into sel (tail = n); write
// the count to *count. work holds ops/filter_cuda.py filter_plan's words:
// one uint64 a tile of 4096 and the ticket, which the function clears on
// the stream. out and sel must be 16-byte aligned. All pointers are device
// pointers; n must be below 2^32. Launches on `stream`, does not
// synchronise; returns 0 or the first CUDA error.
extern "C" int dpu_filter4_u32(const void* x, long long n, unsigned thr, unsigned fill,
                               void* out, void* sel, void* work, void* count, void* stream) {
  return launch_filter<THREADS>(sweep_kernel<false>, sweep_kernel<true>, TILE, x, n, thr, fill,
                                out, sel, work, count, stream);
}
