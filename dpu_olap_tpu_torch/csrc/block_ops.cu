// Chained in-block primitive ops on (R, 128) int32 blocks: the Hopper
// counterpart of the TPU primitive probes scripts/measure_filter.py
// _op_kernel (:439, measure_ops :459: lane_roll :444, row_roll :446, where
// :448, lane_gather :450, sublane_gather :452 on (256, 128) blocks) and
// _c_op_kernel (:237, measure_cops :264: transpose :242, sq_gather :244,
// count_matmul :246, cprep :254 on (128, 128) tiles).
//
// Contract: for each block b of x and idx (rows b*R .. b*R + R - 1 of the
// (nblk*R, 128) planes, R = 256 for the measure_ops ops and 128 for the
// measure_cops ops, the scripts' block shapes), `reps` ops are applied in
// turn to the block's values v, t = 0 .. reps-1, and the result is written
// to out. In int32 arithmetic that wraps modulo 2^32, as JAX's does:
//   lane_roll       v[r][c] <- v[r][(c - s) mod 128], s = 1 + (t & 3)
//                   (jnp.roll / pltpu.roll by s along the lanes)
//   row_roll        v[r][c] <- v[(r - s) mod 256][c]
//   where           v <- (idx & (1 << (t & 4))) != 0 ? v : v + 1
//   lane_gather,    v[r][c] <- v[r][(idx[r][c] + t) & 127]
//   sq_gather
//   sublane_gather  v[r][c] <- v[(idx[r][c] + t) mod 256][c]
//   transpose       v <- v^T + t
//   count_matmul    a[k][m] = (v[k][m] & 127) <= ((idx[k][m] + t) & 127),
//                   b[k][n] = (v[k][n] >> 7) == (idx[k][n] & 127),
//                   v <- v ^ (a^T . b)
//   cprep           s0[c] = #{r : (v[r][c] >> 7) < idx[r][c]},
//                   v <- clip(v + s0[c] + t, 0, 2^30)
// (>> is arithmetic, as on int32 in JAX and torch.) lane_roll, row_roll and
// transpose never read idx, and their kernels do not load it. Every kernel
// reads x and idx with 16-byte loads and writes out with 16-byte stores, so
// all three must start 16-byte aligned.
//
// The TPU block is each op's meaning (which rows roll and gather together,
// over which rows cprep counts), not the CUDA block: each op runs on the
// skeleton its data dependence allows, with a grid over every SM. Each rep
// is one op applied to the data; nothing folds reps together.
//   elementwise (where, where_kernel): a thread keeps 8 values and their
//     idx bits in registers for all reps; no shared memory, no barrier.
//     256 threads, nblk * 16 blocks.
//   row (lane_roll, lane_gather, sq_gather; row_kernel): a warp owns 2
//     rows, lane l holding columns 4l .. 4l + 3 of each (one 16-byte load).
//     The roll by s <= 4 stays in registers: s shuffles from lane l - 1 and
//     moves (the rep loop unrolled by 4, so s is a constant). A gather goes
//     through a warp-private, double-buffered copy of its rows in shared
//     memory (a 16-byte store a lane, __syncwarp, four loads). 256 threads,
//     nblk * R / 16 blocks; no __syncthreads after the loads.
//   column (row_roll, roll_rows_kernel; cprep, cprep_kernel): a block owns
//     a strip of R rows x 32 columns, staged through shared memory so that
//     the loads and stores are 16 bytes. row_roll: lane = column, warp w
//     holding rows 32w .. 32w + 31 in registers; a roll by s moves them up
//     in registers and takes the first s from the previous warp's last s
//     rows, which every warp writes to shared memory before the rep's one
//     barrier (the rep loop unrolled by 4). cprep: a warp owns 4 whole
//     columns, lane l holding rows l + 32k of each, so a column's count is
//     one __reduce_add_sync of the lanes' counts: no barrier in the rep
//     loop; the strips sit at pitch 33, on 32 banks for the row-wise
//     staging and the column reads. 256 threads, nblk * 4 blocks.
//   strip (sublane_gather; strip_kernel): a block owns 256 rows x 32
//     columns in shared memory, row-major, double-buffered; lane = column,
//     so that a gather down a column hits 32 banks whatever the rows. A
//     thread keeps the idx & 255 of its 32 rows in registers; a rep reads
//     the gathered values from one buffer, writes the other and meets one
//     barrier. 256 threads, nblk * 4 blocks.
//   tile (transpose; tile_kernel): every rep needs the whole tile, so a
//     block keeps one 128 x 128 tile, double-buffered in shared memory with
//     rows of 132 words. A rep reads four column entries of the source (32
//     lanes on 32 consecutive words) and writes them, + t, as one 16-byte
//     store into a row of the other buffer (8 lanes of a phase on 8 rows,
//     4 banks apart at pitch 132): one barrier a rep. 1024 threads, nblk
//     blocks.
//   tensor_core (count_matmul): below.
//
// What bounds them on the H100: the HBM bytes of one call, 12 an element (x
// and idx read, out written) or 8 for the three ops that do not read idx:
// 25.2 or 16.8 MB at 2Mi elements, 7.5 or 5.0 us at 3.35 TB/s. On the chip,
// a rep of a gather or of the transpose moves every value through shared
// memory once in and once out: 2 x 8 MiB a rep at 2Mi elements, at 128 B a
// clock an SM, about 30 TB/s across 132 SMs, so about 0.55 us a rep and 9
// us for 16 reps, above the bytes: that floor binds lane_gather, sq_gather,
// sublane_gather and transpose. lane_gather and sq_gather read random
// columns of one row, up to 4 words of a row to a bank, so their reads
// take about 3 wavefronts each where a conflict-free read takes 1: about
// twice that floor. lane_roll moves only the boundary values, by shuffles
// (2.5 a row of 128 a rep on average: 655K warp shuffles a call at 16
// reps, about 2.5 us at one a clock an SM); row_roll moves s edge rows a
// warp through shared memory (1/32 of the strip on average) and meets a
// barrier a rep; where adds one value a rep to each element; cprep
// compares, counts, adds and clamps, a few integer operations an element a
// rep, and sums 32 counts a column with one __reduce_add_sync. The bytes
// bind those four. count_matmul: below.
//
// count_matmul (count_matmul_kernel): the product on the tensor cores, with
// the tile and the product in registers. A warp owns STRIPS 16-row strips
// of the 128 x 128 product and COLS of its columns; its lanes hold v and
// idx & 127 (four bytes a register) in the accumulator layout of
// mma.sync m16n8k16 (bf16 in, f32 accumulate), so that after each rep
// v ^= acc happens where the accumulators land (they start at 2^23, so the
// low 8 bits of a sum's f32 are the sum). Only the two 0/1
// planes go through shared memory: each lane writes the a-bit and the b-bit
// of its own elements as bf16 pairs, into rows of 256 bytes swizzled at 16
// bytes (chunk ^ row & 7), from which ldmatrix.x4.trans reads both
// operands, a^T and b, free of bank conflicts. The planes are
// double-buffered (128 KiB), so a rep meets one barrier. Exact: the
// operands are 0/1 and every sum is at most 128.
//   The layout (csrc/filter4.cu uses the same trick): lane 4g + t
// of a warp holds, for each 16-column group P and each 16-row strip S, the
// four consecutive values v[R][16P + 4t .. 4t + 3] of two rows R, so that
// x and idx are read once with 16-byte loads and out written once with
// 16-byte stores. Accumulator (row 16S + 8h + g, column 16P + 8j + 2t + e)
// holds element (16S + 4(g >> 1) + 2h + (g & 1), 16P + 4t + 2j + e): one
// permutation of 0..127 applied to the rows and the columns alike. Since
// the a-plane's columns index the product's rows, and the contraction runs
// over the planes' rows in any order, a^T . b under that permutation is the
// permuted product, and each lane writes its plane bits at its own
// accumulator positions.
//
// What bounds count_matmul on the H100: its 12 bytes an element, and 2 *
// 128^3 flops a rep and a tile, 8.6 GFLOP a call at reps 16 and 128 tiles,
// 8.7 us at 989 TFLOP/s in bf16 (a rate that only wgmma reaches), one
// block a tile; count_matmul_kernel runs 1024 m16n8k16 products a rep on
// mma.sync (wgmma's rate is out of its reach) and reads 24 KiB of operands
// a warp, 192 KiB a block, from shared memory.

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>
#ifndef BLOCK_OPS_WITHOUT_COUNT_MATMUL
#include "mma_bf16.cuh"  // count_matmul's products
#endif

namespace {

constexpr int LANES = 128;
constexpr unsigned FULL = 0xFFFFFFFFu;

// op codes, in the order of ops/block_ops_cuda.py OPS + COPS
enum : int {
  LANE_ROLL = 0,
  ROW_ROLL,
  WHERE,
  LANE_GATHER,
  SUBLANE_GATHER,
  TRANSPOSE,
  SQ_GATHER,
  COUNT_MATMUL,
  CPREP,
  N_OPS
};

// the block's rows: 256 for the measure_ops ops, 128 for the measure_cops ops
__host__ __device__ constexpr int rows_of(int op) { return op < TRANSPOSE ? 256 : LANES; }

__host__ __device__ constexpr bool reads_idx(int op) {
  return op != LANE_ROLL && op != ROW_ROLL && op != TRANSPOSE;
}

__device__ __forceinline__ uint4 load4(const int32_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void store4(int32_t* p, const uint32_t (&v)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void unpack4(uint32_t (&v)[4], uint4 a) {
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}

// ---- elementwise: where ----------------------------------------------------

namespace ew {
constexpr int THREADS = 256;
constexpr int PER = 8;  // values a thread: two 16-byte loads of x and of idx
constexpr int BLOCKS_PER = 256 * LANES / (THREADS * PER);  // blocks a (256, 128) block: 16
}  // namespace ew

__global__ void __launch_bounds__(ew::THREADS)
where_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ idx,
             int32_t* __restrict__ out, int reps) {
  using namespace ew;
  const size_t e = ((size_t)blockIdx.x * THREADS + threadIdx.x) * PER;
  uint32_t v[PER], lo[PER], hi[PER];  // lo, hi: 1 where idx's bit 0, bit 4 is clear
#pragma unroll
  for (int h = 0; h < PER / 4; ++h) {
    uint32_t a[4], b[4];
    unpack4(a, load4(x + e + 4 * h));
    unpack4(b, load4(idx + e + 4 * h));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[4 * h + k] = a[k];
      lo[4 * h + k] = ~b[k] & 1u;
      hi[4 * h + k] = ~b[k] >> 4 & 1u;
    }
  }
  // one rep an iteration: v <- v + 1 where idx's bit (t & 4) is clear
#pragma unroll 1
  for (int t = 0; t < reps; ++t) {
    if (t & 4) {
#pragma unroll
      for (int k = 0; k < PER; ++k) v[k] += hi[k];
    } else {
#pragma unroll
      for (int k = 0; k < PER; ++k) v[k] += lo[k];
    }
  }
#pragma unroll
  for (int h = 0; h < PER / 4; ++h) {
    const uint32_t o[4] = {v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]};
    store4(out + e + 4 * h, o);
  }
}

// ---- row-local: lane_roll, lane_gather, sq_gather ---------------------------

namespace rw {
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int RPW = 2;                         // rows a warp
constexpr int ROWS = WARPS * RPW;              // rows a block: 16
constexpr int WARP_WORDS = 2 * RPW * LANES;    // a warp's two buffers of its rows
constexpr int SMEM = WARPS * WARP_WORDS * 4;   // bytes a block, for a gather: 16 KiB
}  // namespace rw

// the lane-roll by S (1 .. 4) of rows held four columns a lane: new column
// 4l + k is old column 4l + k - S, from lane l - 1 (src) where k < S
template <int S, int N>
__device__ __forceinline__ void roll_lanes(uint32_t (&v)[N][4], int src) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    uint32_t p[4];
#pragma unroll
    for (int j = 4 - S; j < 4; ++j) p[j] = __shfl_sync(FULL, v[r][j], src);
#pragma unroll
    for (int k = 3; k >= S; --k) v[r][k] = v[r][k - S];
#pragma unroll
    for (int k = 0; k < S; ++k) v[r][k] = p[k - S + 4];
  }
}

template <int OP>
__global__ void __launch_bounds__(rw::THREADS)
row_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ idx,
           int32_t* __restrict__ out, int reps) {
  using namespace rw;
  constexpr bool GATHER = OP != LANE_ROLL;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row0 = ((size_t)blockIdx.x * WARPS + warp) * RPW;
  uint32_t v[RPW][4];
  uint32_t ib[RPW];  // idx & 127 of the lane's four values, a byte each
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const size_t e = (row0 + r) * LANES + 4 * lane;
    unpack4(v[r], load4(x + e));
    if constexpr (GATHER) {
      const uint4 b = load4(idx + e);
      ib[r] = ((b.x & 127u) | (b.y & 127u) << 8 | (b.z & 127u) << 16 | (b.w & 127u) << 24);
    }
  }
  if constexpr (!GATHER) {
    // s = 1 + (t & 3) cycles 1, 2, 3, 4 from t = 0: four reps an iteration
    const int src = (lane + 31) & 31;
    int t = 0;
#pragma unroll 1
    for (; t + 4 <= reps; t += 4) {
      roll_lanes<1>(v, src);
      roll_lanes<2>(v, src);
      roll_lanes<3>(v, src);
      roll_lanes<4>(v, src);
    }
    if (t < reps) roll_lanes<1>(v, src);
    if (t + 1 < reps) roll_lanes<2>(v, src);
    if (t + 2 < reps) roll_lanes<3>(v, src);
  } else {
    uint32_t* buf = reinterpret_cast<uint32_t*>(smem) + warp * WARP_WORDS;
#pragma unroll 1
    for (int t = 0; t < reps; ++t) {
      // the other buffer was last read a rep ago, before that rep's
      // __syncwarp: one __syncwarp a rep
      uint32_t* b = buf + (t & 1) * RPW * LANES;
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        *reinterpret_cast<uint4*>(b + r * LANES + 4 * lane) =
            make_uint4(v[r][0], v[r][1], v[r][2], v[r][3]);
      }
      __syncwarp();
      // (idx + t) & 127 four at once: bytes below 128 add without carries
      const uint32_t tt = (uint32_t)(t & 127) * 0x01010101u;
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const uint32_t src = (ib[r] + tt) & 0x7F7F7F7Fu;
#pragma unroll
        for (int k = 0; k < 4; ++k) v[r][k] = b[r * LANES + (src >> (8 * k) & 127u)];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r) store4(out + (row0 + r) * LANES + 4 * lane, v[r]);
}

// ---- column-local: row_roll, cprep -------------------------------------------

// A block owns a strip of R rows x 32 columns of one TPU block, staged
// through shared memory so that x, idx and out move as 16-byte loads and
// stores of whole 128-byte row pieces.
namespace col {
constexpr int W = 32;                  // columns a strip (128 bytes of a row)
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int STRIPS = LANES / W;      // blocks a TPU block: 4
constexpr int EDGE = 4;                // the most rows a roll moves between warps
constexpr int PITCH = W + 1;           // cprep's strip rows, in words
constexpr int CPW = W / WARPS;         // cprep: columns a warp
// row_roll: the strip (row-major), then its edge rows, double-buffered;
// cprep: the strips of x and idx at pitch 33
constexpr int ROLL_SMEM = (256 * W + 2 * WARPS * EDGE * W) * 4;
constexpr int CPREP_SMEM = 2 * LANES * PITCH * 4;
}  // namespace col

// row_roll (roll_rows_kernel): lane = column, and warp w holds rows 32w ..
// 32w + 31 of it in registers. A roll by S moves each thread's rows up by S
// in its registers; the first S come from the previous warp's last S rows
// (mod 256), which every warp writes to shared memory before the rep's one
// barrier. Shared-memory words of a warp's access are one a lane: 32 banks.
__global__ void __launch_bounds__(col::THREADS)
roll_rows_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ /* idx: not read */,
                 int32_t* __restrict__ out, int reps) {
  using namespace col;
  constexpr int R = 256;
  constexpr int PER = R / WARPS;               // rows a thread: 32
  constexpr int LOADS = R * W / 4 / THREADS;   // 16-byte loads a thread: 8
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s = reinterpret_cast<uint32_t*>(smem);   // [R][W]
  uint32_t* edge = s + R * W;                         // [2][WARPS][EDGE][W]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t base = (size_t)(blockIdx.x / STRIPS) * R * LANES + blockIdx.x % STRIPS * W;

  // load u = tid + THREADS * j is row u >> 3, columns 4 (u & 7) .. + 3
  uint4 a[LOADS];
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int u = threadIdx.x + THREADS * j;
    a[j] = load4(x + base + (size_t)(u >> 3) * LANES + 4 * (u & 7));
  }
#pragma unroll
  for (int j = 0; j < LOADS; ++j)
    *reinterpret_cast<uint4*>(s + 4 * (threadIdx.x + THREADS * j)) = a[j];
  __syncthreads();
  uint32_t v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) v[i] = s[(PER * warp + i) * W + lane];

  const int prev = (warp + WARPS - 1) % WARPS;
  auto roll = [&](auto shift, int t) {
    constexpr int S = decltype(shift)::value;
    uint32_t* e = edge + (t & 1) * WARPS * EDGE * W;  // last read two reps ago
#pragma unroll
    for (int k = 0; k < S; ++k) e[(warp * EDGE + k) * W + lane] = v[PER - S + k];
    __syncthreads();
#pragma unroll
    for (int i = PER - 1; i >= S; --i) v[i] = v[i - S];
#pragma unroll
    for (int k = 0; k < S; ++k) v[k] = e[(prev * EDGE + k) * W + lane];
  };
  // s = 1 + (t & 3) cycles 1, 2, 3, 4 from t = 0: four reps an iteration
  int t = 0;
#pragma unroll 1
  for (; t + 4 <= reps; t += 4) {
    roll(std::integral_constant<int, 1>{}, t);
    roll(std::integral_constant<int, 2>{}, t + 1);
    roll(std::integral_constant<int, 3>{}, t + 2);
    roll(std::integral_constant<int, 4>{}, t + 3);
  }
  if (t < reps) roll(std::integral_constant<int, 1>{}, t);
  if (t + 1 < reps) roll(std::integral_constant<int, 2>{}, t + 1);
  if (t + 2 < reps) roll(std::integral_constant<int, 3>{}, t + 2);

  // back through the strip: each thread rewrites only its own rows, which no
  // other thread read after the first barrier
#pragma unroll
  for (int i = 0; i < PER; ++i) s[(PER * warp + i) * W + lane] = v[i];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int u = threadIdx.x + THREADS * j;
    const uint4 w = *reinterpret_cast<const uint4*>(s + 4 * u);
    *reinterpret_cast<uint4*>(out + base + (size_t)(u >> 3) * LANES + 4 * (u & 7)) = w;
  }
}

// cprep (cprep_kernel): a warp owns CPW whole columns of the 128-row strip,
// lane l holding rows l, l + 32, l + 64, l + 96 of each, so that a column's
// count is the lane's four compares summed over the warp by one
// __reduce_add_sync: no barrier in the rep loop. The strips of x and idx
// sit at pitch 33, which puts a warp's row-wise staging stores (4 rows x 8
// lanes, 4 columns each) and its column reads (32 rows of one column) on
// 32 banks.
__global__ void __launch_bounds__(col::THREADS)
cprep_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ idx,
             int32_t* __restrict__ out, int reps) {
  using namespace col;
  constexpr int R = LANES;
  constexpr int LOADS = R * W / 4 / THREADS;   // 16-byte loads a thread a plane: 4
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* sx = reinterpret_cast<uint32_t*>(smem);   // [R][PITCH]
  uint32_t* si = sx + R * PITCH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t base = (size_t)(blockIdx.x / STRIPS) * R * LANES + blockIdx.x % STRIPS * W;

  uint4 a[LOADS], b[LOADS];
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int u = threadIdx.x + THREADS * j;
    const size_t e = base + (size_t)(u >> 3) * LANES + 4 * (u & 7);
    a[j] = load4(x + e);
    b[j] = load4(idx + e);
  }
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int u = threadIdx.x + THREADS * j, wd = (u >> 3) * PITCH + 4 * (u & 7);
    uint32_t w[4];
    unpack4(w, a[j]);
#pragma unroll
    for (int k = 0; k < 4; ++k) sx[wd + k] = w[k];
    unpack4(w, b[j]);
#pragma unroll
    for (int k = 0; k < 4; ++k) si[wd + k] = w[k];
  }
  __syncthreads();
  uint32_t v[CPW][4];
  int32_t iv[CPW][4];
#pragma unroll
  for (int c = 0; c < CPW; ++c)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int wd = (lane + 32 * k) * PITCH + CPW * warp + c;
      v[c][k] = sx[wd];
      iv[c][k] = (int32_t)si[wd];
    }

#pragma unroll 1
  for (int t = 0; t < reps; ++t) {
#pragma unroll
    for (int c = 0; c < CPW; ++c) {
      uint32_t cnt = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) cnt += ((int32_t)v[c][k] >> 7) < iv[c][k];
      const uint32_t add = __reduce_add_sync(FULL, cnt) + (uint32_t)t;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[c][k] = (uint32_t)min(max((int32_t)(v[c][k] + add), 0), 1 << 30);
    }
  }

  // back through the strip: each warp rewrites only its own columns
#pragma unroll
  for (int c = 0; c < CPW; ++c)
#pragma unroll
    for (int k = 0; k < 4; ++k) sx[(lane + 32 * k) * PITCH + CPW * warp + c] = v[c][k];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int u = threadIdx.x + THREADS * j, wd = (u >> 3) * PITCH + 4 * (u & 7);
    const uint32_t w[4] = {sx[wd], sx[wd + 1], sx[wd + 2], sx[wd + 3]};
    store4(out + base + (size_t)(u >> 3) * LANES + 4 * (u & 7), w);
  }
}

// ---- column-local in shared memory: sublane_gather --------------------------

namespace strip {
constexpr int W = 32;                        // columns a strip
constexpr int R = 256;                       // rows: sublane_gather's block
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int PER = R / WARPS;               // rows a thread: warp + WARPS * j
constexpr int STRIPS = LANES / W;            // blocks a TPU block: 4
constexpr int WORDS = R * W;                 // one buffer
constexpr int SMEM = 2 * WORDS * 4;          // 64 KiB
constexpr int LOADS = WORDS / 4 / THREADS;   // 16-byte loads a thread a plane: 8
}  // namespace strip

__global__ void __launch_bounds__(strip::THREADS)
strip_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ idx,
             int32_t* __restrict__ out, int reps) {
  using namespace strip;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s = reinterpret_cast<uint32_t*>(smem);  // [2][R][W], row-major
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t base = (size_t)(blockIdx.x / STRIPS) * R * LANES + blockIdx.x % STRIPS * W;

  // x into buffer 0 and idx into buffer 1: load u = tid + THREADS * j is row
  // u >> 3, columns 4 (u & 7) .. + 3
  uint4 a[LOADS], b[LOADS];
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int u = threadIdx.x + THREADS * j;
    const size_t e = base + (size_t)(u >> 3) * LANES + 4 * (u & 7);
    a[j] = load4(x + e);
    b[j] = load4(idx + e);
  }
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int u = threadIdx.x + THREADS * j;
    *reinterpret_cast<uint4*>(s + 4 * u) = a[j];
    *reinterpret_cast<uint4*>(s + WORDS + 4 * u) = b[j];
  }
  __syncthreads();
  uint32_t ib[PER / 4];  // idx & 255 of the thread's rows, a byte each
#pragma unroll
  for (int j = 0; j < PER / 4; ++j) ib[j] = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j)
    ib[j >> 2] |= (s[WORDS + (warp + WARPS * j) * W + lane] & 255u) << (8 * (j & 3));
  __syncthreads();  // rep 0 writes buffer 1

#pragma unroll 1
  for (int t = 0; t < reps; ++t) {
    const uint32_t* from = s + (t & 1) * WORDS;
    uint32_t* to = s + ((t + 1) & 1) * WORDS;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const uint32_t r = ((ib[j >> 2] >> (8 * (j & 3)) & 255u) + (uint32_t)t) & 255u;
      to[(warp + WARPS * j) * W + lane] = from[r * W + lane];
    }
    __syncthreads();  // one barrier a rep: the next rep reads `to`, writes `from`
  }

  const uint32_t* res = s + (reps & 1) * WORDS;
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int u = threadIdx.x + THREADS * j;
    const uint4 w = *reinterpret_cast<const uint4*>(res + 4 * u);
    *reinterpret_cast<uint4*>(out + base + (size_t)(u >> 3) * LANES + 4 * (u & 7)) = w;
  }
}

// ---- whole tile: transpose --------------------------------------------------

namespace tile {
constexpr int THREADS = 1024;
constexpr int PITCH = LANES + 4;              // words a row: 16-byte rows 4 banks apart
constexpr int WORDS = LANES * PITCH;          // one buffer
constexpr int SMEM = 2 * WORDS * 4;           // 132 KiB
constexpr int LOADS = LANES * LANES / 4 / THREADS;  // 16-byte loads a thread: 4
}  // namespace tile

__global__ void __launch_bounds__(tile::THREADS, 1)
tile_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ /* idx: not read */,
            int32_t* __restrict__ out, int reps) {
  using namespace tile;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s = reinterpret_cast<uint32_t*>(smem);  // [2][128][PITCH]
  const size_t base = (size_t)blockIdx.x * LANES * LANES;

  // load u = tid + THREADS * j is row u >> 5, columns 4 (u & 31) .. + 3
  uint4 a[LOADS];
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int u = threadIdx.x + THREADS * j;
    a[j] = load4(x + base + (size_t)(u >> 5) * LANES + 4 * (u & 31));
  }
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int u = threadIdx.x + THREADS * j;
    *reinterpret_cast<uint4*>(s + (u >> 5) * PITCH + 4 * (u & 31)) = a[j];
  }
  __syncthreads();

  // a rep: to[r][c .. c + 3] = from[c .. c + 3][r] + t, lanes on 32
  // consecutive r, c = 4 (tid >> 7) + 32 j
  const int r = threadIdx.x & (LANES - 1);
  const int c0 = 4 * (threadIdx.x >> 7);
#pragma unroll 1
  for (int t = 0; t < reps; ++t) {
    const uint32_t* from = s + (t & 1) * WORDS;
    uint32_t* to = s + ((t + 1) & 1) * WORDS;
    const uint32_t tu = (uint32_t)t;
#pragma unroll
    for (int j = 0; j < LANES / 32; ++j) {
      const int c = c0 + 32 * j;
      *reinterpret_cast<uint4*>(to + r * PITCH + c) =
          make_uint4(from[c * PITCH + r] + tu, from[(c + 1) * PITCH + r] + tu,
                     from[(c + 2) * PITCH + r] + tu, from[(c + 3) * PITCH + r] + tu);
    }
    __syncthreads();  // one barrier a rep: the next rep reads `to`, writes `from`
  }

  const uint32_t* res = s + (reps & 1) * WORDS;
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int u = threadIdx.x + THREADS * j;
    const uint4 w = *reinterpret_cast<const uint4*>(res + (u >> 5) * PITCH + 4 * (u & 31));
    *reinterpret_cast<uint4*>(out + base + (size_t)(u >> 5) * LANES + 4 * (u & 31)) = w;
  }
}

// count_matmul_kernel: one (128, 128) tile a block (see the note at the top).
// A host build of the other kernels (tests/block_ops_emu.h) defines
// BLOCK_OPS_WITHOUT_COUNT_MATMUL, which leaves it out.
#ifndef BLOCK_OPS_WITHOUT_COUNT_MATMUL
namespace cm {

// 8 warps of 32 rows x 64 columns, 255 registers and none spilled, beat 8
// warps of 16 x 128 (254 registers) and 16 warps of 16 x 64 (128, 68 B
// spilled) by 11-14% (PERF.md §6)
constexpr int STRIPS = 2;                    // 16-row strips of the product a warp
constexpr int COLS = 64;                     // columns of the product a warp
constexpr int GROUPS = COLS / 16;            // 16-column groups a warp
constexpr int WARPS_N = LANES / COLS;        // warps across the columns
constexpr int WARPS = LANES / 16 / STRIPS * WARPS_N;
constexpr int THREADS = 32 * WARPS;
constexpr int PLANE = LANES * LANES * 2;     // bytes of one bf16 0/1 plane
constexpr int SMEM = 4 * PLANE;              // a and b, double-buffered: 128 KiB
constexpr uint32_t ONES = 0x3F803F80u;       // 1.0 in both bf16 halves
// the accumulators start at 2^23: a sum s <= 128 then lands as the f32 2^23
// + s, whose low 8 bits are s, exact, with no conversion
constexpr uint32_t MAGIC = 0x4B000000u;

using tc::ldmatrix_x4_trans;  // csrc/mma_bf16.cuh
using tc::mma16816;

// byte n of d is byte sel[n] of the eight bytes of a (0-3) and b (4-7), or,
// where bit 3 of selector nibble n is set, that byte's sign bit repeated
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// the low bytes of four words, byte e from word e
__device__ __forceinline__ uint32_t low_bytes(const uint32_t (&w)[4]) {
  return prmt(prmt(w[0], w[1], 0x0040), prmt(w[2], w[3], 0x0040), 0x5410);
}

// byte offset of 16-byte chunk `chunk` of plane row `row`, swizzled
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)(row * (LANES * 2) + ((chunk ^ (row & 7)) << 4));
}

}  // namespace cm

__global__ void __launch_bounds__(cm::THREADS, 1)
count_matmul_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ idx,
                    int32_t* __restrict__ out, int reps) {
  using namespace cm;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int s0 = warp / WARPS_N * STRIPS;  // the warp's first strip
  const int p0 = warp % WARPS_N * GROUPS;  // and its first 16-column group
  const size_t base = (size_t)blockIdx.x * LANES * LANES;

  // v[s][h][q]: row 16(s0 + s) + 4(g >> 1) + 2h + (g & 1), columns
  // 16(p0 + q) + 4t .. + 3; ib: the same elements' idx & 127, a byte each
  uint32_t v[STRIPS][2][GROUPS][4];
  uint32_t ib[STRIPS][2][GROUPS];
#pragma unroll
  for (int s = 0; s < STRIPS; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < GROUPS; ++q) {
        const size_t e = base + (size_t)(16 * (s0 + s) + 4 * (g >> 1) + 2 * h + (g & 1)) * LANES +
                         16 * (p0 + q) + 4 * t4;
        const uint4 xv = *reinterpret_cast<const uint4*>(x + e);
        const uint4 iv = *reinterpret_cast<const uint4*>(idx + e);
        v[s][h][q][0] = xv.x, v[s][h][q][1] = xv.y, v[s][h][q][2] = xv.z, v[s][h][q][3] = xv.w;
        ib[s][h][q] = low_bytes({iv.x, iv.y, iv.z, iv.w}) & 0x7F7F7F7Fu;
      }

  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  // ldmatrix row addresses, less the k-step's 16 rows and the buffer: lane
  // 8q + i reads row i (+ 8) of 16-byte chunk c (+ 1), and row & 7 == i
  const int q8 = lane >> 3, i8 = lane & 7;
  uint32_t a_off[STRIPS], b_off[GROUPS];
#pragma unroll
  for (int s = 0; s < STRIPS; ++s) a_off[s] = swz(i8 + 8 * (q8 >> 1), 2 * (s0 + s) + (q8 & 1));
#pragma unroll
  for (int q = 0; q < GROUPS; ++q)
    b_off[q] = PLANE + swz(i8 + 8 * (q8 & 1), 2 * (p0 + q) + (q8 >> 1));
  const float magic = __uint_as_float(MAGIC);
  const float c0[4] = {magic, magic, magic, magic};

  for (int t = 0; t < reps; ++t) {
    const uint32_t buf = (uint32_t)(t & 1) * 2 * PLANE;
    const uint32_t tt = (uint32_t)(t & 127) * 0x01010101u;
    // the planes: the a-bit and the b-bit of each of the lane's elements, at
    // its accumulator positions, two bf16 a word
#pragma unroll
    for (int s = 0; s < STRIPS; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < GROUPS; ++q) {
          const uint32_t(&w)[4] = v[s][h][q];
          const uint32_t ibq = ib[s][h][q];
          // a, four at once: byte e of le is 128 + ((idx + t) & 127) - (v & 127),
          // in [1, 255], so its sign bit is the a-bit of element e
          const uint32_t le =
              (((ibq + tt) & 0x7F7F7F7Fu) | 0x80808080u) - (low_bytes(w) & 0x7F7F7F7Fu);
          // b: v >> 7 == idx & 127, that is v - ((idx & 127) << 7) in [0, 128)
          uint32_t bb[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t ib7 = (e == 0 ? ibq << 7 : ibq >> (8 * e - 7)) & 0x3F80u;
            bb[e] = w[e] - ib7 < 128u;
          }
          const int row = 16 * (s0 + s) + 8 * h + g;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint32_t off = buf + swz(row, 2 * (p0 + q) + j) + 4 * t4;
            *reinterpret_cast<uint32_t*>(smem + off) = prmt(le, 0, j ? 0xBBAA : 0x9988) & ONES;
            *reinterpret_cast<uint32_t*>(smem + PLANE + off) =
                (bb[2 * j] | bb[2 * j + 1] << 16) * 0x3F80u;
          }
        }
    __syncthreads();  // the one barrier a rep: the next rep writes the other buffer

    float acc[STRIPS][2 * GROUPS][4];
#pragma unroll
    for (int kk = 0; kk < LANES / 16; ++kk) {
      const uint32_t kb = sbase + buf + (uint32_t)kk * 16 * (LANES * 2);
      uint32_t a[STRIPS][4];
#pragma unroll
      for (int s = 0; s < STRIPS; ++s) ldmatrix_x4_trans(a[s], kb + a_off[s]);
#pragma unroll
      for (int q = 0; q < GROUPS; ++q) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, kb + b_off[q]);
#pragma unroll
        for (int s = 0; s < STRIPS; ++s) {
          if (kk == 0) {  // the first k-step starts from 2^23
            mma16816(acc[s][2 * q], a[s], b[0], b[1], c0);
            mma16816(acc[s][2 * q + 1], a[s], b[2], b[3], c0);
          } else {
            mma16816(acc[s][2 * q], a[s], b[0], b[1], acc[s][2 * q]);
            mma16816(acc[s][2 * q + 1], a[s], b[2], b[3], acc[s][2 * q + 1]);
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < STRIPS; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < GROUPS; ++q)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              v[s][h][q][2 * j + e] ^= __float_as_uint(acc[s][2 * q + j][2 * h + e]) & 0xFFu;
  }

#pragma unroll
  for (int s = 0; s < STRIPS; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < GROUPS; ++q) {
        const size_t e = base + (size_t)(16 * (s0 + s) + 4 * (g >> 1) + 2 * h + (g & 1)) * LANES +
                         16 * (p0 + q) + 4 * t4;
        *reinterpret_cast<uint4*>(out + e) =
            make_uint4(v[s][h][q][0], v[s][h][q][1], v[s][h][q][2], v[s][h][q][3]);
      }
}

cudaError_t launch_count_matmul(const int32_t* x, const int32_t* idx, int32_t* out,
                                long long nblk, int reps, cudaStream_t s) {
  static bool opted_in = false;  // as in opt_in
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        count_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cm::SMEM);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  count_matmul_kernel<<<(unsigned)nblk, cm::THREADS, cm::SMEM, s>>>(x, idx, out, reps);
  return cudaGetLastError();
}
#endif  // BLOCK_OPS_WITHOUT_COUNT_MATMUL


// ---- plans and launches -----------------------------------------------------

// how op, any but count_matmul, runs on nblk TPU blocks (ops/block_ops_cuda.py
// block_op_plan describes it)
struct Plan {
  long long grid;
  int threads;
  int smem;  // bytes of dynamic shared memory a block
};

Plan plan_of(int op, long long nblk) {
  const long long rows = nblk * rows_of(op);
  switch (op) {
    case WHERE: return {nblk * ew::BLOCKS_PER, ew::THREADS, 0};
    case LANE_ROLL: return {rows / rw::ROWS, rw::THREADS, 0};
    case LANE_GATHER:
    case SQ_GATHER: return {rows / rw::ROWS, rw::THREADS, rw::SMEM};
    case ROW_ROLL: return {nblk * col::STRIPS, col::THREADS, col::ROLL_SMEM};
    case SUBLANE_GATHER: return {nblk * strip::STRIPS, strip::THREADS, strip::SMEM};
    case TRANSPOSE: return {nblk, tile::THREADS, tile::SMEM};
    default: return {nblk * col::STRIPS, col::THREADS, col::CPREP_SMEM};  // CPREP
  }
}

// once a kernel, before its first launch (which comes before any CUDA-graph
// capture): above 48 KB of dynamic shared memory a kernel needs the opt-in;
// and a kernel with shared memory asks for the largest shared-memory
// carveout, or the driver may leave the SM room for fewer blocks than its
// threads allow (a second wave)
template <auto KERNEL>
cudaError_t opt_in(int bytes) {
  static bool done = false;
  if (!done && bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  if (!done && bytes > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        KERNEL, cudaFuncAttributePreferredSharedMemoryCarveout, (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  done = true;
  return cudaSuccess;
}

template <auto KERNEL>
cudaError_t launch(const Plan& p, cudaStream_t s, const int32_t* x, const int32_t* idx,
                   int32_t* out, int reps) {
  const cudaError_t err = opt_in<KERNEL>(p.smem);
  if (err != cudaSuccess) return err;
  KERNEL<<<(unsigned)p.grid, p.threads, p.smem, s>>>(x, idx, out, reps);
  return cudaGetLastError();
}

}  // namespace

// Runs `reps` chained ops of code `op` (the enum above) on each of the nblk
// (R, 128) blocks of the int32 planes x and idx into out (all device
// pointers, nblk * R * 128 elements each, R = 256 for op codes 0-4, 128 for
// 5-8; x and out, and idx for an op that reads it, 16-byte aligned).
// Launches on `stream`, does not synchronise; returns 0 or the first CUDA
// error.
extern "C" int dpu_block_op_i32(const void* x, const void* idx, void* out, long long nblk,
                                int op, long long reps, void* stream) {
  if (nblk < 0 || nblk > INT_MAX || reps < 0 || reps > INT_MAX || op < 0 || op >= N_OPS)
    return (int)cudaErrorInvalidValue;
  const uintptr_t planes = (uintptr_t)x | (uintptr_t)out | (reads_idx(op) ? (uintptr_t)idx : 0);
  if (planes % 16) return (int)cudaErrorInvalidValue;
  const int32_t* xs = static_cast<const int32_t*>(x);
  const int32_t* is = static_cast<const int32_t*>(idx);
  int32_t* os = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r = (int)reps;
  if (op == COUNT_MATMUL) {
#ifdef BLOCK_OPS_WITHOUT_COUNT_MATMUL
    return (int)cudaErrorNotSupported;
#else
    return nblk ? (int)launch_count_matmul(xs, is, os, nblk, r, s) : 0;
#endif
  }
  const Plan p = plan_of(op, nblk);
  if (p.grid > INT_MAX) return (int)cudaErrorInvalidValue;
  if (nblk == 0) return 0;
  switch (op) {
    case LANE_ROLL: return (int)launch<row_kernel<LANE_ROLL>>(p, s, xs, is, os, r);
    case ROW_ROLL: return (int)launch<roll_rows_kernel>(p, s, xs, is, os, r);
    case WHERE: return (int)launch<where_kernel>(p, s, xs, is, os, r);
    case LANE_GATHER: return (int)launch<row_kernel<LANE_GATHER>>(p, s, xs, is, os, r);
    case SUBLANE_GATHER: return (int)launch<strip_kernel>(p, s, xs, is, os, r);
    case TRANSPOSE: return (int)launch<tile_kernel>(p, s, xs, is, os, r);
    case SQ_GATHER: return (int)launch<row_kernel<SQ_GATHER>>(p, s, xs, is, os, r);
    default: return (int)launch<cprep_kernel>(p, s, xs, is, os, r);
  }
}
