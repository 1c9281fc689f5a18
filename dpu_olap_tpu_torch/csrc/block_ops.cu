// Chained in-block primitive ops on (R, 128) int32 blocks: the Hopper
// counterpart of the TPU primitive probes scripts/measure_filter.py
// _op_kernel (measure_ops: lane_roll, row_roll, where, lane_gather,
// sublane_gather on (256, 128) blocks) and _c_op_kernel (measure_cops:
// transpose, sq_gather, count_matmul, cprep on (128, 128) tiles).
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
// transpose never read idx, and their kernels do not load it.
//
// Every op but count_matmul (block_op_kernel): one thread block per TPU
// block, the value block in dynamic shared memory (rows padded to 129
// words, so that the transpose's column walk hits 32 banks), each thread's
// elements of idx in registers (a (256, 128) block of x and idx together
// would be 256 KiB, more than an SM's shared memory). An op that moves
// values across threads reads into registers, meets a barrier, then writes
// back. Every op but cprep needs only idx & 255, so those idx live four to
// a register; cprep keeps idx whole. Shared memory: 129 KiB at R = 256,
// 64.5 KiB at R = 128 (66.5 for cprep).
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
// What bounds it on the H100: one call moves 12 bytes an element (x and idx
// read, out written), or 8 for the three ops that do not read idx: 25.2 or
// 16.8 MB at 2Mi elements, 7.5 or 5.0 us at 3.35 TB/s; count_matmul also
// does 2 * 128^3 flops a rep and a tile, 8.6 GFLOP a call at reps 16 and
// 128 tiles, 8.7 us at 989 TFLOP/s in bf16 (a rate that only wgmma
// reaches). One block a TPU block gives 64 (R = 256) or 128 (R = 128)
// blocks on 132 SMs; block_op_kernel runs `reps` ops in one SM's shared
// memory, two barriers an op; count_matmul_kernel runs 1024 m16n8k16
// products a rep on mma.sync (wgmma's rate is out of its reach) and reads
// 24 KiB of operands a warp, 192 KiB a block, from shared memory.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 128;
constexpr int THREADS = 512;
constexpr int STRIDE = THREADS / LANES;  // rows between one thread's elements
constexpr int PITCH = LANES + 1;         // shared-memory row pitch, in words

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

// bytes of dynamic shared memory: the value block, then cprep's partial
// column counts
constexpr size_t smem_bytes(int op, int rows) {
  return (size_t)rows * PITCH * 4 + (op == CPREP ? (size_t)STRIDE * LANES * 4 : 0);
}

// idx & 255 of a thread's element j, from its registers: whole words, or
// four bytes a word (j is a constant once the loops unroll)
template <bool WHOLE, int N>
__device__ __forceinline__ uint32_t idx_byte(const uint32_t (&iv)[N], int j) {
  if constexpr (WHOLE) {
    return iv[j] & 255u;
  } else {
    return (iv[j >> 2] >> (8 * (j & 3))) & 255u;
  }
}

template <int OP>
__global__ void __launch_bounds__(THREADS)
block_op_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ idx,
                int32_t* __restrict__ out, int reps) {
  constexpr int R = rows_of(OP);
  static_assert(R % STRIDE == 0 && (R & (R - 1)) == 0, "R: a power of two");
  constexpr int PER = R * LANES / THREADS;  // elements a thread
  constexpr bool WHOLE = OP == CPREP;       // cprep compares with the whole idx
  constexpr int NI = WHOLE ? PER : PER / 4;
  static_assert(OP != COUNT_MATMUL, "count_matmul has its own kernel");
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s = reinterpret_cast<uint32_t*>(smem);
  unsigned char* extra = smem + (size_t)R * PITCH * 4;

  const int c = threadIdx.x % LANES;
  const int r0 = threadIdx.x / LANES;  // a thread's rows: r0 + STRIDE * j
  const size_t base = (size_t)blockIdx.x * R * LANES;
  uint32_t iv[NI];
#pragma unroll
  for (int j = 0; j < NI; ++j) iv[j] = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int r = r0 + STRIDE * j;
    const size_t e = base + (size_t)r * LANES + c;
    s[r * PITCH + c] = (uint32_t)x[e];
    if constexpr (reads_idx(OP)) {
      const uint32_t id = (uint32_t)idx[e];
      if constexpr (WHOLE) {
        iv[j] = id;
      } else {
        iv[j >> 2] |= (id & 255u) << (8 * (j & 3));
      }
    }
  }
  __syncthreads();

  for (int t = 0; t < reps; ++t) {
    const uint32_t tu = (uint32_t)t;
    if constexpr (OP == WHERE) {  // elementwise: each thread its own elements
      const uint32_t m = 1u << (t & 4);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        if (!(idx_byte<WHOLE>(iv, j) & m)) s[(r0 + STRIDE * j) * PITCH + c] += 1u;
      }
    } else if constexpr (OP == CPREP) {
      int* part = reinterpret_cast<int*>(extra);  // [STRIDE][LANES]
      int cnt = 0;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        cnt += ((int32_t)s[(r0 + STRIDE * j) * PITCH + c] >> 7) < (int32_t)iv[j];
      }
      part[r0 * LANES + c] = cnt;
      __syncthreads();
      uint32_t s0 = 0;
#pragma unroll
      for (int q = 0; q < STRIDE; ++q) s0 += (uint32_t)part[q * LANES + c];
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        uint32_t& v = s[(r0 + STRIDE * j) * PITCH + c];
        const int32_t w = (int32_t)(v + s0 + tu);
        v = (uint32_t)min(max(w, 0), 1 << 30);
      }
      __syncthreads();
    } else {  // the ops that move values across threads
      uint32_t nv[PER];
      const int sh = 1 + (t & 3);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int r = r0 + STRIDE * j;
        if constexpr (OP == LANE_ROLL) {
          nv[j] = s[r * PITCH + ((c - sh) & (LANES - 1))];
        } else if constexpr (OP == ROW_ROLL) {
          nv[j] = s[((r - sh) & (R - 1)) * PITCH + c];
        } else if constexpr (OP == LANE_GATHER || OP == SQ_GATHER) {
          nv[j] = s[r * PITCH + ((idx_byte<WHOLE>(iv, j) + tu) & (LANES - 1))];
        } else if constexpr (OP == SUBLANE_GATHER) {
          nv[j] = s[((idx_byte<WHOLE>(iv, j) + tu) & (R - 1)) * PITCH + c];
        } else {  // TRANSPOSE
          nv[j] = s[c * PITCH + r] + tu;
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < PER; ++j) s[(r0 + STRIDE * j) * PITCH + c] = nv[j];
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int r = r0 + STRIDE * j;
    out[base + (size_t)r * LANES + c] = (int32_t)s[r * PITCH + c];
  }
}

template <int OP>
cudaError_t launch(const int32_t* x, const int32_t* idx, int32_t* out, long long nblk, int reps,
                   cudaStream_t s) {
  constexpr size_t bytes = smem_bytes(OP, rows_of(OP));
  // above 48 KB of dynamic shared memory needs the opt-in, once per kernel;
  // the first call comes before any CUDA-graph capture
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        block_op_kernel<OP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  block_op_kernel<OP><<<(unsigned)nblk, THREADS, bytes, s>>>(x, idx, out, reps);
  return cudaGetLastError();
}

// count_matmul_kernel: one (128, 128) tile a block (see the note at the top)
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

// d = a x b + c, one m16n8k16 product on the tensor cores: bf16 operands,
// f32 accumulators, in the PTX ISA's fragment layouts (lane = 4g + t):
//   a (16 x 16): a[0] row g, columns 2t, 2t + 1 (low, high half); a[1] row
//     g + 8, the same columns; a[2] row g, columns 2t + 8, 2t + 9; a[3] row
//     g + 8, those columns;
//   b (16 x 8): b0 rows 2t, 2t + 1 of column g; b1 rows 2t + 8, 2t + 9;
//   c, d (16 x 8): [0], [1] row g, columns 2t, 2t + 1; [2], [3] row g + 8.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1, const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
      " {%8, %9}, {%10, %11, %12, %13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]),
        "f"(c[2]), "f"(c[3]));
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lanes 8q .. 8q +
// 7 give the row addresses (16 bytes each) of matrix q, and lane 4g + t
// receives in r[q] that matrix's elements (2t, g) and (2t + 1, g).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

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
  static bool opted_in = false;  // as in launch<OP>
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        count_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cm::SMEM);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  count_matmul_kernel<<<(unsigned)nblk, cm::THREADS, cm::SMEM, s>>>(x, idx, out, reps);
  return cudaGetLastError();
}

}  // namespace

// Runs `reps` chained ops of code `op` (the enum above) on each of the nblk
// (R, 128) blocks of the int32 planes x and idx into out (all device
// pointers, nblk * R * 128 elements each; R = 256 for op codes 0-4, 128 for
// 5-8; for count_matmul, code 7, all three 16-byte aligned). Launches on
// `stream`, does not synchronise; returns 0 or the first CUDA error.
extern "C" int dpu_block_op_i32(const void* x, const void* idx, void* out, long long nblk,
                                int op, long long reps, void* stream) {
  if (nblk < 0 || nblk > INT_MAX || reps < 0 || reps > INT_MAX || op < 0 || op >= N_OPS)
    return (int)cudaErrorInvalidValue;
  if (op == COUNT_MATMUL && ((uintptr_t)x | (uintptr_t)idx | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  if (nblk == 0) return 0;
  const int32_t* xs = static_cast<const int32_t*>(x);
  const int32_t* is = static_cast<const int32_t*>(idx);
  int32_t* os = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r = (int)reps;
  switch (op) {
    case LANE_ROLL: return (int)launch<LANE_ROLL>(xs, is, os, nblk, r, s);
    case ROW_ROLL: return (int)launch<ROW_ROLL>(xs, is, os, nblk, r, s);
    case WHERE: return (int)launch<WHERE>(xs, is, os, nblk, r, s);
    case LANE_GATHER: return (int)launch<LANE_GATHER>(xs, is, os, nblk, r, s);
    case SUBLANE_GATHER: return (int)launch<SUBLANE_GATHER>(xs, is, os, nblk, r, s);
    case TRANSPOSE: return (int)launch<TRANSPOSE>(xs, is, os, nblk, r, s);
    case SQ_GATHER: return (int)launch<SQ_GATHER>(xs, is, os, nblk, r, s);
    case COUNT_MATMUL: return (int)launch_count_matmul(xs, is, os, nblk, r, s);
    default: return (int)launch<CPREP>(xs, is, os, nblk, r, s);
  }
}
