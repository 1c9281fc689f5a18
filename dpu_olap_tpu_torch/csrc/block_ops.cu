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
// Design (the first, simple one): one thread block per TPU block, the value
// block in dynamic shared memory (rows padded to 129 words, so that the
// transpose's column walk hits 32 banks), each thread's elements of idx in
// registers (a (256, 128) block of x and idx together would be 256 KiB,
// more than an SM's shared memory). An op that moves values across threads
// reads into registers, meets a barrier, then writes back. Every op but
// cprep needs only idx & 255, so those idx live four to a register; cprep
// keeps idx whole. count_matmul builds the 0/1 planes in bf16 in shared
// memory and runs a^T . b on the tensor cores (csrc/onehot_mma.cuh): exact,
// as every operand is 0/1 and every sum at most 128. Shared memory: 129 KiB
// at R = 256, 193 KiB for count_matmul (the planes and the f32 product).
//
// What bounds it on the H100: one call moves 12 bytes an element (x and idx
// read, out written), or 8 for the three ops that do not read idx: 25.2 or
// 16.8 MB at 2Mi elements, 7.5 or 5.0 us at 3.35 TB/s; count_matmul also
// does 2 * 128^3 flops a rep and a tile, 8.6 GFLOP a call at reps 16 and
// 128 tiles, 8.7 us at 989 TFLOP/s in bf16. The kernel is bound by neither:
// one block a TPU block gives 64 (R = 256) or 128 (R = 128) blocks on 132
// SMs, each running `reps` ops in one SM's shared memory, two barriers an op.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "onehot_mma.cuh"

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

// bytes of dynamic shared memory: the value block, then count_matmul's two
// bf16 planes and f32 product, or cprep's partial column counts (a multiple
// of 32 bytes each, so the wmma pointers stay aligned)
constexpr size_t smem_bytes(int op, int rows) {
  return (size_t)rows * PITCH * 4 +
         (op == COUNT_MATMUL ? 2 * (size_t)LANES * LANES * 2 + (size_t)LANES * LANES * 4 : 0) +
         (op == CPREP ? (size_t)STRIDE * LANES * 4 : 0);
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
  extern __shared__ __align__(32) unsigned char smem[];
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
    } else if constexpr (OP == COUNT_MATMUL) {
      __nv_bfloat16* pa = reinterpret_cast<__nv_bfloat16*>(extra);  // a[k][m], row-major
      __nv_bfloat16* pb = pa + LANES * LANES;                       // b[k][n], row-major
      float* dg = reinterpret_cast<float*>(pb + LANES * LANES);     // a^T . b, row-major
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int r = r0 + STRIDE * j;
        const uint32_t v = s[r * PITCH + c];
        const uint32_t ib = idx_byte<WHOLE>(iv, j);
        pa[r * LANES + c] = onehot::bit((v & 127u) <= ((ib + tu) & 127u));
        pb[r * LANES + c] = onehot::bit(((int32_t)v >> 7) == (int32_t)(ib & 127u));
      }
      __syncthreads();
      constexpr int TILES = LANES / 16;
      for (int tile = threadIdx.x / 32; tile < TILES * TILES; tile += THREADS / 32) {
        onehot::at_b_tile(pa, LANES, pb, LANES, LANES, (tile / TILES) * 16, (tile % TILES) * 16,
                          dg, LANES);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int r = r0 + STRIDE * j;
        s[r * PITCH + c] ^= (uint32_t)(int)dg[r * LANES + c];
      }
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

}  // namespace

// Runs `reps` chained ops of code `op` (the enum above) on each of the nblk
// (R, 128) blocks of the int32 planes x and idx into out (all device
// pointers, nblk * R * 128 elements each; R = 256 for op codes 0-4, 128 for
// 5-8). Launches on `stream`, does not synchronise; returns 0 or the first
// CUDA error.
extern "C" int dpu_block_op_i32(const void* x, const void* idx, void* out, long long nblk,
                                int op, long long reps, void* stream) {
  if (nblk < 0 || nblk > INT_MAX || reps < 0 || reps > INT_MAX || op < 0 || op >= N_OPS)
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
    case COUNT_MATMUL: return (int)launch<COUNT_MATMUL>(xs, is, os, nblk, r, s);
    default: return (int)launch<CPREP>(xs, is, os, nblk, r, s);
  }
}
