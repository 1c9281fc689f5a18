// Bitonic network kernels over a uint32 key plane with up to MAX_PAYLOADS
// uint32 payload planes following it: the two entry points that are bitonic
// by contract. The whole sort (dpu_sort_u32) is the radix sort of
// csrc/radix_sort.cu.
//
//   tile_sort_kernel    <- the TPU merge-tree sort's XLA leaf row sort and
//                          bitonic_cascade_rounds (_cascade_rounds_kernel,
//                          dpu_olap_tpu/ops/sort_pallas.py): every merge
//                          round whose segment fits one tile, in shared
//                          memory.
//   global_steps_kernel <- up to three compare-exchange stages at distances
//                          d >= TILE (as sort_pallas.py's _xblock_kernel).
//   tile_merge_kernel   <- the stages d < TILE that finish a merge round
//                          (as sort_pallas.py's _cascade_kernel).
//
// tile_sort_kernel alone makes dpu_sort_tiles_u32, the TPU sort's tile
// stage: every round that fits on chip, the counterpart of
// scripts/measure_filter.py measure_sort's `upto_inblock` (the leaf sort
// plus bitonic_cascade_rounds up to one VMEM block of 128Ki on the TPU; one
// shared-memory tile of 4096 here). The host pads the length to a power of
// two npow >= max(n, MIN_LEN); rows >= n read as key and payload
// 0xFFFFFFFF. Each tile comes out sorted, ascending or descending by the
// parity of its index, unstable.
//
// The two network kernels, with every direction ascending, make
// dpu_merge_blocks_u32, the counterpart of
// dpu_olap_tpu/ops/bitonic_pallas.py:bitonic_merge_blocks
// (_merge_block_kernel): the in-block half-cleaner cascade d = block/2 .. 1
// on each block of a sequence whose blocks are bitonic. The TPU kernel keeps
// one 64Ki block in VMEM and runs all 16 stages there with sublane and lane
// rolls; a Hopper block holds 4096 elements in shared memory, so the stages
// d >= TILE run three to a pass as global_steps_kernel and the rest as one
// tile_merge_kernel pass (from d = min(block, TILE) / 2). A compare-exchange
// swaps only when the lower slot's key is greater, so each slot keeps its own
// pair on a tie, as the TPU kernel's selects do (bitonic_pallas.py:71-72).
// At 8Mi elements and a 64Ki block: one copy, two global passes and one
// tile pass over (1 + payloads) planes.
//
// What bounds them on the H100: device-memory passes. The stages at
// d >= TILE run three to a pass, each thread holding the 8 elements (and
// their payloads) that those stages exchange in registers. Inside a tile
// the same trick runs three shared-memory stages per barrier, and the
// stages d < 32 run in registers with warp shuffles. Tiles sort the key
// with a 16-bit position and permute each payload plane once, so shared
// memory stays at 40 KB whatever the payload count. Kernels are templated
// on the payload count so that the payload pointers stay in registers.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 4096;  // elements per shared-memory tile (power of two)
constexpr int E = 4;        // tile elements per thread (in registers)
constexpr int MIN_LEN = 128;  // smallest padded length: one full warp a tile
constexpr int STEP_THREADS = 256;
constexpr int MAX_PAYLOADS = 8;
constexpr int MAX_FUSED = 3;  // global stages per pass: 2^3 elements a thread

struct Payloads {
  uint32_t* p[MAX_PAYLOADS];
};

struct ConstPayloads {
  const uint32_t* p[MAX_PAYLOADS];
};

// Compare-exchange of a register element with the one held by the lane at
// distance d (< 32) in the same warp: the lower lane of the pair keeps the
// minimum when asc, the maximum otherwise; its position travels with it.
__device__ __forceinline__ void warp_exchange(uint32_t& key, uint16_t& pos,
                                              int d, bool asc) {
  const uint32_t other = __shfl_xor_sync(0xFFFFFFFFu, key, d);
  const uint16_t opos = (uint16_t)__shfl_xor_sync(0xFFFFFFFFu, (unsigned)pos, d);
  const bool lower = (threadIdx.x & d) == 0;
  if (lower == asc ? other < key : other > key) {
    key = other;
    pos = opos;
  }
}

// Stages d = d0 .. 1 (d0 < 32) of merge round k on the E register elements
// of each thread; element r sits at tile index threadIdx.x + r * blockDim.x,
// so a warp holds 32 consecutive elements and the stages need no barrier.
__device__ __forceinline__ void warp_stages(uint32_t (&kv)[E], uint16_t (&pv)[E],
                                            int d0, long long base, long long k) {
  for (int d = d0; d > 0; d >>= 1) {
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const long long i = base + threadIdx.x + (long long)r * blockDim.x;
      warp_exchange(kv[r], pv[r], d, (i & k) == 0);
    }
  }
}

// Stages d = low_d << (S-1) .. low_d (low_d >= 32) of merge round k over a
// shared-memory tile: each thread exchanges 2^S elements in registers, so S
// stages cost one barrier. Neighbouring threads take neighbouring rows, which
// keeps the shared-memory accesses free of bank conflicts.
template <int S>
__device__ __forceinline__ void smem_steps(uint32_t* key, uint16_t* pos, int tile,
                                           long long base, long long k, int low_d) {
  constexpr int M = 1 << S;
  const int ls = __ffs(low_d) - 1;
  for (int g = threadIdx.x; g < (tile >> S); g += blockDim.x) {
    const int lb = ((g >> ls) << (ls + S)) | (g & (low_d - 1));
    const bool asc = ((base + lb) & k) == 0;
    uint32_t kv[M];
    uint16_t pv[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      kv[m] = key[lb + m * low_d];
      pv[m] = pos[lb + m * low_d];
    }
#pragma unroll
    for (int j = S - 1; j >= 0; --j) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if (m & (1 << j)) continue;
        const int o = m | (1 << j);
        const uint32_t a = kv[m], b = kv[o];
        if (asc ? a > b : a < b) {
          kv[m] = b;
          kv[o] = a;
          const uint16_t t = pv[m];
          pv[m] = pv[o];
          pv[o] = t;
        }
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      key[lb + m * low_d] = kv[m];
      pos[lb + m * low_d] = pv[m];
    }
  }
  __syncthreads();
}

// Stages d = d0 .. 32 of merge round k over a shared-memory tile, up to
// three per barrier. Returns the first distance left (16, or d0 if < 32).
__device__ __forceinline__ int smem_stages(uint32_t* key, uint16_t* pos, int tile,
                                           int d0, long long base, long long k) {
  int d = d0;
  while (d >= 32) {
    if (d >= 128) {
      smem_steps<3>(key, pos, tile, base, k, d >> 2);
      d >>= 3;
    } else if (d >= 64) {
      smem_steps<2>(key, pos, tile, base, k, d >> 1);
      d >>= 2;
    } else {
      smem_steps<1>(key, pos, tile, base, k, d);
      d >>= 1;
    }
  }
  return d;
}

// Rounds k = 2 .. tile: each tile comes out sorted, ascending or descending
// by the parity of its index (ascending when one tile covers the whole
// array). Rounds up to 32 run in registers with warp shuffles; larger rounds
// run their stages d >= 32 in shared memory and the rest in registers.
// Reads the inputs with the 0xFFFFFFFF pad.
template <int NPAY>
__global__ void __launch_bounds__(TILE / E)
tile_sort_kernel(const uint32_t* __restrict__ in_key, ConstPayloads in_pay,
                 uint32_t* __restrict__ out_key, Payloads out_pay, long long n,
                 int tile) {
  __shared__ uint32_t key[TILE];
  __shared__ uint16_t pos[TILE];
  const long long base = (long long)blockIdx.x * tile;
  uint32_t kv[E];
  uint16_t pv[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int t = threadIdx.x + r * blockDim.x;
    kv[r] = base + t < n ? in_key[base + t] : 0xFFFFFFFFu;
    pv[r] = (uint16_t)t;
  }
  for (int k = 2; k <= 32; k <<= 1) warp_stages(kv, pv, k >> 1, base, k);
  for (int k = 64; k <= tile; k <<= 1) {
#pragma unroll
    for (int r = 0; r < E; ++r) {
      key[threadIdx.x + r * blockDim.x] = kv[r];
      pos[threadIdx.x + r * blockDim.x] = pv[r];
    }
    __syncthreads();
    const int d = smem_stages(key, pos, tile, k >> 1, base, k);
#pragma unroll
    for (int r = 0; r < E; ++r) {
      kv[r] = key[threadIdx.x + r * blockDim.x];
      pv[r] = pos[threadIdx.x + r * blockDim.x];
    }
    warp_stages(kv, pv, d, base, k);
  }
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int t = threadIdx.x + r * blockDim.x;
    out_key[base + t] = kv[r];
#pragma unroll
    for (int q = 0; q < NPAY; ++q) {
      const long long g = base + pv[r];
      out_pay.p[q][base + t] = g < n ? in_pay.p[q][g] : 0xFFFFFFFFu;
    }
  }
}

// Stages d = low_d << (S-1) .. low_d (all >= TILE) of merge round k, in
// place. Each thread owns the 2^S elements base + m * low_d that these
// stages exchange, keys and payloads in registers; neighbouring threads own
// neighbouring rows, so every load and store is coalesced. The direction is
// uniform per thread because k > low_d << (S-1).
template <int NPAY, int S>
__global__ void __launch_bounds__(STEP_THREADS)
global_steps_kernel(uint32_t* __restrict__ key, Payloads pay, long long groups,
                    long long k, long long low_d, int low_shift) {
  constexpr int M = 1 << S;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  const long long base = ((g >> low_shift) << (low_shift + S)) | (g & (low_d - 1));
  const bool asc = (base & k) == 0;
  uint32_t kv[M];
  uint32_t pv[NPAY > 0 ? NPAY : 1][M];
#pragma unroll
  for (int m = 0; m < M; ++m) kv[m] = key[base + m * low_d];
#pragma unroll
  for (int q = 0; q < NPAY; ++q)
#pragma unroll
    for (int m = 0; m < M; ++m) pv[q][m] = pay.p[q][base + m * low_d];
#pragma unroll
  for (int j = S - 1; j >= 0; --j) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (m & (1 << j)) continue;
      const int o = m | (1 << j);
      const uint32_t a = kv[m], b = kv[o];
      const bool sw = asc ? a > b : a < b;
      kv[m] = sw ? b : a;
      kv[o] = sw ? a : b;
#pragma unroll
      for (int q = 0; q < NPAY; ++q) {
        const uint32_t pa = pv[q][m], pb = pv[q][o];
        pv[q][m] = sw ? pb : pa;
        pv[q][o] = sw ? pa : pb;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) key[base + m * low_d] = kv[m];
#pragma unroll
  for (int q = 0; q < NPAY; ++q)
#pragma unroll
    for (int m = 0; m < M; ++m) pay.p[q][base + m * low_d] = pv[q][m];
}

// Stages d = d0 .. 1 (d0 < tile <= TILE) of merge round k, in place, one
// tile per block of tile / E threads; the whole tile shares one direction
// (k = 0: ascending). Stages d >= 32 run in shared memory, the rest in
// registers; each payload plane is then permuted once through shared memory.
template <int NPAY>
__global__ void __launch_bounds__(TILE / E)
tile_merge_kernel(uint32_t* __restrict__ key_g, Payloads pay, long long k, int tile,
                  int d0) {
  __shared__ uint32_t key[TILE];
  __shared__ uint16_t pos[TILE];
  __shared__ uint32_t tmp[TILE];
  const long long base = (long long)blockIdx.x * tile;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int t = threadIdx.x + r * blockDim.x;
    key[t] = key_g[base + t];
    pos[t] = (uint16_t)t;
  }
  __syncthreads();
  const int d = smem_stages(key, pos, tile, d0, base, k);
  uint32_t kv[E];
  uint16_t pv[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    kv[r] = key[threadIdx.x + r * blockDim.x];
    pv[r] = pos[threadIdx.x + r * blockDim.x];
  }
  warp_stages(kv, pv, d, base, k);
  uint32_t* out = key_g + base + threadIdx.x;
#pragma unroll
  for (int r = 0; r < E; ++r) out[r * blockDim.x] = kv[r];
#pragma unroll
  for (int q = 0; q < NPAY; ++q) {
    uint32_t* pl = pay.p[q] + base + threadIdx.x;
#pragma unroll
    for (int r = 0; r < E; ++r) tmp[threadIdx.x + r * blockDim.x] = pl[r * blockDim.x];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < E; ++r) pl[r * blockDim.x] = tmp[pv[r]];
    __syncthreads();
  }
}

template <int NPAY>
cudaError_t launch_global_steps(int stages, uint32_t* key, Payloads pay,
                                long long npow, long long k, long long low_d,
                                cudaStream_t s) {
  const long long groups = npow >> stages;
  const unsigned blocks = (unsigned)((groups + STEP_THREADS - 1) / STEP_THREADS);
  const int low_shift = __builtin_ctzll((unsigned long long)low_d);
  switch (stages) {
    case 1:
      global_steps_kernel<NPAY, 1><<<blocks, STEP_THREADS, 0, s>>>(key, pay, groups, k,
                                                                    low_d, low_shift);
      break;
    case 2:
      global_steps_kernel<NPAY, 2><<<blocks, STEP_THREADS, 0, s>>>(key, pay, groups, k,
                                                                    low_d, low_shift);
      break;
    default:
      global_steps_kernel<NPAY, 3><<<blocks, STEP_THREADS, 0, s>>>(key, pay, groups, k,
                                                                    low_d, low_shift);
      break;
  }
  return cudaGetLastError();
}

// The tile stage alone: each tile of min(npow, TILE) elements sorted,
// ascending or descending by the parity of its index (ascending when one
// tile covers the whole array), from the inputs (length n, read with the
// 0xFFFFFFFF pad) into the outputs (length npow).
template <int NPAY>
cudaError_t run_tiles(const uint32_t* in_key, ConstPayloads in_pay, uint32_t* key,
                      Payloads pay, long long n, long long npow, cudaStream_t s) {
  const int tile = npow < TILE ? (int)npow : TILE;
  tile_sort_kernel<NPAY><<<(unsigned)(npow / tile), tile / E, 0, s>>>(
      in_key, in_pay, key, pay, n, tile);
  return cudaGetLastError();
}

// Stages d = block/2 .. 1, ascending, on each block of n elements in place.
template <int NPAY>
cudaError_t run_merge_blocks(uint32_t* key, Payloads pay, long long n, long long block,
                             cudaStream_t s) {
  long long d = block >> 1;
  while (d >= TILE) {
    int stages = 1;
    while (stages < MAX_FUSED && (d >> stages) >= TILE) ++stages;
    const long long low_d = d >> (stages - 1);
    const cudaError_t err = launch_global_steps<NPAY>(stages, key, pay, n, 0, low_d, s);
    if (err != cudaSuccess) return err;
    d = low_d >> 1;
  }
  const int tile = block < TILE ? (int)block : TILE;
  tile_merge_kernel<NPAY><<<(unsigned)(n / tile), tile / E, 0, s>>>(key, pay, 0, tile,
                                                                    tile / 2);
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
  ConstPayloads in_pay{};
  Payloads pay{};
  for (int q = 0; q < n_planes - 1; ++q) {
    in_pay.p[q] = static_cast<const uint32_t*>(in_planes[1 + q]);
    pay.p[q] = static_cast<uint32_t*>(out_planes[1 + q]);
  }
  const uint32_t* in_key = static_cast<const uint32_t*>(in_planes[0]);
  uint32_t* key = static_cast<uint32_t*>(out_planes[0]);
  return (int)with_payloads(n_planes - 1, [&](auto np) {
    return run_tiles<decltype(np)::value>(in_key, in_pay, key, pay, n, npow, s);
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
  for (int q = 0; q < n_planes; ++q) {
    if (in_planes[q] == out_planes[q]) continue;
    const cudaError_t err = cudaMemcpyAsync(out_planes[q], in_planes[q], n * sizeof(uint32_t),
                                            cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return (int)err;
  }
  Payloads pay{};
  for (int q = 0; q < n_planes - 1; ++q) pay.p[q] = static_cast<uint32_t*>(out_planes[1 + q]);
  uint32_t* key = static_cast<uint32_t*>(out_planes[0]);
  return (int)with_payloads(n_planes - 1, [&](auto np) {
    return run_merge_blocks<decltype(np)::value>(key, pay, n, block, s);
  });
}

extern "C" const char* dpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
