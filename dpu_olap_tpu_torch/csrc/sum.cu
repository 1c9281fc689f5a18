// Exact 64-bit sum of uint32 values. The Hopper counterpart of the TPU sum
// dpu_olap_tpu/ops/aggregate.py: _sum_pallas_pair (_sum_pallas_kernel).
//
// The TPU has no 64-bit integer path, so its kernel splits each value into
// 16-bit halves, folds them into int32 lane accumulators, splits those
// 16/16 again, and needs a bound on the block count to stay exact. Hopper
// adds 64-bit integers natively: each thread sums into an unsigned long long,
// a warp-shuffle and a block reduction follow, and one atomicAdd per block
// lands in a device u64 that this entry point zeroes first. Integer addition
// is exact in any order, so the atomics give a bit-exact result; for
// n < 2^32 values the total is below 2^64.
//
// What bounds it on the H100: reading the input once (4 bytes a value). The
// grid-stride loop loads 16 bytes a thread; a start that is not 16-byte
// aligned (a view into a larger buffer) and a length that is not a multiple
// of 4 are summed by a few threads as a head and a tail.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;  // resident 256-thread blocks per SM

__global__ void sum_u32_kernel(const uint32_t* __restrict__ head, int n_head,
                               const uint4* __restrict__ body, long long n_vec,
                               const uint32_t* __restrict__ tail, int n_tail,
                               unsigned long long* __restrict__ out) {
  __shared__ unsigned long long warp_sum[THREADS / 32];
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  unsigned long long acc = 0;
  for (long long i = t; i < n_vec; i += stride) {
    const uint4 v = body[i];
    acc += (unsigned long long)v.x + v.y + v.z + v.w;
  }
  if (t < n_head) acc += head[t];
  if (t < n_tail) acc += tail[t];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xFFFFFFFFu, acc, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s = 0;
#pragma unroll
    for (int k = 0; k < THREADS / 32; ++k) s += warp_sum[k];
    if (s) atomicAdd(out, s);
  }
}

}  // namespace

// *out = the sum of the n uint32 values at x, as an unsigned 64-bit integer.
// x and out are device pointers, x 4-byte aligned, n below 2^32. Launches
// on `stream` and does not synchronise. Returns 0 or the first CUDA error.
extern "C" int dpu_sum_u32(const void* x, long long n, void* out, void* stream) {
  if (n < 0 || n > 0xFFFFFFFFLL) return (int)cudaErrorInvalidValue;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  if (addr % 4) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  cudaError_t err = cudaMemsetAsync(o, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess || n == 0) return (int)err;
  const uint32_t* xs = static_cast<const uint32_t*>(x);
  long long n_head = (long long)((16 - addr % 16) % 16) / 4;
  if (n_head > n) n_head = n;
  const long long n_vec = (n - n_head) / 4;
  const long long n_tail = n - n_head - 4 * n_vec;
  // one wave of resident blocks on the current device (132 SMs on an H100
  // SXM, 114 on a PCIe card), the grid-stride loop covers the rest
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (n_vec + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > (long long)sms * BLOCKS_PER_SM) blocks = (long long)sms * BLOCKS_PER_SM;
  sum_u32_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
      xs, (int)n_head, reinterpret_cast<const uint4*>(xs + n_head), n_vec,
      xs + n_head + 4 * n_vec, (int)n_tail, o);
  return (int)cudaGetLastError();
}
