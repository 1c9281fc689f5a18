// A CPU stand-in for the CUDA features csrc/block_ops.cu uses, for
// tests/test_torch_block_ops_emulated.py: one std::thread a CUDA thread,
// one block at a time, std::barrier for __syncthreads and for each warp.
#pragma once
#include <algorithm>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <cstddef>
#include <thread>
#include <vector>
#include <memory>
#include <cstdio>
#include <cstdlib>
using std::min; using std::max;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorNotSupported = 801,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributePreferredSharedMemoryCarveout = 9,
  cudaSharedmemCarveoutMaxShared = 100
};
template <class T> cudaError_t cudaFuncSetAttribute(T, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
struct Idx { unsigned x; };
thread_local Idx threadIdx, blockIdx;
namespace emu {
alignas(16) unsigned char smem[232448];
struct Warp {
  std::barrier<> bar{32};
  uint32_t xch[32];
};
inline std::barrier<>* block_bar;
inline Warp* warps;
}
inline uint4 __ldg(const uint4* p) {
  if ((uintptr_t)p % 16) { fprintf(stderr, "misaligned 16-byte load\n"); abort(); }
  return *p;
}
inline void __syncthreads() { emu::block_bar->arrive_and_wait(); }
inline void __syncwarp() { emu::warps[threadIdx.x / 32].bar.arrive_and_wait(); }
inline uint32_t __shfl_sync(unsigned, uint32_t v, int src) {
  auto& w = emu::warps[threadIdx.x / 32];
  w.xch[threadIdx.x % 32] = v;
  w.bar.arrive_and_wait();
  const uint32_t r = w.xch[src & 31];
  w.bar.arrive_and_wait();
  return r;
}
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  auto& w = emu::warps[threadIdx.x / 32];
  w.xch[threadIdx.x % 32] = v;
  w.bar.arrive_and_wait();
  unsigned s = 0;
  for (int i = 0; i < 32; ++i) s += w.xch[i];
  w.bar.arrive_and_wait();
  return s;
}
namespace emu {
template <class K>
void run(K kernel, long long grid, int threads, int smem_bytes, const int32_t* x,
         const int32_t* idx, int32_t* out, int reps) {
  if (smem_bytes > (int)sizeof(smem) || threads > 1024 || threads % 32) abort();
  for (long long b = 0; b < grid; ++b) {
    memset(smem, 0xCD, sizeof(smem));
    std::barrier<> bar(threads);
    std::unique_ptr<Warp[]> ws(new Warp[threads / 32]);
    block_bar = &bar;
    warps = ws.get();
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([=] { threadIdx.x = t; blockIdx.x = (unsigned)b; kernel(x, idx, out, reps); });
    for (auto& t : ts) t.join();
  }
}
}
