// A CPU stand-in for the CUDA features csrc/block_ops.cu, csrc/probes.cu and
// csrc/scan.cu use, for tests/test_torch_block_ops_emulated.py,
// tests/test_torch_probes_emulated.py and tests/test_torch_fill_match.py:
// one std::thread a CUDA thread, one block at a time, std::barrier for
// __syncthreads and for each warp; a static __shared__ array is one array
// that the blocks take in turn. Blocks run in the order of their index, so
// a block that takes a ticket (atomicAdd) finds every earlier one done.
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
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
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
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct Idx { unsigned x, y, z; };
thread_local Idx threadIdx, blockIdx;
thread_local dim3 blockDim, gridDim;
namespace emu {
alignas(16) unsigned char smem[232448];
thread_local int tid;  // the thread's index in its block, x fastest
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
inline void __syncwarp() { emu::warps[emu::tid / 32].bar.arrive_and_wait(); }
inline uint32_t __shfl_sync(unsigned, uint32_t v, int src) {
  auto& w = emu::warps[emu::tid / 32];
  w.xch[emu::tid % 32] = v;
  w.bar.arrive_and_wait();
  const uint32_t r = w.xch[src & 31];
  w.bar.arrive_and_wait();
  return r;
}
inline int __shfl_sync(unsigned mask, int v, int src) {
  return (int)__shfl_sync(mask, (uint32_t)v, src);
}
inline unsigned long long __shfl_sync(unsigned mask, unsigned long long v, int src) {
  const uint32_t lo = __shfl_sync(mask, (uint32_t)v, src);
  return (unsigned long long)__shfl_sync(mask, (uint32_t)(v >> 32), src) << 32 | lo;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  auto& w = emu::warps[emu::tid / 32];
  w.xch[emu::tid % 32] = pred != 0;
  w.bar.arrive_and_wait();
  unsigned b = 0;
  for (int i = 0; i < 32; ++i) b |= w.xch[i] ? 1u << i : 0u;
  w.bar.arrive_and_wait();
  return b;
}
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline void __nanosleep(unsigned) { std::this_thread::yield(); }
inline void __stcs(uint4* p, uint4 v) { *p = v; }
inline void __stcs(unsigned* p, unsigned v) { *p = v; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  memset(p, v, n);
  return cudaSuccess;
}
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  auto& w = emu::warps[emu::tid / 32];
  w.xch[emu::tid % 32] = v;
  w.bar.arrive_and_wait();
  unsigned s = 0;
  for (int i = 0; i < 32; ++i) s += w.xch[i];
  w.bar.arrive_and_wait();
  return s;
}
namespace emu {
// body() once for each thread of each block of the grid, with threadIdx,
// blockIdx, blockDim and gridDim set; shared memory filled with 0xCD before
// each block
template <class F>
void blocks(dim3 grid, dim3 block, size_t smem_bytes, F body) {
  const int threads = (int)(block.x * block.y * block.z);
  if (smem_bytes > sizeof(smem) || threads > 1024 || threads % 32) abort();
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      memset(smem, 0xCD, sizeof(smem));
      std::barrier<> bar(threads);
      std::unique_ptr<Warp[]> ws(new Warp[threads / 32]);
      block_bar = &bar;
      warps = ws.get();
      std::vector<std::thread> ts;
      for (int t = 0; t < threads; ++t)
        ts.emplace_back([&, t] {
          tid = t;
          threadIdx = {t % block.x, t / block.x % block.y, t / (block.x * block.y)};
          blockIdx = {bx, by, 0};
          blockDim = block;
          gridDim = grid;
          body();
        });
      for (auto& t : ts) t.join();
    }
}

// block_ops.cu's launches: a 1-D grid of one kernel signature
template <class K>
void run(K kernel, long long grid, int threads, int smem_bytes, const int32_t* x,
         const int32_t* idx, int32_t* out, int reps) {
  blocks(dim3((unsigned)grid), dim3((unsigned)threads), (size_t)smem_bytes,
         [=] { kernel(x, idx, out, reps); });
}

// K<<<grid, block, smem, stream>>>(args...) as Launch(grid, block, smem,
// stream).run(K)(args...)
struct Launch {
  dim3 grid, block;
  size_t smem;
  Launch(dim3 g, dim3 b, size_t s = 0, cudaStream_t = nullptr) : grid(g), block(b), smem(s) {}
  template <class K>
  auto run(K kernel) const {
    return [=, *this](auto... args) { blocks(grid, block, smem, [=] { kernel(args...); }); };
  }
};
}
