// Gather of a uint32 table at ascending uint32 positions:
// val[j] = data[sidx[j]] where sidx[j] < n, else 0. The Hopper counterpart
// of the TPU streaming gather dpu_olap_tpu/ops/take_pallas.py:
// gather_sorted_pallas (_gather_kernel).
//
// The TPU kernel walks table slices with a cursor over a fixed window of
// sorted queries, because Mosaic has no dynamic gather; a run of queries
// longer than the window overflows. Here each thread loads its own element,
// so there is no window and nothing can overflow (the caller's overflow flag
// stays 0), and a position outside the table yields 0 without a read: the
// kernel never reads out of bounds, which also applies the join's
// matched mask for free.
//
// What bounds it on the H100: device-memory traffic, 4 bytes of sidx read,
// 4 written, and the table lines touched. Because sidx is sorted,
// neighbouring threads of a warp read neighbouring or equal table addresses,
// so the table reads coalesce into few lines and the whole table streams
// through about once: this is a sequential scan in disguise, not a
// random-access gather.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void gather_sorted_kernel(const uint32_t* __restrict__ data,
                                     long long n,
                                     const uint32_t* __restrict__ sidx,
                                     uint32_t* __restrict__ out, long long k) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= k) return;
  const uint32_t s = sidx[j];
  out[j] = (long long)s < n ? __ldg(data + s) : 0u;
}

}  // namespace

// out[j] = data[sidx[j]] (0 where sidx[j] >= n) for j < k, all device
// pointers. Launches on `stream` and does not synchronise. Returns 0 or
// cudaGetLastError() after the launch.
extern "C" int dpu_gather_sorted_u32(const void* data, long long n,
                                     const void* sidx, void* out, long long k,
                                     void* stream) {
  if (n < 0 || k < 0) return (int)cudaErrorInvalidValue;
  if (k == 0) return 0;
  const unsigned blocks = (unsigned)((k + THREADS - 1) / THREADS);
  gather_sorted_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(data), n, static_cast<const uint32_t*>(sidx),
      static_cast<uint32_t*>(out), k);
  return (int)cudaGetLastError();
}
