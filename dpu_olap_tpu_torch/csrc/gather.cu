// Gather of a uint32 table at ascending uint32 positions:
// val[j] = data[sidx[j]] where sidx[j] < n, else 0. The Hopper counterpart
// of the TPU streaming gather dpu_olap_tpu/ops/take_pallas.py:
// gather_sorted_pallas (_gather_kernel).
//
// The TPU kernel walks table slices with a cursor over a fixed window of
// sorted queries, because Mosaic has no dynamic gather; a run of queries
// longer than the window overflows. Here each thread loads its own
// elements, so there is no window and nothing can overflow: the kernel
// writes the caller's overflow flag as 0 itself, so a call is one launch.
// A position outside the table yields 0 without a read: the kernel never
// reads out of bounds, which also applies the join's matched mask for free.
//
// What bounds it on the H100: device-memory traffic, 4 bytes of sidx read,
// 4 written, and the table lines touched (12 bytes a query when the
// queries cover the table). Because sidx is sorted, neighbouring threads
// of a warp read neighbouring or equal table addresses, so the table reads
// coalesce into few lines and the whole table streams through about once.
// Each thread takes 4 consecutive queries: one 16-byte load of sidx, four
// independent table loads in flight, one 16-byte streaming store. A scalar
// head (until sidx is 16-byte aligned) and tail (k not a multiple of 4)
// run in the same launch; where out is not aligned like sidx, the body
// stores its 4 values one by one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;  // queries a thread

__device__ __forceinline__ uint32_t fetch(const uint32_t* __restrict__ data, long long n,
                                          uint32_t s) {
  return (long long)s < n ? __ldg(data + s) : 0u;
}

__global__ void __launch_bounds__(THREADS)
gather_sorted_kernel(const uint32_t* __restrict__ data, long long n,
                     const uint32_t* __restrict__ sidx, uint32_t* __restrict__ out, long long k,
                     int head, long long body, bool vec_out, int* __restrict__ flag) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (g == 0) *flag = 0;
  if (g < body) {
    const long long j = head + VEC * g;
    const uint4 s = __ldcs(reinterpret_cast<const uint4*>(sidx + j));
    uint4 v;
    v.x = fetch(data, n, s.x);
    v.y = fetch(data, n, s.y);
    v.z = fetch(data, n, s.z);
    v.w = fetch(data, n, s.w);
    if (vec_out) {
      __stcs(reinterpret_cast<uint4*>(out + j), v);
    } else {
      __stcs(out + j, v.x);
      __stcs(out + j + 1, v.y);
      __stcs(out + j + 2, v.z);
      __stcs(out + j + 3, v.w);
    }
  }
  if (g < head) out[g] = fetch(data, n, sidx[g]);
  const long long tail = head + VEC * body;
  if (g < k - tail) out[tail + g] = fetch(data, n, sidx[tail + g]);
}

}  // namespace

// out[j] = data[sidx[j]] (0 where sidx[j] >= n) for j < k, and *flag = 0
// (int32), all device pointers; sidx and out 4-byte aligned. Launches one
// kernel on `stream` and does not synchronise. Returns 0 or
// cudaGetLastError() after the launch.
extern "C" int dpu_gather_sorted_u32(const void* data, long long n, const void* sidx, void* out,
                                     long long k, void* flag, void* stream) {
  if (n < 0 || k < 0) return (int)cudaErrorInvalidValue;
  const uintptr_t sa = reinterpret_cast<uintptr_t>(sidx);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  if ((sa | oa) & 3) return (int)cudaErrorInvalidValue;
  long long head = (long long)((16 - (sa & 15)) & 15) / 4;  // queries before sidx is aligned
  if (head > k) head = k;
  const long long body = (k - head) / VEC;
  const bool vec_out = ((oa + 4 * head) & 15) == 0;
  long long blocks = (body + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;  // the head, the tail and the flag
  gather_sorted_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(data), n, static_cast<const uint32_t*>(sidx),
      static_cast<uint32_t*>(out), k, (int)head, body, vec_out, static_cast<int*>(flag));
  return (int)cudaGetLastError();
}
