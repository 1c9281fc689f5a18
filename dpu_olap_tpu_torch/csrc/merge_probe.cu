// Merge-probe of a sorted uint32 probe column against a sorted build column:
// the Hopper counterpart of the TPU kernel
// dpu_olap_tpu/ops/merge_pallas.py:merge_probe_pallas (_merge_probe_kernel).
//
// For each probe element x: the last build position j with build[j] <= x
// (the greatest build key <= x; build keys are unique apart from an EMPTY
// tail), has = whether there is one, pkey = build[j] or 0xFFFFFFFF (EMPTY)
// where there is none, and each payload plane's value at j, or 0. The TPU
// kernel pads the build side with (EMPTY, 0) rows to its block size; the
// port reads the build column as it is (ops/merge_cuda.py says where that
// shows).
//
// The TPU kernel streams probe blocks against build chunks with an SMEM
// carry, bitonic-merges the two blocks in VMEM and extracts the probe rows
// with a butterfly, because Mosaic has no dynamic gather. Hopper has one, so
// here each thread binary-searches the build keys for its probe element
// (the upper bound: 21 steps at 2Mi, in 32-bit indices) and gathers the
// payloads at the result. The probe column is sorted, so the threads of a
// warp walk nearly the same search path and share the lines they read; a
// build side of a few Mi keys stays in the 50 MB L2. A merge-path split
// (each block searches its probe range once, then merges through shared
// memory) is the later design.
//
// What bounds it on the H100: the build side's lines the searches touch,
// then device-memory traffic: the probe read once, has, pkey and the
// payloads written once, the build keys and payloads read about once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_PAYLOADS = 8;  // ops/merge_cuda.py MAX_PAYLOADS
constexpr uint32_t EMPTY = 0xFFFFFFFFu;

struct InPlanes {
  const uint32_t* p[MAX_PAYLOADS];
};

struct OutPlanes {
  uint32_t* p[MAX_PAYLOADS];
};

template <int NP>
__global__ void __launch_bounds__(THREADS)
merge_probe_kernel(const uint32_t* __restrict__ left, long long nl,
                   const uint32_t* __restrict__ right, uint32_t nr, InPlanes pay,
                   uint8_t* __restrict__ has, uint32_t* __restrict__ pkey, OutPlanes out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= nl) return;
  const uint32_t x = left[i];
  // lo ends as the number of build keys <= x; lo + half < nr < 2^32
  uint32_t lo = 0, len = nr;
  while (len > 0) {
    const uint32_t half = len >> 1;
    if (__ldg(right + lo + half) <= x) {
      lo += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  const bool hit = lo > 0;
  const uint32_t j = lo - 1;
  has[i] = hit;
  pkey[i] = hit ? __ldg(right + j) : EMPTY;
#pragma unroll
  for (int q = 0; q < NP; ++q) out.p[q][i] = hit ? __ldg(pay.p[q] + j) : 0u;
}

template <int NP>
cudaError_t launch(const uint32_t* left, long long nl, const uint32_t* right, uint32_t nr,
                   InPlanes pay, uint8_t* has, uint32_t* pkey, OutPlanes out, cudaStream_t s) {
  const unsigned blocks = (unsigned)((nl + THREADS - 1) / THREADS);
  merge_probe_kernel<NP><<<blocks, THREADS, 0, s>>>(left, nl, right, nr, pay, has, pkey, out);
  return cudaGetLastError();
}

}  // namespace

// For nl >= 1 sorted probe keys and 0 <= nr < 2^32 sorted build keys with
// n_pay payload planes (0..8; host arrays of device pointers, nr uint32
// each in, nl each out): has (nl bytes), pkey (nl uint32) and the payloads of the
// last build position <= each probe key. Launches on `stream` and does not
// synchronise. Returns 0 or the CUDA error of the launch.
extern "C" int dpu_merge_probe_u32(const void* left, long long nl, const void* right, long long nr,
                                   void* const* payloads, int n_pay, void* has, void* pkey,
                                   void* const* out_pays, void* stream) {
  if (nl < 1 || nr < 0 || nr > 0xFFFFFFFFll || n_pay < 0 || n_pay > MAX_PAYLOADS)
    return (int)cudaErrorInvalidValue;
  InPlanes pay{};
  OutPlanes out{};
  for (int q = 0; q < n_pay; ++q) {
    pay.p[q] = static_cast<const uint32_t*>(payloads[q]);
    out.p[q] = static_cast<uint32_t*>(out_pays[q]);
  }
  const uint32_t* l = static_cast<const uint32_t*>(left);
  const uint32_t* r = static_cast<const uint32_t*>(right);
  uint8_t* h = static_cast<uint8_t*>(has);
  uint32_t* k = static_cast<uint32_t*>(pkey);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_pay) {
    case 0: return (int)launch<0>(l, nl, r, nr, pay, h, k, out, s);
    case 1: return (int)launch<1>(l, nl, r, nr, pay, h, k, out, s);
    case 2: return (int)launch<2>(l, nl, r, nr, pay, h, k, out, s);
    case 3: return (int)launch<3>(l, nl, r, nr, pay, h, k, out, s);
    case 4: return (int)launch<4>(l, nl, r, nr, pay, h, k, out, s);
    case 5: return (int)launch<5>(l, nl, r, nr, pay, h, k, out, s);
    case 6: return (int)launch<6>(l, nl, r, nr, pay, h, k, out, s);
    case 7: return (int)launch<7>(l, nl, r, nr, pay, h, k, out, s);
    default: return (int)launch<8>(l, nl, r, nr, pay, h, k, out, s);
  }
}
