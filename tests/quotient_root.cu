// Holds csrc/jacobi_f32.cuh's quotient_fast and root_fast (svd3's
// rotation_one_test) to __fdiv_rn and __fsqrt_rn bit for bit wherever their
// range tests pass: the quotient over every pair of exponent fields (a block
// per pair; random mantissas and signs, and the extreme mantissas), the
// root over every float32 bit pattern. Counts the operands in range and the
// mismatches among them. tests/test_torch_gpu.py builds this file with nvcc
// and calls it through ctypes; nothing of the package loads it.

#include <cuda_runtime.h>

#include "../visualslam_tpu_torch/csrc/jacobi_f32.cuh"

namespace {

__device__ __forceinline__ unsigned mix(unsigned x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

// counts: [in range, mismatches] for the quotient
__global__ void quotient_kernel(int per_thread, unsigned long long* counts) {
  const unsigned ea = blockIdx.x, eb = blockIdx.y;
  unsigned long long in = 0, bad = 0;
  for (int k = 0; k < per_thread; ++k) {
    const unsigned h1 = mix(((blockIdx.y * gridDim.x + blockIdx.x) *
                             blockDim.x + threadIdx.x) * per_thread + k);
    const unsigned h2 = mix(h1 ^ 0x9e3779b9u);
    unsigned ma = h1 & 0x7fffffu, mb = h2 & 0x7fffffu;
    if (k == 0 && threadIdx.x < 4) {         // the extreme mantissas
      ma = threadIdx.x & 1 ? 0x7fffffu : 0u;
      mb = threadIdx.x & 2 ? 0x7fffffu : 0u;
    }
    const float a = __uint_as_float((h1 & 0x80000000u) | ea << 23 | ma);
    const float b = __uint_as_float((h2 & 0x80000000u) | eb << 23 | mb);
    if (quotient_in_range(a, b)) {
      ++in;
      bad += __float_as_uint(quotient_fast(a, b)) !=
             __float_as_uint(__fdiv_rn(a, b));
    }
  }
  atomicAdd(&counts[0], in);
  atomicAdd(&counts[1], bad);
}

// counts: [in range, mismatches] for the root
__global__ void root_kernel(unsigned long long* counts) {
  unsigned long long in = 0, bad = 0;
  const unsigned long long step = 1ull * gridDim.x * blockDim.x;
  for (unsigned long long u = blockIdx.x * blockDim.x + threadIdx.x;
       u < (1ull << 32); u += step) {
    const float x = __uint_as_float(static_cast<unsigned>(u));
    if (root_in_range(x)) {
      ++in;
      bad += __float_as_uint(root_fast(x)) != __float_as_uint(__fsqrt_rn(x));
    }
  }
  atomicAdd(&counts[0], in);
  atomicAdd(&counts[1], bad);
}

}  // namespace

// counts [4]: the quotient's in range and mismatches, the root's
extern "C" int quotient_root_check(int per_thread, unsigned long long* counts,
                                   cudaStream_t stream) {
  quotient_kernel<<<dim3(256, 256), 128, 0, stream>>>(per_thread, counts);
  root_kernel<<<132 * 16, 256, 0, stream>>>(counts + 2);
  return static_cast<int>(cudaGetLastError());
}
