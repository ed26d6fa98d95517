// The dependent-add latency of the card, for the chain floor of a fixed-order
// sum (csrc/segment.cu): one thread adds a value to itself n times, each add
// waiting on the last. chip_smoke.py builds this file with nvcc and calls it
// through ctypes; nothing of the package loads it.

#include <cuda_runtime.h>

namespace {

// n dependent adds of v[0] (n a multiple of 64): the SM cycles between the
// first and the last
template <typename T>
__global__ void add_chain_kernel(const T* v, long long n, T* out,
                                 long long* cycles) {
  const T d = v[0];
  T acc = T(0);
  const long long t0 = clock64();
  for (long long i = 0; i < n; i += 64) {
#pragma unroll
    for (int u = 0; u < 64; ++u) acc = acc + d;
  }
  const long long t1 = clock64();
  out[0] = acc;
  cycles[0] = t1 - t0;
}

}  // namespace

extern "C" int add_chain_f32(const float* v, long long n, float* out,
                             long long* cycles, cudaStream_t stream) {
  add_chain_kernel<float><<<1, 1, 0, stream>>>(v, n, out, cycles);
  return (int)cudaGetLastError();
}

extern "C" int add_chain_f64(const double* v, long long n, double* out,
                             long long* cycles, cudaStream_t stream) {
  add_chain_kernel<double><<<1, 1, 0, stream>>>(v, n, out, cycles);
  return (int)cudaGetLastError();
}
