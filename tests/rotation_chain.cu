// The latency of one Jacobi rotation's dependent chain on the card, for the
// chain floor of csrc/small_linalg.cu's sym_eigh (float64) and
// csrc/triangulate.cu (float32): one thread carries out n rotations in a
// row, each pivot the row update of the last (Rutishauser's coefficients:
// four quotients and two square roots in sequence, then rot_p), as each
// rotation of those kernels waits on the one before. chip_smoke.py builds
// this file with nvcc and calls it through ctypes; nothing of the package
// loads it.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ float magnitude(float a) { return fabsf(a); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ double magnitude(double a) { return fabs(a); }

// n rotations (n a multiple of 8) with the pivots x[0..2] = (a_pp, a_qq,
// a_pq) and the row entry x[3]: the SM cycles between the first and the
// last. The pivot stays in [0.56, 0.71] (no zero, no subnormal).
template <typename T>
__global__ void rotation_chain_kernel(const T* x, long long n, T* out,
                                      long long* cycles) {
  const T one = 1, two = 2;
  const T app = x[0], aqq = x[1], g = x[3];
  T apq = x[2];
  const long long t0 = clock64();
#pragma unroll 8
  for (long long i = 0; i < n; ++i) {
    const T theta = dvd(sub(aqq, app), mul(two, apq));
    T t = dvd(one, add(magnitude(theta), root(add(mul(theta, theta), one))));
    if (theta < T(0)) t = -t;
    const T c = dvd(one, root(add(mul(t, t), one)));
    const T s = mul(t, c);
    const T tau = dvd(s, add(one, c));
    apq = sub(g, mul(s, add(apq, mul(g, tau))));   // rot_p(g, apq, s, tau)
  }
  const long long t1 = clock64();
  out[0] = apq;
  cycles[0] = t1 - t0;
}

}  // namespace

extern "C" int rotation_chain_f32(const float* x, long long n, float* out,
                                  long long* cycles, cudaStream_t stream) {
  rotation_chain_kernel<float><<<1, 1, 0, stream>>>(x, n, out, cycles);
  return (int)cudaGetLastError();
}

extern "C" int rotation_chain_f64(const double* x, long long n, double* out,
                                  long long* cycles, cudaStream_t stream) {
  rotation_chain_kernel<double><<<1, 1, 0, stream>>>(x, n, out, cycles);
  return (int)cudaGetLastError();
}
