// The latency of one Jacobi rotation's dependent chain on the card, for the
// chain floors of csrc/small_linalg.cu (sym_eigh in float64, svd3 in
// float32) and csrc/triangulate.cu (float32): one thread carries out n
// rotations in a row, each pivot the row update of the last (Rutishauser's
// coefficients: four quotients and two square roots in sequence, then
// rot_p), as each rotation of those kernels waits on the one before. Two
// float32 chains: triangulate's rotation (`rotation_chain_f32_stand_ins`:
// csrc/jacobi_f32.cuh `rotation`, with its stand-ins for tiny and
// overflowing operands and the skip of a zero pivot on the way) and svd3's
// (`rotation_chain_f32_one_test`: the skip a branch, `rotation_one_test`'s
// fast paths and one range test), the fastest of them the float32 kernels'
// chain floor.
// chip_smoke.py builds this file with nvcc and calls it through ctypes;
// nothing of the package loads it.

#include <cuda_runtime.h>
#include <math.h>

#include "../visualslam_tpu_torch/csrc/jacobi_f32.cuh"

namespace {

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }

// n rotations (n a multiple of 8) with the pivots x[0..2] = (a_pp, a_qq,
// a_pq) and the row entry x[3], in float64 by sym_eigh's formulas: the SM
// cycles between the first and the last. The pivot stays in [0.56, 0.71]
// (no zero, no subnormal).
__global__ void rotation_chain_kernel(const double* x, long long n,
                                      double* out, long long* cycles) {
  const double one = 1, two = 2;
  const double app = x[0], aqq = x[1], g = x[3];
  double apq = x[2];
  const long long t0 = clock64();
#pragma unroll 8
  for (long long i = 0; i < n; ++i) {
    const double theta = dvd(sub(aqq, app), mul(two, apq));
    double t = dvd(one, add(fabs(theta), __dsqrt_rn(add(mul(theta, theta),
                                                          one))));
    if (theta < 0.0) t = -t;
    const double c = dvd(one, __dsqrt_rn(add(mul(t, t), one)));
    const double s = mul(t, c);
    const double tau = dvd(s, add(one, c));
    apq = sub(g, mul(s, add(apq, mul(g, tau))));   // rot_p(g, apq, s, tau)
  }
  const long long t1 = clock64();
  out[0] = apq;
  cycles[0] = t1 - t0;
}

// The same chain through triangulate's rotation (every pivot non-zero, so
// every rotation is carried out).
__global__ void rotation_chain_kernel_stand_ins(const float* x, long long n,
                                                float* out,
                                                long long* cycles) {
  const float app = x[0], aqq = x[1], g = x[3];
  float apq = x[2];
  const long long t0 = clock64();
#pragma unroll 8
  for (long long i = 0; i < n; ++i) {
    const bool skip = apq == 0.f;
    float s, tau, h;
    rotation(app, aqq, skip ? 1.f : apq, s, tau, h);
    apq = skip ? g : rot_p(g, apq, s, tau);
  }
  const long long t1 = clock64();
  out[0] = apq;
  cycles[0] = t1 - t0;
}

// The same chain through svd3's rotation: the zero pivot's skip a branch
// (never taken here), the coefficients by rotation_one_test.
__global__ void rotation_chain_kernel_one_test(const float* x, long long n,
                                               float* out,
                                               long long* cycles) {
  const float app = x[0], aqq = x[1], g = x[3];
  float apq = x[2];
  const long long t0 = clock64();
#pragma unroll 8
  for (long long i = 0; i < n; ++i) {
    if (apq != 0.f) {
      float s, tau, h;
      rotation_one_test(app, aqq, apq, s, tau, h);
      apq = rot_p(g, apq, s, tau);
    }
  }
  const long long t1 = clock64();
  out[0] = apq;
  cycles[0] = t1 - t0;
}

}  // namespace

extern "C" int rotation_chain_f64(const double* x, long long n, double* out,
                                  long long* cycles, cudaStream_t stream) {
  rotation_chain_kernel<<<1, 1, 0, stream>>>(x, n, out, cycles);
  return (int)cudaGetLastError();
}

extern "C" int rotation_chain_f32_stand_ins(const float* x, long long n,
                                            float* out, long long* cycles,
                                            cudaStream_t stream) {
  rotation_chain_kernel_stand_ins<<<1, 1, 0, stream>>>(x, n, out, cycles);
  return (int)cudaGetLastError();
}

extern "C" int rotation_chain_f32_one_test(const float* x, long long n,
                                           float* out, long long* cycles,
                                           cudaStream_t stream) {
  rotation_chain_kernel_one_test<<<1, 1, 0, stream>>>(x, n, out, cycles);
  return (int)cudaGetLastError();
}
