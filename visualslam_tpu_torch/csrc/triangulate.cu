// Linear (DLT) triangulation of point pairs: the eigenvector of the
// smallest eigenvalue of each point's 4x4 normal matrix, by cyclic Jacobi.
//
// No Pallas kernel of the JAX package corresponds: there the solve is
// `jnp.linalg.eigh` inside geometry/epipolar.py `_triangulate_highp`,
// which XLA runs inside the engine's compiled batch program. In PyTorch
// the same call on the card is cuSOLVER's batched Jacobi followed by a
// host read of its error flags, one host sync per call, which a CUDA graph
// cannot hold. This kernel takes its place, so that a keyframe promotion
// runs without a host sync and can be captured.
//
// For the relative pose (R [3, 3], t [3]: X2 = R X1 + t) and the
// normalized coordinates x1, x2 [n, 2] (all float32, contiguous), it writes
// X [n, 3] in camera 1's frame, one thread per point:
//
//   A = [x1.x P1[2] - P1[0]; x1.y P1[2] - P1[1];      P1 = [I | 0]
//        x2.x P2[2] - P2[0]; x2.y P2[2] - P2[1]]      P2 = [R | t]
//   M = A^T A (rows added in order 0..3)
//   `sweeps` cyclic Jacobi sweeps over the pairs (0,1) (0,2) (0,3) (1,2)
//   (1,3) (2,3), Rutishauser's rotation, the rotations accumulated in V
//   v = the column of V at the first smallest diagonal entry
//   v *= -1 where v[3] < 0; w = v[3], or kEps where |w| < kEps
//   X = v[0:3] / w
//
// Every product, sum, quotient and square root is a separately rounded
// IEEE float32 operation (the __f*_rn intrinsics: nvcc contracts nothing
// into an FMA), so a float32 replay of the same operations on another
// device gives the same bits (ops/cuda/triangulate.py
// `triangulate_jacobi`, which the CPU tests hold against the JAX package).
//
// Sweeps. Cyclic Jacobi converges quadratically; ops/cuda/triangulate.py
// SWEEPS, which the wrapper passes, is the count after which the
// off-diagonal norm of every normal matrix of the tests' and the card's
// triangulations lies below float32 rounding of the matrix (PERF.md).
//
// Bounds: 28 bytes in and 12 out per point, and ~2.3 kFLOP of scalar
// float32 (the rotations); at the main path's n = 512 or 1024 the work is a
// few microseconds of one wave of threads, so the call costs what its
// launch costs. The design is one thread per point with the 4x4 matrices
// in registers (every index is a compile-time constant) and no shared
// memory: what the PyTorch path needed was one launch and no host sync, in
// place of a batched matrix product, cuSOLVER's batched eigensolver and
// its error-flag read.

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-12f;
constexpr int kThreads = 128;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// One Jacobi rotation zeroing a[P][Q] of the symmetric a (both triangles
// kept), accumulated into the columns P and Q of v.
template <int P, int Q>
__device__ __forceinline__ void rotate(float (&a)[4][4], float (&v)[4][4]) {
  const float apq = a[P][Q];
  if (apq == 0.f) return;
  const float theta = dvd(sub(a[Q][Q], a[P][P]), mul(2.f, apq));
  float t = dvd(1.f, add(fabsf(theta),
                         __fsqrt_rn(add(mul(theta, theta), 1.f))));
  if (theta < 0.f) t = -t;
  const float c = dvd(1.f, __fsqrt_rn(add(mul(t, t), 1.f)));
  const float s = mul(t, c);
  const float tau = dvd(s, add(1.f, c));
  const float h = mul(t, apq);
  a[P][P] = sub(a[P][P], h);
  a[Q][Q] = add(a[Q][Q], h);
  a[P][Q] = 0.f;
  a[Q][P] = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (r == P || r == Q) continue;
    const float g = a[r][P];
    const float hh = a[r][Q];
    const float np = sub(g, mul(s, add(hh, mul(g, tau))));
    const float nq = add(hh, mul(s, sub(g, mul(hh, tau))));
    a[r][P] = np;
    a[P][r] = np;
    a[r][Q] = nq;
    a[Q][r] = nq;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float g = v[r][P];
    const float hh = v[r][Q];
    v[r][P] = sub(g, mul(s, add(hh, mul(g, tau))));
    v[r][Q] = add(hh, mul(s, sub(g, mul(hh, tau))));
  }
}

__global__ void __launch_bounds__(kThreads)
triangulate_kernel(const float* __restrict__ Rg, const float* __restrict__ tg,
                   const float* __restrict__ x1, const float* __restrict__ x2,
                   float* __restrict__ X, int n, int sweeps) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float P2[3][4];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) P2[r][c] = Rg[3 * r + c];
    P2[r][3] = tg[r];
  }
  const float u1 = x1[2 * i], v1 = x1[2 * i + 1];
  const float u2 = x2[2 * i], v2 = x2[2 * i + 1];
  // the DLT rows; P1 = [I | 0]: u P1[2] - P1[0] = (u*0 - 1, u*0 - 0, u*1 - 0,
  // u*0 - 0), rounded as the plain version's elementwise ops round them
  float A[4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float p12 = c == 2 ? 1.f : 0.f;
    A[0][c] = sub(mul(u1, p12), c == 0 ? 1.f : 0.f);
    A[1][c] = sub(mul(v1, p12), c == 1 ? 1.f : 0.f);
    A[2][c] = sub(mul(u2, P2[2][c]), P2[0][c]);
    A[3][c] = sub(mul(v2, P2[2][c]), P2[1][c]);
  }
  float a[4][4], v[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int k = j; k < 4; ++k) {
      float m = mul(A[0][j], A[0][k]);
#pragma unroll
      for (int r = 1; r < 4; ++r) m = add(m, mul(A[r][j], A[r][k]));
      a[j][k] = m;
      a[k][j] = m;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) v[j][k] = j == k ? 1.f : 0.f;
  }
  for (int s = 0; s < sweeps; ++s) {
    rotate<0, 1>(a, v);
    rotate<0, 2>(a, v);
    rotate<0, 3>(a, v);
    rotate<1, 2>(a, v);
    rotate<1, 3>(a, v);
    rotate<2, 3>(a, v);
  }
  // the first smallest diagonal entry; select by value so that v stays in
  // registers
  float best = a[0][0];
  float e0 = v[0][0], e1 = v[1][0], e2 = v[2][0], e3 = v[3][0];
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    if (a[k][k] < best) {
      best = a[k][k];
      e0 = v[0][k];
      e1 = v[1][k];
      e2 = v[2][k];
      e3 = v[3][k];
    }
  }
  if (e3 < 0.f) {
    e0 = -e0;
    e1 = -e1;
    e2 = -e2;
    e3 = -e3;
  }
  const float w = fabsf(e3) < kEps ? kEps : e3;
  X[3 * i] = dvd(e0, w);
  X[3 * i + 1] = dvd(e1, w);
  X[3 * i + 2] = dvd(e2, w);
}

}  // namespace

extern "C" int triangulate_dlt(const float* R, const float* t, const float* x1,
                               const float* x2, float* X, int n, int sweeps,
                               cudaStream_t stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  triangulate_kernel<<<blocks, kThreads, 0, stream>>>(R, t, x1, x2, X, n,
                                                      sweeps);
  return static_cast<int>(cudaGetLastError());
}
