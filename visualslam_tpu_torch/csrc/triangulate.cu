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
// X [n, 3] in camera 1's frame:
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
// few microseconds of one wave of threads. What sets the time is each
// point's chain of 6 x `sweeps` dependent rotations, each a coefficient
// chain of four quotients and two square roots, then the update the next
// pivot reads (chip_smoke.py measures that latency with
// tests/rotation_chain.cu and prints rotations x latency as the chain
// floor).
//
// Design: four lanes per point, eight points a warp, blocks of one warp (n
// = 1024 takes 128 blocks, against 8 blocks of 128 threads with a thread
// per point). Every lane of the four holds all of M and rotates it itself,
// the thread-per-point arithmetic as it stood; lane r holds row r of V
// and turns only its V[r][p], V[r][q]; one shuffle at the end brings V's
// last row to the others for the sign. Late sweeps leave tiny pivots, on
// which __fdiv_rn and __fsqrt_rn take their slow paths; `rotation` gives
// their IEEE results without them. The pair order, the skip of a zero
// pivot (by keeping every value: nothing branches on it), each entry's
// rot_p / rot_q on the same operands, the selection, the sign and the
// quotients are the thread-per-point design's, so the points keep their
// bits (tests/test_torch_gpu.py, chip_smoke.py). Lanes on the rows of M
// (the pivot by shuffle, lanes p and q swapping rows) measured the same
// within 2% (PERF.md); the simpler design stays.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kEps = 1e-12f;
constexpr int kLanes = 4;          // per point
constexpr int kThreads = 32;       // one warp: 8 points
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// Rutishauser's coefficients (s, tau, h) for the pivot apq, each value the
// IEEE one that __fdiv_rn / __fsqrt_rn give, without the slow paths that
// late sweeps would take. A divisor 2 apq below 2^-90 (a quotient that may
// overflow, or a subnormal divisor) is divided in float64 and rounded once
// (exact: 53 >= 2 x 24 + 2 bits). Where theta * theta overflows, t = 1 /
// (|theta| + sqrt(inf)) is +0 before its sign, and a zero s over the
// positive 1 + c is that zero: there the quotients run on stand-in operands
// and their results are replaced, so nothing branches but the float64
// division.
__device__ __forceinline__ void rotation(float app, float aqq, float apq,
                                         float& s, float& tau, float& h) {
  const float num = sub(aqq, app), den = mul(2.f, apq);
  const bool tiny = !(fabsf(den) >= 0x1p-90f);
  float theta = dvd(num, tiny ? 1.f : den);
  if (tiny) theta = __double2float_rn(__ddiv_rn(num, den));
  const float tt = mul(theta, theta);
  const bool huge = isinf(tt);
  float t = dvd(1.f, add(fabsf(huge ? 0.f : theta),
                         __fsqrt_rn(add(huge ? 0.f : tt, 1.f))));
  if (huge) t = 0.f;
  if (theta < 0.f) t = -t;
  const float c = dvd(1.f, __fsqrt_rn(add(mul(t, t), 1.f)));
  s = mul(t, c);
  const float q = dvd(s == 0.f ? 1.f : s, add(1.f, c));
  tau = s == 0.f ? s : q;
  h = mul(t, apq);
}

// One Jacobi rotation zeroing a[P][Q] of the symmetric a (every lane of the
// group holds all of it), accumulated into this lane's row of V. A zero
// pivot keeps every value; nothing branches on it.
template <int P, int Q>
__device__ __forceinline__ void rotate(float (&a)[4][4], float (&v)[4]) {
  const float apq = a[P][Q];
  const bool skip = apq == 0.f;
  float s, tau, h;
  rotation(a[P][P], a[Q][Q], skip ? 1.f : apq, s, tau, h);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (r == P || r == Q) continue;
    const float g = a[r][P];
    const float hh = a[r][Q];
    const float np = sub(g, mul(s, add(hh, mul(g, tau))));
    const float nq = add(hh, mul(s, sub(g, mul(hh, tau))));
    a[r][P] = skip ? g : np;
    a[P][r] = skip ? g : np;
    a[r][Q] = skip ? hh : nq;
    a[Q][r] = skip ? hh : nq;
  }
  const float app = a[P][P], aqq = a[Q][Q];
  a[P][P] = skip ? app : sub(app, h);
  a[Q][Q] = skip ? aqq : add(aqq, h);
  a[P][Q] = skip ? apq : 0.f;
  a[Q][P] = skip ? apq : 0.f;
  const float g = v[P], hh = v[Q];
  const float np = sub(g, mul(s, add(hh, mul(g, tau))));
  const float nq = add(hh, mul(s, sub(g, mul(hh, tau))));
  v[P] = skip ? g : np;
  v[Q] = skip ? hh : nq;
}

__global__ void __launch_bounds__(kThreads)
triangulate_kernel(const float* __restrict__ Rg, const float* __restrict__ tg,
                   const float* __restrict__ x1, const float* __restrict__ x2,
                   float* __restrict__ X, int n, int sweeps) {
  const int i = blockIdx.x * (kThreads / kLanes) + threadIdx.x / kLanes;
  const int r = threadIdx.x % kLanes;
  const int at = i < n ? i : n - 1;
  float P2[3][4];
#pragma unroll
  for (int row = 0; row < 3; ++row) {
#pragma unroll
    for (int c = 0; c < 3; ++c) P2[row][c] = Rg[3 * row + c];
    P2[row][3] = tg[row];
  }
  const float u1 = x1[2 * at], v1 = x1[2 * at + 1];
  const float u2 = x2[2 * at], v2 = x2[2 * at + 1];
  float A[4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float p12 = c == 2 ? 1.f : 0.f;
    A[0][c] = sub(mul(u1, p12), c == 0 ? 1.f : 0.f);
    A[1][c] = sub(mul(v1, p12), c == 1 ? 1.f : 0.f);
    A[2][c] = sub(mul(u2, P2[2][c]), P2[0][c]);
    A[3][c] = sub(mul(v2, P2[2][c]), P2[1][c]);
  }
  float a[4][4], v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int c = j; c < 4; ++c) {
      float m = mul(A[0][j], A[0][c]);
#pragma unroll
      for (int row = 1; row < 4; ++row) m = add(m, mul(A[row][j], A[row][c]));
      a[j][c] = m;
      a[c][j] = m;
    }
    v[j] = j == r ? 1.f : 0.f;
  }
  for (int s = 0; s < sweeps; ++s) {
    rotate<0, 1>(a, v);
    rotate<0, 2>(a, v);
    rotate<0, 3>(a, v);
    rotate<1, 2>(a, v);
    rotate<1, 3>(a, v);
    rotate<2, 3>(a, v);
  }
  float best = a[0][0];
  float e = v[0];
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    if (a[k][k] < best) {
      best = a[k][k];
      e = v[k];
    }
  }
  const float e3 = __shfl_sync(kFull, e, 3, kLanes);
  if (e3 < 0.f) e = -e;
  const float w3 = e3 < 0.f ? -e3 : e3;
  const float w = fabsf(w3) < kEps ? kEps : w3;
  if (i < n && r < 3) X[3 * i + r] = dvd(e, w);
}

}  // namespace

extern "C" int triangulate_dlt(const float* R, const float* t, const float* x1,
                               const float* x2, float* X, int n, int sweeps,
                               cudaStream_t stream) {
  if (n <= 0) return 0;
  constexpr int per_block = kThreads / kLanes;
  const int blocks = (n + per_block - 1) / per_block;
  triangulate_kernel<<<blocks, kThreads, 0, stream>>>(R, t, x1, x2, X, n,
                                                      sweeps);
  return static_cast<int>(cudaGetLastError());
}
