// Multi-sigma separable Gaussian blur (the scale-space pyramid under
// blur_mode="pallas").
//
// Replaces visualslam_tpu/ops/pallas/blur.py `pallas_blur_stack`
// (`_conv_pass` with `_vconv_2d_kernel` / `_vconv_3d_kernel`). For frames
// img[B, H, W] (f32, contiguous) and a tap table taps[S, K] (each sigma's
// normalized taps centred and zero-padded to the largest radius R,
// K = 2R + 1) it computes out[B, S, H, W]:
//
//   tmp[b, s, y, x] = sum_k taps[s, k] * img[b, sym(y + k - R, H), x]
//   out[b, s, y, x] = sum_k taps[s, k] * tmp[b, s, y, sym(x + k - R, W)]
//
// y pass first, then x pass, as the TPU kernel; sym() is numpy's
// "symmetric" pad (the edge sample repeats, reflecting again past 2n).
// Every sum runs in tap order k = 0 .. K-1 with a rounded product and a
// rounded add per tap (__fmul_rn / __fadd_rn, no FMA contraction), the
// plain version's arithmetic: the two agree bit for bit.
//
// Bound: memory, then shared-memory issue. Per 376 x 1248 frame at octave 0
// the two passes move ~36 MB (frame in, S planes out, S planes in and out)
// for ~0.5 GFLOP. The TPU kernel transposes between passes because its
// lane-shifted slices are expensive; here both passes read shared memory
// directly, so there is no transpose and no padded copy: each block stages
// its slab once through the symmetric index map. Pass y stages kYH + 2R
// rows of a 32-column strip and writes all S sigma planes from that one
// slab (each thread: 4 rows x S sigmas in registers, 10 shared loads per
// 24 multiply-adds at S = 6). Pass x stages kXW + 2R columns of 8 rows of
// one (frame, sigma) plane.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxS = 8;           // sigmas per launch the kernels hold
constexpr int kThreads = 256;
// pass y: 32 columns x 8 thread rows, 4 output rows per thread
constexpr int kYW = 32, kYRows = 4, kYH = 8 * kYRows;
// pass x: 128 columns x 2 thread rows, 4 output rows per thread
constexpr int kXW = 128, kXRows = 4, kXH = 2 * kXRows;

__device__ __forceinline__ int sym(int i, int n) {
  const int p = 2 * n;
  int m = i % p;
  if (m < 0) m += p;
  return m < n ? m : p - 1 - m;
}

// img: [B, H, W]; tmp: [B, S, H, W]. Shared: slab[kYH + 2R][kYW], taps[S*K].
__global__ void __launch_bounds__(kThreads)
blur_y_kernel(const float* __restrict__ img, const float* __restrict__ taps,
              float* __restrict__ tmp, int H, int W, int S, int K) {
  extern __shared__ float smem[];
  const int R = (K - 1) / 2;
  float* slab = smem;
  float* tp = slab + (kYH + 2 * R) * kYW;
  const int b = blockIdx.z;
  const int col0 = blockIdx.x * kYW;
  const int row0 = blockIdx.y * kYH;
  const int tid = threadIdx.x;
  const float* src = img + (long long)b * H * W;

  for (int e = tid; e < S * K; e += kThreads) tp[e] = taps[e];
  for (int e = tid; e < (kYH + 2 * R) * kYW; e += kThreads) {
    const int r = e / kYW, c = e % kYW;
    const int x = col0 + c;
    slab[e] = x < W ? src[(long long)sym(row0 - R + r, H) * W + x] : 0.f;
  }
  __syncthreads();

  const int tx = tid % kYW;
  const int ty = tid / kYW;                 // output rows ty*4 .. ty*4+3
  float acc[kMaxS][kYRows];
#pragma unroll
  for (int s = 0; s < kMaxS; ++s)
#pragma unroll
    for (int i = 0; i < kYRows; ++i) acc[s][i] = 0.f;
  for (int k = 0; k < K; ++k) {
    float v[kYRows];
#pragma unroll
    for (int i = 0; i < kYRows; ++i) v[i] = slab[(ty * kYRows + i + k) * kYW + tx];
#pragma unroll
    for (int s = 0; s < kMaxS; ++s) {
      if (s < S) {
        const float t = tp[s * K + k];
#pragma unroll
        for (int i = 0; i < kYRows; ++i)
          acc[s][i] = __fadd_rn(acc[s][i], __fmul_rn(t, v[i]));
      }
    }
  }

  const int x = col0 + tx;
  if (x >= W) return;
#pragma unroll
  for (int s = 0; s < kMaxS; ++s) {
    if (s >= S) break;
#pragma unroll
    for (int i = 0; i < kYRows; ++i) {
      const int y = row0 + ty * kYRows + i;
      if (y < H) tmp[(((long long)b * S + s) * H + y) * W + x] = acc[s][i];
    }
  }
}

// tmp, out: [B, S, H, W]; blockIdx.z = b * S + s. Shared:
// slab[kXH][kXW + 2R], taps[K].
__global__ void __launch_bounds__(kThreads)
blur_x_kernel(const float* __restrict__ tmp, const float* __restrict__ taps,
              float* __restrict__ out, int H, int W, int S, int K) {
  extern __shared__ float smem[];
  const int R = (K - 1) / 2;
  const int SW = kXW + 2 * R;
  float* slab = smem;
  float* tp = slab + kXH * SW;
  const long long plane = (long long)blockIdx.z * H * W;
  const int s = blockIdx.z % S;
  const int col0 = blockIdx.x * kXW;
  const int row0 = blockIdx.y * kXH;
  const int tid = threadIdx.x;

  for (int e = tid; e < K; e += kThreads) tp[e] = taps[s * K + e];
  for (int e = tid; e < kXH * SW; e += kThreads) {
    const int r = e / SW, c = e % SW;
    const int y = row0 + r;
    slab[e] = y < H ? tmp[plane + (long long)y * W + sym(col0 - R + c, W)] : 0.f;
  }
  __syncthreads();

  const int tx = tid % kXW;
  const int ty = tid / kXW;                 // output rows ty, ty+2, ty+4, ty+6
  float acc[kXRows];
#pragma unroll
  for (int j = 0; j < kXRows; ++j) acc[j] = 0.f;
  for (int k = 0; k < K; ++k) {
    const float t = tp[k];
#pragma unroll
    for (int j = 0; j < kXRows; ++j)
      acc[j] = __fadd_rn(acc[j], __fmul_rn(t, slab[(2 * j + ty) * SW + tx + k]));
  }

  const int x = col0 + tx;
  if (x >= W) return;
#pragma unroll
  for (int j = 0; j < kXRows; ++j) {
    const int y = row0 + 2 * j + ty;
    if (y < H) out[plane + (long long)y * W + x] = acc[j];
  }
}

}  // namespace

// img: [B, H, W] f32; taps: [S, K] f32 with S <= 8 and K odd; tmp and out:
// [B, S, H, W] f32 (tmp is scratch: the y pass's result). Returns the
// cudaError_t of the launches.
extern "C" int blur_stack(const float* img, const float* taps, float* tmp,
                          float* out, int B, int H, int W, int S, int K,
                          cudaStream_t stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  if (S < 1 || S > kMaxS || K % 2 == 0) return (int)cudaErrorInvalidValue;
  const int R = (K - 1) / 2;
  const int smem_y = (int)sizeof(float) * ((kYH + 2 * R) * kYW + S * K);
  const int smem_x = (int)sizeof(float) * (kXH * (kXW + 2 * R) + K);
  cudaError_t err = cudaFuncSetAttribute(
      blur_y_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_y);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      blur_x_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_x);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_y((W + kYW - 1) / kYW, (H + kYH - 1) / kYH, B);
  blur_y_kernel<<<grid_y, kThreads, smem_y, stream>>>(img, taps, tmp, H, W, S, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_x((W + kXW - 1) / kXW, (H + kXH - 1) / kXH, B * S);
  blur_x_kernel<<<grid_x, kThreads, smem_x, stream>>>(tmp, taps, out, H, W, S, K);
  return (int)cudaGetLastError();
}
