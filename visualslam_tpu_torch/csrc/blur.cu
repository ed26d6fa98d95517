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
// Every sum runs in tap order with a rounded product and a rounded add per
// tap (__fmul_rn / __fadd_rn, no FMA contraction), the plain version's
// arithmetic. The kernel skips the zero taps outside each sigma's span:
// adding 0 * x leaves a finite sum unchanged, so the two agree bit for bit.
//
// Bound: arithmetic. At octave 0 of a 16-frame batch (376 x 1248, six
// sigmas, 162 non-zero taps of 258) the output is 180 MB against 30 MB in
// (0.063 ms at 3.35 TB/s), but the taps are 2.4 G multiply-adds, and with
// the multiply and the add rounded apart they are 4.9 G f32 instructions
// (0.146 ms at 33.5 T instructions/s). Design: one launch; a block owns a
// 32-row x 128-column output tile of one frame and every sigma of it. It
// computes the symmetric index maps of its rows and columns once, stages
// the (32 + 2R) x (128 + 2R) input slab once with cp.async, and per sigma
// runs the y pass over only that sigma's non-zero taps into a shared
// [32][128 + 2R_s] intermediate (each thread a column and 8 rows from a
// register window), then the x pass from it (each thread 8 adjacent
// outputs from a register window; lanes on rows, at an odd stride, so the
// loads hit 32 banks), and stores the tile with float4 where W % 4 == 0.
// The y pass never reaches device memory. Each sigma's span is found by
// scanning its row of the tap table, so the caller passes no radius list.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxS = 8;           // sigmas per launch (the table's rows)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTH = 32, kTW = 128; // output tile: rows x columns
constexpr int kRY = 8;             // y pass: output rows per thread
constexpr int kRX = 8;             // x pass: output columns per thread
constexpr int kMaxDevices = 64;
static_assert(kTH == 32, "the x pass puts one tile row on each lane");
static_assert(kTW / kRX == 2 * kWarps, "the x pass: two column groups per warp");

__device__ __forceinline__ int sym(int i, int n) {
  const int p = 2 * n;
  int m = i % p;
  if (m < 0) m += p;
  return m < n ? m : p - 1 - m;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// slab width (columns) and intermediate stride for radius R
__host__ __device__ __forceinline__ int slab_w(int R) { return kTW + 2 * R; }
__host__ __device__ __forceinline__ int inter_w(int R) { return (kTW + 2 * R) | 1; }

// Dynamic shared memory, in 4-byte words: slab [kTH + 2R + 1][slab_w]
// (one spare row the y window reads past its last tap), inter
// [kTH][inter_w], rowmap [kTH + 2R], colmap [slab_w], taps [S * K].
__host__ __device__ __forceinline__ int smem_words(int R, int S, int K) {
  return (kTH + 2 * R + 1) * slab_w(R) + kTH * inter_w(R) + (kTH + 2 * R) +
         slab_w(R) + S * K;
}

__global__ void __launch_bounds__(kThreads)
blur_stack_kernel(const float* __restrict__ img, const float* __restrict__ taps,
                  float* __restrict__ out, int H, int W, int S, int K) {
  extern __shared__ float smem[];
  __shared__ int span_lo[kMaxS], span_n[kMaxS];
  const int R = (K - 1) / 2;
  const int SW = slab_w(R), TS = inter_w(R);
  float* slab = smem;
  float* inter = slab + (kTH + 2 * R + 1) * SW;
  int* rowmap = reinterpret_cast<int*>(inter + kTH * TS);
  int* colmap = rowmap + kTH + 2 * R;
  float* tp = reinterpret_cast<float*>(colmap + SW);

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH;
  const int tw = min(kTW, W - x0), th = min(kTH, H - y0);   // valid outputs
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // index maps and taps, once per block
  for (int e = tid; e < th + 2 * R; e += kThreads) rowmap[e] = sym(y0 - R + e, H);
  for (int e = tid; e < tw + 2 * R; e += kThreads) colmap[e] = sym(x0 - R + e, W);
  for (int e = tid; e < S * K; e += kThreads) tp[e] = taps[e];
  __syncthreads();
  if (tid < S) {
    int lo = K, hi = -1;
    for (int k = 0; k < K; ++k) {
      if (tp[tid * K + k] != 0.f) {
        lo = min(lo, k);
        hi = k;
      }
    }
    span_lo[tid] = hi < 0 ? 0 : lo;
    span_n[tid] = hi < 0 ? 0 : hi - lo + 1;
  }
  // the slab: rows y0 - R .. y0 + th + R - 1, columns x0 - R .. x0 + tw + R - 1
  const float* src = img + (long long)b * H * W;
  for (int r = warp; r < th + 2 * R; r += kWarps) {
    const float* line = src + (long long)rowmap[r] * W;
    for (int c = lane; c < tw + 2 * R; c += 32)
      cp_async4(&slab[r * SW + c], line + colmap[c]);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const bool vec = W % 4 == 0;
  for (int s = 0; s < S; ++s) {
    const int lo = span_lo[s], n = span_n[s];
    const float* t = tp + s * K + lo;

    // y pass: inter[y][j] = sum_k t[k] * slab[y + lo + k][lo + j] for the
    // columns j < tw + n - 1 the x pass reads; one column x kRY rows each
    const int width = tw + max(n - 1, 0);
    const int groups = (th + kRY - 1) / kRY;
    for (int e = tid; e < groups * width; e += kThreads) {
      const int grp = e / width, j = e - grp * width;
      const float* col = slab + (grp * kRY + lo) * SW + lo + j;
      float w[kRY], acc[kRY];
#pragma unroll
      for (int i = 0; i < kRY; ++i) {
        w[i] = col[i * SW];
        acc[i] = 0.f;
      }
#pragma unroll 8
      for (int k = 0; k < n; ++k) {
        const float tk = t[k];
#pragma unroll
        for (int i = 0; i < kRY; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(tk, w[i]));
#pragma unroll
        for (int i = 0; i < kRY - 1; ++i) w[i] = w[i + 1];
        w[kRY - 1] = col[(k + kRY) * SW];
      }
#pragma unroll
      for (int i = 0; i < kRY; ++i) inter[(grp * kRY + i) * TS + j] = acc[i];
    }
    __syncthreads();

    // x pass: out[y][x] = sum_k t[k] * inter[y][x + k]; lane = row, warp =
    // column group (two per warp), kRX adjacent outputs each
    float* dst = out + (((long long)b * S + s) * H + y0 + lane) * W + x0;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int xg = (warp + kWarps * m) * kRX;
      if (xg >= tw) continue;
      const float* row = inter + lane * TS + xg;
      float w[kRX], acc[kRX];
#pragma unroll
      for (int i = 0; i < kRX; ++i) {
        w[i] = row[i];
        acc[i] = 0.f;
      }
#pragma unroll 8
      for (int k = 0; k < n; ++k) {
        const float tk = t[k];
#pragma unroll
        for (int i = 0; i < kRX; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(tk, w[i]));
#pragma unroll
        for (int i = 0; i < kRX - 1; ++i) w[i] = w[i + 1];
        w[kRX - 1] = row[k + kRX];
      }
      if (lane >= th) continue;
      if (vec && xg + kRX <= tw) {
        reinterpret_cast<float4*>(dst + xg)[0] =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
        reinterpret_cast<float4*>(dst + xg)[1] =
            make_float4(acc[4], acc[5], acc[6], acc[7]);
      } else {
#pragma unroll
        for (int i = 0; i < kRX; ++i)
          if (xg + i < tw) dst[xg + i] = acc[i];
      }
    }
    __syncthreads();                 // inter is rewritten by the next sigma
  }
}

}  // namespace

// img: [B, H, W] f32; taps: [S, K] f32 with 1 <= S <= 8 and K odd; out:
// [B, S, H, W] f32. One launch, no scratch; returns its cudaError_t.
extern "C" int blur_stack(const float* img, const float* taps, float* out,
                          int B, int H, int W, int S, int K,
                          cudaStream_t stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  if (S < 1 || S > kMaxS || K % 2 == 0 || K < 1) return (int)cudaErrorInvalidValue;
  // the attribute is per device: set it once per process, to the most a
  // block may opt in to
  static int limit[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (limit[dev] == 0) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, blur_stack_kernel);
    if (err != cudaSuccess) return (int)err;
    const int dynamic = optin - (int)fa.sharedSizeBytes;   // static counts too
    err = cudaFuncSetAttribute(blur_stack_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
    if (err != cudaSuccess) return (int)err;
    limit[dev] = dynamic;
  }
  const int R = (K - 1) / 2;
  const int smem = (int)sizeof(float) * smem_words(R, S, K);
  if (smem > limit[dev]) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  blur_stack_kernel<<<grid, kThreads, smem, stream>>>(img, taps, out, H, W, S, K);
  return (int)cudaGetLastError();
}
