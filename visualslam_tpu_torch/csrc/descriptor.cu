// Per-keypoint sampling + soft histogram kernels of the SIFT frontend
// (kernels 2 and 3 of the frontend slice).
//
// Replace visualslam_tpu/ops/pallas/descriptor.py `pallas_orient_hist`
// (`_orient_kernel`) and `pallas_descriptor` (`_desc_kernel`). Both read one
// (mag, ori) patch per keypoint, patches[K, 2, ph, pw] (f32 or bf16,
// contiguous) cropped at window origins (y0, x0), as produced by
// ops/patches.crop_patches:
//
//   orient_hist  the integer 16x16 window about yx (integer centres, so the
//                tent weights are one-hots), magnitude weighted by a Gaussian
//                of sigma[k] centred between the four middle samples, binned
//                into a circular soft histogram of nbins bins -> out[K, nbins]
//   descriptor   a 16x16 grid rotated by angle[k] about yx (float centres;
//                the rotation's cos and sin come in from the wrapper),
//                sampled bilinearly and clamped to the patch, magnitude times
//                a spatial Gaussian of sigma 8, the orientation taken
//                relative to angle[k] mod 360, binned into 4x4 regions x 8
//                circular bins -> out[K, 128], unnormalized
//
// Sampling uses the tent weights of ops/patches.tent_sample_patches:
// max(0, 1 - |p - tap|) on the two taps around p. For bf16 patches the y
// weights are rounded to bf16 first, as the TPU kernel's bf16 x bf16
// product does; the x weights stay f32.
//
// Bound: neither bytes nor FLOPs at these sizes -- each keypoint reads only
// the few patch rows its grid touches (a 16x16 grid, 4 taps per sample) and
// does ~256 x 12 multiply-adds; the launch is 16k keypoints per octave-0
// batch. Design: one block per keypoint, one thread per sample. Each thread
// samples its point and parks (bin position, weight) in shared memory; then
// one thread per output bin sums the circular tent contributions of the
// samples that can reach it, in a fixed sample order. No atomics, so the
// result is the same on every run; it differs from the plain version only by
// summation order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSide = 16;                  // window side
constexpr int kSamples = kSide * kSide;    // one thread per sample

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ float y_weight(float w) { return w; }
template <>
__device__ __forceinline__ float y_weight<__nv_bfloat16>(float w) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

// jnp.mod for a positive divisor: the truncated remainder, moved into [0, n)
__device__ __forceinline__ float mod_pos(float a, float n) {
  const float r = fmodf(a, n);
  return r < 0.f ? r + n : r;
}

// circular tent weight of histogram position `pos` in bin `b` (centre b+0.5)
__device__ __forceinline__ float circular_tri(float pos, int b, int nbins) {
  const float half = 0.5f * nbins;
  const float d = mod_pos(pos - (b + 0.5f) + half, (float)nbins) - half;
  return fmaxf(0.f, 1.f - fabsf(d));
}

// Bilinear (mag, ori) of one [2, ph, pw] patch at (py, px), both already
// clamped into the patch.
template <typename T>
__device__ __forceinline__ void sample(const T* __restrict__ patch, int ph,
                                       int pw, float py, float px, float& mag,
                                       float& ori) {
  const int i0 = (int)floorf(py);
  const int j0 = (int)floorf(px);
  const bool has_i1 = i0 + 1 < ph;
  const bool has_j1 = j0 + 1 < pw;
  const float wy0 = y_weight<T>(fmaxf(0.f, 1.f - fabsf(py - (float)i0)));
  const float wy1 = y_weight<T>(fmaxf(0.f, 1.f - fabsf(py - (float)(i0 + 1))));
  const float wx0 = fmaxf(0.f, 1.f - fabsf(px - (float)j0));
  const float wx1 = fmaxf(0.f, 1.f - fabsf(px - (float)(j0 + 1)));
  const long long chan = (long long)ph * pw;
  float out[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const T* row0 = patch + c * chan + (long long)i0 * pw;
    const T* row1 = row0 + pw;
    float t0 = wy0 * to_f32(row0[j0]);
    if (has_i1) t0 += wy1 * to_f32(row1[j0]);
    float v = t0 * wx0;
    if (has_j1) {
      float t1 = wy0 * to_f32(row0[j0 + 1]);
      if (has_i1) t1 += wy1 * to_f32(row1[j0 + 1]);
      v += t1 * wx1;
    }
    out[c] = v;
  }
  mag = out[0];
  ori = out[1];
}

template <typename T>
__global__ void __launch_bounds__(kSamples)
orient_hist_kernel(const T* __restrict__ patches, const int* __restrict__ y0,
                   const int* __restrict__ x0, const float* __restrict__ yx,
                   const float* __restrict__ sigma, float* __restrict__ out,
                   int ph, int pw, int nbins) {
  __shared__ float s_pos[kSamples];
  __shared__ float s_w[kSamples];
  const int k = blockIdx.x;
  const int s = threadIdx.x;
  const float gy = (float)(s / kSide - kSide / 2);
  const float gx = (float)(s % kSide - kSide / 2);
  float py = (yx[2 * k] + gy) - (float)y0[k];
  float px = (yx[2 * k + 1] + gx) - (float)x0[k];
  py = fminf(fmaxf(py, 0.f), ph - 1.f);
  px = fminf(fmaxf(px, 0.f), pw - 1.f);
  float mag, ang;
  sample(patches + (long long)k * 2 * ph * pw, ph, pw, py, px, mag, ang);
  const float sig = fmaxf(sigma[k], 1e-6f);
  // the window offsets run -8..7; +0.5 centres the Gaussian between the
  // middle samples, as ops/histograms.gaussian_window does
  const float r2 = (gy + 0.5f) * (gy + 0.5f) + (gx + 0.5f) * (gx + 0.5f);
  s_w[s] = mag * expf(-r2 / (2.f * sig * sig));
  s_pos[s] = ang * ((float)nbins / 360.f);
  __syncthreads();
  for (int b = s; b < nbins; b += kSamples) {
    float acc = 0.f;
    for (int i = 0; i < kSamples; ++i)
      acc += circular_tri(s_pos[i], b, nbins) * s_w[i];
    out[(long long)k * nbins + b] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kSamples)
descriptor_kernel(const T* __restrict__ patches, const int* __restrict__ y0,
                  const int* __restrict__ x0, const float* __restrict__ yx,
                  const float* __restrict__ angle,
                  const float* __restrict__ rot, float* __restrict__ out,
                  int ph, int pw, int width, int nbins) {
  __shared__ float s_pos[kSamples];
  __shared__ float s_w[kSamples];
  const int k = blockIdx.x;
  const int s = threadIdx.x;
  const float gy = (float)(s / kSide) - 0.5f * (kSide - 1);
  const float gx = (float)(s % kSide) - 0.5f * (kSide - 1);
  const float a = angle[k];
  const float c = rot[2 * k];
  const float sn = rot[2 * k + 1];
  // Rounded exactly as the plain version's separate tensor ops (no FMA
  // contraction): bf16 patches round the y tent weights to bf16, which
  // turns a one-ulp difference in a sample position into a bf16 step in
  // its weight, so the positions have to agree bit for bit.
  const float ry = __fadd_rn(__fmul_rn(sn, gx), __fmul_rn(c, gy));
  const float rx = __fsub_rn(__fmul_rn(c, gx), __fmul_rn(sn, gy));
  float py = (yx[2 * k] + ry) - (float)y0[k];
  float px = (yx[2 * k + 1] + rx) - (float)x0[k];
  py = fminf(fmaxf(py, 0.f), ph - 1.f);
  px = fminf(fmaxf(px, 0.f), pw - 1.f);
  float mag, ang;
  sample(patches + (long long)k * 2 * ph * pw, ph, pw, py, px, mag, ang);
  const float rel = mod_pos(ang - a, 360.f);
  const float half = 0.5f * kSide;
  s_w[s] = mag * expf(-(gy * gy + gx * gx) / (2.f * half * half));
  s_pos[s] = rel * ((float)nbins / 360.f);
  __syncthreads();
  const int cell = kSide / width;
  const int D = width * width * nbins;
  for (int slot = s; slot < D; slot += kSamples) {
    const int region = slot / nbins;
    const int b = slot % nbins;
    const int r0 = (region / width) * cell;
    const int c0 = (region % width) * cell;
    float acc = 0.f;
    for (int i = 0; i < cell; ++i)
      for (int j = 0; j < cell; ++j) {
        const int idx = (r0 + i) * kSide + c0 + j;
        acc += circular_tri(s_pos[idx], b, nbins) * s_w[idx];
      }
    out[(long long)k * D + slot] = acc;
  }
}

}  // namespace

// patches: [K, 2, ph, pw], f32 (bf16 == 0) or bf16 (bf16 == 1); y0, x0: [K]
// i32 patch origins; yx: [K, 2] f32 window centres (integers); sigma: [K]
// f32; out: [K, nbins] f32. Returns the cudaError_t of the launch.
extern "C" int orient_hist(const void* patches, int bf16, const int* y0,
                           const int* x0, const float* yx, const float* sigma,
                           float* out, int K, int ph, int pw, int nbins,
                           cudaStream_t stream) {
  if (K == 0) return 0;
  if (bf16)
    orient_hist_kernel<<<K, kSamples, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(patches), y0, x0, yx, sigma, out, ph,
        pw, nbins);
  else
    orient_hist_kernel<<<K, kSamples, 0, stream>>>(
        static_cast<const float*>(patches), y0, x0, yx, sigma, out, ph, pw,
        nbins);
  return (int)cudaGetLastError();
}

// patches as above; yx: [K, 2] f32 float centres; angle: [K] f32 degrees;
// rot: [K, 2] f32 (cos, sin) of angle in radians; out:
// [K, width*width*nbins] f32. Returns the cudaError_t of the launch.
extern "C" int descriptor(const void* patches, int bf16, const int* y0,
                          const int* x0, const float* yx, const float* angle,
                          const float* rot, float* out, int K, int ph, int pw,
                          int width, int nbins, cudaStream_t stream) {
  if (K == 0) return 0;
  if (bf16)
    descriptor_kernel<<<K, kSamples, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(patches), y0, x0, yx, angle, rot,
        out, ph, pw, width, nbins);
  else
    descriptor_kernel<<<K, kSamples, 0, stream>>>(
        static_cast<const float*>(patches), y0, x0, yx, angle, rot, out, ph,
        pw, width, nbins);
  return (int)cudaGetLastError();
}
