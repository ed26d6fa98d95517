// Per-keypoint sampling + soft histogram kernels of the SIFT frontend,
// reading the gradient levels in place.
//
// Replace visualslam_tpu/ops/pallas/descriptor.py `pallas_orient_hist`
// (`_orient_kernel`) and `pallas_descriptor` (`_desc_kernel`) applied to the
// patches that ops/patches.crop_patches cuts from the (optionally
// bf16-rounded) (mag, ori) level stack. The crop is a pure gather with edge
// replication, so these kernels take the levels themselves,
// mag[B, L, H, W] and ori[B, L, H, W] float32, and per keypoint its frame,
// gradient level and patch origin (y0, x0): patch tap (i, j) is level row
// y0 + i, column min(x0 + j, W - 1). Sample positions stay patch-relative
// and are clamped into the patch [0, ph-1] x [0, pw-1] exactly as the
// patch version does, so both sample the same values at the same positions.
//
//   orient_hist  the integer 16x16 window about yx (integer centres, so the
//                tent weights are one-hots), magnitude weighted by a Gaussian
//                of sigma[k] centred between the four middle samples, binned
//                into a circular soft histogram of nbins bins -> out[K, nbins]
//   descriptor   a 16x16 grid rotated by angle[k] about yx (float centres;
//                the rotation's cos and sin come in from the wrapper),
//                sampled bilinearly, magnitude times a spatial Gaussian of
//                sigma 8, the orientation taken relative to angle[k] mod
//                360, binned into 4x4 regions x 8 circular bins
//                -> out[K, 128], unnormalized
//
// Sampling uses the tent weights of ops/patches.tent_sample_patches:
// max(0, 1 - |p - tap|) on the two taps around p. With bf16 == 1 both
// channels are rounded to bf16 as they are read (__float2bfloat16_rn, the
// rounding of .to(torch.bfloat16)) and the y weights are rounded to bf16,
// as the TPU kernel's bf16 x bf16 product does; the x weights stay f32.
//
// What bounds it on the H100: by the roofline, bytes. A keypoint needs only
// the box of level samples its taps cover (orientation 16x16 for integer
// centres, the descriptor at most 24x24 for the rotated grid), 2 channels x
// 4 bytes, and does ~256 x 40 flops; at 16k keypoints per octave-0 batch
// that is ~33 MB / ~54 MB of reads against ~0.2 GFLOP. In practice the
// instructions per keypoint bound it (PERF.md), so the design spends as few
// as it can, with no block-wide barrier:
//   - one warp per keypoint, 8 samples per lane; a persistent grid (SMs x
//     resident blocks) of 4-warp blocks, each warp walking its keypoints;
//   - each keypoint's box of both channels is staged into the warp's
//     shared memory with cp.async, one 4-byte copy per sample (the right
//     edge replication is an index clamp), in a ring of two boxes, so the
//     next keypoint's box lands while the current one is binned; its
//     scalars are loaded one keypoint earlier still;
//   - a lane reads its samples' taps from the box (a tap outside the box,
//     which the box's margins rule out, is read from the level);
//   - each sample evaluates only the at most three bins its circular tent
//     reaches (the bins whose centre lies within 1.5 of its position, with
//     the same circular_tri as the plain version). The orientation
//     histogram: each lane adds its samples' values, in order, into its own
//     column of a [bin][lane] table in shared memory (stride 33: no bank
//     conflicts when a lane then sums a bin's row); lane l sums bins l and
//     l + 32 over the lanes in lane order. The descriptor: two lanes share
//     a 4x4 region, each keeps the region's 8 bins in registers for its 8
//     samples, and the pair's sums are added. No atomics, so every run
//     gives the same bits; the result differs from the plain version only
//     by summation order.
// No tensor cores: a keypoint is ~1k taps and ~1k adds, with no matrix
// product at a size where wgmma pays. The TPU kernels fed their matrix unit
// tent-weight products only because their vector unit could not gather.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kSide = 16;                     // window side
constexpr int kSamples = kSide * kSide;
constexpr int kLanes = 32;
constexpr int kPerLane = kSamples / kLanes;   // 8 samples per lane
constexpr int kWarps = 4;                     // warps (keypoints) per block
constexpr int kStages = 2;                    // boxes in flight per warp
constexpr int kMaxBins = 2 * kLanes;          // orientation bins: 2 per lane
constexpr int kDescWidth = 4;                 // descriptor regions per side
constexpr int kDescBins = 8;                  // descriptor bins per region
constexpr int kHistStride = kLanes + 1;       // [bin][lane] table row

// Box side the ring holds: integer orientation centres need 16 rows (17
// for a fractional centre, 18 with rounding room); the rotated grid up to
// 24 (2 x 7.5 sqrt 2 + 2, rounded up).
template <bool kDesc>
__host__ __device__ constexpr int box_side() { return kDesc ? 24 : 18; }

struct Params {
  const float* mag;       // [B, L, H, W]
  const float* ori;       // [B, L, H, W]
  const int* frame;       // [K]
  const int* glvl;        // [K]
  const int* y0;          // [K] patch origins
  const int* x0;          // [K]
  const float* yx;        // [K, 2] window centres
  const float* per_kp;    // [K] sigma (orientation) or angle (descriptor)
  const float* rot;       // [K, 2] (cos, sin) of angle (descriptor only)
  float* out;             // [K, slots]
  int K, B, L, H, W, ph, pw, nbins, slots;
};

// One keypoint's scalars and the box of patch rows [lo_r, lo_r + nr) x
// columns [lo_c, lo_c + nc) staged for it; ok == 0 for a keypoint past the
// end or with an index out of range (then nothing is staged or read).
struct Kp {
  long long plane;        // offset of its level in mag / ori
  int ok, y0, x0, lo_r, lo_c, nr, nc;
  float cy, cx, extra, c, s;   // centre, sigma or angle, cos, sin
};

// Keypoint k's scalars as loaded (every lane loads the same ones:
// broadcast loads), kept apart from `finish_kp` so that the loads can be
// issued a keypoint before their values are needed.
struct KpRaw {
  int valid, f, l, y0, x0;
  float cy, cx, extra, c, s;
};

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <bool kBf16>
__device__ __forceinline__ float round_value(float v) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// jnp.mod for a positive divisor: the truncated remainder, moved into
// [0, n). The remainder is exact: for a in (-n, 2n) it is a, or a - n
// (exact, a and n being within a factor of 2), which spares the general
// fmodf routine on every value this file passes.
__device__ __forceinline__ float mod_pos(float a, float n) {
  const float r =
      (a > -n && a < 2.f * n) ? (a >= n ? a - n : a) : fmodf(a, n);
  return r < 0.f ? r + n : r;
}

// circular tent weight of histogram position `pos` in bin `b` (centre b+0.5)
__device__ __forceinline__ float circular_tri(float pos, int b, int nbins) {
  const float half = 0.5f * nbins;
  const float d = mod_pos(pos - (b + 0.5f) + half, (float)nbins) - half;
  return fmaxf(0.f, 1.f - fabsf(d));
}

__device__ __forceinline__ float clampf(float v, float hi) {
  return fminf(fmaxf(v, 0.f), hi);
}

template <bool kDesc>
__device__ __forceinline__ KpRaw load_kp(const Params& p, int k) {
  KpRaw r = {};
  if (k >= p.K) return r;
  r.valid = 1;
  r.f = p.frame[k];
  r.l = p.glvl[k];
  r.y0 = p.y0[k];
  r.x0 = p.x0[k];
  r.cy = p.yx[2 * k];
  r.cx = p.yx[2 * k + 1];
  r.extra = p.per_kp[k];
  if (kDesc) {
    r.c = p.rot[2 * k];
    r.s = p.rot[2 * k + 1];
  }
  return r;
}

// The keypoint's range check and its box: rows from the floor of the least
// clamped sample position to the ceiling of the greatest, so every tap with
// a non-zero weight lies in it. The orientation window's positions are
// (yx + g) - y0 for g in -8..7, monotone in g, so its extremes are exact;
// the rotated grid's offsets are within 7.5 (|cos| + |sin|), taken with a
// margin for rounding.
template <bool kDesc>
__device__ Kp finish_kp(const Params& p, const KpRaw& r) {
  constexpr int kBox = box_side<kDesc>();
  Kp q = {};
  q.y0 = r.y0;
  q.x0 = r.x0;
  q.cy = r.cy;
  q.cx = r.cx;
  q.extra = r.extra;
  q.c = r.c;
  q.s = r.s;
  q.ok = r.valid && r.f >= 0 && r.f < p.B && r.l >= 0 && r.l < p.L &&
         r.y0 >= 0 && r.y0 <= p.H - p.ph && r.x0 >= 0 && r.x0 < p.W;
  if (!q.ok) return q;
  float lo = (float)(-kSide / 2), hi = (float)(kSide / 2 - 1);
  if (kDesc) {
    hi = 7.5f * (fabsf(r.c) + fabsf(r.s)) * (1.f + 1e-5f) + 1e-4f;
    lo = -hi;
  }
  q.plane = ((long long)r.f * p.L + r.l) * p.H * p.W;
  const float y0 = (float)q.y0, x0 = (float)q.x0;
  const float ymin = clampf((q.cy + lo) - y0, p.ph - 1.f);
  const float ymax = clampf((q.cy + hi) - y0, p.ph - 1.f);
  const float xmin = clampf((q.cx + lo) - x0, p.pw - 1.f);
  const float xmax = clampf((q.cx + hi) - x0, p.pw - 1.f);
  q.lo_r = (int)floorf(ymin);
  q.lo_c = (int)floorf(xmin);
  q.nr = min(min((int)ceilf(ymax), p.ph - 1) - q.lo_r + 1, kBox);
  q.nc = min(min((int)ceilf(xmax), p.pw - 1) - q.lo_c + 1, kBox);
  return q;
}

// The warp starts the copies of a keypoint's box (both channels) into
// `box` and commits them as one group; an empty group where there is
// nothing to copy keeps the group count in step with the ring.
template <int kBox>
__device__ void issue_box(const Params& p, const Kp& q, float* box,
                          int lane) {
  if (q.ok) {
    const int row0 = q.y0 + q.lo_r, col0 = q.x0 + q.lo_c;
    for (int e = lane; e < q.nr * kBox; e += kLanes) {
      const int r = e / kBox, j = e - r * kBox;
      if (j < q.nc) {
        const long long src =
            q.plane + (long long)(row0 + r) * p.W + min(col0 + j, p.W - 1);
        cp_async4(box + r * kBox + j, p.mag + src);
        cp_async4(box + kBox * kBox + r * kBox + j, p.ori + src);
      }
    }
  }
  cp_async_commit();
}

// Patch tap (i, j) of one channel read from the level itself.
__device__ __forceinline__ float level_tap(const float* level, const Kp& q,
                                           int i, int j, int W) {
  return level[(long long)(q.y0 + i) * W + min(q.x0 + j, W - 1)];
}

// Bilinear (mag, ori) at patch position (py, px), both already clamped into
// the patch, with the patch version's arithmetic; taps of weight 0 are
// skipped (they add exactly 0).
template <bool kBf16, int kBox>
__device__ __forceinline__ void sample(const Params& p, const float* box,
                                       const Kp& q, float py, float px,
                                       float& mag, float& ori) {
  const int i0 = (int)floorf(py);
  const int j0 = (int)floorf(px);
  float wy0 = fmaxf(0.f, 1.f - fabsf(py - (float)i0));
  float wy1 = fmaxf(0.f, 1.f - fabsf(py - (float)(i0 + 1)));
  if (kBf16) {
    wy0 = __bfloat162float(__float2bfloat16_rn(wy0));
    wy1 = __bfloat162float(__float2bfloat16_rn(wy1));
  }
  const float wx0 = fmaxf(0.f, 1.f - fabsf(px - (float)j0));
  const float wx1 = fmaxf(0.f, 1.f - fabsf(px - (float)(j0 + 1)));
  const bool use_i1 = i0 + 1 < p.ph && wy1 != 0.f;
  const bool use_j1 = j0 + 1 < p.pw && wx1 != 0.f;
  // every tap in the box (the box's margins make it so): read it there
  const int bi = i0 - q.lo_r, bj = j0 - q.lo_c;
  const bool boxed = bi >= 0 && bj >= 0 && bi + use_i1 < q.nr &&
                     bj + use_j1 < q.nc;
  float out[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float* bx = box + c * kBox * kBox + bi * kBox + bj;
    const float* lv = (c ? p.ori : p.mag) + q.plane;
    auto at = [&](int di, int dj) {
      return round_value<kBf16>(boxed ? bx[di * kBox + dj]
                                      : level_tap(lv, q, i0 + di, j0 + dj,
                                                  p.W));
    };
    float t0 = wy0 * at(0, 0);
    if (use_i1) t0 += wy1 * at(1, 0);
    float v = t0 * wx0;
    if (use_j1) {
      float t1 = wy0 * at(0, 1);
      if (use_i1) t1 += wy1 * at(1, 1);
      v += t1 * wx1;
    }
    out[c] = v;
  }
  mag = out[0];
  ori = out[1];
}

// Sample s of the window: (weight, histogram position) and its grid row
// and column.
template <bool kDesc, bool kBf16, int kBox>
__device__ __forceinline__ void weighted_sample(const Params& p,
                                                const float* box, const Kp& q,
                                                int s, float& w, float& pos) {
  float gy, gx, py, px;
  if (kDesc) {
    gy = (float)(s / kSide) - 0.5f * (kSide - 1);
    gx = (float)(s % kSide) - 0.5f * (kSide - 1);
    // Rounded exactly as the plain version's separate tensor ops (no FMA
    // contraction): bf16 rounds the y tent weights, which turns a one-ulp
    // difference in a sample position into a bf16 step in its weight, so
    // the positions have to agree bit for bit.
    const float ry = __fadd_rn(__fmul_rn(q.s, gx), __fmul_rn(q.c, gy));
    const float rx = __fsub_rn(__fmul_rn(q.c, gx), __fmul_rn(q.s, gy));
    py = (q.cy + ry) - (float)q.y0;
    px = (q.cx + rx) - (float)q.x0;
  } else {
    gy = (float)(s / kSide - kSide / 2);
    gx = (float)(s % kSide - kSide / 2);
    py = (q.cy + gy) - (float)q.y0;
    px = (q.cx + gx) - (float)q.x0;
  }
  py = clampf(py, p.ph - 1.f);
  px = clampf(px, p.pw - 1.f);
  float mag, ang;
  sample<kBf16, kBox>(p, box, q, py, px, mag, ang);
  if (kDesc) {
    const float rel = mod_pos(ang - q.extra, 360.f);
    const float half = 0.5f * kSide;
    w = mag * expf(-(gy * gy + gx * gx) / (2.f * half * half));
    pos = rel * ((float)p.nbins / 360.f);
  } else {
    const float sig = fmaxf(q.extra, 1e-6f);
    // the window offsets run -8..7; +0.5 centres the Gaussian between the
    // middle samples, as ops/histograms.gaussian_window does
    const float r2 = (gy + 0.5f) * (gy + 0.5f) + (gx + 0.5f) * (gx + 0.5f);
    w = mag * expf(-r2 / (2.f * sig * sig));
    pos = ang * ((float)p.nbins / 360.f);
  }
}

// The bin below the one pos falls in, and the three bins from there: the
// bins whose centre lies within 1.5 of pos, the only ones its tent reaches.
__device__ __forceinline__ int first_bin(float pos, int nbins) {
  int b0 = (int)floorf(pos);
  if (b0 < 0 || b0 >= 2 * nbins) {
    b0 %= nbins;
    b0 += b0 < 0 ? nbins : 0;
  }
  b0 -= b0 >= nbins ? nbins : 0;
  b0 -= 1;
  return b0 < 0 ? b0 + nbins : b0;
}

// One keypoint of the orientation histogram, by one warp: lane l takes
// samples l, l + 32, ... and adds their values into column l of `hist`
// ([bin][lane], zero on entry and on exit).
template <bool kBf16>
__device__ void orient_keypoint(const Params& p, int k, const float* box,
                                const Kp& q, float* hist, int lane) {
  constexpr int kBox = box_side<false>();
#pragma unroll 2
  for (int j = 0; j < kPerLane; ++j) {
    float w, pos;
    weighted_sample<false, kBf16, kBox>(p, box, q, lane + kLanes * j, w, pos);
    int bin = first_bin(pos, p.nbins);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      hist[bin * kHistStride + lane] += circular_tri(pos, bin, p.nbins) * w;
      bin = bin + 1 == p.nbins ? 0 : bin + 1;
    }
  }
  __syncwarp();
  for (int b = lane; b < p.nbins; b += kLanes) {
    float acc = 0.f;
    float* row = hist + b * kHistStride;
#pragma unroll 8
    for (int l = 0; l < kLanes; ++l) {
      acc += row[l];
      row[l] = 0.f;
    }
    p.out[(long long)k * p.slots + b] = acc;
  }
}

// One keypoint of the descriptor, by one warp: lanes 2r and 2r + 1 take
// the top and bottom halves of region r (a 4x4 block of the grid) and keep
// its 8 bins in registers.
template <bool kBf16>
__device__ void desc_keypoint(const Params& p, int k, const float* box,
                              const Kp& q, int lane) {
  constexpr int kBox = box_side<true>();
  const int region = lane >> 1, half = lane & 1;
  const int row0 = (region / kDescWidth) * 4 + 2 * half;
  const int col0 = (region % kDescWidth) * 4;
  float h[kDescBins];
#pragma unroll
  for (int b = 0; b < kDescBins; ++b) h[b] = 0.f;
#pragma unroll 2
  for (int j = 0; j < kPerLane; ++j) {
    const int s = (row0 + (j >> 2)) * kSide + col0 + (j & 3);
    float w, pos;
    weighted_sample<true, kBf16, kBox>(p, box, q, s, w, pos);
    int bin = first_bin(pos, kDescBins);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float v = circular_tri(pos, bin, kDescBins) * w;
#pragma unroll
      for (int b = 0; b < kDescBins; ++b) h[b] += b == bin ? v : 0.f;
      bin = bin + 1 == kDescBins ? 0 : bin + 1;
    }
  }
  // the pair's sums (a + b == b + a: both lanes hold the same bits); each
  // lane writes half of the region's bins
  float* out = p.out + (long long)k * p.slots + region * kDescBins;
#pragma unroll
  for (int b = 0; b < kDescBins; ++b) {
    const float sum = h[b] + __shfl_xor_sync(0xffffffffu, h[b], 1);
    if ((b >> 2) == half) out[b] = sum;
  }
}

// Shared memory of one warp: its ring of boxes and, for the orientation
// histogram, its [bin][lane] table.
template <bool kDesc>
__host__ __device__ constexpr int warp_floats(int nbins) {
  return kStages * 2 * box_side<kDesc>() * box_side<kDesc>() +
         (kDesc ? 0 : nbins * kHistStride);
}

template <bool kDesc, bool kBf16>
__global__ void __launch_bounds__(kWarps * kLanes)
patch_hist_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kBox = box_side<kDesc>();
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  float* box = smem + warp * warp_floats<kDesc>(p.nbins);
  float* hist = box + kStages * 2 * kBox * kBox;
  if (!kDesc)
    for (int t = lane; t < p.nbins * kHistStride; t += kLanes) hist[t] = 0.f;
  const int first = blockIdx.x * kWarps + warp, step = gridDim.x * kWarps;
  Kp cur = finish_kp<kDesc>(p, load_kp<kDesc>(p, first));
  issue_box<kBox>(p, cur, box, lane);
  // the scalars of the keypoint after next, loaded a keypoint ahead
  KpRaw next = load_kp<kDesc>(p, first + step);
  for (int it = 0, k = first; k < p.K; ++it, k += step) {
    const Kp ahead = finish_kp<kDesc>(p, next);
    float* stage = box + ((it + 1) % kStages) * 2 * kBox * kBox;
    issue_box<kBox>(p, ahead, stage, lane);
    next = load_kp<kDesc>(p, k + 2 * step);
    cp_async_wait<kStages - 1>();   // keypoint k's box has landed
    __syncwarp();
    const float* mine = box + (it % kStages) * 2 * kBox * kBox;
    if (!cur.ok) {
      for (int t = lane; t < p.slots; t += kLanes)
        p.out[(long long)k * p.slots + t] = __int_as_float(0x7fc00000);
    } else if (kDesc) {
      desc_keypoint<kBf16>(p, k, mine, cur, lane);
    } else {
      orient_keypoint<kBf16>(p, k, mine, cur, hist, lane);
    }
    __syncwarp();                   // before this stage is refilled
    cur = ahead;
  }
  cp_async_wait<0>();
}

template <bool kDesc, bool kBf16>
int launch(const Params& p, cudaStream_t stream) {
  if (p.K == 0) return 0;
  auto kern = patch_hist_kernel<kDesc, kBf16>;
  const size_t bytes =
      sizeof(float) * kWarps * (size_t)warp_floats<kDesc>(p.nbins);
  // the persistent grid: as many blocks as fit on the device at once,
  // asked once per device and shared-memory size
  static int cached_dev = -1, resident = 0;
  static size_t cached_bytes = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != cached_dev || bytes != cached_bytes) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                  kWarps * kLanes, bytes);
    resident = sms * std::max(per_sm, 1);
    cached_dev = dev;
    cached_bytes = bytes;
  }
  const int blocks = (p.K + kWarps - 1) / kWarps;
  const int grid = std::max(1, std::min(blocks, resident));
  kern<<<grid, kWarps * kLanes, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool kDesc>
int dispatch(const Params& p, int bf16, cudaStream_t stream) {
  return bf16 ? launch<kDesc, true>(p, stream)
              : launch<kDesc, false>(p, stream);
}

}  // namespace

// mag, ori: [B, L, H, W] f32; frame, glvl, y0, x0: [K] i32; yx: [K, 2] f32
// integer window centres; sigma: [K] f32; out: [K, nbins] f32, 3 <= nbins
// <= 64. ph, pw: the patch the positions are clamped into; bf16: round
// values and y weights to bf16. Returns the cudaError_t of the launch.
extern "C" int orient_hist(const float* mag, const float* ori,
                           const int* frame, const int* glvl, const int* y0,
                           const int* x0, const float* yx, const float* sigma,
                           float* out, int K, int B, int L, int H, int W,
                           int ph, int pw, int nbins, int bf16,
                           cudaStream_t stream) {
  if (nbins < 3 || nbins > kMaxBins) return (int)cudaErrorInvalidValue;
  const Params p = {mag, ori, frame, glvl, y0, x0, yx, sigma, nullptr,
                    out, K,   B,     L,    H,  W,  ph, pw, nbins, nbins};
  return dispatch<false>(p, bf16, stream);
}

// as above; yx: [K, 2] f32 float centres; angle: [K] f32 degrees; rot:
// [K, 2] f32 (cos, sin) of angle in radians; out: [K, 128] f32 (4 x 4
// regions x 8 bins). Returns the cudaError_t of the launch.
extern "C" int descriptor(const float* mag, const float* ori,
                          const int* frame, const int* glvl, const int* y0,
                          const int* x0, const float* yx, const float* angle,
                          const float* rot, float* out, int K, int B, int L,
                          int H, int W, int ph, int pw, int bf16,
                          cudaStream_t stream) {
  const Params p = {mag, ori, frame, glvl, y0, x0, yx, angle, rot, out,
                    K,   B,   L,     H,    W,  ph, pw, kDescBins,
                    kDescWidth * kDescWidth * kDescBins};
  return dispatch<true>(p, bf16, stream);
}
