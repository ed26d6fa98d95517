// Scale-space extrema scans of the SIFT frontend: the fused scan + per-tile
// winner reduce (`extrema_winners`, the default path) and, further down, the
// full masked score map (`extrema_score`, under extrema_impl="pallas").
//
// Replaces visualslam_tpu/ops/pallas/extrema.py `pallas_extrema_candidates`
// (`_fused_kernel`, `_scored_tile`). For a DoG stack dog[B, 5, H, W] (f32,
// contiguous) it scores every position
//
//   score(l, y, x) = |dog|  if dog is strictly greater or strictly smaller
//                           than all 26 neighbours, |dog| > thr, and
//                           1 <= l <= 3, 1 <= y <= H-2, 1 <= x <= W-2
//                  = -1e30  otherwise
//
// and reduces each 16-row tile of each (level, column) to its best score and
// the row that holds it, ties going to the LARGEST row (so a column with no
// extremum reports row tile_h - 1). Output layout is the TPU kernel's winner
// array, flattened by the caller for top-k:
//   smax[B, n_tiles, 3, Wp] f32, srow[B, n_tiles, 3, Wp] i32,
// with n_tiles = ceil(H / tile_h) and Wp = W rounded up to 128 (the padded
// columns hold "no extremum"), so the selection that follows picks the same
// candidates, ties included, as the JAX package.
//
// Bound: memory. One pass over the DoG (16*5*376*1248*4 B ~ 150 MB for a
// 16-frame batch at octave 0) and ~0.1 of that out; ~27 compares per
// position. Design: one thread per (frame, tile, padded column). It walks the
// tile's 16 rows plus one halo row above and below, keeping a 3-row x 5-level
// x 3-column window in registers (each new row costs 15 loads, coalesced
// along W across the warp; the x-1/x+1 loads hit L1). No shared memory, no
// atomics, every output written once, so the result is exact: it equals the
// plain version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kLevels = 5;            // DoG levels per octave (scale_samples + 2)
constexpr int kInner = kLevels - 2;   // levels with a neighbour above and below
constexpr float kNone = -1e30f;       // score of "no extremum"
constexpr int kThreads = 128;

__device__ __forceinline__ void load_row(const float* __restrict__ frame,
                                         long long plane, int W, int y, int x,
                                         float (&r)[kLevels][3]) {
  const float* p = frame + (long long)y * W + x;
#pragma unroll
  for (int l = 0; l < kLevels; ++l) {
    const float* q = p + l * plane;
    r[l][0] = __ldg(q - 1);
    r[l][1] = __ldg(q);
    r[l][2] = __ldg(q + 1);
  }
}

__global__ void __launch_bounds__(kThreads)
extrema_winners_kernel(const float* __restrict__ dog, float* __restrict__ smax,
                       int* __restrict__ srow, int H, int W, int n_tiles,
                       int Wp, int tile_h, float thr) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= Wp) return;

  float best[kInner];
  int brow[kInner];
#pragma unroll
  for (int l = 0; l < kInner; ++l) {
    best[l] = kNone;
    brow[l] = tile_h - 1;
  }

  if (x >= 1 && x <= W - 2) {
    const long long plane = (long long)H * W;
    const float* frame = dog + (long long)b * kLevels * plane;
    const int ytop = t * tile_h;
    float r0[kLevels][3], r1[kLevels][3], r2[kLevels][3];
    // rows outside [0, H-1] are read clamped; every row they could affect
    // is outside [1, H-2] and so scores "no extremum"
    load_row(frame, plane, W, min(max(ytop - 1, 0), H - 1), x, r0);
    load_row(frame, plane, W, min(ytop, H - 1), x, r1);
    for (int r = 0; r < tile_h; ++r) {
      const int y = ytop + r;
      load_row(frame, plane, W, min(y + 1, H - 1), x, r2);
      const bool row_ok = y >= 1 && y <= H - 2;
#pragma unroll
      for (int l = 1; l <= kInner; ++l) {
        const float c = r1[l][1];
        bool gt = true, lt = true;
#pragma unroll
        for (int dl = -1; dl <= 1; ++dl) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float a = r0[l + dl][dx];
            const float e = r2[l + dl][dx];
            gt = gt && c > a && c > e;
            lt = lt && c < a && c < e;
            if (dl != 0 || dx != 1) {
              const float m = r1[l + dl][dx];
              gt = gt && c > m;
              lt = lt && c < m;
            }
          }
        }
        const float score = fabsf(c);
        const float val = (row_ok && (gt || lt) && score > thr) ? score : kNone;
        // >= : ties go to the later (larger) row
        if (val >= best[l - 1]) {
          best[l - 1] = val;
          brow[l - 1] = r;
        }
      }
#pragma unroll
      for (int l = 0; l < kLevels; ++l) {
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          r0[l][d] = r1[l][d];
          r1[l][d] = r2[l][d];
        }
      }
    }
  }

  const long long out = ((long long)b * n_tiles + t) * kInner * Wp + x;
#pragma unroll
  for (int l = 0; l < kInner; ++l) {
    smax[out + (long long)l * Wp] = best[l];
    srow[out + (long long)l * Wp] = brow[l];
  }
}

// ---------------------------------------------------------------------------
// Full masked score map (the reference's `extrema_impl="pallas"` arm).
//
// Replaces visualslam_tpu/ops/pallas/extrema.py `pallas_extrema_score`
// (`_score_kernel`, `_score_batched`). For dog[B, D, H, W] (f32, contiguous,
// D >= 3) it writes out[B, D, H, W] with the score above at every interior
// (l, y, x), 1 <= l <= D-2, and -1e30 everywhere else (levels 0 and D-1, the
// border rows and columns). No reduction: the top-k that follows reads the
// whole map.
//
// Bound: memory. It reads the stack once and writes a map of the same size
// (2 x 150 MB for a 16-frame batch at octave 0, ~90 us at 3.35 TB/s);
// ~27 compares per interior position. Design: one thread per (frame,
// column, strip of kStrip rows), the same sliding 3-row x D-level x 3-column
// register window as the winners kernel (D is a template parameter), and D
// stores per row, coalesced along W across the warp. The halo rows above and
// below a strip are read directly (no padded copy; L2 absorbs the 2/kStrip
// re-read). Compares and fabsf only: it equals the plain version bit for bit.
// ---------------------------------------------------------------------------

constexpr int kStrip = 16;            // rows per thread

template <int D>
__device__ __forceinline__ void load_row_d(const float* __restrict__ frame,
                                           long long plane, int W, int y,
                                           int x, float (&r)[D][3]) {
  const float* p = frame + (long long)y * W + x;
#pragma unroll
  for (int l = 0; l < D; ++l) {
    const float* q = p + l * plane;
    r[l][0] = __ldg(q - 1);
    r[l][1] = __ldg(q);
    r[l][2] = __ldg(q + 1);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
extrema_score_kernel(const float* __restrict__ dog, float* __restrict__ out,
                     int H, int W, float thr) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int ytop = blockIdx.y * kStrip;
  const int b = blockIdx.z;
  if (x >= W) return;
  const long long plane = (long long)H * W;
  const float* frame = dog + (long long)b * D * plane;
  float* oframe = out + (long long)b * D * plane + x;
  const int yend = min(ytop + kStrip, H);

  if (x < 1 || x > W - 2) {
    for (int y = ytop; y < yend; ++y) {
#pragma unroll
      for (int l = 0; l < D; ++l) oframe[l * plane + (long long)y * W] = kNone;
    }
    return;
  }

  float r0[D][3], r1[D][3], r2[D][3];
  // rows outside [0, H-1] are read clamped; every row they could affect is
  // outside [1, H-2] and so scores -1e30
  load_row_d<D>(frame, plane, W, min(max(ytop - 1, 0), H - 1), x, r0);
  load_row_d<D>(frame, plane, W, min(ytop, H - 1), x, r1);
  for (int y = ytop; y < yend; ++y) {
    load_row_d<D>(frame, plane, W, min(y + 1, H - 1), x, r2);
    const bool row_ok = y >= 1 && y <= H - 2;
    float* orow = oframe + (long long)y * W;
    orow[0] = kNone;
    orow[(D - 1) * plane] = kNone;
#pragma unroll
    for (int l = 1; l <= D - 2; ++l) {
      const float c = r1[l][1];
      bool gt = true, lt = true;
#pragma unroll
      for (int dl = -1; dl <= 1; ++dl) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float a = r0[l + dl][dx];
          const float e = r2[l + dl][dx];
          gt = gt && c > a && c > e;
          lt = lt && c < a && c < e;
          if (dl != 0 || dx != 1) {
            const float m = r1[l + dl][dx];
            gt = gt && c > m;
            lt = lt && c < m;
          }
        }
      }
      const float score = fabsf(c);
      orow[l * plane] = (row_ok && (gt || lt) && score > thr) ? score : kNone;
    }
#pragma unroll
    for (int l = 0; l < D; ++l) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        r0[l][d] = r1[l][d];
        r1[l][d] = r2[l][d];
      }
    }
  }
}

template <int D>
int launch_score(const float* dog, float* out, int B, int H, int W, float thr,
                 cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, (H + kStrip - 1) / kStrip, B);
  extrema_score_kernel<D><<<grid, kThreads, 0, stream>>>(dog, out, H, W, thr);
  return (int)cudaGetLastError();
}

}  // namespace

// dog, out: [B, D, H, W] f32 with 3 <= D <= 8 (the wrapper checks); thr is
// the pre-filter on |dog| (half the contrast threshold). Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for an unsupported D).
extern "C" int extrema_score(const float* dog, float* out, int B, int D,
                             int H, int W, float thr, cudaStream_t stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  switch (D) {
    case 3: return launch_score<3>(dog, out, B, H, W, thr, stream);
    case 4: return launch_score<4>(dog, out, B, H, W, thr, stream);
    case 5: return launch_score<5>(dog, out, B, H, W, thr, stream);
    case 6: return launch_score<6>(dog, out, B, H, W, thr, stream);
    case 7: return launch_score<7>(dog, out, B, H, W, thr, stream);
    case 8: return launch_score<8>(dog, out, B, H, W, thr, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dog: [B, 5, H, W] f32; smax/srow: [B, n_tiles, 3, Wp] with
// n_tiles = ceil(H / tile_h) and Wp a multiple of 128 that is >= W.
// thr is the pre-filter on |dog| (half the contrast threshold).
// Returns the cudaError_t of the launch.
extern "C" int extrema_winners(const float* dog, float* smax, int* srow, int B,
                               int H, int W, int n_tiles, int Wp, int tile_h,
                               float thr, cudaStream_t stream) {
  if (B == 0) return 0;
  const dim3 grid(Wp / kThreads, n_tiles, B);
  extrema_winners_kernel<<<grid, kThreads, 0, stream>>>(
      dog, smax, srow, H, W, n_tiles, Wp, tile_h, thr);
  return (int)cudaGetLastError();
}
