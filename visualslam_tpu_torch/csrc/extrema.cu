// Scale-space extrema scans of the SIFT frontend: the fused scan + per-tile
// winner reduce (`extrema_winners`, the default path) and the full masked
// score map (`extrema_score`, under extrema_impl="pallas"). One loader and
// one compare body serve both.
//
// Replaces visualslam_tpu/ops/pallas/extrema.py `pallas_extrema_candidates`
// (`_fused_kernel`, `_scored_tile`) and `pallas_extrema_score`
// (`_score_kernel`, `_score_batched`). For a DoG stack dog[B, D, H, W] (f32,
// contiguous) both score every position
//
//   score(l, y, x) = |dog|  if dog is strictly greater or strictly smaller
//                           than all 26 neighbours, |dog| > thr, and
//                           1 <= l <= D-2, 1 <= y <= H-2, 1 <= x <= W-2
//                  = -1e30  otherwise.
//
// `extrema_winners` (D = 5) reduces each 16-row tile of each (level, column)
// to its best score and the row that holds it, ties going to the LARGEST row
// (a column with no extremum reports row 15), in the TPU kernel's winner
// layout smax[B, n_tiles, 3, Wp] f32, srow[B, n_tiles, 3, Wp] i32 with
// n_tiles = ceil(H / 16) and Wp = W rounded up to 128 (the padded columns
// hold "no extremum"), so the top-k that follows picks the same candidates,
// ties included, as the JAX package. `extrema_score` (3 <= D <= 8) writes
// the score itself to out[B, D, H, W]: -1e30 on levels 0 and D-1 and on the
// border rows and columns.
//
// Bound: memory. Each reads the stack once (16 x 5 x 376 x 1248 x 4 B =
// 150 MB for a 16-frame batch at octave 0); the winners write ~8% of that,
// the score map as much again. At 3.35 TB/s: 0.048 / 0.090 ms at octave 0.
//
// Design. A block of 128 threads owns a strip of 128 columns and a band of
// 16 rows (one winner tile) of one frame. It streams the band's 18 rows,
// halo included, through a ring of kStages shared-memory stages, each one
// row of all D levels with a halo column on either side ([D][136] floats,
// column j holding x0 - 4 + j). All 128 threads copy with cp.async: 16-byte
// copies where a frame's rows are 16-byte aligned (W % 4 == 0 and an
// aligned base), one 4-byte copy per float otherwise; kStages - 1 rows are
// in flight. A stage is published by cp.async.wait_group and one
// __syncthreads per row, which also tells every thread that the stage read
// one row earlier is free for the next copy. So every global byte reaches
// shared memory once per band and the x-1 / x / x+1 neighbours come from
// there. (Taller bands, 32 or 64 rows per block, read fewer halo rows but
// were slower on the H100 at octaves 0 and 2 of the main path and no faster
// at octave 1: the halo rows come from L2, and a taller band lengthens each
// block's serial walk.) The walk is unrolled over the band's rows, so every
// stage index is a constant.
//
// Each thread keeps its column's window in registers as partial extremes,
// not as raw values: per level the max / min over the 3 columns of a row,
// folded over two rows, and per inner level the max / min of the row's
// left and right neighbours. The 26 compares of a position then become
//   c > max(26 neighbours)  or  c < min(26 neighbours)
// with the row extremes shared by the three levels that read them. The max
// and min are PTX's NaN-propagating max.NaN / min.NaN: the compare is false
// wherever one of the 26 compares would be false (a NaN neighbour included),
// and a zero of either sign compares alike, so the result is that of the 26
// compares, bit for bit.
//
// Rows and columns outside the image are zero-filled by the copies, as the
// TPU kernel pads. Every position whose 3x3x3 window touches one is outside
// [1, H-2] x [1, W-2] and is masked to -1e30 whatever the window holds: the
// bits stay those of the plain version (ops/cuda/extrema.py `extrema_winners_ref`,
// `extrema_score_ref`). The winners go out once per tile and column; the
// score map's inner rows once per row, coalesced along W, and its levels 0
// and D-1 as constants while the band's first loads are in flight (16-byte
// stores on the aligned path). No atomics: the result does not depend on
// the schedule.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWinnerLevels = 5;      // DoG levels of a winners call
constexpr int kTile = 16;             // rows per block = winner tile height
constexpr int kRows = kTile + 2;      // rows a block loads, halo included
constexpr float kNone = -1e30f;       // score of "no extremum"
constexpr int kThreads = 128;         // = strip width
constexpr int kRow = kThreads + 8;    // stage row: x0-4 .. x0+131
constexpr int kChunks = kRow / 4;     // 16-byte copies per stage row
constexpr int kStages = 6;            // ring depth: kStages - 1 rows in flight

__device__ __forceinline__ float maxn(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float minn(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// dst: a shared-memory address
__device__ __forceinline__ void cp_async16(unsigned dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(unsigned dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One thread's share of the copies of a stage row: all D levels of row y,
// columns x0-1 .. x0+128 (stage column j holds x0 - 4 + j). The slots are
// fixed for the block, so a row costs a thread a few address adds and its
// copies. Rows and columns outside the image land as zeros (src-size 0:
// nothing is read).
template <int D, bool kVec>
struct RowLoader {
  // 16-byte chunks: slot j is chunk threadIdx.x + j * kThreads of the row's
  // D * kChunks; 4-byte floats: column threadIdx.x of every level, and the
  // last two columns (threads 0 and 1)
  static constexpr int kSlots = kVec ? (D * kChunks + kThreads - 1) / kThreads
                                     : 2;
  const float* frame;
  long long plane;
  int H, W;
  int off[kSlots];          // offset in the frame's row 0 (level 0 for floats)
  unsigned dst[kSlots];     // shared address in stage 0 (level 0 for floats)
  bool has[kSlots];         // the slot holds a copy (inside or outside)
  bool use[kSlots];         // ... of a column inside the image

  __device__ __forceinline__ RowLoader(const float* frame_, long long plane_,
                                       int H_, int W_, int x0,
                                       const float* ring0)
      : frame(frame_), plane(plane_), H(H_), W(W_) {
    const unsigned base = (unsigned)__cvta_generic_to_shared(ring0);
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      int l = 0, col;
      if (kVec) {
        const int c = threadIdx.x + j * kThreads;
        l = min(c / kChunks, D - 1);
        col = 4 * (c - (c / kChunks) * kChunks);
        has[j] = c < D * kChunks;
      } else {
        col = 3 + threadIdx.x + j * kThreads;
        has[j] = col < kRow - 3;
      }
      const int gx = x0 - 4 + col;
      use[j] = gx >= 0 && gx < W;
      off[j] = (int)(l * plane) + gx;
      dst[j] = base + 4u * (unsigned)(l * kRow + col);
    }
  }

  // start this thread's copies of row y into stage s
  __device__ __forceinline__ void row(int s, int y) const {
    const bool row_in = y >= 0 && y < H;
    const float* r = frame + (long long)(row_in ? y : 0) * W;
    const unsigned stage = 4u * (unsigned)(s * D * kRow);
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (!has[j]) continue;
      const bool in = row_in && use[j];
      if (kVec) {
        cp_async16(dst[j] + stage, in ? r + off[j] : frame, in ? 16 : 0);
      } else {
#pragma unroll
        for (int l = 0; l < D; ++l)
          cp_async4(dst[j] + stage + 4u * (unsigned)(l * kRow),
                    in ? r + l * plane + off[j] : frame, in ? 4 : 0);
      }
    }
  }
};

// Levels 0 and D-1 of the score map over the band: constants.
template <int D, bool kVec>
__device__ __forceinline__ void fill_outer_levels(float* __restrict__ oframe,
                                                  long long plane, int W,
                                                  int x0, int y0, int yend) {
  const int ncol = min(kThreads, W - x0);
  if (kVec) {
    // a warp per (level, row): lane v writes columns x0 + 4v .. x0 + 4v + 3
    // (W % 4 == 0, so ncol % 4 == 0); four warps, two rows at a time
    const float4 none = make_float4(kNone, kNone, kNone, kNone);
    const int v = threadIdx.x & 31;
    const int r0 = y0 + (threadIdx.x >> 6);
    if (4 * v < ncol) {
      float* p = oframe + ((threadIdx.x >> 5) & 1 ? (D - 1) * plane : 0)
                 + (long long)r0 * W + x0 + 4 * v;
      for (int y = r0; y < yend; y += 2, p += 2 * W)
        *reinterpret_cast<float4*>(p) = none;
    }
  } else if ((int)threadIdx.x < ncol) {
    float* p = oframe + (long long)y0 * W + x0 + threadIdx.x;
    for (int y = y0; y < yend; ++y, p += W) {
      p[0] = kNone;
      p[(D - 1) * plane] = kNone;
    }
  }
}

// The body of both kernels, one block: blockIdx = (strip, band, frame).
// kScore selects the output: the score map (out [B, D, H, W]) or the
// per-tile winners (out = smax, rows = srow, [B, n_tiles, D-2, Wp]).
template <int D, bool kScore, bool kVec>
__device__ __forceinline__ void scan_band(const float* __restrict__ dog,
                                          float* __restrict__ out,
                                          int* __restrict__ rows, int H, int W,
                                          int Wp, float thr) {
  constexpr int kIn = D - 2;                  // inner levels
  __shared__ __align__(16) float ring[kStages][D][kRow];

  const int x0 = blockIdx.x * kThreads;
  const int x = x0 + threadIdx.x;
  const int y0 = blockIdx.y * kTile;
  const int b = blockIdx.z;
  const int yend = min(y0 + kTile, H);        // centre rows [y0, yend)
  const int nrows = yend - y0 + 2;            // loaded rows y0-1 .. yend
  const long long plane = (long long)H * W;
  const float* frame = dog + (long long)b * D * plane;
  float* oframe = kScore ? out + (long long)b * D * plane : out;

  // the ring's prologue: kStages - 1 rows in flight, one commit group each
  const RowLoader<D, kVec> load(frame, plane, H, W, x0, &ring[0][0][0]);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    load.row(s, y0 - 1 + s);
    cp_async_commit();
  }
  if (kScore) fill_outer_levels<D, kVec>(oframe, plane, W, x0, y0, yend);

  const bool col_ok = x >= 1 && x <= W - 2;
  // window of the column, entering row i:
  //   pmx/pmn[l]  max / min over rows i-2, i-1 and the 3 columns, level l
  //   qmx/qmn[k]  max / min over row i-2's 3 columns and row i-1's x-1, x+1,
  //               inner level k + 1
  //   bmx/bmn[l]  max / min over row i-1's 3 columns
  //   cen[k]      row i-1's centre value, inner level k + 1
  float pmx[D], pmn[D], bmx[D], bmn[D], qmx[kIn], qmn[kIn], cen[kIn];
  float best[kIn];
  int brow[kIn];
#pragma unroll
  for (int k = 0; k < kIn; ++k) best[k] = kNone;

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (i == nrows) break;                    // the last band of a frame
    cp_async_wait<kStages - 2>();             // this thread's copies of row i
    __syncthreads();                          // everyone's; row i-1 is read
    // rows past the band's end are copied too (zeros past H): it keeps the
    // commit groups in step
    if (i + kStages - 1 < kRows)
      load.row((i + kStages - 1) % kStages, y0 + i + kStages - 2);
    cp_async_commit();

    // row i: per-level extremes over the 3 columns
    const float (*st)[kRow] = ring[i % kStages];
    float cmx[D], cmn[D], lrmx[kIn], lrmn[kIn], ctr[kIn];
#pragma unroll
    for (int l = 0; l < D; ++l) {
      const float lft = st[l][threadIdx.x + 3];
      const float c = st[l][threadIdx.x + 4];
      const float rgt = st[l][threadIdx.x + 5];
      const float lr_mx = maxn(lft, rgt), lr_mn = minn(lft, rgt);
      cmx[l] = maxn(lr_mx, c);
      cmn[l] = minn(lr_mn, c);
      if (l >= 1 && l <= D - 2) {
        lrmx[l - 1] = lr_mx;
        lrmn[l - 1] = lr_mn;
        ctr[l - 1] = c;
      }
    }

    if (i >= 2) {                             // centre row i-1
      const int y = y0 + i - 2;
      const bool ok = col_ok && y >= 1 && y <= H - 2;
      float m9x[D], m9n[D];
#pragma unroll
      for (int l = 0; l < D; ++l) {
        m9x[l] = maxn(pmx[l], cmx[l]);
        m9n[l] = minn(pmn[l], cmn[l]);
      }
#pragma unroll
      for (int k = 0; k < kIn; ++k) {
        const float nbx = maxn(maxn(m9x[k], m9x[k + 2]),
                               maxn(qmx[k], cmx[k + 1]));
        const float nbn = minn(minn(m9n[k], m9n[k + 2]),
                               minn(qmn[k], cmn[k + 1]));
        const float c = cen[k];
        const float score = fabsf(c);
        const float val = (ok && (c > nbx || c < nbn) && score > thr) ? score
                                                                      : kNone;
        if (kScore) {
          if (x < W) oframe[(k + 1) * plane + (long long)y * W + x] = val;
        } else if (i == 2 || val >= best[k]) {
          // >= : ties go to the later (larger) row
          best[k] = val;
          brow[k] = i - 2;
        }
      }
    }

    // roll the window down one row (bmx / bmn still hold row i-1)
#pragma unroll
    for (int k = 0; k < kIn; ++k) {
      if (i >= 1) {
        qmx[k] = maxn(bmx[k + 1], lrmx[k]);
        qmn[k] = minn(bmn[k + 1], lrmn[k]);
      }
      cen[k] = ctr[k];
    }
#pragma unroll
    for (int l = 0; l < D; ++l) {
      if (i >= 1) {
        pmx[l] = maxn(bmx[l], cmx[l]);
        pmn[l] = minn(bmn[l], cmn[l]);
      }
      bmx[l] = cmx[l];
      bmn[l] = cmn[l];
    }
  }

  cp_async_wait<0>();                 // the copies past a last band's end

  if (!kScore) {
    // the tile's winners; a tile past H has its missing rows "no extremum",
    // so a column without one reports row 15 there too
    const long long o =
        ((long long)b * gridDim.y + blockIdx.y) * kIn * Wp + x;
#pragma unroll
    for (int k = 0; k < kIn; ++k) {
      out[o + (long long)k * Wp] = best[k];
      rows[o + (long long)k * Wp] = best[k] == kNone ? kTile - 1 : brow[k];
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
extrema_winners_kernel(const float* __restrict__ dog, float* __restrict__ smax,
                       int* __restrict__ srow, int H, int W, int Wp,
                       float thr) {
  scan_band<kWinnerLevels, false, kVec>(dog, smax, srow, H, W, Wp, thr);
}

template <int D, bool kVec>
__global__ void __launch_bounds__(kThreads)
extrema_score_kernel(const float* __restrict__ dog, float* __restrict__ out,
                     int H, int W, float thr) {
  scan_band<D, true, kVec>(dog, out, nullptr, H, W, 0, thr);
}

dim3 grid_of(int B, int H, int W) {
  return dim3((W + kThreads - 1) / kThreads, (H + kTile - 1) / kTile, B);
}

// 16-byte copies (and the score map's 16-byte stores) need 16-byte aligned
// rows
bool aligned(const void* a, const void* b, int W) {
  return W % 4 == 0
         && (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b))
                    % 16 == 0;
}

template <int D>
int launch_score(const float* dog, float* out, int B, int H, int W, float thr,
                 cudaStream_t stream) {
  const dim3 grid = grid_of(B, H, W);
  if (aligned(dog, out, W))
    extrema_score_kernel<D, true><<<grid, kThreads, 0, stream>>>(
        dog, out, H, W, thr);
  else
    extrema_score_kernel<D, false><<<grid, kThreads, 0, stream>>>(
        dog, out, H, W, thr);
  return (int)cudaGetLastError();
}

// a frame's offsets fit an int
bool too_large(int D, int H, int W) {
  return (long long)D * H * W >= (1LL << 31);
}

}  // namespace

// dog, out: [B, D, H, W] f32 with 3 <= D <= 8 (the wrapper checks) and
// D * H * W < 2^31; thr is the pre-filter on |dog| (half the contrast
// threshold). Returns the cudaError_t of the launch (cudaErrorInvalidValue
// for an unsupported D or size).
extern "C" int extrema_score(const float* dog, float* out, int B, int D,
                             int H, int W, float thr, cudaStream_t stream) {
  if (too_large(D, H, W)) return (int)cudaErrorInvalidValue;
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

// dog: [B, 5, H, W] f32 with 5 * H * W < 2^31; smax/srow: [B, n_tiles, 3, Wp]
// with n_tiles = ceil(H / 16) and Wp = W rounded up to 128; thr is the
// pre-filter on |dog| (half the contrast threshold). Returns the cudaError_t
// of the launch.
extern "C" int extrema_winners(const float* dog, float* smax, int* srow, int B,
                               int H, int W, int Wp, float thr,
                               cudaStream_t stream) {
  if (too_large(kWinnerLevels, H, W)) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return 0;
  const dim3 grid = grid_of(B, H, W);
  if (aligned(dog, dog, W))
    extrema_winners_kernel<true><<<grid, kThreads, 0, stream>>>(
        dog, smax, srow, H, W, Wp, thr);
  else
    extrema_winners_kernel<false><<<grid, kThreads, 0, stream>>>(
        dog, smax, srow, H, W, Wp, thr);
  return (int)cudaGetLastError();
}
