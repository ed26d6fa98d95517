// Streaming 2-nearest-neighbour search under squared L2 (descriptor
// matching: the local-map and keyframe matches of tracking, and the
// consecutive-pair matches of the frontend slice).
//
// Replaces visualslam_tpu/ops/pallas/distance.py `pallas_l2_2nn` (`_kernel`).
// For a[P, Ka, D] and b[P, Kb, D] (f32, contiguous) it returns, per pair p
// and A row i, over all B rows j:
//
//   d(i, j)   = max(|a_i|^2 + |b_j|^2 - 2 a_i.b_j, 0)
//   best[i]   = min_j d(i, j)
//   idx[i]    = the lowest j with d(i, j) == best[i]   (argmin's first)
//   second[i] = the second smallest d(i, j) as a multiset (the best value
//               again where two rows tie), 1e30 where Kb == 1
//
// without materialising the [Ka, Kb] matrix. Partial results merge by the
// Pallas kernel's rule: best = min, second = min(second_a, second_b,
// max(best_a, best_b)), idx to the strictly smaller best and on a tie to the
// lower index. The rule is associative and commutative, so every merge order
// gives the same bits; the kernel still merges in a fixed order, with no
// atomics.
//
// Bound: f32 FMAs. At Ka = Kb = 2048, D = 128 the products are 1.07 GFLOP
// against 2 MB of input: compute-bound on the SIMT f32 path (67 TFLOP/s
// peak), tens of microseconds at best. No tensor cores: TF32 would move
// distances by ~1e-3 and flip near-tied ratio tests (ops/distance.py in the
// JAX package records that failure for bf16 passes). Design: a block owns
// 64 A rows and walks a range of B in 64-row tiles, both staged transposed
// through shared memory; each of its 256 threads keeps a 4x4 register
// micro-tile of a.b, then reduces its 4 columns per row and merges across
// the 16 threads of a row with warp shuffles into a running (best, second,
// idx) per row. A tracked frame is one pair, 32 blocks of A rows: too few
// for 132 SMs, so the B range is split over `nsplit` blocks that write
// partial results, and a second kernel merges the splits in order.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTA = 64;            // A rows per block
constexpr int kTB = 64;            // B rows per tile
constexpr int kThreads = 256;      // 16 x 16: (row group, column group)
constexpr int kPad = 4;            // keeps float4 alignment, eases banks
constexpr float kBig = 1e30f;      // the Pallas kernel's initial state

struct Nn {
  float best, second;
  int idx;
};

__device__ __forceinline__ Nn merge(Nn x, Nn y) {
  Nn r;
  r.best = fminf(x.best, y.best);
  r.second = fminf(fminf(x.second, y.second), fmaxf(x.best, y.best));
  r.idx = y.best < x.best ? y.idx : (x.best < y.best ? x.idx : min(x.idx, y.idx));
  return r;
}

// a, b: [P, K, D]; part_*: [P, nsplit, Ka]. Dynamic shared memory:
// As[D][kTA + kPad], Bs[D][kTB + kPad], na[kTA], nb[kTB].
__global__ void __launch_bounds__(kThreads)
l2_2nn_partial_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ part_best,
                      float* __restrict__ part_second,
                      int* __restrict__ part_idx, int Ka, int Kb, int D,
                      int nsplit, int tiles_per_split) {
  extern __shared__ float smem[];
  float* As = smem;                                   // [D][kTA + kPad]
  float* Bs = As + D * (kTA + kPad);                  // [D][kTB + kPad]
  float* na = Bs + D * (kTB + kPad);                  // [kTA]
  float* nb = na + kTA;                               // [kTB]

  const int p = blockIdx.z;
  const int split = blockIdx.y;
  const int row0 = blockIdx.x * kTA;
  const int tid = threadIdx.x;
  const int ty = tid / 16;          // rows ty*4 .. ty*4+3 of the A tile
  const int tx = tid % 16;          // columns tx*4 .. tx*4+3 of the B tile
  const float* ap = a + (long long)p * Ka * D;
  const float* bp = b + (long long)p * Kb * D;

  // stage the A tile transposed; rows past Ka read as zeros (never written)
  for (int e = tid; e < kTA * D; e += kThreads) {
    const int r = e / D, k = e % D;
    As[k * (kTA + kPad) + r] = row0 + r < Ka ? ap[(long long)(row0 + r) * D + k] : 0.f;
  }
  __syncthreads();
  if (tid < kTA) {
    float s = 0.f;
    for (int k = 0; k < D; ++k) {
      const float v = As[k * (kTA + kPad) + tid];
      s = fmaf(v, v, s);
    }
    na[tid] = s;
  }

  Nn run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) run[i] = {kBig, kBig, 0};

  const int n_tiles = (Kb + kTB - 1) / kTB;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int col0 = tile * kTB;
    __syncthreads();                // previous tile fully consumed
    for (int e = tid; e < kTB * D; e += kThreads) {
      const int c = e / D, k = e % D;
      Bs[k * (kTB + kPad) + c] = col0 + c < Kb ? bp[(long long)(col0 + c) * D + k] : 0.f;
    }
    __syncthreads();
    if (tid < kTB) {
      float s = 0.f;
      for (int k = 0; k < D; ++k) {
        const float v = Bs[k * (kTB + kPad) + tid];
        s = fmaf(v, v, s);
      }
      nb[tid] = s;
    }

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < D; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[k * (kTA + kPad) + ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k * (kTB + kPad) + tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();                // nb written

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float nai = na[ty * 4 + i];
      // this thread's 4 columns in increasing order, then the row's 16
      // threads (the same warp, lanes differing in the low 4 bits)
      Nn loc = {kBig, kBig, 0};
      bool first = true;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        if (col0 + c >= Kb) continue;
        const float d = fmaxf(nai + nb[c] - 2.f * acc[i][j], 0.f);
        const Nn one = {d, INFINITY, col0 + c};
        loc = first ? one : merge(loc, one);
        first = false;
      }
      if (first) loc = {INFINITY, INFINITY, 0x7fffffff};
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) {
        Nn o;
        o.best = __shfl_xor_sync(0xffffffffu, loc.best, off);
        o.second = __shfl_xor_sync(0xffffffffu, loc.second, off);
        o.idx = __shfl_xor_sync(0xffffffffu, loc.idx, off);
        loc = merge(loc, o);
      }
      run[i] = merge(run[i], loc);
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty * 4 + i;
      if (r >= Ka) continue;
      const long long o = ((long long)p * nsplit + split) * Ka + r;
      part_best[o] = run[i].best;
      part_second[o] = run[i].second;
      part_idx[o] = run[i].idx;
    }
  }
}

// one thread per (pair, A row): merge the splits in order
__global__ void l2_2nn_merge_kernel(const float* __restrict__ part_best,
                                    const float* __restrict__ part_second,
                                    const int* __restrict__ part_idx,
                                    float* __restrict__ best,
                                    float* __restrict__ second,
                                    int* __restrict__ idx, int P, int Ka,
                                    int nsplit) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)P * Ka) return;
  const long long p = e / Ka, r = e % Ka;
  Nn acc = {kBig, kBig, 0};
  for (int s = 0; s < nsplit; ++s) {
    const long long o = (p * nsplit + s) * Ka + r;
    acc = merge(acc, Nn{part_best[o], part_second[o], part_idx[o]});
  }
  best[e] = acc.best;
  second[e] = acc.second;
  idx[e] = acc.idx;
}

// Bytes of dynamic shared memory the partial kernel needs for descriptor
// width D.
int smem_bytes(int D) {
  return (int)sizeof(float) * (D * (kTA + kPad) + D * (kTB + kPad) + kTA + kTB);
}

}  // namespace

// a: [P, Ka, D], b: [P, Kb, D] f32; part_*: [P, nsplit, Ka] scratch;
// best, second: [P, Ka] f32, idx: [P, Ka] i32. tiles_per_split * nsplit
// must cover ceil(Kb / 64) tiles. Returns the cudaError_t of the launches.
extern "C" int l2_2nn(const float* a, const float* b, float* part_best,
                      float* part_second, int* part_idx, float* best,
                      float* second, int* idx, int P, int Ka, int Kb, int D,
                      int nsplit, int tiles_per_split, cudaStream_t stream) {
  if (P == 0 || Ka == 0) return 0;
  const int smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      l2_2nn_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Ka + kTA - 1) / kTA, nsplit, P);
  l2_2nn_partial_kernel<<<grid, kThreads, smem, stream>>>(
      a, b, part_best, part_second, part_idx, Ka, Kb, D, nsplit,
      tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)P * Ka;
  l2_2nn_merge_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part_best, part_second, part_idx, best, second, idx, P, Ka, nsplit);
  return (int)cudaGetLastError();
}
