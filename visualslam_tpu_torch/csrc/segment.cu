// Fixed-order segment sums: the sparse sums of bundle adjustment and the
// pose graph.
//
// No Pallas kernel of the JAX package corresponds: there the sums are
// `jax.ops.segment_sum`, which XLA lowers to a scatter-add without atomics,
// so the JAX package repeats itself bit for bit. `index_add_` on a CUDA
// tensor sums with atomics, in an order that changes from run to run; this
// kernel replaces it on the card.
//
// For rows x[O, width] (f32 or f64, contiguous) and a plan of the index
// array idx[O] built on the device (ops/cuda/segment.py `segment_plan`):
//
//   perm     [O] int64   the stable argsort of idx
//   offsets  [n + 1] int64, segment s = perm[offsets[s] : offsets[s + 1]]
//
// it writes every out[s, c] of out[n, width], empty segments included:
//
//   out[s, c] = ((0 + x[perm[b], c]) + x[perm[b + 1], c]) + ...
//
// the rows of segment s added in ascending observation order, starting
// from 0: what `index_add_` on the CPU and XLA's scatter compute, so the
// card's sums equal the CPU's and the JAX package's bit for bit. One
// launch; no separate zero fill.
//
// Index contract (index_add_'s): every idx lies in [0, n). A plan of an
// index outside it leaves offsets[0] > 0 or offsets[n] < O, and the kernel
// stops on a device-side assert, as index_add_ does on the card.
//
// Bound: bytes (x, perm and offsets read once, out written once; one add
// per element of x). The add order makes each output a serial chain of
// dependent adds, so the design keeps the loads of a chain ahead of its
// adds:
//   - short segments (O < 64 n: landmark, pair and pose-graph sums, a few
//     rows each): one thread per (segment, column), loads of four rows
//     issued before their adds;
//   - long segments (O >= 64 n: the camera sums, hundreds to thousands of
//     rows each): one block per segment; all its threads gather tiles of
//     the segment's rows into a 6-stage shared-memory ring with cp.async
//     while `width` of them add the landed tile's rows in order, one column
//     each.

#undef NDEBUG
#include <cassert>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLongRows = 64;      // rows per segment on average: long path
constexpr int kStages = 6;         // the long path's ring of tiles
constexpr int kTileElems = 1024;   // elements of x per tile (f64: 48 KB ring)

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               ::"r"(s), "l"(src), "n"(sizeof(T)));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// offsets[0] == 0 and offsets[n] == rows hold exactly when every index lies
// in [0, n)
__device__ __forceinline__ void check_contract(const long long* offsets,
                                               long long rows, int n, int s) {
  if (s == 0) assert(offsets[0] == 0 && "segment_sum: index below 0");
  if (s == n - 1) assert(offsets[n] == rows && "segment_sum: index >= n");
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_short(const T* __restrict__ x, const long long* __restrict__ perm,
                  const long long* __restrict__ offsets, T* __restrict__ out,
                  long long rows, int n, int width) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)n * width) return;
  const int s = (int)(t / width);
  const int c = (int)(t - (long long)s * width);
  if (c == 0) check_contract(offsets, rows, n, s);
  long long k = offsets[s];
  const long long end = offsets[s + 1];
  T acc = T(0);
  for (; k + 4 <= end; k += 4) {
    const T v0 = x[perm[k] * width + c];
    const T v1 = x[perm[k + 1] * width + c];
    const T v2 = x[perm[k + 2] * width + c];
    const T v3 = x[perm[k + 3] * width + c];
    acc = acc + v0;
    acc = acc + v1;
    acc = acc + v2;
    acc = acc + v3;
  }
  for (; k < end; ++k) acc = acc + x[perm[k] * width + c];
  out[t] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_long(const T* __restrict__ x, const long long* __restrict__ perm,
                 const long long* __restrict__ offsets, T* __restrict__ out,
                 long long rows, int n, int width) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int s = blockIdx.x;
  const int c = threadIdx.x;
  if (c == 0) check_contract(offsets, rows, n, s);
  const long long begin = offsets[s];
  const long long end = offsets[s + 1];
  const int tile_rows = kTileElems / width;
  const int tile = tile_rows * width;
  const long long ntiles = (end - begin + tile_rows - 1) / tile_rows;

  // gather tile t's rows into its slot; one commit per call (an empty
  // group past the last tile) keeps the wait counts uniform
  auto issue = [&](long long t) {
    if (t < ntiles) {
      T* dst = ring + (t % kStages) * tile;
      const long long r0 = begin + t * tile_rows;
      const int nr = (int)min((long long)tile_rows, end - r0);
      for (int e = threadIdx.x; e < nr * width; e += kThreads) {
        const int r = e / width;
        cp_async(dst + e, x + perm[r0 + r] * width + (e - r * width));
      }
    }
    cp_async_commit();
  };

  for (int t = 0; t < kStages - 1; ++t) issue(t);
  T acc = T(0);
  for (long long t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();   // this thread's copies of tile t landed
    __syncthreads();                // everyone's did; tile t - 1 is consumed
    issue(t + kStages - 1);         // into tile t - 1's slot
    if (c < width) {
      const T* src = ring + (t % kStages) * tile + c;
      const int nr = (int)min((long long)tile_rows, end - (begin + t * tile_rows));
#pragma unroll 8
      for (int r = 0; r < nr; ++r) acc = acc + src[r * width];
    }
  }
  if (c < width) out[(long long)s * width + c] = acc;
}

template <typename T>
int launch(const T* x, const long long* perm, const long long* offsets, T* out,
           long long rows, int n, int width, cudaStream_t stream) {
  if (n <= 0 || width <= 0) return 0;
  if (width <= kThreads && rows >= (long long)kLongRows * n) {
    const size_t smem = (size_t)kStages * (kTileElems / width) * width * sizeof(T);
    segment_sum_long<T><<<n, kThreads, smem, stream>>>(x, perm, offsets, out,
                                                      rows, n, width);
  } else {
    const long long blocks = ((long long)n * width + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    segment_sum_short<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        x, perm, offsets, out, rows, n, width);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int segment_sum_f32(const float* x, const long long* perm,
                               const long long* offsets, float* out,
                               long long rows, int n, int width,
                               cudaStream_t stream) {
  return launch<float>(x, perm, offsets, out, rows, n, width, stream);
}

extern "C" int segment_sum_f64(const double* x, const long long* perm,
                               const long long* offsets, double* out,
                               long long rows, int n, int width,
                               cudaStream_t stream) {
  return launch<double>(x, perm, offsets, out, rows, n, width, stream);
}

// 1 where a call with these sizes takes the long-segment path, else 0
extern "C" int segment_sum_long_path(long long rows, int n, int width) {
  return width <= kThreads && rows >= (long long)kLongRows * n ? 1 : 0;
}
