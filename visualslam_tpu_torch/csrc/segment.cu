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
//   perm       [O] int64   the stable argsort of idx
//   offsets    [n + 1] int64, segment s = perm[offsets[s] : offsets[s + 1]]
//   long_ids   [workers] int32, the segments of at least kLongRows rows in
//              ascending order (then n); long_count [1] int64 of them valid
//
// it writes every out[s, c] of out[n, width], empty segments included:
//
//   out[s, c] = ((0 + x[perm[b], c]) + x[perm[b + 1], c]) + ...
//
// the rows of segment s added in ascending observation order, starting
// from 0: what `index_add_` on the CPU and XLA's scatter compute, so the
// card's sums equal the CPU's and the JAX package's bit for bit. No tree
// and no split of one output's chain. One launch per call; no separate
// zero fill; the kernel and its grid are chosen from host integers only
// (O, n, width and the plan's worker count), so a call can be captured in
// a CUDA graph and replayed with new rows.
//
// Index contract (index_add_'s): every idx lies in [0, n). A plan of an
// index outside it leaves offsets[0] > 0 or offsets[n] < O, and the kernel
// stops on a device-side assert, as index_add_ does on the card.
//
// Bounds. Each output is a chain of len(s) dependent adds (4 cycles a
// float32 add, 8 a float64 one on the H100; chip_smoke.py measures them).
// A call can go no faster than the larger of that chain for its longest
// segment and its bytes (x, perm and offsets read once, out written once).
// The path is chosen per segment, in one launch:
//   - short segments (fewer than kLongRows = 64 rows: landmark, pair and
//     most pose-graph sums): one thread per (segment, column), loads of
//     four rows issued before their adds, 32-bit index arithmetic. Bound:
//     bytes and the latency of the dependent index reads. Reading a
//     warp's segment ranges once and sharing them by shuffle measured
//     slower than each thread's own (coalesced) reads, so they stay.
//   - long segments (BA's camera sums, the pose graph's padding node):
//     the plan's long list, walked by up to 132 worker blocks placed after
//     the short blocks, a whole block per segment. Bound: the chain. The
//     block splits into consumer warps (one thread per column, two columns
//     past 192) and producer warps (the rest, up to 7) that take turns over
//     the segment's tiles of 32 / 16 / 8 rows. A producer brings its tiles'
//     perm entries into shared memory three of its turns ahead with
//     coalesced cp.async, then gathers each tile's rows from those into a
//     ring of up to 16 tiles (16-, 8- or 4-byte copies); full / empty
//     mbarriers per tile hand tiles over, with no block-wide barrier and
//     no global index read on the add chain. A consumer adds a full tile
//     unrolled, each group of rows loaded from shared memory while the
//     previous group is added and the next tile's first group while its
//     last one is. Many producers because each cp.async instruction takes
//     tens of cycles to issue; the ring stays within 27 KB, and the kernel
//     within 64 registers (at 32 the long path spilled), so that a
//     launch's short blocks keep 4 blocks an SM and half the L1 cache.
//   - a call with no more rows than segments (the dense solvers' pair
//     sums) launches the thread-per-output kernel alone: its blocks then
//     need no ring and no more than 32 registers, and keep the SM's full
//     occupancy and L1 cache. Rows wider than 384 go that way too.
// kLongRows = 64 (ops/cuda/segment.py LONG_ROWS, the plan's threshold,
// must equal it): on the power-law shape set, copies of this kernel and its
// wrapper with the two constants set to 32 to 256 rows timed within a few
// percent of each other on the H100, 16 slower (its long list outgrows the
// 132 worker blocks; chip_smoke.py --segment-turns, PERF.md).
// What the long path still misses: its consumer adds a row in about 10
// cycles against the add's 4; with the shared-memory loads taken out it
// runs at the add's pace, so those loads, not the barriers or the copies,
// hold it (PERF.md).

#undef NDEBUG
#include <cassert>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxConsumers = 192;                  // 6 warps, the rest copy
constexpr int kMaxCols = 2;                         // per consumer
constexpr int kMaxLongWidth = kMaxCols * kMaxConsumers;
constexpr int kMaxProducers = 7;
constexpr int kPermStages = 3;                      // per producer warp
constexpr int kMaxStages = 16;
constexpr int kMaxWorkers = 132;                    // the H100's SMs
constexpr int kMinStages = 6;
constexpr int kLongRows = 64;                       // segment.py LONG_ROWS
constexpr int kHeader = 2 * kMaxStages * 8;         // the mbarriers
// shared memory of a launch with long-path work: at the 4 blocks an SM that
// its registers allow, it leaves half the SM's 256 KB to the L1 cache its
// short outputs read through
constexpr int kSmemBudget = 27 * 1024;

// rows a consumer loads ahead of its adds: ~32 cycles of dependent adds
// cover a shared-memory load
template <typename T> struct Group;
template <> struct Group<float> { static constexpr int rows = 8; };
template <> struct Group<double> { static constexpr int rows = 4; };

// the long path's shape for one call, from host integers
struct Long {
  int rows;      // tile rows: 32, 16, 8 (float) or 16, 8, 4 (double)
  int stages;    // tiles in the ring
  int vec;       // bytes per cp.async
  int cwarps;    // consumer warps
  int pwarps;    // producer warps, after the consumers'
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

template <int V>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 ::"r"(smem_addr(dst)), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 ::"r"(smem_addr(dst)), "l"(src), "n"(V));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_inval(unsigned long long* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n"
               ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(smem_addr(bar)) : "memory");
}

// arrives once every cp.async this thread issued so far has landed
__device__ __forceinline__ void mbar_arrive_copies(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(smem_addr(bar)) : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// offsets[0] == 0 and offsets[n] == rows hold exactly when every index lies
// in [0, n)
__device__ __forceinline__ void check_contract(const long long* offsets,
                                               long long rows, int n) {
  assert(offsets[0] == 0 && "segment_sum: index below 0");
  assert(offsets[n] == rows && "segment_sum: index >= n");
}

// one tile's rows, perm entries pk[0 .. nr), gathered into dst by one warp
// in V-byte copies
template <int V>
__device__ __forceinline__ void copy_rows(char* dst, const char* x,
                                          const long long* pk, int nr,
                                          int row_bytes, int lane) {
  const int cpr = row_bytes / V;             // copies per row
  if (cpr <= 32) {
    const int step = 32 / cpr;               // rows per pass of the warp
    const int q = lane % cpr;
    const int r0 = lane / cpr;
    if (r0 < step) {
#pragma unroll 4
      for (int r = r0; r < nr; r += step)
        cp_async<V>(dst + r * row_bytes + q * V, x + pk[r] * row_bytes + q * V);
    }
  } else {
    for (int r = 0; r < nr; ++r) {
      const char* src = x + pk[r] * row_bytes;
      char* d = dst + r * row_bytes;
      for (int q = lane; q < cpr; q += 32) cp_async<V>(d + q * V, src + q * V);
    }
  }
}

// producer warp p of P: tiles p, p + P, ... of the segment perm[begin,
// begin + len); its perm ring holds kPermStages of its tiles
template <typename T>
__device__ __forceinline__ void produce(const T* __restrict__ x,
                        const long long* __restrict__ perm, long long begin,
                        int len, int ntiles, T* ring, long long* pring,
                        unsigned long long* full, unsigned long long* empty,
                        int width, const Long& g, int p, int P, int lane) {
  const int R = g.rows, S = g.stages;
  const int row_bytes = width * (int)sizeof(T);
  auto fetch_perm = [&](int step, int slot) {
    const int k = p + step * P;
    if (k < ntiles) {
      const int nr = min(R, len - k * R);
      for (int r = lane; r < nr; r += 32)
        cp_async<8>(pring + slot * R + r, perm + begin + (long long)k * R + r);
    }
    cp_async_commit();
  };
  for (int i = 0; i < kPermStages; ++i) fetch_perm(i, i);
  // tile k sits in slot k % S, for the (k / S)-th time: both kept as
  // counters, no division in the loop
  int slot = p % S, round = p / S, ps = 0;
  for (int k = p, step = 0; k < ntiles; k += P, ++step) {
    if (round > 0) mbar_wait(&empty[slot], (unsigned)(round - 1) & 1);
    // this warp's perm entries of tile k landed (one group a step: the
    // kPermStages - 1 later ones may still be in flight)
    cp_async_wait<kPermStages - 1>();
    __syncwarp();
    const long long* pk = pring + ps * R;
    const int nr = min(R, len - k * R);
    char* dst = reinterpret_cast<char*>(ring + slot * R * width);
    const char* src = reinterpret_cast<const char*>(x);
    if (g.vec == 16) copy_rows<16>(dst, src, pk, nr, row_bytes, lane);
    else if (g.vec == 8) copy_rows<8>(dst, src, pk, nr, row_bytes, lane);
    else copy_rows<4>(dst, src, pk, nr, row_bytes, lane);
    mbar_arrive_copies(&full[slot]);
    __syncwarp();                    // every lane has read pk
    fetch_perm(step + kPermStages, ps);
    ps = ps + 1 == kPermStages ? 0 : ps + 1;
    for (slot += P; slot >= S; slot -= S) ++round;
  }
  cp_async_wait<0>();
}

template <typename T, int NC, int U>
__device__ __forceinline__ void load_group(T (&v)[NC][U], const T* tile,
                                           int r, int width) {
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int j = 0; j < NC; ++j) v[j][u] = tile[(r + u) * width + j * kMaxConsumers];
}

template <typename T, int NC, int U>
__device__ __forceinline__ void add_group(T (&acc)[NC], const T (&v)[NC][U]) {
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[j] = acc[j] + v[j][u];
}

// consumer: columns c (and c + kMaxConsumers for NC = 2) of the segment, R
// rows a tile. Full tiles run unrolled, each group of U rows loaded while
// the previous group is added, the next tile's first group while the last
// group is added; the short last tile row by row.
template <typename T, int NC, int R>
__device__ __forceinline__ void consume(const T* ring, unsigned long long* full,
                        unsigned long long* empty, int len, int ntiles, int S,
                        int width, int c, T* __restrict__ out_row) {
  constexpr int U = Group<T>::rows / NC;
  constexpr int G = R / U;
  static_assert(G >= 1 && G * U == R, "a tile is whole groups of rows");
  const int tile = R * width;
  const int full_tiles = len / R;
  T acc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j] = T(0);
  T cur[NC][U], nxt[NC][U];
  // tile k sits in slot k % S, for the (k / S)-th time: kept as counters
  int slot = 0;
  unsigned phase = 0;
  if (full_tiles > 0) {
    mbar_wait(&full[0], 0);
    load_group<T, NC, U>(cur, ring + c, 0, width);
  }
  for (int k = 0; k < full_tiles; ++k) {
    const T* t = ring + slot * tile + c;
#pragma unroll
    for (int q = 1; q < G; ++q) {
      load_group<T, NC, U>(nxt, t, q * U, width);
      add_group<T, NC, U>(acc, cur);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < NC; ++j) cur[j][u] = nxt[j][u];
    }
    const int next = slot + 1 == S ? 0 : slot + 1;
    const unsigned next_phase = next == 0 ? phase ^ 1u : phase;
    const bool more = k + 1 < full_tiles;
    if (more) {
      mbar_wait(&full[next], next_phase);
      load_group<T, NC, U>(nxt, ring + next * tile + c, 0, width);
    }
    add_group<T, NC, U>(acc, cur);
    mbar_arrive(&empty[slot]);
    slot = next;
    phase = next_phase;
    if (more) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < NC; ++j) cur[j][u] = nxt[j][u];
    }
  }
  if (full_tiles < ntiles) {
    mbar_wait(&full[slot], phase);
    const T* t = ring + slot * tile + c;
    const int nr = len - full_tiles * R;
#pragma unroll 4
    for (int r = 0; r < nr; ++r)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[j] = acc[j] + t[r * width + j * kMaxConsumers];
    mbar_arrive(&empty[slot]);
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) out_row[c + j * kMaxConsumers] = acc[j];
}

template <typename T, int NC>
__device__ __forceinline__ void consume_rows(const T* ring, unsigned long long* full,
                             unsigned long long* empty, int len, int ntiles,
                             const Long& g, int width, int c, T* out_row) {
  constexpr bool f32 = sizeof(T) == 4;
  if (g.rows == (f32 ? 32 : 16))
    consume<T, NC, f32 ? 32 : 16>(ring, full, empty, len, ntiles, g.stages,
                                  width, c, out_row);
  else if (g.rows == (f32 ? 16 : 8))
    consume<T, NC, f32 ? 16 : 8>(ring, full, empty, len, ntiles, g.stages,
                                 width, c, out_row);
  else
    consume<T, NC, f32 ? 8 : 4>(ring, full, empty, len, ntiles, g.stages,
                                width, c, out_row);
}

template <typename T>
__device__ __forceinline__ void sum_long(const T* __restrict__ x,
                         const long long* __restrict__ perm, long long begin,
                         long long end, T* __restrict__ out_row, int width,
                         const Long& g, bool first) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* empty = full + kMaxStages;
  const int P = g.pwarps;
  long long* prings = reinterpret_cast<long long*>(smem + kHeader);
  T* ring = reinterpret_cast<T*>(smem + kHeader
                                 + 8 * P * kPermStages * g.rows);
  const int len = (int)(end - begin);
  const int ntiles = (len + g.rows - 1) / g.rows;
  const int consumers = min(width, kMaxConsumers);
  if (threadIdx.x == 0) {
    for (int i = 0; i < g.stages; ++i) {
      if (!first) {
        mbar_inval(&full[i]);
        mbar_inval(&empty[i]);
      }
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], (unsigned)consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (warp >= g.cwarps) {
    const int p = warp - g.cwarps;
    if (p >= P) return;
    produce<T>(x, perm, begin, len, ntiles, ring,
               prings + p * kPermStages * g.rows, full, empty, width, g, p,
               P, threadIdx.x & 31);
    return;
  }
  const int c = threadIdx.x;
  if (c >= consumers) return;
  if (c + kMaxConsumers < width)
    consume_rows<T, 2>(ring, full, empty, len, ntiles, g, width, c, out_row);
  else
    consume_rows<T, 1>(ring, full, empty, len, ntiles, g, width, c, out_row);
}

template <typename T>
__device__ __forceinline__ void sum_short(const T* __restrict__ x,
                          const long long* __restrict__ perm,
                          const long long* __restrict__ offsets,
                          T* __restrict__ out, int n, int width,
                          int skip_rows, unsigned block) {
  const unsigned total = (unsigned)n * (unsigned)width;
  const unsigned t = block * kThreads + threadIdx.x;
  if (t >= total) return;
  const unsigned s = t / (unsigned)width;
  const unsigned c = t - s * (unsigned)width;
  long long k = offsets[s];
  const long long end = offsets[s + 1];
  if (end - k >= skip_rows) return;   // a worker block sums it
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

// blocks [0, short_blocks): one thread per output of the short segments;
// the `workers` blocks after them: the long list's entries w, w + workers,
// ... (a whole block each, in turn)
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
segment_sum_kernel(const T* __restrict__ x, const long long* __restrict__ perm,
                   const long long* __restrict__ offsets,
                   const int* __restrict__ long_ids,
                   const long long* __restrict__ long_count,
                   T* __restrict__ out, long long rows, int n, int width,
                   int short_blocks, int workers, Long g) {
  if (blockIdx.x == 0 && threadIdx.x == 0) check_contract(offsets, rows, n);
  if ((int)blockIdx.x < short_blocks) {
    sum_short<T>(x, perm, offsets, out, n, width, kLongRows, blockIdx.x);
    return;
  }
  const int w = (int)blockIdx.x - short_blocks;
  const long long count = *long_count;
  for (long long e = w; e < count; e += workers) {
    const bool first = e == w;
    if (!first) __syncthreads();     // done with the last segment's ring
    const int s = long_ids[e];
    sum_long<T>(x, perm, offsets[s], offsets[s + 1],
                out + (long long)s * width, width, g, first);
  }
}

// every output by one thread: for calls with no more rows than segments
// (the dense solvers' pair sums), whose blocks then need no ring and keep
// the SM's full occupancy and L1 cache
template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_short_kernel(const T* __restrict__ x,
                         const long long* __restrict__ perm,
                         const long long* __restrict__ offsets,
                         T* __restrict__ out, long long rows, int n,
                         int width) {
  if (blockIdx.x == 0 && threadIdx.x == 0) check_contract(offsets, rows, n);
  sum_short<T>(x, perm, offsets, out, n, width, INT_MAX, blockIdx.x);
}

// the widest copy that keeps every row's source and destination aligned
int copy_bytes(const void* x, int row_bytes) {
  const uintptr_t a = (uintptr_t)x | (uintptr_t)row_bytes;
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : 4;
}

// the long path's tile and ring for rows of `width`: the most rows a tile
// (of 32 / 16 / 8 for float, 16 / 8 / 4 for double) that leave a ring of
// at least kMinStages tiles within kSmemBudget; past that the fewest rows
// and kMinStages - 2 tiles, above the budget. Returns the shared memory.
template <typename T>
size_t long_shape(const T* x, int width, Long* g) {
  const int consumers = width < kMaxConsumers ? width : kMaxConsumers;
  g->cwarps = (consumers + 31) / 32;
  g->vec = copy_bytes(x, width * (int)sizeof(T));
  g->pwarps = kWarps - g->cwarps < kMaxProducers ? kWarps - g->cwarps
                                                   : kMaxProducers;
  const int P = g->pwarps;         // the perm rings' count, at most
  const long long stage_row = (long long)width * sizeof(T);
  const int first = sizeof(T) == 4 ? 32 : 16;
  for (int rows = first; rows >= first / 4; rows /= 2) {
    const long long rest = kSmemBudget - kHeader - 8LL * P * kPermStages * rows;
    long long stages = rest / (stage_row * rows);
    if (stages > kMaxStages) stages = kMaxStages;
    g->rows = rows;
    g->stages = (int)stages;
    if (stages >= kMinStages) break;
  }
  if (g->stages < kMinStages) g->stages = kMinStages - 2;
  // a producer waits for its slot's last tile to be consumed; with more
  // producers than slots two could wait on one slot, a phase apart, and a
  // parity wait cannot tell those phases apart
  if (g->pwarps > g->stages) g->pwarps = g->stages;
  return kHeader + 8ULL * g->pwarps * kPermStages * g->rows
         + (size_t)g->stages * g->rows * stage_row;
}

template <typename T>
int launch(const T* x, const long long* perm, const long long* offsets,
           const int* long_ids, const long long* long_count, T* out,
           long long rows, int n, int width, int workers,
           cudaStream_t stream) {
  if (n <= 0 || width <= 0) return 0;
  if ((long long)n * width > INT_MAX || rows > INT_MAX || workers < 0)
    return (int)cudaErrorInvalidValue;
  const long long short_blocks = ((long long)n * width + kThreads - 1) / kThreads;
  if (short_blocks + kMaxWorkers > INT_MAX) return (int)cudaErrorInvalidValue;
  if (width > kMaxLongWidth || rows <= n) {
    segment_sum_short_kernel<T><<<(unsigned)short_blocks, kThreads, 0, stream>>>(
        x, perm, offsets, out, rows, n, width);
    return (int)cudaGetLastError();
  }
  // at most kMaxWorkers blocks walk the long list, after the short blocks
  if (workers > kMaxWorkers) workers = kMaxWorkers;
  const long long blocks = short_blocks + workers;
  Long g{0, 0, 0, 0, 0};
  size_t smem = 0;
  if (workers > 0) {
    smem = long_shape<T>(x, width, &g);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          segment_sum_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
  }
  segment_sum_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      x, perm, offsets, long_ids, long_count, out, rows, n, width,
      (int)short_blocks, workers, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int segment_sum_f32(const float* x, const long long* perm,
                               const long long* offsets, const int* long_ids,
                               const long long* long_count, float* out,
                               long long rows, int n, int width, int workers,
                               cudaStream_t stream) {
  return launch<float>(x, perm, offsets, long_ids, long_count, out, rows, n,
                       width, workers, stream);
}

extern "C" int segment_sum_f64(const double* x, const long long* perm,
                               const long long* offsets, const int* long_ids,
                               const long long* long_count, double* out,
                               long long rows, int n, int width, int workers,
                               cudaStream_t stream) {
  return launch<double>(x, perm, offsets, long_ids, long_count, out, rows, n,
                        width, workers, stream);
}
