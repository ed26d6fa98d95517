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
// lower index. The rule computes a function of the multiset of (d, j), so
// every merge order gives the same bits, and so does every split of B.
//
// Bound: the products. At Ka = Kb = 2048, D = 128 they are 1.07 GFLOP
// against 2 MB of input (16 us at the SIMT f32 peak). They run on the
// tensor cores in 3xTF32: each operand splits into hi = tf32(x) and
// lo = tf32(x - hi) (round to nearest, ties away), and a.b accumulates
// lo.hi + hi.lo + hi.hi per k step in f32. The dropped lo.lo term is
// ~2^-22 |a||b|, the size of f32 reordering error; a single TF32 or bf16
// pass would move distances by ~1e-3 and flip near-tied ratio tests (the
// JAX package's ops/distance.py records that for bf16). Three products
// take 6.5 us at the 495 TFLOP/s TF32 rate, which only wgmma reaches; an
// earlier form of this kernel on mma.sync.m16n8k8 was slower (PERF.md).
//
// Design: one warpgroup per block owns 64 A rows (warp w rows 16w..16w+15)
// and walks its range of B in 32-row tiles, one wgmma.m64n32k8 group of
// 3 x D/8 products per tile. The A tile is staged once with cp.async, in two
// halves through the staging buffer, and split once: at D = 128 into hi and
// lo fragments that stay in registers for the whole block (128 of its 206
// registers, so only B is read from shared memory), at other widths into
// shared memory. Each B tile is copied with 16-byte cp.async (D fixed at
// 128 at compile time on the main path), then split once into hi and lo in
// the products' canonical K-major layout (8-row x 16-byte core matrices, no
// swizzle) while the squared norms are summed; the copy of the next tile
// overlaps the products and the fold. Two blocks share an SM (50 KB of
// shared memory each, registers the limit), so one block's split and fold
// overlap the other's products. Norms are f32 sums in a fixed order; B rows
// past Kb get an infinite norm, so their distances never win and the fold
// needs no mask. Each thread keeps a running (best, second, idx) for its two
// rows over the columns it sees (increasing, so a tie keeps the lower
// index); a row's quad of lanes merges once, at the end.
//
// One tracked frame is one pair, 32 blocks of A rows: too few for the card,
// so the B range is split over `nsplit` blocks, as many as fit on the card
// at once (the caller plans it from `l2_2nn_blocks_per_sm`, the occupancy
// of the instance it runs). The splits merge in the same
// launch: each block writes its partial rows, and the last block of an A
// tile to arrive (a per-tile counter: __threadfence + atomicAdd) merges the
// partials in split order and resets its counter to 0 for the next launch.
// The caller keeps one scratch (counters + partials) per stream, so two
// streams never share a counter.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTA = 64;            // A rows per block
constexpr int kTB = 32;            // B rows per tile
constexpr int kThreads = 128;      // one warpgroup
constexpr int kPad = 4;            // row stride D + 4 words (D % 8 == 0)
constexpr int kMaxD = 192;         // 168 KB of shared memory at most
constexpr int kMaxDevices = 64;
constexpr float kBig = 1e30f;      // the Pallas kernel's initial state
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ Nn shfl_merge(Nn x, int mask) {
  Nn o;
  o.best = __shfl_xor_sync(kFull, x.best, mask);
  o.second = __shfl_xor_sync(kFull, x.second, mask);
  o.idx = __shfl_xor_sync(kFull, x.idx, mask);
  return merge(x, o);
}

// f32 -> tf32, round to nearest with ties away from zero (cvt.rna's rule),
// the 13 low mantissa bits cleared
__device__ __forceinline__ float tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One k8 step of a 64 x 32 tile, d (+)= A[64 x 8] B[32 x 8]^T, tf32 in,
// f32 accumulate; scale_d == 0 overwrites d. B comes from shared memory
// through a descriptor (K-major, no swizzle); A from shared memory too
// (wgmma_ss) or from registers in the mma fragment layout of each warp's
// 16 rows (wgmma_rs). Asynchronous: d is not touched until
// wgmma.wait_group says the group is done.
#define L2NN_D16                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n}\n"
      : L2NN_D16
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const unsigned (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : L2NN_D16
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
#undef L2NN_D16

// keeps the compiler from moving accumulator registers across the
// asynchronous products
__device__ __forceinline__ void pin(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Shared-memory descriptor of a K-major operand without swizzle: 8-row x
// 16-byte core matrices, the two of a k8 step 128 bytes apart (LBO) and
// successive 8-row groups `sbo` bytes apart.
__device__ __forceinline__ uint64_t descriptor(const float* p, int sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

struct Params {
  const float* a;          // [P, Ka, D]
  const float* b;          // [P, Kb, D]
  float* out;              // [3, P, Ka]: best, second, idx (int32 bits)
  float* part;             // [3, P, nsplit, Ka]: the same, per split
  int* counters;           // [P, a_tiles], 0 between launches
  int P, Ka, Kb, D, nsplit, per;
  int vec;                 // 16-byte copies: D % 4 == 0, aligned rows
};

// Copy rows row0 .. row0 + N - 1 of src [rows, D] into X [N][ld]
// (columns < D); rows past `rows` are zero-filled by the copy itself.
template <int KD, int N>
__device__ __forceinline__ void stage(float* X, const float* src, int row0,
                                      int rows, int D, int ld, bool vec,
                                      int tid) {
  if (vec) {
    constexpr int kNc = KD / 4;
    const int nc = KD ? kNc : D / 4;       // 16-byte chunks per row
    for (int e = tid; e < N * nc; e += kThreads) {
      const int r = e / nc, c = e - r * nc;
      const bool ok = row0 + r < rows;
      cp_async16(&X[r * ld + 4 * c],
                 src + (long long)(ok ? row0 + r : 0) * D + 4 * c,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < N * D; e += kThreads) {
      const int r = e / D, c = e - r * D;
      const bool ok = row0 + r < rows;
      cp_async4(&X[r * ld + c], src + (long long)(ok ? row0 + r : 0) * D + c,
                ok ? 4 : 0);
    }
  }
  cp_async_commit();
}

// Split the N raw rows of X [N][ld] (columns < dp, the pad columns zero)
// into tf32 hi and lo parts in the canonical layout of the products (row r,
// 16-byte chunk kc at byte (r / 8) sbo + 128 kc + 16 (r % 8)), and write
// each thread's partial squared norm of its row to part[q][r]: thread
// (r = tid % N, q = tid / N) takes chunks q, q + 128 / N, ... in order.
// Eight consecutive lanes read 8 rows (stride D + 4 words: 32 banks) and
// write 128 contiguous bytes.
template <int N>
__device__ __forceinline__ void split_rows(const float* X, float* hi, float* lo,
                                           float* part, int nkc, int ld, int sbo,
                                           int tid) {
  constexpr int kQ = kThreads / N;
  const int r = tid % N, q = tid / N;
  char* hb = reinterpret_cast<char*>(hi) + (r / 8) * sbo + (r % 8) * 16;
  char* lb = reinterpret_cast<char*>(lo) + (r / 8) * sbo + (r % 8) * 16;
  float s = 0.f;
  for (int kc = q; kc < nkc; kc += kQ) {
    const float4 v = *reinterpret_cast<const float4*>(&X[r * ld + 4 * kc]);
    s = fmaf(v.x, v.x, s);
    s = fmaf(v.y, v.y, s);
    s = fmaf(v.z, v.z, s);
    s = fmaf(v.w, v.w, s);
    const float4 h = make_float4(tf32(v.x), tf32(v.y), tf32(v.z), tf32(v.w));
    *reinterpret_cast<float4*>(hb + 128 * kc) = h;
    *reinterpret_cast<float4*>(lb + 128 * kc) = make_float4(
        tf32(v.x - h.x), tf32(v.y - h.y), tf32(v.z - h.z), tf32(v.w - h.w));
  }
  part[q * N + r] = s;
}

__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The 3xTF32 products of one tile into acc, issued as one wgmma group: per
// k step lo.hi, hi.lo, then hi.hi, in this order. A from shared memory.
__device__ __forceinline__ void products_ss(float (&acc)[16], uint64_t ah,
                                            uint64_t al, uint64_t bh,
                                            uint64_t bl, int nks) {
  pin(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  for (int ks = 0; ks < nks; ++ks) {
    const uint64_t o = 16 * ks;              // 256 bytes: two 16-byte chunks
    wgmma_ss(acc, al + o, bh + o, ks > 0);
    wgmma_ss(acc, ah + o, bl + o, 1);
    wgmma_ss(acc, ah + o, bh + o, 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// The same with A's hi and lo fragments in registers, K = 8 * KS.
template <int KS>
__device__ __forceinline__ void products_rs(float (&acc)[16],
                                            const unsigned (&ahi)[KS][4],
                                            const unsigned (&alo)[KS][4],
                                            uint64_t bh, uint64_t bl) {
  pin(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint64_t o = 16 * ks;
    wgmma_rs(acc, alo[ks], bh + o, ks > 0);
    wgmma_rs(acc, ahi[ks], bl + o, 1);
    wgmma_rs(acc, ahi[ks], bh + o, 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// The running state of one thread: rows g and g + 8 of its warp's 16, over
// the columns it sees (increasing, so a tie keeps the lower index).
struct Run {
  float best[2], second[2], nar[2];
  int idx[2];
};

// Fold tile `tile`'s products into the running state. acc element
// 4j + 2h + e sits at row g + 8h, column 8j + 2t + e; a column's squared
// norm is the sum of its four partials in order, +inf past Kb.
__device__ __forceinline__ void fold(Run& run, const float (&acc)[16],
                                     const float* nbp, int tile, int Kb, int g,
                                     int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * t + e;
      const int col = tile * kTB + c;
      const float nb = col < Kb ? ((nbp[c] + nbp[kTB + c]) + nbp[2 * kTB + c]) +
                                      nbp[3 * kTB + c]
                                : INFINITY;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float d = fmaxf(
            __fsub_rn(__fadd_rn(run.nar[h], nb), 2.f * acc[4 * j + 2 * h + e]),
            0.f);
        run.second[h] = fminf(run.second[h], fmaxf(run.best[h], d));
        run.idx[h] = d < run.best[h] ? col : run.idx[h];
        run.best[h] = fminf(run.best[h], d);
      }
    }
  }
}

// Dynamic shared memory, floats: B hi, B lo [32 x dp] in the canonical
// layout; the raw staging buffer R [32][ld], which takes the A tile in two
// halves, then each B tile; and, where A is not held in registers (KD ==
// 0), A hi, A lo [64 x dp] canonical.
int smem_bytes(int D, bool a_in_smem) {
  const int dp = (D + 7) / 8 * 8;
  return (int)sizeof(float) *
         ((a_in_smem ? 2 * kTA * dp : 0) + 2 * kTB * dp + 32 * (dp + kPad));
}

template <int KD>
__global__ void __launch_bounds__(kThreads)
l2_2nn_kernel(Params p) {
  extern __shared__ __align__(128) float smem[];
  __shared__ float na_part[2][4 * 32];       // [A half][q][row], KD == 0
  __shared__ float nb_part[4 * kTB];         // [q][column]
  __shared__ int is_last;

  const int D = KD ? KD : p.D;
  const int dp = KD ? KD : (p.D + 7) / 8 * 8;
  const int ld = dp + kPad, nkc = dp / 4, sbo = 128 * nkc;
  float* Bh = smem;
  float* Bl = Bh + kTB * dp;
  float* R = Bl + kTB * dp;
  float* Ah = R + 32 * ld;                   // KD == 0 only
  float* Al = Ah + kTA * dp;

  const int pair = blockIdx.z;
  const int split = blockIdx.y;
  const int row0 = blockIdx.x * kTA;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;      // the fragment coordinates
  const bool vec = KD ? true : p.vec != 0;
  const float* ap = p.a + (long long)pair * p.Ka * D;
  const float* bp = p.b + (long long)pair * p.Kb * D;
  const int n_tiles = (p.Kb + kTB - 1) / kTB;
  const int t_begin = split * p.per;
  const int t_end = min(n_tiles, t_begin + p.per);

  if (!KD && dp != D) {                      // zero R's pad columns once
    for (int e = tid; e < 32 * (dp - D); e += kThreads)
      R[(e / (dp - D)) * ld + D + e % (dp - D)] = 0.f;
    __syncthreads();
  }

  // the A tile, half by half through R: split into tf32 hi and lo, into
  // registers (KD: warp w's rows 16w + g and + 8, mma fragment layout) or
  // into shared memory; the rows' squared norms in a fixed order
  constexpr int kKS = KD ? KD / 8 : 1;
  unsigned ahi[kKS][4], alo[kKS][4];
  Run run;
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    stage<KD, 32>(R, ap, row0 + 32 * half, p.Ka, D, ld, vec, tid);
    cp_async_wait_all();
    __syncthreads();
    if (KD) {
      if (warp / 2 == half) {
        const float* x = R + (warp % 2) * 16 * ld;
        float s[2] = {0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {      // (g, t) (g+8, t) (g, t+4) (g+8, t+4)
            const float v = x[(g + 8 * (q % 2)) * ld + 8 * ks + t + 4 * (q / 2)];
            const float h = tf32(v);
            ahi[ks][q] = __float_as_uint(h);
            alo[ks][q] = __float_as_uint(tf32(v - h));
            s[q % 2] = fmaf(v, v, s[q % 2]);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {        // the quad's four lanes: same bits
          s[h] += __shfl_xor_sync(kFull, s[h], 1);
          s[h] += __shfl_xor_sync(kFull, s[h], 2);
          run.nar[h] = s[h];
        }
      }
    } else {
      split_rows<32>(R, Ah + half * sbo, Al + half * sbo, na_part[half], nkc,
                     ld, sbo, tid);
    }
    __syncthreads();                         // R consumed
  }
  stage<KD, kTB>(R, bp, t_begin * kTB, p.Kb, D, ld, vec, tid);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!KD) {
      const int r = warp * 16 + g + 8 * h;   // this thread's rows
      const float* np = na_part[r / 32];
      run.nar[h] = ((np[r % 32] + np[32 + r % 32]) + np[64 + r % 32]) +
                   np[96 + r % 32];
    }
    run.best[h] = run.second[h] = kBig;
    run.idx[h] = 0;
  }
  const uint64_t dah = descriptor(Ah, sbo), dal = descriptor(Al, sbo);
  const uint64_t dbh = descriptor(Bh, sbo), dbl = descriptor(Bl, sbo);

  // per tile: split it, start the next tile's copy, run the products (the
  // other blocks on the SM split and fold meanwhile), fold
  float acc[16];
#pragma unroll 1
  for (int tile = t_begin; tile < t_end; ++tile) {
    cp_async_wait_all();
    __syncthreads();                         // tile landed; tile - 1 folded
    split_rows<kTB>(R, Bh, Bl, nb_part, nkc, ld, sbo, tid);
    fence_async_proxy();
    __syncthreads();                         // hi / lo visible; R consumed
    if (tile + 1 < t_end)
      stage<KD, kTB>(R, bp, (tile + 1) * kTB, p.Kb, D, ld, vec, tid);
    if (KD)
      products_rs<kKS>(acc, ahi, alo, dbh, dbl);
    else
      products_ss(acc, dah, dal, dbh, dbl, dp / 8);
    wgmma_wait_all();
    pin(acc);
    fold(run, acc, nb_part, tile, p.Kb, g, t);
  }

  // a row's quad of lanes merges; lane t == 0 holds the block's row
  Nn fin[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    fin[h] = shfl_merge(Nn{run.best[h], run.second[h], run.idx[h]}, 1);
    fin[h] = shfl_merge(fin[h], 2);
  }
  const long long plane = (long long)p.P * p.Ka;
  int* out_idx = reinterpret_cast<int*>(p.out + 2 * plane);
  if (p.nsplit == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + warp * 16 + g + 8 * h;
      if (t == 0 && row < p.Ka) {
        const long long o = (long long)pair * p.Ka + row;
        p.out[o] = fin[h].best;
        p.out[plane + o] = fin[h].second;
        out_idx[o] = fin[h].idx;
      }
    }
    return;
  }

  // split merge in this launch: publish the partial, count the arrival
  const long long pplane = plane * p.nsplit;
  float* part_best = p.part;
  float* part_second = p.part + pplane;
  int* part_idx = reinterpret_cast<int*>(p.part + 2 * pplane);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + warp * 16 + g + 8 * h;
    if (t == 0 && row < p.Ka) {
      const long long o = ((long long)pair * p.nsplit + split) * p.Ka + row;
      part_best[o] = fin[h].best;
      part_second[o] = fin[h].second;
      part_idx[o] = fin[h].idx;
    }
  }
  __threadfence();
  __syncthreads();
  int* counter = p.counters + (long long)pair * gridDim.x + blockIdx.x;
  if (tid == 0) is_last = atomicAdd(counter, 1) == p.nsplit - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int row = row0 + tid;
  if (tid < kTA && row < p.Ka) {
    Nn m = {kBig, kBig, 0};
    for (int s = 0; s < p.nsplit; ++s) {
      const long long q = ((long long)pair * p.nsplit + s) * p.Ka + row;
      m = merge(m, Nn{__ldcg(&part_best[q]), __ldcg(&part_second[q]),
                      __ldcg(&part_idx[q])});
    }
    const long long o = (long long)pair * p.Ka + row;
    p.out[o] = m.best;
    p.out[plane + o] = m.second;
    out_idx[o] = m.idx;
  }
  if (tid == 0) *counter = 0;                // ready for the next launch
}

// Allow the instance its largest shared memory on the current device. The
// attribute is per device and per kernel: set once per process.
template <int KD>
cudaError_t prepare() {
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(l2_2nn_kernel<KD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes(KD ? KD : kMaxD, KD == 0));
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  return cudaSuccess;
}

template <int KD>
int launch(const Params& p, int a_tiles, cudaStream_t stream) {
  const cudaError_t err = prepare<KD>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a_tiles, p.nsplit, p.P);
  l2_2nn_kernel<KD><<<grid, kThreads, smem_bytes(p.D, KD == 0), stream>>>(p);
  return (int)cudaGetLastError();
}

template <int KD>
int blocks_per_sm(int D, int* blocks) {
  const cudaError_t err = prepare<KD>();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, l2_2nn_kernel<KD>, kThreads, smem_bytes(D, KD == 0));
}

// The instance a call runs: D = 128 at compile time where the rows allow
// 16-byte copies, D at run time otherwise.
bool fixed_128(int D, bool vec) { return D == 128 && vec; }

}  // namespace

// *blocks = how many blocks of the instance that l2_2nn runs for width D
// (vec: D % 4 == 0 and both operands 16-byte aligned) fit on one SM of the
// current device at once, from its registers and shared memory; the
// caller's split planner uses it. Returns a cudaError_t.
extern "C" int l2_2nn_blocks_per_sm(int D, int vec, int* blocks) {
  if (D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  return fixed_128(D, vec != 0) ? blocks_per_sm<128>(D, blocks)
                                : blocks_per_sm<0>(D, blocks);
}

// a: [P, Ka, D], b: [P, Kb, D] f32 with 1 <= D <= 192 and Kb >= 1; out:
// [3, P, Ka] (best, second, idx as int32); part: [3, P, nsplit, Ka] scratch
// (read only when nsplit > 1); counters: [P, ceil(Ka / 64)] int32, all 0
// (left 0). nsplit * per must cover ceil(Kb / 32) tiles with no empty split;
// P <= 65535.
// One launch; returns its cudaError_t.
extern "C" int l2_2nn(const float* a, const float* b, float* out, float* part,
                      int* counters, int P, int Ka, int Kb, int D, int nsplit,
                      int per, cudaStream_t stream) {
  if (P == 0 || Ka == 0) return 0;
  if (D < 1 || D > kMaxD || Kb < 1 || nsplit < 1 || per < 1 || P > 65535)
    return (int)cudaErrorInvalidValue;
  const bool aligned = ((uintptr_t)a % 16 == 0) && ((uintptr_t)b % 16 == 0);
  Params p{a, b, out, part, counters, P, Ka, Kb, D, nsplit, per,
           (D % 4 == 0 && aligned) ? 1 : 0};
  const int a_tiles = (Ka + kTA - 1) / kTA;
  if (fixed_128(D, p.vec != 0)) return launch<128>(p, a_tiles, stream);
  return launch<0>(p, a_tiles, stream);
}
