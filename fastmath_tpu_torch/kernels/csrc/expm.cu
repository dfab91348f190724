// Batched matrix exponential for Hopper (sm_90a): scaling and squaring
// with a Taylor-Horner core.
//
// Replaces the Pallas TPU kernels of fastmath_tpu/kernels/expm_pallas.py
// (both behind expm_cf):
//   expm_unrolled <- _expm_kernel         (d <= 8 there and here, one
//                                          thread a problem)
//   expm_warp     <- _expm_rolled_kernel  (9 <= d <= 32, a lane group a
//                                          problem)
//
// Each problem is one real d x d matrix X (d <= 32), read through its
// strides (lie_common.cuh). The algebra is the reference's:
//   s = clip(ceil(log2(max(|X|_1, 1e-30) / 0.5)), 0, 20), |X|_1 the largest
//       column sum of |x_ij| (each column summed over i in order);
//   Y = X 2^-s (exact);
//   R = I + Y / order, then R = I + (Y R) / m for m = order - 1 .. 1
//       (order 9 in float32, 16 in float64), the divisions as products by
//       the reciprocal 1/m;
//   then R = R R, exactly s times for this problem.
// Each problem squares its own s times and stops; the TPU kernel runs a
// block of problems to the block's largest s under a mask, which gives
// the same values.
//
// Tiers, split where the times on the card put them (chip_ab.py, NVIDIA
// H100 80GB HBM3 at 700 W; -Xptxas -v for registers):
//   expm_unrolled<T, D, P, kOwn>: one thread a problem, every index a
//     compile-time constant, P problems a block, d <= 8 in both dtypes. A
//     batch-major block is staged through shared memory (tile_stage.cuh:
//     16-byte vectors in order, each problem in a region of its own at an
//     odd stride) and written back the same way; kOwn, for channel-first
//     and transposed operands (and d = 1), has each thread read and write
//     its own problem. To d = 6 Y, R and a product temporary live in
//     registers (3 d^2 values). At d = 7, 8 Y stays in the thread's region
//     and each product reads its left factor from there a row at a time
//     (R R reads R, which the region then holds), so only R and the
//     product are registers (2 d^2: 128 at d = 8 in float32, not 192),
//     and the Horner steps and the squarings run as loops rather than
//     unrolled, which keeps the code a few products long. The 8 x 8
//     float32 batch took 0.31 ms with every matrix in registers and 64
//     problems a block staged a value at a time, 0.11 ms so (36% of its
//     operation bound); float64 at d = 7, 8 takes less than half the
//     time of expm_warp's lane groups, although d = 8 spills (2 d^2
//     doubles).
//   expm_warp<T, G, R, C>: a group of G lanes a problem (32 / G problems a
//     warp), 9 <= d <= 32. Each lane holds an R x C block of every product
//     in registers (8 x 8: G = 4 to d = 16, 16 above; float64 at 17..24
//     and 29..32 8 x 4 on 32 lanes) and sums its R C entries at once, each
//     step R + C values read from shared memory as 16-byte vectors, the
//     next step's issued first. A problem keeps two matrices in shared
//     memory: Y^T (the left factor's transpose, which the last Horner step
//     replaces with R^T) and R; each product is written back over them once
//     its group has read them. Every sum runs t = 0 .. d - 1 and nothing
//     past d is read into a real entry, so the padding to whole blocks is
//     never zeroed. The kernel it replaced formed a column a lane, each
//     entry one chain of G multiply-adds from a broadcast row: four bytes
//     of shared memory read a multiply-add, which an SM serves at a quarter
//     of its FMA rate (a 16-byte read costs the SM 16 bytes a lane,
//     broadcast or not); 8 x 8 blocks read one byte a multiply-add in
//     float32, 4 x 4 blocks two. At 16 x 16 the write-backs take 8% of the
//     time and the barriers 4% (PERF.md); the rest is not explained yet.
//   Each entry sums as the column design did once compiled: a_0 b_0 +
//   (a_1 b_1), the second product rounded first (nvcc's contraction of its
//   first two terms), then one multiply-add a term, then add + acc scale as
//   one multiply-add; the outputs are the column design's bit for bit.
//
// What bounds them: a problem reads and writes d^2 values and needs
// (order - 1 + s) products of about 2 d^3 operations: at 4x4 in float32
// about 11 operations per byte moved, below the card's 20, so the 4x4
// batch is bound by bytes (hence the staged tiles); about 20 at d = 8 and
// 43 at d = 16, bound by operations.
// Multiply-adds contract into FMAs, so results move a few ulp from the
// plain PyTorch version (fastmath_tpu_torch/kernels/expm.py,
// expm_plain), which repeats this arithmetic.
//
// Every launch goes on the caller's stream, allocates nothing and does
// not synchronize; the entry point returns cudaGetLastError().

#include "lie_common.cuh"
#include "tile_stage.cuh"

namespace fm {

constexpr int kSquaringsMax = 20;
// the largest d of the one-thread tier, by dtype (registers, see above)
template <typename T>
constexpr int expm_unroll_max();
template <>
constexpr int expm_unroll_max<float>() { return 8; }
template <>
constexpr int expm_unroll_max<double>() { return 8; }
// the largest d whose one-thread tier keeps Y, R and the product in
// registers; above, Y is read from the thread's region in shared memory
constexpr int kExpmRegsMax = 6;

template <typename T>
__host__ __device__ constexpr int expm_order();
template <>
__host__ __device__ constexpr int expm_order<float>() { return 9; }
template <>
__host__ __device__ constexpr int expm_order<double>() { return 16; }

__device__ __forceinline__ float lie_log2(float x) { return log2f(x); }
__device__ __forceinline__ double lie_log2(double x) { return log2(x); }
__device__ __forceinline__ float lie_ceil(float x) { return ceilf(x); }
__device__ __forceinline__ double lie_ceil(double x) { return ceil(x); }

// The squaring count of a problem from its 1-norm.
template <typename T>
__device__ __forceinline__ int squarings(T norm) {
  T s = lie_ceil(lie_log2(fm_max(norm, T(1e-30)) / T(0.5)));
  s = s < T(0) ? T(0) : (s > T(kSquaringsMax) ? T(kSquaringsMax) : s);
  return (int)s;
}

// One problem's scaling and squaring on the thread's matrices in
// registers (d <= kExpmRegsMax): Y = X 2^-s in y, the result in r.
template <typename T, int D>
__device__ __forceinline__ void expm_regs(T (&y)[D * D], T (&r)[D * D]) {
  constexpr int W = D * D;
  constexpr int kOrder = expm_order<T>();
  T norm = T(0);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    T col = fm_abs(y[j]);
#pragma unroll
    for (int i = 1; i < D; ++i) col = col + fm_abs(y[i * D + j]);
    norm = j == 0 ? col : fm_max(norm, col);
  }
  const int s = squarings(norm);
  const T scale = lie_ldexp(T(1), -s);
#pragma unroll
  for (int e = 0; e < W; ++e) y[e] = y[e] * scale;
  T p[W];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) r[i * D + j] = (i == j ? T(1) : T(0)) + y[i * D + j] * (T(1) / T(kOrder));
#pragma unroll
  for (int m = kOrder - 1; m > 0; --m) {
    lie_mm<T, D>(y, r, p, T(1), T(1) / T(m));
#pragma unroll
    for (int e = 0; e < W; ++e) r[e] = p[e];
  }
  for (int it = 0; it < s; ++it) {
    lie_mm<T, D>(r, r, p);
#pragma unroll
    for (int e = 0; e < W; ++e) r[e] = p[e];
  }
}

// c = add I + scale (a b) as lie_mm forms it, with the left factor a read
// a row at a time from the thread's region (row-major, D x D) and b, c in
// registers.
template <typename T, int D>
__device__ __forceinline__ void expm_rows(const T* a, const T (&b)[D * D], T (&c)[D * D],
                                          T scale) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    T ai[D];
#pragma unroll
    for (int k = 0; k < D; ++k) ai[k] = a[i * D + k];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      T acc = ai[0] * b[j];
#pragma unroll
      for (int k = 1; k < D; ++k) acc = acc + ai[k] * b[k * D + j];
      c[i * D + j] = i == j ? T(1) + acc * scale : acc * scale;
    }
  }
}

// r <- r r, the left factor read from the region m, which holds r; each
// row of the product is written back over its own row of m once it is
// formed (no later row reads it), so m holds the new r at the end.
template <typename T, int D>
__device__ __forceinline__ void expm_square(T* m, T (&r)[D * D]) {
  T p[D * D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    T ai[D];
#pragma unroll
    for (int k = 0; k < D; ++k) ai[k] = m[i * D + k];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      T acc = ai[0] * r[j];
#pragma unroll
      for (int k = 1; k < D; ++k) acc = acc + ai[k] * r[k * D + j];
      p[i * D + j] = acc;
    }
#pragma unroll
    for (int j = 0; j < D; ++j) m[i * D + j] = p[i * D + j];
  }
#pragma unroll
  for (int e = 0; e < D * D; ++e) r[e] = p[e];
}

// One problem's scaling and squaring with X in the thread's region m (d >
// kExpmRegsMax): Y = X 2^-s is scaled in place and read a row at a time as
// each product's left factor, so that only R and the product live in
// registers (2 d^2 values, not 3); the Horner steps run as a loop over
// pairs of steps (R -> P -> R), the squarings as a loop over one step,
// with R copied to m first. The result is in r and in m.
template <typename T, int D>
__device__ __forceinline__ void expm_region(T* m, T (&r)[D * D]) {
  constexpr int W = D * D;
  constexpr int kOrder = expm_order<T>();
  T norm = T(0);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    T col = fm_abs(m[j]);
#pragma unroll
    for (int i = 1; i < D; ++i) col = col + fm_abs(m[i * D + j]);
    norm = j == 0 ? col : fm_max(norm, col);
  }
  const int s = squarings(norm);
  const T scale = lie_ldexp(T(1), -s);
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const T v = m[i * D + j] * scale;
      m[i * D + j] = v;
      r[i * D + j] = (i == j ? T(1) : T(0)) + v * (T(1) / T(kOrder));
    }
  T p[W];
  int k = kOrder - 1;
  if constexpr ((kOrder - 1) % 2 == 1) {
    expm_rows<T, D>(m, r, p, T(1) / T(k));
#pragma unroll
    for (int e = 0; e < W; ++e) r[e] = p[e];
    --k;
  }
#pragma unroll 1
  for (; k > 0; k -= 2) {
    expm_rows<T, D>(m, r, p, T(1) / T(k));
    expm_rows<T, D>(m, p, r, T(1) / T(k - 1));
  }
#pragma unroll
  for (int e = 0; e < W; ++e) m[e] = r[e];
#pragma unroll 1
  for (int it = 0; it < s; ++it) expm_square<T, D>(m, r);
}

// The operand as given (read by the thread of its problem, kOwn) and as
// staged, and the result.
template <typename T>
struct ExpmPlan {
  MatView<T> mat;
  TileOperand<T> in;
  TileOut<T> out;
};

// One thread a problem, P problems a block. Batch-major operands (any
// flat layout: contiguous, broadcast, a row or column stride) are staged
// through the block's regions (tile_stage.cuh) in and out; a channel-first
// operand and result, or an operand whose rows are not flat channels (a
// transposed view), are read and written by each thread for its own
// problem (kOwn: neighbouring threads on neighbouring addresses in the
// channel-first layout), which keeps the staging's code out of the
// batch-major kernel. d <= kExpmRegsMax works in registers (expm_regs);
// above, on the thread's region (expm_region), which a kOwn kernel then
// takes for itself.
template <typename T, int D, int P, bool kOwn>
__global__ void __launch_bounds__(P) expm_unrolled(long long nb, ExpmPlan<T> plan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int W = D * D, S = staged_stride<T>(W);
  T* sm = reinterpret_cast<T*>(smem_raw);
  const long long b0 = blockIdx.x * (long long)P;
  const int np = nb - b0 < P ? (int)(nb - b0) : P;
  const long long b = b0 + threadIdx.x;
  T* m = sm + threadIdx.x * S;
  if constexpr (!kOwn) {
    tile_stage<T, false, staged_loads<T>(W)>(plan.in, b0, np, P, S, sm);
    __syncthreads();
  }
  if ((int)threadIdx.x < np) {
    const MatView<T>& a = plan.mat;
    T r[W];
    if constexpr (D <= kExpmRegsMax) {
      T y[W];
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j)
          y[i * D + j] = kOwn ? a.p[b * a.sb + i * a.rs + j * a.cs] : m[i * D + j];
      expm_regs<T, D>(y, r);
    } else {
      if constexpr (kOwn) {
#pragma unroll
        for (int i = 0; i < D; ++i)
#pragma unroll
          for (int j = 0; j < D; ++j) m[i * D + j] = a.p[b * a.sb + i * a.rs + j * a.cs];
      }
      expm_region<T, D>(m, r);
    }
    if constexpr (kOwn) {
      const View<T>& o = plan.out.v;
#pragma unroll
      for (int e = 0; e < W; ++e) o.p[b * o.sb + e * o.sc] = r[e];
    } else if constexpr (D <= kExpmRegsMax) {
#pragma unroll
      for (int e = 0; e < W; ++e) m[e] = r[e];
    }
  }
  if constexpr (!kOwn) {
    __syncthreads();
    tile_store<T>(plan.out, b0, np, P, S, sm);
  }
}

// x to p as vec_put does, but with flip the 16-byte vectors in the order 1,
// 0, 3, 2, ...: of two lanes that store rows 8 apart at the same columns
// (the same banks), one flips, and each access of the pair then hits
// different banks.
template <typename T, int N>
__device__ __forceinline__ void expm_put_flip(T* p, const T (&x)[N], bool flip) {
  constexpr int kW = 16 / (int)sizeof(T);
  if constexpr (N / kW < 2) {
    vec_put<T, N>(p, x);
  } else {
    struct alignas(16) V { T v[kW]; };
#pragma unroll
    for (int q = 0; q < N / kW; ++q) {
      V v;
#pragma unroll
      for (int e = 0; e < kW; ++e) v.v[e] = flip ? x[(q ^ 1) * kW + e] : x[q * kW + e];
      reinterpret_cast<V*>(p)[q ^ (flip ? 1 : 0)] = v;
    }
  }
}

// b <- add I + scale (a b) on a lane group's matrices (row stride ld): `at`
// holds a's transpose and b is row-major. A busy lane holds the R x C block
// at rows i0.., columns j0.. in registers, R C sums in flight, each step
// R / width vector reads of row t of `at` and C / width of row t of b (the
// group's lanes reading the same rows), the next step's reads issued
// before this step's multiply-adds. Each entry is the column design's sum
// (see the head of this file): a_0 b_0 + (a_1 b_1) with the second product
// rounded first, then t = 2 .. d - 1 in order, and no term past d (the
// column design's trailing terms were exact zeros); then
// add (on the diagonal, j - i = i0 - j0 = dgo) + acc scale as one
// multiply-add. Once the group has read its operands, each lane writes its
// block over b and, if trans, transposed over `at` (in a group of 16 or 32
// lanes the rows' vectors flipped in odd row blocks, the columns' in odd
// column blocks: expm_put_flip). Entries past d hold what their sums give
// and are never read into a real entry. Ends synchronized.
template <typename T, int G, int R, int C>
__device__ __forceinline__ void expm_grp_mm(T* at, T* b, bool trans, int ld, int d, int i0,
                                            int j0, bool busy, int dgo, unsigned mask, T add,
                                            T scale) {
  // 16 or 32 lanes a group; at G = 4 the flips measured slower
  const bool flip_r = G >= 16 && i0 / R % 2, flip_c = G >= 16 && j0 / C % 2;
  T acc[R][C];
  if (busy) {
    T x[R], y[C], xn[R], yn[C];
    const T* pa = at + i0;
    const T* pb = b + j0;
    vec_get<T, R>(pa, x);
    vec_get<T, C>(pb, y);
    vec_get<T, R>(pa + ld, xn);
    vec_get<T, C>(pb + ld, yn);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] = fm_fma(x[i], y[j], xn[i] * yn[j]);
    pa += 2 * ld;
    pb += 2 * ld;
    vec_get<T, R>(pa, x);
    vec_get<T, C>(pb, y);
#pragma unroll 2
    for (int t = 2; t < d - 1; ++t) {
      pa += ld;
      pb += ld;
      vec_get<T, R>(pa, xn);
      vec_get<T, C>(pb, yn);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) acc[i][j] = fm_fma(x[i], y[j], acc[i][j]);
#pragma unroll
      for (int i = 0; i < R; ++i) x[i] = xn[i];
#pragma unroll
      for (int j = 0; j < C; ++j) y[j] = yn[j];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) {
        // square blocks meet the diagonal only where i0 = j0
        const bool diag = R == C ? i == j && dgo == 0 : j - i == dgo;
        acc[i][j] = fm_fma(fm_fma(x[i], y[j], acc[i][j]), scale, diag ? add : T(0));
      }
  }
  __syncwarp(mask);
  if (busy) {
#pragma unroll
    for (int i = 0; i < R; ++i) expm_put_flip<T, C>(b + (i0 + i) * ld + j0, acc[i], flip_r);
    if (trans) {
#pragma unroll
      for (int j = 0; j < C; ++j) {
        T col[R];
#pragma unroll
        for (int i = 0; i < R; ++i) col[i] = acc[i][j];
        expm_put_flip<T, R>(at + (j0 + j) * ld + i0, col, flip_c);
      }
    }
  }
  __syncwarp(mask);
}

// The side of expm_warp's matrices at size d for R x C blocks: d rounded
// up to whole blocks both ways.
__host__ __device__ constexpr int expm_side(int d, int R, int C) {
  const int rows = (d + R - 1) / R * R, cols = (d + C - 1) / C * C;
  return rows > cols ? rows : cols;
}

// A group of G lanes a problem (32 / G problems a warp). Its two matrices,
// ld x ld with ld = expm_side, sit in the group's region of S values in
// shared memory: Y^T, which the last Horner step and then
// each squaring replace with R^T, and R. Lane gl holds the R x C block (R
// (gl / nbc), C (gl % nbc)) of each product (nbc column blocks; lanes past
// the blocks only load and store) and writes it back in place once the
// group has read the operands, so a problem needs two matrices, not four.
// Only the entries of rows and columns below d are read into real entries,
// so nothing is zeroed.
template <typename T, int G, int R, int C>
__global__ void __launch_bounds__(8 * kLieWarp)
expm_warp(long long nb, int d, int S, MatView<T> in, View<T> out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kOrder = expm_order<T>();
  const int lane = threadIdx.x % kLieWarp, gl = lane % G;
  const unsigned mask = lie_group_mask<G>(lane);
  const long long slot = blockIdx.x * (long long)(blockDim.x / G) + threadIdx.x / G;
  const int ld = expm_side(d, R, C), nbc = (d + C - 1) / C;
  T* yt = reinterpret_cast<T*>(smem_raw) + (threadIdx.x / G) * S;
  T* rm = yt + ld * ld;
  if (slot >= nb) return;  // the whole group; no block-wide barrier follows
  // column c of X to row c of Y^T, every copy in flight at once; then each
  // lane sums the absolute values of its columns in order
  for (int c = gl; c < d; c += G) {
    const T* base = in.p + slot * in.sb + c * in.cs;
    for (int i = 0; i < d; ++i) copy_async(yt + c * ld + i, base + i * in.rs);
  }
  copy_async_wait();
  T col = T(0);
  for (int c = gl; c < d; c += G) {
    T sum = T(0);
    for (int i = 0; i < d; ++i) sum = sum + fm_abs(yt[c * ld + i]);
    col = c == gl ? sum : fm_max(col, sum);
  }
  // the largest column sum: every column sum is >= 0 and fmax is exact
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) col = fm_max(col, __shfl_xor_sync(mask, col, o, G));
  const int s = squarings(col);
  const T scale = lie_ldexp(T(1), -s);
  for (int c = gl; c < d; c += G)
    for (int i = 0; i < d; ++i) {
      const T v = yt[c * ld + i] * scale;
      yt[c * ld + i] = v;
      rm[i * ld + c] = (i == c ? T(1) : T(0)) + v * (T(1) / T(kOrder));
    }
  __syncwarp(mask);
  const int bi = gl / nbc;
  const int i0 = R * bi, j0 = C * (gl - bi * nbc);
  const bool busy = i0 < d;
  // kOrder - 1 Horner steps R = I + (Y R) / m, m = kOrder - q, then s
  // squarings R = R R, whose left factor's transpose the last Horner step
  // writes over Y^T
  for (int q = 1; q < kOrder + s; ++q) {
    const bool horner = q < kOrder;
    expm_grp_mm<T, G, R, C>(yt, rm, q >= kOrder - 1, ld, d, i0, j0, busy, i0 - j0, mask,
                         horner ? T(1) : T(0), horner ? T(1) / T(kOrder - q) : T(1));
  }
  T* o = out.p + slot * out.sb;
  for (int c = gl; c < d; c += G)
    for (int i = 0; i < d; ++i) o[(i * d + c) * out.sc] = rm[i * ld + c];
}

// expm_warp with G lanes a problem and R x C blocks at size d.
template <typename T, int G, int R, int C>
void launch_expm_blocks(int d, long long nb, MatView<T> in, View<T> out, cudaStream_t s) {
  constexpr int kW = 16 / (int)sizeof(T);
  const int ld = expm_side(d, R, C);
  // an odd number of 16-byte vectors a region (measured better than 4 past
  // a multiple of 8 for the 8 groups of a warp at G = 4)
  int S = 2 * ld * ld;
  if (S / kW % 2 == 0) S += kW;
  const int per_warp = (kLieWarp / G) * S * (int)sizeof(T);  // at most 33 KB
  const int warps = lie_warps(per_warp);
  const int per_block = warps * (kLieWarp / G);
  const unsigned g = (unsigned)((nb + per_block - 1) / per_block);
  expm_warp<T, G, R, C><<<g, warps * kLieWarp, warps * per_warp, s>>>(nb, d, S, in, out);
}

// The one-thread tier at d = D: the operand staged where it is flat
// channels (entry (i, j) at i * d + j times a channel stride) and not
// channel-first with a channel-first result; each thread's own otherwise,
// and at d = 1, where a thread's one value is its neighbours' neighbour in
// every layout.
template <typename T, int D>
void launch_expm_unrolled(long long nb, MatView<T> in, View<T> out, cudaStream_t s) {
  constexpr int W = D * D, S = staged_stride<T>(W), P = staged_threads<T>(W);
  const View<const T> flat{in.p, in.sb, in.cs};
  const ExpmPlan<T> plan{in, tile_flat_operand<T>(flat, W, P, S), tile_flat_out<T>(out, W, P, S)};
  const bool own = D == 1 || in.rs != D * in.cs ||
                   (plan.in.batch_fastest && plan.out.batch_fastest);
  const int smem = own && D <= kExpmRegsMax ? 0 : P * S * (int)sizeof(T);
  const auto kern = own ? expm_unrolled<T, D, P, true> : expm_unrolled<T, D, P, false>;
  kern<<<(unsigned)((nb + P - 1) / P), P, smem, s>>>(nb, plan);
}

template <typename T>
cudaError_t launch_expm(int d, long long nb, MatView<T> in, View<T> out, cudaStream_t s) {
  if (d < 1 || d > kMaxN) return cudaErrorInvalidValue;
  if (d <= expm_unroll_max<T>()) {
    switch (d) {
#define FM_EXPM_CASE(K) \
  case K: if constexpr (K <= expm_unroll_max<T>()) launch_expm_unrolled<T, K>(nb, in, out, s); break;
      FM_EXPM_CASE(1) FM_EXPM_CASE(2) FM_EXPM_CASE(3) FM_EXPM_CASE(4)
      FM_EXPM_CASE(5) FM_EXPM_CASE(6) FM_EXPM_CASE(7) FM_EXPM_CASE(8)
#undef FM_EXPM_CASE
      default: return cudaErrorInvalidValue;
    }
  } else if (d <= 16) {  // the lane groups' shapes as the card measured them
    launch_expm_blocks<T, 4, 8, 8>(d, nb, in, out, s);
  } else if (sizeof(T) == 4 || (d > 24 && d <= 28)) {
    launch_expm_blocks<T, 16, 8, 8>(d, nb, in, out, s);
  } else {
    launch_expm_blocks<T, kLieWarp, 8, 4>(d, nb, in, out, s);
  }
  return cudaGetLastError();
}

}  // namespace fm

// Plain C entry point (bound with ctypes). dtype: 0 = float, 1 = double.
// The input is (pointer, batch stride, row stride, column stride) in
// elements; the output (pointer, batch stride, channel stride), entry
// (i, j) on channel i * d + j.
extern "C" int fm_expm(int dtype, int d, long long nb, const void* a, long long sb, long long rs,
                       long long cs, void* out, long long osb, long long osc, void* stream) {
  if (nb <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fm::launch_expm<float>(
        d, nb, fm::MatView<float>{static_cast<const float*>(a), sb, rs, cs},
        fm::view<float>(out, osb, osc), s);
  if (dtype == 1)
    return fm::launch_expm<double>(
        d, nb, fm::MatView<double>{static_cast<const double*>(a), sb, rs, cs},
        fm::view<double>(out, osb, osc), s);
  return cudaErrorInvalidValue;
}

// The largest d of the one-thread tier for dtype (0 = float, 1 = double):
// the Python wrapper checks its own copy of the bound against it.
extern "C" int fm_expm_unroll_max(int dtype) {
  return dtype == 0 ? fm::expm_unroll_max<float>() : fm::expm_unroll_max<double>();
}
