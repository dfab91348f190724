// Batched matrix logarithm for Hopper (sm_90a): inverse scaling and
// squaring with product-form Denman-Beavers square roots and a Gregory
// (atanh) series.
//
// Replaces the Pallas TPU kernels of fastmath_tpu/kernels/logm_pallas.py
// (all behind logm_cf):
//   logm_unrolled <- _logm_kernel         (d <= 8 there; here d <= the
//                                          unrolled bound, one thread a problem)
//   logm_warp     <- _logm_rolled_kernel  (9 <= d <= 24) and
//                    _logm_flat_kernel    (25 <= d <= 32): a lane group
//                                          a problem for every larger d
// The three TPU tiers differ only in how their loops nest, a split forced
// by the TPU compiler's compile time; the flat tier's masked commit is the
// same function. Here every tier runs the nested algebra.
//
// Each problem is one real d x d matrix A (d <= 32), read through its
// strides (lie_common.cuh). The algebra is the reference's:
//   D = A - I, k = 0;
//   up to 12 times, while |A - I|_F > 0.25 (and finite):
//     the square root of A by the unscaled product-form Denman-Beavers
//     iteration: M = Y = A; up to 36 times, while |M - I|_F > db_tol (and
//     finite), db_tol = 8 eps d, then once more where the test passed:
//       T = M + I, Y = (Y M^-1 T) / 2, M = (M^-1 (T T)) / 4;
//     the root counts only where |M - I|_F <= 8 db_tol, else it is NaN;
//     D = D (Y + I)^-1 (the cancellation-free A - I of Al-Mohy & Higham),
//     A = Y, k = k + 1;
//   then Z = D (A + I)^-1, log A = 2^(k+1) Z (I/1 + Z^2/3 + ... + Z^(o-1)/o)
//   by Horner in Z^2 (o = 9 in float32, 21 in float64);
//   a problem that never reached |A - I|_F <= 0.25 comes back NaN
//   (eigenvalues on the negative real axis: the caller reroutes it).
// The iteration stays unscaled so that on-cut eigenvalues diverge to NaN
// instead of converging to a branch that is not the principal one.
// Each problem runs its own iterations and stops on its own tests. The
// TPU kernels iterate a block of problems until its every finite problem
// passes, so all but a block's slowest problem take further steps past
// the test; those steps are not idempotent in float32: at |M - I|_F ~
// db_tol the root still carries about db_tol / 2 of error, which the
// final 2^(k+1) multiplies. The one step past the test (M then converges
// quadratically to rounding) gives every problem that accuracy: without
// it the float32 roundtrip chain expm(0.999 logm(e)), k = 4, exceeds
// 1e-5 normwise on some 4x4 problems where the TPU kernel's algebra does
// not (tests/test_torch_lie_kernels.py). Inverses: cofactors times 1/det for
// d <= 4 (batched_adjugate.cuh's full_inverse), the lane-group LU of
// lu_groups.cuh and a column solve against the identity in the warp tier.
//
// Tiers, split where the state stops fitting in registers (set from
// -Xptxas -v on the card; the square root holds D, M, Y, M^-1, T and a
// product temporary, 6 d^2 values):
//   logm_unrolled<T, D>: one thread a problem, every index a compile-time
//     constant, the matrices in registers, staged loads and stores as in
//     expm.cu.
//   logm_warp<T, G, W>: a group of G = 8, 16 or 32 lanes a problem (the
//     least G >= d; 32 / G problems a warp), the problem padded to W x W
//     with the identity (the padding stays exactly I in M and Y, 0 in D
//     and Z, and adds exact zeros to every sum), so every loop runs to W
//     with constant register indices. W = G, except for 17 <= d <= 24,
//     which run at W = 24 in a group of 32 (lanes 24..31 hold zero columns
//     and take part only in the collectives): about 0.6 of the work of
//     W = 32 a step. Lane j holds column j of M, of M^-1
//     and of each product in registers; the operands of the products live
//     column-major in shared memory (lie_cm_ld): D and Y, and two scratch
//     matrices (M's rows in transit to the LU, then M^-1 or (Y + I)^-1;
//     the LU's rows, then T = M + I, T T, Z), 4 G (G + 4) values and the
//     LU's perm a group: 18 KB a warp at G = 32 in float32, 34 KB in
//     float64, 10 KB at G = 16. Each inverse is lu_group_factor (rows in
//     registers and never moved, first-max pivots by REDUX, the pivot row
//     broadcast as vectors) and lu_group_solve against the identity, lane
//     c solving column c. A product (lie_cm_mm) forms lane j's column from
//     its own column of the right factor against the left factor's
//     columns, all read as vectors, the G rows' sums in flight at once,
//     each summed over k in order from the first term, k in a loop that is
//     not unrolled. The phases (a Denman-Beavers step, a square root's
//     commit, the series) each end in one inverse and share one loop, so
//     the kernel holds one copy of the inverse's unrolled code. Code, not
//     arithmetic, set the time at d < G: with the products unrolled over k
//     and three inverses the kernel was hundreds of kilobytes of
//     instructions, and warps at different points of it share no
//     instruction fetches. At d = 32 nearly every problem takes the same
//     steps and the warps of an SM stay together; at d = 17 the counts
//     spread, and the same problems forced to equal counts (more steps)
//     ran faster (PERF.md, open questions, with the counts and clocks).
//     Every lane of the warp takes part in every phase: the warp runs a
//     phase while any of its problems takes it, and a problem that does
//     not keeps its state; a group past the batch runs a copy of the last
//     problem and stores nothing. G = 8 keeps four problems a warp for 5 <=
//     d <= 8: at G = 16 each would cost what a padded 16 x 16 problem
//     costs, about 62 ns a problem against 6 (chip_ab.py on an NVIDIA H100
//     at 700 W: 16 x 16 on 62,500 in 3.90 ms, 8 x 8 on 250k in 1.51 ms).
//
// What bounds them: a problem reads and writes d^2 values and needs
// about (10 d^3 per Denman-Beavers step, 4 d^3 per square-root commit,
// 2 d^3 (o + 5) / 2 for the series) operations: tens of operations per
// byte at every d, so every tier is bound by operations. The warp tier
// issues (G / d)^3 times the multiply-adds a problem needs (the padding),
// and each LU step's REDUX, division and barrier cost more than its
// multiply-adds. Multiply-adds contract into FMAs, so results move a few
// ulp from the plain PyTorch version
// (fastmath_tpu_torch/kernels/logm.py, logm_plain), which repeats this
// arithmetic.
//
// Every launch goes on the caller's stream, allocates nothing and does
// not synchronize; the entry point returns cudaGetLastError().

#include "batched_adjugate.cuh"
#include "lu_groups.cuh"

namespace fm {

constexpr int kIssMax = 12;
constexpr int kDbIters = 36;
// |A - I|_F^2 below which the series runs
constexpr double kThresh2 = 0.0625;
// the width of logm_warp's narrow tier: 17 <= d <= 24 in a group of 32
// lanes, padded to 24 x 24 (see above)
constexpr int kLogmNarrow = 24;
// the largest d of the one-thread tier, by dtype (registers, see above)
template <typename T>
constexpr int logm_unroll_max();
template <>
constexpr int logm_unroll_max<float>() { return 4; }
template <>
constexpr int logm_unroll_max<double>() { return 4; }

template <typename T>
__host__ __device__ constexpr int logm_order();
template <>
__host__ __device__ constexpr int logm_order<float>() { return 9; }
template <>
__host__ __device__ constexpr int logm_order<double>() { return 21; }

template <typename T, int D>
__device__ __forceinline__ void inverse_small(const T (&a)[D * D], T (&inv)[D * D]) {
  if constexpr (D == 1) {
    inv[0] = T(1) / a[0];
  } else {
    full_inverse(a, inv);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kLieThreads)
logm_unrolled(long long nb, MatView<T> in, View<T> out) {
  constexpr int W = D * D;
  constexpr int kOrder = logm_order<T>();
  const T thresh2 = T(kThresh2);
  const T tol = lie_eps(T(0)) * T(8 * D);
  const T tol2 = tol * tol, conv2 = (T(8) * tol) * (T(8) * tol);
  __shared__ T tile[kLieThreads * lie_odd(W)];
  T a[W];
  lie_load<T, D>(tile, in, nb, a);
  T dm[W];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) dm[i * D + j] = a[i * D + j] - (i == j ? T(1) : T(0));
  int k = 0;
  bool cut = false;
  for (int it = 0; it < kIssMax; ++it) {
    const T d2 = lie_dist2<T, D>(a);
    if (!(lie_finite(d2) && d2 > thresh2)) break;
    T m[W], y[W], minv[W], t[W], p[W];
#pragma unroll
    for (int e = 0; e < W; ++e) m[e] = y[e] = a[e];
    bool polished = false;  // the one step past the test (see the header)
    for (int j = 0; j <= kDbIters; ++j) {
      const T e2 = lie_dist2<T, D>(m);
      if (!lie_finite(e2)) break;
      if (e2 <= tol2) {
        if (polished) break;
        polished = true;
      } else if (j == kDbIters) {
        break;
      }
      inverse_small<T, D>(m, minv);
      // T / 2 = (M + I) / 2, then Y = (Y M^-1)(T / 2) and M = M^-1 ((T / 2)
      // (T / 2)): the halves taken into T give the bits of (Y M^-1) T / 2
      // and M^-1 (T T) / 4 (a power of two scales each rounding exactly,
      // short of underflow) without scaling two products
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int c = 0; c < D; ++c)
          t[i * D + c] = i == c ? m[i * D + c] * T(0.5) + T(0.5) : m[i * D + c] * T(0.5);
      lie_mm<T, D>(y, minv, p);
      lie_mm<T, D>(p, t, y);
      lie_mm<T, D>(t, t, p);
      lie_mm<T, D>(minv, p, m);
    }
    ++k;
    const T e2 = lie_dist2<T, D>(m);
    if (!(lie_finite(e2) && e2 <= conv2)) {  // no principal square root chain
      cut = true;
      break;
    }
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int c = 0; c < D; ++c) t[i * D + c] = i == c ? y[i * D + c] + T(1) : y[i * D + c];
    inverse_small<T, D>(t, minv);
    lie_mm<T, D>(dm, minv, p);
#pragma unroll
    for (int e = 0; e < W; ++e) {
      dm[e] = p[e];
      a[e] = y[e];
    }
  }
  const T d2 = lie_dist2<T, D>(a);
  T l[W];
  if (cut || !(lie_finite(d2) && d2 <= thresh2)) {
#pragma unroll
    for (int e = 0; e < W; ++e) l[e] = lie_nan(T(0));
  } else {
    T ap[W], ainv[W], z[W], z2[W], acc[W], q[W];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int c = 0; c < D; ++c) ap[i * D + c] = i == c ? a[i * D + c] + T(1) : a[i * D + c];
    inverse_small<T, D>(ap, ainv);
    lie_mm<T, D>(dm, ainv, z);
    lie_mm<T, D>(z, z, z2);
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int c = 0; c < D; ++c) acc[i * D + c] = i == c ? T(1) / T(kOrder) : T(0);
#pragma unroll
    for (int o = kOrder - 2; o > 0; o -= 2) {
      lie_mm<T, D>(z2, acc, q, T(1) / T(o));
#pragma unroll
      for (int e = 0; e < W; ++e) acc[e] = q[e];
    }
    lie_mm<T, D>(z, acc, l);
    const T scale = T(2) * lie_ldexp(T(1), k);
#pragma unroll
    for (int e = 0; e < W; ++e) l[e] = l[e] * scale;
  }
  lie_store<T, W>(tile, out, nb, l);
}

// Shared memory of one group of logm_warp: D, Y, a scratch matrix (M's
// rows in transit, then M^-1 or Z) and U (the LU's rows, then a product's
// left factor), each column-major at lie_cm_ld, then the LU's perm.
template <typename T, int G, int W = G>
__host__ __device__ constexpr int logm_group_bytes() {
  return 4 * G * lie_cm_ld<T, W>() * (int)sizeof(T) + W * (int)sizeof(int);
}

// The inverse of the group's identity-padded G x G matrix whose rows row
// hold (row gl in lane gl; n = G through lie_opaque): lu_group_factor's LU
// at U and perm, then lane c solves for column c against the identity's
// (lu_group_solve), into x: on the d x d block the operations of
// the plain rolled_solve on [M | I] (kernels/_launch.py), in its order, plus exact
// zeros (the padding's columns pivot on their own 1, their multipliers
// are 0). Every lane of the warp takes part. Ends synchronized.
template <typename T, int G, int W>
__device__ __forceinline__ void logm_inverse(T (&row)[W], int n, int lane, T* U, int* perm,
                                             T (&x)[W]) {
  const int gl = lane % G;
  lu_group_factor<T, G, true, W>(row, n, lane, U, perm);
  lu_group_solve<T, W>(U, perm, n, [gl](int r) { return r == gl ? T(1) : T(0); }, x);
}

// The phases of logm_warp, each ending in one inverse: a Denman-Beavers
// step (M^-1), a square root's commit ((Y + I)^-1), the series ((A + I)^-1).
enum LogmPhase { kLogmRoot, kLogmStep, kLogmCommit, kLogmSeries };

template <typename T, int G, int W>
__global__ void logm_warp(long long nb, int d, MatView<T> in, View<T> out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kOrder = logm_order<T>();
  constexpr int kMat = G * lie_cm_ld<T, W>();
  const T thresh2 = T(kThresh2);
  const T tol = lie_eps(T(0)) * T(8 * d);
  const T tol2 = tol * tol, conv2 = (T(8) * tol) * (T(8) * tol);
  const int lane = threadIdx.x % kLieWarp, gl = lane % G, n = lie_opaque(W);
  const long long slot = blockIdx.x * (long long)(blockDim.x / G) + threadIdx.x / G;
  // a group past the batch runs a copy of the last problem and stores nothing
  const long long b = slot < nb ? slot : nb - 1;
  T* Ds = reinterpret_cast<T*>(smem_raw + (threadIdx.x / G) * logm_group_bytes<T, G, W>());
  T* Ys = Ds + kMat;
  T* Ls = Ys + kMat;
  T* Us = Ls + kMat;
  int* perm = reinterpret_cast<int*>(Us + kMat);
  T m[W], x[W], p[W];
  lie_col_load<T, W>(in, b, d, gl, m);
  lie_col_put<T, W>(Ys, gl, m);  // A, which each square root's Y starts from
#pragma unroll
  for (int i = 0; i < W; ++i) m[i] = i == gl ? m[i] - T(1) : m[i];
  lie_col_put<T, W>(Ds, gl, m);
  __syncwarp(kLieMask);
  // Each group keeps its own tests; the warp runs a phase while any of its
  // groups takes it, and a group that does not stores nothing of it. The
  // phases share one loop, so that the kernel holds one copy of the inverse
  // (see the header: its code, not its arithmetic, set the time at d < G).
  int k = 0, it = 0, j = 0, phase = kLogmRoot;
  bool on = true, cut = false, ok = false, db_on = false, polished = false, step = false;
#pragma unroll 1
  for (;;) {
    if (phase == kLogmRoot) {  // a square root starts: M = Y = A
      lie_col_get<T, W>(Ys, gl, m);
      const T d2 = lie_col_dist2<T, G, W>(m, gl);
      on = on && lie_finite(d2) && d2 > thresh2;
      phase = it < kIssMax && __any_sync(kLieMask, on) ? kLogmStep : kLogmSeries;
      ++it;
      j = 0;
      db_on = on;
      polished = false;
    }
    if (phase == kLogmStep) {
      const T e2 = lie_col_dist2<T, G, W>(m, gl);
      step = db_on && lie_finite(e2);
      if (step && e2 <= tol2) {  // the one step past the test (see the header)
        step = !polished;
        polished = true;
      } else if (j == kDbIters) {
        step = false;
      }
      db_on = step;
      if (!__any_sync(kLieMask, step)) {  // the square root is done
        if (on) {
          ++k;
          if (!(lie_finite(e2) && e2 <= conv2)) {  // no principal square root chain
            cut = true;
            on = false;
          }
        }
        phase = __any_sync(kLieMask, on) ? kLogmCommit : kLogmSeries;
      }
    }
    if (phase == kLogmSeries) {
      lie_col_get<T, W>(Ys, gl, m);
      const T d2 = lie_col_dist2<T, G, W>(m, gl);
      ok = !cut && lie_finite(d2) && d2 <= thresh2;
    }
    // the phase's inverse, into x: of M (its rows through Ls), else of Y + I
    T row[W];
    if (phase == kLogmStep) {
      lie_col_put<T, W>(Ls, gl, m);
      __syncwarp(kLieMask);
      lie_row_get<T, W>(Ls, gl, row);
    } else {
      lie_row_get<T, W>(Ys, gl, row, T(1));
    }
    logm_inverse<T, G, W>(row, n, lane, Us, perm, x);
    __syncwarp(kLieMask);  // the LU has read its rows, the solve U
    lie_col_put<T, W>(Ls, gl, x);
    if (phase == kLogmStep) {
      // T = M + I to Us; Y = (Y M^-1) T / 2; M = M^-1 (T T) / 4
#pragma unroll
      for (int i = 0; i < W; ++i) p[i] = i == gl ? m[i] + T(1) : m[i];
      lie_col_put<T, W>(Us, gl, p);
      __syncwarp(kLieMask);
      lie_cm_mm<T, W>(Ys, Ls, p, n, gl);
      __syncwarp(kLieMask);  // Ys is read
      if (step) lie_col_put<T, W>(Ys, gl, p);  // Y M^-1 (a group that waits keeps Y)
      __syncwarp(kLieMask);
      lie_cm_mm<T, W>(Ys, Us, p, n, gl, T(0), T(0.5));
      __syncwarp(kLieMask);  // Ys is read
      if (step) lie_col_put<T, W>(Ys, gl, p);
      lie_cm_mm<T, W>(Us, Us, p, n, gl);
      __syncwarp(kLieMask);  // Us's T is read
      lie_col_put<T, W>(Us, gl, p);
      __syncwarp(kLieMask);
      lie_cm_mm<T, W>(Ls, Us, p, n, gl, T(0), T(0.25));
      if (step) {
#pragma unroll
        for (int i = 0; i < W; ++i) m[i] = p[i];
      }
      __syncwarp(kLieMask);  // Ls and Us are read
      ++j;
      continue;
    }
    __syncwarp(kLieMask);
    lie_cm_mm<T, W>(Ds, Ls, p, n, gl);  // D (Y + I)^-1: the commit's D, or the series' Z
    __syncwarp(kLieMask);  // Ds and Ls are read
    if (phase == kLogmCommit) {
      if (on) lie_col_put<T, W>(Ds, gl, p);
      __syncwarp(kLieMask);
      phase = kLogmRoot;
      continue;
    }
    // the series: log A = 2^(k+1) Z (I/1 + Z^2/3 + ...), Z in Us, Z^2 in Ls,
    // Horner's sum in Ys
    lie_col_put<T, W>(Us, gl, p);
    __syncwarp(kLieMask);
    lie_cm_mm<T, W>(Us, Us, p, n, gl);
    lie_col_put<T, W>(Ls, gl, p);
#pragma unroll
    for (int i = 0; i < W; ++i) x[i] = i == gl ? T(1) / T(kOrder) : T(0);
    lie_col_put<T, W>(Ys, gl, x);
    __syncwarp(kLieMask);
#pragma unroll 1
    for (int o = kOrder - 2; o > 0; o -= 2) {
      lie_cm_mm<T, W>(Ls, Ys, x, n, gl, T(1) / T(o));
      __syncwarp(kLieMask);
      lie_col_put<T, W>(Ys, gl, x);
      __syncwarp(kLieMask);
    }
    lie_cm_mm<T, W>(Us, Ys, p, n, gl, T(0), T(2) * lie_ldexp(T(1), k));
    break;
  }
  if (slot >= nb || gl >= d) return;
  T* o = out.p + slot * out.sb + gl * out.sc;
#pragma unroll
  for (int i = 0; i < W; ++i)
    if (i < d) o[i * d * out.sc] = ok ? p[i] : lie_nan(T(0));
}

template <typename T>
cudaError_t launch_logm(int d, long long nb, MatView<T> in, View<T> out, cudaStream_t s) {
  if (d < 1 || d > kMaxN) return cudaErrorInvalidValue;
  if (d <= logm_unroll_max<T>()) {
    const unsigned g = (unsigned)((nb + kLieThreads - 1) / kLieThreads);
    switch (d) {
#define FM_LOGM_CASE(K) \
  case K: if constexpr (K <= logm_unroll_max<T>()) logm_unrolled<T, K><<<g, kLieThreads, 0, s>>>(nb, in, out); break;
      FM_LOGM_CASE(1) FM_LOGM_CASE(2) FM_LOGM_CASE(3) FM_LOGM_CASE(4)
#undef FM_LOGM_CASE
      default: return cudaErrorInvalidValue;
    }
  } else {
    const int g = lie_group(d);
    if (g == 8)
      lu_launch<8>(logm_warp<T, 8, 8>, logm_group_bytes<T, 8>(), nb, s, d, in, out);
    else if (g == 16)
      lu_launch<16>(logm_warp<T, 16, 16>, logm_group_bytes<T, 16>(), nb, s, d, in, out);
    else if (d <= kLogmNarrow)
      lu_launch<kLieWarp>(logm_warp<T, kLieWarp, kLogmNarrow>,
                          logm_group_bytes<T, kLieWarp, kLogmNarrow>(), nb, s, d, in, out);
    else
      lu_launch<kLieWarp>(logm_warp<T, kLieWarp, kLieWarp>, logm_group_bytes<T, kLieWarp>(), nb,
                          s, d, in, out);
  }
  return cudaGetLastError();
}

}  // namespace fm

// Plain C entry point (bound with ctypes). dtype: 0 = float, 1 = double.
// The input is (pointer, batch stride, row stride, column stride) in
// elements; the output (pointer, batch stride, channel stride), entry
// (i, j) on channel i * d + j.
extern "C" int fm_logm(int dtype, int d, long long nb, const void* a, long long sb, long long rs,
                       long long cs, void* out, long long osb, long long osc, void* stream) {
  if (nb <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fm::launch_logm<float>(
        d, nb, fm::MatView<float>{static_cast<const float*>(a), sb, rs, cs},
        fm::view<float>(out, osb, osc), s);
  if (dtype == 1)
    return fm::launch_logm<double>(
        d, nb, fm::MatView<double>{static_cast<const double*>(a), sb, rs, cs},
        fm::view<double>(out, osb, osc), s);
  return cudaErrorInvalidValue;
}

// The largest d of the one-thread tier for dtype (0 = float, 1 = double):
// the Python wrapper checks its own copy of the bound against it.
extern "C" int fm_logm_unroll_max(int dtype) {
  return dtype == 0 ? fm::logm_unroll_max<float>() : fm::logm_unroll_max<double>();
}
