// Full-storage batched solve, inverse, determinant and log-determinant,
// and the batched Cholesky factor, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of fastmath_tpu/kernels/batched_pallas.py:
//   fm_solve_full  <- _solve_full_kernel      (solve_full_cf)
//   fm_inv         <- _inv_kernel             (inv_cf)
//   fm_det         <- _det_kernel, log=False  (det_cf)
//                     _det_kernel, log=True   (logdet_cf; one template, a flag)
//   fm_chol        <- _chol_kernel            (chol_cf)
//
// A matrix is full n x n storage in n*n row-major channels; right-hand
// sides and solutions are n x k in n*k row-major channels. One thread owns
// one problem (a group of lanes in the determinant's 9..32 tier), and each
// operand is addressed through a batch stride and a
// channel stride (View, sym_common.cuh), so one kernel reads both the
// batch-major (B, n*n) layout of the public ops and the channel-first
// (n*n, B) layout of the *_cf wrappers without a transpose. The solve can
// read A transposed (entry (i, j) from channel j*n + i), which is how its
// gradient solves with A^T without a transposed copy.
//
// Tiers, as in the reference:
//   solve, n <= 8   LU with first-max partial pivoting, unrolled in
//                   registers (fm::plu_factor); each of the k columns is
//                   then eliminated and back-substituted on its own
//                   (multipliers by the reciprocal pivot, times 1/U_ii,
//                   the reference's _plu_grid_solve), so k costs no
//                   registers and is taken at run time;
//   inverse, n <= 4 generated cofactors times 1/det (batched_adjugate.cuh);
//   inverse, 5..8   the unrolled solve against the identity's columns;
//   both, 9..32     rolled LU over a per-thread local array [A | B] (n + k
//                   columns) or [A | I] (2n columns), multipliers by
//                   division, then back-substitution (fm::rolled_factor,
//                   fm::rolled_backsub).
//   det, n <= 4     the generated expansion (batched_adjugate.cuh); for
//                   log|det| each row is first scaled by its largest
//                   magnitude and the logs of the scales are added, so the
//                   expansion stays in range at any scale;
//   det, 5..8       the unrolled LU, sign * prod U_ii, or sum log|U_ii|;
//   det, 9..32      the lane-group LU (lu_groups.cuh, det_groups): G = 16
//                   lanes a problem to n = 16, 32 above, row i in lane i's
//                   registers, rolled_factor's pivots and multipliers
//                   without moving a row. log|det| sums the per-pivot logs
//                   and never takes the log of the product, which
//                   saturates float32 (an 8 x 8 with pivots ~7e4).
//   chol            compact SPD in, compact lower factor out (slot (i, j)
//                   holds L[max(i,j)][min(i,j)]), no pivoting: n <= 8 the
//                   unrolled Cholesky-Banachiewicz in registers (L_jj =
//                   sqrt(s), then L_ij = s * (1 / L_jj)); 9..32 the
//                   right-looking outer-product form on the packed lower
//                   triangle in local memory (column k scaled by
//                   rsqrt(W_kk), then the rank-1 update of the trailing
//                   block). A matrix that is not SPD gives NaN.
//
// What bounds them on the card: per problem the solve moves n^2 + 2nk
// values, the inverse 2n^2, the determinant n^2 + 1 and the Cholesky
// factor n(n + 1), for O(n^3) flops, so at n <= 4 device memory bounds
// them: each operand is read once and the work stays in registers. From n = 8 on the arithmetic grows past the bytes: the
// unrolled tiers keep A in registers (the double-precision n = 8 tiers
// spill), and the rolled tier's array lives in local memory (cached,
// spilled to device memory), which is measured and recorded, not tuned
// here. The determinant's lane groups keep it in registers instead (about
// n^2 / 2 FMAs a lane); what bounds them is instruction issue: each step's
// reductions, division and broadcast reads cost more than its FMAs.
//
// Every launch goes on the caller's stream, allocates nothing and does
// not synchronize; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "batched_adjugate.cuh"
#include "lu_groups.cuh"
#include "sym_common.cuh"

namespace fm {

template <typename T, int N>
__device__ __forceinline__ void load_full(const T* __restrict__ m, const MatView<T>& a,
                                          T (&A)[N][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) A[i][j] = m[i * a.rs + j * a.cs];
}

// ---------------------------------------------------------------------------
// unrolled tiers: n <= 8
// ---------------------------------------------------------------------------

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
solve_full_unrolled(long long nb, int k, MatView<T> mat, View<const T> rhs, View<T> out) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  T LU[N][N], inv_d[N];
  int piv[N];
  load_full<T, N>(mat.p + b * mat.sb, mat, LU);
  plu_factor<T, N>(LU, piv);
#pragma unroll
  for (int i = 0; i < N; ++i) inv_d[i] = T(1) / LU[i][i];
  const T* r = rhs.p + b * rhs.sb;
  T* o = out.p + b * out.sb;
  for (int c = 0; c < k; ++c) {
    T v[N], x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = r[(i * k + c) * rhs.sc];
    plu_substitute<T, N>(LU, piv, inv_d, v, x);
#pragma unroll
    for (int i = 0; i < N; ++i) o[(i * k + c) * out.sc] = x[i];
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
inv_unrolled(long long nb, MatView<T> mat, View<T> out) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const T* m = mat.p + b * mat.sb;
  T* o = out.p + b * out.sb;
  if constexpr (N == 1) {
    o[0] = T(1) / m[0];
  } else if constexpr (N <= 4) {
    T a[N * N], inv[N * N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) a[i * N + j] = m[i * mat.rs + j * mat.cs];
    full_inverse(a, inv);
#pragma unroll
    for (int c = 0; c < N * N; ++c) o[c * out.sc] = inv[c];
  } else {
    T LU[N][N], inv_d[N];
    int piv[N];
    load_full<T, N>(m, mat, LU);
    plu_factor<T, N>(LU, piv);
#pragma unroll
    for (int i = 0; i < N; ++i) inv_d[i] = T(1) / LU[i][i];
    for (int c = 0; c < N; ++c) {
      T e[N], x[N];
#pragma unroll
      for (int i = 0; i < N; ++i) e[i] = i == c ? T(1) : T(0);
      plu_substitute<T, N>(LU, piv, inv_d, e, x);
#pragma unroll
      for (int i = 0; i < N; ++i) o[(i * N + c) * out.sc] = x[i];
    }
  }
}

// ---------------------------------------------------------------------------
// rolled tier: 9 <= n <= 32
// ---------------------------------------------------------------------------

// [A | B] (rhs given, k columns) or [A | I] (rhs null, k == n): factor,
// back-substitute, write the k solution columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
full_rolled(long long nb, int n, int k, MatView<T> mat, View<const T> rhs, View<T> out) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const int w = n + k;
  T a[kMaxN * kRolledWidth];
  const T* m = mat.p + b * mat.sb;
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) a[i * w + j] = m[i * mat.rs + j * mat.cs];
  if (rhs.p != nullptr) {
    const T* r = rhs.p + b * rhs.sb;
    for (int i = 0; i < n; ++i)
      for (int c = 0; c < k; ++c) a[i * w + n + c] = r[(i * k + c) * rhs.sc];
  } else {
    rolled_identity(a, n, w, n);
  }
  rolled_factor(a, n, w);
  rolled_backsub(a, n, w);
  T* o = out.p + b * out.sb;
  for (int i = 0; i < n; ++i)
    for (int c = 0; c < k; ++c) o[(i * k + c) * out.sc] = a[i * w + n + c];
}

// ---------------------------------------------------------------------------
// determinant and log-determinant
// ---------------------------------------------------------------------------

template <typename T, int N, bool kLog>
__global__ void __launch_bounds__(kThreads)
det_unrolled(long long nb, MatView<T> mat, View<T> out) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const T* m = mat.p + b * mat.sb;
  T r;
  if constexpr (N <= 4) {
    T a[N * N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) a[i * N + j] = m[i * mat.rs + j * mat.cs];
    if constexpr (kLog) r = full_logdet(a);
    else r = full_det(a);
  } else {
    T LU[N][N];
    int piv[N];
    load_full<T, N>(m, mat, LU);
    plu_factor<T, N>(LU, piv);
    if constexpr (kLog) {
      r = fm_log(fm_abs(LU[0][0]));
#pragma unroll
      for (int i = 1; i < N; ++i) r = r + fm_log(fm_abs(LU[i][i]));
    } else {
      r = LU[0][0];
#pragma unroll
      for (int i = 1; i < N; ++i) r = r * LU[i][i];
      if (plu_sign<N>(piv) < 0) r = -r;
    }
  }
  out.p[b * out.sb] = r;
}

// A group of G lanes a problem (lu_groups.cuh): the lane-group LU, then
// the pivots' terms, log|U_ss| or U_ss, written by the lane of row s in
// slot s and folded in step order by the group's first lane, which
// applies the sign and writes the one result.
template <typename T, int G, bool kLog>
__global__ void det_groups(long long nb, int n, MatView<T> mat, View<T> out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kLieWarp, gl = lane % G;
  const long long b = blockIdx.x * (long long)(blockDim.x / G) + threadIdx.x / G;
  T* stage = reinterpret_cast<T*>(smem_raw) + (threadIdx.x / G) * lu_det_values<G>();
  T* rows = stage + G * (G | 1);
  T* terms = rows + 2 * G;
  T row[G];
  lu_load_full<T, G>(mat, b < nb ? b : nb - 1, n, gl, stage, row);
  const LuLane<T> me = lu_group_factor<T, G, false>(row, n, lane, rows, nullptr);
  if (me.step >= 0) terms[me.step] = kLog ? fm_log(fm_abs(me.pivot)) : me.pivot;
  __syncwarp(kLieMask);
  if (gl == 0 && b < nb) {
    T r = terms[0];
    for (int i = 1; i < n; ++i) r = kLog ? r + terms[i] : r * terms[i];
    out.p[b * out.sb] = !kLog && me.odd ? -r : r;
  }
}

template <typename T, int G, bool kLog>
void launch_det_groups(int n, long long nb, MatView<T> mat, View<T> out, cudaStream_t s) {
  const int per_group = lu_det_values<G>() * (int)sizeof(T);
  const int warps = lie_warps((kLieWarp / G) * per_group);
  const int per_block = warps * (kLieWarp / G);
  const unsigned g = (unsigned)((nb + per_block - 1) / per_block);
  det_groups<T, G, kLog><<<g, warps * kLieWarp, per_block * per_group, s>>>(nb, n, mat, out);
}

// ---------------------------------------------------------------------------
// Cholesky (compact in, compact lower factor out)
// ---------------------------------------------------------------------------

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
chol_unrolled(long long nb, View<const T> mat, View<T> out) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  // Banachiewicz in place: L[i][j] overwrites E[i][j], i >= j, which
  // nothing reads after it
  T E[N][N];
  load_sym<T, N>(mat.p + b * mat.sb, mat.sc, nullptr, E);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    T s = E[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - E[j][k] * E[j][k];
    E[j][j] = fm_sqrt(s);
    const T inv_ljj = T(1) / E[j][j];
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      T t = E[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t = t - E[i][k] * E[j][k];
      E[i][j] = t * inv_ljj;
    }
  }
  T* o = out.p + b * out.sb;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) o[tri_index(i, j, N) * out.sc] = E[i][j];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chol_rolled(long long nb, int n, View<const T> mat, View<T> out) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  // the lower triangle packed by rows: entry (i, j), j <= i, at
  // i (i + 1) / 2 + j; the factor overwrites it column by column
  T w[kMaxN * (kMaxN + 1) / 2];
  const T* m = mat.p + b * mat.sb;
  for (int i = 0; i < n; ++i)
    for (int j = 0; j <= i; ++j) w[i * (i + 1) / 2 + j] = m[tri_index(i, j, n) * mat.sc];
  for (int k = 0; k < n; ++k) {
    const T r = fm_rsqrt(w[k * (k + 1) / 2 + k]);
    for (int i = k; i < n; ++i) w[i * (i + 1) / 2 + k] = w[i * (i + 1) / 2 + k] * r;
    for (int i = k + 1; i < n; ++i) {
      const T li = w[i * (i + 1) / 2 + k];
      for (int j = k + 1; j <= i; ++j)
        w[i * (i + 1) / 2 + j] = w[i * (i + 1) / 2 + j] - li * w[j * (j + 1) / 2 + k];
    }
  }
  T* o = out.p + b * out.sb;
  for (int i = 0; i < n; ++i)
    for (int j = 0; j <= i; ++j) o[tri_index(i, j, n) * out.sc] = w[i * (i + 1) / 2 + j];
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t launch_solve_full(int n, int k, long long nb, MatView<T> mat, View<const T> rhs,
                              View<T> out, cudaStream_t s) {
  if (k < 1) return cudaErrorInvalidValue;
  const unsigned g = grid_for(nb);
  switch (n) {
#define FM_SOLVE_FULL_CASE(K) \
  case K: solve_full_unrolled<T, K><<<g, kThreads, 0, s>>>(nb, k, mat, rhs, out); break;
    FM_SOLVE_FULL_CASE(1) FM_SOLVE_FULL_CASE(2) FM_SOLVE_FULL_CASE(3) FM_SOLVE_FULL_CASE(4)
    FM_SOLVE_FULL_CASE(5) FM_SOLVE_FULL_CASE(6) FM_SOLVE_FULL_CASE(7) FM_SOLVE_FULL_CASE(8)
#undef FM_SOLVE_FULL_CASE
    default:
      if (n < 1 || n > kMaxN || n + k > kRolledWidth) return cudaErrorInvalidValue;
      full_rolled<T><<<g, kThreads, 0, s>>>(nb, n, k, mat, rhs, out);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_inv(int n, long long nb, MatView<T> mat, View<T> out, cudaStream_t s) {
  const unsigned g = grid_for(nb);
  switch (n) {
#define FM_INV_CASE(K) \
  case K: inv_unrolled<T, K><<<g, kThreads, 0, s>>>(nb, mat, out); break;
    FM_INV_CASE(1) FM_INV_CASE(2) FM_INV_CASE(3) FM_INV_CASE(4)
    FM_INV_CASE(5) FM_INV_CASE(6) FM_INV_CASE(7) FM_INV_CASE(8)
#undef FM_INV_CASE
    default:
      if (n < 1 || n > kMaxN) return cudaErrorInvalidValue;
      full_rolled<T><<<g, kThreads, 0, s>>>(nb, n, n, mat, View<const T>{nullptr, 0, 0}, out);
  }
  return cudaGetLastError();
}

template <typename T, bool kLog>
cudaError_t launch_det(int n, long long nb, MatView<T> mat, View<T> out, cudaStream_t s) {
  const unsigned g = grid_for(nb);
  switch (n) {
#define FM_DET_CASE(K) \
  case K: det_unrolled<T, K, kLog><<<g, kThreads, 0, s>>>(nb, mat, out); break;
    FM_DET_CASE(1) FM_DET_CASE(2) FM_DET_CASE(3) FM_DET_CASE(4)
    FM_DET_CASE(5) FM_DET_CASE(6) FM_DET_CASE(7) FM_DET_CASE(8)
#undef FM_DET_CASE
    default:
      if (n < 1 || n > kMaxN) return cudaErrorInvalidValue;
      if (lie_group(n) == 16) launch_det_groups<T, 16, kLog>(n, nb, mat, out, s);
      else launch_det_groups<T, kLieWarp, kLog>(n, nb, mat, out, s);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_chol(int n, long long nb, View<const T> mat, View<T> out, cudaStream_t s) {
  const unsigned g = grid_for(nb);
  switch (n) {
#define FM_CHOL_CASE(K) \
  case K: chol_unrolled<T, K><<<g, kThreads, 0, s>>>(nb, mat, out); break;
    FM_CHOL_CASE(1) FM_CHOL_CASE(2) FM_CHOL_CASE(3) FM_CHOL_CASE(4)
    FM_CHOL_CASE(5) FM_CHOL_CASE(6) FM_CHOL_CASE(7) FM_CHOL_CASE(8)
#undef FM_CHOL_CASE
    default:
      if (n < 1 || n > kMaxN) return cudaErrorInvalidValue;
      chol_rolled<T><<<g, kThreads, 0, s>>>(nb, n, mat, out);
  }
  return cudaGetLastError();
}

}  // namespace fm

// Plain C entry points (bound with ctypes). dtype: 0 = float, 1 = double.
// Each operand is (pointer, batch stride, channel stride) in elements;
// trans != 0 reads the matrix transposed.
extern "C" int fm_solve_full(int dtype, int n, int k, long long nb,
                             const void* mat, long long msb, long long msc, int trans,
                             const void* rhs, long long rsb, long long rsc,
                             void* out, long long osb, long long osc, void* stream) {
  if (nb <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fm::launch_solve_full<float>(n, k, nb, fm::mat_view<float>(mat, msb, msc, n, n, trans),
                                        fm::cview<float>(rhs, rsb, rsc),
                                        fm::view<float>(out, osb, osc), s);
  if (dtype == 1)
    return fm::launch_solve_full<double>(n, k, nb, fm::mat_view<double>(mat, msb, msc, n, n, trans),
                                         fm::cview<double>(rhs, rsb, rsc),
                                         fm::view<double>(out, osb, osc), s);
  return cudaErrorInvalidValue;
}

extern "C" int fm_inv(int dtype, int n, long long nb,
                      const void* mat, long long msb, long long msc,
                      void* out, long long osb, long long osc, void* stream) {
  if (nb <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fm::launch_inv<float>(n, nb, fm::mat_view<float>(mat, msb, msc, n, n, 0),
                                 fm::view<float>(out, osb, osc), s);
  if (dtype == 1)
    return fm::launch_inv<double>(n, nb, fm::mat_view<double>(mat, msb, msc, n, n, 0),
                                  fm::view<double>(out, osb, osc), s);
  return cudaErrorInvalidValue;
}

// log_abs != 0: log|det| instead of det. out is one value per problem.
extern "C" int fm_det(int dtype, int n, long long nb,
                      const void* mat, long long msb, long long msc, int log_abs,
                      void* out, long long osb, long long osc, void* stream) {
  if (nb <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const auto m = fm::mat_view<float>(mat, msb, msc, n, n, 0);
    const auto o = fm::view<float>(out, osb, osc);
    return log_abs ? fm::launch_det<float, true>(n, nb, m, o, s)
               : fm::launch_det<float, false>(n, nb, m, o, s);
  }
  if (dtype == 1) {
    const auto m = fm::mat_view<double>(mat, msb, msc, n, n, 0);
    const auto o = fm::view<double>(out, osb, osc);
    return log_abs ? fm::launch_det<double, true>(n, nb, m, o, s)
               : fm::launch_det<double, false>(n, nb, m, o, s);
  }
  return cudaErrorInvalidValue;
}

// mat and out are compact: n (n + 1) / 2 channels each.
extern "C" int fm_chol(int dtype, int n, long long nb,
                       const void* mat, long long msb, long long msc,
                       void* out, long long osb, long long osc, void* stream) {
  if (nb <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fm::launch_chol<float>(n, nb, fm::cview<float>(mat, msb, msc),
                                  fm::view<float>(out, osb, osc), s);
  if (dtype == 1)
    return fm::launch_chol<double>(n, nb, fm::cview<double>(mat, msb, msc),
                                   fm::view<double>(out, osb, osc), s);
  return cudaErrorInvalidValue;
}
