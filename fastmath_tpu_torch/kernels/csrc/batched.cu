// Full-storage batched solve and inverse for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of fastmath_tpu/kernels/batched_pallas.py:
//   fm_solve_full  <- _solve_full_kernel  (solve_full_cf)
//   fm_inv         <- _inv_kernel         (inv_cf)
//
// A matrix is full n x n storage in n*n row-major channels; right-hand
// sides and solutions are n x k in n*k row-major channels. One thread owns
// one problem, and each operand is addressed through a batch stride and a
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
//
// What bounds them on the card: per problem the solve moves n^2 + 2nk
// values and the inverse 2n^2, for O(n^3) flops, so at n <= 4 device
// memory bounds them: each operand is read once and the work stays in
// registers. From n = 8 on the arithmetic grows past the bytes: the
// unrolled tiers keep A in registers (the double-precision n = 8 tiers
// spill), and the rolled tier's array lives in local memory (cached,
// spilled to device memory), which is measured and recorded, not tuned
// here.
//
// Every launch goes on the caller's stream, allocates nothing and does
// not synchronize; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "batched_adjugate.cuh"
#include "sym_common.cuh"

namespace fm {

// Matrix operand: entry (i, j) of problem b at p[b * sb + i * rs + j * cs]
// (rs = n * sc and cs = sc, or swapped to read the transpose).
template <typename T>
struct MatView {
  const T* p;
  long long sb, rs, cs;
};

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
// launchers
// ---------------------------------------------------------------------------

template <typename T>
MatView<T> mat_view(const void* p, long long sb, long long sc, int n, int trans) {
  const long long row = n * sc;
  return trans ? MatView<T>{static_cast<const T*>(p), sb, sc, row}
               : MatView<T>{static_cast<const T*>(p), sb, row, sc};
}

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
    return fm::launch_solve_full<float>(n, k, nb, fm::mat_view<float>(mat, msb, msc, n, trans),
                                        fm::cview<float>(rhs, rsb, rsc),
                                        fm::view<float>(out, osb, osc), s);
  if (dtype == 1)
    return fm::launch_solve_full<double>(n, k, nb, fm::mat_view<double>(mat, msb, msc, n, trans),
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
    return fm::launch_inv<float>(n, nb, fm::mat_view<float>(mat, msb, msc, n, 0),
                                 fm::view<float>(out, osb, osc), s);
  if (dtype == 1)
    return fm::launch_inv<double>(n, nb, fm::mat_view<double>(mat, msb, msc, n, 0),
                                  fm::view<double>(out, osb, osc), s);
  return cudaErrorInvalidValue;
}
