// Compact-symmetric solve and fused chain solve for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of fastmath_tpu/kernels/sym_pallas.py:
//   fm_sym_solve        <- _solve_kernel        (sym_solve_cf)
//   fm_sym_solve_chain  <- _solve_chain_kernel  (sym_solve_chain_cf)
//
// One thread owns one problem. Each operand is addressed through a batch
// stride and a channel stride, so one kernel reads both the batch-major
// (B, NN) layout of the public ops (strides NN, 1) and the channel-first
// (NN, B) layout of the *_cf wrappers (strides 1, B) without a transpose.
// The ragged edge of the last block is masked; nothing is padded.
//
// Tiers, as in the reference:
//   N == 1     divide (the chain multiplies by 1/a);
//   N <= 4     adjugate x 1/det (generated cofactors, sym_adjugate.cuh),
//              plus `refine` residual steps through the same cofactors;
//   5 <= N <= 8  LU with first-max partial pivoting, unrolled in
//              registers; refinement re-solves the residual through the
//              same factors (the numbers of a from-scratch re-solve);
//   9 <= N <= 32 rolled LU over a per-thread local array [A | v | I]; a
//              refined solve applies the explicit inverse to the residual.
//
// What bounds them on the card: the single solve at N <= 4 moves
// (NN + 2N) values per problem for ~250 flops, so it is bound by device
// memory bandwidth; the design reads each operand once and keeps the
// cofactors and refinement in registers. The chain reads A once and
// runs `iters` solves on it, so it is bound by fp32/fp64 arithmetic; the
// loop-invariant part (cofactors and 1/det, packed LU with pivots and
// 1/U_ii, or the explicit inverse) is computed once before the loop.
// The rolled tier's local array (up to 32 x 65 values) spills to local
// memory; that is measured and recorded, not tuned here.
//
// Every launch goes on the caller's stream, allocates nothing and does
// not synchronize; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "sym_adjugate.cuh"
#include "sym_common.cuh"

namespace fm {

// ---------------------------------------------------------------------------
// single solve
// ---------------------------------------------------------------------------

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
solve_unrolled(long long nb, View<const T> mat, View<const T> vec, View<T> out,
               const T* __restrict__ eps, int refine) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const T* m = mat.p + b * mat.sb;
  T v[N], x[N];
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = vec.p[b * vec.sb + j * vec.sc];

  if constexpr (N == 1) {
    T a = m[0];
    if (eps != nullptr) a = a + eps[0];
    x[0] = v[0] / a;
  } else if constexpr (N <= 4) {
    T E[N][N], adj[N][N], y[N], r[N];
    load_sym<T, N>(m, mat.sc, eps, E);
    const T inv_det = T(1) / sym_cofactors(E, adj);
    adj_apply<T, N>(adj, v, y);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = y[i] * inv_det;
    for (int it = 0; it < refine; ++it) {
      residual<T, N>(E, v, x, r);
      adj_apply<T, N>(adj, r, y);
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = x[i] + y[i] * inv_det;
    }
  } else {
    T E[N][N], LU[N][N], inv_d[N], r[N], dx[N];
    int piv[N];
    load_sym<T, N>(m, mat.sc, eps, E);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) LU[i][j] = E[i][j];
    plu_factor<T, N>(LU, piv);
#pragma unroll
    for (int i = 0; i < N; ++i) inv_d[i] = T(1) / LU[i][i];
    plu_substitute<T, N>(LU, piv, inv_d, v, x);
    for (int it = 0; it < refine; ++it) {
      residual<T, N>(E, v, x, r);
      plu_substitute<T, N>(LU, piv, inv_d, r, dx);
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = x[i] + dx[i];
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) out.p[b * out.sb + i * out.sc] = x[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
solve_rolled(long long nb, int n, View<const T> mat, View<const T> vec, View<T> out,
             const T* __restrict__ eps, int refine) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const T* m = mat.p + b * mat.sb;
  // [A | v] or, when refining, [A | v | I]
  const int w = refine > 0 ? 2 * n + 1 : n + 1;
  T a[kMaxN * kRolledWidth];
  T v[kMaxN], x[kMaxN], r[kMaxN];
  rolled_load(a, n, w, m, mat.sc, eps);
  for (int i = 0; i < n; ++i) {
    v[i] = vec.p[b * vec.sb + i * vec.sc];
    a[i * w + n] = v[i];
  }
  if (refine > 0) rolled_identity(a, n, w, n + 1);
  rolled_factor(a, n, w);
  rolled_backsub(a, n, w);
  for (int i = 0; i < n; ++i) x[i] = a[i * w + n];
  for (int it = 0; it < refine; ++it) {
    residual_global(m, mat.sc, eps, n, v, x, r);
    for (int i = 0; i < n; ++i) {
      const T* inv_row = a + i * w + n + 1;
      T acc = inv_row[0] * r[0];
      for (int j = 1; j < n; ++j) acc = acc + inv_row[j] * r[j];
      x[i] = x[i] + acc;
    }
  }
  for (int i = 0; i < n; ++i) out.p[b * out.sb + i * out.sc] = x[i];
}

// ---------------------------------------------------------------------------
// fused chain: x <- A \ x + c, iters times, factoring once
// ---------------------------------------------------------------------------

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
chain_unrolled(long long nb, View<const T> mat, View<const T> vec, View<const T> add,
               View<T> out, const T* __restrict__ eps, int iters) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const T* m = mat.p + b * mat.sb;
  T x[N], c[N], y[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    x[j] = vec.p[b * vec.sb + j * vec.sc];
    c[j] = add.p != nullptr ? add.p[b * add.sb + j * add.sc] : T(0);
  }

  if constexpr (N == 1) {
    T a = m[0];
    if (eps != nullptr) a = a + eps[0];
    const T inv = T(1) / a;
    for (int t = 0; t < iters; ++t) x[0] = x[0] * inv + c[0];
  } else if constexpr (N <= 4) {
    T E[N][N], adj[N][N];
    load_sym<T, N>(m, mat.sc, eps, E);
    const T inv_det = T(1) / sym_cofactors(E, adj);
    for (int t = 0; t < iters; ++t) {
      adj_apply<T, N>(adj, x, y);
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = y[i] * inv_det + c[i];
    }
  } else {
    T LU[N][N], inv_d[N];
    int piv[N];
    load_sym<T, N>(m, mat.sc, eps, LU);
    plu_factor<T, N>(LU, piv);
#pragma unroll
    for (int i = 0; i < N; ++i) inv_d[i] = T(1) / LU[i][i];
    for (int t = 0; t < iters; ++t) {
      plu_substitute<T, N>(LU, piv, inv_d, x, y);
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = y[i] + c[i];
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) out.p[b * out.sb + i * out.sc] = x[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chain_rolled(long long nb, int n, View<const T> mat, View<const T> vec, View<const T> add,
             View<T> out, const T* __restrict__ eps, int iters) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const T* m = mat.p + b * mat.sb;
  // [A | I] -> explicit inverse in columns [n, 2n)
  const int w = 2 * n;
  T a[kMaxN * kRolledWidth];
  T x[kMaxN], c[kMaxN], y[kMaxN];
  rolled_load(a, n, w, m, mat.sc, eps);
  rolled_identity(a, n, w, n);
  rolled_factor(a, n, w);
  rolled_backsub(a, n, w);
  for (int j = 0; j < n; ++j) {
    x[j] = vec.p[b * vec.sb + j * vec.sc];
    c[j] = add.p != nullptr ? add.p[b * add.sb + j * add.sc] : T(0);
  }
  for (int t = 0; t < iters; ++t) {
    for (int i = 0; i < n; ++i) {
      const T* inv_row = a + i * w + n;
      T acc = inv_row[0] * x[0];
      for (int j = 1; j < n; ++j) acc = acc + inv_row[j] * x[j];
      y[i] = acc;
    }
    for (int i = 0; i < n; ++i) x[i] = y[i] + c[i];
  }
  for (int i = 0; i < n; ++i) out.p[b * out.sb + i * out.sc] = x[i];
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t launch_solve(int n, long long nb, View<const T> mat, View<const T> vec,
                         View<T> out, const T* eps, int refine, cudaStream_t s) {
  const unsigned g = grid_for(nb);
  switch (n) {
#define FM_SOLVE_CASE(K) \
  case K: solve_unrolled<T, K><<<g, kThreads, 0, s>>>(nb, mat, vec, out, eps, refine); break;
    FM_SOLVE_CASE(1) FM_SOLVE_CASE(2) FM_SOLVE_CASE(3) FM_SOLVE_CASE(4)
    FM_SOLVE_CASE(5) FM_SOLVE_CASE(6) FM_SOLVE_CASE(7) FM_SOLVE_CASE(8)
#undef FM_SOLVE_CASE
    default:
      if (n < 1 || n > kMaxN) return cudaErrorInvalidValue;
      solve_rolled<T><<<g, kThreads, 0, s>>>(nb, n, mat, vec, out, eps, refine);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_chain(int n, long long nb, View<const T> mat, View<const T> vec,
                         View<const T> add, View<T> out, const T* eps, int iters,
                         cudaStream_t s) {
  const unsigned g = grid_for(nb);
  switch (n) {
#define FM_CHAIN_CASE(K) \
  case K: chain_unrolled<T, K><<<g, kThreads, 0, s>>>(nb, mat, vec, add, out, eps, iters); break;
    FM_CHAIN_CASE(1) FM_CHAIN_CASE(2) FM_CHAIN_CASE(3) FM_CHAIN_CASE(4)
    FM_CHAIN_CASE(5) FM_CHAIN_CASE(6) FM_CHAIN_CASE(7) FM_CHAIN_CASE(8)
#undef FM_CHAIN_CASE
    default:
      if (n < 1 || n > kMaxN) return cudaErrorInvalidValue;
      chain_rolled<T><<<g, kThreads, 0, s>>>(nb, n, mat, vec, add, out, eps, iters);
  }
  return cudaGetLastError();
}

}  // namespace fm

// Plain C entry points (bound with ctypes). dtype: 0 = float, 1 = double.
// Each operand is (pointer, batch stride, channel stride) in elements;
// eps is n values of the dtype or null; add may be null (c = 0).
extern "C" int fm_sym_solve(int dtype, int n, long long nb,
                            const void* mat, long long msb, long long msc,
                            const void* vec, long long vsb, long long vsc,
                            void* out, long long osb, long long osc,
                            const void* eps, int refine, void* stream) {
  if (nb <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fm::launch_solve<float>(n, nb, fm::cview<float>(mat, msb, msc),
                                   fm::cview<float>(vec, vsb, vsc),
                                   fm::view<float>(out, osb, osc),
                                   static_cast<const float*>(eps), refine, s);
  if (dtype == 1)
    return fm::launch_solve<double>(n, nb, fm::cview<double>(mat, msb, msc),
                                    fm::cview<double>(vec, vsb, vsc),
                                    fm::view<double>(out, osb, osc),
                                    static_cast<const double*>(eps), refine, s);
  return cudaErrorInvalidValue;
}

extern "C" int fm_sym_solve_chain(int dtype, int n, long long nb,
                                  const void* mat, long long msb, long long msc,
                                  const void* vec, long long vsb, long long vsc,
                                  const void* add, long long asb, long long asc,
                                  void* out, long long osb, long long osc,
                                  const void* eps, int iters, void* stream) {
  if (nb <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fm::launch_chain<float>(n, nb, fm::cview<float>(mat, msb, msc),
                                   fm::cview<float>(vec, vsb, vsc),
                                   fm::cview<float>(add, asb, asc),
                                   fm::view<float>(out, osb, osc),
                                   static_cast<const float*>(eps), iters, s);
  if (dtype == 1)
    return fm::launch_chain<double>(n, nb, fm::cview<double>(mat, msb, msc),
                                    fm::cview<double>(vec, vsb, vsc),
                                    fm::cview<double>(add, asb, asc),
                                    fm::view<double>(out, osb, osc),
                                    static_cast<const double*>(eps), iters, s);
  return cudaErrorInvalidValue;
}
