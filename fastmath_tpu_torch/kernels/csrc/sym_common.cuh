// Code shared by the kernels (sym_solve.cu, sym_products.cu,
// sym_factor.cu, sym_iterate.cu, batched.cu, batched_products.cu):
// strided operands (compact rows and full matrices) and launch helpers, the
// compact index map, entry loads, residuals, and the partial-pivoting LU
// unrolled in registers for N <= 8 (the 9..32 tiers are lane groups,
// lu_groups.cuh, with the same pivots).
//
// Pivoting is first-max partial pivoting: the pivot of column k is the
// lowest row i >= k whose |A[i][k]| is the column maximum, as in the
// JAX reference (fastmath_tpu/kernels/sym_pallas.py, _plu_grid).
#pragma once

#include <cuda_runtime.h>

namespace fm {

// Largest order the kernels serve.
constexpr int kMaxN = 32;

constexpr int kThreads = 128;

// Strided operand: element (b, k) lives at p[b * sb + k * sc]. The
// batch-major (B, K) layout of the public ops has strides (K, 1), the
// channel-first (K, B) layout of the *_cf wrappers (1, B).
template <typename T>
struct View {
  T* p;
  long long sb, sc;
};

template <typename T>
View<T> view(void* p, long long sb, long long sc) {
  return View<T>{static_cast<T*>(p), sb, sc};
}

template <typename T>
View<const T> cview(const void* p, long long sb, long long sc) {
  return View<const T>{static_cast<const T*>(p), sb, sc};
}

// Matrix operand: entry (i, j) of problem b at p[b * sb + i * rs + j * cs].
template <typename T>
struct MatView {
  const T* p;
  long long sb, rs, cs;
};

// A rows x cols operand stored row-major in rows * cols channels (channel
// stride sc), or, if trans, the transpose of a cols x rows one: the same
// storage read through swapped strides, with no transposed copy.
template <typename T>
MatView<T> mat_view(const void* p, long long sb, long long sc, int rows, int cols, int trans) {
  return trans ? MatView<T>{static_cast<const T*>(p), sb, sc, rows * sc}
               : MatView<T>{static_cast<const T*>(p), sb, cols * sc, sc};
}

// One thread per problem: blocks of kThreads over nb problems.
inline unsigned grid_for(long long nb) { return (unsigned)((nb + kThreads - 1) / kThreads); }

// Flat compact index of entry (i, j): the diagonal first, then the
// strict upper triangle row by row.
__host__ __device__ constexpr int tri_index(int i, int j, int n) {
  if (i == j) return i;
  const int lo = i < j ? i : j;
  const int hi = i < j ? j : i;
  return n + lo * (n - 1) - lo * (lo - 1) / 2 + (hi - lo - 1);
}

__host__ __device__ __forceinline__ float fm_abs(float x) { return fabsf(x); }
__host__ __device__ __forceinline__ double fm_abs(double x) { return fabs(x); }
__host__ __device__ __forceinline__ float fm_max(float a, float b) { return fmaxf(a, b); }
__host__ __device__ __forceinline__ double fm_max(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float fm_log(float x) { return logf(x); }
__device__ __forceinline__ double fm_log(double x) { return log(x); }
__device__ __forceinline__ float fm_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double fm_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float fm_rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double fm_rsqrt(double x) { return rsqrt(x); }

// Entry grid of one compact matrix (channel stride sc), with eps (n
// values, or null) added to the diagonal.
template <typename T, int N>
__device__ __forceinline__ void load_sym(const T* __restrict__ m, long long sc,
                                         const T* __restrict__ eps, T (&E)[N][N]) {
  constexpr int NN = N * (N + 1) / 2;
  T c[NN];
#pragma unroll
  for (int k = 0; k < NN; ++k) c[k] = m[k * sc];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) E[i][j] = c[tri_index(i, j, N)];
  if (eps != nullptr) {
#pragma unroll
    for (int i = 0; i < N; ++i) E[i][i] = E[i][i] + eps[i];
  }
}

// r = v - A x, summed diagonal first, then the other columns in order.
template <typename T, int N>
__device__ __forceinline__ void residual(const T (&E)[N][N], const T (&v)[N],
                                         const T (&x)[N], T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T acc = v[i] - E[i][i] * x[i];
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j != i) acc = acc - E[i][j] * x[j];
    r[i] = acc;
  }
}

// y = adj v (the determinant is applied by the caller).
template <typename T, int N>
__device__ __forceinline__ void adj_apply(const T (&adj)[N][N], const T (&v)[N], T (&y)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T acc = adj[i][0] * v[0];
#pragma unroll
    for (int j = 1; j < N; ++j) acc = acc + adj[i][j] * v[j];
    y[i] = acc;
  }
}

// Unrolled LU with partial pivoting, in place: U on and above the
// diagonal, the multipliers below it, piv[k] the row swapped into k at
// step k. Swaps move columns k.. only, so each multiplier stays in the
// row it was computed for and plu_substitute can replay the steps in
// order. All indices are compile-time constants: the pivot choice is a
// predicate, and the arrays stay in registers.
template <typename T, int N>
__device__ __forceinline__ void plu_factor(T (&A)[N][N], int (&piv)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    int p = k;
    if (k < N - 1) {
      T m = fm_abs(A[k][k]);
#pragma unroll
      for (int i = k + 1; i < N; ++i) {
        const T a = fm_abs(A[i][k]);
        if (a > m) {
          m = a;
          p = i;
        }
      }
#pragma unroll
      for (int i = k + 1; i < N; ++i) {
        if (p == i) {
#pragma unroll
          for (int j = k; j < N; ++j) {
            const T t = A[k][j];
            A[k][j] = A[i][j];
            A[i][j] = t;
          }
        }
      }
    }
    piv[k] = p;
    const T inv_p = T(1) / A[k][k];
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const T l = A[i][k] * inv_p;
      A[i][k] = l;
#pragma unroll
      for (int j = k + 1; j < N; ++j) A[i][j] = A[i][j] - l * A[k][j];
    }
  }
}

// Solve A x = rhs from plu_factor's output; inv_d[i] = 1 / U[i][i].
template <typename T, int N>
__device__ __forceinline__ void plu_substitute(const T (&LU)[N][N], const int (&piv)[N],
                                               const T (&inv_d)[N], const T (&rhs)[N],
                                               T (&x)[N]) {
  T r[N];
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = rhs[i];
#pragma unroll
  for (int k = 0; k < N - 1; ++k) {
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      if (piv[k] == i) {
        const T t = r[k];
        r[k] = r[i];
        r[i] = t;
      }
    }
#pragma unroll
    for (int i = k + 1; i < N; ++i) r[i] = r[i] - LU[i][k] * r[k];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    T acc = r[i];
#pragma unroll
    for (int j = i + 1; j < N; ++j) acc = acc - LU[i][j] * x[j];
    x[i] = acc * inv_d[i];
  }
}

// Sign of the row permutation of plu_factor's pivots: -1 for an odd
// number of swaps.
template <int N>
__device__ __forceinline__ int plu_sign(const int (&piv)[N]) {
  int sign = 1;
#pragma unroll
  for (int k = 0; k < N - 1; ++k)
    if (piv[k] != k) sign = -sign;
  return sign;
}

}  // namespace fm

// Each library built from a source that includes this header exports
// its own copy (bound with ctypes beside the entry points).
extern "C" const char* fm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
