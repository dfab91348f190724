// Compact-symmetric iterations for Hopper (sm_90a): the fused matvec
// chain and the fused power iteration.
//
// Replaces the Pallas TPU kernels of fastmath_tpu/kernels/sym_pallas.py:
//   fm_sym_matvec_chain  <- _matvec_chain_kernel  (sym_matvec_chain_cf)
//   fm_sym_maxeig        <- _maxeig_kernel        (sym_maxeig_cf)
//
// One thread owns one problem and keeps its matrix on chip for every
// step: the chain computes x <- A x + c `iters` times; the power
// iteration pre-scales A by its Gershgorin bound g = max_i sum_j |a_ij|
// (1/g taken as 0 where g = 0), normalizes the start vector, runs
// iters / r blocks of r matvecs each followed by a renormalization, then
// the iters % r remaining matvecs, a last renormalization, one more
// matvec w = A v and mu = (v . w) * g. Renormalization multiplies by
// rsqrt(|v|^2), or by 0 where |v|^2 = 0, so zero problems stay finite.
// Output rows of the power iteration: mu, then the n entries of v.
//
// Term order is the reference's: row i of A x is summed over j = 0..n-1
// from the first term, and c_i is added last; |v|^2, the row sums of |A|
// and v . w are summed in index order. Multiply-adds contract into FMAs,
// so each result moves a few ulp from the plain PyTorch version.
//
// Tiers: n <= 8 unrolls at compile time, the full entry grid in
// registers; 9 <= n <= 32 walks the packed compact matrix (n(n+1)/2
// values, 2,112 B in f32 at n = 32) and the vectors in a per-thread local
// array, each row's slots reached by a running index (slot (j, i) for
// j < i, then the diagonal, then slots (i, j) for j > i).
//
// What bounds them: per problem the chain reads n(n+1)/2 + 2n values and
// writes n, for iters * 2n^2 flops; the power iteration reads n(n+1)/2 + n
// and writes n + 1, for about (iters + 1) * 2n^2 flops. At the bench
// suite's shapes (4x4, iters 128 and 32) the flops weigh more than or as
// much as the bytes, so both are compute-bound loops over registers; one
// thread per problem keeps every step free of communication.
//
// Every launch goes on the caller's stream, allocates nothing and does
// not synchronize; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "sym_common.cuh"

namespace fm {

// ---------------------------------------------------------------------------
// unrolled tier: n <= 8
// ---------------------------------------------------------------------------

// y = A x, row i summed left to right over j.
template <typename T, int N>
__device__ __forceinline__ void grid_matvec(const T (&E)[N][N], const T (&x)[N], T (&y)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T acc = E[i][0] * x[0];
#pragma unroll
    for (int j = 1; j < N; ++j) acc = acc + E[i][j] * x[j];
    y[i] = acc;
  }
}

template <typename T, int N>
__device__ __forceinline__ void grid_renorm(T (&v)[N]) {
  T nrm2 = v[0] * v[0];
#pragma unroll
  for (int i = 1; i < N; ++i) nrm2 = nrm2 + v[i] * v[i];
  const T s = nrm2 > T(0) ? fm_rsqrt(nrm2) : T(0);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = v[i] * s;
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
matvec_chain_unrolled(long long nb, int iters, View<const T> mat, View<const T> vec,
                      View<const T> add, View<T> out) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  T E[N][N], x[N], c[N];
  load_sym<T, N>(mat.p + b * mat.sb, mat.sc, nullptr, E);
  const T* v = vec.p + b * vec.sb;
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = v[i * vec.sc];
  const bool has_add = add.p != nullptr;
#pragma unroll
  for (int i = 0; i < N; ++i) c[i] = has_add ? add.p[b * add.sb + i * add.sc] : T(0);
  for (int t = 0; t < iters; ++t) {
    T y[N];
    grid_matvec<T, N>(E, x, y);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = y[i] + c[i];
  }
  T* o = out.p + b * out.sb;
#pragma unroll
  for (int i = 0; i < N; ++i) o[i * out.sc] = x[i];
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
maxeig_unrolled(long long nb, int iters, int r, View<const T> mat, View<const T> vec,
                View<T> out) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  T E[N][N], v[N], w[N];
  load_sym<T, N>(mat.p + b * mat.sb, mat.sc, nullptr, E);
  T g = T(0);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T row = fm_abs(E[i][0]);
#pragma unroll
    for (int j = 1; j < N; ++j) row = row + fm_abs(E[i][j]);
    g = i == 0 ? row : fm_max(g, row);
  }
  const T inv_g = g > T(0) ? T(1) / g : T(0);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) E[i][j] = E[i][j] * inv_g;
  const T* v0 = vec.p + b * vec.sb;
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = v0[i * vec.sc];
  grid_renorm<T, N>(v);
  const int blocks = iters / r, rem = iters % r;
  for (int o = 0; o < blocks; ++o) {
    for (int s = 0; s < r; ++s) {
      grid_matvec<T, N>(E, v, w);
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = w[i];
    }
    grid_renorm<T, N>(v);
  }
  for (int s = 0; s < rem; ++s) {
    grid_matvec<T, N>(E, v, w);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = w[i];
  }
  grid_renorm<T, N>(v);
  grid_matvec<T, N>(E, v, w);
  T mu = v[0] * w[0];
#pragma unroll
  for (int i = 1; i < N; ++i) mu = mu + v[i] * w[i];
  T* o = out.p + b * out.sb;
  o[0] = mu * g;
#pragma unroll
  for (int i = 0; i < N; ++i) o[(1 + i) * out.sc] = v[i];
}

// ---------------------------------------------------------------------------
// rolled tier: 9 <= n <= 32
// ---------------------------------------------------------------------------

constexpr int kMaxNN = kMaxN * (kMaxN + 1) / 2;

// y = A x (+ c where c is not null) on the packed compact matrix a, row i
// summed left to right over j: slots (j, i) for j < i start at n + i - 1
// and step n - 2 - j; slots (i, j) for j > i are consecutive from
// tri_index(i, i + 1, n).
template <typename T>
__device__ void packed_matvec(const T* a, int n, const T* x, const T* c, T* y) {
  for (int i = 0; i < n; ++i) {
    T acc = T(0);
    int k = n + i - 1;
    for (int j = 0; j < i; ++j) {
      acc = acc + a[k] * x[j];
      k += n - 2 - j;
    }
    acc = acc + a[i] * x[i];
    k = n + i * (n - 1) - i * (i - 1) / 2;
    for (int j = i + 1; j < n; ++j) acc = acc + a[k++] * x[j];
    y[i] = c != nullptr ? acc + c[i] : acc;
  }
}

template <typename T>
__device__ void packed_renorm(T* v, int n) {
  T nrm2 = v[0] * v[0];
  for (int i = 1; i < n; ++i) nrm2 = nrm2 + v[i] * v[i];
  const T s = nrm2 > T(0) ? fm_rsqrt(nrm2) : T(0);
  for (int i = 0; i < n; ++i) v[i] = v[i] * s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
matvec_chain_rolled(long long nb, int n, int iters, View<const T> mat, View<const T> vec,
                    View<const T> add, View<T> out) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  T a[kMaxNN], x[kMaxN], y[kMaxN], c[kMaxN];
  const T* m = mat.p + b * mat.sb;
  const int nn = n * (n + 1) / 2;
  for (int k = 0; k < nn; ++k) a[k] = m[k * mat.sc];
  for (int i = 0; i < n; ++i) x[i] = vec.p[b * vec.sb + i * vec.sc];
  const bool has_add = add.p != nullptr;
  if (has_add)
    for (int i = 0; i < n; ++i) c[i] = add.p[b * add.sb + i * add.sc];
  for (int t = 0; t < iters; ++t) {
    packed_matvec(a, n, x, has_add ? c : nullptr, y);
    for (int i = 0; i < n; ++i) x[i] = y[i];
  }
  T* o = out.p + b * out.sb;
  for (int i = 0; i < n; ++i) o[i * out.sc] = x[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
maxeig_rolled(long long nb, int n, int iters, int r, View<const T> mat, View<const T> vec,
              View<T> out) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  T a[kMaxNN], v[kMaxN], w[kMaxN];
  const T* m = mat.p + b * mat.sb;
  const int nn = n * (n + 1) / 2;
  for (int k = 0; k < nn; ++k) a[k] = m[k * mat.sc];
  // Gershgorin bound: row i's |entries| summed left to right over j
  T g = T(0);
  for (int i = 0; i < n; ++i) {
    T row = T(0);
    int k = n + i - 1;
    for (int j = 0; j < i; ++j) {
      row = row + fm_abs(a[k]);
      k += n - 2 - j;
    }
    row = row + fm_abs(a[i]);
    k = n + i * (n - 1) - i * (i - 1) / 2;
    for (int j = i + 1; j < n; ++j) row = row + fm_abs(a[k++]);
    g = i == 0 ? row : fm_max(g, row);
  }
  const T inv_g = g > T(0) ? T(1) / g : T(0);
  for (int k = 0; k < nn; ++k) a[k] = a[k] * inv_g;
  for (int i = 0; i < n; ++i) v[i] = vec.p[b * vec.sb + i * vec.sc];
  packed_renorm(v, n);
  const int blocks = iters / r, rem = iters % r;
  for (int o = 0; o < blocks; ++o) {
    for (int s = 0; s < r; ++s) {
      packed_matvec<T>(a, n, v, nullptr, w);
      for (int i = 0; i < n; ++i) v[i] = w[i];
    }
    packed_renorm(v, n);
  }
  for (int s = 0; s < rem; ++s) {
    packed_matvec<T>(a, n, v, nullptr, w);
    for (int i = 0; i < n; ++i) v[i] = w[i];
  }
  packed_renorm(v, n);
  packed_matvec<T>(a, n, v, nullptr, w);
  T mu = v[0] * w[0];
  for (int i = 1; i < n; ++i) mu = mu + v[i] * w[i];
  T* o = out.p + b * out.sb;
  o[0] = mu * g;
  for (int i = 0; i < n; ++i) o[(1 + i) * out.sc] = v[i];
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t launch_matvec_chain(int n, int iters, long long nb, View<const T> mat,
                                View<const T> vec, View<const T> add, View<T> out,
                                cudaStream_t s) {
  if (iters < 0) return cudaErrorInvalidValue;
  const unsigned g = grid_for(nb);
  switch (n) {
#define FM_CHAIN_CASE(K) \
  case K: matvec_chain_unrolled<T, K><<<g, kThreads, 0, s>>>(nb, iters, mat, vec, add, out); break;
    FM_CHAIN_CASE(1) FM_CHAIN_CASE(2) FM_CHAIN_CASE(3) FM_CHAIN_CASE(4)
    FM_CHAIN_CASE(5) FM_CHAIN_CASE(6) FM_CHAIN_CASE(7) FM_CHAIN_CASE(8)
#undef FM_CHAIN_CASE
    default:
      if (n < 1 || n > kMaxN) return cudaErrorInvalidValue;
      matvec_chain_rolled<T><<<g, kThreads, 0, s>>>(nb, n, iters, mat, vec, add, out);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_maxeig(int n, int iters, int r, long long nb, View<const T> mat,
                          View<const T> vec, View<T> out, cudaStream_t s) {
  if (iters < 0 || r < 1 || r > 16) return cudaErrorInvalidValue;
  const unsigned g = grid_for(nb);
  switch (n) {
#define FM_MAXEIG_CASE(K) \
  case K: maxeig_unrolled<T, K><<<g, kThreads, 0, s>>>(nb, iters, r, mat, vec, out); break;
    FM_MAXEIG_CASE(1) FM_MAXEIG_CASE(2) FM_MAXEIG_CASE(3) FM_MAXEIG_CASE(4)
    FM_MAXEIG_CASE(5) FM_MAXEIG_CASE(6) FM_MAXEIG_CASE(7) FM_MAXEIG_CASE(8)
#undef FM_MAXEIG_CASE
    default:
      if (n < 1 || n > kMaxN) return cudaErrorInvalidValue;
      maxeig_rolled<T><<<g, kThreads, 0, s>>>(nb, n, iters, r, mat, vec, out);
  }
  return cudaGetLastError();
}

}  // namespace fm

// Plain C entry points (bound with ctypes). dtype: 0 = float, 1 = double.
// Each operand is (pointer, batch stride, channel stride) in elements; a
// null add means c = 0.
extern "C" int fm_sym_matvec_chain(int dtype, int n, int iters, long long nb,
                                   const void* mat, long long msb, long long msc,
                                   const void* vec, long long vsb, long long vsc,
                                   const void* add, long long asb, long long asc,
                                   void* out, long long osb, long long osc, void* stream) {
  if (nb <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fm::launch_matvec_chain<float>(
        n, iters, nb, fm::cview<float>(mat, msb, msc), fm::cview<float>(vec, vsb, vsc),
        fm::cview<float>(add, asb, asc), fm::view<float>(out, osb, osc), s);
  if (dtype == 1)
    return fm::launch_matvec_chain<double>(
        n, iters, nb, fm::cview<double>(mat, msb, msc), fm::cview<double>(vec, vsb, vsc),
        fm::cview<double>(add, asb, asc), fm::view<double>(out, osb, osc), s);
  return cudaErrorInvalidValue;
}

// out has n + 1 channels: mu, then the unit eigenvector estimate.
extern "C" int fm_sym_maxeig(int dtype, int n, int iters, int renorm_every, long long nb,
                             const void* mat, long long msb, long long msc,
                             const void* vec, long long vsb, long long vsc,
                             void* out, long long osb, long long osc, void* stream) {
  if (nb <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fm::launch_maxeig<float>(n, iters, renorm_every, nb, fm::cview<float>(mat, msb, msc),
                                    fm::cview<float>(vec, vsb, vsc),
                                    fm::view<float>(out, osb, osc), s);
  if (dtype == 1)
    return fm::launch_maxeig<double>(n, iters, renorm_every, nb,
                                     fm::cview<double>(mat, msb, msc),
                                     fm::cview<double>(vec, vsb, vsc),
                                     fm::view<double>(out, osb, osc), s);
  return cudaErrorInvalidValue;
}
