// Full-storage batched matrix-vector and matrix-matrix products for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of fastmath_tpu/kernels/batched_pallas.py:
//   fm_matvec_full  <- _matvec_full_kernel  (matvec_full_cf)
//   fm_matmul       <- _matmul_kernel       (matmul_cf)
//
// A matrix is row-major in its channels (entry (i, j) of an R x C matrix
// is channel i * C + j). Each operand is addressed through a batch stride
// and a channel stride (MatView, sym_common.cuh), so the batch-major
// (B, K) layout of the public ops and the channel-first (K, B) layout of
// the *_cf wrappers run without a transpose, and each matrix operand can
// be read transposed through swapped strides: the gradients (dv = A^T g
// for the matvec, dA = G B^T and dB = A^T G for the product) launch the
// same kernels on the same storage, with no transposed copy.
//
// Term order is the reference's: entry (i, j) is summed over the inner
// index from the first term, left to right. Multiply-adds contract into
// FMAs, so each entry moves a few ulp from the plain PyTorch version.
//
// What bounds them: the matvec moves n^2 + 2n values for 2n^2 flops and
// the product mk + kn + mn values for 2mkn flops, at most 16 and 8 flops
// a value at 32 x 32, so device memory bounds both at every size the
// kernels take. Each reads every operand value from device memory once:
//   fm_matvec_full: one thread per problem. n <= 8 unrolls at compile
//     time with v in registers, reading each entry of A once and
//     writing row i when it is summed; 9 <= n <= 32 keeps v in a
//     per-thread local array and loops over the rows.
//   fm_matmul: one thread per output entry, m n threads a problem, so a
//     32 x 32 x 32 product keeps nothing per thread but its sum (one
//     thread per problem would hold 8 KB of operands). Threads of one
//     problem are neighbours, so a row of A and a column of B are read
//     from device memory once and served to the others from L1. The
//     entry index runs fastest for a batch-major output, the batch index
//     for a channel-first one, so neighbouring threads store to
//     neighbouring addresses in both.
//
// Every launch goes on the caller's stream, allocates nothing and does
// not synchronize; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "sym_common.cuh"

namespace fm {

// ---------------------------------------------------------------------------
// matvec: y = A v, A square n x n
// ---------------------------------------------------------------------------

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
matvec_full_unrolled(long long nb, MatView<T> mat, View<const T> vec, View<T> out) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const T* m = mat.p + b * mat.sb;
  const T* x = vec.p + b * vec.sb;
  T v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = x[j * vec.sc];
  T* o = out.p + b * out.sb;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T acc = m[i * mat.rs] * v[0];
#pragma unroll
    for (int j = 1; j < N; ++j) acc = acc + m[i * mat.rs + j * mat.cs] * v[j];
    o[i * out.sc] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
matvec_full_rolled(long long nb, int n, MatView<T> mat, View<const T> vec, View<T> out) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const T* m = mat.p + b * mat.sb;
  const T* x = vec.p + b * vec.sb;
  T v[kMaxN];
  for (int j = 0; j < n; ++j) v[j] = x[j * vec.sc];
  T* o = out.p + b * out.sb;
  for (int i = 0; i < n; ++i) {
    T acc = m[i * mat.rs] * v[0];
    for (int j = 1; j < n; ++j) acc = acc + m[i * mat.rs + j * mat.cs] * v[j];
    o[i * out.sc] = acc;
  }
}

// ---------------------------------------------------------------------------
// matmul: C = A B, A m x k, B k x n, one thread per entry of C
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
matmul_entries(long long nb, int m, int k, int n, bool batch_fastest, MatView<T> a,
               MatView<T> bm, View<T> out) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const int mn = m * n;
  if (t >= nb * mn) return;
  const long long b = batch_fastest ? t % nb : t / mn;
  const int e = batch_fastest ? (int)(t / nb) : (int)(t % mn);
  const int i = e / n, j = e % n;
  const T* ai = a.p + b * a.sb + i * a.rs;
  const T* bj = bm.p + b * bm.sb + j * bm.cs;
  T acc = ai[0] * bj[0];
  for (int kk = 1; kk < k; ++kk) acc = acc + ai[kk * a.cs] * bj[kk * bm.rs];
  out.p[b * out.sb + e * out.sc] = acc;
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t launch_matvec_full(int n, long long nb, MatView<T> mat, View<const T> vec,
                               View<T> out, cudaStream_t s) {
  const unsigned g = grid_for(nb);
  switch (n) {
#define FM_MATVEC_FULL_CASE(K) \
  case K: matvec_full_unrolled<T, K><<<g, kThreads, 0, s>>>(nb, mat, vec, out); break;
    FM_MATVEC_FULL_CASE(1) FM_MATVEC_FULL_CASE(2) FM_MATVEC_FULL_CASE(3)
    FM_MATVEC_FULL_CASE(4) FM_MATVEC_FULL_CASE(5) FM_MATVEC_FULL_CASE(6)
    FM_MATVEC_FULL_CASE(7) FM_MATVEC_FULL_CASE(8)
#undef FM_MATVEC_FULL_CASE
    default:
      if (n < 1 || n > kMaxN) return cudaErrorInvalidValue;
      matvec_full_rolled<T><<<g, kThreads, 0, s>>>(nb, n, mat, vec, out);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_matmul(int m, int k, int n, long long nb, MatView<T> a, MatView<T> b,
                          View<T> out, cudaStream_t s) {
  if (m < 1 || k < 1 || n < 1 || m > kMaxN || k > kMaxN || n > kMaxN)
    return cudaErrorInvalidValue;
  const long long threads = nb * m * n;
  const bool batch_fastest = out.sb == 1 && m * n > 1;
  matmul_entries<T><<<grid_for(threads), kThreads, 0, s>>>(nb, m, k, n, batch_fastest, a, b,
                                                           out);
  return cudaGetLastError();
}

}  // namespace fm

// Plain C entry points (bound with ctypes). dtype: 0 = float, 1 = double.
// Each operand is (pointer, batch stride, channel stride) in elements; a
// nonzero trans flag reads that matrix transposed (the product's A is then
// stored k x m, its B n x k).
extern "C" int fm_matvec_full(int dtype, int n, long long nb,
                              const void* mat, long long msb, long long msc, int trans,
                              const void* vec, long long vsb, long long vsc,
                              void* out, long long osb, long long osc, void* stream) {
  if (nb <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fm::launch_matvec_full<float>(n, nb, fm::mat_view<float>(mat, msb, msc, n, n, trans),
                                         fm::cview<float>(vec, vsb, vsc),
                                         fm::view<float>(out, osb, osc), s);
  if (dtype == 1)
    return fm::launch_matvec_full<double>(n, nb,
                                          fm::mat_view<double>(mat, msb, msc, n, n, trans),
                                          fm::cview<double>(vec, vsb, vsc),
                                          fm::view<double>(out, osb, osc), s);
  return cudaErrorInvalidValue;
}

extern "C" int fm_matmul(int dtype, int m, int k, int n, long long nb,
                         const void* a, long long asb, long long asc, int trans_a,
                         const void* b, long long bsb, long long bsc, int trans_b,
                         void* out, long long osb, long long osc, void* stream) {
  if (nb <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fm::launch_matmul<float>(m, k, n, nb, fm::mat_view<float>(a, asb, asc, m, k, trans_a),
                                    fm::mat_view<float>(b, bsb, bsc, k, n, trans_b),
                                    fm::view<float>(out, osb, osc), s);
  if (dtype == 1)
    return fm::launch_matmul<double>(m, k, n, nb,
                                     fm::mat_view<double>(a, asb, asc, m, k, trans_a),
                                     fm::mat_view<double>(b, bsb, bsc, k, n, trans_b),
                                     fm::view<double>(out, osb, osc), s);
  return cudaErrorInvalidValue;
}
