// Compact-symmetric iterations for Hopper (sm_90a): the fused matvec
// chain and the fused power iteration.
//
// Replaces the Pallas TPU kernels of fastmath_tpu/kernels/sym_pallas.py:
//   fm_sym_matvec_chain  <- _matvec_chain_kernel  (sym_matvec_chain_cf)
//   fm_sym_maxeig        <- _maxeig_kernel        (sym_maxeig_cf)
//
// Each problem keeps its matrix on chip for every step (one thread a
// problem; a group of lanes in the 9..32 tiers): the chain computes
// x <- A x + c `iters` times; the power iteration pre-scales A by its
// Gershgorin bound g = max_i sum_j |a_ij|
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
// registers; 9 <= n <= 32 runs a group of G = 16 lanes a problem to n =
// 16, 32 above (matvec_chain_groups, maxeig_groups: row i of A in lane i's
// registers, x in shared memory, the step lu_group_chain of lu_groups.cuh,
// which the compact chain solve shares). The power iteration's
// renormalizations and Rayleigh quotient read x from shared memory as
// broadcast vectors, each lane summing in index order, so every lane of
// a group holds the same bits without a reduction; its Gershgorin bound
// is a butterfly of fm_max over the group's row sums.
//
// What bounds them: per problem the chain reads n(n+1)/2 + 2n values and
// writes n, for iters * 2n^2 flops; the power iteration reads n(n+1)/2 + n
// and writes n + 1, for about (iters + 1) * 2n^2 flops. At the bench
// suite's shapes (4x4, iters 128 and 32) the flops weigh more than or as
// much as the bytes, so both are compute-bound loops over registers; one
// thread per problem keeps every step free of communication. Above 8, one
// thread a problem kept its matrix in local memory and reached 1.5-1.8% of
// the operation bound (16 x 16, iters 32); a lane of a group issues G / 4
// (f32) broadcast vector loads, G multiply-adds, one store and one
// __syncwarp a step.
//
// Every launch goes on the caller's stream, allocates nothing and does
// not synchronize; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "lu_groups.cuh"

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
// 9 <= n <= 32: lane groups
// ---------------------------------------------------------------------------

// A group of G lanes a problem (G = 16 to n = 16, 32 above; 32 / G
// problems a warp): lane i gathers row i of A from the compact operand
// (lu_load_sym, zero past n), then lu_group_chain runs x <- A x + c
// `iters` times from x = vec (c = 0 without `add`) with x in shared
// memory; the group writes x in order. A group past the batch runs a copy of the last problem and
// stores nothing.
template <typename T, int G>
__global__ void matvec_chain_groups(long long nb, int n, int iters, View<const T> mat,
                                    View<const T> vec, View<const T> add, View<T> out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kLieWarp, gl = lane % G;
  const long long b = blockIdx.x * (long long)(blockDim.x / G) + threadIdx.x / G;
  const long long bb = b < nb ? b : nb - 1;
  T* stage = reinterpret_cast<T*>(smem_raw + (threadIdx.x / G) * lu_chain_bytes<T, G>());
  T* xs = stage + G * (G + 1) / 2;
  T row[G];
  lu_load_sym<T, G>(mat, bb, n, gl, stage, row);
  xs[gl] = gl < n ? vec.p[bb * vec.sb + gl * vec.sc] : T(0);
  __syncwarp(kLieMask);
  const T c = add.p != nullptr && gl < n ? add.p[bb * add.sb + gl * add.sc] : T(0);
  const T xi = lu_group_chain<T, G>(row, c, n, iters, gl, xs);
  if (b < nb && gl < n) out.p[b * out.sb + gl * out.sc] = xi;
}

// The lane's x_i renormalized: every lane of the group sums x_j^2 over j
// = 0..n-1 in index order from buffer `from` of xs (broadcast vectors, the
// same bits in every lane), scales its own x_i by rsqrt(|x|^2) (0 where
// |x|^2 = 0) and writes it to the first buffer, where the next
// lu_group_chain starts. Ends synchronized.
template <typename T, int G>
__device__ __forceinline__ T group_renorm(T* xs, int from, int n, int gl) {
  using V = typename LuVec<T>::type;
  constexpr int kW = LuVec<T>::width;
  const V* x = reinterpret_cast<const V*>(xs + from * G);
  T nrm2 = T(0);
#pragma unroll
  for (int q = 0; q < G / kW; ++q) {
    if (q * kW >= n) break;
    const V v = x[q];
#pragma unroll
    for (int e = 0; e < kW; ++e) {
      const int j = q * kW + e;
      const T xj = lu_get(v, e);
      if (j < n) nrm2 = j == 0 ? xj * xj : nrm2 + xj * xj;
    }
  }
  const T xi = xs[from * G + gl];
  __syncwarp(kLieMask);  // every lane has read the buffer
  const T s = nrm2 > T(0) ? fm_rsqrt(nrm2) : T(0);
  const T vi = xi * s;
  xs[gl] = vi;
  __syncwarp(kLieMask);
  return vi;
}

// The power iteration on a group of G lanes a problem (as
// matvec_chain_groups): lane i holds row i of A (lu_load_sym), sums its
// |a_ij| over j in order and the group takes the largest row sum by a
// butterfly of fm_max, which drops a NaN, so that it equals the sequential
// fm_max chain over the rows (lanes past n offer NaN, which every number
// beats); each lane scales its row by 1/g (0 where g = 0). v lives double
// buffered in shared memory: group_renorm, then lu_group_chain for each
// block of r matvecs and the iters % r rest, each followed by
// group_renorm back into the first buffer, one more step w = A v into the
// second, and every lane forms v . w in index order. Lane 0 stores mu =
// (v . w) g, lane i < n stores v_i. A group past the batch runs a copy of
// the last problem and stores nothing.
template <typename T, int G>
__global__ void maxeig_groups(long long nb, int n, int iters, int r, View<const T> mat,
                              View<const T> vec, View<T> out) {
  using V = typename LuVec<T>::type;
  constexpr int kW = LuVec<T>::width;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kLieWarp, gl = lane % G;
  const long long b = blockIdx.x * (long long)(blockDim.x / G) + threadIdx.x / G;
  const long long bb = b < nb ? b : nb - 1;
  T* stage = reinterpret_cast<T*>(smem_raw + (threadIdx.x / G) * lu_chain_bytes<T, G>());
  T* xs = stage + G * (G + 1) / 2;
  T row[G];
  lu_load_sym<T, G>(mat, bb, n, gl, stage, row);
  // Gershgorin bound: row gl's |entries| summed left to right over j
  T g = fm_abs(row[0]);
#pragma unroll
  for (int j = 1; j < G; ++j)
    if (j < n) g = g + fm_abs(row[j]);
  if (gl >= n) g = lie_nan(T(0));
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) g = fm_max(g, __shfl_xor_sync(kLieMask, g, o));
  const T inv_g = g > T(0) ? T(1) / g : T(0);
#pragma unroll
  for (int j = 0; j < G; ++j) row[j] = row[j] * inv_g;
  xs[gl] = gl < n ? vec.p[bb * vec.sb + gl * vec.sc] : T(0);
  __syncwarp(kLieMask);
  T vi = group_renorm<T, G>(xs, 0, n, gl);
  for (int o = 0; o < iters / r; ++o) {
    lu_group_chain<T, G>(row, T(0), n, r, gl, xs);
    vi = group_renorm<T, G>(xs, r & 1, n, gl);
  }
  const int rem = iters % r;
  lu_group_chain<T, G>(row, T(0), n, rem, gl, xs);
  vi = group_renorm<T, G>(xs, rem & 1, n, gl);
  lu_group_chain<T, G>(row, T(0), n, 1, gl, xs);  // w = A v, into the second buffer
  const V* v = reinterpret_cast<const V*>(xs);
  const V* w = reinterpret_cast<const V*>(xs + G);
  T mu = T(0);
#pragma unroll
  for (int q = 0; q < G / kW; ++q) {
    if (q * kW >= n) break;
    const V vq = v[q], wq = w[q];
#pragma unroll
    for (int e = 0; e < kW; ++e) {
      const int j = q * kW + e;
      const T t = lu_get(vq, e) * lu_get(wq, e);
      if (j < n) mu = j == 0 ? t : mu + t;
    }
  }
  if (b >= nb) return;
  T* o = out.p + b * out.sb;
  if (gl == 0) o[0] = mu * g;
  if (gl < n) o[(1 + gl) * out.sc] = vi;
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
      if (lie_group(n) == 16)
        lu_launch<16>(matvec_chain_groups<T, 16>, lu_chain_bytes<T, 16>(), nb, s, n, iters,
                      mat, vec, add, out);
      else
        lu_launch<kLieWarp>(matvec_chain_groups<T, kLieWarp>, lu_chain_bytes<T, kLieWarp>(),
                            nb, s, n, iters, mat, vec, add, out);
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
      if (lie_group(n) == 16)
        lu_launch<16>(maxeig_groups<T, 16>, lu_chain_bytes<T, 16>(), nb, s, n, iters, r, mat,
                      vec, out);
      else
        lu_launch<kLieWarp>(maxeig_groups<T, kLieWarp>, lu_chain_bytes<T, kLieWarp>(), nb, s, n,
                            iters, r, mat, vec, out);
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
