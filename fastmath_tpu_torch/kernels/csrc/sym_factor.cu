// Compact-symmetric determinant and inverse for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of fastmath_tpu/kernels/sym_pallas.py:
//   fm_sym_det     <- _det_sym_kernel  (sym_det_cf)
//   fm_sym_invert  <- _invert_kernel   (sym_invert_cf)
//
// One thread owns one problem (a group of lanes in the inverse's 9..32
// tier); operands are addressed through a batch
// stride and a channel stride (View, sym_common.cuh), so one kernel reads
// the batch-major (B, NN) layout of the public ops and the channel-first
// (NN, B) layout of the *_cf wrappers. The inverse is compact too: the
// diagonal first, then the upper rows.
//
// Tiers, as in the reference:
//   N <= 4     the generated expansion on the compact entries
//              (sym_adjugate.cuh): the determinant, or the inverse's slot
//              (i, j) = cofactor(j, i) * (1 / det);
//   5 <= N <= 8  LU with first-max partial pivoting, unrolled in registers
//              (fm::plu_factor): det = sign * prod U_ii; the inverse
//              solves against the identity's columns one at a time and
//              keeps only the strict lower part of what it has solved,
//              which the later columns need for the symmetrized upper
//              slots 0.5 * (X_ij + X_ji);
//   9 <= N <= 32 the determinant: the rolled LU over an n x n per-thread
//              local array; the inverse: the lane-group LU (lu_groups.cuh,
//              sym_invert_groups), G = 16 lanes a problem to N = 16, 32
//              above, rolled_factor's pivots on [A | I] without moving a
//              row, each lane then solving for one column, the upper slots
//              symmetrized the same way.
//
// What bounds them on the card: per problem the determinant moves
// N(N+1)/2 + 1 values and the inverse N(N+1), for O(N^3) flops; at N <= 4
// device memory bounds them, and each operand is read once with the work
// in registers. The determinant's rolled local array (4,096 B in float32
// at N = 32) lives in local memory; that is measured and recorded, not
// tuned here. The inverse's lane groups hold a row, then a column, in
// registers (about N^2 FMAs a lane) and U in shared memory; what bounds
// them is instruction issue: each elimination step's reductions, division
// and broadcast reads, then two triangular solves of dependent FMAs.
//
// Every launch goes on the caller's stream, allocates nothing and does
// not synchronize; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "lu_groups.cuh"
#include "sym_adjugate.cuh"
#include "sym_common.cuh"

namespace fm {

template <typename T, int N>
__device__ __forceinline__ void load_compact(const T* __restrict__ m, long long sc,
                                             T (&c)[N * (N + 1) / 2]) {
#pragma unroll
  for (int k = 0; k < N * (N + 1) / 2; ++k) c[k] = m[k * sc];
}

// ---------------------------------------------------------------------------
// determinant
// ---------------------------------------------------------------------------

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
sym_det_unrolled(long long nb, View<const T> mat, View<T> out) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const T* m = mat.p + b * mat.sb;
  T r;
  if constexpr (N <= 4) {
    T c[N * (N + 1) / 2];
    load_compact<T, N>(m, mat.sc, c);
    r = compact_det(c);
  } else {
    T LU[N][N];
    int piv[N];
    load_sym<T, N>(m, mat.sc, nullptr, LU);
    plu_factor<T, N>(LU, piv);
    r = LU[0][0];
#pragma unroll
    for (int i = 1; i < N; ++i) r = r * LU[i][i];
    if (plu_sign<N>(piv) < 0) r = -r;
  }
  out.p[b * out.sb] = r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sym_det_rolled(long long nb, int n, View<const T> mat, View<T> out) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  T a[kMaxN * kMaxN];
  rolled_load(a, n, n, mat.p + b * mat.sb, mat.sc, static_cast<const T*>(nullptr));
  const int sign = rolled_factor(a, n, n);
  T r = a[0];
  for (int i = 1; i < n; ++i) r = r * a[i * n + i];
  out.p[b * out.sb] = sign < 0 ? -r : r;
}

// ---------------------------------------------------------------------------
// inverse
// ---------------------------------------------------------------------------

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
sym_invert_unrolled(long long nb, View<const T> mat, View<T> out) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const T* m = mat.p + b * mat.sb;
  T* o = out.p + b * out.sb;
  if constexpr (N <= 4) {
    T c[N * (N + 1) / 2], inv[N * (N + 1) / 2];
    load_compact<T, N>(m, mat.sc, c);
    compact_inverse(c, inv);
#pragma unroll
    for (int k = 0; k < N * (N + 1) / 2; ++k) o[k * out.sc] = inv[k];
  } else {
    T LU[N][N], inv_d[N], low[N][N];
    int piv[N];
    load_sym<T, N>(m, mat.sc, nullptr, LU);
    plu_factor<T, N>(LU, piv);
#pragma unroll
    for (int i = 0; i < N; ++i) inv_d[i] = T(1) / LU[i][i];
#pragma unroll
    for (int c = 0; c < N; ++c) {
      T e[N], x[N];  // x = column c of the inverse
#pragma unroll
      for (int i = 0; i < N; ++i) e[i] = i == c ? T(1) : T(0);
      plu_substitute<T, N>(LU, piv, inv_d, e, x);
      o[c * out.sc] = x[c];
#pragma unroll
      for (int r = 0; r < c; ++r) o[tri_index(r, c, N) * out.sc] = T(0.5) * (x[r] + low[c][r]);
#pragma unroll
      for (int r = c + 1; r < N; ++r) low[r][c] = x[r];
    }
  }
}

// A group of G lanes a problem (lu_groups.cuh): the lane-group LU with
// every pivot row kept, lane c's solve for column c of the inverse, X
// through shared memory (row stride G + 1: lane c writes row i's entry c,
// then reads its own row c, both free of bank conflicts), and lane i's
// compact slots of row i, X_ii and 0.5 (X_ij + X_ji) for j > i, staged so
// the group writes the problem's slots in order.
template <typename T, int G>
__global__ void sym_invert_groups(long long nb, int n, View<const T> mat, View<T> out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kX = G + 1;
  const int lane = threadIdx.x % kLieWarp, gl = lane % G;
  const long long b = blockIdx.x * (long long)(blockDim.x / G) + threadIdx.x / G;
  T* ux = reinterpret_cast<T*>(smem_raw + (threadIdx.x / G) * lu_invert_bytes<T, G>());
  T* stage = ux + G * kX;
  int* perm = reinterpret_cast<int*>(stage + G * kX / 2);
  T row[G];
  lu_load_sym<T, G>(mat, b < nb ? b : nb - 1, n, gl, stage, row);
  lu_group_factor<T, G, true>(row, n, lane, ux, perm);
  T x[G];
  lu_group_solve_eye<T, G>(ux, perm, n, gl, x);
  __syncwarp(kLieMask);  // U is read; X takes its place
#pragma unroll
  for (int i = 0; i < G; ++i)
    if (i < n) ux[i * kX + gl] = x[i];
  __syncwarp(kLieMask);
  if (gl < n) {
    stage[gl] = ux[gl * kX + gl];
#pragma unroll
    for (int j = 1; j < G; ++j)
      if (j > gl && j < n) stage[tri_index(gl, j, n)] = T(0.5) * (ux[gl * kX + j] + x[j]);
  }
  __syncwarp(kLieMask);
  if (b >= nb) return;
  T* o = out.p + b * out.sb;
  for (int e = gl; e < n * (n + 1) / 2; e += G) o[e * out.sc] = stage[e];
}

template <typename T, int G>
void launch_sym_invert_groups(int n, long long nb, View<const T> mat, View<T> out,
                              cudaStream_t s) {
  const int per_group = lu_invert_bytes<T, G>();
  const int warps = lie_warps((kLieWarp / G) * per_group);
  const int per_block = warps * (kLieWarp / G);
  const unsigned g = (unsigned)((nb + per_block - 1) / per_block);
  sym_invert_groups<T, G><<<g, warps * kLieWarp, per_block * per_group, s>>>(nb, n, mat, out);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t launch_sym_det(int n, long long nb, View<const T> mat, View<T> out, cudaStream_t s) {
  const unsigned g = grid_for(nb);
  switch (n) {
#define FM_SYM_DET_CASE(K) \
  case K: sym_det_unrolled<T, K><<<g, kThreads, 0, s>>>(nb, mat, out); break;
    FM_SYM_DET_CASE(1) FM_SYM_DET_CASE(2) FM_SYM_DET_CASE(3) FM_SYM_DET_CASE(4)
    FM_SYM_DET_CASE(5) FM_SYM_DET_CASE(6) FM_SYM_DET_CASE(7) FM_SYM_DET_CASE(8)
#undef FM_SYM_DET_CASE
    default:
      if (n < 1 || n > kMaxN) return cudaErrorInvalidValue;
      sym_det_rolled<T><<<g, kThreads, 0, s>>>(nb, n, mat, out);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sym_invert(int n, long long nb, View<const T> mat, View<T> out,
                              cudaStream_t s) {
  const unsigned g = grid_for(nb);
  switch (n) {
#define FM_SYM_INVERT_CASE(K) \
  case K: sym_invert_unrolled<T, K><<<g, kThreads, 0, s>>>(nb, mat, out); break;
    FM_SYM_INVERT_CASE(1) FM_SYM_INVERT_CASE(2) FM_SYM_INVERT_CASE(3) FM_SYM_INVERT_CASE(4)
    FM_SYM_INVERT_CASE(5) FM_SYM_INVERT_CASE(6) FM_SYM_INVERT_CASE(7) FM_SYM_INVERT_CASE(8)
#undef FM_SYM_INVERT_CASE
    default:
      if (n < 1 || n > kMaxN) return cudaErrorInvalidValue;
      if (lie_group(n) == 16) launch_sym_invert_groups<T, 16>(n, nb, mat, out, s);
      else launch_sym_invert_groups<T, kLieWarp>(n, nb, mat, out, s);
  }
  return cudaGetLastError();
}

}  // namespace fm

// Plain C entry points (bound with ctypes). dtype: 0 = float, 1 = double.
// Each operand is (pointer, batch stride, channel stride) in elements;
// mat is compact (N(N+1)/2 channels), the determinant's out one value
// per problem, the inverse's out compact.
extern "C" int fm_sym_det(int dtype, int n, long long nb,
                          const void* mat, long long msb, long long msc,
                          void* out, long long osb, long long osc, void* stream) {
  if (nb <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fm::launch_sym_det<float>(n, nb, fm::cview<float>(mat, msb, msc),
                                     fm::view<float>(out, osb, osc), s);
  if (dtype == 1)
    return fm::launch_sym_det<double>(n, nb, fm::cview<double>(mat, msb, msc),
                                      fm::view<double>(out, osb, osc), s);
  return cudaErrorInvalidValue;
}

extern "C" int fm_sym_invert(int dtype, int n, long long nb,
                             const void* mat, long long msb, long long msc,
                             void* out, long long osb, long long osc, void* stream) {
  if (nb <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fm::launch_sym_invert<float>(n, nb, fm::cview<float>(mat, msb, msc),
                                        fm::view<float>(out, osb, osc), s);
  if (dtype == 1)
    return fm::launch_sym_invert<double>(n, nb, fm::cview<double>(mat, msb, msc),
                                         fm::view<double>(out, osb, osc), s);
  return cudaErrorInvalidValue;
}
