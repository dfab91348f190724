// Compact-symmetric determinant and inverse for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of fastmath_tpu/kernels/sym_pallas.py:
//   fm_sym_det     <- _det_sym_kernel  (sym_det_cf)
//   fm_sym_invert  <- _invert_kernel   (sym_invert_cf)
//
// One thread owns one problem (a group of lanes in the 9..32 tiers);
// operands are addressed through a batch
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
//              keeps the strict lower part of what it has solved, which
//              the later columns need for the symmetrized upper slots
//              0.5 * (X_ij + X_ji);
//   9 <= N <= 32 the lane-group LU (lu_groups.cuh), G = 16 lanes a
//              problem to N = 16, 32 above, the plain rolled_factor's pivots without
//              moving a row: the determinant (sym_det_groups) the signed
//              product of the pivots, lu_group_det as batched.cu's
//              det_groups on the compact load; the inverse
//              (sym_invert_groups) on [A | I], each lane then solving for
//              one column, the upper slots symmetrized the same way.
//
// Staging: the inverse at 3 <= N <= 8 stages its blocks' problems through
// shared memory (tile_stage.cuh; sym_invert_staged), with the arithmetic
// of the unstaged kernel, so the same bits, and each solved column's
// strict lower part kept in the problem's region; N <= 2, and an operand
// and result both channel-first, stay one thread a problem straight from
// device memory (sym_invert_unrolled), which the card measured faster
// there. The determinant writes one value a problem and reads as the
// staged tiers do (79% of its byte bound at N = 4, 70-77% at 5..8 on 1M).
//
// What bounds them on the card: per problem the determinant moves
// N(N+1)/2 + 1 values and the inverse N(N+1), for O(N^3) flops; at N <= 6
// device memory bounds them. An inverse that stores its own N(N+1)/2
// slots a thread reached 10-28% of its byte bound; staged, on an H100
// 80GB HBM3 at 700 W (chip_ab.py syminv8, 1M problems, float32), N = 4
// takes 0.030 ms (79%; 0.094 unstaged) and N = 5, 6 72% and 55%. From N =
// 7 its arithmetic outlasts its bytes: at 7 and 8 (39%, 26%) each thread
// keeps its unrolled LU and columns in 106-147 registers; in float64
// (22-34% at 5..8) in 100-254 registers and a local array of 40-96 bytes. The lane groups hold a row in registers (about N^2 / 2 FMAs a
// lane), and the inverse's then a column (about N^2 more) with U in
// shared memory; what bounds them is instruction issue: each elimination
// step's reductions, division and broadcast reads, then the inverse's two
// triangular solves of dependent FMAs.
//
// Every launch goes on the caller's stream, allocates nothing and does
// not synchronize; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "lu_groups.cuh"
#include "sym_adjugate.cuh"
#include "sym_common.cuh"
#include "tile_stage.cuh"

namespace fm {

template <typename T, int N>
__device__ __forceinline__ void load_compact(const T* __restrict__ m, long long sc,
                                             T (&c)[N * (N + 1) / 2]) {
#pragma unroll
  for (int k = 0; k < N * (N + 1) / 2; ++k) c[k] = m[k * sc];
}

// plu_substitute's operations in its order, each pivot's swap of the
// right-hand side written as selects. Where the swap is a branch per row,
// nvcc keeps the right-hand side of the staged float inverse at N = 7, 8 in
// a local array indexed by the pivot (566 local stores at N = 8); with
// selects it keeps none, and runs 1.5x (N = 7) and 1.15x (N = 8) faster on
// the card, the same bits (chip_ab.py syminv8). At N <= 6, and in float64,
// whose selects cost twice the instructions, it runs slower: those keep
// plu_substitute.
template <typename T, int N>
__device__ __forceinline__ void plu_substitute_sel(const T (&LU)[N][N], const int (&piv)[N],
                                                   const T (&inv_d)[N], const T (&rhs)[N],
                                                   T (&x)[N]) {
  T r[N];
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = rhs[i];
#pragma unroll
  for (int k = 0; k < N - 1; ++k) {
    const T rk = r[k];
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const bool sw = piv[k] == i;
      r[k] = sw ? r[i] : r[k];
      r[i] = sw ? rk : r[i];
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

// A group of G lanes a problem (lu_groups.cuh): the compact operand
// staged and gathered into rows, then lu_group_det, whose result the
// group's first lane writes.
template <typename T, int G>
__global__ void sym_det_groups(long long nb, int n, View<const T> mat, View<T> out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kLieWarp, gl = lane % G;
  const long long b = blockIdx.x * (long long)(blockDim.x / G) + threadIdx.x / G;
  T* stage = reinterpret_cast<T*>(smem_raw + (threadIdx.x / G) * lu_det_bytes<T, G>());
  T* rows = stage + G * (G | 1);
  T row[G];
  lu_load_sym<T, G>(mat, b < nb ? b : nb - 1, n, gl, stage, row);
  const T r = lu_group_det<T, G, false>(row, n, lane, rows, rows + 2 * G);
  if (gl == 0 && b < nb) out.p[b * out.sb] = r;
}

// ---------------------------------------------------------------------------
// inverse
// ---------------------------------------------------------------------------

// One thread a problem, straight from device memory: N <= 4 the generated
// cofactors times 1/det; 5..8 the unrolled pivoted LU, then the identity's
// columns substituted in turn, the strict lower part of each solved column
// kept in registers (low) for the later columns' symmetrized upper slots.
// The compact inverse's tier for what sym_invert_staged does not stage
// (below: N <= 2, channel-first in and out).
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

// One thread a problem on the block's staged compact problems (as
// batched.cu's inv_unrolled): the thread reads its problem from its own
// region into registers and writes its compact inverse back into it (it
// alone reads or writes that region between the two barriers), and the
// block writes the regions out in order. N <= 4: the generated cofactors
// times 1/det. 5..8: the unrolled pivoted LU, then the identity's columns
// substituted in turn; column c writes its X_cc to slot c and its strict
// lower part X_rc (r > c) to slot (c, r), whose input nothing reads again,
// and the slot takes 0.5 (X_cr + X_rc) when column r is solved: the region
// holds the solved lower part that the later columns need, and no register
// array does. The loops unrolled as sym_invert_unrolled's, the same
// operations in the same order: the same bits.
template <typename T, int N, int P>
__global__ void __launch_bounds__(P) sym_invert_staged(long long nb, StagedPlan<T> plan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NN = N * (N + 1) / 2, S = staged_stride<T>(NN);
  T* sm = reinterpret_cast<T*>(smem_raw);
  const long long b0 = blockIdx.x * (long long)P;
  const int np = nb - b0 < P ? (int)(nb - b0) : P;
  tile_stage<T, false, staged_loads<T>(NN)>(plan.in, b0, np, P, S, sm);
  __syncthreads();
  if ((int)threadIdx.x < np) {
    T* m = sm + threadIdx.x * S;
    if constexpr (N <= 4) {
      T c[NN], inv[NN];
#pragma unroll
      for (int k = 0; k < NN; ++k) c[k] = m[k];
      compact_inverse(c, inv);
#pragma unroll
      for (int k = 0; k < NN; ++k) m[k] = inv[k];
    } else {
      T LU[N][N], inv_d[N];
      int piv[N];
      load_sym<T, N>(m, 1, nullptr, LU);
      plu_factor<T, N>(LU, piv);
#pragma unroll
      for (int i = 0; i < N; ++i) inv_d[i] = T(1) / LU[i][i];
#pragma unroll
      for (int c = 0; c < N; ++c) {
        T e[N], x[N];  // x = column c of the inverse
#pragma unroll
        for (int i = 0; i < N; ++i) e[i] = i == c ? T(1) : T(0);
        if constexpr (sizeof(T) == 4 && N >= 7)
          plu_substitute_sel<T, N>(LU, piv, inv_d, e, x);
        else
          plu_substitute<T, N>(LU, piv, inv_d, e, x);
        m[c] = x[c];
#pragma unroll
        for (int r = 0; r < c; ++r) m[tri_index(r, c, N)] = T(0.5) * (x[r] + m[tri_index(r, c, N)]);
#pragma unroll
        for (int r = c + 1; r < N; ++r) m[tri_index(c, r, N)] = x[r];
      }
    }
  }
  __syncthreads();
  tile_store<T>(plan.out, b0, np, P, S, sm);
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
  lu_group_solve<T, G>(ux, perm, n, [gl](int r) { return r == gl ? T(1) : T(0); }, x);
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
      if (lie_group(n) == 16)
        lu_launch<16>(sym_det_groups<T, 16>, lu_det_bytes<T, 16>(), nb, s, n, mat, out);
      else
        lu_launch<kLieWarp>(sym_det_groups<T, kLieWarp>, lu_det_bytes<T, kLieWarp>(), nb, s, n,
                            mat, out);
  }
  return cudaGetLastError();
}

// The compact inverse at N <= 8: sym_invert_staged, P problems a block,
// their regions in dynamic shared memory; sym_invert_unrolled where the card
// measured it faster (chip_ab.py syminv8): N <= 2, whose problems share
// sectors with their neighbours', and an operand and result both
// channel-first, which the warp reads and writes a channel at a time.
template <typename T, int N>
void launch_sym_invert_small(long long nb, View<const T> mat, View<T> out, cudaStream_t s) {
  if constexpr (N > 2) {
    if (mat.sb != 1 || out.sb != 1) {
      constexpr int NN = N * (N + 1) / 2, P = staged_threads<T>(NN), S = staged_stride<T>(NN);
      const StagedPlan<T> plan{tile_flat_operand<T>(mat, NN, P, S),
                               tile_flat_out<T>(out, NN, P, S)};
      sym_invert_staged<T, N, P><<<(unsigned)((nb + P - 1) / P), P, P * S * (int)sizeof(T), s>>>(
          nb, plan);
      return;
    }
  }
  sym_invert_unrolled<T, N><<<grid_for(nb), kThreads, 0, s>>>(nb, mat, out);
}

template <typename T>
cudaError_t launch_sym_invert(int n, long long nb, View<const T> mat, View<T> out,
                              cudaStream_t s) {
  switch (n) {
#define FM_SYM_INVERT_CASE(K) \
  case K: launch_sym_invert_small<T, K>(nb, mat, out, s); break;
    FM_SYM_INVERT_CASE(1) FM_SYM_INVERT_CASE(2) FM_SYM_INVERT_CASE(3) FM_SYM_INVERT_CASE(4)
    FM_SYM_INVERT_CASE(5) FM_SYM_INVERT_CASE(6) FM_SYM_INVERT_CASE(7) FM_SYM_INVERT_CASE(8)
#undef FM_SYM_INVERT_CASE
    default:
      if (n < 1 || n > kMaxN) return cudaErrorInvalidValue;
      if (lie_group(n) == 16)
        lu_launch<16>(sym_invert_groups<T, 16>, lu_invert_bytes<T, 16>(), nb, s, n, mat, out);
      else
        lu_launch<kLieWarp>(sym_invert_groups<T, kLieWarp>, lu_invert_bytes<T, kLieWarp>(), nb,
                            s, n, mat, out);
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
