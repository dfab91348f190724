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
// one problem (a group of lanes in the 9..32 tiers), and each operand is
// addressed through a batch stride and a channel stride (View,
// sym_common.cuh), so one kernel reads both the
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
//   inverse, 5..8   the unrolled solve against the identity's columns,
//                   each solved column written to shared memory at once;
//                   both inverse tiers on staged tiles (below);
//   solve and inverse, 9..32
//                   the lane-group LU (lu_groups.cuh, solve_groups,
//                   inv_groups): G = 16 lanes a problem to n = 16, 32
//                   above, the plain rolled_solve's pivots on [A | B]
//                   (kernels/_launch.py) without moving a row, U kept in
//                   shared memory, then lane c solves for column c (the
//                   operations of rolled_solve on that column, in their
//                   order).
//                   The solve stages B in blocks of G columns through
//                   shared memory, so k is any width; at k = 1 each lane
//                   carries its row's entry of B through the factor
//                   instead (solve1_groups), and one lane back-
//                   substitutes. The inverse's columns are the
//                   identity's, and each lane writes its own.
//   det, n <= 4     the generated expansion (batched_adjugate.cuh); for
//                   log|det| each row is first scaled by its largest
//                   magnitude and the logs of the scales are added, so the
//                   expansion stays in range at any scale;
//   det, 5..8       the unrolled LU, sign * prod U_ii, or sum log|U_ii|;
//   det, 9..32      the lane-group LU (lu_groups.cuh, det_groups): G = 16
//                   lanes a problem to n = 16, 32 above, row i in lane i's
//                   registers, the plain rolled_factor's pivots and multipliers
//                   without moving a row. log|det| sums the per-pivot logs
//                   and never takes the log of the product, which
//                   saturates float32 (an 8 x 8 with pivots ~7e4).
//   chol            compact SPD in, compact lower factor out (slot (i, j)
//                   holds L[max(i,j)][min(i,j)]), no pivoting: n <= 8 the
//                   unrolled Cholesky-Banachiewicz on the lower triangle
//                   in registers (L_jj = sqrt(s), then L_ij = s * (1 /
//                   L_jj)), on staged tiles (below); 9..32 the
//                   right-looking outer-product form in lane groups
//                   (chol_groups: row i in lane i's registers, column k
//                   scaled by rsqrt(W_kk), then the rank-1 update of the
//                   trailing rows). A matrix that is not SPD gives NaN.
//
// What bounds them on the card: per problem the solve moves n^2 + 2nk
// values, the inverse 2n^2, the determinant n^2 + 1 and the Cholesky
// factor n(n + 1), for O(n^3) flops, so at n <= 8 device memory bounds
// them (an 8 x 8 inverse is about 1.4 kflop for 512 bytes in float32).
// One thread a problem that reads and writes its own entries one by one
// wastes most of each sector it touches: in the batch-major layout
// neighbouring threads sit 4 n^2 bytes apart, so each warp-wide access
// moves 32 sectors for 128 useful bytes (the inverse and the Cholesky at
// 8 x 8 reached 10.5% and 13% of their byte bounds that way; the solve
// and the determinant still do). The n <= 8 inverse and Cholesky tiers
// therefore stage their blocks' problems through shared memory (below,
// above staged_stride), with the same arithmetic, so the same bits. On an
// H100 80GB HBM3 at 700 W (chip_ab.py, 1M problems, float32) the 8 x 8
// inverse takes 0.23 ms (67% of its byte bound; a kernel that only stages
// the same bytes in and out, 88%), the 8 x 8 Cholesky 0.10 ms (86%), the
// 3 x 3 inverse and Cholesky 79% and 83%: inv_unrolled<float, 8> holds 96
// registers and 33 KB of regions, 5 blocks of 128 an SM, and what is left
// is its arithmetic, which the other blocks' copies overlap only in part.
// In float64 the 8 x 8 inverse (168 registers, a 64-byte local array, 64
// problems a block) reaches 36%; the double-precision 8 x 8 solve spills.
// From n = 9 on the arithmetic grows past the bytes: the lane groups of
// the 9..32 tiers keep a row a lane (about n^2 / 2 FMAs a lane in
// the factor, n^2 more in each column's two triangular solves); what
// bounds them is instruction issue: each step's reductions, division and
// broadcast reads cost more than its FMAs, and at k = 1 one lane of the
// group does the back-substitution.
//
// Every launch goes on the caller's stream, allocates nothing and does
// not synchronize; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "batched_adjugate.cuh"
#include "lu_groups.cuh"
#include "sym_common.cuh"
#include "tile_stage.cuh"

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

// The n <= 8 inverse and Cholesky tiers stage their problems through
// shared memory (tile_stage.cuh): a block of P problems, one thread each,
// each problem's `size` values kept in one run of its region. Where a
// problem is whole 16-byte vectors the region stride is size + 1, odd, so
// that the 32 threads of a warp reading entry j of their own problems hit
// 32 different banks; otherwise the regions are packed (stride size: odd,
// or at most two threads a bank), and the block's range is copied as it
// is. P is 128, or 64 where 128 regions would pass 48 KB (float64 at n =
// 7, 8), a multiple of the vector width, so that each block's range of a
// contiguous operand starts aligned. Each thread loads as many vectors at
// once as its share of the block's range holds, up to 8: no registers
// wait for vectors that small problems never bring.
template <typename T>
__host__ __device__ constexpr int staged_stride(int size) {
  return size % (16 / (int)sizeof(T)) == 0 ? size + 1 : size;
}

template <typename T>
constexpr int staged_threads(int size) {
  return 128 * staged_stride<T>(size) * (int)sizeof(T) <= 48 * 1024 ? 128 : 64;
}

template <typename T>
__host__ __device__ constexpr int staged_loads(int size) {
  const int kW = 16 / (int)sizeof(T), u = (size + kW - 1) / kW;
  return u < 8 ? u : 8;
}

// The block's operand and result.
template <typename T>
struct StagedPlan {
  TileOperand<T> in;
  TileOut<T> out;
};

// One thread a problem, on the block's staged problems: the thread reads
// its problem from its own region, and writes its inverse back into it (it
// alone reads or writes that region between the two barriers). n <= 4:
// the generated cofactors times 1/det; 5..8: the unrolled pivoted LU, then
// each identity column substituted in turn, its solution written to the
// region's column at once, so that only LU and one column live in
// registers.
template <typename T, int N, int P, bool kCF>
__global__ void __launch_bounds__(P) inv_unrolled(long long nb, StagedPlan<T> plan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int S = staged_stride<T>(N * N);
  T* sm = reinterpret_cast<T*>(smem_raw);
  const long long b0 = blockIdx.x * (long long)P;
  const int np = nb - b0 < P ? (int)(nb - b0) : P;
  tile_stage<T, kCF, staged_loads<T>(N * N)>(plan.in, b0, np, P, S, sm);
  __syncthreads();
  if ((int)threadIdx.x < np) {
    T* m = sm + threadIdx.x * S;
    if constexpr (N == 1) {
      m[0] = T(1) / m[0];
    } else if constexpr (N <= 4) {
      T a[N * N], inv[N * N];
#pragma unroll
      for (int c = 0; c < N * N; ++c) a[c] = m[c];
      full_inverse(a, inv);
#pragma unroll
      for (int c = 0; c < N * N; ++c) m[c] = inv[c];
    } else {
      T LU[N][N], inv_d[N];
      int piv[N];
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) LU[i][j] = m[i * N + j];
      plu_factor<T, N>(LU, piv);
#pragma unroll
      for (int i = 0; i < N; ++i) inv_d[i] = T(1) / LU[i][i];
      for (int c = 0; c < N; ++c) {
        T e[N], x[N];
#pragma unroll
        for (int i = 0; i < N; ++i) e[i] = i == c ? T(1) : T(0);
        plu_substitute<T, N>(LU, piv, inv_d, e, x);
#pragma unroll
        for (int i = 0; i < N; ++i) m[i * N + c] = x[i];
      }
    }
  }
  __syncthreads();
  tile_store<T, kCF>(plan.out, b0, np, P, S, sm);
}

// ---------------------------------------------------------------------------
// 9 <= n <= 32: the lane groups of the solve and the inverse
// ---------------------------------------------------------------------------

// A group of G lanes a problem (lu_groups.cuh): the lane-group LU with
// every pivot row kept in U, which takes the place of the staged operand;
// then, for each block of G columns of B staged in shared memory, lane c
// solves for column c of the block, overwrites it with its solution, and
// the group writes the block back in order.
template <typename T, int G>
__global__ void solve_groups(long long nb, int n, int k, MatView<T> mat, View<const T> rhs,
                             View<T> out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kLieWarp, gl = lane % G;
  const long long b = blockIdx.x * (long long)(blockDim.x / G) + threadIdx.x / G;
  const long long bb = b < nb ? b : nb - 1;
  T* u = reinterpret_cast<T*>(smem_raw + (threadIdx.x / G) * lu_solve_bytes<T, G>());
  T* blk = u + G * (G | 1);
  int* perm = reinterpret_cast<int*>(blk + G * G);
  T row[G];
  lu_load_full<T, G>(mat, bb, n, gl, u, row);
  __syncwarp(kLieMask);  // every row is gathered: step 0 may store its pivot row
  lu_group_factor<T, G, true>(row, n, lane, u, perm);
  for (int c0 = 0; c0 < k; c0 += G) {
    const int kc = k - c0 < G ? k - c0 : G;
    lu_block_load<T, G>(rhs, bb, n, k, c0, kc, gl, blk, row);
    if (gl < kc) {
      T x[G];
      lu_group_solve<T, G>(u, perm, n, [=](int r) { return blk[r * kc + gl]; }, x);
#pragma unroll
      for (int i = 0; i < G; ++i)
        if (i < n) blk[i * kc + gl] = x[i];
    }
    __syncwarp(kLieMask);
    if (b < nb) lu_block_store<T, G>(out, b, n, k, c0, kc, gl, blk);
    __syncwarp(kLieMask);  // the block is written out before the next one loads
  }
}

// k = 1: each lane carries its row's entry of B through the factor, which
// leaves the forward substitution's y in shared memory; the group's first
// lane back-substitutes, and the group writes x.
template <typename T, int G>
__global__ void solve1_groups(long long nb, int n, MatView<T> mat, View<const T> rhs,
                              View<T> out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kLieWarp, gl = lane % G;
  const long long b = blockIdx.x * (long long)(blockDim.x / G) + threadIdx.x / G;
  const long long bb = b < nb ? b : nb - 1;
  T* u = reinterpret_cast<T*>(smem_raw + (threadIdx.x / G) * lu_solve1_bytes<T, G>());
  T* y = u + G * (G | 1);
  int* perm = reinterpret_cast<int*>(y + 2 * G);
  T row[G];
  T bv = gl < n ? rhs.p[bb * rhs.sb + gl * rhs.sc] : T(0);
  lu_load_full<T, G>(mat, bb, n, gl, u, row);
  __syncwarp(kLieMask);  // every row is gathered: step 0 may store its pivot row
  lu_group_factor<T, G, true>(row, n, lane, u, perm, &bv, y);
  __syncwarp(kLieMask);  // y is whole
  if (gl == 0) {
    T x[G];
#pragma unroll
    for (int s = 0; s < G; ++s) x[s] = s < n ? y[s] : T(0);
    lu_group_backsub<T, G>(u, n, x);
#pragma unroll
    for (int i = 0; i < G; ++i)
      if (i < n) y[G + i] = x[i];
  }
  __syncwarp(kLieMask);
  if (b < nb && gl < n) out.p[b * out.sb + gl * out.sc] = y[G + gl];
}

// A group of G lanes a problem (lu_groups.cuh): the lane-group LU with
// every pivot row kept in U, which takes the place of the staged operand,
// then lane c's solve for column c of A^-1, written as entry (i, c) of
// each row i: in the batch-major layout the group writes each row as one
// contiguous run.
template <typename T, int G>
__global__ void inv_groups(long long nb, int n, MatView<T> mat, View<T> out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kLieWarp, gl = lane % G;
  const long long b = blockIdx.x * (long long)(blockDim.x / G) + threadIdx.x / G;
  T* u = reinterpret_cast<T*>(smem_raw + (threadIdx.x / G) * lu_inv_bytes<T, G>());
  int* perm = reinterpret_cast<int*>(u + G * (G | 1));
  T row[G];
  lu_load_full<T, G>(mat, b < nb ? b : nb - 1, n, gl, u, row);
  __syncwarp(kLieMask);  // every row is gathered: step 0 may store its pivot row
  lu_group_factor<T, G, true>(row, n, lane, u, perm);
  T x[G];
  lu_group_solve<T, G>(u, perm, n, [gl](int r) { return r == gl ? T(1) : T(0); }, x);
  if (b >= nb || gl >= n) return;
  T* o = out.p + b * out.sb + gl * out.sc;
#pragma unroll
  for (int i = 0; i < G; ++i)
    if (i < n) o[i * n * out.sc] = x[i];
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

// A group of G lanes a problem (lu_groups.cuh): the operand staged and
// gathered into rows, then lu_group_det, whose result the group's first
// lane writes.
template <typename T, int G, bool kLog>
__global__ void det_groups(long long nb, int n, MatView<T> mat, View<T> out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kLieWarp, gl = lane % G;
  const long long b = blockIdx.x * (long long)(blockDim.x / G) + threadIdx.x / G;
  T* stage = reinterpret_cast<T*>(smem_raw + (threadIdx.x / G) * lu_det_bytes<T, G>());
  T* rows = stage + G * (G | 1);
  T row[G];
  lu_load_full<T, G>(mat, b < nb ? b : nb - 1, n, gl, stage, row);
  const T r = lu_group_det<T, G, kLog>(row, n, lane, rows, rows + 2 * G);
  if (gl == 0 && b < nb) out.p[b * out.sb] = r;
}

// ---------------------------------------------------------------------------
// Cholesky (compact in, compact lower factor out)
// ---------------------------------------------------------------------------

// One thread a problem, on the block's staged compact problems (as
// inv_unrolled): the thread takes its problem's lower triangle into
// registers (L[i (i + 1) / 2 + j] from slot (i, j), j <= i), runs
// Cholesky-Banachiewicz in place, each L_ij overwriting the entry that
// nothing reads after it, and writes L back to its region's slots.
template <typename T, int N, int P, bool kCF>
__global__ void __launch_bounds__(P) chol_unrolled(long long nb, StagedPlan<T> plan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NN = N * (N + 1) / 2, S = staged_stride<T>(NN);
  T* sm = reinterpret_cast<T*>(smem_raw);
  const long long b0 = blockIdx.x * (long long)P;
  const int np = nb - b0 < P ? (int)(nb - b0) : P;
  tile_stage<T, kCF, staged_loads<T>(NN)>(plan.in, b0, np, P, S, sm);
  __syncthreads();
  if ((int)threadIdx.x < np) {
    T* m = sm + threadIdx.x * S;
    auto lo = [](int i, int j) { return i * (i + 1) / 2 + j; };
    T L[NN];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) L[lo(i, j)] = m[tri_index(i, j, N)];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      T s = L[lo(j, j)];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[lo(j, k)] * L[lo(j, k)];
      L[lo(j, j)] = fm_sqrt(s);
      const T inv_ljj = T(1) / L[lo(j, j)];
#pragma unroll
      for (int i = j + 1; i < N; ++i) {
        T t = L[lo(i, j)];
#pragma unroll
        for (int k = 0; k < j; ++k) t = t - L[lo(i, k)] * L[lo(j, k)];
        L[lo(i, j)] = t * inv_ljj;
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) m[tri_index(i, j, N)] = L[lo(i, j)];
  }
  __syncthreads();
  tile_store<T, kCF>(plan.out, b0, np, P, S, sm);
}

// A group of G lanes a problem (lu_groups.cuh's row layout): lane i holds
// row i of W, loaded by lu_load_sym. Step k: lane k's W_kk comes by a
// shuffle within the group, lanes i >= k scale their entry k by
// rsqrt(W_kk), giving L_ik, lanes i > k publish it to a column of L in
// shared memory (two in turn: one __syncwarp a step orders a column's
// readers before its next writer) and subtract L_ik L_jk from their
// entries j > k, the L_jk read as broadcast vectors. Lane i ends with
// row i of L in its entries j <= i, which go to compact slots (j, i)
// staged in shared memory, and the group writes them in order. A problem
// that is not SPD gives NaN in its own group only.
template <typename T, int G>
__global__ void chol_groups(long long nb, int n, View<const T> mat, View<T> out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using V = typename LuVec<T>::type;
  constexpr int kW = LuVec<T>::width;
  const int lane = threadIdx.x % kLieWarp, gl = lane % G;
  const long long b = blockIdx.x * (long long)(blockDim.x / G) + threadIdx.x / G;
  T* cols = reinterpret_cast<T*>(smem_raw + (threadIdx.x / G) * lu_chol_bytes<T, G>());
  T* stage = cols + 2 * G;
  T row[G];
  lu_load_sym<T, G>(mat, b < nb ? b : nb - 1, n, gl, stage, row);
#pragma unroll
  for (int k = 0; k < G; ++k) {
    if (k >= n) break;
    const T d = __shfl_sync(kLieMask, row[k], k, G);
    if (gl >= k) row[k] = row[k] * fm_rsqrt(d);
    T* col = cols + (k & 1) * G;
    if (gl > k) col[gl] = row[k];
    __syncwarp(kLieMask);
    if (gl > k) {
#pragma unroll
      for (int q = 0; q < G / kW; ++q) {
        if (q < (k + 1) / kW) continue;
        const V x = reinterpret_cast<const V*>(col)[q];
#pragma unroll
        for (int c = 0; c < kW; ++c) {
          const int j = q * kW + c;
          if (j > k) row[j] = row[j] - row[k] * lu_get(x, c);
        }
      }
    }
  }
  // slot (j, i), j < i: n + j (n - 1) - j (j - 1) / 2 + i - j - 1
  if (gl < n) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j < gl) stage[n + j * (n - 1) - j * (j - 1) / 2 + gl - j - 1] = row[j];
      else if (j == gl) stage[gl] = row[j];
    }
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
      if (n < 1 || n > kMaxN) return cudaErrorInvalidValue;
      if (k == 1 && lie_group(n) == 16)
        lu_launch<16>(solve1_groups<T, 16>, lu_solve1_bytes<T, 16>(), nb, s, n, mat, rhs, out);
      else if (k == 1)
        lu_launch<kLieWarp>(solve1_groups<T, kLieWarp>, lu_solve1_bytes<T, kLieWarp>(), nb, s,
                            n, mat, rhs, out);
      else if (lie_group(n) == 16)
        lu_launch<16>(solve_groups<T, 16>, lu_solve_bytes<T, 16>(), nb, s, n, k, mat, rhs, out);
      else
        lu_launch<kLieWarp>(solve_groups<T, kLieWarp>, lu_solve_bytes<T, kLieWarp>(), nb, s, n,
                            k, mat, rhs, out);
  }
  return cudaGetLastError();
}

// A staged n <= 8 tier (inv_unrolled, chol_unrolled) over nb problems of
// `size` values: P problems a block, their regions in dynamic shared
// memory. A channel-first operand and result take the kernel that reads
// and writes them a problem a thread (`cf`): the general staging's code
// beside the arithmetic costs the batch-major kernel registers, and at
// 8 x 8 in float32 a fifth of its blocks an SM.
template <typename T, int P>
void launch_staged(void (*kern)(long long, StagedPlan<T>), void (*cf)(long long, StagedPlan<T>),
                   int size, long long nb, View<const T> in, View<T> out, cudaStream_t s) {
  const int S = staged_stride<T>(size);
  const StagedPlan<T> plan{tile_flat_operand<T>(in, size, P, S), tile_flat_out<T>(out, size, P, S)};
  const auto k = plan.in.batch_fastest && plan.out.batch_fastest ? cf : kern;
  k<<<(unsigned)((nb + P - 1) / P), P, P * S * sizeof(T), s>>>(nb, plan);
}

template <typename T>
cudaError_t launch_inv(int n, long long nb, View<const T> in, View<T> out, cudaStream_t s) {
  switch (n) {
#define FM_INV_CASE(K)                                                        \
  case K: {                                                                   \
    constexpr int P = staged_threads<T>(K * K);                               \
    launch_staged<T, P>(inv_unrolled<T, K, P, false>, inv_unrolled<T, K, P, true>, K * K, nb, \
                        in, out, s);                                          \
  } break;
    FM_INV_CASE(1) FM_INV_CASE(2) FM_INV_CASE(3) FM_INV_CASE(4)
    FM_INV_CASE(5) FM_INV_CASE(6) FM_INV_CASE(7) FM_INV_CASE(8)
#undef FM_INV_CASE
    default: {
      if (n < 1 || n > kMaxN) return cudaErrorInvalidValue;
      const MatView<T> mat = mat_view<T>(in.p, in.sb, in.sc, n, n, 0);
      if (lie_group(n) == 16)
        lu_launch<16>(inv_groups<T, 16>, lu_inv_bytes<T, 16>(), nb, s, n, mat, out);
      else
        lu_launch<kLieWarp>(inv_groups<T, kLieWarp>, lu_inv_bytes<T, kLieWarp>(), nb, s, n,
                            mat, out);
    }
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
      if (lie_group(n) == 16)
        lu_launch<16>(det_groups<T, 16, kLog>, lu_det_bytes<T, 16>(), nb, s, n, mat, out);
      else
        lu_launch<kLieWarp>(det_groups<T, kLieWarp, kLog>, lu_det_bytes<T, kLieWarp>(), nb, s, n,
                            mat, out);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_chol(int n, long long nb, View<const T> mat, View<T> out, cudaStream_t s) {
  switch (n) {
#define FM_CHOL_CASE(K)                                                       \
  case K: {                                                                   \
    constexpr int NN = K * (K + 1) / 2, P = staged_threads<T>(NN);            \
    launch_staged<T, P>(chol_unrolled<T, K, P, false>, chol_unrolled<T, K, P, true>, NN, nb, \
                        mat, out, s);                                         \
  } break;
    FM_CHOL_CASE(1) FM_CHOL_CASE(2) FM_CHOL_CASE(3) FM_CHOL_CASE(4)
    FM_CHOL_CASE(5) FM_CHOL_CASE(6) FM_CHOL_CASE(7) FM_CHOL_CASE(8)
#undef FM_CHOL_CASE
    default:
      if (n < 1 || n > kMaxN) return cudaErrorInvalidValue;
      if (lie_group(n) == 16)
        lu_launch<16>(chol_groups<T, 16>, lu_chol_bytes<T, 16>(), nb, s, n, mat, out);
      else
        lu_launch<kLieWarp>(chol_groups<T, kLieWarp>, lu_chol_bytes<T, kLieWarp>(), nb, s, n,
                            mat, out);
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
    return fm::launch_inv<float>(n, nb, fm::cview<float>(mat, msb, msc),
                                 fm::view<float>(out, osb, osc), s);
  if (dtype == 1)
    return fm::launch_inv<double>(n, nb, fm::cview<double>(mat, msb, msc),
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
