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
//                   registers and is taken at run time; on staged tiles
//                   (solve_full_staged, below) for k <= kSolveStagedK = 8
//                   and problems (A, B, X) of 96 bytes or more, except
//                   where A, B and X are all channel-first, and at k = 1
//                   only float n >= 7 and float64 odd n (solve_staged: the
//                   card's measurements); the rest, and every k > 8, one
//                   thread a problem straight from device memory
//                   (solve_full_unrolled);
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
//                   from n = kDetStagedN = 4 on staged tiles (det_staged),
//                   unless the operand is channel-first (det_unrolled,
//                   as below n = 4);
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
// moves 32 sectors for 128 useful bytes (at 8 x 8 the inverse, the
// Cholesky factor, the determinant and the one-column solve reached 10.5%,
// 13%, 31% and 31% of their byte bounds that way). The n <= 8 tiers
// therefore stage their blocks' problems through shared memory
// (tile_stage.cuh, staged_stride), with the same arithmetic, so the same
// bits. On an H100 80GB HBM3 at 700 W (chip_ab.py, 1M problems, float32)
// the 8 x 8 inverse takes 0.23 ms (67% of its byte bound; a kernel that
// only stages the same bytes in and out, 88%), the 8 x 8 Cholesky 0.10 ms
// (86%), the 3 x 3 inverse and Cholesky 79% and 83%: inv_unrolled<float,
// 8> holds 96 registers and 33 KB of regions, 5 blocks of 128 an SM, and
// what is left is its arithmetic, which the other blocks' copies overlap
// only in part. The 8 x 8 determinant takes 0.093 ms (84%; its staging
// alone 0.089, its arithmetic alone 0.046), the 4 x 4 0.026 (78%, where
// the unstaged expansion took 0.036), the 8 x 8 solve 0.156 ms with one
// column (61%; staging alone 0.110, arithmetic alone 0.086) and 0.43 with
// eight (54%). The solve stages A and B in areas of their own, so that
// where n^2 or n k is not whole vectors an area packs and its vectors
// land whole; its k columns stay a run-time loop.
// In float64 the 8 x 8 inverse (168 registers, a 64-byte local array, 64
// problems a block) reaches 36%, the 8 x 8 determinant 82% and the
// solve with eight columns 39% (an 8N-byte local array, as in the
// unstaged kernel).
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

// One thread a problem, straight from device memory: the n <= 8 solve's
// tier for what solve_staged does not stage (k > kSolveStagedK, small
// problems, channel-first operands).
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

// The widest B the solve stages with A (the public ops pass k <= 8 at
// n <= 8); wider k takes solve_full_unrolled.
constexpr int kSolveStagedK = 8;
// The smallest problem (A, B and X: n^2 + 2 n k values) the solve stages:
// below it one thread a problem reads as fast, its neighbours' entries
// sharing its sectors.
constexpr int kSolveStagedBytes = 96;

// Problems a block of the staged solve at order N: 128, or 64 or 32 where
// 128 problems' A and widest staged B would pass 48 KB.
template <typename T, int N>
constexpr int solve_staged_threads() {
  constexpr int bytes =
      (staged_stride<T>(N * N) + staged_stride<T>(N * kSolveStagedK)) * (int)sizeof(T);
  return 128 * bytes <= 48 * 1024 ? 128 : (64 * bytes <= 48 * 1024 ? 64 : 32);
}

// The staged solve's operands, each in an area of the block of its own:
// the P problems' A as stored first, a region of staged_stride(N^2) values
// each, then their B, staged_stride(N k) each; X goes out of B's area.
template <typename T>
struct SolvePlan {
  TileOperand<T> a, b;
  TileOut<T> out;
};

// One thread a problem on the block's staged problems (as inv_unrolled;
// if kAsync, vectors that land whole, where an area's regions are packed,
// by copy_async): the thread takes A from its region into registers (A^T
// if trans: the staging copies as stored, whatever the thread reads),
// factors it, then solves column by column as solve_full_unrolled does,
// each solution written over its column of B, which nothing reads after
// it; the block writes X out of B's area in order.
template <typename T, int N, int P, bool kAsync>
__global__ void __launch_bounds__(P)
solve_full_staged(long long nb, int k, bool trans, SolvePlan<T> plan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int SA = staged_stride<T>(N * N);
  const int SB = staged_stride<T>(N * k);
  T* sa = reinterpret_cast<T*>(smem_raw);
  T* sb = sa + P * SA;
  const long long b0 = blockIdx.x * (long long)P;
  const int np = nb - b0 < P ? (int)(nb - b0) : P;
  tile_stage<T, false, staged_loads<T>(N * N), kAsync>(plan.a, b0, np, P, SA, sa);
  tile_stage<T, false, staged_loads<T>(N * N), kAsync>(plan.b, b0, np, P, SB, sb);
  if constexpr (kAsync) copy_async_wait();
  __syncthreads();
  if ((int)threadIdx.x < np) {
    const T* a = sa + threadIdx.x * SA;
    T* x = sb + threadIdx.x * SB;
    T LU[N][N], inv_d[N];
    int piv[N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) LU[i][j] = a[trans ? j * N + i : i * N + j];
    plu_factor<T, N>(LU, piv);
#pragma unroll
    for (int i = 0; i < N; ++i) inv_d[i] = T(1) / LU[i][i];
    for (int c = 0; c < k; ++c) {
      T v[N], y[N];
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = x[i * k + c];
      plu_substitute<T, N>(LU, piv, inv_d, v, y);
#pragma unroll
      for (int i = 0; i < N; ++i) x[i * k + c] = y[i];
    }
  }
  __syncthreads();
  tile_store<T>(plan.out, b0, np, P, SB, sb);
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

// The determinant, or log|det| if kLog, of one N x N problem whose entry
// (i, j) is at(i, j): the generated expansion for N <= 4; above, the
// unrolled pivoted LU, sign * prod U_ii or sum log|U_ii|.
template <typename T, int N, bool kLog, typename At>
__device__ __forceinline__ T det_one(At at) {
  if constexpr (N <= 4) {
    T a[N * N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) a[i * N + j] = at(i, j);
    if constexpr (kLog) return full_logdet(a);
    else return full_det(a);
  } else {
    T LU[N][N];
    int piv[N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) LU[i][j] = at(i, j);
    plu_factor<T, N>(LU, piv);
    T r;
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
    return r;
  }
}

// One thread a problem, straight from device memory: the determinant's
// tier for n < kDetStagedN, and for a channel-first operand (each
// warp-wide load is then one contiguous run already).
template <typename T, int N, bool kLog>
__global__ void __launch_bounds__(kThreads)
det_unrolled(long long nb, MatView<T> mat, View<T> out) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const T* m = mat.p + b * mat.sb;
  out.p[b * out.sb] =
      det_one<T, N, kLog>([&](int i, int j) { return m[i * mat.rs + j * mat.cs]; });
}

// One thread a problem on the block's staged problems (as inv_unrolled;
// vectors that land whole, where the regions are packed, by copy_async):
// the thread takes its problem from its region and writes its one value
// straight to device memory, where the block's values are neighbours in
// either layout of the result.
template <typename T, int N, int P, bool kLog>
__global__ void __launch_bounds__(P) det_staged(long long nb, TileOperand<T> in, View<T> out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int S = staged_stride<T>(N * N);
  T* sm = reinterpret_cast<T*>(smem_raw);
  const long long b0 = blockIdx.x * (long long)P;
  const int np = nb - b0 < P ? (int)(nb - b0) : P;
  tile_stage<T, false, staged_loads<T>(N * N), true>(in, b0, np, P, S, sm);
  copy_async_wait();
  __syncthreads();
  if ((int)threadIdx.x < np) {
    const T* m = sm + threadIdx.x * S;
    out.p[(b0 + threadIdx.x) * out.sb] = det_one<T, N, kLog>([&](int i, int j) {
      return m[i * N + j];
    });
  }
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

// Whether the n <= 8 solve stages its problems (solve_full_staged), as the
// card measured it: k <= kSolveStagedK, problems of kSolveStagedBytes or
// more, not all of A, B and X channel-first (each thread's own accesses
// are then one contiguous run a warp already), and at k = 1 only from n =
// 7 in float and at odd n in float64 (at even n both areas pad and none of
// their vectors is copied whole); solve_full_unrolled takes the rest.
template <typename T>
bool solve_staged(int n, int k, long long asb, long long bsb, long long osb) {
  const bool one = k == 1 && (sizeof(T) == 4 ? n < 7 : n % 2 == 0);
  return k <= kSolveStagedK && (n * n + 2 * n * k) * (int)sizeof(T) >= kSolveStagedBytes &&
         !(asb == 1 && bsb == 1 && osb == 1) && !one;
}

template <typename T, int N>
void launch_solve_small(int k, long long nb, View<const T> a, bool trans, View<const T> b,
                        View<T> out, cudaStream_t s) {
  constexpr bool kStages = (N * N + 2 * N * kSolveStagedK) * (int)sizeof(T) >= kSolveStagedBytes;
  if constexpr (kStages) {
    if (solve_staged<T>(N, k, a.sb, b.sb, out.sb)) {
      constexpr int P = solve_staged_threads<T, N>(), SA = staged_stride<T>(N * N);
      const int SB = staged_stride<T>(N * k);
      const SolvePlan<T> plan{tile_flat_operand<T>(a, N * N, P, SA),
                              tile_flat_operand<T>(b, N * k, P, SB),
                              tile_flat_out<T>(out, N * k, P, SB)};
      // copy_async in float only at k = 1: beside it ptxas keeps a float
      // kernel's pivots or reciprocals in a local array, which each
      // column reads again (float64 keeps one either way)
      const auto kern = k == 1 ? solve_full_staged<T, N, P, true>
                               : solve_full_staged<T, N, P, sizeof(T) == 8>;
      const unsigned g = (unsigned)((nb + P - 1) / P);
      kern<<<g, P, P * (SA + SB) * (int)sizeof(T), s>>>(nb, k, trans, plan);
      return;
    }
  }
  solve_full_unrolled<T, N><<<grid_for(nb), kThreads, 0, s>>>(
      nb, k, mat_view<T>(a.p, a.sb, a.sc, N, N, trans), b, out);
}

template <typename T>
cudaError_t launch_solve_full(int n, int k, long long nb, View<const T> a, bool trans,
                              View<const T> rhs, View<T> out, cudaStream_t s) {
  if (k < 1) return cudaErrorInvalidValue;
  const MatView<T> mat = mat_view<T>(a.p, a.sb, a.sc, n, n, trans);
  switch (n) {
#define FM_SOLVE_FULL_CASE(K) \
  case K: launch_solve_small<T, K>(k, nb, a, trans, rhs, out, s); break;
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

// The smallest n whose determinant is staged (det_staged) where the
// operand is not channel-first.
constexpr int kDetStagedN = 4;

// The n <= 8 determinant: det_staged, P problems a block, their regions in
// dynamic shared memory, from n = kDetStagedN where the operand is not
// channel-first; det_unrolled otherwise.
template <typename T, int N, bool kLog>
void launch_det_small(long long nb, View<const T> in, View<T> out, cudaStream_t s) {
  if constexpr (N >= kDetStagedN) {
    if (in.sb != 1) {
      constexpr int P = staged_threads<T>(N * N), S = staged_stride<T>(N * N);
      det_staged<T, N, P, kLog><<<(unsigned)((nb + P - 1) / P), P, P * S * (int)sizeof(T), s>>>(
          nb, tile_flat_operand<T>(in, N * N, P, S), out);
      return;
    }
  }
  det_unrolled<T, N, kLog><<<grid_for(nb), kThreads, 0, s>>>(
      nb, mat_view<T>(in.p, in.sb, in.sc, N, N, 0), out);
}

template <typename T, bool kLog>
cudaError_t launch_det(int n, long long nb, View<const T> in, View<T> out, cudaStream_t s) {
  const MatView<T> mat = mat_view<T>(in.p, in.sb, in.sc, n, n, 0);
  switch (n) {
#define FM_DET_CASE(K) \
  case K: launch_det_small<T, K, kLog>(nb, in, out, s); break;
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
    return fm::launch_solve_full<float>(n, k, nb, fm::cview<float>(mat, msb, msc), trans != 0,
                                        fm::cview<float>(rhs, rsb, rsc),
                                        fm::view<float>(out, osb, osc), s);
  if (dtype == 1)
    return fm::launch_solve_full<double>(n, k, nb, fm::cview<double>(mat, msb, msc), trans != 0,
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
    const auto m = fm::cview<float>(mat, msb, msc);
    const auto o = fm::view<float>(out, osb, osc);
    return log_abs ? fm::launch_det<float, true>(n, nb, m, o, s)
               : fm::launch_det<float, false>(n, nb, m, o, s);
  }
  if (dtype == 1) {
    const auto m = fm::cview<double>(mat, msb, msc);
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
