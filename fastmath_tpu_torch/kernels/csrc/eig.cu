// Symmetric eigendecomposition by Jacobi rotations for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of fastmath_tpu/kernels/eig_pallas.py:
//   eig_unrolled <- _eig_kernel          (n <= 8; eig_sym_cf)
//   eig_rolled   <- _eig_rolled_kernel   (9 <= n <= 32; eig_sym_cf)
//
// Each problem is one real symmetric n x n matrix, read from one triangle:
// compact storage (entry (i, j) at channel tri_index(i, j, n)) or full
// storage through a row and a column stride (the upper triangle; the
// wrapper swaps the strides to read the lower one). Outputs: the n
// eigenvalues (unsorted, the diagonal of the rotated matrix) and, if
// asked, the n x n eigenvector matrix V row-major (channel i * n + j is
// component i of eigenvector j).
//
// Both tiers keep the reference's rotation: for the pair (p, q), p < q,
// tau = (a_qq - a_pp) / (2 |a_pq|), t = -sign(tau) / (|tau| +
// sqrt(1 + tau^2)) (0 where a_pq = 0), c = 1 / sqrt(1 + t^2), s = t c
// sign(a_pq); rows p, q become (c row_p + s row_q, c row_q - s row_p),
// then columns p, q the same, and V's columns the same. The rolled tier
// computes (c, s) with IEEE divisions and square roots (jacobi_rotation);
// the unrolled tier from four special-function instructions, each within
// an ulp or two (jacobi_rotation_fast), so its results move a few ulp
// from the plain version's, as the contracted multiply-adds do.
//   eig_unrolled: the cyclic order (p = 0..n-2, q = p+1..n-1) of
//     _jacobi_sweep_registers, one thread per problem, every index a
//     compile-time constant: the upper triangle (n(n+1)/2 values; the
//     rotated matrix stays exactly symmetric) and V (n^2) in registers.
//     a_pq is set to 0 after its rotation, as the reference does. A
//     batch-major operand is staged through shared memory (tile_stage.cuh,
//     EigTiles), any other read and written by each thread.
//   eig_rolled<T, M, U>: the round-robin order of _round_robin (n - 1
//     rounds, n for odd n, of floor(n/2) disjoint rotations), a group of
//     16 lanes a problem to n = 16 (two a warp), 32 above; one kernel for
//     each even M = n + n % 2 (odd n adds a zero row and column, whose
//     rotations are exactly the identity). Lane i holds a row of A and row
//     i of V in registers; A is kept in the seat order of the circle
//     method, so each round's pairs are the seats (k, M - 1 - k), every
//     register index a constant, and the round is compiled once (the
//     rounds unrolled from a table took 230 s to build and about 140 KB of
//     instructions at n = 32, which ran slower with vectors). A round: one
//     store of each row to shared memory, the rotations computed by the
//     pairs' lower lanes from the rows as the round found them (oriented
//     by player, as the reference's p < q) and stored as vectors of (c,
//     s), then each lane's row pass against its facing row and the column
//     pass and V J on its own registers, then each row stored at its
//     player's next seat and reloaded. The rolled reference does not zero
//     a_pq; neither does this tier.
//
// The sweep loop of each problem exits on its own test, before each
// sweep: off^2 <= 16 eps^2 |A|_F^2, the squares summed over both
// triangles (off-diagonal entries for off^2, all for |A|_F^2, which the
// rotations leave invariant), or after `sweeps` sweeps. The TPU kernels
// test the largest off^2 of a block of problems against the largest
// |A|_F^2 of the block, and so leave a small-norm problem beside a
// large-norm one half rotated; this is a per-problem test.
//
// Term order: the unrolled tier sums |A|_F^2 and off^2 row by row from
// the first term, as the plain PyTorch version does; the rolled tier
// sums each row in a lane and the lanes by a butterfly. Multiply-adds
// contract into FMAs, so results move a few ulp from the plain version.
//
// What bounds them: a problem reads n^2 values (the full matrix, or
// n(n+1)/2 compact) and writes n (+ n^2 with vectors), while one sweep
// costs about 3 n^3 flops (6 n^3 with vectors), and a problem needs a
// handful of sweeps: every size but the smallest is bound by operations,
// not bytes. Each rotation needs two special-function results at the least
// (the square roots of the tangent's hypotenuse and of the half angle), at
// 16 a clock an SM: below the bytes at 4 x 4 on an H100 (0.0095 ms on 1M
// problems at 3.31 sweeps against 0.0239 of bytes). On an H100 80GB HBM3 at
// 700 W (chip_ab.py eig8, float32, 1M 4 x 4 values) the unrolled tier took
// 0.107 ms with IEEE divisions and square roots (5-6 MUFU instructions a
// rotation inside refinements, range checks and slow-path branches) and
// staging 4-byte elements through 64-problem blocks (0.043 ms alone); with
// jacobi_rotation_fast (4 MUFU) and tile_stage it takes 0.062: staging
// alone 0.030, arithmetic alone 0.048, bound by instruction throughput
// (about 48 instructions a rotation), and 11% more where a warp runs its
// slowest problem's sweeps (mean 3.31, the warps' largest 4.02; the
// problems sorted by sweeps 0.055). The rolled tier spreads one problem's
// n^3 work over a lane group: per round each lane does about
// 4 n multiply-adds (6 n with vectors) for 3 n / 4 vector accesses of
// shared memory (n / 2 in float64), two barriers and its share of the
// rotations' divisions and square roots.
//
// Every launch goes on the caller's stream, allocates nothing and does
// not synchronize; the entry point returns cudaGetLastError().

#include <cfloat>

#include <cuda_runtime.h>

#include "lu_groups.cuh"
#include "tile_stage.cuh"

namespace fm {

constexpr int kEigUnrollMax = 8;

__device__ __forceinline__ float eps_of(float) { return FLT_EPSILON; }
__device__ __forceinline__ double eps_of(double) { return DBL_EPSILON; }

// One symmetric input matrix per problem. Full storage: entry (i, j),
// i <= j, at p[b * sb + i * rs + j * cs]. Compact (compact != 0): entry
// (i, j) at p[b * sb + tri_index(i, j, n) * cs].
template <typename T>
struct SymIn {
  const T* p;
  long long sb, rs, cs;
  int compact;
};

// Entry (i, j), i <= j, of the problem whose first value is at base.
template <typename T>
__device__ __forceinline__ T sym_in(const SymIn<T>& in, const T* base, int i, int j, int n) {
  return in.compact ? base[tri_index(i, j, n) * in.cs] : base[i * in.rs + j * in.cs];
}

// The stable rotation of the pair (p, q) (Golub & Van Loan 8.4.1), the
// sign of a_pq folded into s.
template <typename T>
__device__ __forceinline__ void jacobi_rotation(T app, T aqq, T apq, T& c, T& s) {
  const T r = fm_abs(apq);
  const bool active = r > T(0);
  const T tau = (aqq - app) / (T(2) * (active ? r : T(1)));
  const T sgn = tau >= T(0) ? T(1) : T(-1);
  const T t = active ? -sgn / (fm_abs(tau) + fm_sqrt(T(1) + tau * tau)) : T(0);
  c = T(1) / fm_sqrt(T(1) + t * t);
  s = t * c * (apq >= T(0) ? T(1) : T(-1));
}

// One special-function instruction each (MUFU): 1 / x and 1 / sqrt(x),
// within about 1 ulp (rsqrt 2^-22.9 relative); every argument below is
// normal, or infinite, so flushing subnormals changes nothing.
__device__ __forceinline__ float rcp_approx(float x) {
#ifdef __CUDA_ARCH__
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return 1.0f / x;
#endif
}

__device__ __forceinline__ float rsqrt_approx(float x) {
#ifdef __CUDA_ARCH__
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return 1.0f / sqrtf(x);
#endif
}

// The unrolled tier's rotation: the same (c, s) as jacobi_rotation to a
// few ulp, from four special-function instructions where jacobi_rotation's
// three IEEE divisions and two square roots take five, each inside a
// sequence of refinements, range checks and a branch to a slow path.
//   tau = (a_qq - a_pp) * rcp(2 |a_pq|), 2 |a_pq| held at FLT_MIN or above
//     (a subnormal a_pq: tau is then as large, and t as near 0, as the
//     division makes them);
//   sqrt(1 + tau^2) = h rsqrt(h), kept infinite where tau^2 overflows
//     (fminf drops the NaN of inf * 0), so t = -sign(tau) rcp(|tau| +
//     sqrt(1 + tau^2)) is 0 there, as jacobi_rotation's is;
//   c = rsqrt(1 + t^2) and one Newton step, so that c^2 (1 + t^2) is 1 to
//     an ulp or two (each rotation then scales A by no more than
//     jacobi_rotation's does) and c = 1 exactly where t^2 < 2^-24.
// Float64 takes correctly rounded reciprocals (__drcp_rn) and rsqrt (1
// ulp) in place of its divisions and square roots.
__device__ __forceinline__ void jacobi_rotation_fast(float app, float aqq, float apq, float& c,
                                                     float& s) {
  const float r = fabsf(apq);
  const bool active = r > 0.0f;
  const float tau = (aqq - app) * rcp_approx(active ? fmaxf(2.0f * r, FLT_MIN) : 1.0f);
  const float h = fmaf(tau, tau, 1.0f);
  const float sq = fminf(h * rsqrt_approx(h), h);
  const float sgn = tau >= 0.0f ? 1.0f : -1.0f;
  const float t = active ? -sgn * rcp_approx(fabsf(tau) + sq) : 0.0f;
  const float u = fmaf(t, t, 1.0f);
  const float c0 = rsqrt_approx(u);
  c = c0 * fmaf(-0.5f * u * c0, c0, 1.5f);
  s = t * c * (apq >= 0.0f ? 1.0f : -1.0f);
}

__device__ __forceinline__ void jacobi_rotation_fast(double app, double aqq, double apq,
                                                     double& c, double& s) {
  const double r = fabs(apq);
  const bool active = r > 0.0;
  const double tau = (aqq - app) * __drcp_rn(active ? fmax(2.0 * r, DBL_MIN) : 1.0);
  const double h = fma(tau, tau, 1.0);
  const double sq = fmin(h * rsqrt(h), h);
  const double sgn = tau >= 0.0 ? 1.0 : -1.0;
  const double t = active ? -sgn * __drcp_rn(fabs(tau) + sq) : 0.0;
  c = rsqrt(fma(t, t, 1.0));
  s = t * c * (apq >= 0.0 ? 1.0 : -1.0);
}

// ---------------------------------------------------------------------------
// unrolled tier: n <= 8, one thread per problem
// ---------------------------------------------------------------------------

// Slot of entry (i, j) in the upper-triangle array: the compact index.
__host__ __device__ constexpr int up(int i, int j, int n) { return tri_index(i, j, n); }

// The unrolled tier's device memory: each batch-major operand (the input's
// n^2 full or n(n+1)/2 compact values, w's n, u's n^2, contiguous a
// problem) is staged through the problem's region of staged_stride(n^2)
// values (tile_stage.cuh) by the block in order; any other layout (the
// channel-first compact operands of eig_sym_cf, which the warp reads a
// channel at a time already, strided or broadcast batches) is read and
// written by each thread for its own problem.
template <typename T>
struct EigTiles {
  TileOperand<T> in;
  TileOut<T> w, u;
  bool in_staged, w_staged, u_staged;
};

// Squares of the symmetric matrix summed row by row over j from the first
// term: all of them (diag = true), or the off-diagonal ones.
template <typename T, int N>
__device__ __forceinline__ T sum_squares(const T (&A)[N * (N + 1) / 2], bool diag) {
  T acc = T(0);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (i == j && !diag) continue;
      const T a = A[i < j ? up(i, j, N) : up(j, i, N)];
      acc = acc + a * a;
    }
  return acc;
}

// The cyclic sweeps of one problem in registers (A its upper triangle, V
// the eigenvectors if U), each sweep after the problem's own test, at most
// `sweeps` of them.
template <typename T, int N, bool U>
__device__ __forceinline__ void eig_sweeps(T (&A)[N * (N + 1) / 2], T (&V)[U ? N * N : 1],
                                           int sweeps) {
  const T eps = eps_of(T(0));
  const T tol = sum_squares<T, N>(A, true) * (T(16) * eps * eps);
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    if (!(sum_squares<T, N>(A, false) > tol)) break;
#pragma unroll
    for (int p = 0; p < N - 1; ++p)
#pragma unroll
      for (int q = p + 1; q < N; ++q) {
        const T app = A[p], aqq = A[q], apq = A[up(p, q, N)];
        T c, s;
        jacobi_rotation_fast(app, aqq, apq, c, s);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          if (j == p || j == q) continue;
          const int kp = p < j ? up(p, j, N) : up(j, p, N);
          const int kq = q < j ? up(q, j, N) : up(j, q, N);
          const T xp = A[kp], xq = A[kq];
          A[kp] = c * xp + s * xq;
          A[kq] = c * xq - s * xp;
        }
        // the (p, q) block: rows, then columns, as on the full grid
        const T rpp = c * app + s * apq, rpq = c * apq + s * aqq;
        const T rqp = c * apq - s * app, rqq = c * aqq - s * apq;
        A[p] = c * rpp + s * rpq;
        A[q] = c * rqq - s * rqp;
        A[up(p, q, N)] = T(0);
        if constexpr (U) {
#pragma unroll
          for (int i = 0; i < N; ++i) {
            const T vp = V[i * N + p], vq = V[i * N + q];
            V[i * N + p] = c * vp + s * vq;
            V[i * N + q] = c * vq - s * vp;
          }
        }
      }
  }
}

// One thread a problem, P problems a block: the problem's upper triangle
// (zero past nb, whose loop then ends at once) from its region or device
// memory, its sweeps (eig_sweeps), and its eigenvalues, then its
// eigenvectors, through its region or straight to device memory. Every
// thread of the block reaches every barrier.
template <typename T, int N, bool U, int P>
__global__ void __launch_bounds__(P)
eig_unrolled(long long nb, int sweeps, SymIn<T> in, View<T> w, View<T> u, EigTiles<T> t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NN = N * (N + 1) / 2, S = staged_stride<T>(N * N);
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* m = sm + threadIdx.x * S;
  const long long b0 = blockIdx.x * (long long)P, b = b0 + threadIdx.x;
  const int np = nb - b0 < P ? (int)(nb - b0) : P;
  T A[NN];
  if (t.in_staged) {
    tile_stage<T, false, staged_loads<T>(N * N)>(t.in, b0, np, P, S, sm);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = i; j < N; ++j)
        A[up(i, j, N)] = b >= nb ? T(0) : m[in.compact ? up(i, j, N) : i * in.rs + j * in.cs];
  } else {
    const T* base = in.p + b * in.sb;
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = i; j < N; ++j) A[up(i, j, N)] = b < nb ? sym_in(in, base, i, j, N) : T(0);
  }
  T V[U ? N * N : 1];
  if constexpr (U) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) V[i * N + j] = i == j ? T(1) : T(0);
  }
  eig_sweeps<T, N, U>(A, V, sweeps);
  // the region is the thread's own since the first barrier
  if (t.w_staged) {
#pragma unroll
    for (int i = 0; i < N; ++i) m[i] = A[i];
    __syncthreads();
    tile_store<T>(t.w, b0, np, P, S, sm);
  } else if (b < nb) {
#pragma unroll
    for (int i = 0; i < N; ++i) w.p[b * w.sb + i * w.sc] = A[i];
  }
  if constexpr (U) {
    if (t.u_staged) {
      __syncthreads();  // w is written out before V takes the regions
#pragma unroll
      for (int k = 0; k < N * N; ++k) m[k] = V[k];
      __syncthreads();
      tile_store<T>(t.u, b0, np, P, S, sm);
    } else if (b < nb) {
#pragma unroll
      for (int k = 0; k < N * N; ++k) u.p[b * u.sb + k * u.sc] = V[k];
    }
  }
}

// ---------------------------------------------------------------------------
// rolled tier: 9 <= n <= 32, a group of G lanes a problem
// ---------------------------------------------------------------------------

// Lanes a problem of the rolled tier takes at M = n + (n & 1) players:
// two problems a warp to n = 16.
template <int M>
__host__ __device__ constexpr int eig_group() {
  return M <= 16 ? 16 : kLieWarp;
}

// Row stride of the group's shared rows: whole vectors, an odd number of
// them, so that eight lanes reading eight rows' vectors hit distinct
// banks.
template <typename T, int M>
__host__ __device__ constexpr int eig_ld() {
  return ((M + LuVec<T>::width - 1) / LuVec<T>::width | 1) * LuVec<T>::width;
}

// Values of one turn of rotations: M / 2 pairs' (c, s), whole vectors.
template <typename T, int M>
__host__ __device__ constexpr int eig_rot_len() {
  return (M + LuVec<T>::width - 1) / LuVec<T>::width * LuVec<T>::width;
}

// Shared memory of one group: the rows of A in two turns (M rows each; the
// first also stages the input, and V for the stores) and each turn's
// rotations.
template <typename T, int M>
__host__ __device__ constexpr int eig_group_bytes() {
  return (2 * M * eig_ld<T, M>() + 2 * eig_rot_len<T, M>()) * (int)sizeof(T);
}

// The player at seat k in round r of the circle method over M players
// (round_robin): seat 0 keeps player 0, and every other player moves up
// one seat a round (seat M - 1 to seat 1), so seat k > 0 holds player
// (k - 1 - r) mod (M - 1) + 1. Seat k faces seat M - 1 - k.
template <int M>
__device__ __forceinline__ int eig_player(int k, int r) {
  const int x = k - 1 - r;
  return k == 0 ? 0 : (x < 0 ? x + (M - 1) : x) + 1;
}

// A group of G = eig_group<M>() lanes a problem (32 / G problems a warp,
// every lane of the warp in every collective: a group past the batch runs
// a copy of the last problem and stores nothing), M = n + (n & 1); for odd
// n the last player is a zero row and column, whose rotations are exactly
// the identity (the pairs round_robin leaves out). The matrix is kept in
// seat order: lane k holds the row of A of the player at seat k, its
// columns in the same order, so every round rotates the pairs (k, M - 1 -
// k) and every register index is a compile-time constant. Lane i holds
// row i of V (its columns in seat order too). Each round: the seat's lower
// lane k < M / 2 computes the rotation of its pair from the rows as the
// round found them, oriented as round_robin's (p, q) by player, and stores
// (c, s) as seat k's; then each lane takes its facing row, r_k <- c r_k +
// s' r_(M-1-k) (s' = s at seat k, -s at seat M - 1 - k: the row pass),
// and applies every pair's (c, s) to its own columns (the column pass and
// V J). Between rounds the players move up one seat: each lane stores its
// row, columns moved, at its player's next seat, V's columns move in
// registers, and each lane reloads its seat's row; that store is also the
// next round's row exchange. M - 1 rounds bring every player back to its
// own seat, so each sweep starts and ends in the natural order. Each group
// tests its own convergence before each sweep; the warp sweeps while a
// group of it does, and a group that does not changes nothing.
template <typename T, int M, bool U>
__global__ void eig_rolled(long long nb, int n, int sweeps, SymIn<T> in, View<T> w, View<T> u) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using V = typename LuVec<T>::type;
  constexpr int G = eig_group<M>(), kW = LuVec<T>::width, LD = eig_ld<T, M>();
  constexpr int kNV = (M + kW - 1) / kW;  // vectors a row
  constexpr int H = M / 2;                // pairs a round
  const int lane = threadIdx.x % kLieWarp, gl = lane % G;
  const long long slot = blockIdx.x * (long long)(blockDim.x / G) + threadIdx.x / G;
  const long long b = slot < nb ? slot : nb - 1;
  T* rows = reinterpret_cast<T*>(smem_raw + (threadIdx.x / G) * eig_group_bytes<T, M>());
  T* rots = rows + 2 * M * LD;
  // stage the triangle that is read into both triangles, then take row gl
  {
    const T* base = in.p + b * in.sb;
    LuWalk e(gl, G, n);
    for (int t = gl; t < n * n; t += G, e.next())
      if (e.i <= e.c) {
        const T x = sym_in(in, base, e.i, e.c, n);
        rows[e.i * LD + e.c] = x;
        rows[e.c * LD + e.i] = x;
      }
  }
  __syncwarp(kLieMask);
  T a[kNV * kW], v[U ? kNV * kW : 1];
#pragma unroll
  for (int q = 0; q < kNV; ++q) {
    const V x = gl < n ? reinterpret_cast<const V*>(rows + gl * LD)[q] : V{};
#pragma unroll
    for (int c = 0; c < kW; ++c) a[q * kW + c] = gl < n && q * kW + c < n ? lu_get(x, c) : T(0);
  }
  if constexpr (U) {
#pragma unroll
    for (int j = 0; j < kNV * kW; ++j) v[j] = j == gl ? T(1) : T(0);
  }
  T tot = T(0);
#pragma unroll
  for (int j = 0; j < M; ++j) tot = tot + a[j] * a[j];
  const T eps = eps_of(T(0));
  const T tol = lie_grp_sum<T, G>(tot, kLieMask) * (T(16) * eps * eps);
  if (gl < M) {  // round 0's rows (the stage read its own row only)
#pragma unroll
    for (int q = 0; q < kNV; ++q) reinterpret_cast<V*>(rows + gl * LD)[q] = lu_pack<kNV * kW>(a, q);
  }
  __syncwarp(kLieMask);
  bool on = true;
  int turn = 0;  // which of the two turns of rows and rotations is the round's
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    T off = T(0);
#pragma unroll
    for (int j = 0; j < M; ++j)
      if (j != gl) off = off + a[j] * a[j];
    off = lie_grp_sum<T, G>(off, kLieMask);  // every lane: a butterfly
    on = on && off > tol;
    if (!__any_sync(kLieMask, on)) break;
    for (int r = 0; r < M - 1; ++r, ++turn) {
      const T* buf = rows + (turn & 1) * M * LD;
      T* nxt = rows + ((turn + 1) & 1) * M * LD;
      T* rot = rots + (turn & 1) * eig_rot_len<T, M>();
      const int f = M - 1 - gl;  // the facing seat
      if (on && gl < H) {
        T c, s;
        if (eig_player<M>(gl, r) < eig_player<M>(f, r)) {
          jacobi_rotation(buf[gl * LD + gl], buf[f * LD + f], buf[gl * LD + f], c, s);
        } else {
          jacobi_rotation(buf[f * LD + f], buf[gl * LD + gl], buf[f * LD + gl], c, s);
          s = -s;
        }
        rot[2 * gl] = c;
        rot[2 * gl + 1] = s;
      }
      __syncwarp(kLieMask);
      if (on) {
        if (gl < M) {  // the row pass
          const int h = gl < H ? gl : f;
          const T c = rot[2 * h], s = gl < H ? rot[2 * h + 1] : -rot[2 * h + 1];
          const V* x = reinterpret_cast<const V*>(buf + f * LD);
#pragma unroll
          for (int q = 0; q < kNV; ++q) {
            const V y = x[q];
#pragma unroll
            for (int e = 0; e < kW; ++e) a[q * kW + e] = c * a[q * kW + e] + s * lu_get(y, e);
          }
        }
        // the column pass, and V J: columns k and M - 1 - k of every pair
        const V* cs = reinterpret_cast<const V*>(rot);
#pragma unroll
        for (int q = 0; q < (2 * H + kW - 1) / kW; ++q) {
          const V y = cs[q];
#pragma unroll
          for (int e = 0; e < kW; e += 2) {
            const int k = (q * kW + e) / 2, l = M - 1 - k;
            if (k >= H) break;
            const T c = lu_get(y, e), s = lu_get(y, e + 1);
            const T ak = a[k], al = a[l];
            a[k] = c * ak + s * al;
            a[l] = c * al + (-s) * ak;
            if constexpr (U) {
              const T vk = v[k], vl = v[l];
              v[k] = c * vk + s * vl;
              v[l] = c * vl + (-s) * vk;
            }
          }
        }
        // every player up one seat: seat 0 stays, seat M - 1 goes to 1
        if (gl < M) {
          T* dst = nxt + (gl == 0 ? 0 : (gl == M - 1 ? 1 : gl + 1)) * LD;
#pragma unroll
          for (int q = 0; q < kNV; ++q) {
            T y[kW];
#pragma unroll
            for (int e = 0; e < kW; ++e) {
              const int j = q * kW + e;
              y[e] = j == 0 ? a[0] : (j == 1 ? a[M - 1] : (j < M ? a[j - 1] : T(0)));
            }
            reinterpret_cast<V*>(dst)[q] = lu_pack<kW>(y, 0);
          }
        }
        if constexpr (U) {
          const T last = v[M - 1];
#pragma unroll
          for (int j = M - 1; j > 1; --j) v[j] = v[j - 1];
          v[1] = last;
        }
      }
      __syncwarp(kLieMask);
      if (on && gl < M) {
#pragma unroll
        for (int q = 0; q < kNV; ++q) {
          const V y = reinterpret_cast<const V*>(nxt + gl * LD)[q];
#pragma unroll
          for (int e = 0; e < kW; ++e) a[q * kW + e] = lu_get(y, e);
        }
      }
    }
  }
  T dg = T(0);
#pragma unroll
  for (int j = 0; j < M; ++j)
    if (j == gl) dg = a[j];
  if (slot < nb && gl < n) w.p[slot * w.sb + gl * w.sc] = dg;
  if constexpr (U) {
    // V's rows through shared memory, stored in channel order
    __syncwarp(kLieMask);
    if (gl < M) {
#pragma unroll
      for (int q = 0; q < kNV; ++q) reinterpret_cast<V*>(rows + gl * LD)[q] = lu_pack<kNV * kW>(v, q);
    }
    __syncwarp(kLieMask);
    if (slot < nb) {
      T* dst = u.p + slot * u.sb;
      LuWalk e(gl, G, n);
      for (int t = gl; t < n * n; t += G, e.next()) dst[t * u.sc] = rows[e.i * LD + e.c];
    }
  }
}

// ---------------------------------------------------------------------------
// launcher
// ---------------------------------------------------------------------------

// The unrolled tier at order N: P = staged_threads(N^2) problems a block
// (64 where 128 regions of float64 pass 48 KB), each operand staged where
// it is contiguous batch-major (a full input whose strides read either
// triangle of its row-major storage, or a compact one).
template <typename T, int N, bool U>
void launch_eig_unrolled(long long nb, int sweeps, SymIn<T> in, View<T> w, View<T> u,
                         cudaStream_t s) {
  constexpr int P = staged_threads<T>(N * N), S = staged_stride<T>(N * N);
  const int size = in.compact ? N * (N + 1) / 2 : N * N;
  const bool flat = in.sb == size && (in.compact ? in.cs == 1
                                                 : (in.rs == N && in.cs == 1) ||
                                                       (in.rs == 1 && in.cs == N));
  const EigTiles<T> t{tile_flat_operand<T>(View<const T>{in.p, in.sb, 1}, size, P, S),
                      tile_flat_out<T>(w, N, P, S), tile_flat_out<T>(u, N * N, P, S), flat,
                      w.sb == N && w.sc == 1, U && u.sb == N * N && u.sc == 1};
  eig_unrolled<T, N, U, P><<<(unsigned)((nb + P - 1) / P), P, P * S * (int)sizeof(T), s>>>(
      nb, sweeps, in, w, u, t);
}

template <typename T>
cudaError_t launch_eig(int n, int sweeps, int compute_u, long long nb, SymIn<T> in, View<T> w,
                       View<T> u, cudaStream_t s) {
  if (sweeps < 0 || n < 1 || n > kMaxN) return cudaErrorInvalidValue;
  if (n <= kEigUnrollMax) {
    switch (2 * n + (compute_u ? 1 : 0)) {
#define FM_EIG_CASE(K)                                                       \
  case 2 * K: launch_eig_unrolled<T, K, false>(nb, sweeps, in, w, u, s); break; \
  case 2 * K + 1: launch_eig_unrolled<T, K, true>(nb, sweeps, in, w, u, s); break;
      FM_EIG_CASE(1) FM_EIG_CASE(2) FM_EIG_CASE(3) FM_EIG_CASE(4)
      FM_EIG_CASE(5) FM_EIG_CASE(6) FM_EIG_CASE(7) FM_EIG_CASE(8)
#undef FM_EIG_CASE
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (n + (n & 1) + (compute_u ? 1 : 0)) {
#define FM_EIG_ROLLED(M)                                                                      \
  case M: lu_launch<eig_group<M>()>(eig_rolled<T, M, false>, eig_group_bytes<T, M>(), nb, s, n, \
                                    sweeps, in, w, u); break;                                   \
  case M + 1: lu_launch<eig_group<M>()>(eig_rolled<T, M, true>, eig_group_bytes<T, M>(), nb, s, \
                                        n, sweeps, in, w, u); break;
      FM_EIG_ROLLED(10) FM_EIG_ROLLED(12) FM_EIG_ROLLED(14) FM_EIG_ROLLED(16)
      FM_EIG_ROLLED(18) FM_EIG_ROLLED(20) FM_EIG_ROLLED(22) FM_EIG_ROLLED(24)
      FM_EIG_ROLLED(26) FM_EIG_ROLLED(28) FM_EIG_ROLLED(30) FM_EIG_ROLLED(32)
#undef FM_EIG_ROLLED
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaGetLastError();
}

}  // namespace fm

// Plain C entry point (bound with ctypes). dtype: 0 = float, 1 = double.
// The input is (pointer, batch stride, row stride, column stride, compact
// flag) in elements (compact: the column stride is the channel stride and
// the row stride is unused); w and u are (pointer, batch stride, channel
// stride), u unused unless compute_u.
extern "C" int fm_eig_sym(int dtype, int n, int sweeps, int compute_u, long long nb,
                          const void* a, long long sb, long long rs, long long cs, int compact,
                          void* w, long long wsb, long long wsc,
                          void* u, long long usb, long long usc, void* stream) {
  if (nb <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fm::launch_eig<float>(
        n, sweeps, compute_u, nb, fm::SymIn<float>{static_cast<const float*>(a), sb, rs, cs, compact},
        fm::view<float>(w, wsb, wsc), fm::view<float>(u, usb, usc), s);
  if (dtype == 1)
    return fm::launch_eig<double>(
        n, sweeps, compute_u, nb,
        fm::SymIn<double>{static_cast<const double*>(a), sb, rs, cs, compact},
        fm::view<double>(w, wsb, wsc), fm::view<double>(u, usb, usc), s);
  return cudaErrorInvalidValue;
}
