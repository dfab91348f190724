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
// then columns p, q the same, and V's columns the same.
//   eig_unrolled: the cyclic order (p = 0..n-2, q = p+1..n-1) of
//     _jacobi_sweep_registers, one thread per problem, every index a
//     compile-time constant: the upper triangle (n(n+1)/2 values; the
//     rotated matrix stays exactly symmetric) and V (n^2) in registers.
//     a_pq is set to 0 after its rotation, as the reference does.
//   eig_rolled: the round-robin order of _round_robin (n - 1 rounds, n
//     for odd n, of floor(n/2) disjoint rotations), one warp per problem,
//     A and V in shared memory (row stride n | 1, so a column walk hits
//     distinct banks). Lane k computes rotation k of a round from the
//     matrix as the round found it; then each lane updates one column
//     (the row pass), and after a __syncwarp one row of A and of V (the
//     column pass). The rolled reference does not zero a_pq; neither
//     does this tier.
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
// sums each column in a lane and the lanes by a butterfly. Multiply-adds
// contract into FMAs, so results move a few ulp from the plain version.
//
// What bounds them: a problem reads n^2 values (the full matrix, or
// n(n+1)/2 compact) and writes n (+ n^2 with vectors), while one sweep
// costs about 3 n^3 flops (6 n^3 with vectors), and a problem needs a
// handful of sweeps: every size but the smallest is bound by operations,
// not bytes. The unrolled tier stages the block's input and output rows
// through shared memory, so device memory sees coalesced runs (a thread
// storing its own rows reached 10-28% of the byte bound in the other
// kernels of this package, staged rows 76-98%). The rolled tier spreads
// one problem's n^3 work over a warp instead of keeping 8 KB of matrix in
// one thread's local memory, as the other rolled tiers do.
//
// Every launch goes on the caller's stream, allocates nothing and does
// not synchronize; the entry point returns cudaGetLastError().

#include <cfloat>

#include <cuda_runtime.h>

#include "sym_common.cuh"

namespace fm {

// Problems per block of the unrolled tier: a block stages up to 64 rows
// of n^2 doubles (33 KB at n = 8) in static shared memory.
constexpr int kEigThreads = 64;
constexpr int kEigUnrollMax = 8;
constexpr int kWarpSize = 32;
constexpr unsigned kFullMask = 0xffffffffu;
// Dynamic shared memory a block of the rolled tier may take without an
// opt-in; it gets as many problems (warps, up to 8) as fit.
constexpr int kEigSmem = 48 * 1024;

__device__ __forceinline__ float eps_of(float) { return FLT_EPSILON; }
__device__ __forceinline__ double eps_of(double) { return DBL_EPSILON; }

// Odd row stride of a shared tile, so threads walking a column hit
// distinct banks.
__host__ __device__ constexpr int odd_stride(int w) { return w | 1; }

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

// ---------------------------------------------------------------------------
// unrolled tier: n <= 8, one thread per problem
// ---------------------------------------------------------------------------

// Slot of entry (i, j) in the upper-triangle array: the compact index.
__host__ __device__ constexpr int up(int i, int j, int n) { return tri_index(i, j, n); }

// Each thread's upper triangle. A full batch-major block (the public op's
// (B, n, n), either triangle) is staged through `tile` with coalesced
// loads; other layouts (compact channel-first: coalesced across the warp
// already; strided or broadcast batches) are read directly. Every thread
// of the block calls this (it synchronizes); rows past nb read as 0.
template <typename T, int N>
__device__ __forceinline__ void load_upper(T* tile, const SymIn<T>& in, long long nb,
                                           T (&A)[N * (N + 1) / 2]) {
  constexpr int W = N * N, P = odd_stride(W);
  const long long b0 = blockIdx.x * (long long)kEigThreads;
  const long long b = b0 + threadIdx.x;
  const bool staged = !in.compact && in.sb == W &&
                      ((in.rs == N && in.cs == 1) || (in.rs == 1 && in.cs == N));
  if (staged) {
    const long long rows = nb - b0 < kEigThreads ? nb - b0 : kEigThreads;
    const T* src = in.p + b0 * W;
    for (int e = threadIdx.x; e < rows * W; e += kEigThreads) tile[(e / W) * P + e % W] = src[e];
    __syncthreads();
    const T* row = tile + threadIdx.x * P;
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = i; j < N; ++j)
        A[up(i, j, N)] = b < nb ? row[i * in.rs + j * in.cs] : T(0);
    __syncthreads();
  } else {
    const T* base = in.p + b * in.sb;
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = i; j < N; ++j) A[up(i, j, N)] = b < nb ? sym_in(in, base, i, j, N) : T(0);
  }
}

// Each thread's W results of a (B, W) output: a batch-major contiguous
// output goes through `tile` and leaves the block as one coalesced run;
// other layouts (channel-first: coalesced across the warp) are written
// directly. Every thread of the block calls this (it synchronizes).
template <typename T, int W>
__device__ __forceinline__ void store_rows(T* tile, View<T> out, long long nb, const T (&y)[W]) {
  constexpr int P = odd_stride(W);
  const long long b0 = blockIdx.x * (long long)kEigThreads;
  const long long b = b0 + threadIdx.x;
  if (out.sc == 1 && out.sb == W) {
#pragma unroll
    for (int i = 0; i < W; ++i) tile[threadIdx.x * P + i] = y[i];
    __syncthreads();
    const long long rows = nb - b0 < kEigThreads ? nb - b0 : kEigThreads;
    T* dst = out.p + b0 * W;
    for (int e = threadIdx.x; e < rows * W; e += kEigThreads) dst[e] = tile[(e / W) * P + e % W];
    __syncthreads();
  } else if (b < nb) {
#pragma unroll
    for (int i = 0; i < W; ++i) out.p[b * out.sb + i * out.sc] = y[i];
  }
}

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

template <typename T, int N, bool U>
__global__ void __launch_bounds__(kEigThreads)
eig_unrolled(long long nb, int sweeps, SymIn<T> in, View<T> w, View<T> u) {
  constexpr int NN = N * (N + 1) / 2;
  __shared__ T tile[kEigThreads * odd_stride(N * N)];
  T A[NN];
  load_upper<T, N>(tile, in, nb, A);
  T V[U ? N * N : 1];
  if constexpr (U) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) V[i * N + j] = i == j ? T(1) : T(0);
  }
  const T eps = eps_of(T(0));
  const T tol = sum_squares<T, N>(A, true) * (T(16) * eps * eps);
  // rows past nb are zero, so their loop ends at once
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    if (!(sum_squares<T, N>(A, false) > tol)) break;
#pragma unroll
    for (int p = 0; p < N - 1; ++p)
#pragma unroll
      for (int q = p + 1; q < N; ++q) {
        const T app = A[p], aqq = A[q], apq = A[up(p, q, N)];
        T c, s;
        jacobi_rotation(app, aqq, apq, c, s);
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
  T d[N];
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = A[i];
  store_rows<T, N>(tile, w, nb, d);
  if constexpr (U) store_rows<T, N * N>(tile, u, nb, V);
}

// ---------------------------------------------------------------------------
// rolled tier: 9 <= n <= 32, one warp per problem
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  // a butterfly: every lane ends with the same bits
#pragma unroll
  for (int o = kWarpSize / 2; o > 0; o >>= 1) x = x + __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// Player at seat k of round r of the circle method (_round_robin): seat 0
// keeps player 0, the others rotate by one seat a round.
__device__ __forceinline__ int seat(int k, int r, int m) {
  if (k == 0) return 0;
  const int z = ((k - 1 - r) % (m - 1) + (m - 1)) % (m - 1);
  return z + 1;
}

template <typename T>
__global__ void eig_rolled(long long nb, int n, int sweeps, int compute_u, SymIn<T> in,
                           View<T> w, View<T> u) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarpSize, warp = threadIdx.x / kWarpSize;
  const int ld = odd_stride(n);
  T* A = reinterpret_cast<T*>(smem_raw) + (long long)warp * (compute_u ? 2 : 1) * n * ld;
  T* V = A + n * ld;
  const long long b = blockIdx.x * (long long)(blockDim.x / kWarpSize) + warp;
  if (b >= nb) return;  // the whole warp; no block-wide barrier follows
  const T* base = in.p + b * in.sb;
  if (lane < n) {
    for (int i = 0; i <= lane; ++i) {
      const T x = sym_in(in, base, i, lane, n);
      A[i * ld + lane] = x;
      A[lane * ld + i] = x;
    }
    if (compute_u)
      for (int i = 0; i < n; ++i) V[i * ld + lane] = i == lane ? T(1) : T(0);
  }
  __syncwarp();
  T col2 = T(0);
  if (lane < n)
    for (int i = 0; i < n; ++i) col2 = col2 + A[i * ld + lane] * A[i * ld + lane];
  const T eps = eps_of(T(0));
  const T tol = warp_sum(col2) * (T(16) * eps * eps);
  const int m = n + (n & 1), half = m / 2;
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    T off = T(0);
    if (lane < n)
      for (int i = 0; i < n; ++i)
        if (i != lane) off = off + A[i * ld + lane] * A[i * ld + lane];
    if (!(warp_sum(off) > tol)) break;
    for (int r = 0; r < m - 1; ++r) {
      // lane k < half: rotation k of round r, from the matrix as the
      // round found it (the pairs are disjoint, so none sees another's)
      int p = -1, q = -1;
      T c = T(1), s = T(0);
      if (lane < half) {
        const int x = seat(lane, r, m), y = seat(m - 1 - lane, r, m);
        if (x < n && y < n) {
          p = x < y ? x : y;
          q = x < y ? y : x;
          jacobi_rotation(A[p * ld + p], A[q * ld + q], A[p * ld + q], c, s);
        }
      }
      __syncwarp();
      // rows p, q of every pair: lane j owns column j
      for (int k = 0; k < half; ++k) {
        const int pk = __shfl_sync(kFullMask, p, k), qk = __shfl_sync(kFullMask, q, k);
        const T ck = __shfl_sync(kFullMask, c, k), sk = __shfl_sync(kFullMask, s, k);
        if (pk >= 0 && lane < n) {
          const T xp = A[pk * ld + lane], xq = A[qk * ld + lane];
          A[pk * ld + lane] = ck * xp + sk * xq;
          A[qk * ld + lane] = ck * xq - sk * xp;
        }
      }
      __syncwarp();
      // columns p, q of A and of V: lane i owns row i
      for (int k = 0; k < half; ++k) {
        const int pk = __shfl_sync(kFullMask, p, k), qk = __shfl_sync(kFullMask, q, k);
        const T ck = __shfl_sync(kFullMask, c, k), sk = __shfl_sync(kFullMask, s, k);
        if (pk >= 0 && lane < n) {
          T* a = A + lane * ld;
          const T xp = a[pk], xq = a[qk];
          a[pk] = ck * xp + sk * xq;
          a[qk] = ck * xq - sk * xp;
          if (compute_u) {
            T* v = V + lane * ld;
            const T vp = v[pk], vq = v[qk];
            v[pk] = ck * vp + sk * vq;
            v[qk] = ck * vq - sk * vp;
          }
        }
      }
      __syncwarp();
    }
  }
  if (lane < n) {
    w.p[b * w.sb + lane * w.sc] = A[lane * ld + lane];
    if (compute_u)
      for (int i = 0; i < n; ++i) u.p[b * u.sb + (i * n + lane) * u.sc] = V[i * ld + lane];
  }
}

// ---------------------------------------------------------------------------
// launcher
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t launch_eig(int n, int sweeps, int compute_u, long long nb, SymIn<T> in, View<T> w,
                       View<T> u, cudaStream_t s) {
  if (sweeps < 0 || n < 1 || n > kMaxN) return cudaErrorInvalidValue;
  if (n <= kEigUnrollMax) {
    const unsigned g = (unsigned)((nb + kEigThreads - 1) / kEigThreads);
    switch (2 * n + (compute_u ? 1 : 0)) {
#define FM_EIG_CASE(K)                                                                \
  case 2 * K: eig_unrolled<T, K, false><<<g, kEigThreads, 0, s>>>(nb, sweeps, in, w, u); break; \
  case 2 * K + 1: eig_unrolled<T, K, true><<<g, kEigThreads, 0, s>>>(nb, sweeps, in, w, u); break;
      FM_EIG_CASE(1) FM_EIG_CASE(2) FM_EIG_CASE(3) FM_EIG_CASE(4)
      FM_EIG_CASE(5) FM_EIG_CASE(6) FM_EIG_CASE(7) FM_EIG_CASE(8)
#undef FM_EIG_CASE
      default: return cudaErrorInvalidValue;
    }
  } else {
    const int per_warp = (compute_u ? 2 : 1) * n * odd_stride(n) * (int)sizeof(T);
    int warps = kEigSmem / per_warp;
    warps = warps > 8 ? 8 : warps;
    const unsigned g = (unsigned)((nb + warps - 1) / warps);
    eig_rolled<T><<<g, warps * kWarpSize, warps * per_warp, s>>>(nb, n, sweeps, compute_u, in,
                                                                 w, u);
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
