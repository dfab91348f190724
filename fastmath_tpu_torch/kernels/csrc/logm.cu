// Batched matrix logarithm for Hopper (sm_90a): inverse scaling and
// squaring with product-form Denman-Beavers square roots and a Gregory
// (atanh) series.
//
// Replaces the Pallas TPU kernels of fastmath_tpu/kernels/logm_pallas.py
// (all behind logm_cf):
//   logm_unrolled <- _logm_kernel         (d <= 8 there; here d <= the
//                                          unrolled bound, one thread a problem)
//   logm_warp     <- _logm_rolled_kernel  (9 <= d <= 24) and
//                    _logm_flat_kernel    (25 <= d <= 32): a lane group
//                                          a problem for every larger d
// The three TPU tiers differ only in how their loops nest, a split forced
// by the TPU compiler's compile time; the flat tier's masked commit is the
// same function. Here every tier runs the nested algebra.
//
// Each problem is one real d x d matrix A (d <= 32), read through its
// strides (lie_common.cuh). The algebra is the reference's:
//   D = A - I, k = 0;
//   up to 12 times, while |A - I|_F > 0.25 (and finite):
//     the square root of A by the unscaled product-form Denman-Beavers
//     iteration: M = Y = A; up to 36 times, while |M - I|_F > db_tol (and
//     finite), db_tol = 8 eps d, then once more where the test passed:
//       T = M + I, Y = (Y M^-1 T) / 2, M = (M^-1 (T T)) / 4;
//     the root counts only where |M - I|_F <= 8 db_tol, else it is NaN;
//     D = D (Y + I)^-1 (the cancellation-free A - I of Al-Mohy & Higham),
//     A = Y, k = k + 1;
//   then Z = D (A + I)^-1, log A = 2^(k+1) Z (I/1 + Z^2/3 + ... + Z^(o-1)/o)
//   by Horner in Z^2 (o = 9 in float32, 21 in float64);
//   a problem that never reached |A - I|_F <= 0.25 comes back NaN
//   (eigenvalues on the negative real axis: the caller reroutes it).
// The iteration stays unscaled so that on-cut eigenvalues diverge to NaN
// instead of converging to a branch that is not the principal one.
// Each problem runs its own iterations and stops on its own tests. The
// TPU kernels iterate a block of problems until its every finite problem
// passes, so all but a block's slowest problem take further steps past
// the test; those steps are not idempotent in float32: at |M - I|_F ~
// db_tol the root still carries about db_tol / 2 of error, which the
// final 2^(k+1) multiplies. The one step past the test (M then converges
// quadratically to rounding) gives every problem that accuracy: without
// it the float32 roundtrip chain expm(0.999 logm(e)), k = 4, exceeds
// 1e-5 normwise on some 4x4 problems where the TPU kernel's algebra does
// not (tests/test_torch_lie_kernels.py). Inverses: cofactors times 1/det for
// d <= 4 (batched_adjugate.cuh's full_inverse), Gauss-Jordan with
// partial pivoting and exact row swaps in the warp tier.
//
// Tiers, split where the state stops fitting in registers (set from
// -Xptxas -v on the card; the square root holds D, M, Y, M^-1, T and a
// product temporary, 6 d^2 values):
//   logm_unrolled<T, D>: one thread a problem, every index a compile-time
//     constant, the matrices in registers, staged loads and stores as in
//     expm.cu.
//   logm_warp<T, G>: a group of G = 8, 16 or 32 lanes a problem (the
//     least G >= d; 32 / G problems a warp), seven d x d matrices row-major
//     in shared memory with row stride G, the columns past d zero (A, D, M,
//     Y, T or the inverse's work matrix, M^-1 and a product scratch: 28 KB
//     at d = 32 in float32, 57 KB in float64, above 48 KB with an opt-in).
//     Lane j forms column j of each product from column j of its right
//     factor held in registers against the rows of the left (broadcasts,
//     read as 16-byte vectors), and column j of each Gauss-Jordan step.
//
// What bounds them: a problem reads and writes d^2 values and needs
// about (10 d^3 per Denman-Beavers step, 4 d^3 per square-root commit,
// 2 d^3 (o + 5) / 2 for the series) operations: tens of operations per
// byte at every d, so every tier is bound by operations. Multiply-adds
// contract into FMAs, so results move a few ulp from the plain PyTorch
// version (fastmath_tpu_torch/kernels/logm.py, logm_plain), which repeats
// this arithmetic.
//
// Every launch goes on the caller's stream, allocates nothing and does
// not synchronize; the entry point returns cudaGetLastError().

#include "batched_adjugate.cuh"
#include "lie_common.cuh"

namespace fm {

constexpr int kIssMax = 12;
constexpr int kDbIters = 36;
// |A - I|_F^2 below which the series runs
constexpr double kThresh2 = 0.0625;
// the largest d of the one-thread tier, by dtype (registers, see above)
template <typename T>
constexpr int logm_unroll_max();
template <>
constexpr int logm_unroll_max<float>() { return 4; }
template <>
constexpr int logm_unroll_max<double>() { return 4; }

template <typename T>
__host__ __device__ constexpr int logm_order();
template <>
__host__ __device__ constexpr int logm_order<float>() { return 9; }
template <>
__host__ __device__ constexpr int logm_order<double>() { return 21; }

template <typename T, int D>
__device__ __forceinline__ void inverse_small(const T (&a)[D * D], T (&inv)[D * D]) {
  if constexpr (D == 1) {
    inv[0] = T(1) / a[0];
  } else {
    full_inverse(a, inv);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kLieThreads)
logm_unrolled(long long nb, MatView<T> in, View<T> out) {
  constexpr int W = D * D;
  constexpr int kOrder = logm_order<T>();
  const T thresh2 = T(kThresh2);
  const T tol = lie_eps(T(0)) * T(8 * D);
  const T tol2 = tol * tol, conv2 = (T(8) * tol) * (T(8) * tol);
  __shared__ T tile[kLieThreads * lie_odd(W)];
  T a[W];
  lie_load<T, D>(tile, in, nb, a);
  T dm[W];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) dm[i * D + j] = a[i * D + j] - (i == j ? T(1) : T(0));
  int k = 0;
  bool cut = false;
  for (int it = 0; it < kIssMax; ++it) {
    const T d2 = lie_dist2<T, D>(a);
    if (!(lie_finite(d2) && d2 > thresh2)) break;
    T m[W], y[W], minv[W], t[W], p[W];
#pragma unroll
    for (int e = 0; e < W; ++e) m[e] = y[e] = a[e];
    bool polished = false;  // the one step past the test (see the header)
    for (int j = 0; j <= kDbIters; ++j) {
      const T e2 = lie_dist2<T, D>(m);
      if (!lie_finite(e2)) break;
      if (e2 <= tol2) {
        if (polished) break;
        polished = true;
      } else if (j == kDbIters) {
        break;
      }
      inverse_small<T, D>(m, minv);
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int c = 0; c < D; ++c) t[i * D + c] = m[i * D + c] + (i == c ? T(1) : T(0));
      lie_mm<T, D>(y, minv, p);
      lie_mm<T, D>(p, t, y, T(0), T(0.5));
      lie_mm<T, D>(t, t, p);
      lie_mm<T, D>(minv, p, m, T(0), T(0.25));
    }
    ++k;
    const T e2 = lie_dist2<T, D>(m);
    if (!(lie_finite(e2) && e2 <= conv2)) {  // no principal square root chain
      cut = true;
      break;
    }
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int c = 0; c < D; ++c) t[i * D + c] = y[i * D + c] + (i == c ? T(1) : T(0));
    inverse_small<T, D>(t, minv);
    lie_mm<T, D>(dm, minv, p);
#pragma unroll
    for (int e = 0; e < W; ++e) {
      dm[e] = p[e];
      a[e] = y[e];
    }
  }
  const T d2 = lie_dist2<T, D>(a);
  T l[W];
  if (cut || !(lie_finite(d2) && d2 <= thresh2)) {
#pragma unroll
    for (int e = 0; e < W; ++e) l[e] = lie_nan(T(0));
  } else {
    T ap[W], ainv[W], z[W], z2[W], acc[W], q[W];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int c = 0; c < D; ++c) ap[i * D + c] = a[i * D + c] + (i == c ? T(1) : T(0));
    inverse_small<T, D>(ap, ainv);
    lie_mm<T, D>(dm, ainv, z);
    lie_mm<T, D>(z, z, z2);
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int c = 0; c < D; ++c) acc[i * D + c] = i == c ? T(1) / T(kOrder) : T(0);
#pragma unroll
    for (int o = kOrder - 2; o > 0; o -= 2) {
      lie_mm<T, D>(z2, acc, q, T(1) / T(o));
#pragma unroll
      for (int e = 0; e < W; ++e) acc[e] = q[e];
    }
    lie_mm<T, D>(z, acc, l);
    const T scale = T(2) * lie_ldexp(T(1), k);
#pragma unroll
    for (int e = 0; e < W; ++e) l[e] = l[e] * scale;
  }
  lie_store<T, W>(tile, out, nb, l);
}

template <typename T, int G>
__global__ void logm_warp(long long nb, int d, MatView<T> in, View<T> out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kOrder = logm_order<T>();
  const T thresh2 = T(kThresh2);
  const T tol = lie_eps(T(0)) * T(8 * d);
  const T tol2 = tol * tol, conv2 = (T(8) * tol) * (T(8) * tol);
  const int lane = threadIdx.x % kLieWarp, gl = lane % G;
  const unsigned mask = lie_group_mask<G>(lane);
  const long long slot = blockIdx.x * (long long)(blockDim.x / G) + threadIdx.x / G;
  const int dg = d * G;
  T* a = reinterpret_cast<T*>(smem_raw) + (threadIdx.x / G) * 7 * dg;
  T* dm = a + dg;
  T* m = dm + dg;
  T* y = m + dg;
  T* w = y + dg;   // T = M + I, or the matrix an inverse destroys
  T* r = w + dg;   // an inverse
  T* s = r + dg;   // product scratch
  if (slot >= nb) return;  // the whole group; no block-wide barrier follows
  lie_grp_zero<T, G>(a, 7 * dg, gl, mask);
  lie_grp_load<T, G>(in, slot, d, gl, a);
  __syncwarp(mask);
  lie_grp_copy<T, G>(a, dm, d, gl, mask, T(-1));
  int k = 0;
  bool cut = false;
  for (int it = 0; it < kIssMax; ++it) {
    const T d2 = lie_grp_dist2<T, G>(a, d, gl, mask);
    if (!(lie_finite(d2) && d2 > thresh2)) break;
    lie_grp_copy<T, G>(a, m, d, gl, mask);
    lie_grp_copy<T, G>(a, y, d, gl, mask);
    bool polished = false;  // the one step past the test (see the header)
    for (int j = 0; j <= kDbIters; ++j) {
      const T e2 = lie_grp_dist2<T, G>(m, d, gl, mask);
      if (!lie_finite(e2)) break;
      if (e2 <= tol2) {
        if (polished) break;
        polished = true;
      } else if (j == kDbIters) {
        break;
      }
      lie_grp_copy<T, G>(m, w, d, gl, mask);
      lie_grp_eye<T, G>(r, d, gl, mask, T(1));
      lie_grp_inverse<T, G>(w, r, d, gl, mask);
      lie_grp_copy<T, G>(m, w, d, gl, mask, T(1));
      lie_grp_mm<T, G>(y, r, s, d, gl, mask);
      lie_grp_mm<T, G>(s, w, y, d, gl, mask, T(0), T(0.5));
      lie_grp_mm<T, G>(w, w, s, d, gl, mask);
      lie_grp_mm<T, G>(r, s, m, d, gl, mask, T(0), T(0.25));
    }
    ++k;
    const T e2 = lie_grp_dist2<T, G>(m, d, gl, mask);
    if (!(lie_finite(e2) && e2 <= conv2)) {  // no principal square root chain
      cut = true;
      break;
    }
    lie_grp_copy<T, G>(y, w, d, gl, mask, T(1));
    lie_grp_eye<T, G>(r, d, gl, mask, T(1));
    lie_grp_inverse<T, G>(w, r, d, gl, mask);
    lie_grp_mm<T, G>(dm, r, s, d, gl, mask);
    T* u = dm;
    dm = s;
    s = u;
    u = a;
    a = y;
    y = u;
  }
  const T d2 = lie_grp_dist2<T, G>(a, d, gl, mask);
  if (cut || !(lie_finite(d2) && d2 <= thresh2)) {
    if (gl < d)
      for (int i = 0; i < d; ++i) out.p[slot * out.sb + (i * d + gl) * out.sc] = lie_nan(T(0));
    return;
  }
  lie_grp_copy<T, G>(a, w, d, gl, mask, T(1));
  lie_grp_eye<T, G>(r, d, gl, mask, T(1));
  lie_grp_inverse<T, G>(w, r, d, gl, mask);
  T* z = m;
  T* z2 = y;
  T* acc = w;
  lie_grp_mm<T, G>(dm, r, z, d, gl, mask);
  lie_grp_mm<T, G>(z, z, z2, d, gl, mask);
  lie_grp_eye<T, G>(acc, d, gl, mask, T(1) / T(kOrder));
  for (int o = kOrder - 2; o > 0; o -= 2) {
    lie_grp_mm<T, G>(z2, acc, s, d, gl, mask, T(1) / T(o));
    T* u = acc;
    acc = s;
    s = u;
  }
  lie_grp_mm<T, G>(z, acc, s, d, gl, mask);
  lie_grp_store<T, G>(s, out, slot, d, gl, T(2) * lie_ldexp(T(1), k));
}

template <typename T, int G>
cudaError_t launch_logm_group(int d, long long nb, MatView<T> in, View<T> out, cudaStream_t s) {
  const int per_warp = (kLieWarp / G) * 7 * d * G * (int)sizeof(T);
  const int warps = lie_warps(per_warp);
  const int bytes = warps * per_warp;
  if (bytes > kLieSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        logm_warp<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  const int per_block = warps * (kLieWarp / G);
  const unsigned g = (unsigned)((nb + per_block - 1) / per_block);
  logm_warp<T, G><<<g, warps * kLieWarp, bytes, s>>>(nb, d, in, out);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_logm(int d, long long nb, MatView<T> in, View<T> out, cudaStream_t s) {
  if (d < 1 || d > kMaxN) return cudaErrorInvalidValue;
  if (d <= logm_unroll_max<T>()) {
    const unsigned g = (unsigned)((nb + kLieThreads - 1) / kLieThreads);
    switch (d) {
#define FM_LOGM_CASE(K) \
  case K: if constexpr (K <= logm_unroll_max<T>()) logm_unrolled<T, K><<<g, kLieThreads, 0, s>>>(nb, in, out); break;
      FM_LOGM_CASE(1) FM_LOGM_CASE(2) FM_LOGM_CASE(3) FM_LOGM_CASE(4)
#undef FM_LOGM_CASE
      default: return cudaErrorInvalidValue;
    }
  } else {
    const int g = lie_group(d);
    const cudaError_t e = g == 8    ? launch_logm_group<T, 8>(d, nb, in, out, s)
                          : g == 16 ? launch_logm_group<T, 16>(d, nb, in, out, s)
                                    : launch_logm_group<T, kLieWarp>(d, nb, in, out, s);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

}  // namespace fm

// Plain C entry point (bound with ctypes). dtype: 0 = float, 1 = double.
// The input is (pointer, batch stride, row stride, column stride) in
// elements; the output (pointer, batch stride, channel stride), entry
// (i, j) on channel i * d + j.
extern "C" int fm_logm(int dtype, int d, long long nb, const void* a, long long sb, long long rs,
                       long long cs, void* out, long long osb, long long osc, void* stream) {
  if (nb <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fm::launch_logm<float>(
        d, nb, fm::MatView<float>{static_cast<const float*>(a), sb, rs, cs},
        fm::view<float>(out, osb, osc), s);
  if (dtype == 1)
    return fm::launch_logm<double>(
        d, nb, fm::MatView<double>{static_cast<const double*>(a), sb, rs, cs},
        fm::view<double>(out, osb, osc), s);
  return cudaErrorInvalidValue;
}

// The largest d of the one-thread tier for dtype (0 = float, 1 = double):
// the Python wrapper checks its own copy of the bound against it.
extern "C" int fm_logm_unroll_max(int dtype) {
  return dtype == 0 ? fm::logm_unroll_max<float>() : fm::logm_unroll_max<double>();
}
