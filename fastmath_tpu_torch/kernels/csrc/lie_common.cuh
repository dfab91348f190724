// Code shared by the matrix exponential and logarithm kernels (expm.cu,
// logm.cu), whose group sizes and launch shapes (lie_group, lie_warps) and
// 16-byte vectors (LuVec) the lane-group LU (lu_groups.cuh) and the rolled
// eig tier (eig.cu) take too: the staged row loads and stores of
// logm_unrolled, the one-thread tiers' unrolled products and squared
// distance to I (expm_unrolled stages through tile_stage.cuh); a lane
// group's mask and butterfly (expm_warp keeps its register blocks in
// expm.cu); logm_warp's columns in registers, its column-major shared
// matrices and their products (a group of 8, 16 or 32 lanes a problem).
//
// Operands: the input is a MatView (entry (i, j) of problem b at
// p[b * sb + i * rs + j * cs]: the public ops' batch-major (B, d, d) of any
// strides, or a channel-first (d*d, B) tensor read as sb = 1, rs = d B,
// cs = B); the output is a View of d*d channels (entry (i, j) on channel
// i * d + j), batch-major contiguous or channel-first.
#pragma once

#include <cfloat>

#include <cuda_runtime.h>

#include "sym_common.cuh"

namespace fm {

// Problems per block of the one-thread-a-problem tiers.
constexpr int kLieThreads = 64;
constexpr int kLieWarp = 32;
constexpr unsigned kLieMask = 0xffffffffu;
// Dynamic shared memory a block of a warp tier takes without an opt-in;
// it gets as many problems (warps, up to 8) as fit, at least one.
constexpr int kLieSmem = 48 * 1024;

__host__ __device__ constexpr int lie_odd(int w) { return w | 1; }

__device__ __forceinline__ float lie_eps(float) { return FLT_EPSILON; }
__device__ __forceinline__ double lie_eps(double) { return DBL_EPSILON; }
__device__ __forceinline__ bool lie_finite(float x) { return isfinite(x); }
__device__ __forceinline__ bool lie_finite(double x) { return isfinite(x); }
__device__ __forceinline__ float lie_ldexp(float x, int e) { return ldexpf(x, e); }
__device__ __forceinline__ double lie_ldexp(double x, int e) { return ldexp(x, e); }
__device__ __forceinline__ float lie_nan(float) { return __int_as_float(0x7fffffff); }
__device__ __forceinline__ double lie_nan(double) {
  return __longlong_as_double(0x7fffffffffffffffll);
}

// ---------------------------------------------------------------------------
// one thread a problem
// ---------------------------------------------------------------------------

// Each thread's D x D matrix, row-major. A batch-major contiguous input
// is staged through `tile` with coalesced loads; other layouts
// (channel-first: coalesced across the warp already; strided or
// broadcast batches) are read directly. Every thread of the block calls
// this (it synchronizes); rows past nb read as 0.
template <typename T, int D>
__device__ __forceinline__ void lie_load(T* tile, const MatView<T>& in, long long nb,
                                         T (&x)[D * D]) {
  constexpr int W = D * D, P = lie_odd(W);
  const long long b0 = blockIdx.x * (long long)kLieThreads;
  const long long b = b0 + threadIdx.x;
  if (in.sb == W && in.rs == D && in.cs == 1) {
    const long long rows = nb - b0 < kLieThreads ? nb - b0 : kLieThreads;
    const T* src = in.p + b0 * W;
    for (int e = threadIdx.x; e < rows * W; e += kLieThreads) tile[(e / W) * P + e % W] = src[e];
    __syncthreads();
#pragma unroll
    for (int e = 0; e < W; ++e) x[e] = b < nb ? tile[threadIdx.x * P + e] : T(0);
    __syncthreads();
  } else {
    const T* base = in.p + b * in.sb;
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) x[i * D + j] = b < nb ? base[i * in.rs + j * in.cs] : T(0);
  }
}

// Each thread's W results: a batch-major contiguous output goes through
// `tile` and leaves the block as one coalesced run; other layouts are
// written directly. Every thread of the block calls this (it
// synchronizes).
template <typename T, int W>
__device__ __forceinline__ void lie_store(T* tile, View<T> out, long long nb, const T (&y)[W]) {
  constexpr int P = lie_odd(W);
  const long long b0 = blockIdx.x * (long long)kLieThreads;
  const long long b = b0 + threadIdx.x;
  if (out.sc == 1 && out.sb == W) {
#pragma unroll
    for (int e = 0; e < W; ++e) tile[threadIdx.x * P + e] = y[e];
    __syncthreads();
    const long long rows = nb - b0 < kLieThreads ? nb - b0 : kLieThreads;
    T* dst = out.p + b0 * W;
    for (int e = threadIdx.x; e < rows * W; e += kLieThreads) dst[e] = tile[(e / W) * P + e % W];
    __syncthreads();
  } else if (b < nb) {
#pragma unroll
    for (int e = 0; e < W; ++e) out.p[b * out.sb + e * out.sc] = y[e];
  }
}

// c = add I + scale (a b), each entry of a b summed over k in order from
// the first term; c must not alias a or b. No entry takes a `0 +` (it
// changes nothing but the sign of a zero, and costs an instruction an
// entry where scale is 1).
template <typename T, int D>
__device__ __forceinline__ void lie_mm(const T (&a)[D * D], const T (&b)[D * D], T (&c)[D * D],
                                       T add = T(0), T scale = T(1)) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      T acc = a[i * D] * b[j];
#pragma unroll
      for (int k = 1; k < D; ++k) acc = acc + a[i * D + k] * b[k * D + j];
      c[i * D + j] = i == j && add != T(0) ? add + acc * scale : acc * scale;
    }
}

// sum of (x - I)^2 over the entries, row by row from the first term.
template <typename T, int D>
__device__ __forceinline__ T lie_dist2(const T (&x)[D * D]) {
  T acc = T(0);
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const T v = x[i * D + j] - (i == j ? T(1) : T(0));
      acc = acc + v * v;
    }
  return acc;
}

// ---------------------------------------------------------------------------
// a group of G lanes a problem (G = 8, 16 or 32; 32 / G problems a warp):
// expm.cu's expm_warp, eig.cu's eig_rolled
// ---------------------------------------------------------------------------

// The group's lanes within the warp, for the *_sync intrinsics.
template <int G>
__device__ __forceinline__ unsigned lie_group_mask(int lane) {
  if constexpr (G == kLieWarp) {
    return kLieMask;
  } else {
    return ((1u << G) - 1u) << (lane / G * G);
  }
}

template <typename T, int G>
__device__ __forceinline__ T lie_grp_sum(T x, unsigned mask) {
  // a butterfly: every lane of the group ends with the same bits
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) x = x + __shfl_xor_sync(mask, x, o, G);
  return x;
}

// 16-byte vectors of T (float4, double2), as the lane groups' shared
// matrices are read and written.
template <typename T>
struct LuVec;
template <>
struct LuVec<float> {
  using type = float4;
  static constexpr int width = 4;
};
template <>
struct LuVec<double> {
  using type = double2;
  static constexpr int width = 2;
};

// Component c (a compile-time constant after unrolling) of a vector.
__device__ __forceinline__ float lu_get(const float4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}
__device__ __forceinline__ double lu_get(const double2& v, int c) { return c == 0 ? v.x : v.y; }

// Vector q of a register row.
template <int G>
__device__ __forceinline__ float4 lu_pack(const float (&r)[G], int q) {
  return make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
}
template <int G>
__device__ __forceinline__ double2 lu_pack(const double (&r)[G], int q) {
  return make_double2(r[2 * q], r[2 * q + 1]);
}

// ---------------------------------------------------------------------------
// a group of G lanes a problem, every lane of the warp in every call
// (logm.cu's logm_warp): lane j holds column j of a W x W matrix in
// registers (x[i] = X[i][j]; W = G, or 24 in a group of 32, whose lanes
// past W hold zero columns); a matrix that every lane reads is kept
// column-major in shared memory, column k at a + k * lie_cm_ld, 16-byte
// aligned. A d x d problem is padded to W x W with the identity, so every
// loop runs to W with constant register indices and no runtime bound. The
// helpers below take the width W as their G.
// ---------------------------------------------------------------------------

// n, opaque to the compiler. The lane-group loops are unrolled to G and
// test a runtime bound at every step; with the bound a constant they lose
// the tests, and ptxas hoists later steps' loads: logm_warp<float, 32>
// took 255 registers and spilled 3.5 KB (against 167 and none).
__device__ __forceinline__ int lie_opaque(int n) {
  asm volatile("" : "+r"(n));
  return n;
}

// Row stride of a column-major shared matrix: G plus one vector, so that
// the group's lanes writing or reading their own columns as vectors hit
// distinct banks.
template <typename T, int G>
__host__ __device__ constexpr int lie_cm_ld() {
  return G + LuVec<T>::width;
}

// Column gl of x to column gl of a.
template <typename T, int G>
__device__ __forceinline__ void lie_col_put(T* a, int gl, const T (&x)[G]) {
  using V = typename LuVec<T>::type;
  V* dst = reinterpret_cast<V*>(a + gl * lie_cm_ld<T, G>());
#pragma unroll
  for (int q = 0; q < G / LuVec<T>::width; ++q) dst[q] = lu_pack<G>(x, q);
}

// Column gl of a into x.
template <typename T, int G>
__device__ __forceinline__ void lie_col_get(const T* a, int gl, T (&x)[G]) {
  using V = typename LuVec<T>::type;
  constexpr int kW = LuVec<T>::width;
  const V* src = reinterpret_cast<const V*>(a + gl * lie_cm_ld<T, G>());
#pragma unroll
  for (int q = 0; q < G / kW; ++q) {
    const V v = src[q];
#pragma unroll
    for (int c = 0; c < kW; ++c) x[q * kW + c] = lu_get(v, c);
  }
}

// Row gl of a + add I into x: the row layout of lu_group_factor.
template <typename T, int G>
__device__ __forceinline__ void lie_row_get(const T* a, int gl, T (&x)[G], T add = T(0)) {
#pragma unroll
  for (int c = 0; c < G; ++c) {
    const T v = a[c * lie_cm_ld<T, G>() + gl];
    x[c] = c == gl ? v + add : v;
  }
}

// Problem b's column gl into x, padded with the identity past d: the
// group reads each row i in order (coalesced in a batch-major layout).
template <typename T, int G>
__device__ __forceinline__ void lie_col_load(const MatView<T>& in, long long b, int d, int gl,
                                             T (&x)[G]) {
  const T* base = in.p + b * in.sb + gl * in.cs;
#pragma unroll
  for (int i = 0; i < G; ++i)
    x[i] = gl < d && i < d ? base[i * in.rs] : (i == gl ? T(1) : T(0));
}

// c = add I + scale (a b): a and b column-major in shared memory (b may be
// a), c a column in registers. Lane gl forms column gl of the product:
// entry i sums a[i][k] b[k][gl] over k in order from the first term, the G
// rows at once (G independent sums in flight), each column of a read as
// broadcast vectors and the lane's own column of b a vector at a time. k
// runs to n (G, lie_opaque) in a loop that is not unrolled: a product
// costs a few hundred bytes of code instead of tens of kilobytes. On
// identity-padded operands the terms past d are exact zeros.
template <typename T, int G>
__device__ __forceinline__ void lie_cm_mm(const T* a, const T* b, T (&c)[G], int n, int gl,
                                          T add = T(0), T scale = T(1)) {
  using V = typename LuVec<T>::type;
  constexpr int kW = LuVec<T>::width, kLd = lie_cm_ld<T, G>();
  T acc[G];
#pragma unroll
  for (int i = 0; i < G; ++i) acc[i] = T(0);
  const V* bc = reinterpret_cast<const V*>(b + gl * kLd);
#pragma unroll 1
  for (int k0 = 0; k0 < n; k0 += kW) {
    const V bv = bc[k0 / kW];
#pragma unroll
    for (int e = 0; e < kW; ++e) {
      const T bk = lu_get(bv, e);
      const V* col = reinterpret_cast<const V*>(a + (k0 + e) * kLd);
#pragma unroll
      for (int q = 0; q < G / kW; ++q) {
        const V v = col[q];
#pragma unroll
        for (int f = 0; f < kW; ++f) acc[q * kW + f] = acc[q * kW + f] + lu_get(v, f) * bk;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < G; ++i) c[i] = (i == gl ? add : T(0)) + acc[i] * scale;
}

// |X - I|_F^2 of the matrix whose column gl is x (W rows; the group's
// lanes past W hold zero columns): each lane sums its column in order, the
// group's G lanes add by a butterfly (every lane of the group gets the
// same bits). The identity padding adds exact zeros.
template <typename T, int G, int W = G>
__device__ __forceinline__ T lie_col_dist2(const T (&x)[W], int gl) {
  T acc = T(0);
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const T v = x[i] - (i == gl ? T(1) : T(0));
    acc = acc + v * v;
  }
  return lie_grp_sum<T, G>(acc, kLieMask);
}

// Lanes a problem takes at size d.
inline int lie_group(int d) { return d <= 8 ? 8 : (d <= 16 ? 16 : kLieWarp); }

// Warps a block of a group tier takes at `per_warp` bytes of shared memory
// each: as many as kLieSmem holds, up to 8, at least 1.
inline int lie_warps(int per_warp) {
  int w = kLieSmem / per_warp;
  return w < 1 ? 1 : (w > 8 ? 8 : w);
}

}  // namespace fm
