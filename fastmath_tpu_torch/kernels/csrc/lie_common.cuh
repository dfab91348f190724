// Code shared by the matrix exponential and logarithm kernels (expm.cu,
// logm.cu), whose group sizes and launch shapes (lie_group, lie_warps) the
// lane-group LU (lu_groups.cuh) takes too: the staged row loads and stores
// of the one-thread-a-problem
// tiers, their unrolled products and squared distance to I, and the
// lane-group tiers' products, distance and Gauss-Jordan inverse on
// row-major d x d matrices in shared memory (a group of 8, 16 or 32 lanes
// a problem).
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
// the first term; c must not alias a or b.
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
      c[i * D + j] = (i == j ? add : T(0)) + acc * scale;
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
// a group of G lanes a problem (G = 8, 16 or 32, G >= d; 32 / G problems a
// warp): row-major d x d matrices in shared memory with row stride G, the
// columns d..G-1 zero, lane j of the group owning column j
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

// Column j of problem b into x, from lane j (j < d).
template <typename T, int G>
__device__ __forceinline__ void lie_grp_load(const MatView<T>& in, long long b, int d, int gl,
                                             T* x) {
  if (gl < d) {
    const T* base = in.p + b * in.sb + gl * in.cs;
    for (int i = 0; i < d; ++i) x[i * G + gl] = base[i * in.rs];
  }
}

// sum_k a[k] b[k] over the G entries of a row a (16-byte aligned, read
// as vectors) and a register column b, in order from the first term.
template <typename T, int G>
__device__ __forceinline__ T lie_row_dot(const T* a, const T (&b)[G]) {
  T acc;
  if constexpr (sizeof(T) == 4) {
    const float4* v = reinterpret_cast<const float4*>(a);
#pragma unroll
    for (int q = 0; q < G / 4; ++q) {
      const float4 x = v[q];
      acc = q == 0 ? x.x * b[0] : acc + x.x * b[4 * q];
      acc = acc + x.y * b[4 * q + 1];
      acc = acc + x.z * b[4 * q + 2];
      acc = acc + x.w * b[4 * q + 3];
    }
  } else {
    const double2* v = reinterpret_cast<const double2*>(a);
#pragma unroll
    for (int q = 0; q < G / 2; ++q) {
      const double2 x = v[q];
      acc = q == 0 ? x.x * b[0] : acc + x.x * b[2 * q];
      acc = acc + x.y * b[2 * q + 1];
    }
  }
  return acc;
}

// c = add I + scale (a b): lane j holds column j of b in registers (rows
// past d as 0) and forms column j of the product, each entry a row of a
// (a broadcast, read as vectors) against it, summed over k in order from
// the first term (the zero columns past d add exact zeros). c must not
// alias a or b. Ends synchronized.
template <typename T, int G>
__device__ __forceinline__ void lie_grp_mm(const T* a, const T* b, T* c, int d, int gl,
                                           unsigned mask, T add = T(0), T scale = T(1)) {
  T bc[G];
#pragma unroll
  for (int k = 0; k < G; ++k) bc[k] = k < d ? b[k * G + gl] : T(0);
  for (int i = 0; i < d; ++i) {
    const T acc = lie_row_dot<T, G>(a + i * G, bc);
    if (gl < d) c[i * G + gl] = (i == gl ? add : T(0)) + acc * scale;
  }
  __syncwarp(mask);
}

// dst = src + add I (column j by lane j). Ends synchronized.
template <typename T, int G>
__device__ __forceinline__ void lie_grp_copy(const T* src, T* dst, int d, int gl, unsigned mask,
                                             T add = T(0)) {
  if (gl < d)
    for (int i = 0; i < d; ++i) dst[i * G + gl] = src[i * G + gl] + (i == gl ? add : T(0));
  __syncwarp(mask);
}

// x = v I (column j by lane j). Ends synchronized.
template <typename T, int G>
__device__ __forceinline__ void lie_grp_eye(T* x, int d, int gl, unsigned mask, T v) {
  if (gl < d)
    for (int i = 0; i < d; ++i) x[i * G + gl] = i == gl ? v : T(0);
  __syncwarp(mask);
}

// sum of (x - I)^2: each lane sums its column over i in order, the lanes
// add by a butterfly (every lane of the group gets the same bits).
template <typename T, int G>
__device__ __forceinline__ T lie_grp_dist2(const T* x, int d, int gl, unsigned mask) {
  T acc = T(0);
  if (gl < d)
    for (int i = 0; i < d; ++i) {
      const T v = x[i * G + gl] - (i == gl ? T(1) : T(0));
      acc = acc + v * v;
    }
  return lie_grp_sum<T, G>(acc, mask);
}

// r = w^-1 by Gauss-Jordan elimination with partial pivoting: w is
// destroyed, r holds the identity on entry. The pivot of column k is the
// lowest row i >= k whose |w[i][k]| is the largest (found by a butterfly
// over the group, then its first lane's choice broadcast); rows k and p
// swap exactly, each lane its own column of w and r. Then the pivot row is
// divided by the pivot and its multiple subtracted from every other row
// (lane j: columns j > k of w, column j of r; column k of w is not written,
// so every lane reads the multipliers w[i][k] unchanged). A zero pivot
// gives inf/NaN, which propagates. Ends synchronized.
template <typename T, int G>
__device__ void lie_grp_inverse(T* w, T* r, int d, int gl, unsigned mask) {
  for (int k = 0; k < d; ++k) {
    T v = (gl >= k && gl < d) ? fm_abs(w[gl * G + k]) : T(-1);
    int p = gl;
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
      const T v2 = __shfl_xor_sync(mask, v, o, G);
      const int p2 = __shfl_xor_sync(mask, p, o, G);
      if (v2 > v || (v2 == v && p2 < p)) {
        v = v2;
        p = p2;
      }
    }
    p = __shfl_sync(mask, p, 0, G);
    if (p < k || p >= d) p = k;  // every candidate NaN
    if (p != k && gl < d) {
      T t = w[k * G + gl];
      w[k * G + gl] = w[p * G + gl];
      w[p * G + gl] = t;
      t = r[k * G + gl];
      r[k * G + gl] = r[p * G + gl];
      r[p * G + gl] = t;
    }
    __syncwarp(mask);
    if (gl < d) {
      const T piv = w[k * G + k];
      const T wk = w[k * G + gl] / piv;
      const T rk = r[k * G + gl] / piv;
      for (int i = 0; i < d; ++i) {
        if (i == k) continue;
        const T f = w[i * G + k];
        if (gl > k) w[i * G + gl] = w[i * G + gl] - f * wk;
        r[i * G + gl] = r[i * G + gl] - f * rk;
      }
      if (gl > k) w[k * G + gl] = wk;
      r[k * G + gl] = rk;
    }
    __syncwarp(mask);
  }
}

// Column j of x times `scale` to problem b of out, from lane j (j < d).
template <typename T, int G>
__device__ __forceinline__ void lie_grp_store(const T* x, View<T> out, long long b, int d,
                                              int gl, T scale) {
  if (gl < d)
    for (int i = 0; i < d; ++i) out.p[b * out.sb + (i * d + gl) * out.sc] = x[i * G + gl] * scale;
}

// Zero `n` values of a group's shared memory (its padding columns stay 0).
// Ends synchronized.
template <typename T, int G>
__device__ __forceinline__ void lie_grp_zero(T* x, int n, int gl, unsigned mask) {
  for (int e = gl; e < n; e += G) x[e] = T(0);
  __syncwarp(mask);
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
