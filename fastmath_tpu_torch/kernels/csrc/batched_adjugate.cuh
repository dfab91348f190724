// Generated by fastmath_tpu_torch/kernels/_gen_adjugate.py; do not edit.
// Inverse of a small full matrix from its row-major entries a[i * n + j]:
// inv[i * n + j] = cofactor(j, i) * (1 / det); its determinant; and
// log|det| with each row scaled by its largest magnitude first; by memoized
// Laplace expansion.
#pragma once

#include "sym_common.cuh"  // fm_abs, fm_max, fm_log

namespace fm {

template <typename T>
__host__ __device__ __forceinline__ void full_inverse(const T (&a)[4],
                                                    T (&inv)[4]) {
  const T m0 = a[0] * a[3] - a[1] * a[2];
  const T inv_det = T(1) / m0;
  inv[0] = a[3] * inv_det;
  inv[1] = -a[1] * inv_det;
  inv[2] = -a[2] * inv_det;
  inv[3] = a[0] * inv_det;
}

template <typename T>
__host__ __device__ __forceinline__ void full_inverse(const T (&a)[9],
                                                    T (&inv)[9]) {
  const T m0 = a[4] * a[8] - a[5] * a[7];
  const T m1 = a[3] * a[8] - a[5] * a[6];
  const T m2 = a[3] * a[7] - a[4] * a[6];
  const T m3 = a[0] * m0 - a[1] * m1 + a[2] * m2;
  const T inv_det = T(1) / m3;
  inv[0] = m0 * inv_det;
  const T m4 = a[1] * a[8] - a[2] * a[7];
  inv[1] = -m4 * inv_det;
  const T m5 = a[1] * a[5] - a[2] * a[4];
  inv[2] = m5 * inv_det;
  inv[3] = -m1 * inv_det;
  const T m6 = a[0] * a[8] - a[2] * a[6];
  inv[4] = m6 * inv_det;
  const T m7 = a[0] * a[5] - a[2] * a[3];
  inv[5] = -m7 * inv_det;
  inv[6] = m2 * inv_det;
  const T m8 = a[0] * a[7] - a[1] * a[6];
  inv[7] = -m8 * inv_det;
  const T m9 = a[0] * a[4] - a[1] * a[3];
  inv[8] = m9 * inv_det;
}

template <typename T>
__host__ __device__ __forceinline__ void full_inverse(const T (&a)[16],
                                                    T (&inv)[16]) {
  const T m0 = a[10] * a[15] - a[11] * a[14];
  const T m1 = a[9] * a[15] - a[11] * a[13];
  const T m2 = a[9] * a[14] - a[10] * a[13];
  const T m3 = a[5] * m0 - a[6] * m1 + a[7] * m2;
  const T m4 = a[8] * a[15] - a[11] * a[12];
  const T m5 = a[8] * a[14] - a[10] * a[12];
  const T m6 = a[4] * m0 - a[6] * m4 + a[7] * m5;
  const T m7 = a[8] * a[13] - a[9] * a[12];
  const T m8 = a[4] * m1 - a[5] * m4 + a[7] * m7;
  const T m9 = a[4] * m2 - a[5] * m5 + a[6] * m7;
  const T m10 = a[0] * m3 - a[1] * m6 + a[2] * m8 - a[3] * m9;
  const T inv_det = T(1) / m10;
  inv[0] = m3 * inv_det;
  const T m11 = a[1] * m0 - a[2] * m1 + a[3] * m2;
  inv[1] = -m11 * inv_det;
  const T m12 = a[6] * a[15] - a[7] * a[14];
  const T m13 = a[5] * a[15] - a[7] * a[13];
  const T m14 = a[5] * a[14] - a[6] * a[13];
  const T m15 = a[1] * m12 - a[2] * m13 + a[3] * m14;
  inv[2] = m15 * inv_det;
  const T m16 = a[6] * a[11] - a[7] * a[10];
  const T m17 = a[5] * a[11] - a[7] * a[9];
  const T m18 = a[5] * a[10] - a[6] * a[9];
  const T m19 = a[1] * m16 - a[2] * m17 + a[3] * m18;
  inv[3] = -m19 * inv_det;
  inv[4] = -m6 * inv_det;
  const T m20 = a[0] * m0 - a[2] * m4 + a[3] * m5;
  inv[5] = m20 * inv_det;
  const T m21 = a[4] * a[15] - a[7] * a[12];
  const T m22 = a[4] * a[14] - a[6] * a[12];
  const T m23 = a[0] * m12 - a[2] * m21 + a[3] * m22;
  inv[6] = -m23 * inv_det;
  const T m24 = a[4] * a[11] - a[7] * a[8];
  const T m25 = a[4] * a[10] - a[6] * a[8];
  const T m26 = a[0] * m16 - a[2] * m24 + a[3] * m25;
  inv[7] = m26 * inv_det;
  inv[8] = m8 * inv_det;
  const T m27 = a[0] * m1 - a[1] * m4 + a[3] * m7;
  inv[9] = -m27 * inv_det;
  const T m28 = a[4] * a[13] - a[5] * a[12];
  const T m29 = a[0] * m13 - a[1] * m21 + a[3] * m28;
  inv[10] = m29 * inv_det;
  const T m30 = a[4] * a[9] - a[5] * a[8];
  const T m31 = a[0] * m17 - a[1] * m24 + a[3] * m30;
  inv[11] = -m31 * inv_det;
  inv[12] = -m9 * inv_det;
  const T m32 = a[0] * m2 - a[1] * m5 + a[2] * m7;
  inv[13] = m32 * inv_det;
  const T m33 = a[0] * m14 - a[1] * m22 + a[2] * m28;
  inv[14] = -m33 * inv_det;
  const T m34 = a[0] * m18 - a[1] * m25 + a[2] * m30;
  inv[15] = m34 * inv_det;
}

template <typename T>
__host__ __device__ __forceinline__ T full_det(const T (&a)[1]) {
  return a[0];
}

template <typename T>
__host__ __device__ __forceinline__ T full_det(const T (&a)[4]) {
  const T m0 = a[0] * a[3] - a[1] * a[2];
  return m0;
}

template <typename T>
__host__ __device__ __forceinline__ T full_det(const T (&a)[9]) {
  const T m0 = a[4] * a[8] - a[5] * a[7];
  const T m1 = a[3] * a[8] - a[5] * a[6];
  const T m2 = a[3] * a[7] - a[4] * a[6];
  const T m3 = a[0] * m0 - a[1] * m1 + a[2] * m2;
  return m3;
}

template <typename T>
__host__ __device__ __forceinline__ T full_det(const T (&a)[16]) {
  const T m0 = a[10] * a[15] - a[11] * a[14];
  const T m1 = a[9] * a[15] - a[11] * a[13];
  const T m2 = a[9] * a[14] - a[10] * a[13];
  const T m3 = a[5] * m0 - a[6] * m1 + a[7] * m2;
  const T m4 = a[8] * a[15] - a[11] * a[12];
  const T m5 = a[8] * a[14] - a[10] * a[12];
  const T m6 = a[4] * m0 - a[6] * m4 + a[7] * m5;
  const T m7 = a[8] * a[13] - a[9] * a[12];
  const T m8 = a[4] * m1 - a[5] * m4 + a[7] * m7;
  const T m9 = a[4] * m2 - a[5] * m5 + a[6] * m7;
  const T m10 = a[0] * m3 - a[1] * m6 + a[2] * m8 - a[3] * m9;
  return m10;
}

template <typename T>
__device__ __forceinline__ T full_logdet(const T (&a)[1]) {
  const T r0 = fm_abs(a[0]);
  const T q0 = r0 > T(0) ? T(1) / r0 : T(0);
  const T s[1] = {a[0] * q0};
  return fm_log(r0 > T(0) ? r0 : T(1)) + fm_log(fm_abs(s[0]));
}

template <typename T>
__device__ __forceinline__ T full_logdet(const T (&a)[4]) {
  const T r0 = fm_max(fm_abs(a[0]), fm_abs(a[1]));
  const T q0 = r0 > T(0) ? T(1) / r0 : T(0);
  const T r1 = fm_max(fm_abs(a[2]), fm_abs(a[3]));
  const T q1 = r1 > T(0) ? T(1) / r1 : T(0);
  const T s[4] = {a[0] * q0, a[1] * q0, a[2] * q1, a[3] * q1};
  const T m0 = s[0] * s[3] - s[1] * s[2];
  return fm_log(r0 > T(0) ? r0 : T(1)) + fm_log(r1 > T(0) ? r1 : T(1)) + fm_log(fm_abs(m0));
}

template <typename T>
__device__ __forceinline__ T full_logdet(const T (&a)[9]) {
  const T r0 = fm_max(fm_max(fm_abs(a[0]), fm_abs(a[1])), fm_abs(a[2]));
  const T q0 = r0 > T(0) ? T(1) / r0 : T(0);
  const T r1 = fm_max(fm_max(fm_abs(a[3]), fm_abs(a[4])), fm_abs(a[5]));
  const T q1 = r1 > T(0) ? T(1) / r1 : T(0);
  const T r2 = fm_max(fm_max(fm_abs(a[6]), fm_abs(a[7])), fm_abs(a[8]));
  const T q2 = r2 > T(0) ? T(1) / r2 : T(0);
  const T s[9] = {a[0] * q0, a[1] * q0, a[2] * q0, a[3] * q1, a[4] * q1, a[5] * q1, a[6] * q2, a[7] * q2, a[8] * q2};
  const T m0 = s[4] * s[8] - s[5] * s[7];
  const T m1 = s[3] * s[8] - s[5] * s[6];
  const T m2 = s[3] * s[7] - s[4] * s[6];
  const T m3 = s[0] * m0 - s[1] * m1 + s[2] * m2;
  return fm_log(r0 > T(0) ? r0 : T(1)) + fm_log(r1 > T(0) ? r1 : T(1)) + fm_log(r2 > T(0) ? r2 : T(1)) + fm_log(fm_abs(m3));
}

template <typename T>
__device__ __forceinline__ T full_logdet(const T (&a)[16]) {
  const T r0 = fm_max(fm_max(fm_max(fm_abs(a[0]), fm_abs(a[1])), fm_abs(a[2])), fm_abs(a[3]));
  const T q0 = r0 > T(0) ? T(1) / r0 : T(0);
  const T r1 = fm_max(fm_max(fm_max(fm_abs(a[4]), fm_abs(a[5])), fm_abs(a[6])), fm_abs(a[7]));
  const T q1 = r1 > T(0) ? T(1) / r1 : T(0);
  const T r2 = fm_max(fm_max(fm_max(fm_abs(a[8]), fm_abs(a[9])), fm_abs(a[10])), fm_abs(a[11]));
  const T q2 = r2 > T(0) ? T(1) / r2 : T(0);
  const T r3 = fm_max(fm_max(fm_max(fm_abs(a[12]), fm_abs(a[13])), fm_abs(a[14])), fm_abs(a[15]));
  const T q3 = r3 > T(0) ? T(1) / r3 : T(0);
  const T s[16] = {a[0] * q0, a[1] * q0, a[2] * q0, a[3] * q0, a[4] * q1, a[5] * q1, a[6] * q1, a[7] * q1, a[8] * q2, a[9] * q2, a[10] * q2, a[11] * q2, a[12] * q3, a[13] * q3, a[14] * q3, a[15] * q3};
  const T m0 = s[10] * s[15] - s[11] * s[14];
  const T m1 = s[9] * s[15] - s[11] * s[13];
  const T m2 = s[9] * s[14] - s[10] * s[13];
  const T m3 = s[5] * m0 - s[6] * m1 + s[7] * m2;
  const T m4 = s[8] * s[15] - s[11] * s[12];
  const T m5 = s[8] * s[14] - s[10] * s[12];
  const T m6 = s[4] * m0 - s[6] * m4 + s[7] * m5;
  const T m7 = s[8] * s[13] - s[9] * s[12];
  const T m8 = s[4] * m1 - s[5] * m4 + s[7] * m7;
  const T m9 = s[4] * m2 - s[5] * m5 + s[6] * m7;
  const T m10 = s[0] * m3 - s[1] * m6 + s[2] * m8 - s[3] * m9;
  return fm_log(r0 > T(0) ? r0 : T(1)) + fm_log(r1 > T(0) ? r1 : T(1)) + fm_log(r2 > T(0) ? r2 : T(1)) + fm_log(r3 > T(0) ? r3 : T(1)) + fm_log(fm_abs(m10));
}

}  // namespace fm
