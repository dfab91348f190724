// Generated by fastmath_tpu_torch/kernels/_gen_adjugate.py; do not edit.
// Cofactor grid adj (adj[i][j] = cofactor(j, i), so adj * v = det * A^-1 v)
// and determinant of a small entry grid; determinant and inverse of a small
// compact matrix from its compact entries c (inverse slot (i, j), i <= j:
// cofactor(j, i) * (1 / det)); by memoized Laplace expansion.
#pragma once

namespace fm {

template <typename T>
__host__ __device__ __forceinline__ T sym_cofactors(const T (&E)[2][2],
                                                    T (&adj)[2][2]) {
  const T m0 = E[0][0] * E[1][1] - E[0][1] * E[1][0];
  adj[0][0] = E[1][1];
  adj[0][1] = -E[0][1];
  adj[1][0] = -E[1][0];
  adj[1][1] = E[0][0];
  return m0;
}

template <typename T>
__host__ __device__ __forceinline__ T sym_cofactors(const T (&E)[3][3],
                                                    T (&adj)[3][3]) {
  const T m0 = E[1][1] * E[2][2] - E[1][2] * E[2][1];
  const T m1 = E[1][0] * E[2][2] - E[1][2] * E[2][0];
  const T m2 = E[1][0] * E[2][1] - E[1][1] * E[2][0];
  const T m3 = E[0][0] * m0 - E[0][1] * m1 + E[0][2] * m2;
  adj[0][0] = m0;
  const T m4 = E[0][1] * E[2][2] - E[0][2] * E[2][1];
  adj[0][1] = -m4;
  const T m5 = E[0][1] * E[1][2] - E[0][2] * E[1][1];
  adj[0][2] = m5;
  adj[1][0] = -m1;
  const T m6 = E[0][0] * E[2][2] - E[0][2] * E[2][0];
  adj[1][1] = m6;
  const T m7 = E[0][0] * E[1][2] - E[0][2] * E[1][0];
  adj[1][2] = -m7;
  adj[2][0] = m2;
  const T m8 = E[0][0] * E[2][1] - E[0][1] * E[2][0];
  adj[2][1] = -m8;
  const T m9 = E[0][0] * E[1][1] - E[0][1] * E[1][0];
  adj[2][2] = m9;
  return m3;
}

template <typename T>
__host__ __device__ __forceinline__ T sym_cofactors(const T (&E)[4][4],
                                                    T (&adj)[4][4]) {
  const T m0 = E[2][2] * E[3][3] - E[2][3] * E[3][2];
  const T m1 = E[2][1] * E[3][3] - E[2][3] * E[3][1];
  const T m2 = E[2][1] * E[3][2] - E[2][2] * E[3][1];
  const T m3 = E[1][1] * m0 - E[1][2] * m1 + E[1][3] * m2;
  const T m4 = E[2][0] * E[3][3] - E[2][3] * E[3][0];
  const T m5 = E[2][0] * E[3][2] - E[2][2] * E[3][0];
  const T m6 = E[1][0] * m0 - E[1][2] * m4 + E[1][3] * m5;
  const T m7 = E[2][0] * E[3][1] - E[2][1] * E[3][0];
  const T m8 = E[1][0] * m1 - E[1][1] * m4 + E[1][3] * m7;
  const T m9 = E[1][0] * m2 - E[1][1] * m5 + E[1][2] * m7;
  const T m10 = E[0][0] * m3 - E[0][1] * m6 + E[0][2] * m8 - E[0][3] * m9;
  adj[0][0] = m3;
  const T m11 = E[0][1] * m0 - E[0][2] * m1 + E[0][3] * m2;
  adj[0][1] = -m11;
  const T m12 = E[1][2] * E[3][3] - E[1][3] * E[3][2];
  const T m13 = E[1][1] * E[3][3] - E[1][3] * E[3][1];
  const T m14 = E[1][1] * E[3][2] - E[1][2] * E[3][1];
  const T m15 = E[0][1] * m12 - E[0][2] * m13 + E[0][3] * m14;
  adj[0][2] = m15;
  const T m16 = E[1][2] * E[2][3] - E[1][3] * E[2][2];
  const T m17 = E[1][1] * E[2][3] - E[1][3] * E[2][1];
  const T m18 = E[1][1] * E[2][2] - E[1][2] * E[2][1];
  const T m19 = E[0][1] * m16 - E[0][2] * m17 + E[0][3] * m18;
  adj[0][3] = -m19;
  adj[1][0] = -m6;
  const T m20 = E[0][0] * m0 - E[0][2] * m4 + E[0][3] * m5;
  adj[1][1] = m20;
  const T m21 = E[1][0] * E[3][3] - E[1][3] * E[3][0];
  const T m22 = E[1][0] * E[3][2] - E[1][2] * E[3][0];
  const T m23 = E[0][0] * m12 - E[0][2] * m21 + E[0][3] * m22;
  adj[1][2] = -m23;
  const T m24 = E[1][0] * E[2][3] - E[1][3] * E[2][0];
  const T m25 = E[1][0] * E[2][2] - E[1][2] * E[2][0];
  const T m26 = E[0][0] * m16 - E[0][2] * m24 + E[0][3] * m25;
  adj[1][3] = m26;
  adj[2][0] = m8;
  const T m27 = E[0][0] * m1 - E[0][1] * m4 + E[0][3] * m7;
  adj[2][1] = -m27;
  const T m28 = E[1][0] * E[3][1] - E[1][1] * E[3][0];
  const T m29 = E[0][0] * m13 - E[0][1] * m21 + E[0][3] * m28;
  adj[2][2] = m29;
  const T m30 = E[1][0] * E[2][1] - E[1][1] * E[2][0];
  const T m31 = E[0][0] * m17 - E[0][1] * m24 + E[0][3] * m30;
  adj[2][3] = -m31;
  adj[3][0] = -m9;
  const T m32 = E[0][0] * m2 - E[0][1] * m5 + E[0][2] * m7;
  adj[3][1] = m32;
  const T m33 = E[0][0] * m14 - E[0][1] * m22 + E[0][2] * m28;
  adj[3][2] = -m33;
  const T m34 = E[0][0] * m18 - E[0][1] * m25 + E[0][2] * m30;
  adj[3][3] = m34;
  return m10;
}

template <typename T>
__host__ __device__ __forceinline__ T compact_det(const T (&c)[1]) {
  return c[0];
}

template <typename T>
__host__ __device__ __forceinline__ T compact_det(const T (&c)[3]) {
  const T m0 = c[0] * c[1] - c[2] * c[2];
  return m0;
}

template <typename T>
__host__ __device__ __forceinline__ T compact_det(const T (&c)[6]) {
  const T m0 = c[1] * c[2] - c[5] * c[5];
  const T m1 = c[3] * c[2] - c[5] * c[4];
  const T m2 = c[3] * c[5] - c[1] * c[4];
  const T m3 = c[0] * m0 - c[3] * m1 + c[4] * m2;
  return m3;
}

template <typename T>
__host__ __device__ __forceinline__ T compact_det(const T (&c)[10]) {
  const T m0 = c[2] * c[3] - c[9] * c[9];
  const T m1 = c[7] * c[3] - c[9] * c[8];
  const T m2 = c[7] * c[9] - c[2] * c[8];
  const T m3 = c[1] * m0 - c[7] * m1 + c[8] * m2;
  const T m4 = c[5] * c[3] - c[9] * c[6];
  const T m5 = c[5] * c[9] - c[2] * c[6];
  const T m6 = c[4] * m0 - c[7] * m4 + c[8] * m5;
  const T m7 = c[5] * c[8] - c[7] * c[6];
  const T m8 = c[4] * m1 - c[1] * m4 + c[8] * m7;
  const T m9 = c[4] * m2 - c[1] * m5 + c[7] * m7;
  const T m10 = c[0] * m3 - c[4] * m6 + c[5] * m8 - c[6] * m9;
  return m10;
}

template <typename T>
__host__ __device__ __forceinline__ void compact_inverse(const T (&c)[1],
                                                       T (&inv)[1]) {
  const T inv_det = T(1) / c[0];
  inv[0] = T(1) * inv_det;
}

template <typename T>
__host__ __device__ __forceinline__ void compact_inverse(const T (&c)[3],
                                                       T (&inv)[3]) {
  const T m0 = c[0] * c[1] - c[2] * c[2];
  const T inv_det = T(1) / m0;
  inv[0] = c[1] * inv_det;
  inv[2] = -c[2] * inv_det;
  inv[1] = c[0] * inv_det;
}

template <typename T>
__host__ __device__ __forceinline__ void compact_inverse(const T (&c)[6],
                                                       T (&inv)[6]) {
  const T m0 = c[1] * c[2] - c[5] * c[5];
  const T m1 = c[3] * c[2] - c[5] * c[4];
  const T m2 = c[3] * c[5] - c[1] * c[4];
  const T m3 = c[0] * m0 - c[3] * m1 + c[4] * m2;
  const T inv_det = T(1) / m3;
  inv[0] = m0 * inv_det;
  const T m4 = c[3] * c[2] - c[4] * c[5];
  inv[3] = -m4 * inv_det;
  const T m5 = c[3] * c[5] - c[4] * c[1];
  inv[4] = m5 * inv_det;
  const T m6 = c[0] * c[2] - c[4] * c[4];
  inv[1] = m6 * inv_det;
  const T m7 = c[0] * c[5] - c[4] * c[3];
  inv[5] = -m7 * inv_det;
  const T m8 = c[0] * c[1] - c[3] * c[3];
  inv[2] = m8 * inv_det;
}

template <typename T>
__host__ __device__ __forceinline__ void compact_inverse(const T (&c)[10],
                                                       T (&inv)[10]) {
  const T m0 = c[2] * c[3] - c[9] * c[9];
  const T m1 = c[7] * c[3] - c[9] * c[8];
  const T m2 = c[7] * c[9] - c[2] * c[8];
  const T m3 = c[1] * m0 - c[7] * m1 + c[8] * m2;
  const T m4 = c[5] * c[3] - c[9] * c[6];
  const T m5 = c[5] * c[9] - c[2] * c[6];
  const T m6 = c[4] * m0 - c[7] * m4 + c[8] * m5;
  const T m7 = c[5] * c[8] - c[7] * c[6];
  const T m8 = c[4] * m1 - c[1] * m4 + c[8] * m7;
  const T m9 = c[4] * m2 - c[1] * m5 + c[7] * m7;
  const T m10 = c[0] * m3 - c[4] * m6 + c[5] * m8 - c[6] * m9;
  const T inv_det = T(1) / m10;
  inv[0] = m3 * inv_det;
  const T m11 = c[4] * m0 - c[5] * m1 + c[6] * m2;
  inv[4] = -m11 * inv_det;
  const T m12 = c[7] * c[3] - c[8] * c[9];
  const T m13 = c[1] * c[3] - c[8] * c[8];
  const T m14 = c[1] * c[9] - c[7] * c[8];
  const T m15 = c[4] * m12 - c[5] * m13 + c[6] * m14;
  inv[5] = m15 * inv_det;
  const T m16 = c[7] * c[9] - c[8] * c[2];
  const T m17 = c[1] * c[9] - c[8] * c[7];
  const T m18 = c[1] * c[2] - c[7] * c[7];
  const T m19 = c[4] * m16 - c[5] * m17 + c[6] * m18;
  inv[6] = -m19 * inv_det;
  const T m20 = c[0] * m0 - c[5] * m4 + c[6] * m5;
  inv[1] = m20 * inv_det;
  const T m21 = c[4] * c[3] - c[8] * c[6];
  const T m22 = c[4] * c[9] - c[7] * c[6];
  const T m23 = c[0] * m12 - c[5] * m21 + c[6] * m22;
  inv[7] = -m23 * inv_det;
  const T m24 = c[4] * c[9] - c[8] * c[5];
  const T m25 = c[4] * c[2] - c[7] * c[5];
  const T m26 = c[0] * m16 - c[5] * m24 + c[6] * m25;
  inv[8] = m26 * inv_det;
  const T m27 = c[4] * c[8] - c[1] * c[6];
  const T m28 = c[0] * m13 - c[4] * m21 + c[6] * m27;
  inv[2] = m28 * inv_det;
  const T m29 = c[4] * c[7] - c[1] * c[5];
  const T m30 = c[0] * m17 - c[4] * m24 + c[6] * m29;
  inv[9] = -m30 * inv_det;
  const T m31 = c[0] * m18 - c[4] * m25 + c[5] * m29;
  inv[3] = m31 * inv_det;
}

}  // namespace fm
