// Generated by fastmath_tpu_torch/kernels/_gen_adjugate.py; do not edit.
// Cofactor grid adj (adj[i][j] = cofactor(j, i), so adj * v = det * A^-1 v)
// and determinant of a small entry grid, by memoized Laplace expansion.
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

}  // namespace fm
