// Lane-group LU with first-max partial pivoting for 9 <= n <= 32, shared by
// the determinant / log-determinant kernel (batched.cu, det_groups) and the
// compact inverse (sym_factor.cu, sym_invert_groups).
//
// A group of G lanes owns one problem (G = 16 for n <= 16, 32 above:
// lie_group; 32 / G problems a warp, lie_common.cuh). Lane i holds row i
// of A in registers, G values with the columns past n zero, and every loop
// over the elimination step k or a column j is unrolled to G, so every
// register index is a compile-time constant. Every *_sync takes the whole
// warp: both groups of a warp run every step together (a group past the
// batch runs a copy of the last problem and stores nothing), and each
// group's reductions read only its own lanes' values, so a problem that
// goes inf or NaN never reaches its neighbour.
//
// Rows never move. Each lane keeps in a register the position its row would
// hold after rolled_factor's whole-row swaps (sym_common.cuh): at step k the
// pivot is the first largest |a[i][k]| over the positions >= k, found by
// warp reductions (REDUX) of |a[i][k]|'s bits, then of position; the row at
// position k takes the pivot's position p, and the parity flips where
// p != k. As in rolled_factor's `v > m` scan, a NaN never wins, except at
// position k itself (nothing compares greater than it); an all-zero column
// keeps position k. The winning lane writes its row to the group's pivot
// row in shared memory (16-byte vector stores) and retires; every other
// live lane reads it as broadcast vectors, forms l = a[i][k] / U_kk (by
// division, as rolled_factor) and updates its columns k+1.. with FMAs in
// registers.
//
// The determinant keeps two pivot rows in turn and the retiring rows'
// pivots. The inverse keeps every retired row (row s of U, with the
// multipliers of row s's steps in its columns < s: in-place LU) and the lane
// each came from, then lane c solves for column c of A^-1: forward
// substitution against the pivoted identity column, which is what
// eliminating [A | I] does to it, then rolled_backsub's back-substitution.
// Every U and L read is a broadcast, and a lane holds about n live values
// instead of 2n.
//
// Operands are staged through shared memory so that device memory sees
// the group read and write each problem's values in order (contiguous,
// hence coalesced, in the batch-major layout; the channel-first views of
// the *_cf wrappers are read through the same strides, correct but not
// coalesced).
#pragma once

#include "lie_common.cuh"

namespace fm {

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

// The group's largest x: one REDUX over the warp, at G = 16 one for each
// group, every lane offering x in its own group's turn and 0 in the
// other's. The mask stays the whole warp: a REDUX whose mask differs
// between the lanes of a warp compiles to a loop over the distinct masks.
template <int G>
__device__ __forceinline__ unsigned lu_grp_max(unsigned x, int lane) {
  if constexpr (G == kLieWarp) {
    return __reduce_max_sync(kLieMask, x);
  } else {
    static_assert(G == 16, "two groups a warp");
    const bool upper = lane >= 16;
    const unsigned lo = __reduce_max_sync(kLieMask, upper ? 0u : x);
    const unsigned hi = __reduce_max_sync(kLieMask, upper ? x : 0u);
    return upper ? hi : lo;
  }
}

// The least position pos < G over the group's lanes with `hit`: one REDUX
// over the warp; at G = 16 one OR of the bits 1 << pos, each group's in
// its own 16 bits, for both groups.
template <int G>
__device__ __forceinline__ int lu_grp_first(bool hit, int pos, int lane) {
  if constexpr (G == kLieWarp) {
    return (int)__reduce_min_sync(kLieMask, hit ? (unsigned)pos : 0xffu);
  } else {
    const int shift = lane / G * G;
    const unsigned bits = __reduce_or_sync(kLieMask, hit ? 1u << (pos + shift) : 0u);
    return __ffs(bits >> shift) - 1;
  }
}

// The pivot position of the step whose candidates are the live lanes' v
// at positions pos (`at_k`: pos is the step's own position). The key of a
// live candidate is |v|'s bit pattern, which orders as |v| does; a NaN
// keys below every number, except at position k, where it keys above every
// number (rolled_factor's `v > m` scan starts there and nothing exceeds
// it). Then the least position holding the largest key. A problem's keys
// never reach the other group's reductions.
template <int G>
__device__ __forceinline__ int lu_pivot(float v, bool live, bool at_k, int pos, int lane) {
  unsigned key = 0u;
  if (live) key = v != v ? (at_k ? 0xffffffffu : 0u) : (__float_as_uint(v) & 0x7fffffffu);
  const unsigned top = lu_grp_max<G>(key, lane);
  return lu_grp_first<G>(live && key == top, pos, lane);
}

template <int G>
__device__ __forceinline__ int lu_pivot(double v, bool live, bool at_k, int pos, int lane) {
  unsigned hi = 0u, lo = 0u;  // the key's two words
  if (live) {
    if (v != v) {
      hi = lo = at_k ? 0xffffffffu : 0u;
    } else {
      const unsigned long long bits =
          (unsigned long long)__double_as_longlong(v) & 0x7fffffffffffffffull;
      hi = (unsigned)(bits >> 32);
      lo = (unsigned)bits;
    }
  }
  const unsigned top_hi = lu_grp_max<G>(hi, lane);
  const unsigned top_lo = lu_grp_max<G>(hi == top_hi ? lo : 0u, lane);
  return lu_grp_first<G>(live && hi == top_hi && lo == top_lo, pos, lane);
}

// A lane's part of the factorization: the parity of the row permutation
// (the same in every lane of the group), the step at which its row became
// the pivot row (its row of U; -1 for lanes >= n) and that pivot, U_ss.
template <typename T>
struct LuLane {
  int odd;
  int step;
  T pivot;
};

// Factor the n x n matrix whose row gl is `row` (zero past n; lanes >= n
// hold zeros and take part only in the collectives). Step k's
// pivot row goes to shared memory at `rows` (16-byte aligned, row stride
// G): with kSolve to row k, whole, with the multipliers of its steps, and
// perm[k] names the lane it came from; otherwise to row k % 2 from the
// vector holding column k on (two rows in turn suffice: one __syncwarp a
// step orders a row's readers before its next writer). Ends synchronized.
template <typename T, int G, bool kSolve>
__device__ __forceinline__ LuLane<T> lu_group_factor(T (&row)[G], int n, int lane, T* rows,
                                                     int* perm) {
  const int gl = lane % G;
  using V = typename LuVec<T>::type;
  constexpr int kW = LuVec<T>::width;
  int pos = gl;
  bool live = gl < n;
  LuLane<T> me{0, -1, T(0)};
#pragma unroll
  for (int k = 0; k < G; ++k) {
    if (k >= n) break;
    const int p = lu_pivot<G>(row[k], live, pos == k, pos, lane);
    T* pr = rows + (kSolve ? k : (k & 1)) * G;
    if (live && pos == p) {
#pragma unroll
      for (int q = 0; q < G / kW; ++q)
        if (kSolve || q >= k / kW) reinterpret_cast<V*>(pr)[q] = lu_pack<G>(row, q);
      if constexpr (kSolve) perm[k] = gl;
      me.step = k;
      me.pivot = row[k];
      live = false;
    } else if (live && pos == k) {
      pos = p;  // the swap moves the row at position k to the pivot's
    }
    if (p != k) me.odd ^= 1;
    __syncwarp(kLieMask);
    if (live) {
      const T l = row[k] / pr[k];
      if constexpr (kSolve) row[k] = l;
#pragma unroll
      for (int q = 0; q < G / kW; ++q) {
        if (q < (k + 1) / kW) continue;
        const V x = reinterpret_cast<const V*>(pr)[q];
#pragma unroll
        for (int c = 0; c < kW; ++c) {
          const int j = q * kW + c;
          if (j > k) row[j] = row[j] - l * lu_get(x, c);
        }
      }
    }
  }
  return me;
}

// Column c of A^-1 into x[0..n) (zero past n) from lu_group_factor<T, G,
// true>'s rows U (row stride G) and perm: y_s = [perm[s] == c] - sum over
// k < s, ascending, of L_sk y_k; then x_i = (y_i - s_i) / U_ii for i from
// n - 1 down, s_i = sum over j > i, ascending from 0, of U_ij x_j. The
// same operations, in the same order, as rolled_factor on [A | I]
// followed by rolled_backsub.
template <typename T, int G>
__device__ __forceinline__ void lu_group_solve_eye(const T* U, const int* perm, int n, int c,
                                                   T (&x)[G]) {
  using V = typename LuVec<T>::type;
  constexpr int kW = LuVec<T>::width;
#pragma unroll
  for (int s = 0; s < G; ++s) {
    T y = T(0);
    if (s < n) {
      y = perm[s] == c ? T(1) : T(0);
      const V* l = reinterpret_cast<const V*>(U + s * G);
#pragma unroll
      for (int q = 0; q < G / kW; ++q) {
        if (q * kW >= s) continue;
        const V v = l[q];
#pragma unroll
        for (int cc = 0; cc < kW; ++cc) {
          const int k = q * kW + cc;
          if (k < s) y = y - lu_get(v, cc) * x[k];
        }
      }
    }
    x[s] = y;
  }
#pragma unroll
  for (int i = G - 1; i >= 0; --i) {
    if (i < n) {
      const V* u = reinterpret_cast<const V*>(U + i * G);
      T acc = T(0);
#pragma unroll
      for (int q = 0; q < G / kW; ++q) {
        if (q < (i + 1) / kW) continue;
        const V v = u[q];
#pragma unroll
        for (int cc = 0; cc < kW; ++cc) {
          const int j = q * kW + cc;
          if (j > i && j < n) acc = acc + lu_get(v, cc) * x[j];
        }
      }
      x[i] = (x[i] - acc) / U[i * G + i];
    }
  }
}

// Row gl of problem b of a full n x n operand into `row` (zero past n).
// Lane gl reads entries e = gl + G t, t < G, all loads in flight at once
// (`row` holds them), the group together in order (contiguous in a
// batch-major tensor: coalesced); they go to `stage` (row stride n | 1, so
// that lane i's reads of row i fall in distinct banks), then each lane
// gathers its row. G < 2n, so each step of G advances e's row by one or
// two. Ends synchronized.
template <typename T, int G>
__device__ __forceinline__ void lu_load_full(const MatView<T>& m, long long b, int n, int gl,
                                             T* stage, T (&row)[G]) {
  const int ld = lie_odd(n);
  const T* base = m.p + b * m.sb;
  if (m.rs == n && m.cs == 1) {
#pragma unroll
    for (int t = 0; t < G; ++t) row[t] = gl + G * t < n * n ? base[gl + G * t] : T(0);
  } else {
    int i = gl / n, j = gl % n;
#pragma unroll
    for (int t = 0; t < G; ++t) {
      row[t] = i < n ? base[i * m.rs + j * m.cs] : T(0);
      j += G - n;
      i += j >= n ? 2 : 1;
      j -= j >= n ? n : 0;
    }
  }
  int i = gl / n, j = gl % n;
#pragma unroll
  for (int t = 0; t < G; ++t) {
    if (i < n) stage[i * ld + j] = row[t];
    j += G - n;
    i += j >= n ? 2 : 1;
    j -= j >= n ? n : 0;
  }
  __syncwarp(kLieMask);
#pragma unroll
  for (int c = 0; c < G; ++c) row[c] = gl < n && c < n ? stage[gl * ld + c] : T(0);
}

// Row gl of problem b of a compact operand (n (n + 1) / 2 <= G (G + 1) / 2
// slots, the diagonal first) into `row`, its slots read as above. Ends
// synchronized.
template <typename T, int G>
__device__ __forceinline__ void lu_load_sym(const View<const T>& m, long long b, int n, int gl,
                                            T* stage, T (&row)[G]) {
  constexpr int kReads = G / 2 + 1;  // ceil(G (G + 1) / 2 / G)
  const int nn = n * (n + 1) / 2;
  const T* base = m.p + b * m.sb;
#pragma unroll
  for (int t = 0; t < kReads; ++t) row[t] = gl + G * t < nn ? base[(gl + G * t) * m.sc] : T(0);
#pragma unroll
  for (int t = 0; t < kReads; ++t)
    if (gl + G * t < nn) stage[gl + G * t] = row[t];
  __syncwarp(kLieMask);
#pragma unroll
  for (int c = 0; c < G; ++c) row[c] = gl < n && c < n ? stage[tri_index(gl, c, n)] : T(0);
}

// Shared memory of one group, in values of T: the determinant's staged
// operand, two pivot rows and the n pivots' terms; the inverse's U (row
// stride G, then X at stride G + 1), its staged compact operand and result
// (G (G + 1) / 2 values, a multiple of 16 bytes), and perm (G ints).
template <int G>
__host__ __device__ constexpr int lu_det_values() { return G * (G | 1) + 3 * G; }

template <typename T, int G>
__host__ __device__ constexpr int lu_invert_bytes() {
  return (G * (G + 1) + G * (G + 1) / 2) * (int)sizeof(T) + G * (int)sizeof(int);
}

}  // namespace fm
