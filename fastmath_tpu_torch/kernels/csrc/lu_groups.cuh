// Lane-group LU with first-max partial pivoting for 9 <= n <= 32, shared by
// the determinant / log-determinant, inverse and solve kernels (batched.cu,
// det_groups, inv_groups, solve_groups, solve1_groups), the compact
// determinant and inverse (sym_factor.cu, sym_det_groups,
// sym_invert_groups), the compact solve (sym_solve.cu,
// sym_solve_groups), the compact chain solve's inverse (sym_solve.cu,
// chain_groups) and the matrix logarithm's inverses (logm.cu, logm_warp,
// also at G = 8 for 5 <= d <= 8); the Cholesky factor (batched.cu,
// chol_groups) takes its row layout and compact load, the matvec chain
// (sym_iterate.cu, matvec_chain_groups) and the power iteration
// (maxeig_groups) its compact load and the chain step (lu_group_chain),
// which chain_groups shares.
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
// hold after whole-row swaps (the plain versions' rolled_factor and
// rolled_solve, kernels/_launch.py): at step k the
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
// The determinants keep two pivot rows in turn and the retiring rows'
// pivots (lu_group_det). The inverses and the solve keep every retired row
// (row s of U, with the multipliers of row s's steps in its columns < s:
// in-place LU) and the lane each came from, then lane c solves for one
// column (lu_group_solve): forward substitution against the pivoted
// column of the right-hand side (the identity's column c, or column c of
// B staged in shared memory), which is what eliminating [A | B] does to
// it, then rolled_solve's back-substitution. Every U and L read is a
// broadcast, and a lane holds about n live values instead of 2n. With one
// right-hand side, each lane carries its row's entry of B through the
// factor instead (eliminated in the same step as the row, so the forward
// substitution is done when the factor is), and one lane back-substitutes.
//
// Operands are staged through shared memory so that device memory sees
// the group read and write each problem's values in order (contiguous,
// hence coalesced, in the batch-major layout; the channel-first views of
// the *_cf wrappers are read through the same strides, correct but not
// coalesced).
#pragma once

#include "lie_common.cuh"

namespace fm {

// The group's largest x: one REDUX over the warp, at G < 32 one for each
// group, every lane offering x in its own group's turn and 0 in the
// others'. The mask stays the whole warp: a REDUX whose mask differs
// between the lanes of a warp compiles to a loop over the distinct masks.
// (G = 8, four groups a warp, serves only the logm kernel's 5 <= d <= 8.)
template <int G>
__device__ __forceinline__ unsigned lu_grp_max(unsigned x, int lane) {
  if constexpr (G == kLieWarp) {
    return __reduce_max_sync(kLieMask, x);
  } else {
    static_assert(G == 8 || G == 16, "two or four groups a warp");
    unsigned r = 0u;
#pragma unroll
    for (int g = 0; g < kLieWarp / G; ++g) {
      const unsigned t = __reduce_max_sync(kLieMask, lane / G == g ? x : 0u);
      if (lane / G == g) r = t;
    }
    return r;
  }
}

// The least position pos < G over the group's lanes with `hit`: one REDUX
// over the warp; at G < 32 one OR of the bits 1 << pos, each group's in
// its own G bits, for every group.
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

// Factor the n x n matrix whose row gl is `row` (W values, W = G unless a
// narrower problem leaves lanes W.. of the group idle; zero past n; lanes
// >= n hold zeros and take part only in the collectives). Step k's pivot
// row goes to shared memory at `rows` (16-byte aligned, row stride W):
// with kSolve to row k, whole, with the multipliers of its steps, and
// perm[k] names the lane it came from; otherwise to row k % 2 from the
// vector holding column k on (two rows in turn suffice: one __syncwarp a
// step orders a row's readers before its next writer). Given `b` (the
// lane's entry of a right-hand-side column) and `y` (G values of shared
// memory), b is eliminated with the row, b -= l * y[k], and the pivot
// row's goes to y[k]: y ends as the forward substitution's result, in
// step order. Ends synchronized.
template <typename T, int G, bool kSolve, int W = G>
__device__ __forceinline__ LuLane<T> lu_group_factor(T (&row)[W], int n, int lane, T* rows,
                                                     int* perm, T* b = nullptr,
                                                     T* y = nullptr) {
  const int gl = lane % G;
  using V = typename LuVec<T>::type;
  constexpr int kW = LuVec<T>::width;
  int pos = gl;
  bool live = gl < n;
  LuLane<T> me{0, -1, T(0)};
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (k >= n) break;
    const int p = lu_pivot<G>(row[k], live, pos == k, pos, lane);
    T* pr = rows + (kSolve ? k : (k & 1)) * W;
    if (live && pos == p) {
#pragma unroll
      for (int q = 0; q < W / kW; ++q)
        if (kSolve || q >= k / kW) reinterpret_cast<V*>(pr)[q] = lu_pack<W>(row, q);
      if constexpr (kSolve) perm[k] = gl;
      if (y != nullptr) y[k] = *b;
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
      if (y != nullptr) *b = *b - l * y[k];
#pragma unroll
      for (int q = 0; q < W / kW; ++q) {
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

// Back-substitution with lu_group_factor<T, G, true, W>'s rows U (row
// stride W), in place on x[0..n) (zero past n), which holds y: x_i = (y_i
// - s_i) / U_ii for i from n - 1 down, s_i = sum over j > i, ascending
// from 0, of U_ij x_j: rolled_solve's back-substitution in its order.
template <typename T, int W>
__device__ __forceinline__ void lu_group_backsub(const T* U, int n, T (&x)[W]) {
  using V = typename LuVec<T>::type;
  constexpr int kW = LuVec<T>::width;
#pragma unroll
  for (int i = W - 1; i >= 0; --i) {
    if (i < n) {
      const V* u = reinterpret_cast<const V*>(U + i * W);
      T acc = T(0);
#pragma unroll
      for (int q = 0; q < W / kW; ++q) {
        if (q < (i + 1) / kW) continue;
        const V v = u[q];
#pragma unroll
        for (int cc = 0; cc < kW; ++cc) {
          const int j = q * kW + cc;
          if (j > i && j < n) acc = acc + lu_get(v, cc) * x[j];
        }
      }
      x[i] = (x[i] - acc) / U[i * W + i];
    }
  }
}

// One column of the solution into x[0..n) (zero past n) from
// lu_group_factor<T, G, true, W>'s rows U (row stride W) and perm, where
// rhs(r) is the column's right-hand side in row r (the identity's column
// c: r == c): y_s = rhs(perm[s]) - sum over k < s, ascending, of L_sk
// y_k, then lu_group_backsub. The same operations, in the same order, as
// rolled_solve on [A | B].
template <typename T, int W, typename Rhs>
__device__ __forceinline__ void lu_group_solve(const T* U, const int* perm, int n, Rhs rhs,
                                               T (&x)[W]) {
  using V = typename LuVec<T>::type;
  constexpr int kW = LuVec<T>::width;
#pragma unroll
  for (int s = 0; s < W; ++s) {
    T y = T(0);
    if (s < n) {
      y = rhs(perm[s]);
      const V* l = reinterpret_cast<const V*>(U + s * W);
#pragma unroll
      for (int q = 0; q < W / kW; ++q) {
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
  lu_group_backsub<T, W>(U, n, x);
}

// The determinant (kLog: log|det|) of the matrix whose row gl is `row`:
// lu_group_factor<T, G, false> with two pivot rows at `rows`, then each
// pivot's term, U_ss or log|U_ss|, written by the lane of row s to
// terms[s] (G values) and folded in step order by the group's first lane,
// which applies the parity's sign; the result is that lane's. Ends
// synchronized.
template <typename T, int G, bool kLog>
__device__ __forceinline__ T lu_group_det(T (&row)[G], int n, int lane, T* rows, T* terms) {
  const LuLane<T> me = lu_group_factor<T, G, false>(row, n, lane, rows, nullptr);
  if (me.step >= 0) terms[me.step] = kLog ? fm_log(fm_abs(me.pivot)) : me.pivot;
  __syncwarp(kLieMask);
  T r = T(0);
  if (lane % G == 0) {
    r = terms[0];
    for (int i = 1; i < n; ++i) r = kLog ? r + terms[i] : r * terms[i];
  }
  return !kLog && me.odd ? -r : r;
}

// The chain step of the matvec chain and the power iteration
// (sym_iterate.cu, matvec_chain_groups, maxeig_groups) and the compact
// chain solve (sym_solve.cu, chain_groups): x <- M x + c,
// `iters` times. Lane i holds row i of M in `row` (a zero row for lanes
// >= n) and c = c_i; x lives in shared memory at xs, double buffered (G
// values each, 16-byte aligned), and starts in the first buffer. Step t
// reads buffer t % 2 and writes into the other, so one __syncwarp a step
// orders both. Every lane of the group reads the same x: broadcast
// vectors, G / width loads for G multiply-adds (the vectors wholly past n
// are skipped; the rest add exact zeros, since lanes >= n write 0). Row i
// sums m_i0 x_0, then j ascending, then adds c_i: the plain versions'
// order (a chain without c adds 0, which changes no value but the sign of
// a zero sum). Returns the lane's final x_i. Every lane of the warp takes
// part.
template <typename T, int G>
__device__ __forceinline__ T lu_group_chain(const T (&row)[G], T c, int n, int iters, int gl,
                                            T* xs) {
  using V = typename LuVec<T>::type;
  constexpr int kW = LuVec<T>::width;
  T xi = xs[gl];
  for (int t = 0; t < iters; ++t) {
    const V* x = reinterpret_cast<const V*>(xs + (t & 1) * G);
    T acc = T(0);
#pragma unroll
    for (int q = 0; q < G / kW; ++q) {
      if (q * kW >= n) break;
      const V v = x[q];
#pragma unroll
      for (int e = 0; e < kW; ++e) {
        const int j = q * kW + e;
        acc = j == 0 ? row[0] * lu_get(v, 0) : acc + row[j] * lu_get(v, e);
      }
    }
    xi = gl < n ? acc + c : T(0);
    xs[((t + 1) & 1) * G + gl] = xi;
    __syncwarp(kLieMask);
  }
  return xi;
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

// Where entry e = gl + G t of an n x kc block (row stride kc) lies: row
// i, column c. A step of t advances G / kc rows and G % kc columns, so
// the walk divides only at its start.
struct LuWalk {
  int i, c, di, dc, kc;
  __device__ __forceinline__ LuWalk(int gl, int g, int kc_)
      : i(gl / kc_), c(gl % kc_), di(g / kc_), dc(g % kc_), kc(kc_) {}
  __device__ __forceinline__ void next() {
    i += di;
    c += dc;
    if (c >= kc) {
      c -= kc;
      ++i;
    }
  }
};

// Columns [c0, c0 + kc) of problem b's n x k operand (row-major: entry
// (i, c) in channel i k + c) into `blk`, an n x kc block at row stride
// kc. Lane gl reads entries e = gl + G t, all loads in flight at once
// (`tmp` holds them), the group together in order (contiguous in a
// batch-major tensor when kc == k). Ends synchronized.
template <typename T, int G>
__device__ __forceinline__ void lu_block_load(const View<const T>& v, long long b, int n, int k,
                                              int c0, int kc, int gl, T* blk, T (&tmp)[G]) {
  const T* base = v.p + b * v.sb;
  LuWalk w(gl, G, kc);
#pragma unroll
  for (int t = 0; t < G; ++t) {
    if (G * t >= n * kc) break;
    tmp[t] = gl + G * t < n * kc ? base[(w.i * k + c0 + w.c) * v.sc] : T(0);
    w.next();
  }
#pragma unroll
  for (int t = 0; t < G; ++t) {
    if (G * t >= n * kc) break;
    if (gl + G * t < n * kc) blk[gl + G * t] = tmp[t];
  }
  __syncwarp(kLieMask);
}

// The block back to columns [c0, c0 + kc) of problem b of `v`, in the
// same order.
template <typename T, int G>
__device__ __forceinline__ void lu_block_store(const View<T>& v, long long b, int n, int k,
                                               int c0, int kc, int gl, const T* blk) {
  T* base = v.p + b * v.sb;
  LuWalk w(gl, G, kc);
#pragma unroll
  for (int t = 0; t < G; ++t) {
    if (G * t >= n * kc) break;
    if (gl + G * t < n * kc) base[(w.i * k + c0 + w.c) * v.sc] = blk[gl + G * t];
    w.next();
  }
}

// Shared memory of one group, in bytes: the determinants' staged operand
// (G (G | 1) values, full, or compact in its first G (G + 1) / 2), two
// pivot rows and the n pivots' terms (3 G values); the full inverse's U
// (row stride G) over its staged operand (n (n | 1) <= G (G | 1) values:
// the load is over before step 0 stores its pivot row), then perm (G
// ints); the solve's the same with a block of G right-hand-side columns
// (G G values) between them, or at one column that column's y and x (2 G
// values), which the compact solve takes too (its refined form: the
// compact inverse's U, X and staged operand, then y, x and r, 3 G values,
// then perm); the compact inverse's U (row stride G, then
// X at stride G + 1), its staged compact operand and result (G (G + 1) / 2
// values, a multiple of 16 bytes), and perm; the Cholesky factor's two
// columns of L (2 G values) and its staged compact operand and result.
// Every size is a multiple of 16 bytes, so each group's pivot rows and
// columns stay aligned for the vector accesses.
template <typename T, int G>
__host__ __device__ constexpr int lu_det_bytes() {
  return (G * (G | 1) + 3 * G) * (int)sizeof(T);
}

template <typename T, int G>
__host__ __device__ constexpr int lu_inv_bytes() {
  return G * (G | 1) * (int)sizeof(T) + G * (int)sizeof(int);
}

template <typename T, int G>
__host__ __device__ constexpr int lu_solve_bytes() {
  return (G * (G | 1) + G * G) * (int)sizeof(T) + G * (int)sizeof(int);
}

template <typename T, int G>
__host__ __device__ constexpr int lu_solve1_bytes() {
  return (G * (G | 1) + 2 * G) * (int)sizeof(T) + G * (int)sizeof(int);
}

template <typename T, int G>
__host__ __device__ constexpr int lu_sym_refine_bytes() {
  return (G * (G + 1) + G * (G + 1) / 2 + 3 * G) * (int)sizeof(T) + G * (int)sizeof(int);
}

template <typename T, int G>
__host__ __device__ constexpr int lu_chol_bytes() {
  return (2 * G + G * (G + 1) / 2) * (int)sizeof(T);
}

template <typename T, int G>
__host__ __device__ constexpr int lu_chain_bytes() {
  return (G * (G + 1) / 2 + 2 * G) * (int)sizeof(T);
}

template <typename T, int G>
__host__ __device__ constexpr int lu_chain_solve_bytes() {
  return (G * (G + 1) + 2 * G) * (int)sizeof(T) + G * (int)sizeof(int);
}

template <typename T, int G>
__host__ __device__ constexpr int lu_invert_bytes() {
  return (G * (G + 1) + G * (G + 1) / 2) * (int)sizeof(T) + G * (int)sizeof(int);
}

// Launch `kern` over nb problems, a group of G lanes each at `per_group`
// bytes of shared memory: blocks of lie_warps warps, 32 / G problems a
// warp.
template <int G, typename Kernel, typename... Args>
void lu_launch(Kernel kern, int per_group, long long nb, cudaStream_t s, Args... args) {
  const int warps = lie_warps((kLieWarp / G) * per_group);
  const int per_block = warps * (kLieWarp / G);
  const unsigned g = (unsigned)((nb + per_block - 1) / per_block);
  kern<<<g, warps * kLieWarp, per_block * per_group, s>>>(nb, args...);
}

}  // namespace fm
