// Compact-symmetric solve and fused chain solve for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of fastmath_tpu/kernels/sym_pallas.py:
//   fm_sym_solve        <- _solve_kernel        (sym_solve_cf)
//   fm_sym_solve_chain  <- _solve_chain_kernel  (sym_solve_chain_cf)
//
// One thread owns one problem (a group of lanes in the solve's 9..32
// tier). Each operand is addressed through a batch stride and a channel
// stride, so one kernel reads both the batch-major (B, NN) layout of the
// public ops (strides NN, 1) and the channel-first (NN, B) layout of the
// *_cf wrappers (strides 1, B) without a transpose. The ragged edge of the
// last block is masked; nothing is padded.
//
// Tiers, as in the reference:
//   N == 1     divide (the chain multiplies by 1/a);
//   N <= 4     adjugate x 1/det (generated cofactors, sym_adjugate.cuh),
//              plus `refine` residual steps through the same cofactors;
//   5 <= N <= 8  LU with first-max partial pivoting, unrolled in
//              registers; refinement re-solves the residual through the
//              same factors (the numbers of a from-scratch re-solve). The
//              chain (chain_inverse) stages the compact operand through
//              shared memory (tile_stage.cuh), forms the explicit inverse
//              from that LU once, and runs x <- X x + c with X's rows in
//              registers;
//   9 <= N <= 32 the solve: the lane-group LU (lu_groups.cuh,
//              sym_solve_groups): G = 16 lanes a problem to N = 16, 32
//              above, row i of A + diag(eps) in lane i's registers,
//              the plain rolled_solve's pivots on [A | v]
//              (kernels/_launch.py) without moving a row, each lane
//              carrying its row's entry of v through the factor, then one
//              lane's back-substitution; a refined solve also forms the
//              explicit inverse (lane c solves for column c) and applies
//              it to the residual, which lane i sums for row i. The chain
//              (chain_groups) forms the same explicit inverse, moves row i
//              to lane i and runs lu_group_chain: x in shared memory, each
//              step's x read as broadcast vectors.
//
// What bounds them on the card: the single solve at N <= 4 moves
// (NN + 2N) values per problem for ~250 flops, so it is bound by device
// memory bandwidth; the design reads each operand once and keeps the
// cofactors and refinement in registers. The chain reads A once and
// runs `iters` solves on it, so it is bound by fp32/fp64 arithmetic; the
// loop-invariant part (cofactors and 1/det at N <= 4, the explicit inverse
// above) is computed once before the loop. At 5 <= N <= 8 the chain was a
// pivot replay and two dependent substitutions a step, one thread a
// problem, at 4.5% of its bound at N = 8 (float32, H100); a step of the
// explicit inverse is N independent dot products.
// The 9..32 tiers were one thread a problem over a local array of up to
// 32 x 65 values, every step read and written through L1 and L2, at 1.4-2%
// of their bounds; the lane groups keep a row a lane in registers and read
// U and x as broadcast vectors from shared memory, so instruction issue
// bounds them (each LU step's reductions, division and broadcast reads;
// each chain step's vector loads, multiply-adds and barrier).
//
// Every launch goes on the caller's stream, allocates nothing and does
// not synchronize; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "lu_groups.cuh"
#include "sym_adjugate.cuh"
#include "sym_common.cuh"
#include "tile_stage.cuh"

namespace fm {

// ---------------------------------------------------------------------------
// single solve
// ---------------------------------------------------------------------------

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
solve_unrolled(long long nb, View<const T> mat, View<const T> vec, View<T> out,
               const T* __restrict__ eps, int refine) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const T* m = mat.p + b * mat.sb;
  T v[N], x[N];
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = vec.p[b * vec.sb + j * vec.sc];

  if constexpr (N == 1) {
    T a = m[0];
    if (eps != nullptr) a = a + eps[0];
    x[0] = v[0] / a;
  } else if constexpr (N <= 4) {
    T E[N][N], adj[N][N], y[N], r[N];
    load_sym<T, N>(m, mat.sc, eps, E);
    const T inv_det = T(1) / sym_cofactors(E, adj);
    adj_apply<T, N>(adj, v, y);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = y[i] * inv_det;
    for (int it = 0; it < refine; ++it) {
      residual<T, N>(E, v, x, r);
      adj_apply<T, N>(adj, r, y);
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = x[i] + y[i] * inv_det;
    }
  } else {
    T E[N][N], LU[N][N], inv_d[N], r[N], dx[N];
    int piv[N];
    load_sym<T, N>(m, mat.sc, eps, E);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) LU[i][j] = E[i][j];
    plu_factor<T, N>(LU, piv);
#pragma unroll
    for (int i = 0; i < N; ++i) inv_d[i] = T(1) / LU[i][i];
    plu_substitute<T, N>(LU, piv, inv_d, v, x);
    for (int it = 0; it < refine; ++it) {
      residual<T, N>(E, v, x, r);
      plu_substitute<T, N>(LU, piv, inv_d, r, dx);
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = x[i] + dx[i];
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) out.p[b * out.sb + i * out.sc] = x[i];
}

// A group of G lanes a problem (lu_groups.cuh): row i of A + diag(eps) in
// lane i (lu_load_sym, then eps on the diagonal, as the plain version's
// _dense), the lane-group LU with every pivot row kept in U, each lane
// carrying its row's entry of v through the factor, then the group's first
// lane back-substitutes (solve1_groups' scheme on compact input); the
// group writes x in order. The staged operand is over before step 0 stores
// its pivot row, so U takes its place (lu_solve1_bytes).
//
// kRefine (refine > 0): the staged operand stays, U goes beside it, and
// each lane also solves for column gl of the inverse X, which then takes
// U's place (row stride G + 1). Each of the `refine` steps x += X (v - A x)
// has lane i form r_i = v_i - E_ii x_i - sum over j != i, ascending, of
// E_ij x_j from the staged A, then add row i of X times r, j ascending,
// with x and r broadcast through shared memory: the operations of the
// plain version's residual and update, in its order.
template <typename T, int G, bool kRefine>
__global__ void sym_solve_groups(long long nb, int n, View<const T> mat, View<const T> vec,
                                 View<T> out, const T* __restrict__ eps, int refine) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kX = G + 1;
  const int lane = threadIdx.x % kLieWarp, gl = lane % G;
  const long long b = blockIdx.x * (long long)(blockDim.x / G) + threadIdx.x / G;
  const long long bb = b < nb ? b : nb - 1;
  const int per_group = kRefine ? lu_sym_refine_bytes<T, G>() : lu_solve1_bytes<T, G>();
  T* u = reinterpret_cast<T*>(smem_raw + (threadIdx.x / G) * per_group);
  T* stage = kRefine ? u + G * kX : u;
  T* y = kRefine ? stage + G * kX / 2 : u + G * (G | 1);  // y, then x, then r
  int* perm = reinterpret_cast<int*>(y + (kRefine ? 3 : 2) * G);
  T row[G];
  const T vi = gl < n ? vec.p[bb * vec.sb + gl * vec.sc] : T(0);
  T bv = vi;
  lu_load_sym<T, G>(mat, bb, n, gl, stage, row);
  T dii = T(0);  // E_ii of lane i's row
  const T e = eps != nullptr && gl < n ? eps[gl] : T(0);
#pragma unroll
  for (int c = 0; c < G; ++c) {
    if (c == gl) {
      if (eps != nullptr) row[c] = row[c] + e;
      dii = row[c];
    }
  }
  if constexpr (!kRefine) __syncwarp(kLieMask);  // every row is gathered: U may take its place
  lu_group_factor<T, G, true>(row, n, lane, u, perm, &bv, y);
  __syncwarp(kLieMask);  // y is whole
  if (gl == 0) {
    T x[G];
#pragma unroll
    for (int s = 0; s < G; ++s) x[s] = s < n ? y[s] : T(0);
    lu_group_backsub<T, G>(u, n, x);
#pragma unroll
    for (int i = 0; i < G; ++i)
      if (i < n) y[G + i] = x[i];
  }
  if constexpr (kRefine) {
    T xc[G];
    lu_group_solve<T, G>(u, perm, n, [gl](int r) { return r == gl ? T(1) : T(0); }, xc);
    __syncwarp(kLieMask);  // U is read, and x is whole; X takes U's place
#pragma unroll
    for (int i = 0; i < G; ++i)
      if (i < n) u[i * kX + gl] = xc[i];
    T* xs = y + G;
    T* rs = y + 2 * G;
    T xi = xs[gl];
    for (int it = 0; it < refine; ++it) {
      __syncwarp(kLieMask);  // X and x are whole
      if (gl < n) {
        T acc = vi - dii * xs[gl];
        for (int j = 0; j < n; ++j)
          if (j != gl) acc = acc - stage[tri_index(gl, j, n)] * xs[j];
        rs[gl] = acc;
      }
      __syncwarp(kLieMask);  // r is whole
      if (gl < n) {
        const T* xr = u + gl * kX;
        T acc = xr[0] * rs[0];
        for (int j = 1; j < n; ++j) acc = acc + xr[j] * rs[j];
        xi = xi + acc;
      }
      __syncwarp(kLieMask);  // x and r are read
      if (gl < n) xs[gl] = xi;
    }
    if (b < nb && gl < n) out.p[b * out.sb + gl * out.sc] = xi;
  } else {
    __syncwarp(kLieMask);
    if (b < nb && gl < n) out.p[b * out.sb + gl * out.sc] = y[G + gl];
  }
}

// ---------------------------------------------------------------------------
// fused chain: x <- A \ x + c, iters times, factoring once
// ---------------------------------------------------------------------------

// N <= 4: one thread a problem, the cofactors once, then each step adj x
// times 1/det plus c (N == 1: x times 1/a plus c).
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
chain_unrolled(long long nb, View<const T> mat, View<const T> vec, View<const T> add,
               View<T> out, const T* __restrict__ eps, int iters) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const T* m = mat.p + b * mat.sb;
  T x[N], c[N], y[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    x[j] = vec.p[b * vec.sb + j * vec.sc];
    c[j] = add.p != nullptr ? add.p[b * add.sb + j * add.sc] : T(0);
  }

  if constexpr (N == 1) {
    T a = m[0];
    if (eps != nullptr) a = a + eps[0];
    const T inv = T(1) / a;
    for (int t = 0; t < iters; ++t) x[0] = x[0] * inv + c[0];
  } else {
    T E[N][N], adj[N][N];
    load_sym<T, N>(m, mat.sc, eps, E);
    const T inv_det = T(1) / sym_cofactors(E, adj);
    for (int t = 0; t < iters; ++t) {
      adj_apply<T, N>(adj, x, y);
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = y[i] * inv_det + c[i];
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) out.p[b * out.sb + i * out.sc] = x[i];
}

// 5 <= N <= 8: one thread a problem, P problems a block, the compact
// operand staged into the block's regions (tile_stage.cuh). The thread
// factors A + diag(eps) with the unrolled pivoted LU and forms the
// explicit inverse X from it, each identity column substituted in turn
// and written to the region's column at once (so that only LU and one
// column live in registers), as the batched inverse's n <= 8 tier does;
// then it holds X's rows in registers and runs x <- X x + c `iters`
// times, each entry of X x a row summed from its first term: N
// independent dot products a step, with no pivot replay and no chain of
// dependent substitutions across the rows.
template <typename T, int N, int P>
__global__ void __launch_bounds__(P)
chain_inverse(long long nb, TileOperand<T> mat, View<const T> vec, View<const T> add,
              View<T> out, const T* __restrict__ eps, int iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NN = N * (N + 1) / 2, S = staged_stride<T>(N * N);
  T* sm = reinterpret_cast<T*>(smem_raw);
  const long long b0 = blockIdx.x * (long long)P;
  const int np = nb - b0 < P ? (int)(nb - b0) : P;
  tile_stage<T, false, staged_loads<T>(NN)>(mat, b0, np, P, S, sm);
  __syncthreads();
  if ((int)threadIdx.x >= np) return;  // no barrier follows
  const long long b = b0 + threadIdx.x;
  T* m = sm + threadIdx.x * S;
  {
    T LU[N][N], inv_d[N];
    int piv[N];
    load_sym<T, N>(m, 1, eps, LU);
    plu_factor<T, N>(LU, piv);
#pragma unroll
    for (int i = 0; i < N; ++i) inv_d[i] = T(1) / LU[i][i];
    for (int c = 0; c < N; ++c) {
      T e[N], xc[N];
#pragma unroll
      for (int i = 0; i < N; ++i) e[i] = i == c ? T(1) : T(0);
      plu_substitute<T, N>(LU, piv, inv_d, e, xc);
#pragma unroll
      for (int i = 0; i < N; ++i) m[i * N + c] = xc[i];
    }
  }
  T X[N][N], x[N], c[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) X[i][j] = m[i * N + j];
    x[i] = vec.p[b * vec.sb + i * vec.sc];
    c[i] = add.p != nullptr ? add.p[b * add.sb + i * add.sc] : T(0);
  }
  for (int t = 0; t < iters; ++t) {
    T y[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T acc = X[i][0] * x[0];
#pragma unroll
      for (int j = 1; j < N; ++j) acc = acc + X[i][j] * x[j];
      y[i] = acc + c[i];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = y[i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) out.p[b * out.sb + i * out.sc] = x[i];
}

// A group of G lanes a problem (G = 16 to N = 16, 32 above): the explicit
// inverse X of A + diag(eps) as sym_solve_groups<T, G, true> forms it
// (lu_load_sym with eps on the diagonal, lu_group_factor with every pivot
// row kept in U, lane c solving for column c against the identity with
// lu_group_solve), which is the plain version's rolled_solve(A, I); X goes
// through shared memory (row stride G + 1) so that lane i holds row i,
// then lu_group_chain runs x <- X x + c `iters` times from x = vec. The
// staged operand is over before step 0 stores its pivot row, so U takes
// its place, and X U's. A group past the batch runs a copy of the last
// problem and stores nothing.
template <typename T, int G>
__global__ void chain_groups(long long nb, int n, View<const T> mat, View<const T> vec,
                             View<const T> add, View<T> out, const T* __restrict__ eps,
                             int iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kX = G + 1;
  const int lane = threadIdx.x % kLieWarp, gl = lane % G;
  const long long b = blockIdx.x * (long long)(blockDim.x / G) + threadIdx.x / G;
  const long long bb = b < nb ? b : nb - 1;
  T* u = reinterpret_cast<T*>(smem_raw + (threadIdx.x / G) * lu_chain_solve_bytes<T, G>());
  T* xs = u + G * kX;
  int* perm = reinterpret_cast<int*>(xs + 2 * G);
  T row[G];
  lu_load_sym<T, G>(mat, bb, n, gl, u, row);
  if (eps != nullptr && gl < n) {
    const T e = eps[gl];
#pragma unroll
    for (int c = 0; c < G; ++c)
      if (c == gl) row[c] = row[c] + e;
  }
  __syncwarp(kLieMask);  // every row is gathered: U may take its place
  lu_group_factor<T, G, true>(row, n, lane, u, perm);
  T xc[G];
  lu_group_solve<T, G>(u, perm, n, [gl](int r) { return r == gl ? T(1) : T(0); }, xc);
  __syncwarp(kLieMask);  // U is read: X takes its place
#pragma unroll
  for (int i = 0; i < G; ++i)
    if (i < n) u[i * kX + gl] = xc[i];
  xs[gl] = gl < n ? vec.p[bb * vec.sb + gl * vec.sc] : T(0);
  const T c = add.p != nullptr && gl < n ? add.p[bb * add.sb + gl * add.sc] : T(0);
  __syncwarp(kLieMask);
#pragma unroll
  for (int j = 0; j < G; ++j) row[j] = gl < n && j < n ? u[gl * kX + j] : T(0);
  const T xi = lu_group_chain<T, G>(row, c, n, iters, gl, xs);
  if (b < nb && gl < n) out.p[b * out.sb + gl * out.sc] = xi;
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t launch_solve(int n, long long nb, View<const T> mat, View<const T> vec,
                         View<T> out, const T* eps, int refine, cudaStream_t s) {
  const unsigned g = grid_for(nb);
  switch (n) {
#define FM_SOLVE_CASE(K) \
  case K: solve_unrolled<T, K><<<g, kThreads, 0, s>>>(nb, mat, vec, out, eps, refine); break;
    FM_SOLVE_CASE(1) FM_SOLVE_CASE(2) FM_SOLVE_CASE(3) FM_SOLVE_CASE(4)
    FM_SOLVE_CASE(5) FM_SOLVE_CASE(6) FM_SOLVE_CASE(7) FM_SOLVE_CASE(8)
#undef FM_SOLVE_CASE
    default:
      if (n < 1 || n > kMaxN) return cudaErrorInvalidValue;
      if (refine > 0 && lie_group(n) == 16)
        lu_launch<16>(sym_solve_groups<T, 16, true>, lu_sym_refine_bytes<T, 16>(), nb, s, n,
                      mat, vec, out, eps, refine);
      else if (refine > 0)
        lu_launch<kLieWarp>(sym_solve_groups<T, kLieWarp, true>,
                            lu_sym_refine_bytes<T, kLieWarp>(), nb, s, n, mat, vec, out, eps,
                            refine);
      else if (lie_group(n) == 16)
        lu_launch<16>(sym_solve_groups<T, 16, false>, lu_solve1_bytes<T, 16>(), nb, s, n, mat,
                      vec, out, eps, refine);
      else
        lu_launch<kLieWarp>(sym_solve_groups<T, kLieWarp, false>, lu_solve1_bytes<T, kLieWarp>(),
                            nb, s, n, mat, vec, out, eps, refine);
  }
  return cudaGetLastError();
}

template <typename T, int N>
void launch_chain_inverse(long long nb, View<const T> mat, View<const T> vec, View<const T> add,
                          View<T> out, const T* eps, int iters, cudaStream_t s) {
  constexpr int S = staged_stride<T>(N * N), P = staged_threads<T>(N * N);
  chain_inverse<T, N, P><<<(unsigned)((nb + P - 1) / P), P, P * S * sizeof(T), s>>>(
      nb, tile_flat_operand<T>(mat, N * (N + 1) / 2, P, S), vec, add, out, eps, iters);
}

template <typename T>
cudaError_t launch_chain(int n, long long nb, View<const T> mat, View<const T> vec,
                         View<const T> add, View<T> out, const T* eps, int iters,
                         cudaStream_t s) {
  const unsigned g = grid_for(nb);
  switch (n) {
#define FM_CHAIN_CASE(K) \
  case K: chain_unrolled<T, K><<<g, kThreads, 0, s>>>(nb, mat, vec, add, out, eps, iters); break;
    FM_CHAIN_CASE(1) FM_CHAIN_CASE(2) FM_CHAIN_CASE(3) FM_CHAIN_CASE(4)
#undef FM_CHAIN_CASE
#define FM_CHAIN_CASE(K) \
  case K: launch_chain_inverse<T, K>(nb, mat, vec, add, out, eps, iters, s); break;
    FM_CHAIN_CASE(5) FM_CHAIN_CASE(6) FM_CHAIN_CASE(7) FM_CHAIN_CASE(8)
#undef FM_CHAIN_CASE
    default:
      if (n < 1 || n > kMaxN) return cudaErrorInvalidValue;
      if (lie_group(n) == 16)
        lu_launch<16>(chain_groups<T, 16>, lu_chain_solve_bytes<T, 16>(), nb, s, n, mat, vec,
                      add, out, eps, iters);
      else
        lu_launch<kLieWarp>(chain_groups<T, kLieWarp>, lu_chain_solve_bytes<T, kLieWarp>(), nb,
                            s, n, mat, vec, add, out, eps, iters);
  }
  return cudaGetLastError();
}

}  // namespace fm

// Plain C entry points (bound with ctypes). dtype: 0 = float, 1 = double.
// Each operand is (pointer, batch stride, channel stride) in elements;
// eps is n values of the dtype or null; add may be null (c = 0).
extern "C" int fm_sym_solve(int dtype, int n, long long nb,
                            const void* mat, long long msb, long long msc,
                            const void* vec, long long vsb, long long vsc,
                            void* out, long long osb, long long osc,
                            const void* eps, int refine, void* stream) {
  if (nb <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fm::launch_solve<float>(n, nb, fm::cview<float>(mat, msb, msc),
                                   fm::cview<float>(vec, vsb, vsc),
                                   fm::view<float>(out, osb, osc),
                                   static_cast<const float*>(eps), refine, s);
  if (dtype == 1)
    return fm::launch_solve<double>(n, nb, fm::cview<double>(mat, msb, msc),
                                    fm::cview<double>(vec, vsb, vsc),
                                    fm::view<double>(out, osb, osc),
                                    static_cast<const double*>(eps), refine, s);
  return cudaErrorInvalidValue;
}

extern "C" int fm_sym_solve_chain(int dtype, int n, long long nb,
                                  const void* mat, long long msb, long long msc,
                                  const void* vec, long long vsb, long long vsc,
                                  const void* add, long long asb, long long asc,
                                  void* out, long long osb, long long osc,
                                  const void* eps, int iters, void* stream) {
  if (nb <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fm::launch_chain<float>(n, nb, fm::cview<float>(mat, msb, msc),
                                   fm::cview<float>(vec, vsb, vsc),
                                   fm::cview<float>(add, asb, asc),
                                   fm::view<float>(out, osb, osc),
                                   static_cast<const float*>(eps), iters, s);
  if (dtype == 1)
    return fm::launch_chain<double>(n, nb, fm::cview<double>(mat, msb, msc),
                                    fm::cview<double>(vec, vsb, vsc),
                                    fm::cview<double>(add, asb, asc),
                                    fm::view<double>(out, osb, osc),
                                    static_cast<const double*>(eps), iters, s);
  return cudaErrorInvalidValue;
}
