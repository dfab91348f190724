// Compact-symmetric products for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of fastmath_tpu/kernels/sym_pallas.py:
//   fm_sym_matvec     <- _matvec_kernel     (sym_matvec_cf)
//   fm_sym_accmatvec  <- _accmatvec_kernel  (sym_addmatvec_cf, sym_submatvec_cf)
//   fm_sym_outer      <- _outer_kernel      (sym_outer_cf)
//   fm_sym_jhj        <- _jhj_kernel        (sym_matmul_cf)
//
// Operands are (pointer, batch stride, channel stride), as in
// sym_solve.cu, so the batch-major (B, K) and the channel-first (K, B)
// layouts run without a transpose. The ragged edge is masked; nothing is
// padded. Every launch goes on the caller's stream, allocates nothing
// and does not synchronize; each entry point returns cudaGetLastError().
//
// What bounds them: matvec, acc +/- matvec and outer do under 2 flops
// per value they move (72, 88 and 56 bytes per 4x4 f32 problem), so
// device memory bandwidth bounds them; JtHJ at K = D = 16 moves 2,112
// bytes for ~16k flops per problem, still under the card's flops-per-byte
// balance, so bytes bound it too. Each kernel reads every value once and
// writes every result once:
//   matvec / accumulate / outer, N <= 8, and JtHJ, K, D <= 6: one thread
//     per problem, unrolled in registers, reading its rows directly (L1
//     serves a batch-major block's lines). A block's rows of a batch-major
//     (B, W) output are one contiguous run, so they pass through a
//     shared-memory tile and go out with coalesced stores (a thread's own
//     row, W values from its neighbour's, would make every store a
//     partial sector; staging the loads the same way measured slower,
//     each operand then waiting at a block barrier). In matvec, slot
//     (i, j) adds A_ij v_j to row i and A_ij v_i to row j in storage
//     order, so every row sums its diagonal term first and then j != i in
//     ascending order: the reference's term order. JtHJ forms only the
//     upper slots of G = J^T (H J), as the reference's unrolled tier does.
//   matvec / accumulate / outer, 9..32: a row at a time, entries read from
//     memory (the second read of an off-diagonal slot hits L1).
//   JtHJ, 7 <= max(K, D) <= 32 (jhj_tiles): a block of P problems, a team
//     of lanes each (a power of two, at least the count of 4 x 4 blocks of
//     HJ or G, at most a warp). The block stages each problem's J and
//     compact H into the problem's region of shared memory through
//     tile_stage.cuh, reading device memory in order (16-byte vectors where
//     an operand is contiguous batch-major, batch-fastest where it is
//     channel-first, element by element otherwise); the team expands H to
//     both triangles, forms HJ and then G in 4 x 4 blocks from 16-byte
//     shared-memory loads (the padding to multiples of 4 adds exact zeros
//     after the real terms, so every sum keeps the reference's order), and
//     writes the compact result (0.5 (G_ij + G_ji) off the diagonal, as the
//     reference's rolled tier) over J at the region's start; the block
//     writes it out in order (tile_store). The kernel it replaced staged J
//     with one 4-byte copy a value, H by a triangular walk that copied each
//     off-diagonal slot twice, and stored the result one 4-byte value at a
//     time: 31% of its byte bound at K = D = 16.

#include <cuda_runtime.h>

#include "sym_common.cuh"
#include "tile_stage.cuh"

namespace fm {

constexpr int kJhjUnrollMax = 6;
constexpr int kWarp = 32;
constexpr int kDefaultSmem = 48 * 1024;  // dynamic shared memory without an opt-in

// ---------------------------------------------------------------------------
// block-staged rows (thread-per-problem kernels)
// ---------------------------------------------------------------------------

// Shared-memory row stride of a W-wide tile: odd, so a thread reading its
// own row hits distinct banks.
__host__ __device__ constexpr int tile_stride(int w) { return w | 1; }

// Each thread's W values of a (B, W) operand, read directly: L1 keeps
// the lines of a batch-major block, and channel-first reads are
// coalesced. Rows past nb read as 0.
template <typename T, int W>
__device__ __forceinline__ void load_row(View<const T> in, long long nb, T (&x)[W]) {
  const long long b = blockIdx.x * (long long)kThreads + threadIdx.x;
#pragma unroll
  for (int i = 0; i < W; ++i) x[i] = b < nb ? in.p[b * in.sb + i * in.sc] : T(0);
}

// Each thread's W results of a (B, W) output. A batch-major contiguous
// output (strides W, 1) goes through `tile` (kThreads rows), and the block
// writes its rows, one contiguous run, with coalesced stores: written row
// by row from each thread, every store would be a partial sector. Other
// layouts (channel-first: coalesced across the warp already) are written
// directly. Every thread of the block calls this (it synchronizes); rows
// past nb are not written.
template <typename T, int W>
__device__ __forceinline__ void store_row(T* tile, View<T> out, long long nb, const T (&y)[W]) {
  constexpr int P = tile_stride(W);
  const long long b0 = blockIdx.x * (long long)kThreads;
  const long long b = b0 + threadIdx.x;
  if (out.sc == 1 && out.sb == W) {
#pragma unroll
    for (int i = 0; i < W; ++i) tile[threadIdx.x * P + i] = y[i];
    __syncthreads();
    const long long rows = nb - b0 < kThreads ? nb - b0 : kThreads;
    T* dst = out.p + b0 * W;
    for (int e = threadIdx.x; e < rows * W; e += kThreads) dst[e] = tile[(e / W) * P + e % W];
  } else if (b < nb) {
#pragma unroll
    for (int i = 0; i < W; ++i) out.p[b * out.sb + i * out.sc] = y[i];
  }
}

// ---------------------------------------------------------------------------
// matvec and acc + sign * matvec (one template; Acc selects the second)
// ---------------------------------------------------------------------------

template <typename T, int N, bool Acc>
__global__ void __launch_bounds__(kThreads)
matvec_unrolled(long long nb, View<const T> acc, T sign, View<const T> mat,
                View<const T> vec, View<T> out) {
  constexpr int NN = N * (N + 1) / 2;
  __shared__ T tile[kThreads * tile_stride(N)];
  T m[NN], v[N], y[N];
  load_row<T, NN>(mat, nb, m);
  load_row<T, N>(vec, nb, v);
#pragma unroll
  for (int i = 0; i < N; ++i) y[i] = m[i] * v[i];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i + 1; j < N; ++j) {
      const T a = m[tri_index(i, j, N)];
      y[i] = y[i] + a * v[j];
      y[j] = y[j] + a * v[i];
    }
  if constexpr (Acc) {
    T c[N];
    load_row<T, N>(acc, nb, c);
#pragma unroll
    for (int i = 0; i < N; ++i) y[i] = c[i] + sign * y[i];
  }
  store_row<T, N>(tile, out, nb, y);
}

template <typename T, bool Acc>
__global__ void __launch_bounds__(kThreads)
matvec_rolled(long long nb, int n, View<const T> acc, T sign, View<const T> mat,
              View<const T> vec, View<T> out) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const T* m = mat.p + b * mat.sb;
  const T* v = vec.p + b * vec.sb;
  for (int i = 0; i < n; ++i) {
    T r = m[i * mat.sc] * v[i * vec.sc];
    for (int j = 0; j < n; ++j)
      if (j != i) r = r + m[tri_index(i, j, n) * mat.sc] * v[j * vec.sc];
    if constexpr (Acc) r = acc.p[b * acc.sb + i * acc.sc] + sign * r;
    out.p[b * out.sb + i * out.sc] = r;
  }
}

// ---------------------------------------------------------------------------
// compact outer product x x^T: the diagonal, then the upper rows
// ---------------------------------------------------------------------------

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
outer_unrolled(long long nb, View<const T> x, View<T> out) {
  constexpr int NN = N * (N + 1) / 2;
  __shared__ T tile[kThreads * tile_stride(NN)];
  T v[N], o[NN];
  load_row<T, N>(x, nb, v);
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] = v[i] * v[i];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i + 1; j < N; ++j) o[tri_index(i, j, N)] = v[i] * v[j];
  store_row<T, NN>(tile, out, nb, o);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
outer_rolled(long long nb, int n, View<const T> x, View<T> out) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const T* v = x.p + b * x.sb;
  T* o = out.p + b * out.sb;
  for (int i = 0; i < n; ++i) {
    const T vi = v[i * x.sc];
    o[i * out.sc] = vi * vi;
  }
  for (int i = 0; i < n; ++i) {
    const T vi = v[i * x.sc];
    for (int j = i + 1; j < n; ++j) o[tri_index(i, j, n) * out.sc] = vi * v[j * x.sc];
  }
}

// ---------------------------------------------------------------------------
// congruence J^T H J: J (K, D) row-major, H compact K x K -> compact D x D
// ---------------------------------------------------------------------------

template <typename T, int K, int D>
__global__ void __launch_bounds__(kThreads)
jhj_unrolled(long long nb, View<const T> jm, View<const T> hm, View<T> out) {
  constexpr int KK = K * (K + 1) / 2, DD = D * (D + 1) / 2;
  __shared__ T tile[kThreads * tile_stride(DD)];
  T J[K * D], h[KK], HJ[K][D], o[DD];
  load_row<T, K * D>(jm, nb, J);
  load_row<T, KK>(hm, nb, h);
  // (H J)[a][c] = sum_b H[a][b] J[b][c], from b = 0
#pragma unroll
  for (int a = 0; a < K; ++a)
#pragma unroll
    for (int c = 0; c < D; ++c) {
      T acc = h[tri_index(a, 0, K)] * J[c];
#pragma unroll
      for (int bb = 1; bb < K; ++bb) acc = acc + h[tri_index(a, bb, K)] * J[bb * D + c];
      HJ[a][c] = acc;
    }
  // G[i][c] = sum_a J[a][i] (H J)[a][c], for c >= i only
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int c = i; c < D; ++c) {
      T acc = J[i] * HJ[0][c];
#pragma unroll
      for (int a = 1; a < K; ++a) acc = acc + J[a * D + i] * HJ[a][c];
      o[tri_index(i, c, D)] = acc;
    }
  store_row<T, DD>(tile, out, nb, o);
}

// C[i0 + i][j0 + j] = sum_t A[t][i0 + i] * B[t][j0 + j] over t < depth,
// from t = 0 (the first product rounded, then one multiply-add a term): one
// 4 x 4 block in registers, each step one 16-byte read of row t of A and
// of B (two in float64). A, B and C are row-major in shared memory with row
// lengths lda, ldb and ldc, and depth, all multiples of 4. (8 x 8 blocks
// read half as much a multiply-add but leave 4 lanes a problem at K = D =
// 16, whose block of 16 problems stages and expands too slowly: PERF.md.)
template <typename T>
__device__ __forceinline__ void block4(const T* A, int lda, int i0, const T* B, int ldb, int j0,
                                       int depth, T* C, int ldc) {
  T acc[4][4], a[4], b[4];
  vec_get<T, 4>(A + i0, a);
  vec_get<T, 4>(B + j0, b);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = a[i] * b[j];
  for (int t = 1; t < depth; ++t) {
    vec_get<T, 4>(A + t * lda + i0, a);
    vec_get<T, 4>(B + t * ldb + j0, b);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fm_fma(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) vec_put<T, 4>(C + (i0 + i) * ldc + j0, acc[i]);
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// The rolled tier's launch shape: P problems a block, tpp lanes a problem
// (a power of two, at most a warp, so that a problem's lanes sync as part
// of one warp), each problem's region of S values and where J (row stride
// dp, at 0), HJ, H in both triangles (later G, both at row stride kp or
// dp) and the compact H sit in it; the operands and the result. kp and dp
// are K and D rounded up to multiples of 4.
template <typename T>
struct JhjPlan {
  int P, tpp, S, oHJ, oG, oHc;
  TileOperand<T> j, h;
  TileOut<T> out;
};

// A block of P problems (plan), tpp lanes each. The block stages each
// problem's J (k x d, rows padded to dp) and compact H into its region
// (tile_stage: in order, as 16-byte vectors where an operand is contiguous
// batch-major); the problem's lanes zero J's padding, expand H to both
// triangles (rows and columns k.. zero), form HJ and then G = J^T (HJ) in
// 4 x 4 blocks (block4), and write the compact result (the diagonal, then
// 0.5 (G_ij + G_ji) in slot order, the lanes taking consecutive slots) over
// J and HJ at the region's start; the block writes it in order
// (tile_store).
template <typename T>
__global__ void __launch_bounds__(256) jhj_tiles(long long nb, int k, int d, JhjPlan<T> plan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int P = plan.P, S = plan.S, tpp = plan.tpp;
  const long long b0 = blockIdx.x * (long long)P;
  const int np = nb - b0 < P ? (int)(nb - b0) : P;
  const int kp = round4(k), dp = round4(d);
  const int p = threadIdx.x / tpp, w = threadIdx.x % tpp;
  const bool busy = p < np;
  T* sJ = sm + p * S;
  T* sHJ = sJ + plan.oHJ;
  T* sH = sJ + plan.oG;
  T* sG = sH;  // H is dead once HJ is formed
  const T* sHc = sJ + plan.oHc;
  if (busy && (k < kp || d < dp))  // J's padding; the staging writes the rest
    for (int a = 0; a < kp; ++a)
      for (int c = w + (a < k ? d : 0); c < dp; c += tpp) sJ[a * dp + c] = T(0);
  tile_stage<T, false, 8, true>(plan.j, b0, np, P, S, sm);
  tile_stage<T, false, 8, true>(plan.h, b0, np, P, S, sm);
  copy_async_wait();
  __syncthreads();
  // H to both triangles, rows and columns k.. zero: lane w takes columns
  // w, w + tpp, ..., each walked down its rows with the compact slots of
  // (a, c) and (c, a) kept as running sums (tri_index)
  if (busy)
    for (int c = w; c < kp; c += tpp) {
      const int col = k + c * (k - 1) - c * (c - 1) / 2 - c - 1;  // + a: slot (c, a), a > c
      int row = k - 1;  // + c - a: slot (a, c), a < c
      for (int a = 0; a < kp; ++a) {
        T v = T(0);
        if (a < k && c < k) v = sHc[a == c ? a : (a < c ? row + c - a : col + a)];
        sH[a * kp + c] = v;
        row += k - 1 - a;
      }
    }
  __syncwarp();
  // HJ = H J in 4 x 4 blocks (H symmetric: its row t is its column t);
  // the zero padding adds exact zeros after the real terms
  const int kb = kp / 4, db = dp / 4;
  if (busy)
    for (int blk = w; blk < kb * db; blk += tpp)
      block4(sH, kp, 4 * (blk / db), sJ, dp, 4 * (blk % db), kp, sHJ, dp);
  __syncwarp();
  // G = J^T (H J)
  if (busy)
    for (int blk = w; blk < db * db; blk += tpp)
      block4(sJ, dp, 4 * (blk / db), sHJ, dp, 4 * (blk % db), kp, sG, dp);
  __syncwarp();
  if (busy) {
    T* o = sJ;
    for (int i = w; i < d; i += tpp) o[i] = sG[i * dp + i];
    // upper slot d + u is entry (i, c), c > i, row by row: lane w walks
    // u = w, w + tpp, ...
    const int nup = d * (d - 1) / 2;
    int i = 0, c = 1 + w;
    for (int u = w; u < nup; u += tpp, c += tpp) {
      while (c >= d) {
        ++i;
        c += i + 1 - d;
      }
      o[d + u] = T(0.5) * (sG[i * dp + c] + sG[c * dp + i]);
    }
  }
  __syncthreads();
  tile_store<T>(plan.out, b0, np, P, S, sm);
}

// Dynamic shared memory a block of jhj_tiles may take (it opts in above
// the default 48 KB).
constexpr int kJhjSmem = 96 * 1024;

// The rolled tier's layout and launch shape. Lanes a problem: the power of
// two at least the larger count of 4 x 4 blocks (HJ's, G's), at most a
// warp. Region: J and HJ (kp dp each), then H in both triangles, later G
// (the larger of kp^2, dp^2), at least the compact result past the start;
// the compact H in HJ's place where it fits (it is dead once H is
// expanded), after the rest otherwise. The region is whole 16-byte vectors
// and its stride spreads the problems of a warp over the banks (two
// problems half a bank row apart). Problems a block: 256 threads' worth
// (128 in float64, whose blocks are twice the bytes: measured faster at
// every shape but (16, 7)), as many as kJhjSmem holds, a multiple of the
// vector width where it can be, so that each block's range of a
// contiguous operand starts aligned.
template <typename T>
JhjPlan<T> jhj_plan(int k, int d, View<const T> jm, View<const T> hm, View<T> out) {
  constexpr int kW = 16 / (int)sizeof(T);
  auto up = [](int x, int q) { return (x + q - 1) / q * q; };
  const int kp = round4(k), dp = round4(d), kk = k * (k + 1) / 2, dd = d * (d + 1) / 2;
  const int kb = kp / 4, db = dp / 4, blocks = (kb > db ? kb : db) * db;
  int tpp = 1;
  while (tpp < kWarp && tpp < blocks) tpp *= 2;
  JhjPlan<T> plan;
  plan.tpp = tpp;
  plan.oHJ = kp * dp;
  plan.oG = up(2 * kp * dp > dd ? 2 * kp * dp : dd, kW);
  const int g = kp > dp ? kp * kp : dp * dp;
  plan.oHc = kk <= kp * dp ? plan.oHJ : plan.oG + g;
  int sv = (plan.oHc == plan.oHJ ? plan.oG + g : plan.oHc + kk + kW - 1) / kW;  // vectors
  if (tpp < kWarp) {
    const int teams = kWarp / tpp, q = 8 / (teams < 8 ? teams : 8);
    sv = up(sv, q);
    if (sv / q % 2 == 0) sv += q;
  }
  plan.S = sv * kW;
  int P = (sizeof(T) == 8 ? 128 : 256) / tpp;
  if (P * plan.S * (int)sizeof(T) > kJhjSmem) P = kJhjSmem / (plan.S * (int)sizeof(T));
  P = P >= kW ? P / kW * kW : (P < 1 ? 1 : P);
  plan.P = P;
  const bool jf = jm.sb == 1 && k * d > 1, hf = hm.sb == 1 && kk > 1;
  plan.j = {jm, k * d, dp, 0, false, jf, tile_vec<T>(jm.p, jm.sb, jm.sc, k * d, P),
            d % kW == 0 ? kLandWhole : kLandApart, fast_div(d), fast_div(jf ? P : k * d)};
  plan.h = {hm, kk, kk, plan.oHc, false, hf, tile_vec<T>(hm.p, hm.sb, hm.sc, kk, P),
            kk % kW == 0 ? kLandWhole : kLandApart, fast_div(kk), fast_div(hf ? P : kk)};
  plan.out = tile_flat_out<T>(out, dd, P, plan.S);
  return plan;
}

template <typename T>
cudaError_t launch_jhj_tiles(int k, int d, long long nb, View<const T> jm, View<const T> hm,
                             View<T> out, cudaStream_t s) {
  const JhjPlan<T> plan = jhj_plan<T>(k, d, jm, hm, out);
  const int bytes = plan.P * plan.S * (int)sizeof(T);
  if (bytes > kDefaultSmem) {
    const cudaError_t e =
        cudaFuncSetAttribute(jhj_tiles<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  const int threads = (plan.P * plan.tpp + kWarp - 1) / kWarp * kWarp;
  const unsigned g = (unsigned)((nb + plan.P - 1) / plan.P);
  jhj_tiles<T><<<g, threads, bytes, s>>>(nb, k, d, plan);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T, bool Acc>
cudaError_t launch_matvec(int n, long long nb, View<const T> acc, T sign, View<const T> mat,
                          View<const T> vec, View<T> out, cudaStream_t s) {
  const unsigned g = grid_for(nb);
  switch (n) {
#define FM_MATVEC_CASE(K) \
  case K: matvec_unrolled<T, K, Acc><<<g, kThreads, 0, s>>>(nb, acc, sign, mat, vec, out); break;
    FM_MATVEC_CASE(1) FM_MATVEC_CASE(2) FM_MATVEC_CASE(3) FM_MATVEC_CASE(4)
    FM_MATVEC_CASE(5) FM_MATVEC_CASE(6) FM_MATVEC_CASE(7) FM_MATVEC_CASE(8)
#undef FM_MATVEC_CASE
    default:
      if (n < 1 || n > kMaxN) return cudaErrorInvalidValue;
      matvec_rolled<T, Acc><<<g, kThreads, 0, s>>>(nb, n, acc, sign, mat, vec, out);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_outer(int n, long long nb, View<const T> x, View<T> out, cudaStream_t s) {
  const unsigned g = grid_for(nb);
  switch (n) {
#define FM_OUTER_CASE(K) \
  case K: outer_unrolled<T, K><<<g, kThreads, 0, s>>>(nb, x, out); break;
    FM_OUTER_CASE(1) FM_OUTER_CASE(2) FM_OUTER_CASE(3) FM_OUTER_CASE(4)
    FM_OUTER_CASE(5) FM_OUTER_CASE(6) FM_OUTER_CASE(7) FM_OUTER_CASE(8)
#undef FM_OUTER_CASE
    default:
      if (n < 1 || n > kMaxN) return cudaErrorInvalidValue;
      outer_rolled<T><<<g, kThreads, 0, s>>>(nb, n, x, out);
  }
  return cudaGetLastError();
}

template <typename T, int K>
void launch_jhj_unrolled(int d, unsigned g, long long nb, View<const T> jm, View<const T> hm,
                         View<T> out, cudaStream_t s) {
  switch (d) {
#define FM_JHJ_CASE(D) \
  case D: jhj_unrolled<T, K, D><<<g, kThreads, 0, s>>>(nb, jm, hm, out); break;
    FM_JHJ_CASE(1) FM_JHJ_CASE(2) FM_JHJ_CASE(3) FM_JHJ_CASE(4) FM_JHJ_CASE(5) FM_JHJ_CASE(6)
#undef FM_JHJ_CASE
  }
}

template <typename T>
cudaError_t launch_jhj(int k, int d, long long nb, View<const T> jm, View<const T> hm,
                       View<T> out, cudaStream_t s) {
  if (k < 1 || d < 1 || k > kMaxN || d > kMaxN) return cudaErrorInvalidValue;
  if (k <= kJhjUnrollMax && d <= kJhjUnrollMax) {
    const unsigned g = grid_for(nb);
    switch (k) {
#define FM_JHJ_K(K) \
  case K: launch_jhj_unrolled<T, K>(d, g, nb, jm, hm, out, s); break;
      FM_JHJ_K(1) FM_JHJ_K(2) FM_JHJ_K(3) FM_JHJ_K(4) FM_JHJ_K(5) FM_JHJ_K(6)
#undef FM_JHJ_K
    }
    return cudaGetLastError();
  }
  return launch_jhj_tiles<T>(k, d, nb, jm, hm, out, s);
}

// float for dtype 0, double for dtype 1
template <typename F>
int by_dtype(int dtype, F&& f) {
  if (dtype == 0) return f(float{});
  if (dtype == 1) return f(double{});
  return cudaErrorInvalidValue;
}

}  // namespace fm

// Plain C entry points (bound with ctypes). dtype: 0 = float, 1 = double.
// Each operand is (pointer, batch stride, channel stride) in elements.
extern "C" int fm_sym_matvec(int dtype, int n, long long nb,
                             const void* mat, long long msb, long long msc,
                             const void* vec, long long vsb, long long vsc,
                             void* out, long long osb, long long osc, void* stream) {
  if (nb <= 0) return cudaSuccess;
  return fm::by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    return (int)fm::launch_matvec<T, false>(
        n, nb, fm::cview<T>(nullptr, 0, 0), T(1), fm::cview<T>(mat, msb, msc),
        fm::cview<T>(vec, vsb, vsc), fm::view<T>(out, osb, osc),
        static_cast<cudaStream_t>(stream));
  });
}

// out = acc + sign * (A v); sign is +1 (sym_addmatvec) or -1 (sym_submatvec).
extern "C" int fm_sym_accmatvec(int dtype, int n, long long nb, double sign,
                                const void* acc, long long asb, long long asc,
                                const void* mat, long long msb, long long msc,
                                const void* vec, long long vsb, long long vsc,
                                void* out, long long osb, long long osc, void* stream) {
  if (nb <= 0) return cudaSuccess;
  return fm::by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    return (int)fm::launch_matvec<T, true>(
        n, nb, fm::cview<T>(acc, asb, asc), T(sign), fm::cview<T>(mat, msb, msc),
        fm::cview<T>(vec, vsb, vsc), fm::view<T>(out, osb, osc),
        static_cast<cudaStream_t>(stream));
  });
}

extern "C" int fm_sym_outer(int dtype, int n, long long nb,
                            const void* x, long long xsb, long long xsc,
                            void* out, long long osb, long long osc, void* stream) {
  if (nb <= 0) return cudaSuccess;
  return fm::by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    return (int)fm::launch_outer<T>(n, nb, fm::cview<T>(x, xsb, xsc),
                                    fm::view<T>(out, osb, osc),
                                    static_cast<cudaStream_t>(stream));
  });
}

// j: K*D values per problem (row-major K x D); h: K(K+1)/2; out: D(D+1)/2.
extern "C" int fm_sym_jhj(int dtype, int k, int d, long long nb,
                          const void* j, long long jsb, long long jsc,
                          const void* h, long long hsb, long long hsc,
                          void* out, long long osb, long long osc, void* stream) {
  if (nb <= 0) return cudaSuccess;
  return fm::by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    return (int)fm::launch_jhj<T>(k, d, nb, fm::cview<T>(j, jsb, jsc),
                                  fm::cview<T>(h, hsb, hsc), fm::view<T>(out, osb, osc),
                                  static_cast<cudaStream_t>(stream));
  });
}
