// Full-storage batched matrix-vector and matrix-matrix products for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of fastmath_tpu/kernels/batched_pallas.py:
//   fm_matvec_full  <- _matvec_full_kernel  (matvec_full_cf)
//   fm_matmul       <- _matmul_kernel       (matmul_cf)
//
// A matrix is row-major in its channels (entry (i, j) of an R x C matrix
// is channel i * C + j). Each operand is addressed through a batch stride
// and a channel stride (MatView, sym_common.cuh), so the batch-major
// (B, K) layout of the public ops and the channel-first (K, B) layout of
// the *_cf wrappers run without a transpose, and each matrix operand can
// be read transposed through swapped strides: the gradients (dv = A^T g
// for the matvec, dA = G B^T and dB = A^T G for the product) launch the
// same kernels on the same storage, with no transposed copy.
//
// Term order is the reference's: entry (i, j) is summed over the inner
// index from the first term, left to right. Multiply-adds contract into
// FMAs, so each entry moves a few ulp from the plain PyTorch version.
//
// What bounds them: the matvec moves n^2 + 2n values for 2n^2 flops and
// the product mk + kn + mn values for 2mkn flops, at most 16 and 8 flops
// a value at 32 x 32, so device memory bounds both at every size the
// kernels take. Each reads every operand value from device memory once:
//   fm_matvec_full: one thread per problem. n <= 8 unrolls at compile
//     time with v in registers, reading each entry of A once and
//     writing row i when it is summed; 9 <= n <= 32 keeps v in a
//     per-thread local array and loops over the rows.
//   fm_matmul: a block of P problems stages each problem's A and B in
//     shared memory (matmul_tiles, on tile_stage.cuh's tile_stage and
//     tile_store, which batched.cu's n <= 8 inverse and Cholesky share),
//     reading device memory in order: in
//     16-byte vectors where an operand is contiguous batch-major (P a
//     whole number of vectors' worth of problems), batch-fastest where it
//     is channel-first; each thread issues eight loads before it stores
//     any, so that the bytes in flight cover the latency. Each thread then
//     accumulates a 4 x 4 tile of C in registers from vector reads of A's
//     rows and B's rows (A's row stride an odd number of vectors, so the
//     rows one access reads start in different banks); C takes the
//     operands' place and the block writes it in order. The kernel this
//     replaced took a thread an entry, each reading its row of A and
//     column of B from device memory (2k scalar loads for 2k flops, B at
//     stride n): load-bound at 26% of the byte bound at 16 x 16. That
//     tier stays for products of at most 8 multiply-adds (matmul_entries),
//     where its one pass beats the staging.
//
// Every launch goes on the caller's stream, allocates nothing and does
// not synchronize; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "sym_common.cuh"
#include "tile_stage.cuh"

namespace fm {

// ---------------------------------------------------------------------------
// matvec: y = A v, A square n x n
// ---------------------------------------------------------------------------

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
matvec_full_unrolled(long long nb, MatView<T> mat, View<const T> vec, View<T> out) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const T* m = mat.p + b * mat.sb;
  const T* x = vec.p + b * vec.sb;
  T v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = x[j * vec.sc];
  T* o = out.p + b * out.sb;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T acc = m[i * mat.rs] * v[0];
#pragma unroll
    for (int j = 1; j < N; ++j) acc = acc + m[i * mat.rs + j * mat.cs] * v[j];
    o[i * out.sc] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
matvec_full_rolled(long long nb, int n, MatView<T> mat, View<const T> vec, View<T> out) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const T* m = mat.p + b * mat.sb;
  const T* x = vec.p + b * vec.sb;
  T v[kMaxN];
  for (int j = 0; j < n; ++j) v[j] = x[j * vec.sc];
  T* o = out.p + b * out.sb;
  for (int i = 0; i < n; ++i) {
    T acc = m[i * mat.rs] * v[0];
    for (int j = 1; j < n; ++j) acc = acc + m[i * mat.rs + j * mat.cs] * v[j];
    o[i * out.sc] = acc;
  }
}

// ---------------------------------------------------------------------------
// matmul: C = A B, A m x k, B k x n
// ---------------------------------------------------------------------------

// One thread per entry of C (the tier for the smallest products).
template <typename T>
__global__ void __launch_bounds__(kThreads)
matmul_entries(long long nb, int m, int k, int n, bool batch_fastest, MatView<T> a,
               MatView<T> bm, View<T> out) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const int mn = m * n;
  if (t >= nb * mn) return;
  const long long b = batch_fastest ? t % nb : t / mn;
  const int e = batch_fastest ? (int)(t / nb) : (int)(t % mn);
  const int i = e / n, j = e % n;
  const T* ai = a.p + b * a.sb + i * a.rs;
  const T* bj = bm.p + b * bm.sb + j * bm.cs;
  T acc = ai[0] * bj[0];
  for (int kk = 1; kk < k; ++kk) acc = acc + ai[kk * a.cs] * bj[kk * bm.rs];
  out.p[b * out.sb + e * out.sc] = acc;
}

// The tile of C a thread of matmul_tiles accumulates: kTile x kTile.
constexpr int kTile = 4;

// The launch shape: problems a block, threads a problem and column blocks
// of C a problem, each problem's shared region (S values), the operands,
// and the division of the output's entries.
template <typename T>
struct TilePlan {
  int P, tpp, ncb, S;
  TileOperand<T> a, b;
  TileOut<T> out;
};

// A block of P problems (plan), tpp threads each. The block stages each
// problem's A (row stride lda, a multiple of the vector width) and B in
// shared memory, reading device memory in order (tile_stage); thread w of a
// problem accumulates the kTile x kTile tile of C at row block w / ncb and
// column block w % ncb in registers, reading A's rows and B's rows as
// 16-byte vectors, each entry summed over kk ascending (from zero, which
// gives the first term's product exactly); then C takes the operands'
// place, row stride n, and the block writes each problem's m n values in
// order, in vectors where the output is contiguous batch-major.
template <typename T>
__global__ void matmul_tiles(long long nb, int m, int k, int n, TilePlan<T> plan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TM = kTile, TN = kTile, kW = 16 / (int)sizeof(T);
  static_assert(TN % kW == 0, "a tile row is whole vectors");
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int P = plan.P, S = plan.S;
  const long long b0 = blockIdx.x * (long long)P;
  const int np = nb - b0 < P ? (int)(nb - b0) : P;
  tile_stage<T>(plan.a, b0, np, P, S, sm);
  tile_stage<T>(plan.b, b0, np, P, S, sm);
  __syncthreads();

  const int p = threadIdx.x / plan.tpp, w = threadIdx.x - p * plan.tpp;
  const int ri = w / plan.ncb, cj = w - ri * plan.ncb;
  const bool busy = p < np;
  T acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int s = 0; s < TN; ++s) acc[r][s] = T(0);
  if (busy) {
    const int lda = plan.a.ld, ldb = plan.b.ld;
    const T* sa = sm + p * S + plan.a.off + ri * TM * lda;
    const T* sb = sm + p * S + plan.b.off + cj * TN;
    for (int k0 = 0; k0 < k; k0 += kW) {
      T av[TM][kW], bv[kW][TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const TileVec<T> x = *reinterpret_cast<const TileVec<T>*>(sa + r * lda + k0);
#pragma unroll
        for (int c = 0; c < kW; ++c) av[r][c] = x.v[c];
      }
#pragma unroll
      for (int c = 0; c < kW; ++c)
#pragma unroll
        for (int q = 0; q < TN / kW; ++q) {
          const TileVec<T> x =
              *reinterpret_cast<const TileVec<T>*>(sb + (k0 + c) * ldb + q * kW);
#pragma unroll
          for (int s = 0; s < kW; ++s) bv[c][q * kW + s] = x.v[s];
        }
#pragma unroll
      for (int c = 0; c < kW; ++c) {
        if (k0 + c < k) {
#pragma unroll
          for (int r = 0; r < TM; ++r)
#pragma unroll
            for (int s = 0; s < TN; ++s) acc[r][s] = acc[r][s] + av[r][c] * bv[c][s];
        }
      }
    }
  }
  __syncthreads();  // the operands are read: C takes their place
  if (busy) {
    T* c = sm + p * S;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int i = ri * TM + r;
#pragma unroll
      for (int s = 0; s < TN; ++s) {
        const int j = cj * TN + s;
        if (i < m && j < n) c[i * n + j] = acc[r][s];
      }
    }
  }
  __syncthreads();
  tile_store<T>(plan.out, b0, np, P, S, sm);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t launch_matvec_full(int n, long long nb, MatView<T> mat, View<const T> vec,
                               View<T> out, cudaStream_t s) {
  const unsigned g = grid_for(nb);
  switch (n) {
#define FM_MATVEC_FULL_CASE(K) \
  case K: matvec_full_unrolled<T, K><<<g, kThreads, 0, s>>>(nb, mat, vec, out); break;
    FM_MATVEC_FULL_CASE(1) FM_MATVEC_FULL_CASE(2) FM_MATVEC_FULL_CASE(3)
    FM_MATVEC_FULL_CASE(4) FM_MATVEC_FULL_CASE(5) FM_MATVEC_FULL_CASE(6)
    FM_MATVEC_FULL_CASE(7) FM_MATVEC_FULL_CASE(8)
#undef FM_MATVEC_FULL_CASE
    default:
      if (n < 1 || n > kMaxN) return cudaErrorInvalidValue;
      matvec_full_rolled<T><<<g, kThreads, 0, s>>>(nb, n, mat, vec, out);
  }
  return cudaGetLastError();
}

// The staged layout: A as m x k at a row stride whose
// vectors are odd in number (so the rows that one access of a warp reads
// start in different banks), B as k x n, both padded to whole vectors and
// tiles; each problem's region holds them or C, whichever is larger, and
// is a whole, odd number of vectors too.
template <typename T>
TilePlan<T> tile_plan(int m, int k, int n, View<const T> a, bool ta, View<const T> b, bool tb,
                      View<T> out) {
  constexpr int TM = kTile, TN = kTile, kW = 16 / (int)sizeof(T);
  constexpr int kBlock = 256, kSmem = 48 * 1024;
  auto up = [](int x, int q) { return (x + q - 1) / q * q; };
  auto odd = [](int x) { return (x / kW) % 2 == 0 ? x + kW : x; };
  const int mp = up(m, TM), kp = up(k, kW), np = up(n, TN);
  const int lda = odd(kp), ldb = up(np, kW);
  const int ops = mp * lda + kp * ldb;
  const int S = odd(up(ops > m * n ? ops : m * n, kW));
  const int ncb = np / TN, tpp = mp / TM * ncb;
  // problems a block: a multiple of the vector width where it can be, so
  // that each block's range of a contiguous operand starts aligned
  int P = kBlock / tpp;
  if (P * S * (int)sizeof(T) > kSmem) P = kSmem / (S * (int)sizeof(T));
  P = P >= kW ? P / kW * kW : (P < 1 ? 1 : P);
  TilePlan<T> plan;
  plan.P = P;
  plan.tpp = tpp;
  plan.ncb = ncb;
  plan.S = S;
  // a vector of a row that is whole vectors lands whole in its staged row
  const bool af = a.sb == 1 && m * k > 1, bf = b.sb == 1 && k * n > 1;
  const bool av = tile_vec<T>(a.p, a.sb, a.sc, m * k, P);
  const bool bv = tile_vec<T>(b.p, b.sb, b.sc, k * n, P);
  plan.a = {a, m * k, lda, 0, ta, af, av, !ta && k % kW == 0 ? kLandWhole : kLandApart,
            fast_div(ta ? m : k), fast_div(af ? P : m * k)};
  plan.b = {b, k * n, ldb, mp * lda, tb, bf, bv, !tb && n % kW == 0 ? kLandWhole : kLandApart,
            fast_div(tb ? k : n), fast_div(bf ? P : k * n)};
  plan.out = tile_flat_out<T>(out, m * n, P, S);  // C at row stride n: one run a problem
  return plan;
}

template <typename T>
void launch_tiles(int m, int k, int n, long long nb, View<const T> a, bool ta, View<const T> b,
                  bool tb, View<T> out, cudaStream_t s) {
  const TilePlan<T> plan = tile_plan<T>(m, k, n, a, ta, b, tb, out);
  const int threads = (plan.P * plan.tpp + 31) / 32 * 32;
  const unsigned g = (unsigned)((nb + plan.P - 1) / plan.P);
  matmul_tiles<T><<<g, threads, plan.P * plan.S * (int)sizeof(T), s>>>(nb, m, k, n, plan);
}

// The tier of an m x k x n product: a thread an entry up to 8
// multiply-adds a problem, where its one pass beats the staging; the
// tiles above (both measured on an H100 by chip_smoke.py's sweep).
inline bool matmul_by_entries(int m, int k, int n) { return m * k * n <= 8; }

template <typename T>
cudaError_t launch_matmul(int m, int k, int n, long long nb, View<const T> a, bool ta,
                          View<const T> b, bool tb, View<T> out, cudaStream_t s) {
  if (m < 1 || k < 1 || n < 1 || m > kMaxN || k > kMaxN || n > kMaxN)
    return cudaErrorInvalidValue;
  if (matmul_by_entries(m, k, n)) {
    const long long threads = nb * m * n;
    const bool batch_fastest = out.sb == 1 && m * n > 1;
    matmul_entries<T><<<grid_for(threads), kThreads, 0, s>>>(
        nb, m, k, n, batch_fastest, mat_view<T>(a.p, a.sb, a.sc, m, k, ta),
        mat_view<T>(b.p, b.sb, b.sc, k, n, tb), out);
  } else {
    launch_tiles<T>(m, k, n, nb, a, ta, b, tb, out, s);
  }
  return cudaGetLastError();
}

}  // namespace fm

// Plain C entry points (bound with ctypes). dtype: 0 = float, 1 = double.
// Each operand is (pointer, batch stride, channel stride) in elements; a
// nonzero trans flag reads that matrix transposed (the product's A is then
// stored k x m, its B n x k).
extern "C" int fm_matvec_full(int dtype, int n, long long nb,
                              const void* mat, long long msb, long long msc, int trans,
                              const void* vec, long long vsb, long long vsc,
                              void* out, long long osb, long long osc, void* stream) {
  if (nb <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fm::launch_matvec_full<float>(n, nb, fm::mat_view<float>(mat, msb, msc, n, n, trans),
                                         fm::cview<float>(vec, vsb, vsc),
                                         fm::view<float>(out, osb, osc), s);
  if (dtype == 1)
    return fm::launch_matvec_full<double>(n, nb,
                                          fm::mat_view<double>(mat, msb, msc, n, n, trans),
                                          fm::cview<double>(vec, vsb, vsc),
                                          fm::view<double>(out, osb, osc), s);
  return cudaErrorInvalidValue;
}

extern "C" int fm_matmul(int dtype, int m, int k, int n, long long nb,
                         const void* a, long long asb, long long asc, int trans_a,
                         const void* b, long long bsb, long long bsc, int trans_b,
                         void* out, long long osb, long long osc, void* stream) {
  if (nb <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fm::launch_matmul<float>(m, k, n, nb, fm::cview<float>(a, asb, asc), trans_a,
                                    fm::cview<float>(b, bsb, bsc), trans_b,
                                    fm::view<float>(out, osb, osc), s);
  if (dtype == 1)
    return fm::launch_matmul<double>(m, k, n, nb, fm::cview<double>(a, asb, asc), trans_a,
                                     fm::cview<double>(b, bsb, bsc), trans_b,
                                     fm::view<double>(out, osb, osc), s);
  return cudaErrorInvalidValue;
}

// The tier fm_matmul takes for an m x k x n product: 0 one thread an entry
// (matmul_entries), 1 the staged tiles (matmul_tiles).
extern "C" int fm_matmul_tier(int m, int k, int n) {
  return fm::matmul_by_entries(m, k, n) ? 0 : 1;
}
