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
//   JtHJ, 7 <= max(K, D) <= 32: a team of lanes per problem (a power of
//     two, one per 4 x 4 block of G, at most a warp). The team stages J
//     and H (both triangles) in shared memory with cp.async, zero-padded
//     to multiples of 4; each lane forms 4 x 4 blocks of HJ, then of G,
//     from 16-byte shared-memory loads (the padding adds exact zeros after
//     the real terms, so every sum keeps the reference's order); the
//     output takes 0.5 (G_ij + G_ji) off the diagonal, as the reference's
//     rolled tier does. It reaches ~30% of its byte bound at K = D = 16;
//     what holds it there is not measured yet (PERF.md).

#include <cuda_runtime.h>

#include "sym_common.cuh"

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

// Asynchronous copy of one value from device to shared memory (sm_80+):
// the warp goes on issuing while the copies are in flight, so a staging
// loop waits for memory once (copy_async_wait), not once per element as
// a load followed by a shared-memory store does.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(sizeof(T)));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copy_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Four consecutive shared-memory values (16-byte aligned) in one or two
// vector loads.
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
}

__device__ __forceinline__ void load4(const double* p, double (&x)[4]) {
  const double2 lo = *reinterpret_cast<const double2*>(p);
  const double2 hi = *reinterpret_cast<const double2*>(p + 2);
  x[0] = lo.x, x[1] = lo.y, x[2] = hi.x, x[3] = hi.y;
}

__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(double* p, const double (&x)[4]) {
  *reinterpret_cast<double2*>(p) = make_double2(x[0], x[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(x[2], x[3]);
}

// C[i0 + i][j0 + j] = sum_t A[t][i0 + i] * B[t][j0 + j] over t < depth,
// from t = 0: one 4 x 4 block. A, B and C are row-major in shared memory
// with row lengths lda, ldb and ldc, and depth, all multiples of 4.
template <typename T>
__device__ __forceinline__ void block4(const T* A, int lda, int i0, const T* B, int ldb, int j0,
                                       int depth, T* C, int ldc) {
  T acc[4][4], a[4], b[4];
  load4(A + i0, a);
  load4(B + j0, b);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = a[i] * b[j];
  for (int t = 1; t < depth; ++t) {
    load4(A + t * lda + i0, a);
    load4(B + t * ldb + j0, b);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = acc[i][j] + a[i] * b[j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) store4(C + (i0 + i) * ldc + j0, acc[i]);
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Shared-memory values of one problem of the rolled tier: J (k x d), HJ
// (k x d), then H (k x k, both triangles) and later, over it, G (d x d);
// each side padded with zeros to a multiple of 4.
__host__ __device__ inline int jhj_values(int k, int d) {
  const int kp = round4(k), dp = round4(d);
  return 2 * kp * dp + (kp > dp ? kp * kp : dp * dp);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
jhj_rolled(long long nb, int k, int d, int team, View<const T> jm, View<const T> hm,
           View<T> out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kp = round4(k), dp = round4(d);
  const int lane = threadIdx.x % team;
  const long long b = blockIdx.x * (long long)(blockDim.x / team) + threadIdx.x / team;
  const bool live = b < nb;
  T* sJ = reinterpret_cast<T*>(smem_raw) + (threadIdx.x / team) * jhj_values(k, d);
  T* sHJ = sJ + kp * dp;
  T* sH = sHJ + kp * dp;
  T* sG = sH;  // H is dead once HJ is formed
  if (live) {
    const T* jb = jm.p + b * jm.sb;
    const T* hb = hm.p + b * hm.sb;
    for (int a = 0; a < kp; ++a)
      for (int c = lane; c < dp; c += team) {
        if (a < k && c < d)
          copy_async(sJ + a * dp + c, jb + (a * d + c) * jm.sc);
        else
          sJ[a * dp + c] = T(0);
      }
    // H from its compact rows, walked in storage order: slot (a, c), c >= a,
    // fills (a, c) and (c, a); rows and columns k..kp are zero
    int slot = k;  // row a's first off-diagonal slot
    for (int a = 0; a < k; ++a) {
      for (int c = a + lane; c < k; c += team) {
        const T* src = hb + (c == a ? a : slot + c - a - 1) * hm.sc;
        copy_async(sH + a * kp + c, src);
        if (c != a) copy_async(sH + c * kp + a, src);
      }
      slot += k - 1 - a;
    }
    for (int a = 0; a < kp; ++a)
      for (int c = k + lane; c < kp; c += team) sH[a * kp + c] = sH[c * kp + a] = T(0);
    copy_async_wait();
  }
  __syncwarp();
  // HJ = H J in 4 x 4 blocks (H symmetric: its row t is its column t);
  // the zero padding adds exact zeros after the real terms
  const int kb = kp / 4, db = dp / 4;
  if (live)
    for (int blk = lane; blk < kb * db; blk += team)
      block4(sH, kp, 4 * (blk / db), sJ, dp, 4 * (blk % db), kp, sHJ, dp);
  __syncwarp();
  // G = J^T (H J)
  if (live)
    for (int blk = lane; blk < db * db; blk += team)
      block4(sJ, dp, 4 * (blk / db), sHJ, dp, 4 * (blk % db), kp, sG, dp);
  __syncwarp();
  if (live) {
    T* o = out.p + b * out.sb;
    for (int i = lane; i < d; i += team) o[i * out.sc] = sG[i * dp + i];
    int slot = d;  // row i's first off-diagonal slot
    for (int i = 0; i < d; ++i) {
      for (int c = i + 1 + lane; c < d; c += team)
        o[(slot + c - i - 1) * out.sc] = T(0.5) * (sG[i * dp + c] + sG[c * dp + i]);
      slot += d - 1 - i;
    }
  }
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
  // a team of lanes per problem, one 4 x 4 block of G each (the power of
  // two >= the block count, at most a warp), wider where the warp's
  // problems would not fit the default shared memory
  const int blocks = (round4(d) / 4) * (round4(d) / 4);
  const int bytes = jhj_values(k, d) * (int)sizeof(T);
  int team = 1;
  while (team < kWarp && (team < blocks || (kWarp / team) * bytes > kDefaultSmem)) team *= 2;
  int warps = kThreads / kWarp;
  while (warps > 1 && warps * (kWarp / team) * bytes > kDefaultSmem) warps /= 2;
  const int per_block = warps * (kWarp / team);
  const unsigned g = (unsigned)((nb + per_block - 1) / per_block);
  jhj_rolled<T><<<g, warps * kWarp, per_block * bytes, s>>>(nb, k, d, team, jm, hm, out);
  return cudaGetLastError();
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
