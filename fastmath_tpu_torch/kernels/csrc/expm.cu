// Batched matrix exponential for Hopper (sm_90a): scaling and squaring
// with a Taylor-Horner core.
//
// Replaces the Pallas TPU kernels of fastmath_tpu/kernels/expm_pallas.py
// (both behind expm_cf):
//   expm_unrolled <- _expm_kernel         (d <= 8 there and here, one
//                                          thread a problem)
//   expm_warp     <- _expm_rolled_kernel  (9 <= d <= 32, a lane group a
//                                          problem)
//
// Each problem is one real d x d matrix X (d <= 32), read through its
// strides (lie_common.cuh). The algebra is the reference's:
//   s = clip(ceil(log2(max(|X|_1, 1e-30) / 0.5)), 0, 20), |X|_1 the largest
//       column sum of |x_ij| (each column summed over i in order);
//   Y = X 2^-s (exact);
//   R = I + Y / order, then R = I + (Y R) / m for m = order - 1 .. 1
//       (order 9 in float32, 16 in float64), the divisions as products by
//       the reciprocal 1/m;
//   then R = R R, exactly s times for this problem.
// Each problem squares its own s times and stops; the TPU kernel runs a
// block of problems to the block's largest s under a mask, which gives
// the same values.
//
// Tiers, split where the times on the card put them (chip_ab.py, NVIDIA
// H100 80GB HBM3 at 700 W; -Xptxas -v for registers):
//   expm_unrolled<T, D, P, kOwn>: one thread a problem, every index a
//     compile-time constant, P problems a block, d <= 8 in both dtypes. A
//     batch-major block is staged through shared memory (tile_stage.cuh:
//     16-byte vectors in order, each problem in a region of its own at an
//     odd stride) and written back the same way; kOwn, for channel-first
//     and transposed operands (and d = 1), has each thread read and write
//     its own problem. To d = 6 Y, R and a product temporary live in
//     registers (3 d^2 values). At d = 7, 8 Y stays in the thread's region
//     and each product reads its left factor from there a row at a time
//     (R R reads R, which the region then holds), so only R and the
//     product are registers (2 d^2: 128 at d = 8 in float32, not 192),
//     and the Horner steps and the squarings run as loops rather than
//     unrolled, which keeps the code a few products long. The 8 x 8
//     float32 batch took 0.31 ms with every matrix in registers and 64
//     problems a block staged a value at a time, 0.11 ms so (36% of its
//     operation bound); float64 at d = 7, 8 takes less than half the
//     time of expm_warp's lane groups, although d = 8 spills (2 d^2
//     doubles).
//   expm_warp<T, G>: a group of G = 16 or 32 lanes a problem (the least
//     G >= d; 32 / G problems a warp), Y, R and a scratch matrix row-major
//     in shared memory with row stride G (3 d G values a problem: 12 KB at
//     d = 32 in float32), the columns past d zero. Lane j
//     holds column j of a product's right factor in registers and forms
//     column j of the product, each entry a row of the left factor (a
//     broadcast, read as 16-byte vectors) against it; the zero columns add
//     exact zeros. Lanes j >= d of a group idle in the writes.
//
// What bounds them: a problem reads and writes d^2 values and needs
// (order - 1 + s) products of about 2 d^3 operations: at 4x4 in float32
// about 11 operations per byte moved, below the card's 20, so the 4x4
// batch is bound by bytes (hence the staged tiles); about 20 at d = 8 and
// 43 at d = 16, bound by operations.
// Multiply-adds contract into FMAs, so results move a few ulp from the
// plain PyTorch version (fastmath_tpu_torch/kernels/expm.py,
// expm_plain), which repeats this arithmetic.
//
// Every launch goes on the caller's stream, allocates nothing and does
// not synchronize; the entry point returns cudaGetLastError().

#include "lie_common.cuh"
#include "tile_stage.cuh"

namespace fm {

constexpr int kSquaringsMax = 20;
// the largest d of the one-thread tier, by dtype (registers, see above)
template <typename T>
constexpr int expm_unroll_max();
template <>
constexpr int expm_unroll_max<float>() { return 8; }
template <>
constexpr int expm_unroll_max<double>() { return 8; }
// the largest d whose one-thread tier keeps Y, R and the product in
// registers; above, Y is read from the thread's region in shared memory
constexpr int kExpmRegsMax = 6;

template <typename T>
__host__ __device__ constexpr int expm_order();
template <>
__host__ __device__ constexpr int expm_order<float>() { return 9; }
template <>
__host__ __device__ constexpr int expm_order<double>() { return 16; }

__device__ __forceinline__ float lie_log2(float x) { return log2f(x); }
__device__ __forceinline__ double lie_log2(double x) { return log2(x); }
__device__ __forceinline__ float lie_ceil(float x) { return ceilf(x); }
__device__ __forceinline__ double lie_ceil(double x) { return ceil(x); }

// The squaring count of a problem from its 1-norm.
template <typename T>
__device__ __forceinline__ int squarings(T norm) {
  T s = lie_ceil(lie_log2(fm_max(norm, T(1e-30)) / T(0.5)));
  s = s < T(0) ? T(0) : (s > T(kSquaringsMax) ? T(kSquaringsMax) : s);
  return (int)s;
}

// One problem's scaling and squaring on the thread's matrices in
// registers (d <= kExpmRegsMax): Y = X 2^-s in y, the result in r.
template <typename T, int D>
__device__ __forceinline__ void expm_regs(T (&y)[D * D], T (&r)[D * D]) {
  constexpr int W = D * D;
  constexpr int kOrder = expm_order<T>();
  T norm = T(0);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    T col = fm_abs(y[j]);
#pragma unroll
    for (int i = 1; i < D; ++i) col = col + fm_abs(y[i * D + j]);
    norm = j == 0 ? col : fm_max(norm, col);
  }
  const int s = squarings(norm);
  const T scale = lie_ldexp(T(1), -s);
#pragma unroll
  for (int e = 0; e < W; ++e) y[e] = y[e] * scale;
  T p[W];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) r[i * D + j] = (i == j ? T(1) : T(0)) + y[i * D + j] * (T(1) / T(kOrder));
#pragma unroll
  for (int m = kOrder - 1; m > 0; --m) {
    lie_mm<T, D>(y, r, p, T(1), T(1) / T(m));
#pragma unroll
    for (int e = 0; e < W; ++e) r[e] = p[e];
  }
  for (int it = 0; it < s; ++it) {
    lie_mm<T, D>(r, r, p);
#pragma unroll
    for (int e = 0; e < W; ++e) r[e] = p[e];
  }
}

// c = add I + scale (a b) as lie_mm forms it, with the left factor a read
// a row at a time from the thread's region (row-major, D x D) and b, c in
// registers.
template <typename T, int D>
__device__ __forceinline__ void expm_rows(const T* a, const T (&b)[D * D], T (&c)[D * D],
                                          T scale) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    T ai[D];
#pragma unroll
    for (int k = 0; k < D; ++k) ai[k] = a[i * D + k];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      T acc = ai[0] * b[j];
#pragma unroll
      for (int k = 1; k < D; ++k) acc = acc + ai[k] * b[k * D + j];
      c[i * D + j] = i == j ? T(1) + acc * scale : acc * scale;
    }
  }
}

// r <- r r, the left factor read from the region m, which holds r; each
// row of the product is written back over its own row of m once it is
// formed (no later row reads it), so m holds the new r at the end.
template <typename T, int D>
__device__ __forceinline__ void expm_square(T* m, T (&r)[D * D]) {
  T p[D * D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    T ai[D];
#pragma unroll
    for (int k = 0; k < D; ++k) ai[k] = m[i * D + k];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      T acc = ai[0] * r[j];
#pragma unroll
      for (int k = 1; k < D; ++k) acc = acc + ai[k] * r[k * D + j];
      p[i * D + j] = acc;
    }
#pragma unroll
    for (int j = 0; j < D; ++j) m[i * D + j] = p[i * D + j];
  }
#pragma unroll
  for (int e = 0; e < D * D; ++e) r[e] = p[e];
}

// One problem's scaling and squaring with X in the thread's region m (d >
// kExpmRegsMax): Y = X 2^-s is scaled in place and read a row at a time as
// each product's left factor, so that only R and the product live in
// registers (2 d^2 values, not 3); the Horner steps run as a loop over
// pairs of steps (R -> P -> R), the squarings as a loop over one step,
// with R copied to m first. The result is in r and in m.
template <typename T, int D>
__device__ __forceinline__ void expm_region(T* m, T (&r)[D * D]) {
  constexpr int W = D * D;
  constexpr int kOrder = expm_order<T>();
  T norm = T(0);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    T col = fm_abs(m[j]);
#pragma unroll
    for (int i = 1; i < D; ++i) col = col + fm_abs(m[i * D + j]);
    norm = j == 0 ? col : fm_max(norm, col);
  }
  const int s = squarings(norm);
  const T scale = lie_ldexp(T(1), -s);
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const T v = m[i * D + j] * scale;
      m[i * D + j] = v;
      r[i * D + j] = (i == j ? T(1) : T(0)) + v * (T(1) / T(kOrder));
    }
  T p[W];
  int k = kOrder - 1;
  if constexpr ((kOrder - 1) % 2 == 1) {
    expm_rows<T, D>(m, r, p, T(1) / T(k));
#pragma unroll
    for (int e = 0; e < W; ++e) r[e] = p[e];
    --k;
  }
#pragma unroll 1
  for (; k > 0; k -= 2) {
    expm_rows<T, D>(m, r, p, T(1) / T(k));
    expm_rows<T, D>(m, p, r, T(1) / T(k - 1));
  }
#pragma unroll
  for (int e = 0; e < W; ++e) m[e] = r[e];
#pragma unroll 1
  for (int it = 0; it < s; ++it) expm_square<T, D>(m, r);
}

// The operand as given (read by the thread of its problem, kOwn) and as
// staged, and the result.
template <typename T>
struct ExpmPlan {
  MatView<T> mat;
  TileOperand<T> in;
  TileOut<T> out;
};

// One thread a problem, P problems a block. Batch-major operands (any
// flat layout: contiguous, broadcast, a row or column stride) are staged
// through the block's regions (tile_stage.cuh) in and out; a channel-first
// operand and result, or an operand whose rows are not flat channels (a
// transposed view), are read and written by each thread for its own
// problem (kOwn: neighbouring threads on neighbouring addresses in the
// channel-first layout), which keeps the staging's code out of the
// batch-major kernel. d <= kExpmRegsMax works in registers (expm_regs);
// above, on the thread's region (expm_region), which a kOwn kernel then
// takes for itself.
template <typename T, int D, int P, bool kOwn>
__global__ void __launch_bounds__(P) expm_unrolled(long long nb, ExpmPlan<T> plan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int W = D * D, S = staged_stride<T>(W);
  T* sm = reinterpret_cast<T*>(smem_raw);
  const long long b0 = blockIdx.x * (long long)P;
  const int np = nb - b0 < P ? (int)(nb - b0) : P;
  const long long b = b0 + threadIdx.x;
  T* m = sm + threadIdx.x * S;
  if constexpr (!kOwn) {
    tile_stage<T, false, staged_loads<T>(W)>(plan.in, b0, np, P, S, sm);
    __syncthreads();
  }
  if ((int)threadIdx.x < np) {
    const MatView<T>& a = plan.mat;
    T r[W];
    if constexpr (D <= kExpmRegsMax) {
      T y[W];
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j)
          y[i * D + j] = kOwn ? a.p[b * a.sb + i * a.rs + j * a.cs] : m[i * D + j];
      expm_regs<T, D>(y, r);
    } else {
      if constexpr (kOwn) {
#pragma unroll
        for (int i = 0; i < D; ++i)
#pragma unroll
          for (int j = 0; j < D; ++j) m[i * D + j] = a.p[b * a.sb + i * a.rs + j * a.cs];
      }
      expm_region<T, D>(m, r);
    }
    if constexpr (kOwn) {
      const View<T>& o = plan.out.v;
#pragma unroll
      for (int e = 0; e < W; ++e) o.p[b * o.sb + e * o.sc] = r[e];
    } else if constexpr (D <= kExpmRegsMax) {
#pragma unroll
      for (int e = 0; e < W; ++e) m[e] = r[e];
    }
  }
  if constexpr (!kOwn) {
    __syncthreads();
    tile_store<T>(plan.out, b0, np, P, S, sm);
  }
}

template <typename T, int G>
__global__ void expm_warp(long long nb, int d, MatView<T> in, View<T> out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kOrder = expm_order<T>();
  const int lane = threadIdx.x % kLieWarp, gl = lane % G;
  const unsigned mask = lie_group_mask<G>(lane);
  const long long slot = blockIdx.x * (long long)(blockDim.x / G) + threadIdx.x / G;
  const int dg = d * G;
  T* y = reinterpret_cast<T*>(smem_raw) + (threadIdx.x / G) * 3 * dg;
  T* r = y + dg;
  T* t = r + dg;
  if (slot >= nb) return;  // the whole group; no block-wide barrier follows
  lie_grp_zero<T, G>(y, 3 * dg, gl, mask);
  lie_grp_load<T, G>(in, slot, d, gl, y);
  T col = T(0);
  if (gl < d)
    for (int i = 0; i < d; ++i) col = col + fm_abs(y[i * G + gl]);
  // the largest column sum: every column sum is >= 0 and fmax is exact
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) col = fm_max(col, __shfl_xor_sync(mask, col, o, G));
  const int s = squarings(col);
  const T scale = lie_ldexp(T(1), -s);
  if (gl < d)
    for (int i = 0; i < d; ++i) {
      const T v = y[i * G + gl] * scale;
      y[i * G + gl] = v;
      r[i * G + gl] = (i == gl ? T(1) : T(0)) + v * (T(1) / T(kOrder));
    }
  __syncwarp(mask);
  for (int m = kOrder - 1; m > 0; --m) {
    lie_grp_mm<T, G>(y, r, t, d, gl, mask, T(1), T(1) / T(m));
    T* u = r;
    r = t;
    t = u;
  }
  for (int it = 0; it < s; ++it) {
    lie_grp_mm<T, G>(r, r, t, d, gl, mask);
    T* u = r;
    r = t;
    t = u;
  }
  lie_grp_store<T, G>(r, out, slot, d, gl, T(1));
}

template <typename T, int G>
void launch_expm_group(int d, long long nb, MatView<T> in, View<T> out, cudaStream_t s) {
  const int per_warp = (kLieWarp / G) * 3 * d * G * (int)sizeof(T);
  const int warps = lie_warps(per_warp);
  const int per_block = warps * (kLieWarp / G);
  const unsigned g = (unsigned)((nb + per_block - 1) / per_block);
  expm_warp<T, G><<<g, warps * kLieWarp, warps * per_warp, s>>>(nb, d, in, out);
}

// The one-thread tier at d = D: the operand staged where it is flat
// channels (entry (i, j) at i * d + j times a channel stride) and not
// channel-first with a channel-first result; each thread's own otherwise,
// and at d = 1, where a thread's one value is its neighbours' neighbour in
// every layout.
template <typename T, int D>
void launch_expm_unrolled(long long nb, MatView<T> in, View<T> out, cudaStream_t s) {
  constexpr int W = D * D, S = staged_stride<T>(W), P = staged_threads<T>(W);
  const View<const T> flat{in.p, in.sb, in.cs};
  const ExpmPlan<T> plan{in, tile_flat_operand<T>(flat, W, P, S), tile_flat_out<T>(out, W, P, S)};
  const bool own = D == 1 || in.rs != D * in.cs ||
                   (plan.in.batch_fastest && plan.out.batch_fastest);
  const int smem = own && D <= kExpmRegsMax ? 0 : P * S * (int)sizeof(T);
  const auto kern = own ? expm_unrolled<T, D, P, true> : expm_unrolled<T, D, P, false>;
  kern<<<(unsigned)((nb + P - 1) / P), P, smem, s>>>(nb, plan);
}

template <typename T>
cudaError_t launch_expm(int d, long long nb, MatView<T> in, View<T> out, cudaStream_t s) {
  if (d < 1 || d > kMaxN) return cudaErrorInvalidValue;
  if (d <= expm_unroll_max<T>()) {
    switch (d) {
#define FM_EXPM_CASE(K) \
  case K: if constexpr (K <= expm_unroll_max<T>()) launch_expm_unrolled<T, K>(nb, in, out, s); break;
      FM_EXPM_CASE(1) FM_EXPM_CASE(2) FM_EXPM_CASE(3) FM_EXPM_CASE(4)
      FM_EXPM_CASE(5) FM_EXPM_CASE(6) FM_EXPM_CASE(7) FM_EXPM_CASE(8)
#undef FM_EXPM_CASE
      default: return cudaErrorInvalidValue;
    }
  } else if (lie_group(d) == 16) {
    launch_expm_group<T, 16>(d, nb, in, out, s);
  } else {
    launch_expm_group<T, kLieWarp>(d, nb, in, out, s);
  }
  return cudaGetLastError();
}

}  // namespace fm

// Plain C entry point (bound with ctypes). dtype: 0 = float, 1 = double.
// The input is (pointer, batch stride, row stride, column stride) in
// elements; the output (pointer, batch stride, channel stride), entry
// (i, j) on channel i * d + j.
extern "C" int fm_expm(int dtype, int d, long long nb, const void* a, long long sb, long long rs,
                       long long cs, void* out, long long osb, long long osc, void* stream) {
  if (nb <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fm::launch_expm<float>(
        d, nb, fm::MatView<float>{static_cast<const float*>(a), sb, rs, cs},
        fm::view<float>(out, osb, osc), s);
  if (dtype == 1)
    return fm::launch_expm<double>(
        d, nb, fm::MatView<double>{static_cast<const double*>(a), sb, rs, cs},
        fm::view<double>(out, osb, osc), s);
  return cudaErrorInvalidValue;
}

// The largest d of the one-thread tier for dtype (0 = float, 1 = double):
// the Python wrapper checks its own copy of the bound against it.
extern "C" int fm_expm_unroll_max(int dtype) {
  return dtype == 0 ? fm::expm_unroll_max<float>() : fm::expm_unroll_max<double>();
}
