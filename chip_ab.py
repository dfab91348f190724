#!/usr/bin/env python3
"""Time one source tree's full-storage solve, Cholesky, inverse, compact
solve, product, matrix logarithm, rolled eig, chain and power-iteration
kernels, the n <= 8 inverse, Cholesky, determinant and solve tiers, the
matrix exponential (both tiers), the 5 <= N <= 8 compact chain, the
rolled JtHJ tier, the N <= 8 compact inverse, solve and determinant and
the n <= 8 eig tier, on one NVIDIA GPU, to compare two versions of a
kernel in one call.

    python3 /path/to/chip_ab.py TAG [--library] [--only GROUP[,GROUP...]]

Run it from the root of the tree to time (its ``chip_smoke.py`` and
``fastmath_tpu_torch`` are imported from the working directory), once for
each tree in turns (old, new, new, old). It builds the sources of the
groups it times, times each kernel three times with
``chip_smoke.device_ms`` at the bench suite's shapes, holds each result
against its plain version, and prints one JSON line: ``tag``, each
shape's three times and error, and the registers and spills (``-Xptxas
-v``) of every kernel of those sources but the unrolled tiers (except
``logm_unrolled``, and the inverse's, Cholesky's, expm's, the chain's,
the determinant's, the solve's, the compact inverse's and eig's with
``inv8``, ``chol8``, ``expm``, ``chain8``, ``det8``, ``solve8``,
``syminv8`` and ``eig8``). The groups (all by default):
``solve``
(``csrc/batched.cu``: the solve 16x16 on 500k, 24x24 on 200k, 32x32 on
100k with one column and 16x16 with 16; the inverse 16x16 and 32x32),
``chol`` (16x16, 24x24, 32x32), ``sym_solve`` (``csrc/sym_solve.cu``: N =
16 on 262,144, also with ``refine=1``, N = 24 on 131,072, N = 32 on
65,536), ``matmul`` (``csrc/batched_products.cu``: 4x4 on 1M, 16x16 on
500k, 32x32 on 100k), ``logm`` (``csrc/logm.cu``: ``logm_warp`` at every
``chip_smoke.LIE_SHAPES`` d and 17x17, 20x20 and 21x21 on 15,625, on expm
of the bench input, and 32x32 holding those 17x17 problems padded with
the identity; normwise error), ``logm4`` (``logm_unrolled``: 4x4 on 1M,
``chip_smoke.py``'s input, then the same problems sorted by their
iteration counts and a batch of one problem a warp, each with its mean
square roots and Denman-Beavers steps; and ``expm_unrolled`` on the
input, which shares the tier's product), ``eig`` (``csrc/eig.cu``:
``eig_rolled`` at 12, 16 on 200k and 24, 32 on 100k, values and vectors,
the largest eigenvalue difference), ``chain`` (``csrc/sym_iterate.cu``
and ``csrc/sym_solve.cu``: the matvec chain k = 32 at n = 9, 12, 16, 17,
24, 32 and the compact chain solve k = 128 at N = 9, 16, 24, 32, on the
bytes of 16x16 on 1M and of N = 16 on 262,144; normwise over the terms,
as ``chip_smoke.py``) and ``maxeig`` (``csrc/sym_iterate.cu``: the power
iteration, iters 32, r 8, at n = 9, 12, 16, 17, 24, 32 on the bytes of
16x16 on 1M, ``chip_smoke.maxeig_input``; mu over the Gershgorin bound,
v normwise), ``inv8`` (``csrc/batched.cu``'s n <= 8 inverse tier: 3x3,
5x5 and 8x8 on 1M in float32, 8x8 in float64, and the channel-first 8x8;
then the staging's ceiling, ``stage_copy``: ``csrc/tile_stage.cuh`` of the
tree this script lies in, built here into a kernel that stages 8x8
problems into shared memory and writes them back with no arithmetic, at P
= 64, 128 and 256 problems a block, beside ``Tensor.copy_`` of the same
bytes and their bound), ``chol8`` (the n <= 8 Cholesky tier: 3x3, 5x5
and 8x8 on 1M in float32, 8x8 in float64, and the channel-first 8x8),
``expm`` (``csrc/expm.cu``'s one-thread tier at every d <= 8 in both
dtypes on the bytes of 4x4 on 1M, batch-major and channel-first, with its
bound and mean squarings; 4x4 and 8x8 float32 also sorted by their
squaring counts), ``chain8`` (the compact chain solve k = 128 at N =
5..8 on 262,144 in both dtypes, channel-first too, with its bound and its
normwise error against the float64 recurrence on 4096 problems; and
``chain_groups<T, 8>``, from ``TIER_PROBE``, built against the measured
tree's sources), ``expm_warp`` (``csrc/expm.cu``'s lane groups at every
``EXPM_WARP_DS`` d in both dtypes on 16M values, with bound and mean
squarings, 16x16 and 32x32 channel-first too, and each instantiation's
SASS size) and ``jhj`` (``csrc/sym_products.cu``'s rolled JtHJ tier at
``JHJ_SHAPES`` in both dtypes, each on the bytes of K = D = 16 on 200k,
with its bound, 16x16 float32 channel-first too), ``det8``
(``csrc/batched.cu``'s det and log|det| at n = 4..8 on 1M in both dtypes,
batch-major and channel-first, with their bounds; at 4x4 also the
unstaged expansion, and at 8x8 float32 the staging alone and the
arithmetic alone, from ``PROBE8``) and ``solve8`` (the n <= 8 solve at n
= 1..8 on 1M with k = 1, 2 and n, and 8 at n <= 2, A as it is and
transposed, in both dtypes, with its bound; at 8x8 float32 also k = 9,
the first width past the staged one, the three operands channel-first at
k = 1, and at k = 1 and 8 the staging alone and the arithmetic alone),
``syminv8`` (``csrc/sym_factor.cu``'s compact inverse at N = 1..8 on 1M
in both dtypes, batch-major and channel-first in and out, with its bound;
at N = 4 and 8 in float32 also channel-first in and batch-major out),
``compact8`` (the compact solve and determinant at N = 5..8 in float32 on
262,144 and on 1M, with their bounds), ``route`` (the host side of the
main path, the public ``sym_solve`` on ``chip_smoke.py``'s 1M x 4 x 4
batch under ``auto``: its routing decision alone, ``ops.sym._route``
as the call makes it, in microseconds a call over 20 x 20,000 calls, and the whole call's ``chip_smoke.host_ms`` over 15 x 50 calls,
each list with its median and quartiles; no kernel is timed) and ``eig8`` (``csrc/eig.cu``'s
unrolled tier at n = 2..8 in both dtypes, values and vectors, on the bytes
of 4x4 on 1M, batch-major full storage and channel-first compact, with
its bound, its special-function bound and the mean sweeps beside the
mean of each warp's largest; at 4x4 and 8x8 float32 also the problems
sorted by their sweeps, the staging alone (the tree's kernel at sweeps =
0) and the arithmetic alone, from ``EIG_PROBE``; each instantiation's SASS
size and MUFU count). ``inv8``, ``chol8``, ``expm``, ``chain8``,
``expm_warp``, ``jhj``, ``det8``, ``solve8``, ``syminv8`` and ``eig8``
also give each output's digest (SHA-256 of its bytes), so that two
trees' outputs compare bit for bit, and their tiers' registers (``det8``
and ``solve8`` also each instantiation's SASS size). ``--library`` also
times ``torch.linalg.solve_ex`` / ``cholesky_ex`` (the compact solve's on
the densified batch), ``inv_ex`` (the compact inverse's on the densified
batch), ``torch.matmul``, ``eigvalsh`` / ``eigh`` and ``det`` /
``slogdet`` on the same inputs. It imports neither JAX nor
``fastmath_tpu``.
"""
import ctypes
import hashlib
import json
import pathlib
import re
import subprocess
import sys

# A kernel that stages problems of SIZE values into shared memory at the
# n <= 8 tiers' odd region stride and writes them back, with no arithmetic:
# the ceiling of the staged path (inv8's stage_copy).
STAGE_COPY = r"""
#include "tile_stage.cuh"

namespace fm {
template <typename T, int SIZE, int P>
__global__ void __launch_bounds__(P) stage_copy(long long nb, TileOperand<T> in, TileOut<T> out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int S = SIZE | 1;
  T* sm = reinterpret_cast<T*>(smem_raw);
  const long long b0 = blockIdx.x * (long long)P;
  const int np = nb - b0 < P ? (int)(nb - b0) : P;
  tile_stage<T>(in, b0, np, P, S, sm);
  __syncthreads();
  tile_store<T>(out, b0, np, P, S, sm);
}

template <typename T, int SIZE, int P>
int copy(long long nb, const void* x, long long xsb, long long xsc, void* y, long long ysb,
         long long ysc, void* stream) {
  constexpr int S = SIZE | 1;
  const int smem = P * S * (int)sizeof(T);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(stage_copy<T, SIZE, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  const View<const T> in{static_cast<const T*>(x), xsb, xsc};
  const View<T> out{static_cast<T*>(y), ysb, ysc};
  stage_copy<T, SIZE, P><<<(unsigned)((nb + P - 1) / P), P, smem, (cudaStream_t)stream>>>(
      nb, tile_flat_operand<T>(in, SIZE, P, S), tile_flat_out<T>(out, SIZE, P, S));
  return cudaGetLastError();
}
}  // namespace fm

extern "C" int fm_stage_copy(int dtype, int P, long long nb, const void* x, long long xsb,
                             long long xsc, void* y, long long ysb, long long ysc, void* s) {
  if (dtype == 0 && P == 64) return fm::copy<float, 64, 64>(nb, x, xsb, xsc, y, ysb, ysc, s);
  if (dtype == 0 && P == 128) return fm::copy<float, 64, 128>(nb, x, xsb, xsc, y, ysb, ysc, s);
  if (dtype == 0 && P == 256) return fm::copy<float, 64, 256>(nb, x, xsb, xsc, y, ysb, ysc, s);
  if (dtype == 1 && P == 64) return fm::copy<double, 64, 64>(nb, x, xsb, xsc, y, ysb, ysc, s);
  if (dtype == 1 && P == 128) return fm::copy<double, 64, 128>(nb, x, xsb, xsc, y, ysb, ysc, s);
  return cudaErrorInvalidValue;
}
"""


# The other tier a shape could take, built from the measured tree's own
# sources: chain_groups<T, 8> (the 9 <= N <= 32 chain's explicit inverse on
# lane groups of 8), launched at 5 <= N <= 8, where the tree's own launcher
# takes the one-thread tier.
TIER_PROBE = r"""
#include "sym_solve.cu"

template <typename T>
int chain8(int n, long long nb, const void* mat, long long msb, long long msc, const void* vec,
           long long vsb, long long vsc, const void* add, long long asb, long long asc,
           void* out, long long osb, long long osc, int iters, cudaStream_t s) {
  fm::lu_launch<8>(fm::chain_groups<T, 8>, fm::lu_chain_solve_bytes<T, 8>(), nb, s, n,
                   fm::cview<T>(mat, msb, msc), fm::cview<T>(vec, vsb, vsc),
                   fm::cview<T>(add, asb, asc), fm::view<T>(out, osb, osc),
                   static_cast<const T*>(nullptr), iters);
  return cudaGetLastError();
}

extern "C" int fm_probe_chain_groups8(int dtype, int n, long long nb, const void* mat,
                                      long long msb, long long msc, const void* vec,
                                      long long vsb, long long vsc, const void* add,
                                      long long asb, long long asc, void* out, long long osb,
                                      long long osc, int iters, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? chain8<float>(n, nb, mat, msb, msc, vec, vsb, vsc, add, asb, asc, out,
                                    osb, osc, iters, s)
                    : chain8<double>(n, nb, mat, msb, msc, vec, vsb, vsc, add, asb, asc, out,
                                     osb, osc, iters, s);
}
"""


# The staged n <= 8 determinant and solve of the measured tree taken apart
# (built only from a tree whose batched.cu has them): det_unrolled at 4 x 4,
# the unstaged expansion, where the tree's launcher stages; and, at 8 x 8
# in float32, each staged kernel's staging alone (the same copies in and
# out, no arithmetic) and its arithmetic alone (each thread fills its
# regions from its index, then the same arithmetic and output).
PROBE8 = r"""
#include "batched.cu"

namespace fm {
template <typename T>
__device__ __forceinline__ T fill(int p, int i, int j) {  // well-conditioned, pivoting
  return i == ((j + p) & 7) ? T(8) : T(((p + 3 * i + 5 * j) & 15) - 7) * T(0.0625);
}

template <int P, int kMode>  // 0: staging alone, 1: arithmetic alone
__global__ void __launch_bounds__(P)
det8_part(long long nb, TileOperand<float> in, View<float> out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int N = 8, S = staged_stride<float>(N * N);
  float* sm = reinterpret_cast<float*>(smem_raw);
  const long long b0 = blockIdx.x * (long long)P;
  const int np = nb - b0 < P ? (int)(nb - b0) : P;
  float* m = sm + threadIdx.x * S;
  if (kMode == 0) {
    tile_stage<float, false, staged_loads<float>(N * N), true>(in, b0, np, P, S, sm);
    copy_async_wait();
  } else {
    for (int q = 0; q < N * N; ++q) m[q] = fill<float>((int)threadIdx.x, q / N, q % N);
  }
  __syncthreads();
  if ((int)threadIdx.x < np) {
    float r;
    if (kMode == 0) {
      r = m[0];
#pragma unroll
      for (int q = 1; q < N * N; ++q) r += m[q];
    } else {
      r = det_one<float, N, false>([&](int i, int j) { return m[i * N + j]; });
    }
    out.p[(b0 + threadIdx.x) * out.sb] = r;
  }
}

template <int P, int kMode>
__global__ void __launch_bounds__(P) solve8_part(long long nb, int k, SolvePlan<float> plan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int N = 8, SA = staged_stride<float>(N * N);
  const int SB = staged_stride<float>(N * k);
  float* sa = reinterpret_cast<float*>(smem_raw);
  float* sb = sa + P * SA;
  const long long b0 = blockIdx.x * (long long)P;
  const int np = nb - b0 < P ? (int)(nb - b0) : P;
  float* a = sa + threadIdx.x * SA;
  float* m = sb + threadIdx.x * SB;
  if (kMode == 0) {
    tile_stage<float, false, staged_loads<float>(N * N), true>(plan.a, b0, np, P, SA, sa);
    tile_stage<float, false, staged_loads<float>(N * N), true>(plan.b, b0, np, P, SB, sb);
    copy_async_wait();
  } else {
    for (int q = 0; q < N * N; ++q) a[q] = fill<float>((int)threadIdx.x, q / N, q % N);
    for (int q = 0; q < N * k; ++q) m[q] = float(q & 3) - 1.5f;
  }
  __syncthreads();
  if (kMode == 1 && (int)threadIdx.x < np) {
    float LU[N][N], inv_d[N];
    int piv[N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) LU[i][j] = a[i * N + j];
    plu_factor<float, N>(LU, piv);
#pragma unroll
    for (int i = 0; i < N; ++i) inv_d[i] = 1.0f / LU[i][i];
    for (int c = 0; c < k; ++c) {
      float v[N], x[N];
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = m[i * k + c];
      plu_substitute<float, N>(LU, piv, inv_d, v, x);
#pragma unroll
      for (int i = 0; i < N; ++i) m[i * k + c] = x[i];
    }
  }
  __syncthreads();
  tile_store<float>(plan.out, b0, np, P, SB, sb);
}
}  // namespace fm

extern "C" int fm_probe_det4(int dtype, long long nb, const void* mat, long long msb,
                             long long msc, int log_abs, void* out, long long osb, long long osc,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned g = fm::grid_for(nb);
  if (dtype == 0) {
    const auto m = fm::mat_view<float>(mat, msb, msc, 4, 4, 0);
    const auto o = fm::view<float>(out, osb, osc);
    if (log_abs) fm::det_unrolled<float, 4, true><<<g, fm::kThreads, 0, s>>>(nb, m, o);
    else fm::det_unrolled<float, 4, false><<<g, fm::kThreads, 0, s>>>(nb, m, o);
  } else {
    const auto m = fm::mat_view<double>(mat, msb, msc, 4, 4, 0);
    const auto o = fm::view<double>(out, osb, osc);
    if (log_abs) fm::det_unrolled<double, 4, true><<<g, fm::kThreads, 0, s>>>(nb, m, o);
    else fm::det_unrolled<double, 4, false><<<g, fm::kThreads, 0, s>>>(nb, m, o);
  }
  return cudaGetLastError();
}

// mode 0: staging alone, 1: arithmetic alone; float32 8 x 8, batch-major
extern "C" int fm_probe_det8_part(int mode, long long nb, const void* mat, void* out,
                                  void* stream) {
  constexpr int P = fm::staged_threads<float>(64), S = fm::staged_stride<float>(64);
  const auto in = fm::tile_flat_operand<float>(fm::cview<float>(mat, 64, 1), 64, P, S);
  const auto o = fm::view<float>(out, 1, 1);
  const unsigned g = (unsigned)((nb + P - 1) / P);
  auto s = static_cast<cudaStream_t>(stream);
  if (mode == 0) fm::det8_part<P, 0><<<g, P, P * S * 4, s>>>(nb, in, o);
  else fm::det8_part<P, 1><<<g, P, P * S * 4, s>>>(nb, in, o);
  return cudaGetLastError();
}

extern "C" int fm_probe_solve8_part(int mode, int k, long long nb, const void* mat,
                                    const void* rhs, void* out, void* stream) {
  constexpr int P = fm::solve_staged_threads<float, 8>(), SA = fm::staged_stride<float>(64);
  const int SB = fm::staged_stride<float>(8 * k);
  const fm::SolvePlan<float> plan{
      fm::tile_flat_operand<float>(fm::cview<float>(mat, 64, 1), 64, P, SA),
      fm::tile_flat_operand<float>(fm::cview<float>(rhs, 8 * k, 1), 8 * k, P, SB),
      fm::tile_flat_out<float>(fm::view<float>(out, 8 * k, 1), 8 * k, P, SB)};
  const unsigned g = (unsigned)((nb + P - 1) / P);
  const int smem = P * (SA + SB) * 4;
  auto s = static_cast<cudaStream_t>(stream);
  if (mode == 0) fm::solve8_part<P, 0><<<g, P, smem, s>>>(nb, k, plan);
  else fm::solve8_part<P, 1><<<g, P, smem, s>>>(nb, k, plan);
  return cudaGetLastError();
}
"""


def probe8_library(_build):
    """Build PROBE8 against the measured tree's csrc into its build/chip_ab/
    and load it; None where the tree's batched.cu has no staged
    determinant."""
    if "det_staged" not in (_build.CSRC / "batched.cu").read_text():
        return None, ""
    out = pathlib.Path.cwd() / "build" / "chip_ab"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"libprobe8_{_build.library_path('batched').parent.name}.so"
    if not lib.exists():  # built once a tree
        (out / "probe8.cu").write_text(PROBE8)
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                               "-o", str(lib), str(out / "probe8.cu")], capture_output=True,
                              text=True)
        if proc.returncode:
            raise RuntimeError(f"probe8 failed to build:\n{proc.stdout}{proc.stderr}")
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    cdll = ctypes.CDLL(str(lib))
    cdll.fm_probe_det4.argtypes = [i, ll, p, ll, ll, i, p, ll, ll, p]
    cdll.fm_probe_det8_part.argtypes = [i, ll, p, p, p]
    cdll.fm_probe_solve8_part.argtypes = [i, i, ll, p, p, p, p]
    for f in (cdll.fm_probe_det4, cdll.fm_probe_det8_part, cdll.fm_probe_solve8_part):
        f.restype = i
    return cdll, lib.with_suffix(".log").read_text()


def build_probe(_build, name, source, csrc, flags=()):
    """Build ``source`` against the headers and sources in ``csrc`` into
    build/chip_ab/lib<name>.so of the working directory and load it:
    (the library, nvcc's output)."""
    out = pathlib.Path.cwd() / "build" / "chip_ab"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(source)
    lib = out / f"lib{name}.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-I", str(csrc), "-o",
                           str(lib), str(out / f"{name}.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name} failed to build:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib)), proc.stdout + proc.stderr


def tier_probe_library(_build):
    """Build TIER_PROBE against the measured tree's csrc (the working
    directory's package) and load it."""
    cdll, log = build_probe(_build, "tier_probe", TIER_PROBE, _build.CSRC)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    cdll.fm_probe_chain_groups8.argtypes = [i, i, ll, p, ll, ll, p, ll, ll, p, ll, ll, p, ll, ll,
                                            i, p]
    cdll.fm_probe_chain_groups8.restype = i
    return cdll, log


# eig_unrolled's arithmetic alone, float32 at 4 x 4 and 8 x 8, built against
# the measured tree's eig.cu: each thread makes a symmetric problem (uniform
# entries in [-1, 1) plus n on the diagonal) from its index in registers,
# runs the tree's sweeps and stores one value, the sum of its eigenvalues.
# A tree whose eig.cu has no eig_sweeps gets the loop of its eig_unrolled
# restated here. (Its staging alone is the tree's own kernel at sweeps = 0.)
EIG_PROBE = r"""
#include "eig.cu"

namespace fm {
template <int N>
__device__ __forceinline__ void eig_fill(long long b, float (&A)[N * (N + 1) / 2]) {
  unsigned h = 2654435761u * (unsigned)(b + 1);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i; j < N; ++j) {
      h = h * 1664525u + 1013904223u;
      A[up(i, j, N)] = float((int)(h >> 8) - (1 << 23)) * (1.0f / (1 << 23)) + (i == j ? N : 0);
    }
}

#ifdef FM_TREE_SWEEPS
template <int N>
__device__ __forceinline__ void probe_sweeps(float (&A)[N * (N + 1) / 2], int sweeps) {
  float V[1];
  eig_sweeps<float, N, false>(A, V, sweeps);
}
#else
template <int N>
__device__ __forceinline__ void probe_sweeps(float (&A)[N * (N + 1) / 2], int sweeps) {
  const float eps = eps_of(0.0f);
  const float tol = sum_squares<float, N>(A, true) * (16.0f * eps * eps);
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    if (!(sum_squares<float, N>(A, false) > tol)) break;
#pragma unroll
    for (int p = 0; p < N - 1; ++p)
#pragma unroll
      for (int q = p + 1; q < N; ++q) {
        const float app = A[p], aqq = A[q], apq = A[up(p, q, N)];
        float c, s;
        jacobi_rotation(app, aqq, apq, c, s);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          if (j == p || j == q) continue;
          const int kp = p < j ? up(p, j, N) : up(j, p, N);
          const int kq = q < j ? up(q, j, N) : up(j, q, N);
          const float xp = A[kp], xq = A[kq];
          A[kp] = c * xp + s * xq;
          A[kq] = c * xq - s * xp;
        }
        const float rpp = c * app + s * apq, rpq = c * apq + s * aqq;
        const float rqp = c * apq - s * app, rqq = c * aqq - s * apq;
        A[p] = c * rpp + s * rpq;
        A[q] = c * rqq - s * rqp;
        A[up(p, q, N)] = 0.0f;
      }
  }
}
#endif

template <int N>
__global__ void __launch_bounds__(128) eig_arith(long long nb, int sweeps, float* out) {
  const long long b = blockIdx.x * 128LL + threadIdx.x;
  float A[N * (N + 1) / 2];
  eig_fill<N>(b, A);
  probe_sweeps<N>(A, sweeps);
  float r = A[0];
#pragma unroll
  for (int i = 1; i < N; ++i) r += A[i];
  if (b < nb) out[b] = r;
}
}  // namespace fm

extern "C" int fm_probe_eig_arith(int n, int sweeps, long long nb, void* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned g = (unsigned)((nb + 127) / 128);
  float* o = static_cast<float*>(out);
  if (n == 4) fm::eig_arith<4><<<g, 128, 0, s>>>(nb, sweeps, o);
  else if (n == 8) fm::eig_arith<8><<<g, 128, 0, s>>>(nb, sweeps, o);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}
"""


def eig_probe_library(_build):
    """Build EIG_PROBE against the measured tree's csrc and load it."""
    flags = ["-DFM_TREE_SWEEPS"] if "eig_sweeps" in (_build.CSRC / "eig.cu").read_text() else []
    cdll, log = build_probe(_build, "eig_probe", EIG_PROBE, _build.CSRC, flags)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    cdll.fm_probe_eig_arith.argtypes = [i, i, ll, p, p]
    cdll.fm_probe_eig_arith.restype = i
    return cdll, log


def stage_copy_library(_build):
    """Build STAGE_COPY against this script's tree's tile_stage.cuh and load
    it."""
    csrc = pathlib.Path(__file__).resolve().parent / "fastmath_tpu_torch" / "kernels" / "csrc"
    cdll, log = build_probe(_build, "stage_copy", STAGE_COPY, csrc)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    cdll.fm_stage_copy.argtypes = [i, i, ll, p, ll, ll, p, ll, ll, p]
    cdll.fm_stage_copy.restype = i
    return cdll, log


# expm_warp's sizes: each block shape's edges and the bench suite's d
EXPM_WARP_DS = (9, 10, 12, 13, 16, 17, 20, 21, 24, 25, 28, 29, 31, 32)
# the rolled JtHJ tier's shapes: the bench suite's 16 x 16, the tier's edges
# and the lopsided ones
JHJ_SHAPES = ((16, 16), (7, 3), (3, 7), (16, 7), (7, 16), (32, 32))


def sass_sizes(_build, lib, kernel, opcode=None):
    """SASS instructions of each instantiation of ``kernel`` in the tree's
    built ``lib`` (``cuobjdump -sass``); with ``opcode`` (e.g. ``MUFU``),
    the instructions of that opcode instead."""
    sass = subprocess.run([str(pathlib.Path(_build.nvcc_path()).with_name("cuobjdump")), "-sass",
                           str(_build.library_path(lib))], capture_output=True, text=True).stdout
    sizes, name = {}, None
    for line in sass.splitlines():
        m = re.search(rf"Function : \S*{kernel}I([fd])((?:L[ib]\d+E)+)E", line)
        if m:
            args = [m.group(1), *re.findall(r"L[ib](\d+)E", m.group(2))]
            name = f"{kernel}<{','.join(args)}>"
        elif "Function" in line:
            name = None
        if name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line) and (
                opcode is None or re.search(rf"\b{opcode}\b", line)):
            sizes[name] = sizes.get(name, 0) + 1
    return sizes


def quartiles(xs):
    """[lower quartile, median, upper quartile] of ``xs``."""
    import statistics

    q = statistics.quantiles(xs, n=4)
    return [q[0], statistics.median(xs), q[2]]


def route_host(torch, C, res):
    """The ``route`` group: the main path's routing decision alone and its
    public call's host time, in the tree of the working directory (one
    with ``ops/_routing.py`` passes ``_route`` the size of the broadcast
    batch shape, which both trees compute for the launch, and its product
    is part of the decision)."""
    import inspect
    import math
    import timeit

    import numpy as np

    import fastmath_tpu_torch as T
    from fastmath_tpu_torch.layouts.sym import classify_layout
    from fastmath_tpu_torch.ops import sym as S

    rng = np.random.default_rng(0)
    mat = torch.from_numpy(C.compact(C.spd(rng, C.B_MAIN, C.N_MAIN))).cuda()
    vec = torch.from_numpy(rng.standard_normal((C.B_MAIN, C.N_MAIN)).astype(np.float32)).cuda()
    n = vec.shape[-1]
    layout = classify_layout(mat.shape[-1], n)
    shape = torch.broadcast_shapes(mat.shape[:-1], vec.shape[:-1])
    if "batch" in inspect.signature(S._route).parameters:
        def decide():
            return S._route("auto", layout, n, mat, "sym_solve", math.prod(shape))
    else:
        def decide():
            return S._route("auto", layout, n, mat, "sym_solve")
    if decide() != (True, True):
        raise RuntimeError(f"route: the main path's decision is {decide()}, not the kernel")
    us = [timeit.timeit(decide, number=20_000) / 20_000 * 1e6 for _ in range(20)]
    res["route decision us"] = us
    res["route decision us quartiles"] = quartiles(us)

    def call():
        return T.sym_solve(mat, vec)
    call()
    torch.cuda.synchronize()
    host = [C.host_ms(torch, call, reps=50) for _ in range(15)]
    res["sym_solve host ms"] = host
    res["sym_solve host ms quartiles"] = quartiles(host)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path.cwd()))
    import chip_smoke as C
    from fastmath_tpu_torch.kernels import _build
    from fastmath_tpu_torch.kernels import batched_cuda as BC
    from fastmath_tpu_torch.kernels import eig as KEIG
    from fastmath_tpu_torch.kernels import expm as KE
    from fastmath_tpu_torch.kernels import logm as KL
    from fastmath_tpu_torch.kernels import sym_cuda as SC
    from fastmath_tpu_torch.kernels import sym_factor as SF
    from fastmath_tpu_torch.kernels import sym_iterate as SI
    from fastmath_tpu_torch.kernels import sym_products as SP
    from fastmath_tpu_torch.layouts import full_to_sym, sym_to_full

    tag, library = sys.argv[1], "--library" in sys.argv[2:]
    groups = {"solve", "chol", "sym_solve", "matmul", "logm", "logm4", "eig", "chain", "maxeig",
              "inv8", "chol8", "expm", "chain8", "expm_warp", "jhj", "det8", "solve8",
              "syminv8", "compact8", "eig8", "route"}
    if "--only" in sys.argv:
        groups = set(sys.argv[sys.argv.index("--only") + 1].split(","))
    sources = {"solve": "batched", "chol": "batched", "sym_solve": "sym_solve",
               "matmul": "batched_products", "logm": "logm", "logm4": "logm", "eig": "eig",
               "chain": ("sym_iterate", "sym_solve"), "maxeig": "sym_iterate",
               "inv8": "batched", "chol8": "batched", "expm": "expm", "chain8": "sym_solve",
               "expm_warp": "expm", "jhj": "sym_products", "det8": "batched",
               "solve8": "batched", "syminv8": "sym_factor",
               "compact8": ("sym_solve", "sym_factor"), "eig8": "eig", "route": "sym_solve"}
    libs = sorted({lib for g in groups for lib in
                   ((sources[g],) if isinstance(sources[g], str) else sources[g])})
    _build.build_all(sorted(set(libs) | ({"expm"} if groups & {"logm", "logm4"} else set())))
    res = {"tag": tag}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def timed(key, launch, plain, lib, error=None):
        got, want = launch(), plain()
        if error is None:
            err = ((got - want).norm(dim=1) / want.norm(dim=1)).max().item()
        else:
            err = error(got, want)
        del got, want
        res[key] = [C.device_ms(torch, launch, reps=10) for _ in range(3)] + [err]
        if library and lib is not None:
            res[f"{key} library"] = C.yardstick_ms(torch, lib, key)

    for n, b, k in ((16, 500_000, 1), (24, 200_000, 1), (32, 100_000, 1), (16, 500_000, 16)):
        if "solve" not in groups:
            break
        a = C.spd_on_card(torch, gen, b, n)
        f = a.reshape(b, n * n)
        r = torch.randn(b, n * k, generator=gen, device="cuda")
        timed(f"solve {n}x{n} on {b} k={k}", lambda: BC.launch_solve_full(f, r, k),
              lambda: BC.solve_full_plain(f, r, k),
              lambda: torch.linalg.solve_ex(a, r.reshape(b, n, k)))
        if k == 1 and n in (16, 32):
            res[f"inv {n}x{n} on {b}"] = [C.device_ms(torch, lambda: BC.launch_inv(f), reps=10)
                                          for _ in range(3)]
        del a, f, r
    def digest(t):  # SHA-256 of a result's bytes, in its storage order
        t = t.t() if t.stride(0) == 1 and t.shape[1] > 1 else t
        return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]

    def cf(t):  # the channel-first copy of a (B, K) tensor, seen as (B, K)
        return t.t().contiguous().t()

    # the n <= 8 tiers on inputs seeded by shape, so that two trees get the
    # same bits: (op, n, dtype) on 1M, then the channel-first 8x8
    for op, n, dt in (("inv", 3, "f32"), ("inv", 5, "f32"), ("inv", 8, "f32"), ("inv", 8, "f64"),
                      ("chol", 3, "f32"), ("chol", 5, "f32"), ("chol", 8, "f32"),
                      ("chol", 8, "f64")):
        if f"{op}8" not in groups:
            continue
        b, dtype = 1_000_000, torch.float32 if dt == "f32" else torch.float64
        g = torch.Generator(device="cuda")
        g.manual_seed(1000 * n + (dt == "f64"))
        a = C.spd_on_card(torch, g, b, n).to(dtype)
        if op == "inv":
            x, launch, plain = a.reshape(b, n * n), BC.launch_inv, BC.inv_plain
            lib = lambda a=a: torch.linalg.inv_ex(a)  # noqa: E731
        else:
            x, launch, plain = full_to_sym(a).contiguous(), BC.launch_chol, BC.chol_plain
            lib = lambda a=a: torch.linalg.cholesky_ex(a)  # noqa: E731
        key = f"{op} {n}x{n} {dt} on {b}"
        timed(key, lambda: launch(x), lambda: plain(x), lib)
        res[f"{key} digest"] = digest(launch(x))
        if n == 8:
            xc = cf(x)
            res[f"{key} channel-first"] = [
                C.device_ms(torch, lambda: launch(xc, cf_out=True), reps=10) for _ in range(3)]
            res[f"{key} channel-first digest"] = digest(launch(xc, cf_out=True))
            del xc
        del a, x
    if "inv8" in groups:
        copy_lib, nvcc_log = stage_copy_library(_build)
        res["stage_copy ptxas"] = C.ptxas_summary(nvcc_log)
        for dt, dtype, ps in (("f32", torch.float32, (64, 128, 256)),
                              ("f64", torch.float64, (64, 128))):
            b = 1_000_000
            x = torch.randn(b, 64, generator=gen, device="cuda").to(dtype)
            y = torch.empty_like(x)
            for P in ps:
                def run(P=P):
                    err = copy_lib.fm_stage_copy(int(dt == "f64"), P, b, x.data_ptr(),
                                                 *x.stride(), y.data_ptr(), *y.stride(), stream())
                    if err:
                        raise RuntimeError(f"stage_copy P={P}: CUDA error {err}")
                run()
                if not torch.equal(x, y):
                    raise RuntimeError(f"stage_copy {dt} P={P} did not copy")
                res[f"stage_copy 8x8 {dt} on {b} P={P}"] = [C.device_ms(torch, run, reps=10)
                                                             for _ in range(3)]
            res[f"Tensor.copy_ 8x8 {dt} on {b}"] = [
                C.device_ms(torch, lambda: y.copy_(x), reps=10) for _ in range(3)]
            res[f"copy bound 8x8 {dt} on {b}"] = (2 * x.numel() * x.element_size()
                                                   / C.PEAK_BYTES * 1e3)
            del x, y
    probe8 = probe8_library(_build) if groups & {"det8", "solve8"} else (None, "")
    if probe8[1]:
        res["probe8 ptxas"] = C.ptxas_summary(probe8[1])
    probe8 = probe8[0]

    def bounds(key, nbytes, nops, dt):
        res[f"{key} bound"] = list(C.bound(nbytes, nops, "float32" if dt == "f32" else "float64"))

    # the determinant and log|det| at n = 4..8 on 1M in both dtypes, inputs
    # seeded by shape: batch-major (digest) and channel-first (digest), the
    # bound; at 4 x 4 also the unstaged expansion (PROBE8), which the
    # launcher does not take there; at 8 x 8 float32 the staging alone and
    # the arithmetic alone
    for n, dt, log in ((n, dt, log) for n in range(4, 9) for dt in ("f32", "f64")
                       for log in (False, True)):
        if "det8" not in groups:
            break
        b, dtype = 1_000_000, torch.float32 if dt == "f32" else torch.float64
        g = torch.Generator(device="cuda")
        g.manual_seed(3000 + 10 * n + (dt == "f64"))
        a = C.spd_on_card(torch, g, b, n).to(dtype)
        x, op = a.reshape(b, n * n), "logdet" if log else "det"
        launch = BC.launch_logdet if log else BC.launch_det
        plain = BC.logdet_plain if log else BC.det_plain
        lib = (lambda a=a: torch.linalg.slogdet(a)) if log else (lambda a=a: torch.linalg.det(a))

        def det_err(got, want):
            return ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()

        key = f"{op} {n}x{n} {dt} on {b}"
        timed(key, lambda: launch(x), lambda: plain(x), lib, det_err)
        res[f"{key} digest"] = digest(launch(x)[:, None])
        bounds(key, b * (n * n + 1) * x.element_size(),
               b * (C.ops_logdet(n) if log else C.ops_det(n)), dt)
        xc = cf(x)
        res[f"{key} channel-first"] = [
            C.device_ms(torch, lambda: launch(xc, cf_out=True), reps=10) for _ in range(3)]
        res[f"{key} channel-first digest"] = digest(launch(xc, cf_out=True)[:, None])
        del xc
        if n == 4 and probe8 is not None:
            y = torch.empty(b, 1, dtype=dtype, device="cuda")

            def unstaged4():
                err = probe8.fm_probe_det4(int(dt == "f64"), b, x.data_ptr(), *x.stride(),
                                           int(log), y.data_ptr(), *y.stride(), stream())
                if err:
                    raise RuntimeError(f"det_unrolled<{dt}, 4>: CUDA error {err}")
                return y[:, 0]

            timed(f"{key} det_unrolled", unstaged4, lambda: plain(x), None, det_err)
            res[f"{key} det_unrolled digest"] = digest(unstaged4()[:, None])
            del y
        if (n, dt, log) == (8, "f32", False) and probe8 is not None:
            y = torch.empty(b, dtype=dtype, device="cuda")
            for mode, part in ((0, "staging alone"), (1, "arithmetic alone")):
                def run(mode=mode):
                    err = probe8.fm_probe_det8_part(mode, b, x.data_ptr(), y.data_ptr(),
                                                    stream())
                    if err:
                        raise RuntimeError(f"det8 {part}: CUDA error {err}")
                run()
                res[f"{key} {part}"] = [C.device_ms(torch, run, reps=10) for _ in range(3)]
            del y
        del a, x
    # the solve at n = 1..8 on 1M, k = 1, 2 and n (and 8 at n <= 2: both
    # sides of the staged tier's smallest problem), A read as it is and
    # transposed, in both dtypes, inputs seeded by shape: batch-major
    # (digest), the bound; at 8 x 8 float32 also k = 9 (the first width past
    # the staged one, solve_full_unrolled in either tree), the three operands
    # channel-first at k = 1, and at k = 1 and 8 the staging alone and the
    # arithmetic alone
    for n, k, trans, dt in ((n, k, trans, dt) for n in range(1, 9)
                            for k in sorted({1, 2, n} | ({8} if n <= 2 else set()))
                            for trans in (False, True) for dt in ("f32", "f64")):
        if "solve8" not in groups:
            break
        b, dtype = 1_000_000, torch.float32 if dt == "f32" else torch.float64
        g = torch.Generator(device="cuda")
        g.manual_seed(4000 + 100 * n + 10 * k + 2 * trans + (dt == "f64"))
        a = C.spd_on_card(torch, g, b, n).to(dtype)
        f = a.reshape(b, n * n)
        ks = (k, 9) if (n, k, trans, dt) == (8, 8, False, "f32") else (k,)
        for kk in ks:
            r = torch.randn(b, n * kk, generator=g, device="cuda").to(dtype)
            am = a.mT if trans else a
            key = f"solve {n}x{n} k={kk}{' trans' if trans else ''} {dt} on {b}"
            timed(key, lambda: BC.launch_solve_full(f, r, kk, trans),
                  lambda: BC.solve_full_plain(f, r, kk, trans),
                  lambda: torch.linalg.solve_ex(am, r.reshape(b, n, kk)))
            res[f"{key} digest"] = digest(BC.launch_solve_full(f, r, kk, trans))
            bounds(key, b * (n * n + 2 * n * kk) * f.element_size(), b * C.ops_plu(n, kk), dt)
            if (n, kk, trans, dt) == (8, 1, False, "f32"):
                fc, rc = cf(f), cf(r)
                res[f"{key} channel-first"] = [
                    C.device_ms(torch, lambda: BC.launch_solve_full(fc, rc, 1, cf_out=True),
                                reps=10) for _ in range(3)]
                res[f"{key} channel-first digest"] = digest(
                    BC.launch_solve_full(fc, rc, 1, cf_out=True))
                del fc, rc
            if n == 8 and kk in (1, 8) and not trans and dt == "f32" and probe8 is not None:
                y = torch.empty_like(r)
                for mode, part in ((0, "staging alone"), (1, "arithmetic alone")):
                    def run(mode=mode, kk=kk, r=r):
                        err = probe8.fm_probe_solve8_part(mode, kk, b, f.data_ptr(),
                                                          r.data_ptr(), y.data_ptr(), stream())
                        if err:
                            raise RuntimeError(f"solve8 {part}: CUDA error {err}")
                    run()
                    res[f"{key} {part}"] = [C.device_ms(torch, run, reps=10) for _ in range(3)]
                del y
            del r
        del a, f
    for n, b in ((16, 500_000), (24, 200_000), (32, 100_000)):
        if "chol" not in groups:
            break
        a = C.spd_on_card(torch, gen, b, n)
        m = full_to_sym(a).contiguous()
        timed(f"chol {n}x{n} on {b}", lambda: BC.launch_chol(m), lambda: BC.chol_plain(m),
              lambda: torch.linalg.cholesky_ex(a))
        del a, m
    for n, b, refine in ((16, 262_144, 0), (16, 262_144, 1), (24, 131_072, 0),
                         (32, 65_536, 0)):
        if "sym_solve" not in groups:
            break
        a = C.spd_on_card(torch, gen, b, n)
        m = full_to_sym(a).contiguous()
        v = torch.randn(b, n, generator=gen, device="cuda")
        timed(f"sym_solve N={n} on {b} refine={refine}",
              lambda: SC.launch_solve(m, v, None, refine),
              lambda: SC.solve_plain(m, v, None, refine),
              lambda: torch.linalg.solve_ex(a, v[..., None]))
        del a, m, v
    for n, b in ((4, 1_000_000), (16, 500_000), (32, 100_000)):
        if "matmul" not in groups:
            break
        x, y = (torch.randn(b, n, n, generator=gen, device="cuda") for _ in range(2))
        xf, yf = x.reshape(b, -1), y.reshape(b, -1)
        timed(f"matmul {n}x{n} on {b}", lambda: BC.launch_matmul(xf, yf, n, n, n),
              lambda: BC.matmul_plain(xf, yf, n, n, n), lambda: torch.matmul(x, y))
        del x, y, xf, yf
    def chain_err(add):  # normwise over the terms: ||x - x_plain|| / (||x_plain|| + ||c||)
        return lambda got, want: ((got - want).norm(dim=1)
                                  / (want.norm(dim=1) + add.norm(dim=1))).max().item()

    for n in (9, 12, 16, 17, 24, 32):
        if "chain" not in groups:
            break
        b = 1_000_000 * 136 // (n * (n + 1) // 2)  # the bytes of 16 x 16 on 1M
        # chip_smoke.chain_input's contractions, restated for trees that predate it
        a = C.spd_on_card(torch, gen, b, n)
        m = full_to_sym(a / torch.clamp(a.abs().sum(dim=-1).amax(dim=-1) / 0.95,
                                        min=6.0 * n)[:, None, None]).contiguous()
        del a
        k = 32
        v, c = (torch.randn(b, n, generator=gen, device="cuda") for _ in range(2))
        timed(f"matvec_chain {n}x{n} k={k} on {b}", lambda: SI.launch_matvec_chain(m, v, c, k),
              lambda: SI.matvec_chain_plain(m, v, c, k), None, chain_err(c))
        del m, v, c
    for n in (9, 16, 24, 32):
        if "chain" not in groups:
            break
        b = 262_144 * 136 // (n * (n + 1) // 2)  # the bytes of N = 16 on 262,144
        m = full_to_sym(C.spd_on_card(torch, gen, b, n)).contiguous()
        v, c = (torch.randn(b, n, generator=gen, device="cuda") for _ in range(2))
        timed(f"sym_chain N={n} k=128 on {b}", lambda: SC.launch_chain(m, v, c, None, 128),
              lambda: SC.chain_plain(m, v, c, None, 128), None, chain_err(c))
        del m, v, c
    for n in (9, 12, 16, 17, 24, 32):
        if "maxeig" not in groups:
            break
        b = 1_000_000 * 136 // (n * (n + 1) // 2)  # the bytes of 16 x 16 on 1M
        m, v = C.maxeig_input(torch, gen, n, b)
        gersh = sym_to_full(m).abs().sum(dim=-1).amax(dim=-1)

        def maxeig_err(got, want):  # mu over the Gershgorin bound, v normwise
            return max(((got[:, 0] - want[:, 0]).abs() / gersh).max().item(),
                       ((got[:, 1:] - want[:, 1:]).norm(dim=1)
                        / want[:, 1:].norm(dim=1)).max().item())

        timed(f"maxeig {n}x{n} iters=32 r=8 on {b}", lambda: SI.launch_maxeig(m, v, 32, 8),
              lambda: SI.maxeig_plain(m, v, 32, 8), None, maxeig_err)
        del m, v, gersh
    logm_err = lambda got, want: C.lie_normwise(torch, got, want).max().item()  # noqa: E731
    if "logm4" in groups:
        # chip_smoke.py's 4x4 input, then the same problems sorted by their
        # (square roots, Denman-Beavers steps), so that neighbours take equal
        # steps, and a batch whose every 32 consecutive problems are one
        # problem (each warp's lanes in step); each with its mean counts
        x = torch.randn(1_000_000, 4, 4, generator=gen, device="cuda") * 0.5
        timed("expm 4x4 on 1000000", lambda: KE.launch_expm(x), lambda: KE.expm_plain(x), None,
              logm_err)  # expm_unrolled shares logm_unrolled's product
        e = KE.launch_expm(x)
        del x
        iss, db = KL.iteration_counts(e)
        order = torch.argsort(iss.long() * 4096 + db.long())
        one = torch.arange(0, 1_000_000, 32, device="cuda").repeat_interleave(32)
        for key, idx in (("logm 4x4 on 1000000", None), ("logm 4x4 sorted by counts", order),
                         ("logm 4x4 one problem a warp", one)):
            a = e if idx is None else e[idx].contiguous()
            timed(key, lambda: KL.launch_logm(a), lambda: KL.logm_plain(a), None, logm_err)
            sel = slice(None) if idx is None else idx
            res[f"{key} counts"] = [iss[sel].double().mean().item(),
                                    db[sel].double().mean().item()]
            del a
        del e, iss, db, order, one
    for d, b in C.LIE_SHAPES:
        if "logm" not in groups:
            break
        e = KE.launch_expm(torch.randn(b, d, d, generator=gen, device="cuda") * (0.5 / d ** 0.5))
        timed(f"logm {d}x{d} on {b}", lambda: KL.launch_logm(e), lambda: KL.logm_plain(e), None,
              logm_err)
        del e
    for d in (20, 21):
        if "logm" not in groups:
            break
        e = KE.launch_expm(torch.randn(15_625, d, d, generator=gen, device="cuda")
                           * (0.5 / d ** 0.5))
        timed(f"logm {d}x{d} on 15625", lambda: KL.launch_logm(e), lambda: KL.logm_plain(e),
              None, logm_err)
        del e
    if "logm" in groups:
        # 17x17 problems, and the same padded with I to 32x32: G = 32 lanes on both
        e17 = KE.launch_expm(torch.randn(15_625, 17, 17, generator=gen, device="cuda")
                             * (0.5 / 17 ** 0.5))
        e32 = torch.eye(32, device="cuda").repeat(15_625, 1, 1)
        e32[:, :17, :17] = e17
        for key, e in (("logm 17x17 on 15625", e17),
                       ("logm 32x32 on 15625 holding the 17x17 problems", e32)):
            timed(key, lambda: KL.launch_logm(e), lambda: KL.logm_plain(e), None, logm_err)
        del e17, e32
    for n, b in ((12, 200_000), (16, 200_000), (24, 100_000), (32, 100_000)):
        if "eig" not in groups:
            break
        a = C.spd_on_card(torch, gen, b, n)
        s = KEIG.sweeps_for(n)
        for vec in (False, True):
            timed(f"eig {n}x{n} on {b}{' vectors' if vec else ''}",
                  lambda: KEIG.launch_eig_full(a, True, vec, s)[0],
                  lambda: KEIG.eig_plain(a, vec, s)[0],
                  lambda: (torch.linalg.eigh if vec else torch.linalg.eigvalsh)(a),
                  lambda got, want: (got.sort(-1).values - want.sort(-1).values).abs().max().item())
        del a
    probe = tier_probe_library(_build) if "chain8" in groups else None
    if probe is not None:
        res["tier_probe ptxas"] = C.ptxas_summary(probe[1])
        probe = probe[0]
    # expm at d = 1..8 in both dtypes on the bytes of 4x4 on 1M (8x8 on
    # 250k), inputs seeded by shape: the tree's tier batch-major (digest) and
    # channel-first (digest), and at d = 4 and 8 in float32 the same
    # problems sorted by their squaring counts
    for d in range(1, 9):
        if "expm" not in groups:
            break
        for dt in ("f32", "f64"):
            dtype, b = (torch.float32 if dt == "f32" else torch.float64), 16_000_000 // (d * d)
            g = torch.Generator(device="cuda")
            g.manual_seed(7000 + 10 * d + (dt == "f64"))
            x = (torch.randn(b, d, d, generator=g, device="cuda")
                 * (0.5 if d == 4 else 0.5 / d ** 0.5)).to(dtype)
            key = f"expm {d}x{d} {dt} on {b}"
            timed(key, lambda: KE.launch_expm(x), lambda: KE.expm_plain(x), None, logm_err)
            res[f"{key} digest"] = digest(KE.launch_expm(x).reshape(b, d * d))
            s_mean = KE.squaring_counts(x[:65536]).double().mean().item()
            nops = C.ops_expm(d, s_mean, KE.taylor_order(dtype))
            res[f"{key} bound"] = list(C.bound(2 * b * d * d * x.element_size(), b * nops,
                                               "float32" if dt == "f32" else "float64"))
            res[f"{key} squarings"] = s_mean
            xc = x.reshape(b, d * d).t().contiguous().t().reshape(b, d, d)
            res[f"{key} channel-first"] = [
                C.device_ms(torch, lambda: KE.launch_expm(xc, cf_out=True), reps=10)
                for _ in range(3)]
            res[f"{key} channel-first digest"] = digest(KE.launch_expm(xc, cf_out=True)
                                                        .reshape(b, d * d))
            del xc
            if dt == "f32" and d in (4, 8):
                xs = x[torch.argsort(KE.squaring_counts(x), stable=True)].contiguous()
                res[f"{key} sorted by squarings"] = [
                    C.device_ms(torch, lambda: KE.launch_expm(xs), reps=10) for _ in range(3)]
                del xs
            del x
    # expm_warp at 9 <= d <= 32 in both dtypes on 16M values (16x16 on
    # 62,500, 32x32 on 15,625), inputs seeded by shape at the bench scale:
    # batch-major (digest), channel-first (digest), bound, mean squarings
    for d in EXPM_WARP_DS:
        if "expm_warp" not in groups:
            break
        for dt in ("f32", "f64"):
            dtype, b = (torch.float32 if dt == "f32" else torch.float64), 16_000_000 // (d * d)
            g = torch.Generator(device="cuda")
            g.manual_seed(8000 + 10 * d + (dt == "f64"))
            x = (torch.randn(b, d, d, generator=g, device="cuda") * (0.5 / d ** 0.5)).to(dtype)
            key = f"expm_warp {d}x{d} {dt} on {b}"
            timed(key, lambda: KE.launch_expm(x), lambda: KE.expm_plain(x), None, logm_err)
            res[f"{key} digest"] = digest(KE.launch_expm(x).reshape(b, d * d))
            s_mean = KE.squaring_counts(x[:65536]).double().mean().item()
            nops = C.ops_expm(d, s_mean, KE.taylor_order(dtype))
            res[f"{key} bound"] = list(C.bound(2 * b * d * d * x.element_size(), b * nops,
                                               "float32" if dt == "f32" else "float64"))
            res[f"{key} squarings"] = s_mean
            if d in (16, 32):
                xc = x.reshape(b, d * d).t().contiguous().t().reshape(b, d, d)
                res[f"{key} channel-first"] = [
                    C.device_ms(torch, lambda: KE.launch_expm(xc, cf_out=True), reps=10)
                    for _ in range(3)]
                res[f"{key} channel-first digest"] = digest(KE.launch_expm(xc, cf_out=True)
                                                            .reshape(b, d * d))
                del xc
            del x
    if "expm_warp" in groups:
        res["expm_warp sass instructions"] = sass_sizes(_build, "expm", "expm_warp")
    for group, kernel in (("det8", "det_staged"), ("det8", "det_unrolled"),
                          ("solve8", "solve_full_staged"), ("solve8", "solve_full_unrolled")):
        if group in groups:
            res[f"{kernel} sass instructions"] = sass_sizes(_build, "batched", kernel)
    # the rolled JtHJ tier (max(K, D) >= 7) in both dtypes, each shape on the
    # bytes of K = D = 16 on 200k, inputs seeded by shape: batch-major
    # (digest), the 16 x 16 float32 channel-first too, and the bound
    for k, d in JHJ_SHAPES:
        if "jhj" not in groups:
            break
        kk, dd = k * (k + 1) // 2, d * (d + 1) // 2
        b = 200_000 * (256 + 2 * 136) // (k * d + kk + dd)
        for dt in ("f32", "f64"):
            dtype = torch.float32 if dt == "f32" else torch.float64
            g = torch.Generator(device="cuda")
            g.manual_seed(6000 + 100 * k + d + 50 * (dt == "f64"))
            j = torch.randn(b, k * d, generator=g, device="cuda").to(dtype)
            h = full_to_sym(C.spd_on_card(torch, g, b, k)).contiguous().to(dtype)
            key = f"jhj K={k} D={d} {dt} on {b}"
            timed(key, lambda: SP.launch_jhj(j, h, d), lambda: SP.jhj_plain(j, h, d), None)
            res[f"{key} digest"] = digest(SP.launch_jhj(j, h, d))
            res[f"{key} bound"] = list(C.bound(b * (k * d + kk + dd) * j.element_size(),
                                               b * C.ops_jhj(k, d),
                                               "float32" if dt == "f32" else "float64"))
            if (k, d, dt) == (16, 16, "f32"):
                jc, hc = cf(j), cf(h)
                res[f"{key} channel-first"] = [
                    C.device_ms(torch, lambda: SP.launch_jhj(jc, hc, d, cf_out=True), reps=10)
                    for _ in range(3)]
                res[f"{key} channel-first digest"] = digest(SP.launch_jhj(jc, hc, d, cf_out=True))
                del jc, hc
            del j, h
    # the compact chain k = 128 at N = 5..8 on 262,144 in both dtypes (add =
    # c, no eps): the tree's tier batch-major (digest) and channel-first,
    # chain_groups<T, 8>, and the normwise error over the terms against
    # the float64 recurrence on the first 4096
    for n in range(5, 9):
        if "chain8" not in groups:
            break
        for dt in ("f32", "f64"):
            dtype, b, k = (torch.float32 if dt == "f32" else torch.float64), 262_144, 128
            g = torch.Generator(device="cuda")
            g.manual_seed(9000 + 10 * n + (dt == "f64"))
            full = C.spd_on_card(torch, g, b, n)
            m = full_to_sym(full).contiguous().to(dtype)
            v, c = (torch.randn(b, n, generator=g, device="cuda").to(dtype) for _ in range(2))
            key = f"sym_chain N={n} k={k} {dt} on {b}"
            timed(key, lambda: SC.launch_chain(m, v, c, None, k),
                  lambda: SC.chain_plain(m, v, c, None, k), None, chain_err(c))
            got = SC.launch_chain(m, v, c, None, k)
            res[f"{key} digest"] = digest(got)
            want = C.oracle_chain(full[:4096].double().cpu().numpy(), v[:4096].cpu().numpy(),
                                  c[:4096].cpu().numpy(), k)
            res[f"{key} vs f64 recurrence"] = float(C.normwise(
                got[:4096].double().cpu().numpy(), want, c[:4096].double().cpu().numpy()).max())
            nn = n * (n + 1) // 2
            res[f"{key} bound"] = list(C.bound(b * (nn + 2 * n) * m.element_size(),
                                               b * C.ops_chain_rolled(n, k),
                                               "float32" if dt == "f32" else "float64"))
            mc, vc, cc = cf(m), cf(v), cf(c)
            res[f"{key} channel-first"] = [
                C.device_ms(torch, lambda: SC.launch_chain(mc, vc, cc, None, k, cf_out=True),
                            reps=10) for _ in range(3)]
            res[f"{key} channel-first digest"] = digest(SC.launch_chain(mc, vc, cc, None, k,
                                                                        cf_out=True))
            y = torch.empty_like(v)

            def groups8():
                err = probe.fm_probe_chain_groups8(int(dt == "f64"), n, b, m.data_ptr(),
                                                   *m.stride(), v.data_ptr(), *v.stride(),
                                                   c.data_ptr(), *c.stride(), y.data_ptr(),
                                                   *y.stride(), k, stream())
                if err:
                    raise RuntimeError(f"chain_groups<{dt}, 8> N={n}: CUDA error {err}")
                return y

            timed(f"{key} chain_groups8", groups8, lambda: SC.chain_plain(m, v, c, None, k),
                  None, chain_err(c))
            del full, m, v, c, mc, vc, cc, got, y
    # the compact inverse at N = 1..8 on 1M in both dtypes, inputs seeded by
    # shape: batch-major (digest), channel-first in and out (digest), the
    # bound; at N = 4 and 8 in float32 also channel-first in and batch-major
    # out (the determinant's gradient)
    for n, dt in ((n, dt) for n in range(1, 9) for dt in ("f32", "f64")):
        if "syminv8" not in groups:
            break
        b, dtype = 1_000_000, torch.float32 if dt == "f32" else torch.float64
        g = torch.Generator(device="cuda")
        g.manual_seed(12000 + 10 * n + (dt == "f64"))
        a = C.spd_on_card(torch, g, b, n).to(dtype)
        m = full_to_sym(a).contiguous()
        key = f"sym_invert N={n} {dt} on {b}"
        timed(key, lambda: SF.launch_sym_invert(m), lambda: SF.invert_plain(m),
              lambda a=a: torch.linalg.inv_ex(a))
        res[f"{key} digest"] = digest(SF.launch_sym_invert(m))
        nn = n * (n + 1) // 2
        bounds(key, 2 * b * nn * m.element_size(), b * C.ops_sym_invert(n), dt)
        mc = cf(m)
        res[f"{key} channel-first"] = [
            C.device_ms(torch, lambda: SF.launch_sym_invert(mc, cf_out=True), reps=10)
            for _ in range(3)]
        res[f"{key} channel-first digest"] = digest(SF.launch_sym_invert(mc, cf_out=True))
        if dt == "f32" and n in (4, 8):
            res[f"{key} channel-first in"] = [
                C.device_ms(torch, lambda: SF.launch_sym_invert(mc), reps=10) for _ in range(3)]
            res[f"{key} channel-first in digest"] = digest(SF.launch_sym_invert(mc))
        del a, m, mc
    # the compact solve (no refinement) and determinant at N = 5..8 on
    # 262,144 and on 1M in float32, with their bounds: the one-thread tiers
    # that chip_smoke.py does not time (262,144 problems' bytes stay in the
    # 50 MB L2 from one launch to the next; 1M problems' do not)
    for n, b in ((n, b) for b in (262_144, 1_000_000) for n in range(5, 9)):
        if "compact8" not in groups:
            break
        g = torch.Generator(device="cuda")
        g.manual_seed(13000 + n)
        a = C.spd_on_card(torch, g, b, n)
        m = full_to_sym(a).contiguous()
        v = torch.randn(b, n, generator=g, device="cuda")
        nn = n * (n + 1) // 2
        key = f"sym_solve N={n} on {b}"
        timed(key, lambda: SC.launch_solve(m, v, None, 0), lambda: SC.solve_plain(m, v, None, 0),
              lambda a=a, v=v: torch.linalg.solve_ex(a, v[..., None]))
        bounds(key, b * (nn + 2 * n) * 4, b * C.ops_sym_solve(n, 0), "f32")
        key = f"sym_det N={n} on {b}"
        timed(key, lambda: SF.launch_sym_det(m), lambda: SF.sym_det_plain(m),
              lambda a=a: torch.linalg.det(a),
              lambda got, want: ((got - want).abs() / want.abs()).max().item())
        bounds(key, b * (nn + 1) * 4, b * C.ops_det(n), "f32")
        del a, m, v
    # eig_unrolled at n = 2..8 in both dtypes, values and vectors, on the
    # bytes of 4x4 on 1M, inputs seeded by shape: batch-major full storage
    # (digests) and channel-first compact (digests), the largest eigenvalue
    # difference from the plain version over ||A||_F, the bound with its
    # special-function part, the mean sweeps and the mean of each warp's
    # largest (32 neighbours, from the plain version on 65,536 problems); at
    # 4x4 and 8x8 float32 also the problems sorted by their sweeps (each
    # warp's problems sweep alike), the staging alone and the arithmetic
    # alone (EIG_PROBE)
    eprobe = eig_probe_library(_build) if "eig8" in groups else None
    if eprobe is not None:
        res["eig_probe ptxas"] = [r for r in C.ptxas_summary(eprobe[1]) if "eig_arith" in r]
        eprobe = eprobe[0]
    for n, dt in ((n, dt) for n in range(2, 9) for dt in ("f32", "f64")):
        if "eig8" not in groups:
            break
        b, dtype = 16_000_000 // (n * n), torch.float32 if dt == "f32" else torch.float64
        g = torch.Generator(device="cuda")
        g.manual_seed(11000 + 10 * n + (dt == "f64"))
        a = C.spd_on_card(torch, g, b, n).to(dtype)
        fro = torch.linalg.matrix_norm(a)
        sweeps = KEIG.sweeps_for(n)
        ran = KEIG.sweep_counts(a[:65536], sweeps)
        mean_sweeps = ran.double().mean().item()
        res[f"eig {n}x{n} {dt} sweeps (mean, mean of warp max)"] = [
            mean_sweeps, ran.view(-1, 32).amax(dim=1).double().mean().item()]
        del ran

        def eig_err(got, want):  # sorted eigenvalues over ||A||_F
            return ((got.sort(-1).values - want.sort(-1).values).abs().amax(-1)
                    / fro).max().item()

        m = full_to_sym(a).contiguous()
        mc = cf(m)
        for vec in (False, True):
            key = f"eig {n}x{n}{' vectors' if vec else ''} {dt} on {b}"
            timed(key, lambda: KEIG.launch_eig_full(a, True, vec, sweeps)[0],
                  lambda: KEIG.eig_plain(a, vec, sweeps)[0], None, eig_err)
            if library:
                res[f"{key} library"] = C.library_eig_ms(torch, a, vec)
            w, u = KEIG.launch_eig_full(a, True, vec, sweeps)
            res[f"{key} digest"] = [digest(w)] + ([digest(u.reshape(b, n * n))] if vec else [])
            rot = mean_sweeps * n * (n - 1) / 2
            bounds(key, b * (n * n + n + (n * n if vec else 0)) * a.element_size(),
                   b * C.ops_eig(n, vec, mean_sweeps), dt)
            # two special-function operations a rotation at the least (the
            # square roots of the tangent's hypotenuse and of the half angle),
            # at 16 a clock an SM against 128 float32 lanes' 2 operations
            res[f"{key} special-function bound"] = 2 * b * rot / (C.PEAK_OPS["float32"] / 16) * 1e3
            res[f"{key} channel-first"] = [
                C.device_ms(torch, lambda: KEIG.launch_eig_compact(mc, n, vec, sweeps, True),
                            reps=10) for _ in range(3)]
            w, u = KEIG.launch_eig_compact(mc, n, vec, sweeps, True)
            res[f"{key} channel-first digest"] = [digest(w)] + ([digest(u)] if vec else [])
            del w, u
        if dt == "f32" and n in (4, 8):
            order = torch.argsort(KEIG.sweep_counts(a, sweeps), stable=True)
            a_s = a[order].contiguous()
            res[f"eig {n}x{n} {dt} on {b} sorted by sweeps"] = [
                C.device_ms(torch, lambda: KEIG.launch_eig_full(a_s, True, False, sweeps),
                            reps=10) for _ in range(3)]
            del a_s, order
            res[f"eig {n}x{n} {dt} on {b} staging alone"] = [
                C.device_ms(torch, lambda: KEIG.launch_eig_full(a, True, False, 0), reps=10)
                for _ in range(3)]
            y = torch.empty(b, dtype=dtype, device="cuda")

            def arith():
                err = eprobe.fm_probe_eig_arith(n, sweeps, b, y.data_ptr(), stream())
                if err:
                    raise RuntimeError(f"eig {n}x{n} arithmetic alone: CUDA error {err}")
            arith()
            res[f"eig {n}x{n} {dt} on {b} arithmetic alone"] = [C.device_ms(torch, arith, reps=10)
                                                                for _ in range(3)]
            del y
        del a, fro, m, mc
    if "route" in groups:
        route_host(torch, C, res)
    if "eig8" in groups:
        res["eig_unrolled sass instructions"] = sass_sizes(_build, "eig", "eig_unrolled")
        res["eig_unrolled MUFU instructions"] = sass_sizes(_build, "eig", "eig_unrolled", "MUFU")
    unrolled = ("logm_unrolled",) + (("inv_unrolled",) if "inv8" in groups else ()) + (
        ("det_unrolled",) if "det8" in groups else ()) + (
        ("solve_full_unrolled",) if "solve8" in groups else ()) + (
        ("chol_unrolled",) if "chol8" in groups else ()) + (
        ("expm_unrolled",) if "expm" in groups else ()) + (
        ("chain_unrolled",) if "chain8" in groups else ()) + (
        ("sym_invert_unrolled",) if "syminv8" in groups else ()) + (
        ("eig_unrolled",) if "eig8" in groups else ())
    res["ptxas"] = [row for lib in libs
                    for row in C.ptxas_summary(_build.build_log(lib).read_text())
                    if "unrolled" not in row or row.startswith(unrolled)]
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
