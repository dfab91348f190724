// Staged tiles: a block of P problems moves its operands between device
// memory and shared memory in order, so that the threads that work on them
// never touch device memory one problem at a time (batched_products.cu:
// matmul_tiles; batched.cu: the n <= 8 inverse, Cholesky, determinant and
// solve tiers; sym_factor.cu: the compact inverse at N <= 8; expm.cu:
// expm_unrolled; sym_solve.cu: the compact chain at 5 <= N <= 8;
// sym_products.cu: jhj_tiles).
//
// Each problem owns a region of S values in shared memory. The block reads
// each operand into the regions (tile_stage) and writes each result out of
// them (tile_store) in one of three orders, picked from the strides:
//   - a contiguous batch-major operand at a 16-byte boundary: 16-byte
//     vectors, each thread issuing kU loads before it stores any, so that
//     enough bytes are in flight to cover the latency;
//   - a channel-first operand (batch stride 1): batch-fastest, the block's
//     problems neighbours in each channel;
//   - any other strides: element by element, problem-major.
// Either way the block reads and writes device memory in order.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "sym_common.cuh"

namespace fm {

// x / d for 0 <= x, x d < 2^32, d fixed at launch: the high word of x times
// 2^32 / d rounded up (exact in that range), and x itself for d = 1.
struct FastDiv {
  unsigned d, mul;
};

inline FastDiv fast_div(int d) {
  return {(unsigned)d, d == 1 ? 0u : (unsigned)(((1ull << 32) + d - 1) / d)};
}

__device__ __forceinline__ int fdiv(int x, FastDiv f) {
  return f.d == 1 ? x : (int)__umulhi((unsigned)x, f.mul);
}

// 16 bytes of T, moved as one access.
template <typename T>
struct alignas(16) TileVec {
  T v[16 / sizeof(T)];
};

// Where the values of one 16-byte vector of a batch-major operand sit in
// shared memory: whole at a 16-byte boundary (one vector access), in one
// contiguous run at any boundary (one scalar access each), or apart (each
// at its own row and column).
enum TileLand : unsigned char { kLandWhole, kLandRun, kLandApart };

// One operand as the block stages it: raw storage in rows * cols channels
// of `v` (row-major, or, if trans, the transpose of a cols x rows matrix),
// staged as the rows x cols matrix at row stride ld, at offset `off` of
// each problem's region.
template <typename T>
struct TileOperand {
  View<const T> v;
  int size, ld, off;
  bool trans, batch_fastest, vec;
  TileLand land;       // where a vector's values sit, if vec
  FastDiv inner, per;  // raw row length; size, or problems a block if batch_fastest
};

// One result as the block writes it: the first `size` values of each
// problem's region, in order, go to `size` channels of `v`.
template <typename T>
struct TileOut {
  View<T> v;
  int size;
  bool batch_fastest, vec;
  TileLand land;  // where a vector's values sit, if vec
  FastDiv per;    // size, or problems a block if batch_fastest
};

// Whether an operand of `size` channels is contiguous batch-major at a
// 16-byte boundary with P a whole number of vectors' worth of problems,
// so that each block's range starts aligned: it is then moved in vectors.
template <typename T>
inline bool tile_vec(const void* p, long long sb, long long sc, int size, int P) {
  constexpr int kW = 16 / (int)sizeof(T);
  return sc == 1 && sb == size && P * size % kW == 0 && (uintptr_t)p % 16 == 0;
}

// Where a vector of `size`-value problems, each kept in one run at region
// stride S, sits in shared memory: whole where the regions are packed (S =
// size: the block's range is copied as it is) or the runs and regions are
// whole vectors; in a run where a vector stays in one problem.
template <typename T>
inline TileLand tile_flat_land(int size, int S) {
  constexpr int kW = 16 / (int)sizeof(T);
  if (S == size || (size % kW == 0 && S % kW == 0)) return kLandWhole;
  return size % kW == 0 ? kLandRun : kLandApart;
}

// An operand of `size` channels that each problem keeps in one run of its
// region (row-major, untransposed) at region stride S.
template <typename T>
TileOperand<T> tile_flat_operand(View<const T> v, int size, int P, int S) {
  const bool bf = v.sb == 1 && size > 1, vec = tile_vec<T>(v.p, v.sb, v.sc, size, P);
  return {v, size, size, 0, false, bf, vec, tile_flat_land<T>(size, S), fast_div(size),
          fast_div(bf ? P : size)};
}

// A result of `size` channels, each problem's in the first run of its
// region at region stride S.
template <typename T>
TileOut<T> tile_flat_out(View<T> v, int size, int P, int S) {
  const bool vec = tile_vec<T>(v.p, v.sb, v.sc, size, P);
  const bool bf = !vec && v.sb == 1 && size > 1;
  return {v, size, bf, vec, tile_flat_land<T>(size, S), fast_div(bf ? P : size)};
}

// Stage operand `o` of problems b0 .. b0 + np - 1 into the regions (S
// values each) of `sm`. Entry e of the block's range is problem p's raw
// value q, problem-major or, for a channel-first operand, batch-fastest.
// kU: the vectors a thread loads before it stores any. kOwn: a
// channel-first flat operand (tile_flat_operand, batch_fastest) of one
// problem a thread: each thread reads its own problem channel by channel
// (the warp's threads neighbours in each channel), with no division.
// kAsync: vectors that land whole are copied with copy_async, every one of
// a thread's in flight at once; the caller then calls copy_async_wait
// before its barrier.
template <typename T, bool kOwn = false, int kU = 8, bool kAsync = false>
__device__ __forceinline__ void tile_stage(const TileOperand<T>& o, long long b0, int np, int P,
                                           int S, T* sm) {
  constexpr int kW = 16 / (int)sizeof(T);
  using V = TileVec<T>;
  const int inner = (int)o.inner.d;
  auto at = [&](int p, int q1, int q2) {  // the staged slot of raw row q1, column q2
    return sm + p * S + o.off + (o.trans ? q2 * o.ld + q1 : q1 * o.ld + q2);
  };
  auto put = [&](int p, int q, T x) {
    const int q1 = fdiv(q, o.inner);
    *at(p, q1, q - q1 * inner) = x;
  };
  if constexpr (kOwn) {
    constexpr int kC = 8;  // channels in flight
    if ((int)threadIdx.x < np) {
      const T* src = o.v.p + b0 + threadIdx.x;
      T* dst = sm + threadIdx.x * S;
      for (int q0 = 0; q0 < o.size; q0 += kC) {
        T x[kC];
#pragma unroll
        for (int c = 0; c < kC; ++c)
          if (q0 + c < o.size) x[c] = src[(q0 + c) * o.v.sc];
#pragma unroll
        for (int c = 0; c < kC; ++c)
          if (q0 + c < o.size) dst[q0 + c] = x[c];
      }
    }
    return;
  }
  if (o.vec) {
    const T* base = o.v.p + b0 * o.size;
    const int total = np * o.size, nv = total / kW;
    const V* src = reinterpret_cast<const V*>(base);
    if (kAsync && o.land == kLandWhole) {
      for (int v = threadIdx.x; v < nv; v += blockDim.x) {
        const int e = v * kW, p = fdiv(e, o.per), q = e - p * o.size, q1 = fdiv(q, o.inner);
        copy_async(reinterpret_cast<V*>(at(p, q1, q - q1 * inner)), src + v);
      }
    } else {
      for (int e0 = threadIdx.x; e0 < nv; e0 += kU * blockDim.x) {
        V x[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u)
          if (e0 + u * (int)blockDim.x < nv) x[u] = src[e0 + u * blockDim.x];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (e0 + u * (int)blockDim.x < nv) {
            // the vector's first value by division, the next ones by steps
            const int e = (e0 + u * blockDim.x) * kW;
            int p = fdiv(e, o.per), q = e - p * o.size;
            int q1 = fdiv(q, o.inner), q2 = q - q1 * inner;
            if (o.land == kLandWhole) {
              *reinterpret_cast<V*>(at(p, q1, q2)) = x[u];
              continue;
            }
            if (o.land == kLandRun) {
              T* d = at(p, q1, q2);
#pragma unroll
              for (int c = 0; c < kW; ++c) d[c] = x[u].v[c];
              continue;
            }
#pragma unroll
            for (int c = 0; c < kW; ++c) {
              *at(p, q1, q2) = x[u].v[c];
              if (++q2 == inner) {
                q2 = 0;
                ++q1;
              }
              if (++q == o.size) {
                q = q1 = q2 = 0;
                ++p;
              }
            }
          }
        }
      }
    }
    for (int e = nv * kW + threadIdx.x; e < total; e += blockDim.x) {  // the last block's tail
      const int p = fdiv(e, o.per);
      put(p, e - p * o.size, base[e]);
    }
    return;
  }
  const int total = (o.batch_fastest ? P : np) * o.size;
  for (int e0 = threadIdx.x; e0 < total; e0 += kU * blockDim.x) {
    T x[kU];
    int pu[kU], qu[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * blockDim.x;
      if (o.batch_fastest) {
        qu[u] = fdiv(e, o.per);
        pu[u] = e - qu[u] * P;
      } else {
        pu[u] = fdiv(e, o.per);
        qu[u] = e - pu[u] * o.size;
      }
      if (e < total && pu[u] < np) x[u] = o.v.p[(b0 + pu[u]) * o.v.sb + qu[u] * o.v.sc];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (e0 + u * (int)blockDim.x < total && pu[u] < np) put(pu[u], qu[u], x[u]);
  }
}

// Write result `o` of problems b0 .. b0 + np - 1 from the regions of `sm`:
// the counterpart of tile_stage, in the same three orders (kOwn the same).
template <typename T, bool kOwn = false>
__device__ __forceinline__ void tile_store(const TileOut<T>& o, long long b0, int np, int P,
                                           int S, const T* sm) {
  constexpr int kW = 16 / (int)sizeof(T);
  const int size = o.size;
  if constexpr (kOwn) {
    if ((int)threadIdx.x < np) {
      T* dst = o.v.p + b0 + threadIdx.x;
      const T* src = sm + threadIdx.x * S;
      for (int q = 0; q < size; ++q) dst[q * o.v.sc] = src[q];
    }
    return;
  }
  if (o.vec) {
    using V = TileVec<T>;
    T* base = o.v.p + b0 * size;
    const int total = np * size, nv = total / kW;
    for (int v = threadIdx.x; v < nv; v += blockDim.x) {
      V x;
      int pp = fdiv(v * kW, o.per), q = v * kW - pp * size;
      if (o.land == kLandWhole) {
        reinterpret_cast<V*>(base)[v] = *reinterpret_cast<const V*>(sm + pp * S + q);
        continue;
      }
      if (o.land == kLandRun) {
#pragma unroll
        for (int c = 0; c < kW; ++c) x.v[c] = sm[pp * S + q + c];
      } else {
#pragma unroll
        for (int c = 0; c < kW; ++c) {
          x.v[c] = sm[pp * S + q];
          if (++q == size) {
            q = 0;
            ++pp;
          }
        }
      }
      reinterpret_cast<V*>(base)[v] = x;
    }
    for (int e = nv * kW + threadIdx.x; e < total; e += blockDim.x) {
      const int pp = fdiv(e, o.per);
      base[e] = sm[pp * S + e - pp * size];
    }
    return;
  }
  const int total = (o.batch_fastest ? P : np) * size;
#pragma unroll 4
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    int pp, q;
    if (o.batch_fastest) {
      q = fdiv(e, o.per);
      pp = e - q * P;
      if (pp >= np) continue;
    } else {
      pp = fdiv(e, o.per);
      q = e - pp * size;
    }
    o.v.p[(b0 + pp) * o.v.sb + q * o.v.sc] = sm[pp * S + q];
  }
}

// The one-thread-a-problem tiers that stage their problems here (batched.cu:
// the n <= 8 inverse, Cholesky, determinant and solve; sym_factor.cu: the
// compact inverse at N <= 8; expm.cu: expm_unrolled; sym_solve.cu:
// chain_inverse at 5 <= N <= 8): a block of P problems, one thread each,
// each problem's `size` values kept in one run of its region. Where a
// problem is whole 16-byte vectors the region stride is size + 1, odd, so
// that the 32 threads of a warp reading entry j of their own problems hit
// 32 different banks; otherwise the regions are packed (stride size: odd,
// or at most two threads a bank), and the block's range is copied as it
// is. P is 128, or 64 where 128 regions would pass 48 KB (float64 regions
// of 49 or 65 values), a multiple of the vector width, so that each block's range of a
// contiguous operand starts aligned. Each thread loads as many vectors at
// once as its share of the block's range holds, up to 8: no registers
// wait for vectors that small problems never bring.
template <typename T>
__host__ __device__ constexpr int staged_stride(int size) {
  return size % (16 / (int)sizeof(T)) == 0 ? size + 1 : size;
}

template <typename T>
constexpr int staged_threads(int size) {
  return 128 * staged_stride<T>(size) * (int)sizeof(T) <= 48 * 1024 ? 128 : 64;
}

template <typename T>
__host__ __device__ constexpr int staged_loads(int size) {
  const int kW = 16 / (int)sizeof(T), u = (size + kW - 1) / kW;
  return u < 8 ? u : 8;
}

// The operand and result of a one-thread-a-problem staged tier (batched.cu:
// inv_unrolled, chol_unrolled; sym_factor.cu: sym_invert_staged).
template <typename T>
struct StagedPlan {
  TileOperand<T> in;
  TileOut<T> out;
};

}  // namespace fm
