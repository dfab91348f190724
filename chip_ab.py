#!/usr/bin/env python3
"""Time one source tree's full-storage solve, Cholesky, inverse, compact
solve, product, matrix logarithm, rolled eig, chain and power-iteration
kernels, the n <= 8 inverse and Cholesky tiers, the matrix exponential
(both tiers), the 5 <= N <= 8 compact chain and the rolled JtHJ tier, on
one NVIDIA GPU, to compare two versions of a kernel in one call.

    python3 /path/to/chip_ab.py TAG [--library] [--only GROUP[,GROUP...]]

Run it from the root of the tree to time (its ``chip_smoke.py`` and
``fastmath_tpu_torch`` are imported from the working directory), once for
each tree in turns (old, new, new, old). It builds the sources of the
groups it times, times each kernel three times with
``chip_smoke.device_ms`` at the bench suite's shapes, holds each result
against its plain version, and prints one JSON line: ``tag``, each
shape's three times and error, and the registers and spills (``-Xptxas
-v``) of every kernel of those sources but the unrolled tiers (except
``logm_unrolled``, and the inverse's, Cholesky's, expm's and the chain's
with ``inv8``, ``chol8``, ``expm`` and ``chain8``). The groups (all by
default): ``solve``
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
the solve's n <= 8 tier at 8x8 on 1M with one column; then the staging's
ceiling, ``stage_copy``: ``csrc/tile_stage.cuh`` of the
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
with its bound, 16x16 float32 channel-first too). ``inv8``, ``chol8``,
``expm``, ``chain8``, ``expm_warp`` and ``jhj`` also give each output's
digest (SHA-256 of its bytes), so that two trees' outputs compare bit for
bit, and their tiers' registers. ``--library`` also times
``torch.linalg.solve_ex`` /
``cholesky_ex`` (the compact solve's on the densified batch),
``inv_ex``, ``torch.matmul`` and ``eigvalsh`` / ``eigh`` on the same
inputs. It imports neither JAX nor ``fastmath_tpu``.
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


def tier_probe_library(_build):
    """Build TIER_PROBE against the measured tree's csrc (the working
    directory's package) into its build/chip_ab/ and load it."""
    out = pathlib.Path.cwd() / "build" / "chip_ab"
    out.mkdir(parents=True, exist_ok=True)
    (out / "tier_probe.cu").write_text(TIER_PROBE)
    lib = out / "libtier_probe.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                           str(lib), str(out / "tier_probe.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"tier_probe failed to build:\n{proc.stdout}{proc.stderr}")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    cdll = ctypes.CDLL(str(lib))
    cdll.fm_probe_chain_groups8.argtypes = [i, i, ll, p, ll, ll, p, ll, ll, p, ll, ll, p, ll, ll,
                                            i, p]
    cdll.fm_probe_chain_groups8.restype = i
    return cdll, proc.stdout + proc.stderr


def stage_copy_library(_build):
    """Build STAGE_COPY against this script's tree's tile_stage.cuh into
    build/chip_ab/ of the working directory and load it."""
    csrc = pathlib.Path(__file__).resolve().parent / "fastmath_tpu_torch" / "kernels" / "csrc"
    out = pathlib.Path.cwd() / "build" / "chip_ab"
    out.mkdir(parents=True, exist_ok=True)
    (out / "stage_copy.cu").write_text(STAGE_COPY)
    lib = out / "libstage_copy.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
                           str(lib), str(out / "stage_copy.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"stage_copy failed to build:\n{proc.stdout}{proc.stderr}")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    cdll = ctypes.CDLL(str(lib))
    cdll.fm_stage_copy.argtypes = [i, i, ll, p, ll, ll, p, ll, ll, p]
    cdll.fm_stage_copy.restype = i
    return cdll, proc.stdout + proc.stderr


# expm_warp's sizes: each block shape's edges and the bench suite's d
EXPM_WARP_DS = (9, 10, 12, 13, 16, 17, 20, 21, 24, 25, 28, 29, 31, 32)
# the rolled JtHJ tier's shapes: the bench suite's 16 x 16, the tier's edges
# and the lopsided ones
JHJ_SHAPES = ((16, 16), (7, 3), (3, 7), (16, 7), (7, 16), (32, 32))


def sass_sizes(_build, lib, kernel):
    """SASS instructions of each instantiation of ``kernel`` in the tree's
    built ``lib`` (``cuobjdump -sass``)."""
    sass = subprocess.run([str(pathlib.Path(_build.nvcc_path()).with_name("cuobjdump")), "-sass",
                           str(_build.library_path(lib))], capture_output=True, text=True).stdout
    sizes, name = {}, None
    for line in sass.splitlines():
        m = re.search(rf"Function : \S*{kernel}I([fd])((?:Li\d+E)+)E", line)
        if m:
            args = [m.group(1), *re.findall(r"Li(\d+)E", m.group(2))]
            name = f"{kernel}<{','.join(args)}>"
        elif "Function" in line:
            name = None
        if name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            sizes[name] = sizes.get(name, 0) + 1
    return sizes


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
    from fastmath_tpu_torch.kernels import sym_iterate as SI
    from fastmath_tpu_torch.kernels import sym_products as SP
    from fastmath_tpu_torch.layouts import full_to_sym, sym_to_full

    tag, library = sys.argv[1], "--library" in sys.argv[2:]
    groups = {"solve", "chol", "sym_solve", "matmul", "logm", "logm4", "eig", "chain", "maxeig",
              "inv8", "chol8", "expm", "chain8", "expm_warp", "jhj"}
    if "--only" in sys.argv:
        groups = set(sys.argv[sys.argv.index("--only") + 1].split(","))
    sources = {"solve": "batched", "chol": "batched", "sym_solve": "sym_solve",
               "matmul": "batched_products", "logm": "logm", "logm4": "logm", "eig": "eig",
               "chain": ("sym_iterate", "sym_solve"), "maxeig": "sym_iterate",
               "inv8": "batched", "chol8": "batched", "expm": "expm", "chain8": "sym_solve",
               "expm_warp": "expm", "jhj": "sym_products"}
    libs = sorted({lib for g in groups for lib in
                   ((sources[g],) if isinstance(sources[g], str) else sources[g])})
    _build.build_all(sorted(set(libs) | ({"expm"} if groups & {"logm", "logm4"} else set())))
    res = {"tag": tag}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

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
        # the solve's n <= 8 tier, not staged: one column at 8x8 on 1M
        b, n = 1_000_000, 8
        a = C.spd_on_card(torch, gen, b, n)
        f, r = a.reshape(b, n * n), torch.randn(b, n, generator=gen, device="cuda")
        timed(f"solve {n}x{n} k=1 f32 on {b}", lambda: BC.launch_solve_full(f, r, 1),
              lambda: BC.solve_full_plain(f, r, 1),
              lambda: torch.linalg.solve_ex(a, r.reshape(b, n, 1)))
        del a, f, r
        copy_lib, nvcc_log = stage_copy_library(_build)
        res["stage_copy ptxas"] = C.ptxas_summary(nvcc_log)
        for dt, dtype, ps in (("f32", torch.float32, (64, 128, 256)),
                              ("f64", torch.float64, (64, 128))):
            b = 1_000_000
            x = torch.randn(b, 64, generator=gen, device="cuda").to(dtype)
            y = torch.empty_like(x)
            stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
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
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
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
    unrolled = ("logm_unrolled",) + (("inv_unrolled",) if "inv8" in groups else ()) + (
        ("chol_unrolled",) if "chol8" in groups else ()) + (
        ("expm_unrolled",) if "expm" in groups else ()) + (
        ("chain_unrolled",) if "chain8" in groups else ())
    res["ptxas"] = [row for lib in libs
                    for row in C.ptxas_summary(_build.build_log(lib).read_text())
                    if "unrolled" not in row or row.startswith(unrolled)]
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
