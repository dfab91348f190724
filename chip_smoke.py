#!/usr/bin/env python3
"""Drive the PyTorch port (``fastmath_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``fastmath_tpu_torch/kernels/csrc``
(``nvcc``, into ``build/``), then runs, each phase failing the run:

1. device: the card's name and power limit, the build time and each
   kernel's registers and spills (``-Xptxas -v``; the full log goes to
   ``chiprun_out/chip_smoke/``);
2. every kernel against its plain PyTorch version on the card, at every
   tier (N = 1 .. 32; JᵀHJ at K, D up to 32), float32 and float64, with
   and without ``eps``, ``refine`` 0..2, on a ragged batch, in the
   batch-major and the channel-first layout, and against a float64 numpy
   oracle (the compact solve also at N = 12, 17 and 24, the edges of its
   lane groups); the full-storage solve (k = 1, 3, 8 columns up to n = 8, 1, 16,
   17 and 40 above, also reading A transposed) and inverse (n = 1..8, 12, 17
   and 24) on general matrices that pivot at most steps and on SPD
   matrices; the determinant,
   log-determinant, Cholesky, compact determinant and compact inverse
   (n = 1..8, and 12, 17 and 24, the edges of the lane-group tiers);
   the matvec chain (iters 0, 1, 7, with and without ``add``), the power
   iteration (iters 0, 5, 32; ``renorm_every`` 1, 8, 16; both also at n =
   12, 17 and 24), the full matvec
   (also reading A transposed) and the product (every pair of transposed
   reads, m, k, n up to 32, the edges of its tiers and tiles); the Jacobi eigendecomposition (both tiers,
   n = 4..32, values and vectors: sorted eigenvalues, U diag(w) Uᵀ and
   UᵀU - I) and a mixed-scale block against float64 numpy; expm and logm
   (both tiers of each, d = 1..32, float32 and float64, batch-major and
   channel-first bit for bit, on the bench scale, on skew-symmetric input
   of spectral radius 128 and on rotations by up to 0.9 pi, and against
   float64 scipy; logm's NaN on exactly the on-cut problems of a batch);
3. gradients of ``sym_solve``, ``sym_solve_chain``, the products,
   ``batchinv``, ``batchlmdiv``, ``batchdet``, ``batchlogdet``,
   ``batchchol``, ``sym_det``, ``sym_invert``, ``sym_matvec_chain``,
   ``sym_maxeig``, ``batchmatvec``, ``batchmatmul``, ``eig_sym``, ``expm``
   and ``logm`` through
   the kernels against the same through the plain versions (``eig_sym``
   also against central differences on gapped spectra) (the compact solve
   kernel up to N = 24, the matvec kernel, the full-storage solve kernel
   reading A transposed, the inverse kernel, the compact
   inverse kernel, the chain kernel, the full matvec kernel reading A
   transposed, the product kernel and, while 2d <= 32, the expm and logm
   kernels must launch in the backward);
4. the solve's main path at full size: the public ``sym_solve`` on a 1M
   batch of 4x4 float32 compact SPD matrices made as ``bench.py`` makes
   them, and ``sym_solve_chain`` with k = 128 on the same batch; launch
   counts, normwise error against float64 numpy, solves/s; then the
   solve at N = 8 and 16 on 262,144 (N = 16 also with ``refine=1``) and
   N = 32 on 65,536, each beside its bound, its plain version and
   ``torch.linalg.solve_ex`` on the densified batch, and the chain at N =
   8 and 16 beside its bound;
5. the products' path at full size (``bench/suite.py``'s shapes): the
   public ``sym_matvec``, ``sym_addmatvec``, ``sym_submatvec`` and
   ``sym_outer`` on that batch, ``sym_matmul`` JᵀHJ at K = D = 16 on
   200,000 problems, and one Gauss-Newton step on the 1M batch
   (H = JᵀWJ + g gᵀ, δ = H \\ g, r = g - H δ); launch counts, normwise
   error against float64 numpy, kernel, plain and library times, and the
   step's device time beside each of its launches alone;
6. the batched path at the bench suite's shapes (float32, a a^T + n I):
   the public ``batchinv`` at 3x3 and 8x8 on 1M, 16x16 on 500k and 24x24
   on 200k, ``batchlmdiv`` 16x16 with a vector on 500k, ``sym_solve`` on
   full storage at 1M x 4 x 4 and on compact N = 40 (checked, not timed);
   launch counts, normwise error against float64 numpy, per-call, host
   and device times, each kernel alone against its bound, its plain
   version and ``torch.linalg.inv_ex`` / ``solve_ex``; the inverse kernel
   also timed at 32x32 on 100,000, the solve kernel at 24x24 on 200,000
   and 32x32 on 100,000 with one column and at 16x16 on 500k with 16;
7. the factor path at the bench suite's shapes (float32, a a^T + n I):
   the public ``batchchol`` at 3x3 and 8x8 on 1M, 16x16 on 500k and 24x24
   on 200k, ``batchlogdet`` 16x16 on 500k and 32x32 on 100k, ``batchdet``
   3x3 and 8x8 on 1M, ``sym_det`` and ``sym_invert`` on ``bench.py``'s
   1M x 4 compact batch and at N = 16 on 262,144; launch counts, error
   against float64 numpy on 4,096 problems (relative for a determinant,
   normwise for a factor or an inverse, absolute over max(1, |logdet|)
   for log|det|), per-call, host and device times, each kernel alone
   against its bound, its plain version and one ``torch.linalg`` call
   (``det``, ``slogdet``, ``cholesky_ex``, ``det`` / ``inv_ex`` of the
   densified compact matrix); the Cholesky kernel also timed at 32x32 on
   100k, the determinant kernel at 16x16
   on 500k and 32x32 on 100k (on (a a^T + n I) / n), the compact
   determinant at N = 32 on 65,536 (on (a a^T + n I) / n), the compact
   inverse at N = 32 on 65,536;
8. the iterations and the full-storage products at the bench suite's
   shapes (float32): ``sym_matvec_chain`` at 1M x 4 x 4 (k = 128) and
   16 x 16 (k = 32) on contraction-scaled a a^T + n I, gated normwise
   against a float64 numpy recurrence; ``sym_maxeig`` at 1M x 4 x 4 and
   8 x 8, iters = 32, on gap-boosted input, its median relative error
   against float64 ``eigvalsh`` gated; ``batchmatmul`` at 16 x 16 on 500k,
   4 x 4 on 1M and 32 x 32 on 100k, ``auto`` and ``cuda``; ``sym_solve`` on full storage at
   1M x 4 x 4 through the matvec kernel; launch counts, per-call, host and
   device times, each kernel alone against its bound, its plain version
   and ``torch.matmul`` (the product at each of its shapes, with the tier
   it takes; the power iteration also at 16 x 16 on 1M and 32 x 32 on
   262,144, its lane groups); then the routing sweeps: the matvec and the product kernels
   against ``torch.matmul`` from n = 4 to 32, with the product's tier;
9. ``eig_sym`` and ``sugar.lmdiv`` at the bench suite's shapes (float32,
   a a^T + n I): ``eig_sym`` 2x2 and 3x3 (closed forms) and 4x4 on 1M,
   12x12 and 16x16 on 200k, 24x24 and 32x32 on 100k, with vectors and the
   default polish at 4x4 and 16x16, ``lmdiv`` lu and chol 16x16 on 500k;
   launch counts, sorted eigenvalues against float64 ``eigvalsh`` (over
   ||A||_2), the reconstruction and U^T U - I, lmdiv normwise, all gated
   at 1e-5; per-call, host and device times, each eig kernel alone
   against its bound, its plain version and ``eigvalsh`` / ``eigh`` (on
   the whole batch, in the chunks cuSOLVER takes);
10. the Lie path at the bench suite's shapes (float32): ``expm`` and
    ``logm`` 4x4 on 1M and their chains (``0.5 expm(0.5 x)``, k = 16;
    ``expm(0.999 logm(e))``, k = 4), both at 8x8 to 32x32 on about 64 MB,
    SPD ``logm`` at 5 to 32 on 15,625 through the symmetric eig route and
    through the kernel, ``meanm`` G = 4096, K = 8, 4x4 (float64); launch
    counts, normwise error against float64 scipy gated at 1e-5 (the 4x4
    roundtrip at the reference's elementwise bound, meanm's fixed-point
    residual at 1e-10), per-call, host and device times, the two SPD
    routes per call, each kernel alone against its bound, its plain
    version and, for expm, ``torch.linalg.matrix_exp``;
11. the numerics path at the bench suite's shapes (float32), the modules
    with no kernel: ``nansum`` and ``median`` (dim=-1) on 1M x 64 with 20%
    NaN; ``besseli(0, z, "norm")`` on 1M z in [0, 30), its chain z <-
    besseli(0, z) + z (k = 32) and ``besseli(3.7, z, "log")``;
    ``logsumexp`` and ``softmax`` with the implicit class on 1M x 8; DCT-II
    n = 64 ortho on 1M and n = 2048 on 65,536, DCT-I/III/IV and DST-IV n =
    64 on 200k, ``dctn`` 32x32 on 8,192; ``trapprox`` (Hutchinson and
    Hutch++, s = 64), ``vbald`` and ``maxeig_power`` (max_iter 256) on 512
    SPD 64x64 as one block-diagonal operator and with ``sym_matvec`` on the
    1M x 4 compact batch as the operator (which must launch kernel #3);
    per-call, host and device times beside the bound by bytes, the error
    against float64 numpy / scipy at the float32 tolerance of the JAX
    package's test of the function (else 1e-5 normwise; the estimators at
    their sampling tolerance); then the sweep of the DCT-II basis product
    against the FFT path at n = 64 to 8192 on 256 MB batches, which sets
    ``realtransforms.MATMUL_MAX_N``; one JSON line of these rows;
12. one JSON line of per-kernel times beside their bounds (the batched
    and factor kernels also at each shape phases 6 and 7 time).

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the rest of the repository beside it, the script exits non-zero
and prints no result. It imports neither JAX nor ``fastmath_tpu``.
"""
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"
SEED = 0
B_MAIN, N_MAIN, CHAIN_K = 1_000_000, 4, 128
B_CHECK = 4099  # a 4096 batch with a ragged tail
B_WIDE = 262_144
B_JHJ, K_JHJ = 200_000, 16  # bench/suite.py's sym_matmul JhJ 16x16 batch
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, non-tensor-core FP32
# and FP64 operations/s
PEAK_BYTES = 3.35e12
PEAK_OPS = {"float32": 67e12, "float64": 34e12}
# kernel vs plain version on the card: the kernels contract multiply-adds
# into FMAs and the plain version does not, a few ulp per operation
TOL_PLAIN = {"float32": 1e-5, "float64": 1e-12}
# against the float64 numpy oracle (matrices with condition number ~10)
TOL_ORACLE = {"float32": 1e-5, "float64": 1e-12}
GATE = 1e-5  # main-path normwise gate (bench.py's north-star target)
DEV = "cuda"


def log(*args):
    print(*args, flush=True)


def fail(msg):
    raise RuntimeError(msg)


def spd(rng, b, n, dtype=np.float32):
    """bench.py's construction: a a^T + n I."""
    a = rng.standard_normal((b, n, n)).astype(dtype)
    return np.einsum("...ij,...kj->...ik", a, a) + n * np.eye(n, dtype=dtype)


def compact(full):
    n = full.shape[-1]
    rows, cols = np.triu_indices(n, k=1)
    return np.ascontiguousarray(np.concatenate(
        [np.diagonal(full, axis1=-2, axis2=-1), full[..., rows, cols]], axis=-1))


def normwise(got, want, add=None):
    """Per-problem ||got - want|| / ||want||. For a chain pass its ``add``
    (for acc +/- A v, its acc): the recurrence x <- A \\ x + add can cancel
    (||x_k|| far below the per-step terms), and rounding scales with the
    terms, so the error is taken relative to ||want|| + ||add||."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.linalg.norm(want, axis=-1)
    if add is not None:
        scale = scale + np.linalg.norm(np.asarray(add, np.float64), axis=-1)
    return np.linalg.norm(got - want, axis=-1) / scale


def oracle_solve(full, v, eps=None):
    full = full.astype(np.float64)
    if eps is not None:
        full = full + np.diag(eps)
    return np.linalg.solve(full, v.astype(np.float64)[..., None])[..., 0]


def oracle_chain(full, v, c, iters, eps=None):
    full = full.astype(np.float64)
    if eps is not None:
        full = full + np.diag(eps)
    x = v.astype(np.float64)
    c = np.zeros_like(x) if c is None else c.astype(np.float64)
    for _ in range(iters):
        x = np.linalg.solve(full, x[..., None])[..., 0] + c
    return x


def call_ms(torch, fn, reps=10, warmup=2):
    """Median over ``reps`` of one call as its caller sees it: CUDA events
    around the call, so the host's time to launch counts where the card
    waits for it (the public ops, the plain versions)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_ms(torch, fn, reps=20):
    """Host time to issue one call (the card is not waited for)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def device_ms(torch, fn, reps=20, warmup=2, tries=8):
    """Device time of one call of ``fn`` (a few launches): a spin kernel
    holds the card while the host queues ``reps`` calls, so they run back
    to back and the events time the card alone, not the host's launches.
    The spin grows until it outlasts the queueing; None if ``fn`` waits
    for the card itself and so cannot be queued ahead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = 2_000_000  # clock cycles, about 1 ms
    for _ in range(tries):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        starved = start.query()  # the spin ended before the queue was full
        end.synchronize()
        if not starved:
            return start.elapsed_time(end) / reps
        spin *= 4
    return None


# --- phase 1 -----------------------------------------------------------------


def ptxas_summary(text):
    """One line per compiled kernel: registers, stack frame and spills."""
    rows, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            k = re.search(r"fm\d+(\w+?)I([fd])((?:L[ib]\d+E)*)E", name)
            if k:  # fm::kernel<dtype, int and bool template arguments...>
                args = [k.group(2), *re.findall(r"L[ib](\d+)E", k.group(3))]
                name = f"{k.group(1)}<{','.join(args)}>"
            stack = spills = None
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            stack, spills = m.group(1), f"{m.group(2)}/{m.group(3)}"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append(f"{name}: regs={m.group(1)} stack={stack} spill_st/ld={spills}")
            name = None
    return rows


def phase_device(torch):
    from fastmath_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        fail("no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"build_seconds={time.perf_counter() - t0:.2f}")
    OUT.mkdir(parents=True, exist_ok=True)
    for name in paths:
        text = _build.build_log(name).read_text()
        (OUT / f"ptxas_{name}.log").write_text(text)
        for row in ptxas_summary(text):
            log(f"  ptxas {row}")
    return smi.splitlines()[0]


# --- phase 2 -----------------------------------------------------------------

# the compact solve's and chain's tiers, and the edges of the solve's lane
# groups (G = 16 to N = 16, 32 above)
SYM_SOLVE_CHECK_NS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 16, 17, 24, 32)


def phase_kernels_vs_plain(torch, rng):
    from fastmath_tpu_torch.kernels import sym_cuda

    worst = {}
    for dt_name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        for n in SYM_SOLVE_CHECK_NS:
            full = spd(rng, B_CHECK, n, np.float64)
            cm = compact(full)
            v = rng.standard_normal((B_CHECK, n))
            c = rng.standard_normal((B_CHECK, n))
            mat = torch.tensor(cm, dtype=dtype, device=DEV)
            vec = torch.tensor(v, dtype=dtype, device=DEV)
            add = torch.tensor(c, dtype=dtype, device=DEV)
            # channel-first copies, seen as transposed (B, K) views
            mat_cf, vec_cf = mat.t().contiguous().t(), vec.t().contiguous().t()
            for eps in (None, tuple(float(e) for e in rng.uniform(0.1, 1.0, n))):
                e = None if eps is None else np.asarray(eps)
                want64 = oracle_solve(full, v, e)
                for refine in (0, 1, 2):
                    for layout, (m, x) in (("bm", (mat, vec)), ("cf", (mat_cf, vec_cf))):
                        if layout == "cf" and refine != 1:
                            continue
                        got = sym_cuda.launch_solve(m, x, eps, refine, cf_out=layout == "cf")
                        plain = sym_cuda.solve_plain(mat, vec, eps, refine)
                        torch.cuda.synchronize()
                        got = got.cpu().numpy()
                        d = normwise(got, plain.cpu().numpy()).max()
                        o = normwise(got, want64).max()
                        key = f"solve {dt_name} n={n} eps={eps is not None} refine={refine} {layout}"
                        worst[key] = (d, o)
                        if not (d <= TOL_PLAIN[dt_name] and o <= TOL_ORACLE[dt_name]):
                            fail(f"{key}: kernel vs plain {d:.3e}, vs f64 oracle {o:.3e}")
                iters = 8
                want64 = oracle_chain(full, v, c, iters, e)
                for layout, (m, x, a) in (("bm", (mat, vec, add)),
                                          ("cf", (mat_cf, vec_cf, add.t().contiguous().t()))):
                    got = sym_cuda.launch_chain(m, x, a, eps, iters, cf_out=layout == "cf")
                    plain = sym_cuda.chain_plain(mat, vec, add, eps, iters)
                    torch.cuda.synchronize()
                    got = got.cpu().numpy()
                    d = normwise(got, plain.cpu().numpy(), c).max()
                    o = normwise(got, want64, c).max()
                    key = f"chain {dt_name} n={n} eps={eps is not None} iters={iters} {layout}"
                    worst[key] = (d, o)
                    if not (d <= TOL_PLAIN[dt_name] and o <= TOL_ORACLE[dt_name]):
                        fail(f"{key}: kernel vs plain {d:.3e}, vs f64 oracle {o:.3e}")
        torch.cuda.synchronize()
    for dt_name in ("float32", "float64"):
        for op in ("solve", "chain"):
            ks = [k for k in worst if k.startswith(f"{op} {dt_name}")]
            d = max(worst[k][0] for k in ks)
            o = max(worst[k][1] for k in ks)
            log(f"  {op} {dt_name}: {len(ks)} cases{' (error over norm(x) + norm(add))' if op == 'chain' else ''}, worst normwise kernel-vs-plain "
                f"{d:.3e} (tol {TOL_PLAIN[dt_name]:.0e}), vs f64 numpy {o:.3e} "
                f"(tol {TOL_ORACLE[dt_name]:.0e})")


def hold(torch, worst, key, got, plain, want64, dt_name, add=None):
    """Hold a kernel's output to its plain version (``TOL_PLAIN``) and to
    a float64 oracle (``TOL_ORACLE``), normwise (over norm + norm(add)
    where ``add`` is given); record both errors in ``worst[key]``."""
    torch.cuda.synchronize()
    got = got.cpu().numpy()
    d = normwise(got, plain.cpu().numpy(), add).max()
    o = normwise(got, want64, add).max()
    worst[key] = (d, o)
    if not (d <= TOL_PLAIN[dt_name] and o <= TOL_ORACLE[dt_name]):
        fail(f"{key}: kernel vs plain {d:.3e}, vs f64 oracle {o:.3e}")


JHJ_CHECK = ((1, 1), (3, 2), (4, 4), (6, 6), (7, 3), (3, 7), (16, 16), (32, 32), (16, 7),
             (7, 16))


def full64(cm, n):
    """float64 numpy full matrices of a compact tensor (the values the
    card holds, so float32 inputs are not rounded twice)."""
    from fastmath_tpu_torch.layouts import compact_index_grid

    return cm.double().cpu().numpy()[:, compact_index_grid(n)]


def oracle_jhj(J, H):
    return compact(np.einsum("bai,bac,bcj->bij", J, H, J))


def phase_products_vs_plain(torch, rng):
    """The product kernels (matvec, acc +/- matvec, outer, JtHJ) against
    their plain versions and a float64 numpy oracle."""
    from fastmath_tpu_torch.kernels import sym_products as P

    worst = {}

    def check(key, got, plain, want64, dt_name, acc=None):
        # acc +/- A v can cancel: its error is taken over norm + norm(acc)
        hold(torch, worst, key, got, plain, want64, dt_name, acc)

    layouts = (("bm", lambda t: t), ("cf", lambda t: t.t().contiguous().t()))
    for dt_name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        for n in (1, 2, 3, 4, 5, 8, 16, 32):
            mat, vec, acc = (torch.tensor(a, dtype=dtype, device=DEV) for a in (
                compact(spd(rng, B_CHECK, n, np.float64)), rng.standard_normal((B_CHECK, n)),
                rng.standard_normal((B_CHECK, n))))
            v64, c64 = vec.double().cpu().numpy(), acc.double().cpu().numpy()
            mv64 = np.einsum("bij,bj->bi", full64(mat, n), v64)
            outer64 = compact(v64[:, :, None] * v64[:, None, :])
            for layout, lay in layouts:
                cf = layout == "cf"
                m, x, a = lay(mat), lay(vec), lay(acc)
                check(f"matvec {dt_name} n={n} {layout}", P.launch_matvec(m, x, cf),
                      P.matvec_plain(mat, vec), mv64, dt_name)
                for sign, op in ((1.0, "addmatvec"), (-1.0, "submatvec")):
                    check(f"{op} {dt_name} n={n} {layout}",
                          P.launch_accmatvec(a, m, x, sign, cf),
                          P.accmatvec_plain(acc, mat, vec, sign), c64 + sign * mv64, dt_name,
                          c64)
                check(f"outer {dt_name} n={n} {layout}", P.launch_outer(x, cf),
                      P.outer_plain(vec), outer64, dt_name)
        for k, d in JHJ_CHECK:
            j = torch.tensor(rng.standard_normal((B_CHECK, k * d)), dtype=dtype, device=DEV)
            h = torch.tensor(compact(spd(rng, B_CHECK, k, np.float64)), dtype=dtype, device=DEV)
            want64 = oracle_jhj(j.double().cpu().numpy().reshape(B_CHECK, k, d), full64(h, k))
            plain = P.jhj_plain(j, h, d)
            for layout, lay in layouts:
                check(f"jhj {dt_name} k={k} d={d} {layout}",
                      P.launch_jhj(lay(j), lay(h), d, layout == "cf"), plain, want64, dt_name)
    for dt_name in ("float32", "float64"):
        for op in ("matvec", "addmatvec", "submatvec", "outer", "jhj"):
            ks = [k for k in worst if k.startswith(f"{op} {dt_name}")]
            over = " (error over norm(y) + norm(acc))" if op in ("addmatvec", "submatvec") else ""
            log(f"  {op} {dt_name}: {len(ks)} cases{over}, worst normwise kernel-vs-plain "
                f"{max(worst[k][0] for k in ks):.3e} (tol {TOL_PLAIN[dt_name]:.0e}), "
                f"vs f64 numpy {max(worst[k][1] for k in ks):.3e} "
                f"(tol {TOL_ORACLE[dt_name]:.0e})")


def general(rng, b, n):
    """General matrices n I + (sqrt(n) / 4) R, R standard normal, with
    their rows shuffled: partial pivoting swaps rows at most steps, and
    the singular values stay near [n/2, 3n/2] (condition number ~3), so
    the checks measure the kernels, not the conditioning."""
    a = n * np.eye(n) + np.sqrt(n) / 4 * rng.standard_normal((b, n, n))
    perm = np.argsort(rng.random((b, n)), axis=-1)
    return np.take_along_axis(a, perm[..., None], axis=1)


# every n of the unrolled tiers (the inverse's and Cholesky's staged), and
# the lane-group LU's edges (G = 16 to n = 16, 32 above)
FACTOR_CHECK_NS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 16, 17, 24, 32)
SOLVE_CHECK_NS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 32)
# the n <= 8 solve's widths: one column, a few, k = n, the staged width
# (batched.cu's kSolveStagedK), the first width past it, and 40 (solve_full_cf
# takes any k)
SOLVE_SMALL_KS = (1, 3, 8, 9, 40)
# the lane-group solve's widths: one column, a block of G = 16 columns and
# one ragged column past it, and 40 (two blocks and a ragged one at G = 16,
# one and a ragged one at G = 32)
SOLVE_GROUP_KS = (1, 16, 17, 40)


def phase_batched_vs_plain(torch, rng):
    """The full-storage solve and inverse kernels against their plain
    versions and a float64 numpy oracle, on general (pivoting) and SPD
    matrices; the solve also reading A transposed (its gradient's read).
    The inverse at ``FACTOR_CHECK_NS``, the solve at ``SOLVE_CHECK_NS``."""
    from fastmath_tpu_torch.kernels import batched_cuda as BC

    worst = {}

    def check(key, got, plain, want64, dt_name):
        hold(torch, worst, key, got, plain, want64, dt_name)

    for dt_name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        for n in FACTOR_CHECK_NS:
            for kind, full in (("general", general(rng, B_CHECK, n)),
                               ("spd", spd(rng, B_CHECK, n, np.float64))):
                a = torch.tensor(full.reshape(B_CHECK, n * n), dtype=dtype, device=DEV)
                a64 = a.double().cpu().numpy().reshape(B_CHECK, n, n)
                a_cf = a.t().contiguous().t()
                inv64 = np.linalg.inv(a64).reshape(B_CHECK, n * n)
                plain = BC.inv_plain(a)
                for layout, m in (("bm", a), ("cf", a_cf)):
                    check(f"inv {dt_name} n={n} {kind} {layout}",
                          BC.launch_inv(m, cf_out=layout == "cf"), plain, inv64, dt_name)
                if n not in SOLVE_CHECK_NS:
                    continue
                for k in (sorted({n, *SOLVE_SMALL_KS}) if n <= 8 else SOLVE_GROUP_KS):
                    rhs = torch.tensor(rng.standard_normal((B_CHECK, n * k)), dtype=dtype,
                                       device=DEV)
                    r64 = rhs.double().cpu().numpy().reshape(B_CHECK, n, k)
                    for trans in (False, True):
                        am = np.swapaxes(a64, 1, 2) if trans else a64
                        x64 = np.linalg.solve(am, r64).reshape(B_CHECK, n * k)
                        plain = BC.solve_full_plain(a, rhs, k, trans)
                        for layout, (m, r) in (("bm", (a, rhs)),
                                               ("cf", (a_cf, rhs.t().contiguous().t()))):
                            if trans and layout == "cf":
                                continue
                            check(f"solve_full {dt_name} n={n} k={k} {kind} trans={trans} "
                                  f"{layout}", BC.launch_solve_full(m, r, k, trans, layout == "cf"),
                                  plain, x64, dt_name)
    for dt_name in ("float32", "float64"):
        for op in ("inv", "solve_full"):
            ks = [k for k in worst if k.startswith(f"{op} {dt_name}")]
            log(f"  {op} {dt_name}: {len(ks)} cases, worst normwise kernel-vs-plain "
                f"{max(worst[k][0] for k in ks):.3e} (tol {TOL_PLAIN[dt_name]:.0e}), "
                f"vs f64 numpy {max(worst[k][1] for k in ks):.3e} "
                f"(tol {TOL_ORACLE[dt_name]:.0e})")


def symmetric(rng, b, n):
    """Symmetric, indefinite matrices Q diag(w) Q^T, |w| in [0.5, 2] with
    mixed signs: pivoting swaps rows, the condition number is <= 4 and
    the determinant stays in float32 range at every n."""
    q, _ = np.linalg.qr(rng.standard_normal((b, n, n)))
    w = rng.uniform(0.5, 2.0, (b, n)) * np.where(rng.random((b, n)) < 0.5, -1, 1)
    s = np.einsum("bik,bk,bjk->bij", q, w, q)
    return 0.5 * (s + s.transpose(0, 2, 1))


def compact_lower(L):
    """Compact slots of lower factors (the Cholesky kernel's output):
    slot (i, j), i < j, holds L[j][i]."""
    rows, cols = np.triu_indices(L.shape[-1], k=1)
    return np.concatenate([np.diagonal(L, axis1=-2, axis2=-1), L[..., cols, rows]], axis=-1)


def log_err(got, want):
    """|got - want| / max(1, |want|) per problem, for log|det|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want) / np.maximum(1.0, np.abs(want))


def phase_factor_vs_plain(torch, rng):
    """The determinant (and its log mode), Cholesky, compact determinant
    and compact inverse kernels against their plain versions and a
    float64 numpy oracle: relative error for a determinant, normwise for
    a factor or an inverse, absolute over max(1, |logdet|) for log|det|.
    The matrices keep their determinants in float32 range at every n."""
    from fastmath_tpu_torch.kernels import batched_cuda as BC
    from fastmath_tpu_torch.kernels import sym_factor as SF

    worst = {}
    for dt_name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        for n in FACTOR_CHECK_NS:
            a = torch.tensor((general(rng, B_CHECK, n) / n).reshape(B_CHECK, n * n), dtype=dtype,
                             device=DEV)
            sym = torch.tensor(compact(symmetric(rng, B_CHECK, n)), dtype=dtype, device=DEV)
            pd = torch.tensor(compact(spd(rng, B_CHECK, n, np.float64) / n), dtype=dtype,
                              device=DEV)
            a64 = a.double().cpu().numpy().reshape(B_CHECK, n, n)
            sym64, pd64 = full64(sym, n), full64(pd, n)
            rows = [
                ("det", BC.launch_det, a, BC.det_plain, np.linalg.det(a64)),
                ("logdet", BC.launch_logdet, a, BC.logdet_plain, np.linalg.slogdet(a64)[1]),
                ("chol", BC.launch_chol, pd, BC.chol_plain,
                 compact_lower(np.linalg.cholesky(pd64))),
                ("sym_det", SF.launch_sym_det, sym, SF.sym_det_plain, np.linalg.det(sym64)),
                ("sym_invert", SF.launch_sym_invert, sym, SF.invert_plain,
                 compact(np.linalg.inv(sym64))),
            ]
            for op, kern, x, plain, want64 in rows:
                want = plain(x)
                for layout, m in (("bm", x), ("cf", x.t().contiguous().t())):
                    key = f"{op} {dt_name} n={n} {layout}"
                    got = kern(m, cf_out=layout == "cf")
                    torch.cuda.synchronize()
                    if op == "logdet":
                        g = got.cpu().numpy()
                        d, o = log_err(g, want.cpu().numpy()).max(), log_err(g, want64).max()
                        worst[key] = (d, o)
                        if not (d <= TOL_PLAIN[dt_name] and o <= TOL_ORACLE[dt_name]):
                            fail(f"{key}: kernel vs plain {d:.3e}, vs f64 oracle {o:.3e}")
                    elif got.dim() == 1:  # a determinant: relative
                        hold(torch, worst, key, got[:, None], want[:, None], want64[:, None],
                             dt_name)
                    else:
                        hold(torch, worst, key, got, want, want64, dt_name)
    for dt_name in ("float32", "float64"):
        for op in ("det", "logdet", "chol", "sym_det", "sym_invert"):
            ks = [k for k in worst if k.startswith(f"{op} {dt_name}")]
            log(f"  {op} {dt_name}: {len(ks)} cases, worst kernel-vs-plain "
                f"{max(worst[k][0] for k in ks):.3e} (tol {TOL_PLAIN[dt_name]:.0e}), "
                f"vs f64 numpy {max(worst[k][1] for k in ks):.3e} "
                f"(tol {TOL_ORACLE[dt_name]:.0e})")


def contraction(rng, b, n):
    """Symmetric Q diag(w) Q^T, w in [-0.9, 0.9]: the chain's iterates
    neither grow nor amplify their roundings."""
    q, _ = np.linalg.qr(rng.standard_normal((b, n, n)))
    s = np.einsum("bik,bk,bjk->bij", q, rng.uniform(-0.9, 0.9, (b, n)), q)
    return 0.5 * (s + s.transpose(0, 2, 1))


def gapped(rng, b, n):
    """Symmetric matrices with a dominant eigenvalue 8 n apart from the
    rest (the reference's tests/test_maxeig.py construction), and start
    vectors u + r / 2, u the boost direction and r a random unit vector:
    a start vector nearly orthogonal to the dominant eigenvector makes the
    first steps amplify every rounding (the iteration's own condition, in
    the kernel and the plain version alike), which is not what the check
    measures."""
    a = rng.standard_normal((b, n, n))
    u, r = (x / np.linalg.norm(x, axis=-1, keepdims=True)
            for x in (rng.standard_normal((b, n)), rng.standard_normal((b, n))))
    return (a + a.transpose(0, 2, 1)) / 2 + 8.0 * n * u[:, :, None] * u[:, None, :], u + r / 2


def dominant(full64):
    """Largest-|lambda| eigenvalue of float64 symmetric matrices."""
    w = np.linalg.eigvalsh(full64)
    return w[np.arange(len(w)), np.argmax(np.abs(w), axis=-1)]


# the entry tier's and the tile tier's edges: ragged tiles, k = 1 beside the
# largest C, square n = 8, 12, 17
MKN_CHECK = ((1, 1, 1), (2, 3, 4), (4, 4, 4), (6, 6, 6), (7, 3, 5), (1, 32, 1), (8, 8, 8),
             (12, 12, 12), (13, 5, 17), (16, 16, 16), (17, 17, 17), (32, 1, 32), (32, 32, 32))


def phase_iterate_vs_plain(torch, rng):
    """The chain, power-iteration, full-matvec and product kernels against
    their plain versions and float64 numpy: normwise, over norm(x) +
    norm((vec, add)) for the chain and over norm(y) + norm(|A| |B|) for the
    products (their sums can cancel); for the power iteration the eigenvalue's error over
    the Gershgorin bound (a Rayleigh quotient cancels before it
    converges) and the vector normwise, and after 64 steps the eigenvalue
    against eigvalsh, relative."""
    from fastmath_tpu_torch.kernels import batched_cuda as BC
    from fastmath_tpu_torch.kernels import sym_iterate as SI

    worst = {}
    layouts = (("bm", lambda t: t), ("cf", lambda t: t.t().contiguous().t()))
    for dt_name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        tol_p, tol_o = TOL_PLAIN[dt_name], TOL_ORACLE[dt_name]
        for n in (1, 2, 3, 4, 5, 8, 9, 12, 16, 17, 24, 32):
            mat, vec, add = (torch.tensor(a, dtype=dtype, device=DEV) for a in (
                compact(contraction(rng, B_CHECK, n)), rng.standard_normal((B_CHECK, n)),
                rng.standard_normal((B_CHECK, n))))
            a64, v64, c64 = full64(mat, n), vec.double().cpu().numpy(), add.double().cpu().numpy()
            # the steps round terms as large as vec and add: the error is
            # taken over norm(x) + norm((vec, add)), as x_iters can be small
            vc64 = np.concatenate([v64, c64], axis=-1)
            for iters in (0, 1, 7):
                for c, c_np in ((None, v64), (add, vc64)):
                    x64 = v64
                    for _ in range(iters):
                        x64 = np.einsum("bij,bj->bi", a64, x64) + (0 if c is None else c64)
                    plain = SI.matvec_chain_plain(mat, vec, c, iters)
                    for layout, lay in layouts:
                        got = SI.launch_matvec_chain(lay(mat), lay(vec),
                                                     None if c is None else lay(c), iters,
                                                     layout == "cf")
                        hold(torch, worst, f"chain {dt_name} n={n} iters={iters} "
                             f"add={c is not None} {layout}", got, plain, x64, dt_name, c_np)
            gfull, v0 = gapped(rng, B_CHECK, n)
            gm = torch.tensor(compact(gfull), dtype=dtype, device=DEV)
            v0 = torch.tensor(v0, dtype=dtype, device=DEV)
            g64 = full64(gm, n)
            gersh = np.abs(g64).sum(axis=-1).max(axis=-1)
            dom = dominant(g64)
            for iters, r in ((0, 1), (5, 8), (32, 16), (32, 1), (64, 8)):
                plain = SI.maxeig_plain(gm, v0, iters, r).double().cpu().numpy()
                for layout, lay in layouts:
                    got = SI.launch_maxeig(lay(gm), lay(v0), iters, r, layout == "cf")
                    torch.cuda.synchronize()
                    got = got.double().cpu().numpy()
                    d = max((np.abs(got[:, 0] - plain[:, 0]) / gersh).max(),
                            normwise(got[:, 1:], plain[:, 1:]).max())
                    o = (np.abs(got[:, 0] - dom) / np.abs(dom)).max() if iters == 64 else 0.0
                    key = f"maxeig {dt_name} n={n} iters={iters} r={r} {layout}"
                    worst[key] = (d, o)
                    if not (d <= tol_p and o <= tol_o):
                        fail(f"{key}: kernel vs plain {d:.3e}, vs f64 eigvalsh {o:.3e}")
            full = torch.tensor(rng.standard_normal((B_CHECK, n * n)), dtype=dtype, device=DEV)
            f64 = full.double().cpu().numpy().reshape(B_CHECK, n, n)
            for trans in (False, True):
                eq = "bji,bj->bi" if trans else "bij,bj->bi"
                want64 = np.einsum(eq, f64, v64)
                terms = np.einsum(eq, np.abs(f64), np.abs(v64))  # |A| |v|: sums can cancel
                plain = BC.matvec_full_plain(full, vec, trans)
                for layout, lay in layouts:
                    hold(torch, worst, f"matvec_full {dt_name} n={n} trans={trans} {layout}",
                         BC.launch_matvec_full(lay(full), lay(vec), trans, layout == "cf"),
                         plain, want64, dt_name, terms)
        for m, k, n in MKN_CHECK:
            a, b = (torch.tensor(rng.standard_normal((B_CHECK, r * c)), dtype=dtype, device=DEV)
                    for r, c in ((m, k), (k, n)))
            a64, b64 = a.double().cpu().numpy(), b.double().cpu().numpy()
            for ta in (False, True):
                for tb in (False, True):
                    A = a64.reshape(B_CHECK, k, m).transpose(0, 2, 1) if ta else \
                        a64.reshape(B_CHECK, m, k)
                    Bm = b64.reshape(B_CHECK, n, k).transpose(0, 2, 1) if tb else \
                        b64.reshape(B_CHECK, k, n)
                    want64 = (A @ Bm).reshape(B_CHECK, m * n)
                    terms = (np.abs(A) @ np.abs(Bm)).reshape(B_CHECK, m * n)
                    plain = BC.matmul_plain(a, b, m, k, n, ta, tb)
                    for layout, lay in layouts:
                        hold(torch, worst, f"matmul {dt_name} {m}x{k}x{n} ta={ta} tb={tb} "
                             f"{layout}", BC.launch_matmul(lay(a), lay(b), m, k, n, ta, tb,
                                                           layout == "cf"),
                             plain, want64, dt_name, terms)
    for dt_name in ("float32", "float64"):
        for op, how in (("chain", " (error over norm(x) + norm((vec, add)))"),
                        ("maxeig", " (mu over the Gershgorin bound; vs eigvalsh after 64 "
                                   "steps)"), ("matvec_full", " (over norm(y) + norm(|A| |v|))"),
                        ("matmul", " (over norm(C) + norm(|A| |B|))")):
            ks = [k for k in worst if k.startswith(f"{op} {dt_name}")]
            log(f"  {op} {dt_name}: {len(ks)} cases{how}, worst kernel-vs-plain "
                f"{max(worst[k][0] for k in ks):.3e} (tol {TOL_PLAIN[dt_name]:.0e}), "
                f"vs f64 numpy {max(worst[k][1] for k in ks):.3e} "
                f"(tol {TOL_ORACLE[dt_name]:.0e})")


# --- phase 3 -----------------------------------------------------------------


def phase_gradients(torch, rng):
    import fastmath_tpu_torch as T
    from fastmath_tpu_torch.kernels import sym_solve_cf

    for n in (3, 6, 12, 24):
        cm = compact(spd(rng, 515, n, np.float64))
        ins0 = [torch.tensor(a, device=DEV) for a in
                (cm, rng.standard_normal((515, n)), rng.standard_normal((515, n)))]

        def grads(backend):
            ins = [t.clone().requires_grad_() for t in ins0]
            out = (T.sym_solve(ins[0], ins[1], eps=0.1, backend=backend).square().sum()
                   + T.sym_solve(ins[0], ins[2], refine=1, backend=backend).square().sum()
                   + T.sym_solve_chain(ins[0], ins[1], 3, add=ins[2],
                                       backend=backend).square().sum())
            before = sym_solve_cf.launches
            g = torch.autograd.grad(out, ins)
            return g, sym_solve_cf.launches - before

        (kernel, bwd), (plain, _) = grads("cuda"), grads("torch")
        worst = max(((k - p).norm() / p.norm()).item() for k, p in zip(kernel, plain))
        torch.cuda.synchronize()
        log(f"  grad n={n}: kernel vs plain relative {worst:.3e} (tol 1e-10); solve kernel "
            f"launches in backward: {bwd}")
        if not worst <= 1e-10:
            fail(f"gradient n={n} differs: {worst:.3e}")
        if bwd < 2:
            fail(f"gradient n={n}: the backward did not launch the solve kernel")

    from fastmath_tpu_torch.kernels import sym_matvec_cf

    for n in (3, 12):
        ins0 = [torch.tensor(a, device=DEV) for a in (
            compact(spd(rng, 515, n, np.float64)), rng.standard_normal((515, n)),
            rng.standard_normal((515, n)), rng.standard_normal((515, n, 2)))]

        def product_grads(backend):
            ins = [t.clone().requires_grad_() for t in ins0]
            m, v, a, j = ins
            out = (T.sym_matvec(m, v, backend=backend).square().sum()
                   + T.sym_addmatvec(a, m, v, backend=backend).square().sum()
                   + T.sym_submatvec(a, m, v, backend=backend).square().sum()
                   + T.sym_outer(v, backend=backend).square().sum()
                   + T.sym_matmul(j, m, backend=backend).square().sum())
            before = sym_matvec_cf.launches
            g = torch.autograd.grad(out, ins)
            return g, sym_matvec_cf.launches - before

        kernel, bwd = product_grads("cuda")
        plain, _ = product_grads("torch")
        worst = max(((k - p).norm() / p.norm()).item() for k, p in zip(kernel, plain))
        torch.cuda.synchronize()
        log(f"  product grads n={n}: kernel vs plain relative {worst:.3e} (tol 1e-10); "
            f"matvec kernel launches in backward: {bwd}")
        if not worst <= 1e-10:
            fail(f"product gradient n={n} differs: {worst:.3e}")
        if bwd < 1:
            fail(f"product gradient n={n}: the backward did not launch the matvec kernel")


def phase_batched_gradients(torch, rng):
    """Gradients of batchinv and batchlmdiv through the kernels (float64,
    on the card) against the same through the plain versions (the CPU);
    the solves' backward must launch the solve kernel on A transposed."""
    import fastmath_tpu_torch as T
    from fastmath_tpu_torch.kernels import solve_full_cf

    for n in (3, 6, 12, 24):
        ins0 = [torch.tensor(x, device=DEV) for x in (
            general(rng, 515, n), rng.standard_normal((515, n)),
            rng.standard_normal((515, n, 2)))]

        def grads(device):
            ins = [t.to(device).clone().requires_grad_() for t in ins0]
            out = (T.batchinv(ins[0]).square().sum()
                   + T.batchlmdiv(ins[0], ins[1]).square().sum()
                   + T.batchlmdiv(ins[0], ins[2]).square().sum())
            before = solve_full_cf.launches
            g = torch.autograd.grad(out, ins)
            return [t.cpu() for t in g], solve_full_cf.launches - before

        (kernel, bwd), (plain, _) = grads(DEV), grads("cpu")
        worst = max(((k - p).norm() / p.norm()).item() for k, p in zip(kernel, plain))
        log(f"  batched grads n={n}: kernel vs plain relative {worst:.3e} (tol 1e-10); "
            f"solve kernel launches in backward: {bwd}")
        if not worst <= 1e-10:
            fail(f"batched gradient n={n} differs: {worst:.3e}")
        if n > 4 and bwd < 2:
            fail(f"batched gradient n={n}: the backward did not launch the solve kernel")


def phase_factor_gradients(torch, rng):
    """Gradients of batchdet, batchlogdet, batchchol, sym_det and
    sym_invert through the kernels (float64, on the card) against the
    same through the plain versions (the CPU). The backward must launch
    the inverse kernel for det above n = 4, the solve kernel (on A
    transposed) for log|det|, and the compact inverse kernel for sym_det
    above N = 4."""
    import fastmath_tpu_torch as T
    from fastmath_tpu_torch.kernels import inv_cf, solve_full_cf, sym_invert_cf

    counters = (inv_cf, solve_full_cf, sym_invert_cf)
    for n in (3, 6, 12, 24):
        ins0 = [torch.tensor(x, device=DEV) for x in (
            general(rng, 515, n) / n, spd(rng, 515, n, np.float64),
            compact(symmetric(rng, 515, n)))]

        def grads(device):
            ins = [t.to(device).clone().requires_grad_() for t in ins0]
            out = (T.batchdet(ins[0]).square().sum() + T.batchlogdet(ins[0]).square().sum()
                   + T.batchchol(ins[1]).square().sum() + T.sym_det(ins[2]).square().sum()
                   + T.sym_invert(ins[2]).square().sum())
            before = [c.launches for c in counters]
            g = torch.autograd.grad(out, ins)
            return [t.cpu() for t in g], [c.launches - b for c, b in zip(counters, before)]

        (kernel, bwd), (plain, _) = grads(DEV), grads("cpu")
        worst = max(((k - p).norm() / p.norm()).item() for k, p in zip(kernel, plain))
        log(f"  factor grads n={n}: kernel vs plain relative {worst:.3e} (tol 1e-10); "
            f"launches in backward: inverse {bwd[0]}, solve {bwd[1]}, compact inverse {bwd[2]}")
        if not worst <= 1e-10:
            fail(f"factor gradient n={n} differs: {worst:.3e}")
        if bwd[1] < 1 or (n > 4 and min(bwd[0], bwd[2]) < 1):
            fail(f"factor gradient n={n}: the backward did not launch its kernels: {bwd}")


def phase_iterate_gradients(torch, rng):
    """Gradients of sym_matvec_chain, sym_maxeig, batchmatvec and
    batchmatmul through the kernels (float64, on the card) against the
    same through the plain versions (the CPU). The backward must launch
    the chain kernel (iters times or more), the full matvec kernel (A
    transposed) and the product kernel (twice)."""
    import fastmath_tpu_torch as T
    from fastmath_tpu_torch.kernels import matmul_cf, matvec_full_cf, sym_matvec_chain_cf

    counters = (sym_matvec_chain_cf, matvec_full_cf, matmul_cf)
    for n in (3, 6, 12):
        ins0 = [torch.tensor(x, device=DEV) for x in (
            compact(contraction(rng, 515, n)), rng.standard_normal((515, n)),
            rng.standard_normal((515, n)), compact(gapped(rng, 515, n)[0]),
            rng.standard_normal((515, min(n, 4), min(n, 4))), rng.standard_normal((515, n, n)),
            rng.standard_normal((515, n, 3)))]

        def grads(device):
            ins = [t.to(device).clone().requires_grad_() for t in ins0]
            m, v, c, g, f, a, b = ins
            backend = "cuda" if device == DEV else "torch"
            out = (T.sym_matvec_chain(m, v, 6, add=c, backend=backend).square().sum()
                   + T.sym_maxeig(g, iters=24, v0=v, backend=backend).square().sum()
                   + T.batchmatvec(f, v[:, :f.shape[-1]]).square().sum()
                   + T.batchmatmul(a, b, backend=backend).square().sum())
            before = [k.launches for k in counters]
            gr = torch.autograd.grad(out, ins)
            return [t.cpu() for t in gr], [k.launches - x for k, x in zip(counters, before)]

        (kernel, bwd), (plain, _) = grads(DEV), grads("cpu")
        worst = max(((k - p).norm() / p.norm()).item() for k, p in zip(kernel, plain))
        log(f"  iterate grads n={n}: kernel vs plain relative {worst:.3e} (tol 1e-10); "
            f"launches in backward: chain {bwd[0]}, matvec {bwd[1]}, matmul {bwd[2]}")
        if not worst <= 1e-10:
            fail(f"iterate gradient n={n} differs: {worst:.3e}")
        if bwd[0] < 6 or bwd[1] < 1 or bwd[2] < 2:
            fail(f"iterate gradient n={n}: the backward did not launch its kernels: {bwd}")


# --- phase 4 -----------------------------------------------------------------


def ops_solve(n, refine):
    """Arithmetic operations of one closed-form (N <= 4) solve, as the
    kernel does them: cofactors and 1/det, adj v and the 1/det scale,
    then per refinement step the residual, adj r and the update."""
    from fastmath_tpu_torch.kernels._gen_adjugate import cofactor_ops

    apply = n * (2 * n - 1)
    return cofactor_ops(n) + 1 + apply + n + refine * (2 * n * n + apply + 2 * n)


def ops_chain(n, iters):
    """Arithmetic operations that x <- A^-1 x + c needs, ``iters`` times,
    at N <= 4: cofactors and 1/det, 1/det folded into the cofactor grid
    once, then n^2 multiply-adds per step (the kernel scales by 1/det in
    the loop instead; the bound does not charge that)."""
    from fastmath_tpu_torch.kernels._gen_adjugate import cofactor_ops

    return cofactor_ops(n) + 1 + n * n + iters * 2 * n * n


def bound(nbytes, nops, dt_name):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = nops / PEAK_OPS[dt_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_main_path(torch, rng):
    import fastmath_tpu_torch as T
    from fastmath_tpu_torch.kernels import sym_cuda, sym_solve_cf, sym_solve_chain_cf

    full = spd(rng, B_MAIN, N_MAIN)
    vec_np = rng.standard_normal((B_MAIN, N_MAIN)).astype(np.float32)
    mat = torch.from_numpy(compact(full)).to(DEV)
    vec = torch.from_numpy(vec_np).to(DEV)
    torch.cuda.synchronize()

    sym_solve_cf.launches = 0
    sym_solve_chain_cf.launches = 0
    x = T.sym_solve(mat, vec)
    y = T.sym_solve_chain(mat, vec, CHAIN_K, add=vec)
    torch.cuda.synchronize()
    launches = {"solve": sym_solve_cf.launches, "chain": sym_solve_chain_cf.launches}
    log(f"  main-path launches: sym_solve_cf={launches['solve']} "
        f"sym_solve_chain_cf={launches['chain']}")
    if not (launches["solve"] >= 1 and launches["chain"] >= 1):
        fail(f"main path did not go through both kernels: {launches}")
    if x.shape != (B_MAIN, N_MAIN) or not torch.isfinite(x).all():
        fail("sym_solve output has the wrong shape or is not finite")
    if y.shape != (B_MAIN, N_MAIN) or not torch.isfinite(y).all():
        fail("sym_solve_chain output has the wrong shape or is not finite")

    ns = 65_536
    nw = normwise(x[:ns].cpu().numpy(), oracle_solve(full[:ns], vec_np[:ns]))
    log(f"  sym_solve {B_MAIN}x{N_MAIN}x{N_MAIN} f32 normwise rel-err vs f64 (65536 slice): "
        f"median={np.median(nw):.3e} p99={np.quantile(nw, 0.99):.3e} max={nw.max():.3e} "
        f"(gate {GATE:.0e})")
    if not nw.max() <= GATE:
        fail(f"sym_solve normwise error {nw.max():.3e} > {GATE}")
    nc = 2048
    nwc = normwise(y[:nc].cpu().numpy(),
                   oracle_chain(full[:nc], vec_np[:nc], vec_np[:nc], CHAIN_K))
    log(f"  sym_solve_chain k={CHAIN_K} normwise rel-err vs f64 128-step recurrence "
        f"(2048 problems): median={np.median(nwc):.3e} p99={np.quantile(nwc, 0.99):.3e} "
        f"max={nwc.max():.3e} (gate {GATE:.0e})")
    if not nwc.max() <= GATE:
        fail(f"sym_solve_chain normwise error {nwc.max():.3e} > {GATE}")

    # the public ops: per call as a caller sees it (host launch included),
    # and the host's own time per call, which bounds a stream of calls
    pub_solve = lambda: T.sym_solve(mat, vec)  # noqa: E731
    pub_chain = lambda: T.sym_solve_chain(mat, vec, CHAIN_K, add=vec)  # noqa: E731
    for name, fn, k in (("sym_solve", pub_solve, 1), ("sym_solve_chain", pub_chain, CHAIN_K)):
        t_call = call_ms(torch, fn, reps=20)
        t_host = host_ms(torch, fn, reps=20)
        log(f"  public {name} {B_MAIN}x{N_MAIN}x{N_MAIN} f32 (k={k}): {t_call:.4f} ms per call "
            f"({B_MAIN * k / t_call * 1e3:.4e} solves/s), host {t_host:.4f} ms per call")

    # the kernels line: each kernel alone at the main-path shape
    refine = 1
    k_solve = sym_cuda.launch_solve(mat, vec, None, refine)
    p_solve = sym_cuda.solve_plain(mat, vec, None, refine)
    k_chain = sym_cuda.launch_chain(mat, vec, vec, None, CHAIN_K)
    p_chain = sym_cuda.chain_plain(mat, vec, vec, None, CHAIN_K)
    torch.cuda.synchronize()
    err_solve = (k_solve - p_solve).abs().max().item()
    err_chain = (k_chain - p_chain).abs().max().item()
    ms_solve = device_ms(torch, lambda: sym_cuda.launch_solve(mat, vec, None, refine))
    ms_chain = device_ms(torch, lambda: sym_cuda.launch_chain(mat, vec, vec, None, CHAIN_K))
    if ms_solve is None or ms_chain is None:
        fail("the kernels could not be queued ahead of the card")
    # the plain versions launch hundreds (solve) and thousands (chain) of
    # small kernels: timed per call, host launches included
    plain_solve = call_ms(torch, lambda: sym_cuda.solve_plain(mat, vec, None, refine), reps=5)
    plain_chain = call_ms(torch, lambda: sym_cuda.chain_plain(mat, vec, vec, None, CHAIN_K),
                          reps=3, warmup=1)
    # the same solve on channel-first (NN, B) copies: coalesced loads
    mat_cf, vec_cf = mat.t().contiguous().t(), vec.t().contiguous().t()
    ms_cf = device_ms(torch, lambda: sym_cuda.launch_solve(mat_cf, vec_cf, None, refine,
                                                           cf_out=True))
    log(f"  sym_solve_cf kernel, batch-major (B, NN): {ms_solve:.4f} ms; "
        f"channel-first (NN, B): {ms_cf:.4f} ms")
    full_t = torch.from_numpy(full).to(DEV)
    rhs = vec[..., None]
    # yardstick only (the port never calls it); solve_ex skips the error
    # check that would wait for the card
    lib = lambda: torch.linalg.solve_ex(full_t, rhs)  # noqa: E731
    lib_solve = device_ms(torch, lib, reps=5, tries=4)
    if lib_solve is None:
        lib_solve = call_ms(torch, lib, reps=5)
        log("  torch.linalg.solve_ex waits for the card: timed per call")
    item = mat.element_size()
    nn = mat.shape[1]
    b_solve, by_solve = bound(B_MAIN * (nn + 2 * N_MAIN) * item,
                              B_MAIN * ops_solve(N_MAIN, refine), "float32")
    # add is vec: the chain reads mat and vec once and writes its output
    b_chain, by_chain = bound(B_MAIN * (nn + 2 * N_MAIN) * item,
                              B_MAIN * ops_chain(N_MAIN, CHAIN_K), "float32")
    kernels = [
        {"name": "sym_solve_cf", "route": "cuda",
         "source": "fastmath_tpu_torch/kernels/csrc/sym_solve.cu",
         "replaces": "fastmath_tpu/kernels/sym_pallas.py:390",
         "launches": launches["solve"], "max_abs_err": err_solve,
         "ms": ms_solve, "plain_ms": plain_solve, "bound_ms": b_solve,
         "bound_by": by_solve, "library_ms": lib_solve},
        {"name": "sym_solve_chain_cf", "route": "cuda",
         "source": "fastmath_tpu_torch/kernels/csrc/sym_solve.cu",
         "replaces": "fastmath_tpu/kernels/sym_pallas.py:746",
         "launches": launches["chain"], "max_abs_err": err_chain,
         "ms": ms_chain, "plain_ms": plain_chain, "bound_ms": b_chain,
         "bound_by": by_chain, "library_ms": None},
    ]
    for k in kernels:
        log(f"  {k['name']}: {k['ms']:.4f} ms (bound {k['bound_ms']:.4f} ms by "
            f"{k['bound_by']}, {k['bound_ms'] / k['ms'] * 100:.1f}% of it), plain "
            f"{k['plain_ms']:.4f} ms, library {k['library_ms']}")
    if not (err_solve <= 1e-4 and err_chain <= 1e-3):
        fail(f"main-path kernels disagree with their plain versions: "
             f"{err_solve:.3e}, {err_chain:.3e}")
    return kernels, (full, vec_np, mat, vec)


def ops_chain_rolled(n, iters):
    """Arithmetic operations of the chain kernel's ``iters`` steps x <-
    A^-1 x + c at N >= 5: the explicit inverse once (the solve against the
    identity's n columns), then n^2 multiply-adds and n adds a step."""
    return ops_plu(n, n) + iters * 2 * n * n


# the compact solve beyond the main path: (N, batch, refine); the chain is
# timed beside the unrefined solve
WIDE_SHAPES = ((8, B_WIDE, 0), (16, B_WIDE, 0), (16, B_WIDE, 1), (32, 65_536, 0))
# the chain's other N of the explicit-inverse tier (5 <= N <= 8), on B_WIDE
CHAIN_NARROW = (5, 6, 7)


def ops_sym_solve(n, refine):
    """Arithmetic operations of one solve at 5 <= N <= 32 as the kernels do
    it: the pivoted LU with v's column; with refinement the inverse's n
    columns too, then per step the residual (2 n^2) and X r (2 n^2)."""
    if refine == 0:
        return ops_plu(n, 1)
    return ops_plu(n, n + 1) + refine * 4 * n * n


def phase_wide(torch, rng):
    """The compact solve at N = 8 (unrolled PLU), N = 16 (lane groups, also
    with ``refine=1``) and N = 32 (lane groups of 32), each beside its
    bound, its plain version and ``torch.linalg.solve_ex`` on the densified
    batch, and the chain k = 128 at N = 5, 6, 7, 8 (the explicit inverse,
    one thread a problem), 16 and 32 beside its bound and its plain
    version, each also against the float64 recurrence. Returns the solve's
    and the chain's timed shapes for the kernels line."""
    import fastmath_tpu_torch as T
    from fastmath_tpu_torch.kernels import sym_cuda
    from fastmath_tpu_torch.layouts import full_to_sym

    torch.backends.cuda.matmul.allow_tf32 = False
    rows, chain_rows = [], []
    for n, b, refine in WIDE_SHAPES:
        a = torch.from_numpy(rng.standard_normal((b, n, n)).astype(np.float32)).to(DEV)
        dense = a @ a.mT + n * torch.eye(n, device=DEV)
        mat = full_to_sym(dense).contiguous()
        del a
        vec = torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32)).to(DEV)
        x = T.sym_solve(mat, vec, refine=refine, backend="cuda")
        nw = normwise(x[:4096].cpu().numpy(),
                      oracle_solve(T.layouts.sym_to_full(mat[:4096]).cpu().numpy(),
                                   vec[:4096].cpu().numpy()))
        if not nw.max() <= GATE:
            fail(f"N={n} refine={refine} solve normwise error {nw.max():.3e}")
        plain = sym_cuda.solve_plain(mat[:4096], vec[:4096], None, refine)
        d = normwise(x[:4096].cpu().numpy(), plain.cpu().numpy()).max()
        if not d <= TOL_PLAIN["float32"]:
            fail(f"N={n} refine={refine}: kernel vs plain {d:.3e}")
        t_s = device_ms(torch, lambda: sym_cuda.launch_solve(mat, vec, None, refine), reps=10)
        if t_s is None:
            fail(f"N={n}: the solve kernel could not be queued ahead of the card")
        t_plain = call_ms(torch, lambda: sym_cuda.solve_plain(mat, vec, None, refine), reps=3,
                          warmup=1)
        # yardstick only: one library solve of the same systems, densified
        t_lib = yardstick_ms(torch, lambda: torch.linalg.solve_ex(dense, vec[..., None]),
                             f"N={n} solve_ex")
        nn = n * (n + 1) // 2
        b_s, by_s = bound(b * (nn + 2 * n) * 4, b * ops_sym_solve(n, refine), "float32")
        shape = f"N = {n} on {b}" + (f", refine = {refine}" if refine else "")
        rows.append(shape_row(shape, t_s, t_plain, b_s, by_s, t_lib))
        log(f"  N={n} B={b} refine={refine} f32 solve kernel {t_s:.4f} ms "
            f"({b / t_s * 1e3:.4e} solves/s, normwise max {nw.max():.3e}, vs plain {d:.3e}; "
            f"bound {b_s:.4f} ms by {by_s}, {b_s / t_s * 100:.1f}% of it; plain "
            f"{t_plain:.4f} ms; solve_ex {t_lib:.4f} ms)")
        if refine == 0:
            chain_rows.append(chain_row(n, b, mat, vec))
        del dense, mat, vec, x
    # the chain alone at the other N of the explicit inverse's tier
    narrow = []
    for n in CHAIN_NARROW:
        a = torch.from_numpy(rng.standard_normal((B_WIDE, n, n)).astype(np.float32)).to(DEV)
        mat = full_to_sym(a @ a.mT + n * torch.eye(n, device=DEV)).contiguous()
        vec = torch.from_numpy(rng.standard_normal((B_WIDE, n)).astype(np.float32)).to(DEV)
        narrow.append(chain_row(n, B_WIDE, mat, vec))
        del a, mat, vec
    return rows, narrow + chain_rows


def chain_row(n, b, mat, vec):
    """The chain k = CHAIN_K with add = vec at N = n on b problems, float32:
    the kernel against its plain version (the main path's gate) and, on
    4096 problems, the float64 recurrence (GATE); its time beside its bound
    and its plain version's; the kernels line's row."""
    import torch

    from fastmath_tpu_torch.kernels import sym_cuda
    from fastmath_tpu_torch.layouts import sym_to_full

    nn = n * (n + 1) // 2
    c_k = sym_cuda.launch_chain(mat[:4096], vec[:4096], vec[:4096], None, CHAIN_K)
    c_p = sym_cuda.chain_plain(mat[:4096], vec[:4096], vec[:4096], None, CHAIN_K)
    v64 = vec[:4096].cpu().numpy()
    d_c = normwise(c_k.cpu().numpy(), c_p.cpu().numpy(), v64).max()
    if not d_c <= 1e-3:  # the main path's chain gate
        fail(f"N={n}: chain k={CHAIN_K} kernel vs plain {d_c:.3e}")
    full = sym_to_full(mat[:4096]).double().cpu().numpy()
    o_c = normwise(c_k.cpu().numpy(), oracle_chain(full, v64, v64, CHAIN_K), v64).max()
    if not o_c <= GATE:
        fail(f"N={n}: chain k={CHAIN_K} vs the float64 recurrence {o_c:.3e}")
    t_c = kernel_ms(torch, lambda: sym_cuda.launch_chain(mat, vec, vec, None, CHAIN_K),
                    f"chain N={n}", reps=5)
    t_cp = call_ms(torch, lambda: sym_cuda.chain_plain(mat, vec, vec, None, CHAIN_K),
                   reps=3, warmup=1)
    b_c, by_c = bound(b * (nn + 2 * n) * 4, b * ops_chain_rolled(n, CHAIN_K), "float32")
    log(f"  N={n} B={b} f32 chain k={CHAIN_K} kernel {t_c:.4f} ms "
        f"({b * CHAIN_K / t_c * 1e3:.4e} solves/s; bound {b_c:.4f} ms by {by_c}, "
        f"{b_c / t_c * 100:.1f}% of it; plain {t_cp:.4f} ms; vs plain {d_c:.3e}, "
        f"vs f64 recurrence {o_c:.3e} (gate {GATE:.0e}))")
    return shape_row(f"N = {n}, k = {CHAIN_K} on {b}", t_c, t_cp, b_c, by_c, None)


# --- phase 5 -----------------------------------------------------------------


def ops_matvec(n, acc):
    """Arithmetic operations of one compact A v: n diagonal products and
    two multiply-adds per off-diagonal slot; the accumulate adds a
    multiply-add per row (acc + sign * y)."""
    return n + 4 * (n * (n - 1) // 2) + (2 * n if acc else 0)


def ops_jhj(k, d):
    """Arithmetic operations of one JtHJ as the kernel does them: H J
    (k d sums of k products), then G = Jt (H J), its upper triangle up to
    K, D = 6 and the whole of it above, with 0.5 (G_ij + G_ji) there."""
    dot = 2 * k - 1
    if max(k, d) <= 6:
        return k * d * dot + d * (d + 1) // 2 * dot
    return k * d * dot + d * d * dot + d * (d - 1)


def yardstick_ms(torch, fn, name):
    """Device time of one PyTorch library call (never called by the port),
    per call where it waits for the card."""
    t = device_ms(torch, fn, reps=5, tries=4)
    if t is None:
        log(f"  {name} waits for the card: timed per call")
        t = call_ms(torch, fn, reps=5)
    return t


def phase_products(torch, rng, full, vec_np, mat, vec):
    """The products at bench/suite.py's shapes, through the public ops,
    and one Gauss-Newton step, on phase 4's 1M x 4 x 4 batch."""
    import fastmath_tpu_torch as T
    from fastmath_tpu_torch.kernels import sym_cuda
    from fastmath_tpu_torch.kernels import sym_products as P

    torch.backends.cuda.matmul.allow_tf32 = False
    acc_np = rng.standard_normal((B_MAIN, N_MAIN)).astype(np.float32)
    j16_np = rng.standard_normal((B_JHJ, K_JHJ, K_JHJ)).astype(np.float32)
    h16_np = spd(rng, B_JHJ, K_JHJ)  # bench/suite.py's spd_batch
    # Gauss-Newton Jacobians Q diag(s): Q orthogonal, s in [0.8, 1.25], so
    # cond(J) <= 1.5625 and the check measures the kernels, not the
    # conditioning of random 4x4 Jacobians
    q, _ = np.linalg.qr(rng.standard_normal((B_MAIN, N_MAIN, N_MAIN)))
    j4_np = (q * rng.uniform(0.8, 1.25, (B_MAIN, 1, N_MAIN))).astype(np.float32)
    acc, j16, j4 = (torch.from_numpy(a).to(DEV) for a in (acc_np, j16_np, j4_np))
    h16 = torch.from_numpy(compact(h16_np)).to(DEV)
    torch.cuda.synchronize()

    counters = {"matvec": P.sym_matvec_cf, "addmatvec": P.sym_addmatvec_cf,
                "submatvec": P.sym_submatvec_cf, "outer": P.sym_outer_cf,
                "jhj": P.sym_matmul_cf, "solve": sym_cuda.sym_solve_cf,
                "chain": sym_cuda.sym_solve_chain_cf}
    for c in counters.values():
        c.launches = 0
    y_mv = T.sym_matvec(mat, vec)
    y_add = T.sym_addmatvec(acc, mat, vec)
    y_sub = T.sym_submatvec(acc, mat, vec)
    y_out = T.sym_outer(vec)
    y_jhj = T.sym_matmul(j16, h16)
    # one Gauss-Newton step: H = Jt W J + g gt, delta = H \ g, r = g - H delta
    gn_h = T.sym_matmul(j4, mat) + T.sym_outer(vec)
    delta = T.sym_solve(gn_h, vec)
    resid = T.sym_submatvec(vec, gn_h, delta)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    log("  products-path launches: " + " ".join(f"{k}={v}" for k, v in launches.items()))
    if not all(launches[k] >= 1 for k in ("matvec", "addmatvec", "submatvec", "outer",
                                          "jhj", "solve")):
        fail(f"the products' path did not go through every kernel: {launches}")
    for name, y, shape in (("sym_matvec", y_mv, (B_MAIN, N_MAIN)),
                           ("sym_addmatvec", y_add, (B_MAIN, N_MAIN)),
                           ("sym_submatvec", y_sub, (B_MAIN, N_MAIN)),
                           ("sym_outer", y_out, (B_MAIN, 10)),
                           ("sym_matmul", y_jhj, (B_JHJ, K_JHJ * (K_JHJ + 1) // 2)),
                           ("gauss-newton delta", delta, (B_MAIN, N_MAIN)),
                           ("gauss-newton r", resid, (B_MAIN, N_MAIN))):
        if tuple(y.shape) != shape or not torch.isfinite(y).all():
            fail(f"{name} output has the wrong shape or is not finite")

    # normwise error against float64 numpy on a slice of each batch
    ns, nj = 65_536, 8192
    a64, v64, c64 = (x[:ns].astype(np.float64) for x in (full, vec_np, acc_np))
    mv64 = np.einsum("bij,bj->bi", a64, v64)
    gg64 = v64[:, :, None] * v64[:, None, :]
    gnh64 = np.einsum("bai,bac,bcj->bij", j4_np[:ns].astype(np.float64), a64,
                      j4_np[:ns].astype(np.float64)) + gg64
    cpu = lambda t, k=ns: t[:k].cpu().numpy()  # noqa: E731
    errs = {
        "sym_matvec 1Mx4 normwise vs f64": normwise(cpu(y_mv), mv64),
        # acc +/- A v can cancel: over norm(y) + norm(acc), as the chain
        "sym_addmatvec 1Mx4 normwise vs f64": normwise(cpu(y_add), c64 + mv64, c64),
        "sym_submatvec 1Mx4 normwise vs f64": normwise(cpu(y_sub), c64 - mv64, c64),
        "sym_outer 1Mx4 normwise vs f64": normwise(cpu(y_out), compact(gg64)),
        f"sym_matmul {K_JHJ}x{K_JHJ} 200k normwise vs f64": normwise(
            cpu(y_jhj, nj), oracle_jhj(j16_np[:nj].astype(np.float64),
                                       h16_np[:nj].astype(np.float64))),
        "gauss-newton H normwise vs f64": normwise(cpu(gn_h), compact(gnh64)),
        "gauss-newton delta normwise vs f64": normwise(cpu(delta), np.linalg.solve(gnh64, v64[..., None])[..., 0]),
        "gauss-newton |r|/|g|": np.linalg.norm(cpu(resid), axis=-1) / np.linalg.norm(v64, axis=-1),
    }
    for name, e in errs.items():
        log(f"  {name} ({len(e)} problems): median={np.median(e):.3e} "
            f"p99={np.quantile(e, 0.99):.3e} max={e.max():.3e} (gate {GATE:.0e})")
        if not e.max() <= GATE:
            fail(f"{name}: normwise error {e.max():.3e} > {GATE}")

    def gauss_newton_step():
        h = T.sym_matmul(j4, mat) + T.sym_outer(vec)
        return T.sym_submatvec(vec, h, T.sym_solve(h, vec))

    # the public ops per call (host launch included) and their host share
    public = {
        "sym_matvec": lambda: T.sym_matvec(mat, vec),
        "sym_addmatvec": lambda: T.sym_addmatvec(acc, mat, vec),
        "sym_submatvec": lambda: T.sym_submatvec(acc, mat, vec),
        "sym_outer": lambda: T.sym_outer(vec),
        "sym_matmul 16x16 200k": lambda: T.sym_matmul(j16, h16),
        "gauss-newton step": gauss_newton_step,
    }
    for name, fn in public.items():
        log(f"  public {name}: {call_ms(torch, fn, reps=20):.4f} ms per call, "
            f"host {host_ms(torch, fn, reps=20):.4f} ms per call")

    # the step's device time, then each of its launches alone on the same
    # operands: the 4x4 JtHJ, the outer product, the elementwise add, the
    # solve (refine 1, the public default at N = 4) and the residual
    j4f = j4.reshape(B_MAIN, N_MAIN * N_MAIN)
    jhj4, gg = T.sym_matmul(j4, mat), T.sym_outer(vec)
    parts = {
        "jhj 4x4": lambda: P.launch_jhj(j4f, mat, N_MAIN),
        "outer": lambda: P.launch_outer(vec),
        "H + g gt": lambda: jhj4 + gg,
        "solve": lambda: sym_cuda.launch_solve(gn_h, vec, None, 1),
        "submatvec": lambda: P.launch_accmatvec(vec, gn_h, delta, -1.0),
    }
    gn_ms = device_ms(torch, gauss_newton_step)
    part_ms = {k: device_ms(torch, fn) for k, fn in parts.items()}
    if gn_ms is None or None in part_ms.values():
        fail("the Gauss-Newton step could not be queued ahead of the card")
    log(f"  gauss-newton step device time: {gn_ms:.4f} ms; its launches alone: "
        + ", ".join(f"{k} {v:.4f}" for k, v in part_ms.items())
        + f" ms (sum {sum(part_ms.values()):.4f} ms)")

    # the kernels line: each kernel alone at its path's shape, its plain
    # version and one PyTorch call on full storage as the yardstick
    j16f = j16.reshape(B_JHJ, K_JHJ * K_JHJ)
    full_t = torch.from_numpy(full).to(DEV)
    h16_full = torch.from_numpy(h16_np).to(DEV)
    item = 4
    nn = N_MAIN * (N_MAIN + 1) // 2
    rows = [
        ("sym_matvec_cf", 483, "matvec", lambda: P.launch_matvec(mat, vec),
         lambda: P.matvec_plain(mat, vec), lambda: torch.matmul(full_t, vec[..., None]),
         bound(B_MAIN * (nn + 2 * N_MAIN) * item, B_MAIN * ops_matvec(N_MAIN, False),
               "float32")),
        ("sym_addmatvec_cf/sym_submatvec_cf", 1441, ("addmatvec", "submatvec"),
         lambda: P.launch_accmatvec(acc, mat, vec, -1.0),
         lambda: P.accmatvec_plain(acc, mat, vec, -1.0),
         lambda: torch.baddbmm(acc[..., None], full_t, vec[..., None], alpha=-1.0),
         bound(B_MAIN * (nn + 3 * N_MAIN) * item, B_MAIN * ops_matvec(N_MAIN, True),
               "float32")),
        ("sym_outer_cf", 1538, "outer", lambda: P.launch_outer(vec),
         lambda: P.outer_plain(vec), lambda: torch.einsum("bi,bj->bij", vec, vec),
         bound(B_MAIN * (N_MAIN + nn) * item, B_MAIN * nn, "float32")),
        ("sym_matmul_cf", 1713, "jhj", lambda: P.launch_jhj(j16f, h16, K_JHJ),
         lambda: P.jhj_plain(j16f, h16, K_JHJ),
         lambda: torch.einsum("bki,bkl,blj->bij", j16, h16_full, j16),
         bound(B_JHJ * (K_JHJ * K_JHJ + 2 * K_JHJ * (K_JHJ + 1) // 2) * item,
               B_JHJ * ops_jhj(K_JHJ, K_JHJ), "float32")),
    ]
    kernels = []
    for name, line, counted, kern, plain, lib, (b_ms, b_by) in rows:
        diff, want = kern() - plain(), plain()
        err = diff.abs().max().item()
        rel = (diff.norm(dim=-1) / want.norm(dim=-1)).max().item()
        log(f"  {name} at full size: kernel vs plain max abs {err:.3e}, normwise {rel:.3e} "
            f"(tol {TOL_PLAIN['float32']:.0e})")
        if not rel <= TOL_PLAIN["float32"]:
            fail(f"{name} disagrees with its plain version: normwise {rel:.3e}")
        del diff, want
        ms = device_ms(torch, kern)
        if ms is None:
            fail(f"{name}: the kernel could not be queued ahead of the card")
        counted = (counted,) if isinstance(counted, str) else counted
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fastmath_tpu_torch/kernels/csrc/sym_products.cu",
            "replaces": f"fastmath_tpu/kernels/sym_pallas.py:{line}",
            "launches": sum(launches[c] for c in counted), "max_abs_err": err,
            "ms": ms, "plain_ms": call_ms(torch, plain, reps=5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": yardstick_ms(torch, lib, name)})
    for k in kernels:
        log(f"  {k['name']}: {k['ms']:.4f} ms (bound {k['bound_ms']:.4f} ms by "
            f"{k['bound_by']}, {k['bound_ms'] / k['ms'] * 100:.1f}% of it), plain "
            f"{k['plain_ms']:.4f} ms, library {k['library_ms']:.4f} ms")
    return kernels


# --- phase 6 -----------------------------------------------------------------

# bench/suite.py's batched shapes: batchinv 3x3 and 8x8 on 1M (:381-412),
# 16x16 on 500k (:468-480), 24x24 on 200k (:513-530); the 16x16 solve
# on 500k (:499-506)
INV_SHAPES = ((3, 1_000_000), (8, 1_000_000), (16, 500_000), (24, 200_000))
# timed beside its library call, not part of the path: the inverse's
# G = 32 lane groups at their widest
INV_TIMED = ((32, 100_000),)
# the solve timed beside its library call, not part of the path: (n,
# batch, k), the lane groups at the inverse's shapes with one column and
# 16 columns at 16 x 16; the staged n <= 8 tier at 8 x 8 on 1M with one
# column and eight
SOLVE_TIMED = ((24, 200_000, 1), (32, 100_000, 1), (16, 500_000, 16), (8, 1_000_000, 1),
               (8, 1_000_000, 8))
N_GATE, B_GATE = 16, 500_000
N_DENSE, B_DENSE = 40, 4096  # compact N > 32: sym_solve's torch.linalg tier


def ops_plu(n, k):
    """Arithmetic operations of one pivoted-LU solve of n x n with k
    right-hand-side columns, as the kernels do them: at step j the n-1-j
    multipliers (a reciprocal and products, or divisions), two per entry
    of the trailing (n-1-j) x (n-1-j) block and of the k columns, then
    back-substitution, two per off-diagonal entry and one scale per row,
    for each column (pivot comparisons are not counted)."""
    elim = sum((n - 1 - j) * (1 + 2 * (n - 1 - j + k)) for j in range(n))
    return elim + k * n * n


def ops_inv(n):
    """Arithmetic operations of one inverse: the cofactors, 1/det and the
    n^2 scaled entries for n <= 4, the solve against the identity's n
    columns above."""
    from fastmath_tpu_torch.kernels._gen_adjugate import cofactor_ops

    if n == 1:
        return 1
    return cofactor_ops(n) + 1 + n * n if n <= 4 else ops_plu(n, n)


def shape_row(shape, ms, plain_ms, b_ms, b_by, lib_ms):
    """One timed shape of a kernel, for its entry in the kernels line."""
    return {"shape": shape, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms}


def spd_on_card(torch, gen, b, n):
    """bench/suite.py's spd_batch recipe, a a^T + n I in float32, made on
    the card from a seeded generator."""
    a = torch.randn(b, n, n, generator=gen, device=DEV, dtype=torch.float32)
    return a @ a.mT + n * torch.eye(n, device=DEV)


def phase_batched(torch, rng):
    """The batched path at the bench suite's shapes: the public batchinv
    and batchlmdiv, sym_solve on full storage at bench.py's 1M x 4 x 4
    (the inverse kernel and batchmatvec) and on compact N = 40 (the
    torch.linalg tier, checked, not timed); launch counts, normwise error
    against float64 numpy, per-call, host and device times, and each
    kernel alone against its bound, its plain version and the library."""
    import fastmath_tpu_torch as T
    from fastmath_tpu_torch.kernels import batched_cuda as BC
    from fastmath_tpu_torch.layouts import full_to_sym

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEV)
    gen.manual_seed(int(rng.integers(2 ** 31)))
    mats = {n: spd_on_card(torch, gen, b, n) for n, b in INV_SHAPES}
    v16 = torch.randn(B_GATE, N_GATE, generator=gen, device=DEV)
    m4 = spd_on_card(torch, gen, B_MAIN, N_MAIN)
    full4 = m4.reshape(B_MAIN, N_MAIN * N_MAIN)
    v4 = torch.randn(B_MAIN, N_MAIN, generator=gen, device=DEV)
    c40 = full_to_sym(spd_on_card(torch, gen, B_DENSE, N_DENSE))
    v40 = torch.randn(B_DENSE, N_DENSE, generator=gen, device=DEV)
    torch.cuda.synchronize()

    counters = {"solve_full": BC.solve_full_cf, "inv": BC.inv_cf}
    for c in counters.values():
        c.launches = 0
    invs = {n: T.batchinv(a) for n, a in mats.items()}
    x16 = T.batchlmdiv(mats[N_GATE], v16)
    x4 = T.sym_solve(full4, v4)
    x40 = T.sym_solve(c40, v40)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    log("  batched-path launches: " + " ".join(f"{k}={v}" for k, v in launches.items()))
    if not all(v >= 1 for v in launches.values()):
        fail(f"the batched path did not go through both kernels: {launches}")
    outs = [(f"batchinv {n}x{n}", invs[n], (b, n, n)) for n, b in INV_SHAPES]
    outs += [(f"batchlmdiv {N_GATE}x{N_GATE}", x16, (B_GATE, N_GATE)),
             ("sym_solve full 4x4", x4, (B_MAIN, N_MAIN)),
             (f"sym_solve compact N={N_DENSE}", x40, (B_DENSE, N_DENSE))]
    for name, y, shape in outs:
        if tuple(y.shape) != shape or not torch.isfinite(y).all():
            fail(f"{name} output has the wrong shape or is not finite")

    # normwise error against float64 numpy on a slice of each batch
    ns = 4096
    d64 = lambda t: t[:ns].double().cpu().numpy()  # noqa: E731
    errs = {f"batchinv {n}x{n} on {b}": normwise(
        d64(invs[n]).reshape(-1, n * n), np.linalg.inv(d64(mats[n])).reshape(-1, n * n))
        for n, b in INV_SHAPES}
    errs[f"batchlmdiv {N_GATE}x{N_GATE} on {B_GATE}"] = normwise(
        d64(x16), oracle_solve(d64(mats[N_GATE]), d64(v16)))
    errs[f"sym_solve full 4x4 on {B_MAIN}"] = normwise(d64(x4), oracle_solve(d64(m4), d64(v4)))
    errs[f"sym_solve compact N={N_DENSE} on {B_DENSE}"] = normwise(
        d64(x40), oracle_solve(T.layouts.sym_to_full(c40[:ns]).double().cpu().numpy(), d64(v40)))
    for name, e in errs.items():
        log(f"  {name} f32 normwise vs f64 ({len(e)} problems): median={np.median(e):.3e} "
            f"p99={np.quantile(e, 0.99):.3e} max={e.max():.3e} (gate {GATE:.0e})")
        if not e.max() <= GATE:
            fail(f"{name}: normwise error {e.max():.3e} > {GATE}")

    # the public ops per call (host launch included), the host's share,
    # and the card's time
    public = {f"batchinv {n}x{n} on {b}": (lambda a=mats[n]: T.batchinv(a))
              for n, b in INV_SHAPES}
    public[f"batchlmdiv {N_GATE}x{N_GATE} on {B_GATE}"] = lambda: T.batchlmdiv(mats[N_GATE], v16)
    public[f"sym_solve full 4x4 on {B_MAIN}"] = lambda: T.sym_solve(full4, v4)
    for name, fn in public.items():
        dev = device_ms(torch, fn, reps=10)
        log(f"  public {name}: {call_ms(torch, fn, reps=10):.4f} ms per call, "
            f"host {host_ms(torch, fn, reps=10):.4f} ms, device "
            + ("not measured (waits for the card)" if dev is None else f"{dev:.4f} ms"))

    # each kernel alone against its bound, the library call on the same
    # tensors (timed only), and the plain version; the inverse also at
    # the 4x4 of sym_solve on full storage and at INV_TIMED
    alone = {**mats, N_MAIN: m4}
    alone.update({n: spd_on_card(torch, gen, b, n) for n, b in INV_TIMED})
    flat = {n: a.reshape(-1, n * n) for n, a in alone.items()}
    rows = {}
    for n, b in INV_SHAPES + ((N_MAIN, B_MAIN),) + INV_TIMED:
        kern = lambda f=flat[n]: BC.launch_inv(f)  # noqa: E731
        rows[f"inv {n}x{n} on {b}"] = (
            "inv", kern, lambda f=flat[n]: BC.inv_plain(f),
            lambda a=alone[n]: torch.linalg.inv_ex(a),
            bound(b * 2 * n * n * 4, b * ops_inv(n), "float32"))
    for n, b, k in ((N_GATE, B_GATE, 1),) + SOLVE_TIMED:
        rhs = v16 if (n, b, k) == (N_GATE, B_GATE, 1) else torch.randn(
            b, n * k, generator=gen, device=DEV)
        rows[f"solve {n}x{n} on {b}" + (f" k={k}" if k > 1 else "")] = (
            "solve_full", lambda f=flat[n], r=rhs, k=k: BC.launch_solve_full(f, r, k),
            lambda f=flat[n], r=rhs, k=k: BC.solve_full_plain(f, r, k),
            lambda a=alone[n], r=rhs, n=n, k=k: torch.linalg.solve_ex(a, r.reshape(-1, n, k)),
            bound(b * (n * n + 2 * n * k) * 4, b * ops_plu(n, k), "float32"))
    kernels, shapes = [], {"inv": [], "solve_full": []}
    for name, (counted, kern, plain, lib, (b_ms, b_by)) in rows.items():
        y, want = kern(), plain()
        diff = y.reshape(want.shape) - want
        err = diff.abs().max().item()
        rel = (diff.norm(dim=-1) / want.norm(dim=-1)).max().item()
        del y, diff
        if not rel <= TOL_PLAIN["float32"]:
            fail(f"{name}: kernel disagrees with its plain version: normwise {rel:.3e}")
        ms = device_ms(torch, kern, reps=10)
        if ms is None:
            fail(f"{name}: the kernel could not be queued ahead of the card")
        plain_ms = call_ms(torch, plain, reps=3, warmup=1)
        lib_ms = yardstick_ms(torch, lib, name)
        log(f"  {name} kernel: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
            f"{b_ms / ms * 100:.1f}% of it), plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
            f"kernel vs plain max abs {err:.3e}, normwise {rel:.3e}")
        shapes[counted].append(shape_row(name.split(" ", 1)[1], ms, plain_ms, b_ms, b_by, lib_ms))
        if name in (f"inv {N_GATE}x{N_GATE} on {B_GATE}", f"solve {N_GATE}x{N_GATE} on {B_GATE}"):
            line = 184 if counted == "inv" else 248
            kernels.append({
                "name": f"{counted}_cf", "route": "cuda",
                "source": "fastmath_tpu_torch/kernels/csrc/batched.cu",
                "replaces": f"fastmath_tpu/kernels/batched_pallas.py:{line}",
                "launches": launches[counted], "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
    for k in kernels:
        k["shapes"] = shapes[k["name"].removesuffix("_cf")]
    return kernels


# --- phase 7 -----------------------------------------------------------------

# bench/suite.py's factor shapes: batchchol 3x3 and 8x8 on 1M (:412-417),
# 16x16 on 500k (:456-467), 24x24 on 200k (:529-537); batchlogdet 16x16
# on 500k and 32x32 on 100k (:543-552); batchdet 3x3 and 8x8 on 1M;
# sym_det / sym_invert on bench.py's 1M x 4 batch and at N = 16
CHOL_SHAPES = ((3, 1_000_000), (8, 1_000_000), (16, 500_000), (24, 200_000))
LOGDET_SHAPES = ((16, 500_000), (32, 100_000))
DET_SHAPES = ((3, 1_000_000), (8, 1_000_000))
SYM_SHAPES = ((4, 1_000_000), (16, 262_144))
# timed beside their library calls, not part of the path: the determinant
# at log|det|'s shapes and at 4 x 4 on 1M (the smallest staged n), and the
# compact determinant at N = 32, on (a a^T + n I) / n (in float32 range at
# 32); log|det| at 8 x 8 on 1M (staged); the compact inverse at N = 32 and
# at N = 8 on 1M (the widest staged one-thread problem)
DET_TIMED = ((16, 500_000), (32, 100_000), (4, 1_000_000))
LOGDET_TIMED = ((8, 1_000_000),)
SYM_DET_TIMED = ((32, 65_536),)
SYM_INVERT_TIMED = ((32, 65_536), (8, 1_000_000))
# the Cholesky factor's G = 32 lane groups at their widest
CHOL_TIMED = ((32, 100_000),)
# the shape of each kernel's row in the kernels line
FACTOR_ROWS = {"det": 8, "logdet": 16, "chol": 16, "sym_det": 16, "sym_invert": 4}


def ops_det(n):
    """Arithmetic operations of one determinant as the kernels do it: the
    expansion for n <= 4; the pivoted LU's elimination and the product of
    the n pivots above."""
    from fastmath_tpu_torch.kernels._gen_adjugate import det_ops

    return det_ops(n) if n <= 4 else ops_plu(n, 0) + n - 1


def ops_logdet(n):
    """One log|det|: for n <= 4 the row scales (a reciprocal each, n^2
    products), the expansion, n + 1 logs and n adds; above, the LU's
    elimination, n logs and n - 1 adds (a log counts as one operation)."""
    from fastmath_tpu_torch.kernels._gen_adjugate import det_ops

    if n <= 4:
        return n + n * n + det_ops(n) + 2 * n + 1
    return ops_plu(n, 0) + 2 * n - 1


def ops_chol(n):
    """One Cholesky factor as the kernel does it: Banachiewicz up to
    n = 8 (each entry's dot product, a square root and a reciprocal per
    column, a scale per entry below), the outer-product form above (a
    reciprocal square root and n - k scales per column, two operations
    per entry of the trailing triangle)."""
    if n <= 8:
        return sum(2 * j + 2 + (n - 1 - j) * (2 * j + 1) for j in range(n))
    return sum(1 + (n - k) + (n - k - 1) * (n - k) for k in range(n))


def ops_sym_invert(n):
    """One compact inverse: the compact cofactors, 1/det and the scaled
    slots for n <= 4; the solve against the identity's n columns and the
    averaged upper slots above."""
    from fastmath_tpu_torch.kernels._gen_adjugate import compact_inverse_ops

    if n == 1:
        return 1
    return compact_inverse_ops(n) if n <= 4 else ops_plu(n, n) + n * (n - 1)


def phase_factor(torch, rng, mat4):
    """The factor path at the bench suite's shapes, through the public
    ops: launch counts, the error against float64 numpy on 4,096
    problems, per-call, host and device times, and each kernel alone
    against its byte bound, its plain version and one torch.linalg call.
    ``mat4`` is phase 4's 1M x 4 compact batch (bench.py's)."""
    import fastmath_tpu_torch as T
    from fastmath_tpu_torch.kernels import batched_cuda as BC
    from fastmath_tpu_torch.kernels import sym_factor as SF
    from fastmath_tpu_torch.layouts import full_to_sym, sym_to_full

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEV)
    gen.manual_seed(int(rng.integers(2 ** 31)))
    sizes = sorted({*CHOL_SHAPES, *LOGDET_SHAPES, *DET_SHAPES, *CHOL_TIMED, *DET_TIMED,
                    *LOGDET_TIMED})
    full = {nb: spd_on_card(torch, gen, nb[1], nb[0]) for nb in sizes}
    comp = {(4, B_MAIN): mat4,
            SYM_SHAPES[1]: full_to_sym(spd_on_card(torch, gen, SYM_SHAPES[1][1],
                                                   SYM_SHAPES[1][0])).contiguous()}
    torch.cuda.synchronize()

    counters = {"det": BC.det_cf, "logdet": BC.logdet_cf, "chol": BC.chol_cf,
                "sym_det": SF.sym_det_cf, "sym_invert": SF.sym_invert_cf}
    for c in counters.values():
        c.launches = 0
    outs = {}
    for n, b in CHOL_SHAPES:
        outs[("chol", n, b)] = T.batchchol(full[n, b])
    for n, b in LOGDET_SHAPES:
        outs[("logdet", n, b)] = T.batchlogdet(full[n, b])
    for n, b in DET_SHAPES:
        outs[("det", n, b)] = T.batchdet(full[n, b])
    for n, b in SYM_SHAPES:
        outs[("sym_det", n, b)] = T.sym_det(comp[n, b])
        outs[("sym_invert", n, b)] = T.sym_invert(comp[n, b])
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    log("  factor-path launches: " + " ".join(f"{k}={v}" for k, v in launches.items()))
    if not all(v >= 1 for v in launches.values()):
        fail(f"the factor path did not go through every kernel: {launches}")

    # the error against float64 numpy on 4,096 problems of each batch
    ns = 4096
    for (op, n, b), y in outs.items():
        shape = {"chol": (b, n, n), "sym_invert": (b, n * (n + 1) // 2)}.get(op, (b,))
        if tuple(y.shape) != shape or not torch.isfinite(y).all():
            fail(f"{op} {n}x{n} on {b}: output has the wrong shape or is not finite")
        got = y[:ns].double().cpu().numpy()
        if op in ("sym_det", "sym_invert"):
            a64 = sym_to_full(comp[n, b][:ns]).double().cpu().numpy()
        else:
            a64 = full[n, b][:ns].double().cpu().numpy()
        if op == "chol":
            e = normwise(got.reshape(len(got), -1), np.linalg.cholesky(a64).reshape(len(got), -1))
        elif op == "sym_invert":
            e = normwise(got, compact(np.linalg.inv(a64)))
        elif op == "logdet":
            e = log_err(got, np.linalg.slogdet(a64)[1])
        else:
            e = normwise(got[:, None], np.linalg.det(a64)[:, None])
        kind = {"chol": "normwise", "sym_invert": "normwise",
                "logdet": "abs over max(1, |logdet|)"}.get(op, "relative")
        log(f"  {op} {n}x{n} on {b} f32 {kind} vs f64 ({len(e)} problems): median="
            f"{np.median(e):.3e} p99={np.quantile(e, 0.99):.3e} max={e.max():.3e} "
            f"(gate {GATE:.0e})")
        if not e.max() <= GATE:
            fail(f"{op} {n}x{n} on {b}: error {e.max():.3e} > {GATE}")
    del outs

    # each public op per call (host launch included), its host share and
    # its device time; then each kernel alone against its bound, its plain
    # version and one library call on the same inputs (timed only)
    # op: the public op, the kernel's launch and plain version, the TPU
    # kernel it replaces and its CUDA source
    spec = {
        "chol": (T.batchchol, BC.launch_chol, BC.chol_plain, "batched_pallas.py:226",
                 "batched.cu"),
        "logdet": (T.batchlogdet, BC.launch_logdet, BC.logdet_plain, "batched_pallas.py:123",
                   "batched.cu"),
        "det": (T.batchdet, BC.launch_det, BC.det_plain, "batched_pallas.py:123", "batched.cu"),
        "sym_det": (T.sym_det, SF.launch_sym_det, SF.sym_det_plain, "sym_pallas.py:1599",
                    "sym_factor.cu"),
        "sym_invert": (T.sym_invert, SF.launch_sym_invert, SF.invert_plain,
                       "sym_pallas.py:493", "sym_factor.cu"),
    }
    kernels, timed = [], {op: [] for op in spec}
    for op, shapes in (("chol", CHOL_SHAPES + CHOL_TIMED),
                       ("logdet", LOGDET_SHAPES + LOGDET_TIMED),
                       ("det", DET_SHAPES + DET_TIMED), ("sym_det", SYM_SHAPES + SYM_DET_TIMED),
                       ("sym_invert", SYM_SHAPES + SYM_INVERT_TIMED)):
        for n, b in shapes:
            nn = n * (n + 1) // 2
            if op in ("sym_det", "sym_invert"):
                if (n, b) not in comp:  # a timed shape
                    comp[n, b] = full_to_sym(spd_on_card(torch, gen, b, n)).contiguous()
                inp = arg = (comp[n, b] / n if op == "sym_det" and (n, b) in SYM_DET_TIMED
                             else comp[n, b])
                dense = sym_to_full(inp)
                lib = ((lambda d=dense: torch.linalg.det(d)) if op == "sym_det"
                       else (lambda d=dense: torch.linalg.inv_ex(d)))
                nbytes = (nn + 1) * 4 if op == "sym_det" else 2 * nn * 4
                nops = ops_det(n) if op == "sym_det" else ops_sym_invert(n)
            else:
                inp = a = full[n, b] / n if op == "det" and (n, b) in DET_TIMED else full[n, b]
                if op == "chol":
                    arg = full_to_sym(a).contiguous()
                    lib = lambda a=a: torch.linalg.cholesky_ex(a)  # noqa: E731
                    nbytes, nops = 2 * nn * 4, ops_chol(n)
                else:
                    arg = a.reshape(b, n * n)
                    lib = ((lambda a=a: torch.linalg.slogdet(a)) if op == "logdet"
                           else (lambda a=a: torch.linalg.det(a)))
                    nbytes = (n * n + 1) * 4
                    nops = ops_logdet(n) if op == "logdet" else ops_det(n)
            public, launch_fn, plain_fn, replaces, source = spec[op]
            pub = lambda f=public, t=inp: f(t)  # noqa: E731
            dev = device_ms(torch, pub, reps=10)
            log(f"  public {op} {n}x{n} on {b}: {call_ms(torch, pub, reps=10):.4f} ms per call, "
                f"host {host_ms(torch, pub, reps=10):.4f} ms, device "
                + ("not measured (waits for the card)" if dev is None else f"{dev:.4f} ms"))
            kern = lambda f=launch_fn, t=arg: f(t)  # noqa: E731
            plain = lambda f=plain_fn, t=arg: f(t)  # noqa: E731
            y, want = kern(), plain()
            diff = (y - want).reshape(b, -1)
            err = diff.abs().max().item()
            if op == "logdet":
                rel = (diff[:, 0].abs() / want.abs().clamp_min(1.0)).max().item()
            else:
                rel = (diff.norm(dim=-1) / want.reshape(b, -1).norm(dim=-1)).max().item()
            del y, want, diff
            if not rel <= TOL_PLAIN["float32"]:
                fail(f"{op} {n}x{n} on {b}: kernel disagrees with its plain version: {rel:.3e}")
            ms = device_ms(torch, kern, reps=10)
            if ms is None:
                fail(f"{op} {n}x{n} on {b}: the kernel could not be queued ahead of the card")
            plain_ms = call_ms(torch, plain, reps=3, warmup=1)
            lib_ms = yardstick_ms(torch, lib, f"{op} library")
            b_ms, b_by = bound(b * nbytes, b * nops, "float32")
            log(f"  {op} {n}x{n} on {b} kernel: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
                f"{b_ms / ms * 100:.1f}% of it), plain {plain_ms:.4f} ms, library "
                f"{lib_ms:.4f} ms, kernel vs plain max abs {err:.3e}, error {rel:.3e}")
            timed[op].append(shape_row(f"{n}x{n} on {b}", ms, plain_ms, b_ms, b_by, lib_ms))
            if n == FACTOR_ROWS[op]:
                kernels.append({
                    "name": f"{op}_cf", "route": "cuda",
                    "source": f"fastmath_tpu_torch/kernels/csrc/{source}",
                    "replaces": f"fastmath_tpu/kernels/{replaces}",
                    "launches": launches[op], "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": lib_ms})
    for k in kernels:
        k["shapes"] = timed[k["name"].removesuffix("_cf")]
    return kernels


# --- phase 8 -----------------------------------------------------------------

# bench/suite.py's shapes: the matvec chain at (4, 128) and (16, 32) on
# its 1M batch, contraction-scaled by 1/(6n) (:336-370); the power
# iteration at 4 x 4 and 8 x 8 on 1M, iters 32, gap-boosted (:715-740);
# batchmatmul 16 x 16 on 500k (:478-496) and 4 x 4 on 1M
CHAIN_SHAPES = ((4, 128, 1_000_000), (16, 32, 1_000_000))
# timed beside the path: the chain's group of 32 lanes, the power
# iteration's groups of 16 and 32 lanes
CHAIN_WIDE = (32, 32, 262_144)
MAXEIG_SHAPES = ((4, 1_000_000), (8, 1_000_000))
MAXEIG_GROUPS = ((16, 1_000_000), (32, 262_144))
MAXEIG_ITERS, MAXEIG_RENORM = 32, 8
MATMUL_SHAPES = ((16, 500_000), (4, 1_000_000), (32, 100_000))
# batch of each size in the routing sweeps: 256 MB or less per operand
SWEEP_NS = (4, 5, 6, 8, 9, 12, 16, 24, 32)


def kernel_ms(torch, fn, what, reps=10):
    """device_ms of a kernel's launch; the run fails if it cannot be
    queued ahead of the card."""
    t = device_ms(torch, fn, reps=reps)
    if t is None:
        fail(f"{what}: the kernel could not be queued ahead of the card")
    return t


def sweep_batch(n):
    return min(1_000_000, (64 << 20) // (n * n))


def ops_chain_mv(n, iters):
    """One matvec chain: per step n rows of n products summed (n(2n - 1))
    and the n adds of c."""
    return iters * (n * (2 * n - 1) + n)


def ops_maxeig(n, iters, r):
    """One power iteration as the kernel does it: the Gershgorin bound
    (n(2n - 1) abs-adds, n - 1 maxima), the scaled matrix (n^2), iters + 1
    matvecs (n(2n - 1) each), iters // r + 2 renormalizations (2n - 1 for
    |v|^2, an rsqrt, n scales) and the Rayleigh quotient (2n)."""
    mv = n * (2 * n - 1)
    return mv + n - 1 + n * n + (iters + 1) * mv + (iters // r + 2) * (3 * n) + 2 * n


def chain_input(torch, gen, n, k, b):
    """(k, mat, vec, add) of the matvec chain: bench/suite.py's 1/(6n)
    scale, capped so that every matrix's Gershgorin bound stays at or under
    0.95 (a 1M batch of a a^T + n I holds matrices whose spectral radius
    exceeds 1 at 1/(6n), and their recurrence overflows within 128 steps)."""
    from fastmath_tpu_torch.layouts import full_to_sym

    a = spd_on_card(torch, gen, b, n)
    scale = 1.0 / torch.clamp(a.abs().sum(dim=-1).amax(dim=-1) / 0.95, min=6.0 * n)
    mat = full_to_sym(a * scale[:, None, None]).contiguous()
    del a, scale
    return (k, mat, torch.randn(b, n, generator=gen, device=DEV),
            torch.randn(b, n, generator=gen, device=DEV))


def maxeig_input(torch, gen, n, b):
    """bench/suite.py's gap-boosted power-iteration input, and start
    vectors u + r / 2 for the kernels alone (a start vector nearly
    orthogonal to the dominant eigenvector, which a 1M batch of random
    ones holds, makes the first steps amplify every rounding)."""
    from fastmath_tpu_torch.layouts import full_to_sym

    u, r = (x / x.norm(dim=-1, keepdim=True)
            for x in (torch.randn(b, n, generator=gen, device=DEV) for _ in range(2)))
    mat = full_to_sym(spd_on_card(torch, gen, b, n)
                      + 8.0 * n * u[:, :, None] * u[:, None, :]).contiguous()
    return mat, u + r / 2


def phase_iterate(torch, rng):
    """The iterations and the full-storage products at the bench suite's
    shapes, through the public ops; launch counts, gated errors, per-call,
    host and device times, each kernel alone against its bound, its plain
    version and torch.matmul; then the routing sweeps."""
    import fastmath_tpu_torch as T
    from fastmath_tpu_torch.kernels import batched_cuda as BC
    from fastmath_tpu_torch.kernels import sym_iterate as SI
    from fastmath_tpu_torch.layouts import sym_to_full

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEV)
    gen.manual_seed(int(rng.integers(2 ** 31)))
    chain_in = {n: chain_input(torch, gen, n, k, b) for n, k, b in CHAIN_SHAPES}
    eig_in, eig_start = {}, {}
    for n, b in MAXEIG_SHAPES:
        eig_in[n], eig_start[n] = maxeig_input(torch, gen, n, b)
    mm_in = {n: (torch.randn(b, n, n, generator=gen, device=DEV),
                 torch.randn(b, n, n, generator=gen, device=DEV)) for n, b in MATMUL_SHAPES}
    m4 = spd_on_card(torch, gen, B_MAIN, N_MAIN)
    full4 = m4.reshape(B_MAIN, N_MAIN * N_MAIN)
    v4 = torch.randn(B_MAIN, N_MAIN, generator=gen, device=DEV)
    torch.cuda.synchronize()

    counters = {"chain": SI.sym_matvec_chain_cf, "maxeig": SI.sym_maxeig_cf,
                "matvec_full": BC.matvec_full_cf, "matmul": BC.matmul_cf}
    for c in counters.values():
        c.launches = 0
    outs = {}
    for n, (k, mat, vec, add) in chain_in.items():
        outs["chain", n] = T.sym_matvec_chain(mat, vec, k, add=add)
    for n, mat in eig_in.items():
        outs["maxeig", n] = T.sym_maxeig(mat, iters=MAXEIG_ITERS)
    for n, (a, b) in mm_in.items():
        for backend in ("auto", "cuda"):
            outs[f"matmul {backend}", n] = T.batchmatmul(a, b, backend=backend)
    outs["sym_solve full", N_MAIN] = T.sym_solve(full4, v4)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    log("  iterate-path launches: " + " ".join(f"{k}={v}" for k, v in launches.items()))
    if not all(v >= 1 for v in launches.values()):
        fail(f"the iterate path did not go through every kernel: {launches}")

    # errors against float64 numpy on a slice of each batch
    ns = 2048
    for (op, n), y in outs.items():
        b = y.shape[0]
        if not torch.isfinite(y).all():
            fail(f"{op} {n}: output is not finite")
        if op == "chain":
            k, mat, vec, add = chain_in[n]
            a64 = sym_to_full(mat[:ns]).double().cpu().numpy()
            c64 = add[:ns].double().cpu().numpy()
            x64 = vec[:ns].double().cpu().numpy()
            for _ in range(k):
                x64 = np.einsum("bij,bj->bi", a64, x64) + c64
            e = normwise(y[:ns].cpu().numpy(), x64, c64)
            what = f"sym_matvec_chain {n}x{n} k={k} on {b} normwise (over |x| + |add|)"
            gate = e.max()
        elif op == "maxeig":
            nse = 8192
            want = dominant(sym_to_full(eig_in[n][:nse]).double().cpu().numpy())
            e = np.abs(y[:nse].double().cpu().numpy() - want) / np.abs(want)
            what = f"sym_maxeig {n}x{n} iters={MAXEIG_ITERS} on {b} relative vs eigvalsh"
            gate = np.median(e)
        elif op == "sym_solve full":
            e = normwise(y[:ns].cpu().numpy(), oracle_solve(m4[:ns].double().cpu().numpy(),
                                                            v4[:ns].double().cpu().numpy()))
            what, gate = f"sym_solve full 4x4 on {B_MAIN} normwise", e.max()
        else:
            a, bm = mm_in[n]
            want = a[:ns].double().cpu().numpy() @ bm[:ns].double().cpu().numpy()
            e = normwise(y[:ns].cpu().numpy().reshape(len(want), -1), want.reshape(len(want), -1))
            what, gate = f"batch{op} {n}x{n} on {b} normwise", e.max()
        log(f"  {what} ({len(e)} problems): median={np.median(e):.3e} "
            f"p99={np.quantile(e, 0.99):.3e} max={e.max():.3e} (gate {GATE:.0e} on the "
            f"{'median' if op == 'maxeig' else 'max'})")
        if not gate <= GATE:
            fail(f"{what}: error {gate:.3e} > {GATE}")
    del outs

    # the public ops per call (host launch included), the host's share and
    # the card's time
    public = {f"sym_matvec_chain {n}x{n} k={k}": (lambda m=m, v=v, c=c, k=k:
                                                T.sym_matvec_chain(m, v, k, add=c))
              for n, (k, m, v, c) in chain_in.items()}
    public.update({f"sym_maxeig {n}x{n}": (lambda m=m: T.sym_maxeig(m, iters=MAXEIG_ITERS))
                   for n, m in eig_in.items()})
    for n, (a, b) in mm_in.items():
        for backend in ("auto", "cuda"):
            public[f"batchmatmul {n}x{n} {backend}"] = (
                lambda a=a, b=b, bk=backend: T.batchmatmul(a, b, backend=bk))
    public[f"sym_solve full 4x4 on {B_MAIN}"] = lambda: T.sym_solve(full4, v4)
    for name, fn in public.items():
        dev = device_ms(torch, fn, reps=10)
        log(f"  public {name}: {call_ms(torch, fn, reps=10):.4f} ms per call, "
            f"host {host_ms(torch, fn, reps=10):.4f} ms, device "
            + ("not measured (waits for the card)" if dev is None else f"{dev:.4f} ms"))

    # each kernel alone at the path's shape against its bound, its plain
    # version and one PyTorch call (timed only, never called by the port)
    k4, mat4, vec4, add4 = chain_in[4]
    nn4 = N_MAIN * (N_MAIN + 1) // 2
    a16, b16 = (x.reshape(x.shape[0], -1) for x in mm_in[16])
    rows = [
        ("sym_matvec_chain_cf", "chain", "sym_iterate.cu", "sym_pallas.py:934",
         lambda: SI.launch_matvec_chain(mat4, vec4, add4, k4),
         lambda: SI.matvec_chain_plain(mat4, vec4, add4, k4), None,
         bound(B_MAIN * (nn4 + 3 * N_MAIN) * 4, B_MAIN * ops_chain_mv(N_MAIN, k4), "float32"),
         "1M x 4 x 4, k = 128"),
        ("sym_maxeig_cf", "maxeig", "sym_iterate.cu", "sym_pallas.py:1059",
         lambda: SI.launch_maxeig(eig_in[4], eig_start[4], MAXEIG_ITERS, MAXEIG_RENORM),
         lambda: SI.maxeig_plain(eig_in[4], eig_start[4], MAXEIG_ITERS, MAXEIG_RENORM), None,
         bound(B_MAIN * (nn4 + 2 * N_MAIN + 1) * 4,
               B_MAIN * ops_maxeig(N_MAIN, MAXEIG_ITERS, MAXEIG_RENORM), "float32"),
         "1M x 4 x 4, iters = 32"),
        ("matvec_full_cf", "matvec_full", "batched_products.cu", "batched_pallas.py:270",
         lambda: BC.launch_matvec_full(full4, v4), lambda: BC.matvec_full_plain(full4, v4),
         lambda: torch.matmul(m4, v4[..., None]),
         bound(B_MAIN * (N_MAIN * N_MAIN + 2 * N_MAIN) * 4,
               B_MAIN * N_MAIN * (2 * N_MAIN - 1), "float32"), "1M x 4 x 4"),
        ("matmul_cf", "matmul", "batched_products.cu", "batched_pallas.py:753",
         lambda: BC.launch_matmul(a16, b16, 16, 16, 16),
         lambda: BC.matmul_plain(a16, b16, 16, 16, 16),
         lambda: torch.matmul(*mm_in[16]),
         bound(MATMUL_SHAPES[0][1] * 3 * 256 * 4, MATMUL_SHAPES[0][1] * 256 * 31, "float32"),
         "16 x 16 on 500k"),
    ]
    kernels = []
    for name, counted, source, replaces, kern, plain, lib, (b_ms, b_by), shape in rows:
        y, want = kern(), plain()
        diff = (y - want).reshape(y.shape[0], -1)
        err = diff.abs().max().item()
        if counted == "maxeig":  # mu over the Gershgorin bound, v normwise
            gersh = sym_to_full(eig_in[4]).abs().sum(dim=-1).amax(dim=-1)
            rel = max((diff[:, 0].abs() / gersh).max().item(),
                      (diff[:, 1:].norm(dim=-1) / want[:, 1:].norm(dim=-1)).max().item())
        elif counted == "chain":
            rel = (diff.norm(dim=-1) / (want.norm(dim=-1) + add4.norm(dim=-1))).max().item()
        else:
            rel = (diff.norm(dim=-1) / want.reshape(y.shape[0], -1).norm(dim=-1)).max().item()
        del y, want, diff
        if not rel <= TOL_PLAIN["float32"]:
            fail(f"{name} at {shape}: kernel disagrees with its plain version: {rel:.3e}")
        ms = kernel_ms(torch, kern, name)
        plain_ms = call_ms(torch, plain, reps=3, warmup=1)
        lib_ms = None if lib is None else yardstick_ms(torch, lib, name)
        log(f"  {name} {shape} kernel: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
            f"{b_ms / ms * 100:.1f}% of it), plain {plain_ms:.4f} ms, library "
            + ("none" if lib_ms is None else f"{lib_ms:.4f} ms")
            + f", kernel vs plain max abs {err:.3e}, error {rel:.3e}")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"fastmath_tpu_torch/kernels/csrc/{source}",
            "replaces": f"fastmath_tpu/kernels/{replaces}", "launches": launches[counted],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms})
    # the other shapes of the path, and the lane-group chain's widest group
    # (n = 32 on about the bytes of 16 x 16 on 1M) and the power
    # iteration's groups (16 x 16 on 1M, 32 x 32 on 262,144), kernel alone
    # beside its plain version, for the kernels' rows
    chain_in[32] = chain_input(torch, gen, *CHAIN_WIDE)
    chain_rows, maxeig_rows = [], []
    for n in (16, 32):
        k, mat, vec, add = chain_in[n]
        b = mat.shape[0]
        d = (SI.launch_matvec_chain(mat[:4096], vec[:4096], add[:4096], k)
             - SI.matvec_chain_plain(mat[:4096], vec[:4096], add[:4096], k))
        rel = (d.norm(dim=-1) / (SI.matvec_chain_plain(mat[:4096], vec[:4096], add[:4096], k)
                                 .norm(dim=-1) + add[:4096].norm(dim=-1))).max().item()
        if not rel <= TOL_PLAIN["float32"]:
            fail(f"sym_matvec_chain_cf {n}x{n}: kernel vs plain {rel:.3e}")
        t = kernel_ms(torch, lambda: SI.launch_matvec_chain(mat, vec, add, k), f"chain {n}",
                      reps=5)
        t_plain = call_ms(torch, lambda: SI.matvec_chain_plain(mat, vec, add, k), reps=3,
                          warmup=1)
        nn = n * (n + 1) // 2
        b_ms, b_by = bound(b * (nn + 3 * n) * 4, b * ops_chain_mv(n, k), "float32")
        chain_rows.append(shape_row(f"{n}x{n}, k = {k} on {b}", t, t_plain, b_ms, b_by, None))
        log(f"  sym_matvec_chain_cf {n}x{n} k={k} on {b} kernel: {t:.4f} ms (bound {b_ms:.4f} "
            f"ms by {b_by}, {b_ms / t * 100:.1f}% of it), plain {t_plain:.4f} ms, vs plain "
            f"{rel:.3e}")
    del chain_in
    for n, b in ((8, None),) + MAXEIG_GROUPS:
        if b is not None:
            eig_in[n], eig_start[n] = maxeig_input(torch, gen, n, b)
        b = eig_in[n].shape[0]
        fn = (f"maxeig_unrolled<float, {n}>" if n <= 8
              else f"maxeig_groups<float, {16 if n <= 16 else 32}>")
        m, v = eig_in[n][:4096], eig_start[n][:4096]
        want = SI.maxeig_plain(m, v, MAXEIG_ITERS, MAXEIG_RENORM)
        d = SI.launch_maxeig(m, v, MAXEIG_ITERS, MAXEIG_RENORM) - want
        gersh = sym_to_full(m).abs().sum(dim=-1).amax(dim=-1)
        rel = max((d[:, 0].abs() / gersh).max().item(),
                  (d[:, 1:].norm(dim=-1) / want[:, 1:].norm(dim=-1)).max().item())
        if not rel <= TOL_PLAIN["float32"]:
            fail(f"sym_maxeig_cf {n}x{n} ({fn}): kernel vs plain {rel:.3e}")
        del m, v, d, want, gersh
        t = kernel_ms(torch, lambda: SI.launch_maxeig(eig_in[n], eig_start[n], MAXEIG_ITERS,
                                                      MAXEIG_RENORM), f"maxeig {n}")
        t_plain = call_ms(torch, lambda: SI.maxeig_plain(eig_in[n], eig_start[n], MAXEIG_ITERS,
                                                         MAXEIG_RENORM), reps=3, warmup=1)
        nn = n * (n + 1) // 2
        b_ms, b_by = bound(b * (nn + 2 * n + 1) * 4,
                           b * ops_maxeig(n, MAXEIG_ITERS, MAXEIG_RENORM), "float32")
        maxeig_rows.append(shape_row(f"{n}x{n}, iters = {MAXEIG_ITERS} on {b} ({fn})", t,
                                     t_plain, b_ms, b_by, None))
        log(f"  sym_maxeig_cf {n}x{n} on {b} kernel ({fn}): {t:.4f} ms (bound {b_ms:.4f} ms by "
            f"{b_by}, {b_ms / t * 100:.1f}% of it), plain {t_plain:.4f} ms, vs plain {rel:.3e}")
        if n > 8:
            del eig_in[n], eig_start[n]
    next(k for k in kernels if k["name"] == "sym_matvec_chain_cf")["shapes"] = chain_rows
    next(k for k in kernels if k["name"] == "sym_maxeig_cf")["shapes"] = maxeig_rows
    # the product at each shape of the path, kernel alone, for its row
    mm_rows = []
    for n, b in MATMUL_SHAPES:
        af, bf = (x.reshape(b, -1) for x in mm_in[n])
        t = kernel_ms(torch, lambda: BC.launch_matmul(af, bf, n, n, n), f"matmul {n}")
        t_plain = call_ms(torch, lambda: BC.matmul_plain(af, bf, n, n, n), reps=3, warmup=1)
        t_lib = yardstick_ms(torch, lambda: torch.matmul(*mm_in[n]), "matmul")
        b_ms, b_by = bound(b * 3 * n * n * 4, b * n * n * (2 * n - 1), "float32")
        mm_rows.append(shape_row(f"{n}x{n} on {b}", t, t_plain, b_ms, b_by, t_lib))
        log(f"  matmul_cf {n}x{n} on {b} kernel ({BC.matmul_tier(n, n, n)}): {t:.4f} ms (bound "
            f"{b_ms:.4f} ms by {b_by}, {b_ms / t * 100:.1f}% of it), plain {t_plain:.4f} ms, "
            f"torch.matmul {t_lib:.4f} ms")
    next(k for k in kernels if k["name"] == "matmul_cf")["shapes"] = mm_rows
    del eig_in, eig_start, mm_in, m4, full4, v4

    # the routing sweeps: each kernel against torch.matmul on the same
    # square batches (float32)
    for n in SWEEP_NS:
        b = sweep_batch(n)
        a = torch.randn(b, n, n, generator=gen, device=DEV)
        c = torch.randn(b, n, n, generator=gen, device=DEV)
        v = torch.randn(b, n, generator=gen, device=DEV)
        af, cf_ = a.reshape(b, -1), c.reshape(b, -1)
        t_mv = kernel_ms(torch, lambda: BC.launch_matvec_full(af, v), f"matvec {n}")
        t_mv_lib = yardstick_ms(torch, lambda: torch.matmul(a, v[..., None]), "matmul")
        t_mm = kernel_ms(torch, lambda: BC.launch_matmul(af, cf_, n, n, n), f"matmul {n}")
        t_mm_lib = yardstick_ms(torch, lambda: torch.matmul(a, c), "matmul")
        log(f"  routing n={n} on {b}: matvec kernel {t_mv:.4f} ms, torch.matmul "
            f"{t_mv_lib:.4f} ms; matmul kernel ({BC.matmul_tier(n, n, n)}) {t_mm:.4f} ms, "
            f"torch.matmul {t_mm_lib:.4f} ms")
        del a, c, v, af, cf_
    return kernels

# --- eig (phases 2, 3 and 9) --------------------------------------------------

# kernel vs plain version and against float64, over ||A||_F of each problem:
# float32 Jacobi sits at 4e-6..9e-6 ||A||_F at n = 32 before any polish (in
# the kernel and the plain version alike); float64 at round-off
TOL_EIG = {"float32": 2e-5, "float64": 1e-12}
EIG_CHECK_NS = (4, 5, 8, 9, 12, 16, 17, 24, 25, 32)


def eig_errors(torch, w, u, sym, w_ref):
    """(sorted w against sorted w_ref, U diag(w) U^T against sym, U^T U
    against I), each the worst over problems, the first two over
    ||sym||_F; u may be None (then 0 for the last two)."""
    sym = sym.double()
    fro = torch.linalg.matrix_norm(sym)
    dw = (w.double().sort(-1).values - w_ref.double().sort(-1).values).abs().amax(-1)
    out = [(dw / fro).max().item(), 0.0, 0.0]
    if u is not None:
        u = u.double().reshape(sym.shape)
        rec = torch.einsum("bij,bj,bkj->bik", u, w.double(), u)
        out[1] = (torch.linalg.matrix_norm(rec - sym) / fro).max().item()
        eye = torch.eye(sym.shape[-1], dtype=sym.dtype, device=sym.device)
        out[2] = (u.mT @ u - eye).abs().max().item()
    return out


def phase_eig_vs_plain(torch, rng):
    """Both tiers of the eig kernel against their plain versions (n = 4..32,
    float32 and float64, values and values with vectors, reading the upper
    triangle of non-symmetric input on a ragged batch): sorted eigenvalues,
    the reconstruction and U^T U - I; then a mixed-scale block (a 1e6-scale
    problem beside an O(1) one) against float64 numpy."""
    from fastmath_tpu_torch.kernels import eig as KE
    from fastmath_tpu_torch.layouts.sym import sym_from_triangle

    worst = {}
    for dt_name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        tol = TOL_EIG[dt_name]
        for n in EIG_CHECK_NS:
            a = torch.tensor(rng.standard_normal((B_CHECK, n, n)), dtype=dtype, device=DEV)
            sym = sym_from_triangle(a, True)
            sweeps = KE.sweeps_for(n)
            wp, up = KE.eig_plain(sym, True, sweeps)
            for compute_u in (False, True):
                wk, uk = KE.launch_eig_full(a, True, compute_u, sweeps)
                torch.cuda.synchronize()
                errs = eig_errors(torch, wk, uk, sym, wp)
                if compute_u:  # the plain version's own reconstruction, for scale
                    errs.append(eig_errors(torch, wp, up, sym, wk)[1])
                key = f"eig {dt_name} n={n} u={compute_u}"
                worst[key] = errs
                if not max(errs) <= tol:
                    fail(f"{key}: kernel vs plain / reconstruction / orthogonality {errs}")
        for n in (4, 12):
            x = rng.standard_normal((n, n))
            full = np.stack([1e6 * np.diag(np.arange(1.0, n + 1)), x + x.T])
            w, _ = KE.launch_eig_full(torch.tensor(full, dtype=dtype, device=DEV), True, False,
                                      KE.sweeps_for(n))
            want = np.sort(np.linalg.eigvalsh(full), -1)
            got = np.sort(w.double().cpu().numpy(), -1)
            err = (np.abs(got - want).max(-1) / np.abs(want).max(-1)).max()
            key = f"eig mixed-scale block {dt_name} n={n}"
            worst[key] = [err]
            if not err <= TOL_ORACLE[dt_name]:
                fail(f"{key}: relative error against float64 eigvalsh {err:.3e}")
    for dt_name in ("float32", "float64"):
        ks = [k for k in worst if k.startswith(f"eig {dt_name}")]
        cols = list(zip(*(worst[k][:3] for k in ks)))
        log(f"  eig {dt_name}: {len(ks)} cases over ||A||_F, worst kernel-vs-plain eigenvalues "
            f"{max(cols[0]):.3e}, reconstruction {max(cols[1]):.3e} (plain version "
            f"{max(worst[k][3] for k in ks if len(worst[k]) > 3):.3e}), |U^T U - I| "
            f"{max(cols[2]):.3e} (tol {TOL_EIG[dt_name]:.0e})")
        m = max(worst[k][0] for k in worst if k.startswith(f"eig mixed-scale block {dt_name}"))
        log(f"  eig mixed-scale block {dt_name}: small problem vs f64 eigvalsh {m:.3e} "
            f"(tol {TOL_ORACLE[dt_name]:.0e})")


def gapped_sym(rng, b, n):
    """Symmetric Q diag(w) Q^T, w = 0, 1, .., n-1 plus up to 0.5: every gap
    at least 0.5, so the eigenvectors and their gradient are well defined."""
    q, _ = np.linalg.qr(rng.standard_normal((b, n, n)))
    w = np.arange(n) + rng.uniform(0, 0.5, (b, n))
    s = np.einsum("bik,bk,bjk->bij", q, w, q)
    return 0.5 * (s + s.transpose(0, 2, 1))


def phase_eig_gradients(torch, rng):
    """eig_sym's backward (the Giles formula) through the kernel against the
    same through the plain version (float64, on the card, both triangles),
    and the kernel route against central differences on gapped spectra.
    The loss, sum cos(w_i) (u_i^T g)^2 + sum w_i^3, does not depend on the
    eigenpairs' order or signs."""
    import fastmath_tpu_torch as T
    from fastmath_tpu_torch.kernels import eig as KE

    for n in (3, 6, 12, 20):
        a0 = torch.tensor(gapped_sym(rng, 257, n), device=DEV)
        g = torch.tensor(rng.standard_normal(n), device=DEV)
        d = torch.tensor(rng.standard_normal((257, n, n)), device=DEV)

        def loss(a, backend, upper=True):
            w, u = T.eig_sym(a, compute_u=True, upper=upper, backend=backend)
            return (torch.cos(w) * ((u * g[:, None]).sum(-2)) ** 2).sum() + (w ** 3).sum()

        worst = 0.0
        counter = KE.eig_unrolled if n <= KE.UNROLL_MAX else KE.eig_rolled
        before = counter.launches
        for upper in (True, False):
            grads = []
            for backend in ("cuda", "torch"):
                a = a0.clone().requires_grad_()
                grads.append(torch.autograd.grad(loss(a, backend, upper), a)[0])
            worst = max(worst, ((grads[0] - grads[1]).norm() / grads[1].norm()).item())
        launched = counter.launches - before
        a = a0.clone().requires_grad_()
        grad = torch.autograd.grad(loss(a, "cuda"), a)[0]
        h = 1e-5
        with torch.no_grad():
            fd = (loss(a0 + h * d, "cuda") - loss(a0 - h * d, "cuda")) / (2 * h)
        ad = (grad * d).sum()
        fd_err = abs((fd - ad) / ad).item()
        torch.cuda.synchronize()
        log(f"  eig grads n={n}: kernel vs plain relative {worst:.3e} (tol 1e-10); kernel route "
            f"vs central differences {fd_err:.3e} (tol 1e-6); kernel launches {launched}")
        if not (worst <= 1e-10 and fd_err <= 1e-6):
            fail(f"eig gradient n={n}: kernel vs plain {worst:.3e}, vs differences {fd_err:.3e}")
        if launched < 2:
            fail(f"eig gradient n={n}: the kernel route did not launch the kernel")


# bench/suite.py's eig_sym shapes (float32, spd_batch): 2x2 and 3x3 on 1M
# (:667-690, the closed forms), 4x4 on 1M (:620-661), 12x12 and 16x16 on
# 200k (:567-575, :693-701), 24x24 and 32x32 on 100k (:553-563,
# :577-585), and 8x8 on 250k (the widest unrolled problem, on the bytes of
# 4x4 on 1M); with vectors and the default polish, 4x4 on 1M and 16x16 on
# 200k; sugar.lmdiv, lu and chol, 16x16 with a vector on 500k (:497-505)
EIG_SHAPES = ((2, 1_000_000), (3, 1_000_000), (4, 1_000_000), (8, 250_000), (12, 200_000),
              (16, 200_000), (24, 100_000), (32, 100_000))
EIG_VEC_SHAPES = ((4, 1_000_000), (16, 200_000))
LMDIV_SHAPE = (16, 500_000)
# the shape of each kernel's row in the kernels line
EIG_ROWS = {"eig_unrolled": (4, 1_000_000), "eig_rolled": (16, 200_000)}


def ops_eig(n, compute_u, sweeps):
    """Arithmetic operations one problem's run needs: the |A|_F^2 sum over
    one triangle (n(n+1)) and, before each of sweeps + 1 tests, the
    off-diagonal one over one triangle (n(n-1)); per rotation (n(n-1)/2 a
    sweep) 16 for (c, s), then 3 a rotated entry (two products and a sum)
    of the symmetric matrix: 2(n-2) off the pair and the 2x2 block's six,
    and 2n of V with vectors. The rolled kernel rotates both triangles;
    the bound does not charge that. ``sweeps`` may be a mean over
    problems."""
    per_rot = 16 + 3 * (2 * (n - 2) + 6) + (6 * n if compute_u else 0)
    return n * (n + 1) + (sweeps + 1) * n * (n - 1) + sweeps * n * (n - 1) // 2 * per_rot


# special-function results an SM gives a clock (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0: reciprocal,
# reciprocal square root) against its 128 float32 lanes' two operations
PEAK_SPECIAL = PEAK_OPS["float32"] / 16


def eig_special_ms(n, sweeps):
    """The least time one problem's rotations take on the special-function
    units, in ms per problem: two results a rotation (the square roots of
    the tangent's hypotenuse and of the half angle), n(n-1)/2 rotations a
    sweep; ``sweeps`` may be a mean."""
    return 2 * sweeps * n * (n - 1) / 2 / PEAK_SPECIAL * 1e3


def library_eig_ms(torch, a, vec):
    """The yardstick of the eig kernels, torch.linalg.eigh (vectors) or
    eigvalsh on the same batch (timed only, never called by the port).
    cuSOLVER's batched solver refuses some large batches
    (CUSOLVER_STATUS_INVALID_VALUE at 1M 4x4): then the batch goes through
    back to back in the largest leading chunks it takes (halving until it
    does), and the time is that of all the chunks."""
    fn = torch.linalg.eigh if vec else torch.linalg.eigvalsh
    name = "eigh" if vec else "eigvalsh"
    b = a.shape[0]
    chunk = b
    while True:
        try:
            fn(a[:chunk])
            torch.cuda.synchronize()
            break
        except torch.linalg.LinAlgError as e:
            log(f"  {name} refuses {chunk} x {a.shape[-1]}x{a.shape[-1]}: {str(e)[:60]}")
            if chunk == 1:
                raise
            chunk //= 2
    if chunk < b:
        log(f"  {name} on the whole batch in chunks of {chunk}")
    return yardstick_ms(torch, lambda: [fn(a[i:i + chunk]) for i in range(0, b, chunk)], name)


def phase_eig(torch, rng):
    """eig_sym and sugar.lmdiv at the bench suite's shapes through the public
    ops (check_finite=False, as the suite calls them): launch counts; sorted
    eigenvalues against float64 eigvalsh (per problem over ||A||_2), with
    vectors the reconstruction (over ||A||_F) and U^T U - I, lmdiv
    normwise, all gated at 1e-5; per-call, host and device times; each
    kernel alone against its bound (bytes, or the operations of the sweeps
    this run's problems needed, counted by the plain version on a sample),
    its plain version and eigvalsh / eigh."""
    import fastmath_tpu_torch as T
    from fastmath_tpu_torch.kernels import batched_cuda as BC
    from fastmath_tpu_torch.kernels import eig as KE

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEV)
    gen.manual_seed(int(rng.integers(2 ** 31)))
    mats = {n: spd_on_card(torch, gen, b, n) for n, b in EIG_SHAPES}
    n_l, b_l = LMDIV_SHAPE
    a_l = spd_on_card(torch, gen, b_l, n_l)
    v_l = torch.randn(b_l, n_l, generator=gen, device=DEV)
    torch.cuda.synchronize()

    counters = {"eig_unrolled": KE.eig_unrolled, "eig_rolled": KE.eig_rolled,
                "solve_full": BC.solve_full_cf, "chol": BC.chol_cf}
    for c in counters.values():
        c.launches = 0
    outs = {("values", n): (T.eig_sym(a, check_finite=False), None) for n, a in mats.items()}
    for n, _ in EIG_VEC_SHAPES:
        outs["vectors", n] = T.eig_sym(mats[n], compute_u=True, check_finite=False)
    x_lu = T.lmdiv(a_l, v_l)
    x_chol = T.lmdiv(a_l, v_l, method="chol")
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    log("  eig/sugar-path launches: " + " ".join(f"{k}={v}" for k, v in launches.items()))
    if not all(v >= 1 for v in launches.values()):
        fail(f"the eig/sugar path did not go through every kernel: {launches}")

    for (what, n), (w, u) in outs.items():
        b = mats[n].shape[0]
        if tuple(w.shape) != (b, n) or not torch.isfinite(w).all() or (
                u is not None and (tuple(u.shape) != (b, n, n) or not torch.isfinite(u).all())):
            fail(f"eig_sym {n}x{n} {what}: output has the wrong shape or is not finite")
        ns = 4096 if n < 24 else (2048 if n == 24 else 1024)
        a64 = mats[n][:ns].double()
        w64 = torch.linalg.eigvalsh(a64)
        ev = ((w[:ns].double().sort(-1).values - w64).abs().amax(-1)
              / w64.abs().amax(-1)).cpu().numpy()
        msg = (f"  eig_sym {n}x{n} {what} on {b}: eigenvalues vs f64 eigvalsh over ||A||_2 "
               f"({ns} problems) median={np.median(ev):.3e} max={ev.max():.3e}")
        gated = [ev.max()]
        if u is not None:
            _, rec, orth = eig_errors(torch, w[:ns], u[:ns], a64, w64)
            msg += f"; reconstruction over ||A||_F max={rec:.3e}; |U^T U - I| max={orth:.3e}"
            gated += [rec, orth]
        log(msg + f" (gate {GATE:.0e})")
        if not max(gated) <= GATE:
            fail(f"eig_sym {n}x{n} {what}: {gated} > {GATE}")
    ns = 4096
    want = oracle_solve(a_l[:ns].double().cpu().numpy(), v_l[:ns].double().cpu().numpy())
    for meth, x in (("lu", x_lu), ("chol", x_chol)):
        e = normwise(x[:ns].cpu().numpy(), want)
        log(f"  lmdiv {meth} {n_l}x{n_l} on {b_l} normwise vs f64 ({ns} problems): "
            f"median={np.median(e):.3e} max={e.max():.3e} (gate {GATE:.0e})")
        if not e.max() <= GATE:
            fail(f"lmdiv {meth}: normwise error {e.max():.3e} > {GATE}")
    del outs, x_lu, x_chol

    # the public ops per call (host launch included), the host's share and
    # the card's time
    public = {f"eig_sym {n}x{n} on {a.shape[0]}": (lambda a=a: T.eig_sym(a, check_finite=False))
              for n, a in mats.items()}
    for n, b in EIG_VEC_SHAPES:
        public[f"eig_sym {n}x{n} on {b} with vectors (polish)"] = (
            lambda a=mats[n]: T.eig_sym(a, compute_u=True, check_finite=False))
    public[f"lmdiv lu {n_l}x{n_l} on {b_l}"] = lambda: T.lmdiv(a_l, v_l)
    public[f"lmdiv chol {n_l}x{n_l} on {b_l}"] = lambda: T.lmdiv(a_l, v_l, method="chol")
    for name, fn in public.items():
        dev = device_ms(torch, fn, reps=5)
        log(f"  public {name}: {call_ms(torch, fn, reps=5):.4f} ms per call, "
            f"host {host_ms(torch, fn, reps=5):.4f} ms, device "
            + ("not measured (waits for the card)" if dev is None else f"{dev:.4f} ms"))

    # each kernel alone at every kernel shape against its bound, its plain
    # version and the library call (timed only, never called by the port)
    kernels, timed = [], {"eig_unrolled": [], "eig_rolled": []}
    shapes = [(n, b, False) for n, b in EIG_SHAPES if n >= 4] + \
        [(n, b, True) for n, b in EIG_VEC_SHAPES]
    for n, b, vec in shapes:
        a = mats[n]
        sweeps = KE.sweeps_for(n)
        kern = lambda a=a, s=sweeps, v=vec: KE.launch_eig_full(a, True, v, s)  # noqa: E731
        plain = lambda a=a, s=sweeps, v=vec: KE.eig_plain(a, v, s)  # noqa: E731
        (wk, uk), (wp, up) = kern(), plain()
        errs = eig_errors(torch, wk, uk, a, wp)
        err = (wk.sort(-1).values - wp.sort(-1).values).abs().max().item()
        del wk, uk, wp, up
        if not max(errs) <= TOL_EIG["float32"]:
            fail(f"eig {n}x{n} on {b}: kernel disagrees with its plain version: {errs}")
        ms = kernel_ms(torch, kern, f"eig {n}x{n}", reps=5)
        plain_ms = call_ms(torch, plain, reps=2, warmup=1)
        lib_ms = library_eig_ms(torch, a, vec)
        mean_sweeps = KE.sweep_counts(a[:4096], sweeps).double().mean().item()
        b_ms, b_by = bound(b * (n * n + n + (n * n if vec else 0)) * 4,
                           b * ops_eig(n, vec, mean_sweeps), "float32")
        sf_ms = b * eig_special_ms(n, mean_sweeps)
        if sf_ms > b_ms:
            b_ms, b_by = sf_ms, "operations"
        name = "eig_unrolled" if n <= KE.UNROLL_MAX else "eig_rolled"
        log(f"  {name} {n}x{n} on {b}{' with vectors' if vec else ''} kernel: {ms:.4f} ms "
            f"(bound {b_ms:.4f} ms by {b_by} at {mean_sweeps:.2f} sweeps, special functions "
            f"{sf_ms:.4f} ms, {b_ms / ms * 100:.1f}% of it), plain {plain_ms:.4f} ms, "
            f"{'eigh' if vec else 'eigvalsh'} {lib_ms:.4f} ms, kernel vs plain max abs {err:.3e}, "
            f"errors {errs[0]:.3e} / {errs[1]:.3e} / {errs[2]:.3e}")
        timed[name].append(shape_row(f"{n}x{n} on {b}{' vectors' if vec else ''}", ms,
                                     plain_ms, b_ms, b_by, lib_ms))
        if (n, b) == EIG_ROWS[name] and not vec:
            line = 82 if name == "eig_unrolled" else 205
            kernels.append({
                "name": name, "route": "cuda",
                "source": "fastmath_tpu_torch/kernels/csrc/eig.cu",
                "replaces": f"fastmath_tpu/kernels/eig_pallas.py:{line}",
                "launches": launches[name], "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
    for k in kernels:
        k["shapes"] = timed[k["name"]]
    return kernels


# --- lie (phases 2, 3 and 10) ---------------------------------------------------

# kernel vs plain version, normwise per problem (the kernels contract
# multiply-adds into FMAs): expm at ||X|| ~ 0.5; on skew-symmetric X of
# spectral radius 128, whose ten squarings each double the relative
# rounding (the plain version alone sits at 3e-5 from float64 there); logm,
# whose 2^(k+1) scaling after k square roots amplifies the last rounding
# (the plain version alone: 4e-6 from float64, 9e-6 on rotations by 0.9 pi)
TOL_EXPM = {"float32": 1e-5, "float64": 1e-12}
TOL_EXPM_DEEP = {"float32": 2e-4, "float64": 1e-11}
TOL_LOGM = {"float32": 5e-5, "float64": 1e-11}
# every d phase 10 runs, and each tier's edges
LIE_CHECK_DS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 16, 17, 24, 25, 28, 32)
LIE_ORACLE = 64  # problems held against float64 scipy in phase 2


def lie_normwise(torch, got, want):
    """Per-problem ||got - want||_F / ||want||_F (log I = 0 exactly: 0/0
    counts as 0), on the card."""
    got, want = got.double().flatten(1), want.double().flatten(1)
    return (got - want).norm(dim=1) / want.norm(dim=1).clamp_min(1e-300)


def skew_batch(torch, gen, b, d, radius):
    """Skew-symmetric (b, d, d) float64 on the card, spectral radius
    ``radius``: expm is a rotation by angles up to it."""
    r = torch.randn(b, d, d, generator=gen, device=DEV, dtype=torch.float64)
    s = r - r.mT
    rho = torch.linalg.matrix_norm(s, ord=2).clamp_min(1e-30)
    return s * (radius / rho)[:, None, None]


def scipy_map(fn, a):
    """fn of each float64 matrix of ``a`` (a tensor) on the host."""
    import scipy.linalg as sla

    f = getattr(sla, fn)
    mats = a.double().cpu().numpy()
    if fn == "logm":
        return np.stack([np.real(f(m)) for m in mats])
    return np.stack([f(m) for m in mats])


def phase_lie_vs_plain(torch, rng):
    """Both tiers of the expm and logm kernels against their plain versions
    (d = 1..32, float32 and float64, on a ragged batch, batch-major and
    channel-first, which must agree bit for bit) and the first problems
    against float64 scipy: expm at the bench scale 0.5/sqrt(d) and on
    skew-symmetric X of spectral radius 128 (ten squarings); logm of expm of
    the bench input and of rotations by up to 0.9 pi; then a batch with a
    reflection and a rotation by pi among regular matrices: exactly those
    come back NaN, every other problem bit for bit as without them."""
    from fastmath_tpu_torch.kernels import expm as KE
    from fastmath_tpu_torch.kernels import logm as KL

    gen = torch.Generator(device=DEV)
    gen.manual_seed(int(rng.integers(2 ** 31)))
    worst = {}
    for d in LIE_CHECK_DS:
        x = torch.randn(B_CHECK, d, d, generator=gen, device=DEV, dtype=torch.float64) * (
            0.5 / np.sqrt(d))
        cases = {"expm bench": (x, TOL_EXPM), "expm skew128": (skew_batch(torch, gen, B_CHECK, d, 128.0),
                                                                TOL_EXPM_DEEP)}
        logm_in = {"logm bench": KE.expm_plain(x),
                   "logm rot0.9pi": KE.expm_plain(skew_batch(torch, gen, B_CHECK, d, 0.9 * np.pi))}
        oracle = {k: scipy_map("expm", v[:LIE_ORACLE]) for k, (v, _) in cases.items()}
        oracle.update({k: scipy_map("logm", v[:LIE_ORACLE]) for k, v in logm_in.items()})
        for dt_name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
            for key, (launch, plain, a, tol) in {
                    **{k: (KE.launch_expm, KE.expm_plain, v, t[dt_name]) for k, (v, t) in cases.items()},
                    **{k: (KL.launch_logm, KL.logm_plain, v, TOL_LOGM[dt_name])
                       for k, v in logm_in.items()}}.items():
                a = a.to(dtype)
                got = launch(a)
                cf = launch(a.reshape(B_CHECK, d * d).t().contiguous().t().reshape(B_CHECK, d, d),
                            cf_out=True)
                want = plain(a)
                torch.cuda.synchronize()
                e_plain = lie_normwise(torch, got, want).max().item()
                e_oracle = lie_normwise(torch, got[:LIE_ORACLE],
                                        torch.tensor(oracle[key], device=DEV)).max().item()
                name = f"{key} {dt_name} d={d}"
                worst[name] = (e_plain, e_oracle)
                if not torch.equal(cf, got):
                    fail(f"{name}: channel-first and batch-major results differ")
                if not (torch.isfinite(got).all() and e_plain <= tol and e_oracle <= tol):
                    fail(f"{name}: kernel vs plain {e_plain:.3e}, vs f64 scipy {e_oracle:.3e} "
                         f"(tol {tol:.0e})")
            if d >= 2:
                good = logm_in["logm bench"][:200].to(dtype)
                refl = torch.eye(d, dtype=dtype, device=DEV)
                refl[0, 0] = -1.0
                rot = torch.eye(d, dtype=dtype, device=DEV)
                rot[:2, :2] = -torch.eye(2, dtype=dtype, device=DEV)
                i, j = len(good) // 3, 2 * len(good) // 3
                got = KL.launch_logm(torch.cat([good[:i], refl[None], good[i:j], rot[None],
                                                good[j:]]))
                alone = KL.launch_logm(good)
                torch.cuda.synchronize()
                bad = torch.isnan(got).any(-1).any(-1).nonzero()[:, 0].tolist()
                keep = torch.ones(len(got), dtype=torch.bool, device=DEV)
                keep[[i, j + 1]] = False
                if bad != [i, j + 1] or not torch.isnan(got[[i, j + 1]]).all() or not torch.equal(
                        got[keep], alone):
                    fail(f"logm cut batch {dt_name} d={d}: NaN lanes {bad}, or a neighbour moved")
    for dt_name in ("float32", "float64"):
        for op in ("expm bench", "expm skew128", "logm bench", "logm rot0.9pi"):
            ks = [k for k in worst if k.startswith(f"{op} {dt_name}")]
            p = max(worst[k][0] for k in ks)
            o = max(worst[k][1] for k in ks)
            tol = (TOL_LOGM if op.startswith("logm") else
                   TOL_EXPM_DEEP if "skew" in op else TOL_EXPM)[dt_name]
            log(f"  {op} {dt_name}: {len(ks)} sizes, worst normwise kernel-vs-plain {p:.3e}, "
                f"vs f64 scipy {o:.3e} (tol {tol:.0e}); cut batch: NaN on exactly the 2 on-cut "
                f"problems, neighbours bit for bit")


def phase_lie_gradients(torch, rng):
    """expm's Mathias backward through the kernel route against the plain
    route at d = 4 and 16 (the 2d x 2d block through the kernel, which must
    launch in the backward) and 20 (the 40 x 40 block through the plain
    version); logm's at d = 4 on the card against the same on the CPU (the
    ISS core); both against central differences. Float64."""
    import fastmath_tpu_torch as T
    from fastmath_tpu_torch.kernels import expm as KE
    from fastmath_tpu_torch.kernels import logm as KL

    def fd_check(f, a0, g, e, h=1e-6):
        a = a0.clone().requires_grad_()
        grad = torch.autograd.grad((f(a) * g).sum(), a)[0]
        with torch.no_grad():
            fd = ((f(a0 + h * e) * g).sum() - (f(a0 - h * e) * g).sum()) / (2 * h)
        return abs((fd - (grad * e).sum()) / fd).item()

    for d in (4, 16, 20):
        x0 = torch.tensor(rng.standard_normal((257, d, d)) * (0.5 / np.sqrt(d)), device=DEV)
        g = torch.tensor(rng.standard_normal((257, d, d)), device=DEV)
        e = torch.tensor(rng.standard_normal((257, d, d)), device=DEV)
        counter = None
        if 2 * d <= 32:
            counter = KE.expm_unrolled if KE.tier(2 * d, torch.float64) == "expm_unrolled" \
                else KE.expm_warp
        before = counter.launches if counter else 0
        grads = []
        for backend in ("cuda", "torch"):
            x = x0.clone().requires_grad_()
            grads.append(torch.autograd.grad((T.expm(x, backend=backend) * g).sum(), x)[0])
        launched = counter.launches - before if counter else 0
        worst = lie_normwise(torch, grads[0][None], grads[1][None]).item()
        fd = fd_check(lambda a: T.expm(a), x0, g, e)
        torch.cuda.synchronize()
        log(f"  expm grads d={d}: kernel vs plain relative {worst:.3e} (tol 1e-10); vs central "
            f"differences {fd:.3e} (tol 1e-6); expm kernel launches in the backward {launched}")
        if not (worst <= 1e-10 and fd <= 1e-6):
            fail(f"expm gradient d={d}: kernel vs plain {worst:.3e}, vs differences {fd:.3e}")
        if counter and launched < 1:
            fail(f"expm gradient d={d}: the backward did not launch the kernel")
    x0 = torch.tensor(rng.standard_normal((257, 4, 4)) * 0.25, device=DEV)
    a0 = KE.expm_plain(x0)
    g = torch.tensor(rng.standard_normal((257, 4, 4)), device=DEV)
    e = torch.tensor(rng.standard_normal((257, 4, 4)), device=DEV)
    counters = (KL.logm_unrolled, KL.logm_warp)
    before = [c.launches for c in counters]
    grads = []
    for device in (DEV, "cpu"):
        a = a0.to(device).clone().requires_grad_()
        grads.append(torch.autograd.grad((T.logm(a) * g.to(device)).sum(), a)[0].cpu())
    launched = [c.launches - b for c, b in zip(counters, before)]
    worst = lie_normwise(torch, grads[0][None], grads[1][None]).item()
    fd = fd_check(lambda a: T.logm(a), a0, g, e)
    torch.cuda.synchronize()
    log(f"  logm grads d=4: card vs CPU relative {worst:.3e} (tol 1e-10); vs central differences "
        f"{fd:.3e} (tol 1e-6); logm kernel launches (unrolled, warp) {launched}")
    if not (worst <= 1e-10 and fd <= 1e-6) or sum(launched) < 2:
        fail(f"logm gradient: card vs CPU {worst:.3e}, vs differences {fd:.3e}, launches {launched}")


# bench/suite.py's Lie section (:799-985), float32: expm and logm 4x4 on 1M
# (X = 0.5 randn), the sustained chains (0.5 expm(0.5 x), k = 16;
# expm(0.999 logm(e)), k = 4), expm and logm at the larger d on a batch of
# about 1M * 64 bytes (X = 0.5/sqrt(d) randn), SPD logm (a a^T / d + I,
# spectrum O(1)) at 16, 28 and 32 on 15,625, meanm G = 4096, K = 8, 4x4,
# max_iter 64 (here on float64 input, so the mean stays float64)
LIE_MAIN = (4, 1_000_000)
LIE_SHAPES = ((8, 250_000), (16, 62_500), (24, 27_777), (28, 20_408), (32, 15_625))
LIE_SPD = ((5, 15_625), (8, 15_625), (12, 15_625), (16, 15_625), (17, 15_625), (24, 15_625),
           (28, 15_625), (32, 15_625))
MEANM_SHAPE = (4096, 8, 4)
# the shape of each kernel row of the kernels line
LIE_ROWS = {"expm_unrolled": (4, 1_000_000), "expm_unrolled_d8": (8, 250_000),
            "expm_warp": (16, 62_500), "expm_warp_d32": (32, 15_625),
            "logm_unrolled": (4, 1_000_000), "logm_warp": (16, 62_500),
            "logm_warp_d32": (32, 15_625)}


def ops_matmul(d):
    """Operations of one d x d product: d^2 entries of d products and d - 1 sums."""
    return d * d * (2 * d - 1)


def ops_expm(d, squarings, order=9):
    """Arithmetic operations one problem's expm needs: the 1-norm (2 d^2),
    the 2^-s scale (d^2), R = I + Y/order (d^2 + d), order - 1 Horner steps
    (a product, the 1/m scale, the diagonal), and ``squarings`` products
    (may be a mean over problems)."""
    return 4 * d * d + d + (order - 1) * (ops_matmul(d) + d * d + d) + squarings * ops_matmul(d)


def ops_logm(d, iss, db, order=9):
    """Arithmetic operations one problem's logm needs, an inverse counted
    as 2 d^3: per Denman-Beavers step |M - I|^2 (3 d^2), M^-1, T = M + I,
    four products and two scales; per square root the final test, (Y +
    I)^-1 and D (Y + I)^-1; then the series: (A + I)^-1, Z, Z^2, (order -
    1)/2 Horner steps and L, and the 2^(k+1) scale. ``iss`` and ``db`` may
    be means over problems."""
    inv = 2 * d ** 3
    per_db = 3 * d * d + inv + d + 4 * ops_matmul(d) + 2 * d * d
    per_iss = 6 * d * d + d + inv + ops_matmul(d)
    series = 3 * d * d + d + inv + ((order - 1) // 2 + 3) * ops_matmul(d) + d * d
    return db * per_db + iss * per_iss + series


def lie_elementwise(got, want):
    """The bench suite's rel_err: elementwise |got - want| / |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want) / (np.abs(want) + 1e-30)


def phase_lie(torch, rng):
    """The Lie path at the bench suite's shapes through the public ops:
    launch counts; accuracy against float64 scipy (normwise, gated at
    1e-5; the 4x4 logm roundtrip elementwise at the reference's bound,
    median 1e-6 and p99 3e-5; meanm's fixed-point residual in float64 at
    1e-10); per-call, host and device times; the SPD logm through the
    symmetric eig route and through the kernel; each kernel alone against
    its bound (the squarings and iterations this run's problems need,
    counted by the plain versions on 4,096 of them), its plain version and,
    for expm, torch.linalg.matrix_exp."""
    import fastmath_tpu_torch as T
    from fastmath_tpu_torch.kernels import eig as KEIG
    from fastmath_tpu_torch.kernels import expm as KE
    from fastmath_tpu_torch.kernels import logm as KL
    from fastmath_tpu_torch.ops import lie as L

    gen = torch.Generator(device=DEV)
    gen.manual_seed(int(rng.integers(2 ** 31)))
    d0, b0 = LIE_MAIN
    X = torch.randn(b0, d0, d0, generator=gen, device=DEV) * 0.5
    Xs = {d: torch.randn(b, d, d, generator=gen, device=DEV) * (0.5 / np.sqrt(d))
          for d, b in LIE_SHAPES}
    spds = {}
    for d, b in LIE_SPD:
        a = torch.randn(b, d, d, generator=gen, device=DEV)
        spds[d] = (a @ a.mT + d * torch.eye(d, device=DEV)) / d
    g, k, dm = MEANM_SHAPE
    Am = KE.expm_plain(0.25 * torch.randn(g, k, dm, dm, generator=gen, device=DEV,
                                          dtype=torch.float64))
    torch.cuda.synchronize()

    counters = {"expm_unrolled": KE.expm_unrolled, "expm_warp": KE.expm_warp,
                "logm_unrolled": KL.logm_unrolled, "logm_warp": KL.logm_warp,
                "eig_rolled": KEIG.eig_rolled}
    for c in counters.values():
        c.launches = 0
    E = T.expm(X)
    chain = X
    for _ in range(16):
        chain = 0.5 * T.expm(0.5 * chain)
    Lg = T.logm(E)
    rt = E
    for _ in range(4):
        rt = T.expm(T.logm(rt) * 0.999)
    outs = {}
    for d, x in Xs.items():
        e = T.expm(x)
        outs[d] = (e, T.logm(e))
    spd_out = {d: T.logm(a) for d, a in spds.items()}
    mean = T.meanm(Am, max_iter=64)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    log("  lie-path launches: " + " ".join(f"{k}={v}" for k, v in launches.items()))
    # eig_rolled: the SPD logm from _LOGM_SYM_EIG_MIN_D up takes the eig route
    if not all(v >= 1 for v in launches.values()):
        fail(f"the Lie path did not go through every kernel: {launches}")

    def gate(name, err, limit=GATE):
        log(f"  {name}: median={np.median(err):.3e} max={err.max():.3e} (gate {limit:.0e})")
        if not err.max() <= limit:
            fail(f"{name}: {err.max():.3e} > {limit}")

    import scipy.linalg as sla

    ns = 256
    gate(f"expm 4x4 on {b0} normwise vs f64 scipy ({ns} problems)",
         lie_normwise(torch, E[:ns], torch.tensor(scipy_map("expm", X[:ns]), device=DEV)).cpu().numpy())

    want = X[:ns].double().cpu().numpy()
    for _ in range(16):
        want = 0.5 * np.stack([sla.expm(m * 0.5) for m in want])
    gate("expm chain k=16 normwise vs the f64 scipy recurrence (256)",
         lie_normwise(torch, chain[:ns], torch.tensor(want, device=DEV)).cpu().numpy())
    rel = lie_elementwise(Lg[:8192].cpu().numpy(), X[:8192].cpu().numpy())
    med, p99 = float(np.median(rel)), float(np.quantile(rel, 0.99))
    log(f"  logm 4x4 on {b0} roundtrip vs X elementwise (8192): median={med:.3e} p99={p99:.3e} "
        f"(gates 1e-6, 3e-5); normwise vs f64 scipy of its input (256) max="
        f"{lie_normwise(torch, Lg[:ns], torch.tensor(scipy_map('logm', E[:ns]), device=DEV)).max().item():.3e}")
    if not (med <= 1e-6 and p99 <= 3e-5):
        fail(f"logm 4x4 roundtrip: median {med:.3e}, p99 {p99:.3e}")
    want = E[:ns].double().cpu().numpy()
    for _ in range(4):
        want = np.stack([sla.expm(np.real(sla.logm(m)) * 0.999) for m in want])
    gate("logm+expm chain k=4 normwise vs the f64 scipy recurrence (256)",
         lie_normwise(torch, rt[:ns], torch.tensor(want, device=DEV)).cpu().numpy())
    for d, (e, lg) in outs.items():
        n = ns if d <= 16 else 128
        x = Xs[d]
        gate(f"expm {d}x{d} on {x.shape[0]} normwise vs f64 scipy ({n})",
             lie_normwise(torch, e[:n], torch.tensor(scipy_map("expm", x[:n]), device=DEV)).cpu().numpy())
        gate(f"logm {d}x{d} on {x.shape[0]} normwise vs f64 scipy of its input ({n})",
             lie_normwise(torch, lg[:n], torch.tensor(scipy_map("logm", e[:n]), device=DEV)).cpu().numpy())
    for d, lg in spd_out.items():
        n = 128
        gate(f"SPD logm {d}x{d} on {lg.shape[0]} ({'eig route' if d >= L._LOGM_SYM_EIG_MIN_D else 'kernel'}) "
             f"normwise vs f64 scipy ({n})",
             lie_normwise(torch, lg[:n], torch.tensor(scipy_map("logm", spds[d][:n]), device=DEV)).cpu().numpy())
    # meanm: the fixed-point residual ||mean_k logm(M^-1 A_k)|| over the mean
    # tangent norm, on the host (scipy) for 64 barycenters
    ng = min(64, g)
    mg = mean[:ng].cpu().numpy()
    Ah = Am[:ng].cpu().numpy()
    num, den = [], []
    for gi in range(ng):
        ls = [np.real(sla.logm(np.linalg.solve(mg[gi], Ah[gi, kk]))) for kk in range(k)]
        num.append(np.linalg.norm(np.mean(ls, axis=0)))
        den.append(np.mean([np.linalg.norm(x) for x in ls]))
    resid = np.array(num) / np.array(den)
    log(f"  meanm G={g} K={k} {dm}x{dm} float64: residual median={np.median(resid):.3e} "
        f"max={resid.max():.3e} (gate: median 1e-10); finite {bool(torch.isfinite(mean).all())}")
    if not (np.median(resid) <= 1e-10 and torch.isfinite(mean).all()):
        fail(f"meanm residual median {np.median(resid):.3e}")
    del chain, rt, outs, spd_out, mean

    # the public ops per call (host launch included), the host's share and
    # the card's time (logm reads the host once: it waits for the card)
    def chain16():
        c = X
        for _ in range(16):
            c = 0.5 * T.expm(0.5 * c)
        return c

    def roundtrip4():
        c = E
        for _ in range(4):
            c = T.expm(T.logm(c) * 0.999)
        return c

    public = {f"expm 4x4 on {b0}": lambda: T.expm(X), "expm chain k=16 (4x4)": chain16,
              f"logm 4x4 on {b0}": lambda: T.logm(E), "logm+expm chain k=4 (4x4)": roundtrip4}
    for d, x in Xs.items():
        public[f"expm {d}x{d} on {x.shape[0]}"] = lambda x=x: T.expm(x)
    es = {d: KE.launch_expm(x) for d, x in Xs.items()}
    for d, e in es.items():
        public[f"logm {d}x{d} on {e.shape[0]}"] = lambda e=e: T.logm(e)
    for d, a in spds.items():
        public[f"SPD logm {d}x{d} on {a.shape[0]}"] = lambda a=a: T.logm(a)
    public[f"meanm G={g} K={k} {dm}x{dm} float64, max_iter 64"] = lambda: T.meanm(Am, max_iter=64)
    for name, fn in public.items():
        # logm and meanm read a flag on the host, so they cannot be queued
        # ahead of the card: their device time is not measured
        dev = None if "logm" in name or "meanm" in name else device_ms(torch, fn, reps=5)
        log(f"  public {name}: {call_ms(torch, fn, reps=5):.4f} ms per call, "
            f"host {host_ms(torch, fn, reps=5):.4f} ms, device "
            + ("not measured (waits for the card)" if dev is None else f"{dev:.4f} ms"))

    # the crossover that sets _LOGM_SYM_EIG_MIN_D: the public logm per call
    # on SPD input, the symmetric eig route switched on and off at each d
    min_d = L._LOGM_SYM_EIG_MIN_D
    for d, a in spds.items():
        L._LOGM_SYM_EIG_MIN_D = d
        sym_ms = call_ms(torch, lambda a=a: T.logm(a), reps=5)
        L._LOGM_SYM_EIG_MIN_D = L._LOGM_SYM_EIG_MAX_D + 1
        ker_ms = call_ms(torch, lambda a=a: T.logm(a), reps=5)
        log(f"  SPD logm {d}x{d} on {a.shape[0]} per call: eig route {sym_ms:.4f} ms, "
            f"kernel route {ker_ms:.4f} ms")
    L._LOGM_SYM_EIG_MIN_D = min_d

    # each kernel alone at its row's shape against its bound, its plain
    # version and, for expm, torch.linalg.matrix_exp (timed only, never
    # called by the port)
    kernels = []
    rows = {"expm_unrolled": (X, "expm"), "expm_unrolled_d8": (Xs[8], "expm"),
            "expm_warp": (Xs[16], "expm"),
            "expm_warp_d32": (Xs[32], "expm"), "logm_unrolled": (E, "logm"),
            "logm_warp": (es[16], "logm"), "logm_warp_d32": (es[32], "logm")}
    lines = {"expm_unrolled": "expm_pallas.py:114", "expm_unrolled_d8": "expm_pallas.py:114",
             "expm_warp": "expm_pallas.py:73",
             "expm_warp_d32": "expm_pallas.py:73", "logm_unrolled": "logm_pallas.py:106",
             "logm_warp": "logm_pallas.py:235", "logm_warp_d32": "logm_pallas.py:317"}
    for name, (a, op) in rows.items():
        b, d = a.shape[0], a.shape[-1]
        if (d, b) != LIE_ROWS[name]:
            fail(f"{name}: row shape {(d, b)} is not {LIE_ROWS[name]}")
        launch = KE.launch_expm if op == "expm" else KL.launch_logm
        plain = KE.expm_plain if op == "expm" else KL.logm_plain
        tier = (KE.tier if op == "expm" else KL.tier)(d, a.dtype)
        kernel = re.sub(r"_d\d+$", "", name)
        if tier != kernel:
            fail(f"{name}: d={d} runs {tier}")
        got, want = launch(a), plain(a)
        err = (got - want).abs().max().item()
        nerr = lie_normwise(torch, got, want).max().item()
        del got, want
        if not nerr <= (TOL_EXPM if op == "expm" else TOL_LOGM)["float32"]:
            fail(f"{name} {d}x{d} on {b}: kernel disagrees with its plain version: {nerr:.3e}")
        ms = kernel_ms(torch, lambda a=a: launch(a), f"{name} {d}x{d}", reps=10)
        plain_ms = call_ms(torch, lambda a=a: plain(a), reps=2, warmup=1)
        sample = a[:4096]
        if op == "expm":
            s = KE.squaring_counts(sample).double().mean().item()
            nops, what = ops_expm(d, s), f"{s:.2f} squarings"
            lib_ms = yardstick_ms(torch, lambda a=a: torch.linalg.matrix_exp(a), "matrix_exp")
        else:
            iss, db = (t.double().mean().item() for t in KL.iteration_counts(sample))
            nops, what = ops_logm(d, iss, db), f"{iss:.2f} square roots, {db:.2f} DB steps"
            lib_ms = None
        b_ms, b_by = bound(2 * b * d * d * 4, b * nops, "float32")
        log(f"  {name} {d}x{d} on {b} kernel: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by} at "
            f"{what}, {b_ms / ms * 100:.1f}% of it), plain {plain_ms:.4f} ms, "
            + (f"matrix_exp {lib_ms:.4f} ms, " if lib_ms is not None else "")
            + f"kernel vs plain max abs {err:.3e}, normwise {nerr:.3e}")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"fastmath_tpu_torch/kernels/csrc/{op}.cu",
            "replaces": f"fastmath_tpu/kernels/{lines[name]}",
            "launches": launches[kernel], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
    return kernels


# --- phase 11 ----------------------------------------------------------------

NUM_BIG, NUM_MID = 1_000_000, 200_000  # bench/suite.py's BIG and MID batches
NUM_ORACLE = 65_536  # values held against float64 numpy / scipy
DCT_ORACLE = 4096  # rows (images) held against float64 scipy
DCT_WIDE = (2048, 65_536)  # n, rows
DCTN_SHAPE = (8192, 32, 32)
EST_BLOCKS = (512, 64)  # 512 SPD 64 x 64 as one block-diagonal operator
EST_SAMPLES, EST_MAX_ITER = 64, 256
CHAIN_BESSEL = 32
DCT_SWEEP_NS = (64, 128, 256, 512, 1024, 2048, 4096, 8192)
DCT_SWEEP_BYTES = 256 << 20  # each sweep batch's input
# float32 gates: the float32 tolerance of the JAX package's own test of the
# function where it has one (besseli "norm": rtol 2e-5, atol 1e-8), else
# 1e-5 normwise; trapprox and vbald at the tolerances of the reference's
# tests (Hutchinson 0.1, Hutch++ 0.05, vbald 0.35). maxeig_power runs its
# 256 steps (tol=0) and is held at 1e-5 against the same iteration in
# float64 from the same start: how close 256 steps come to the largest
# eigenvalue depends on the gap at the top of the spectrum, which the data
# set (0.1-1% apart on these operators), so that distance is reported, not
# gated
GATE_BESSEL = (2e-5, 1e-8)
GATE_EST = {"trapprox": 0.1, "trapprox_hutchpp": 0.05, "vbald": 0.35, "maxeig_power": GATE}


def vec_err(got, want):
    """||got - want|| / ||want|| over a whole vector (float64 host)."""
    got, want = np.asarray(got, np.float64).ravel(), np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def allclose_excess(got, want, rtol_atol):
    """max (|got - want| - atol) / |want|: at most rtol where
    ``np.testing.assert_allclose(got, want, rtol, atol)`` passes."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.maximum(np.abs(got - want) - rtol_atol[1], 0) / np.abs(want)))


def lower_median(x):
    """numpy oracle of reduce.median: the (count - 1) // 2-th of the sorted
    non-NaN values of each row, NaN where a row has none."""
    s = np.sort(x, axis=-1)  # NaN sorts last
    cnt = np.sum(~np.isnan(x), axis=-1)
    k = np.maximum(cnt - 1, 0) // 2
    out = np.take_along_axis(s, k[:, None], axis=-1)[:, 0]
    return np.where(cnt == 0, np.nan, out)


def dct_sweep(torch, gen):
    """DCT-II ortho by the basis product and by the FFT, device time on
    about 256 MB of float32 at each n, both paths held against each other."""
    from fastmath_tpu_torch.ops import realtransforms as RT

    rows = []
    for n in DCT_SWEEP_NS:
        b = DCT_SWEEP_BYTES // (4 * n)
        x = torch.randn(b, n, generator=gen, device=DEV)
        paths = {"matmul": RT._matmul_last, "fft": RT._fft_last}
        ms = {k: kernel_ms(torch, lambda f=f: f(x, "dct", 2, "ortho"), f"dct {k} n={n}", reps=5)
              for k, f in paths.items()}
        y_mm = RT._matmul_last(x[:256], "dct", 2, "ortho").double()
        y_ff = RT._fft_last(x[:256], "dct", 2, "ortho").double()
        err = ((y_mm - y_ff).norm(dim=-1) / y_ff.norm(dim=-1)).max().item()
        if not err <= GATE:
            fail(f"dct n={n}: the two paths differ by {err:.3e}")
        log(f"  dct-II ortho n={n} on {b}: basis product {ms['matmul']:.4f} ms, "
            f"FFT {ms['fft']:.4f} ms, paths apart {err:.2e}")
        rows.append({"n": n, "rows": b, "matmul_ms": ms["matmul"], "fft_ms": ms["fft"],
                     "paths_err": err})
        del x, y_mm, y_ff
    first_fft = next((r["n"] for r in rows if r["fft_ms"] < r["matmul_ms"]), None)
    cut = max((r["n"] for r in rows if first_fft is None or r["n"] < first_fft), default=0)
    log(f"  measured cut: basis product to n = {cut} (FFT faster from n = {first_fft}); "
        f"realtransforms.MATMUL_MAX_N = {RT.MATMUL_MAX_N}")
    RT._basis_t.cache_clear()
    return {"rows": rows, "measured_cut": cut, "matmul_max_n": RT.MATMUL_MAX_N}


def phase_numerics(torch, rng):
    """The numerics path at the bench suite's shapes (float32), through the
    public ops: the NaN reductions, besseli, the implicit-class simplex ops,
    DCT/DST, and the stochastic estimators on a tensor operator and on the
    compact 1M x 4 batch through sym_matvec (which must launch kernel #3).
    Each row: per-call, host and device ms, the bound by bytes, the error
    against float64 numpy / scipy at its gate. Then the sweep that sets the
    realtransforms cut."""
    import scipy.fft as sfft
    import scipy.special as ssp

    import fastmath_tpu_torch as T
    from fastmath_tpu_torch.kernels import sym_matvec_cf

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: the basis product must run in full float32")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(int(rng.integers(2 ** 31)))
    rows = []

    def row(name, fn, nbytes, err, gate, reps=10, queue=True, **extra):
        t_call = call_ms(torch, fn, reps=reps, warmup=1)
        t_host = host_ms(torch, fn, reps=reps)
        t_dev = device_ms(torch, fn, reps=reps) if queue else None
        b_ms = nbytes / PEAK_BYTES * 1e3
        r = {"name": name, "ms": t_call, "host_ms": t_host, "device_ms": t_dev,
             "bound_ms": b_ms, "bound_by": "bytes", "err": err, "gate": gate, **extra}
        dev = "not measured (reads on the host)" if t_dev is None else f"{t_dev:.4f} ms"
        log(f"  {name}: {t_call:.4f} ms per call, host {t_host:.4f} ms, device {dev}, "
            f"bound {b_ms:.4f} ms (bytes); err {err:.3e} (gate {gate:.0e})"
            + "".join(f", {k} {v}" for k, v in extra.items()))
        if not err <= gate:
            fail(f"{name}: error {err:.3e} above its gate {gate:.0e}")
        rows.append(r)

    # NaN-omitting reductions, 1M x 64, 20% NaN (bench/suite.py "reduce")
    xx = rng.standard_normal((NUM_BIG, 64)).astype(np.float32)
    xx[rng.random(xx.shape) < 0.2] = np.nan
    x = torch.from_numpy(xx).to(DEV)
    o = slice(0, NUM_ORACLE)
    nb = x.numel() * 4 + NUM_BIG * 4
    got = T.nansum(x, dim=-1)[o].cpu().numpy()
    row(f"nansum dim=-1 {NUM_BIG}x64", lambda: T.nansum(x, dim=-1), nb,
        vec_err(got, np.nansum(xx[o].astype(np.float64), -1)), GATE)
    got = T.median(x, dim=-1)[o].cpu().numpy()
    row(f"median dim=-1 {NUM_BIG}x64", lambda: T.median(x, dim=-1), nb,
        vec_err(got, lower_median(xx[o].astype(np.float64))), GATE)
    del x, xx

    # besseli on 1M z in [0, 30)
    zz = (rng.random(NUM_BIG) * 30.0).astype(np.float32)
    z = torch.from_numpy(zz).to(DEV)
    z64 = zz[o].astype(np.float64)
    nb = 2 * NUM_BIG * 4
    got = T.besseli(0, z, mode="norm")[o].cpu().numpy()
    row(f"besseli nu=0 norm {NUM_BIG}", lambda: T.besseli(0, z, mode="norm"), nb,
        allclose_excess(got, ssp.i0e(z64), GATE_BESSEL), GATE_BESSEL[0])

    def chain():
        c = z
        for _ in range(CHAIN_BESSEL):
            c = T.besseli(0, c, mode="norm") + c
        return c

    want = z64.copy()
    for _ in range(CHAIN_BESSEL):
        want = ssp.i0e(want) + want
    row(f"besseli nu=0 norm chain k={CHAIN_BESSEL} {NUM_BIG}", chain, nb,
        allclose_excess(chain()[o].cpu().numpy(), want, GATE_BESSEL), GATE_BESSEL[0], reps=5)
    got = T.besseli(3.7, z, mode="log")[o].cpu().numpy()
    # about 200 launches a call: 3 calls stay inside the card's launch queue
    row(f"besseli nu=3.7 log {NUM_BIG}", lambda: T.besseli(3.7, z, mode="log"), nb,
        vec_err(got, np.log(ssp.ive(3.7, z64)) + z64), GATE, reps=3)
    del z

    # implicit-class logsumexp / softmax over K-1 = 8 logits
    xl = rng.standard_normal((NUM_BIG, 8)).astype(np.float32)
    x = torch.from_numpy(xl).to(DEV)
    x64 = np.concatenate([xl[o], np.zeros((NUM_ORACLE, 1), np.float32)], -1).astype(np.float64)
    got = T.logsumexp(x, dim=-1, implicit=True)[o].cpu().numpy()
    row(f"logsumexp implicit K=9 {NUM_BIG}", lambda: T.logsumexp(x, dim=-1, implicit=True),
        x.numel() * 4 + NUM_BIG * 4, vec_err(got, ssp.logsumexp(x64, axis=-1)), GATE)
    got = T.softmax(x, dim=-1, implicit=(True, True))[o].cpu().numpy()
    row(f"softmax implicit (True, True) K=9 {NUM_BIG}",
        lambda: T.softmax(x, dim=-1, implicit=(True, True)), 2 * x.numel() * 4,
        normwise(got, ssp.softmax(x64, axis=-1)[:, :8]).max(), GATE)
    del x

    # DCT / DST (bench/suite.py "dct" and the types row)
    def transform_row(name, fn, oracle, shape, reps=10):
        xd = rng.standard_normal(shape).astype(np.float32)
        xt = torch.from_numpy(xd).to(DEV)
        got = fn(xt[:DCT_ORACLE]).double().cpu().numpy().reshape(min(DCT_ORACLE, shape[0]), -1)
        want = oracle(xd[:DCT_ORACLE].astype(np.float64)).reshape(got.shape)
        row(name, lambda: fn(xt), 2 * xt.numel() * 4, normwise(got, want).max(), GATE,
            reps=reps)

    transform_row(f"dct-II n=64 ortho {NUM_BIG}", lambda t: T.dct(t, norm="ortho"),
                  lambda a: sfft.dct(a, norm="ortho"), (NUM_BIG, 64))
    n, b = DCT_WIDE
    transform_row(f"dct-II n={n} ortho {b}", lambda t: T.dct(t, norm="ortho"),
                  lambda a: sfft.dct(a, norm="ortho"), (b, n), reps=5)
    for fam, typ in (("dct", 1), ("dct", 3), ("dct", 4), ("dst", 4)):
        transform_row(f"{fam}-{'I' * typ if typ < 4 else 'IV'} n=64 ortho {NUM_MID}",
                      lambda t, f=fam, ty=typ: getattr(T, f)(t, type=ty, norm="ortho"),
                      lambda a, f=fam, ty=typ: getattr(sfft, f)(a, type=ty, norm="ortho"),
                      (NUM_MID, 64))
    transform_row(f"dctn 32x32 ortho {DCTN_SHAPE[0]}",
                  lambda t: T.dctn(t, dim=(-2, -1), norm="ortho"),
                  lambda a: sfft.dctn(a, axes=(-2, -1), norm="ortho"), DCTN_SHAPE)

    # the stochastic estimators on 512 SPD 64 x 64 as one operator
    bst, nst = EST_BLOCKS
    a = rng.standard_normal((bst, nst, nst)).astype(np.float32)
    spd_np = np.einsum("...ij,...kj->...ik", a, a) / nst + np.eye(nst, dtype=np.float32)
    spd64 = spd_np.astype(np.float64)
    ops = torch.from_numpy(spd_np).to(DEV)
    estimator_rows(torch, row, f"{bst}x{nst}x{nst}", ops, None, spd64, ops.numel() * 4)
    del ops

    # ... and with sym_matvec on bench.py's 1M x 4 compact batch as the operator
    full = spd(rng, B_MAIN, N_MAIN)
    mat = torch.from_numpy(compact(full)).to(DEV)
    sym_matvec_cf.launches = 0
    launched = estimator_rows(torch, row, f"{B_MAIN}x{N_MAIN} compact (sym_matvec)",
                              lambda v: T.sym_matvec(mat, v), (B_MAIN, N_MAIN),
                              full.astype(np.float64), mat.numel() * 4,
                              launches=lambda: sym_matvec_cf.launches)
    if not launched:
        fail("the compact-operator estimators did not launch sym_matvec_cf")
    del mat, full
    torch.cuda.synchronize()
    sweep = dct_sweep(torch, gen)
    line = json.dumps({"numerics": rows, "dct_sweep": sweep})
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "numerics.json").write_text(line + "\n")
    log(line)


def power_oracle(torch, full64, v0, steps):
    """The Rayleigh quotient after ``steps`` power-iteration steps from
    ``v0`` on the block-diagonal operator ``full64``, in float64 on the
    card."""
    a = torch.from_numpy(full64).to(DEV)
    v, mu = v0.double(), float("inf")
    for _ in range(steps):
        w = (a @ v[..., None])[..., 0]
        mu = torch.sum(v * w)
        v = w / torch.sqrt(torch.sum(w * w))
    return float(mu)


def estimator_rows(torch, row, what, op, shape, full64, nbytes, launches=None):
    """trapprox (Hutchinson and Hutch++, s = 64), vbald and maxeig_power
    (256 steps) on one operator, each against its float64 oracle; with
    ``launches``, the kernel launches counted over the first call of each
    (the timed calls come after)."""
    import fastmath_tpu_torch as T
    from fastmath_tpu_torch.ops.stochastic import _sample

    kw = {} if shape is None else {"shape": shape, "device": DEV, "dtype": torch.float32}
    gen = lambda: torch.Generator(device=DEV).manual_seed(SEED)  # noqa: E731
    top = float(np.linalg.eigvalsh(full64)[:, -1].max())
    v0 = _sample(gen(), "rademacher", full64.shape[:-1], torch.float32, DEV)
    calls = {
        "trapprox": (lambda: T.trapprox(op, samples=EST_SAMPLES, generator=gen(), **kw),
                     float(np.trace(full64, axis1=-2, axis2=-1).sum())),
        "trapprox_hutchpp": (lambda: T.trapprox(op, samples=EST_SAMPLES, hutchpp=True,
                                                generator=gen(), **kw),
                             float(np.trace(full64, axis1=-2, axis2=-1).sum())),
        "vbald": (lambda: T.vbald(op, generator=gen(), **kw),
                  float(np.linalg.slogdet(full64)[1].sum())),
        "maxeig_power": (lambda: T.maxeig_power(op, max_iter=EST_MAX_ITER, tol=0.0,
                                                generator=gen(), **kw),
                         power_oracle(torch, full64, v0, EST_MAX_ITER)),
    }
    counted = 0
    for name, (fn, want) in calls.items():
        before = launches() if launches else 0
        got = float(fn())
        extra = {"to_top": abs(got - top) / top} if name == "maxeig_power" else {}
        if launches:
            extra["launches"] = launches() - before
            counted += extra["launches"] > 0
        row(f"{name} {what}", fn, nbytes, abs(got - want) / abs(want), GATE_EST[name], reps=3,
            queue=name.startswith("trapprox"), **extra)
    return counted == len(calls)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import fastmath_tpu_torch  # noqa: F401  (fails outside the repository)

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    log("== phase 1: device and build")
    smi = phase_device(torch)
    log("== phase 2: kernels against their plain versions")
    phase_kernels_vs_plain(torch, rng)
    phase_products_vs_plain(torch, rng)
    phase_batched_vs_plain(torch, rng)
    phase_factor_vs_plain(torch, rng)
    phase_iterate_vs_plain(torch, rng)
    phase_eig_vs_plain(torch, rng)
    phase_lie_vs_plain(torch, rng)
    log("== phase 3: gradients")
    phase_gradients(torch, rng)
    phase_batched_gradients(torch, rng)
    phase_factor_gradients(torch, rng)
    phase_iterate_gradients(torch, rng)
    phase_eig_gradients(torch, rng)
    phase_lie_gradients(torch, rng)
    log("== phase 4: main path at full size")
    kernels, batch = phase_main_path(torch, rng)
    kernels[0]["shapes"], kernels[1]["shapes"] = phase_wide(torch, rng)
    log("== phase 5: the products' path at full size")
    kernels += phase_products(torch, rng, *batch)
    mat4 = batch[2]
    del batch
    log("== phase 6: the batched path at full size")
    kernels += phase_batched(torch, rng)
    log("== phase 7: the factor path at full size")
    kernels += phase_factor(torch, rng, mat4)
    del mat4
    log("== phase 8: the iterations and the full-storage products at full size")
    kernels += phase_iterate(torch, rng)
    log("== phase 9: eig_sym and sugar.lmdiv at full size")
    kernels += phase_eig(torch, rng)
    log("== phase 10: the Lie path (expm, logm, meanm) at full size")
    kernels += phase_lie(torch, rng)
    log("== phase 11: the numerics path at full size")
    phase_numerics(torch, rng)
    torch.cuda.synchronize()
    log("== phase 12: the kernels line")
    log(f"total_seconds={time.perf_counter() - t0:.1f}")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
