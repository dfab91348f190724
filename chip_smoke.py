#!/usr/bin/env python3
"""Drive the PyTorch port (``fastmath_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``fastmath_tpu_torch/kernels/csrc``
(``nvcc``, into ``build/``), then runs, each phase failing the run:

1. device: the card's name and power limit, the build time and each
   kernel's registers and spills (``-Xptxas -v``; the full log goes to
   ``chiprun_out/chip_smoke/``);
2. every kernel against its plain PyTorch version on the card, at every
   tier (N = 1 .. 32), float32 and float64, with and without ``eps``,
   ``refine`` 0..2, on a ragged batch, in the batch-major and the
   channel-first layout, and against a float64 numpy oracle;
3. gradients of ``sym_solve`` and ``sym_solve_chain`` through the kernels
   against the same through the plain versions;
4. the main path at full size: the public ``sym_solve`` on a 1M batch of
   4x4 float32 compact SPD matrices made as ``bench.py`` makes them, and
   ``sym_solve_chain`` with k = 128 on the same batch; launch counts,
   normwise error against float64 numpy, solves/s; then N = 8 and 16;
5. one JSON line of per-kernel times beside their bounds.

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
    """Per-problem ||got - want|| / ||want||. For a chain pass its ``add``:
    the recurrence x <- A \\ x + add can cancel (||x_k|| far below the
    per-step terms), and rounding scales with the terms, so the error is
    taken relative to ||want|| + ||add||."""
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
            k = re.search(r"fm\d+(\w+?)I([fd])(?:Li(\d+)E)?", name)
            name = f"{k.group(1)}<{k.group(2)}{',' + k.group(3) if k.group(3) else ''}>" if k else name
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


def phase_kernels_vs_plain(torch, rng):
    from fastmath_tpu_torch.kernels import sym_cuda

    worst = {}
    for dt_name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        for n in (1, 2, 3, 4, 5, 6, 8, 9, 16, 32):
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


# --- phase 3 -----------------------------------------------------------------


def phase_gradients(torch, rng):
    import fastmath_tpu_torch as T

    for n in (3, 6, 12):
        cm = compact(spd(rng, 515, n, np.float64))
        ins0 = [torch.tensor(a, device=DEV) for a in
                (cm, rng.standard_normal((515, n)), rng.standard_normal((515, n)))]

        def grads(backend):
            ins = [t.clone().requires_grad_() for t in ins0]
            out = (T.sym_solve(ins[0], ins[1], eps=0.1, backend=backend).square().sum()
                   + T.sym_solve_chain(ins[0], ins[1], 3, add=ins[2],
                                       backend=backend).square().sum())
            return torch.autograd.grad(out, ins)

        worst = 0.0
        for k, p in zip(grads("cuda"), grads("torch")):
            worst = max(worst, ((k - p).norm() / p.norm()).item())
        torch.cuda.synchronize()
        log(f"  grad n={n}: kernel vs plain relative {worst:.3e} (tol 1e-10)")
        if not worst <= 1e-10:
            fail(f"gradient n={n} differs: {worst:.3e}")


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
    return kernels


def phase_wide(torch, rng):
    """Solve and chain at N = 8 (unrolled PLU) and N = 16 (rolled PLU)."""
    import fastmath_tpu_torch as T
    from fastmath_tpu_torch.kernels import sym_cuda
    from fastmath_tpu_torch.layouts import full_to_sym

    torch.backends.cuda.matmul.allow_tf32 = False
    for n in (8, 16):
        a = torch.from_numpy(rng.standard_normal((B_WIDE, n, n)).astype(np.float32)).to(DEV)
        mat = full_to_sym(a @ a.mT + n * torch.eye(n, device=DEV)).contiguous()
        vec = torch.from_numpy(rng.standard_normal((B_WIDE, n)).astype(np.float32)).to(DEV)
        x = T.sym_solve(mat, vec, backend="cuda")
        nw = normwise(x[:4096].cpu().numpy(),
                      oracle_solve(T.layouts.sym_to_full(mat[:4096]).cpu().numpy(),
                                   vec[:4096].cpu().numpy()))
        if not nw.max() <= GATE:
            fail(f"N={n} solve normwise error {nw.max():.3e}")
        t_s = device_ms(torch, lambda: sym_cuda.launch_solve(mat, vec), reps=10)
        t_c = device_ms(torch, lambda: sym_cuda.launch_chain(mat, vec, vec, None, CHAIN_K),
                        reps=5)
        if t_s is None or t_c is None:
            fail(f"N={n}: the kernels could not be queued ahead of the card")
        log(f"  N={n} B={B_WIDE} f32 kernels: solve {t_s:.4f} ms "
            f"({B_WIDE / t_s * 1e3:.4e} solves/s, normwise max {nw.max():.3e}); "
            f"chain k={CHAIN_K} {t_c:.4f} ms ({B_WIDE * CHAIN_K / t_c * 1e3:.4e} solves/s)")


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
    log("== phase 3: gradients")
    phase_gradients(torch, rng)
    log("== phase 4: main path at full size")
    kernels = phase_main_path(torch, rng)
    phase_wide(torch, rng)
    torch.cuda.synchronize()
    log(f"total_seconds={time.perf_counter() - t0:.1f}")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
