#!/usr/bin/env python3
"""Time one source tree's full-storage solve, Cholesky, inverse, compact
solve, product, matrix logarithm, rolled eig, chain and power-iteration
kernels on one NVIDIA GPU, to compare two versions of a kernel in one call.

    python3 /path/to/chip_ab.py TAG [--library] [--only GROUP[,GROUP...]]

Run it from the root of the tree to time (its ``chip_smoke.py`` and
``fastmath_tpu_torch`` are imported from the working directory), once for
each tree in turns (old, new, new, old). It builds the sources of the
groups it times, times each kernel three times with
``chip_smoke.device_ms`` at the bench suite's shapes, holds each result
against its plain version, and prints one JSON line: ``tag``, each
shape's three times and error, and the registers and spills (``-Xptxas
-v``) of every kernel of those sources but the unrolled tiers (except
``logm_unrolled``). The groups (all by default): ``solve``
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
v normwise). ``--library`` also times ``torch.linalg.solve_ex`` /
``cholesky_ex`` (the compact solve's on the densified batch),
``torch.matmul`` and ``eigvalsh`` / ``eigh`` on the same inputs. It
imports neither JAX nor ``fastmath_tpu``.
"""
import json
import pathlib
import sys


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
    from fastmath_tpu_torch.layouts import full_to_sym, sym_to_full

    tag, library = sys.argv[1], "--library" in sys.argv[2:]
    groups = {"solve", "chol", "sym_solve", "matmul", "logm", "logm4", "eig", "chain", "maxeig"}
    if "--only" in sys.argv:
        groups = set(sys.argv[sys.argv.index("--only") + 1].split(","))
    sources = {"solve": "batched", "chol": "batched", "sym_solve": "sym_solve",
               "matmul": "batched_products", "logm": "logm", "logm4": "logm", "eig": "eig",
               "chain": ("sym_iterate", "sym_solve"), "maxeig": "sym_iterate"}
    libs = sorted({lib for g in groups for lib in
                   ((sources[g],) if isinstance(sources[g], str) else sources[g])})
    _build.build_all(libs + (["expm"] if groups & {"logm", "logm4"} else []))
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
    res["ptxas"] = [row for lib in libs
                    for row in C.ptxas_summary(_build.build_log(lib).read_text())
                    if "unrolled" not in row or row.startswith("logm_unrolled")]
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
