#!/usr/bin/env python3
"""Time one source tree's full-storage solve, Cholesky, inverse, compact
solve and product kernels on one NVIDIA GPU, to compare two versions of a
kernel in one call.

    python3 /path/to/chip_ab.py TAG [--library]

Run it from the root of the tree to time (its ``chip_smoke.py`` and
``fastmath_tpu_torch`` are imported from the working directory), once for
each tree in turns (old, new, new, old). It builds ``csrc/batched.cu``,
``csrc/sym_solve.cu`` and ``csrc/batched_products.cu``, times each kernel
three times with ``chip_smoke.device_ms`` at the bench suite's shapes (the
solve 16x16 on 500k, 24x24 on 200k, 32x32 on 100k with one column and
16x16 with 16; Cholesky 16x16, 24x24, 32x32; the inverse 16x16 and 32x32;
the compact solve at N = 16 on 262,144 (also with ``refine=1``), N = 24
on 131,072 and N = 32 on 65,536; the product 4x4 on 1M, 16x16 on 500k and
32x32 on 100k), holds each result against its plain version, and prints
one JSON line: ``tag``, each shape's three times and normwise error, and
the registers and spills (``-Xptxas -v``) of every kernel but the
unrolled tiers. ``--library`` also times ``torch.linalg.solve_ex`` /
``cholesky_ex`` (the compact solve's on the densified batch) and
``torch.matmul`` on the same inputs. It imports neither JAX nor
``fastmath_tpu``.
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
    from fastmath_tpu_torch.kernels import sym_cuda as SC
    from fastmath_tpu_torch.layouts import full_to_sym

    tag, library = sys.argv[1], "--library" in sys.argv[2:]
    libs = ["batched", "sym_solve", "batched_products"]
    _build.build_all(libs)
    res = {"tag": tag}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def timed(key, launch, plain, lib):
        got, want = launch(), plain()
        err = ((got - want).norm(dim=1) / want.norm(dim=1)).max().item()
        res[key] = [C.device_ms(torch, launch, reps=10) for _ in range(3)] + [err]
        if library:
            res[f"{key} library"] = C.yardstick_ms(torch, lib, key)

    for n, b, k in ((16, 500_000, 1), (24, 200_000, 1), (32, 100_000, 1), (16, 500_000, 16)):
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
        a = C.spd_on_card(torch, gen, b, n)
        m = full_to_sym(a).contiguous()
        timed(f"chol {n}x{n} on {b}", lambda: BC.launch_chol(m), lambda: BC.chol_plain(m),
              lambda: torch.linalg.cholesky_ex(a))
        del a, m
    for n, b, refine in ((16, 262_144, 0), (16, 262_144, 1), (24, 131_072, 0),
                         (32, 65_536, 0)):
        a = C.spd_on_card(torch, gen, b, n)
        m = full_to_sym(a).contiguous()
        v = torch.randn(b, n, generator=gen, device="cuda")
        timed(f"sym_solve N={n} on {b} refine={refine}",
              lambda: SC.launch_solve(m, v, None, refine),
              lambda: SC.solve_plain(m, v, None, refine),
              lambda: torch.linalg.solve_ex(a, v[..., None]))
        del a, m, v
    for n, b in ((4, 1_000_000), (16, 500_000), (32, 100_000)):
        x, y = (torch.randn(b, n, n, generator=gen, device="cuda") for _ in range(2))
        xf, yf = x.reshape(b, -1), y.reshape(b, -1)
        timed(f"matmul {n}x{n} on {b}", lambda: BC.launch_matmul(xf, yf, n, n, n),
              lambda: BC.matmul_plain(xf, yf, n, n, n), lambda: torch.matmul(x, y))
        del x, y, xf, yf
    res["ptxas"] = [row for lib in libs
                    for row in C.ptxas_summary(_build.build_log(lib).read_text())
                    if "unrolled" not in row]
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
