#!/usr/bin/env python3
"""Where ``logm_warp``'s time goes at 17 <= d <= 32, on one NVIDIA GPU.

    python3 /path/to/logm_probe.py TAG

Run it from the root of the tree to probe (its ``fastmath_tpu_torch`` and
``chip_smoke.py`` are read from the working directory). It copies the
tree's ``kernels/`` to ``build/logm_probe/`` and patches the copy's
``csrc/logm.cu``: each problem counts its square roots and Denman-Beavers
steps and its ``clock64`` cycles from load to store; the tolerance can be
computed with another d (``tol_d``), and every problem can be forced
through the same 4 square roots of ``force`` steps each (the results are
then not a logarithm: only the time counts). The tree's own kernel is not
touched. For each input (the bench suite's expm of randn 0.5/sqrt(d) at
d = 17, 20, 24, 28, 32 on 15,625, and the 17x17 problems padded with the
identity to 32x32) it prints one JSON line: the counts' means and
histogram, the cycles a problem and a step, and ``device_ms`` of the
patched kernel with counting off at the input's own tolerance, at d = 32's
and forced to 4 steps; then the SASS instruction count of every
``logm_warp`` instantiation (``cuobjdump -sass``). It imports neither JAX
nor ``fastmath_tpu``.
"""
import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys

# (pattern, replacement) pairs on csrc/logm.cu; each pattern (a regular
# expression) must match once
PATCHES = [
    (r"namespace fm \{\n\nconstexpr int kIssMax",
     "namespace fm {\n\n__device__ long long* g_probe = nullptr;\n__device__ int g_tol_d = 0;\n"
     "__device__ int g_force = 0;\n\nconstexpr int kIssMax"),
    (r"  const T tol = lie_eps\(T\(0\)\) \* T\(8 \* d\);\n  const T tol2 = tol \* tol, conv2",
     "  const T tol = lie_eps(T(0)) * T(8 * (g_tol_d ? g_tol_d : d));\n"
     "  const int force = g_force;\n  long long* probe = g_probe;\n"
     "  const long long c0 = clock64();\n  int n_db = 0;\n  const T tol2 = tol * tol, conv2"),
    (r"    on = on && lie_finite\(d2\) && d2 > thresh2;",
     "    on = force > 0 ? it < 4 : on && lie_finite(d2) && d2 > thresh2;"),
    (r"      \} else if \(j == kDbIters\) \{\n        step = false;\n      \}\n",
     "      } else if (j == kDbIters) {\n        step = false;\n      }\n"
     "      if (force > 0) step = j < force;\n      n_db += step ? 1 : 0;\n"),
    (r"(\+\+k;\n\s+)if \(!\(lie_finite\(e2\) && e2 <= conv2\)\) \{",
     r"\1if (force == 0 && !(lie_finite(e2) && e2 <= conv2)) {"),
    (r"  if \(slot >= nb \|\| gl >= d\) return;",
     "  if (probe != nullptr && slot < nb && gl == 0) {\n"
     "    probe[3 * slot] = k;\n    probe[3 * slot + 1] = n_db;\n"
     "    probe[3 * slot + 2] = clock64() - c0;\n  }\n"
     "  if (slot >= nb || gl >= d) return;"),
    (r"// The largest d of the one-thread tier",
     "extern \"C\" int fm_logm_probe(void* p, int tol_d, int force) {\n"
     "  cudaMemcpyToSymbol(fm::g_probe, &p, sizeof(p));\n"
     "  cudaMemcpyToSymbol(fm::g_force, &force, sizeof(int));\n"
     "  return cudaMemcpyToSymbol(fm::g_tol_d, &tol_d, sizeof(int));\n}\n\n"
     "// The largest d of the one-thread tier"),
]


def patched_copy(root):
    """The tree's kernels/ copied to build/logm_probe/ with logm.cu patched."""
    dst = root / "build" / "logm_probe"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(root / "fastmath_tpu_torch" / "kernels" / "csrc", dst / "csrc")
    src = (dst / "csrc" / "logm.cu").read_text()
    for pattern, new in PATCHES:
        src, hits = re.subn(pattern, new, src)
        if hits != 1:
            raise SystemExit(f"logm_probe: {pattern!r} matched {hits} times")
    (dst / "csrc" / "logm.cu").write_text(src)
    return dst


def main():
    import torch

    if not torch.cuda.is_available():
        print("logm_probe: no CUDA device", file=sys.stderr)
        return 2
    root = pathlib.Path.cwd()
    sys.path.insert(0, str(root))
    import chip_smoke as C
    from fastmath_tpu_torch.kernels import _build
    from fastmath_tpu_torch.kernels import expm as KE
    from fastmath_tpu_torch.kernels import logm as KL

    tag = sys.argv[1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dst = patched_copy(root)
    lib_path = dst / "liblogm_probe.so"
    build = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                            str(dst / "csrc" / "logm.cu")], capture_output=True, text=True)
    if build.returncode != 0:
        raise SystemExit(build.stdout + build.stderr)
    lib = ctypes.CDLL(str(lib_path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fm_logm.argtypes = [i, i, ll, p, ll, ll, ll, p, ll, ll, p]
    lib.fm_logm_probe.argtypes = [p, i, i]

    def run(a, out):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fm_logm(0, a.shape[-1], a.shape[0], a.data_ptr(), *a.stride(),
                          out.data_ptr(), *out.stride(), stream)
        if err:
            raise RuntimeError(f"fm_logm returned {err}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    cases = []
    for d in (17, 20, 24, 28, 32):
        e = KE.launch_expm(torch.randn(15_625, d, d, generator=gen, device="cuda")
                           * (0.5 / d ** 0.5))
        cases.append((f"{d}x{d} on 15625", e))
        if d == 17:
            e32 = torch.eye(32, device="cuda").repeat(15_625, 1, 1)
            e32[:, :17, :17] = e
            cases.append(("32x32 on 15625 holding the 17x17 problems", e32))
    print(json.dumps({"tag": tag, "device": smi}), flush=True)
    for key, a in cases:
        b, d = a.shape[0], a.shape[-1]
        out = torch.empty(b, d * d, device="cuda")
        buf = torch.zeros(b, 3, dtype=torch.int64, device="cuda")
        lib.fm_logm_probe(buf.data_ptr(), 0, 0)
        run(a, out)
        torch.cuda.synchronize()
        lib.fm_logm_probe(None, 0, 0)
        err = C.lie_normwise(torch, out.reshape(b, d, d), KL.logm_plain(a)).max().item()
        q = buf.double()
        row = {"case": key, "roots": q[:, 0].mean().item(), "db_steps": q[:, 1].mean().item(),
               "db_hist": torch.bincount(buf[:, 1]).tolist(),
               "cycles_per_problem": q[:, 2].mean().item(),
               "cycles_per_db_step": (q[:, 2] / q[:, 1].clamp_min(1)).mean().item(),
               "vs_plain": err}
        for name, tol_d, force in (("ms", 0, 0), ("ms tol of d=32", 32, 0),
                                   ("ms forced to 4 roots of 4 steps", 0, 4)):
            lib.fm_logm_probe(None, tol_d, force)
            row[name] = min(C.device_ms(torch, lambda: run(a, out), reps=10) for _ in range(2))
        lib.fm_logm_probe(None, 0, 0)
        print(json.dumps(row), flush=True)
    sass = subprocess.run([str(pathlib.Path(_build.nvcc_path()).with_name("cuobjdump")), "-sass",
                           str(lib_path)], capture_output=True, text=True).stdout
    sizes, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*logm_warpI([fd])((?:Li\d+E)+)E", line)
        if m:
            name = f"logm_warp<{','.join([m.group(1), *re.findall(r'Li(\d+)E', m.group(2))])}>"
        elif "Function" in line:
            name = None
        if name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            sizes[name] = sizes.get(name, 0) + 1
    print(json.dumps({"sass_instructions": sizes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
