"""Build the CUDA kernels in ``csrc/`` with ``nvcc`` at first use and
load them with ``ctypes``.

Each ``csrc/*.cu`` file becomes one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). Libraries go
to ``build/kernels/<hash>/`` at the repository root, keyed by a hash of
every source and of the compiler flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. All sources build in parallel,
one ``nvcc`` process each.

Nothing here runs at import time. A missing ``nvcc`` or a failed build
raises with the compiler's output; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

__all__ = ["load", "build_all", "library_path", "nvcc_path", "BUILD_DIR",
           "build_log"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin/nvcc``, else the one
    on ``PATH``, else ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of fastmath_tpu_torch "
        "are built at first use and need the CUDA toolkit")


def _sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> pathlib.Path:
    """Where the library built from ``csrc/<name>.cu`` goes."""
    return BUILD_DIR / _sources_hash() / f"lib{name}.so"


def build_log(name: str) -> pathlib.Path:
    """The compiler's output (``-Xptxas -v``: registers, spills) for
    ``csrc/<name>.cu``, kept beside its library."""
    return library_path(name).with_suffix(".log")


def _start(name: str):
    out = library_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return name, out, tmp, cmd, proc


def build_all(names=None) -> dict[str, pathlib.Path]:
    """Compile every ``csrc/*.cu`` (or the given names) whose library is
    missing, all at once; return each name's library path."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None else names
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    jobs = [_start(n) for n in todo]
    errors = []
    for name, out, tmp, cmd, proc in jobs:
        log, _ = proc.communicate()
        build_log(name).write_text(log)
        if proc.returncode != 0:
            errors.append(f"$ {' '.join(cmd)}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _libs[name] = lib
        return lib
