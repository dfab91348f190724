"""Where the port keeps its compiled kernels.

PyTorch counterpart of ``fastmath_tpu/core/cache.py``. The port's compile
products are the shared libraries that ``nvcc`` builds from
``kernels/csrc`` (:mod:`fastmath_tpu_torch.kernels._build`), one per
source, under ``<dir>/<hash>/`` where the hash covers every source and
the compiler flags: a later process with the same sources loads them
without compiling. With no call and no variable, ``<dir>`` is
``build/kernels/`` at the repository root.

Two ways to choose another directory:

* programmatic: ``fastmath_tpu_torch.enable_compilation_cache("/path")``
  (before the first launch of a kernel; no path means
  ``$FASTMATH_TPU_TORCH_CACHE_DIR``, else
  ``~/.cache/fastmath_tpu_torch/kernels``);
* environment: ``FASTMATH_TPU_TORCH_CACHE_DIR=/path`` before importing
  ``fastmath_tpu_torch``; the package honours it at import. The variable
  is the port's own, so a process that imports both packages keeps the
  two caches apart.
"""
from __future__ import annotations

import os
import pathlib
from typing import Optional

__all__ = ["enable_compilation_cache", "compilation_cache_dir"]

_DEFAULT_DIR = os.path.join("~", ".cache", "fastmath_tpu_torch", "kernels")
_ENV_KNOB = "FASTMATH_TPU_TORCH_CACHE_DIR"


def compilation_cache_dir() -> str:
    """The directory the kernels are built into and loaded from. Never
    None: every build is kept."""
    from ..kernels import _build

    return str(_build.BUILD_DIR)


def enable_compilation_cache(cache_dir: Optional[str] = None, *,
                             min_compile_time_secs: float = 1.0) -> str:
    """Build and load the kernels under ``cache_dir`` from now on; create
    it and return it.

    ``cache_dir`` defaults to ``$FASTMATH_TPU_TORCH_CACHE_DIR`` or
    ``~/.cache/fastmath_tpu_torch/kernels``. ``min_compile_time_secs`` is
    accepted for the JAX package's signature: each ``nvcc`` build takes
    seconds, so every build is kept. Libraries already loaded stay loaded,
    as compiled executables do in JAX.
    """
    from ..kernels import _build

    if cache_dir is None:
        cache_dir = os.environ.get(_ENV_KNOB) or _DEFAULT_DIR
    path = pathlib.Path(os.path.expanduser(str(cache_dir))).resolve()
    path.mkdir(parents=True, exist_ok=True)
    _build.BUILD_DIR = path
    return str(path)


def _maybe_enable_from_env() -> None:
    """Import-time hook: honour ``FASTMATH_TPU_TORCH_CACHE_DIR`` if set."""
    if os.environ.get(_ENV_KNOB):
        enable_compilation_cache()
