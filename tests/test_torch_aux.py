"""The port's ``core/checks``, ``utils/profiling``, ``core/cache``,
``kernels.DEFAULT_BLOCK`` and the ``__all__`` of its packages, against the
JAX package where it has a counterpart (``tests/test_aux.py``).

* ``assert_finite`` raises ``ValueError`` on NaN or inf, ``TypeError``
  under tracing; ``debug_nans`` and ``checked`` raise on a NaN (and, with
  ``div``, inf) that a torch function makes from inputs that held none,
  and pass clean input through bit for bit;
* ``device_timer`` fills its sink; ``trace_to`` writes a trace holding an
  ``annotate`` range;
* ``enable_compilation_cache`` moves the kernels' libraries under its
  directory (no ``nvcc`` needed), and the environment variable does it at
  import in a child process;
* ``DEFAULT_BLOCK`` is ``kThreads`` of ``csrc/sym_common.cuh``;
* every name of the ``__all__`` of the JAX package's top level, ``core``,
  ``utils``, ``kernels`` and ``parallel`` (read by AST) is in the port's
  counterpart ``__all__``.

Inputs are small float64 tensors made from a numpy seed.
"""
import ast
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import fastmath_tpu_torch as T
from fastmath_tpu_torch.core import checks as C
from fastmath_tpu_torch.kernels import _build
from fastmath_tpu_torch.utils import profiling as P

from _torch_cpu import one_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "fastmath_tpu"


def test_assert_finite():
    x = torch.tensor([1.0, 2.0])
    assert C.assert_finite(x) is x
    for bad in (float("nan"), float("inf")):
        with pytest.raises(ValueError, match="mat has non finite values."):
            C.assert_finite(torch.tensor([1.0, bad]), "mat")
    with pytest.raises(TypeError, match="checked"):
        torch.jit.trace(C.assert_finite, (x,))


def test_debug_nans():
    with C.debug_nans():
        torch.log(torch.tensor([1.0, 2.0]))
        torch.log(torch.tensor([float("nan")]))  # NaN in, NaN out: not made here
        with pytest.raises(FloatingPointError, match="log returned NaN"):
            torch.log(torch.tensor([-1.0]))
    with C.debug_nans(False):
        torch.log(torch.tensor([-1.0]))
    torch.log(torch.tensor([-1.0]))  # off again after the block


def test_debug_nans_in_a_public_op(rng):
    """A zero matrix in a batch: the solve's plain version makes NaN."""
    a = rng.standard_normal((4, 3, 3))
    mat = T.full_to_sym(torch.tensor(a @ a.transpose(0, 2, 1) + 3 * np.eye(3)))
    mat[2] = 0.0
    vec = torch.tensor(rng.standard_normal((4, 3)))
    with pytest.raises(FloatingPointError, match="returned NaN"):
        with C.debug_nans():
            T.sym_solve(mat, vec)


def test_checked(rng):
    f = C.checked(torch.log)
    x = torch.tensor([1.0, 2.0], dtype=torch.float64)
    np.testing.assert_array_equal(f(x).numpy(), np.log([1.0, 2.0]))
    with pytest.raises(FloatingPointError, match="NaN"):
        f(torch.tensor([-1.0]))
    with pytest.raises(FloatingPointError, match="inf"):
        f(torch.tensor([0.0]))
    C.checked(torch.log, div=False)(torch.tensor([0.0]))
    C.checked(torch.log, nan=False, div=False)(torch.tensor([-1.0]))
    a = rng.standard_normal((8, 4, 4))
    mat = T.full_to_sym(torch.tensor(a @ a.transpose(0, 2, 1) + 4 * np.eye(4)))
    vec = torch.tensor(rng.standard_normal((8, 4)))
    got = C.checked(T.sym_solve, oob=True)(mat, vec)
    np.testing.assert_array_equal(got.numpy(), T.sym_solve(mat, vec).numpy())


def test_device_timer(rng):
    sink = []
    with P.device_timer("x", sink=sink) as t:
        t.result = torch.sum(torch.tensor(rng.standard_normal(1000)) ** 2)
    assert sink and sink[0][0] == "x" and sink[0][1] > 0 and t.elapsed == sink[0][1]


def test_trace_to(tmp_path):
    @P.annotate("fm_double")
    def double(x):
        return 2 * x

    with P.trace_to(str(tmp_path)):
        with P.annotate("fm_solve"):
            double(torch.ones(4))
    traces = list(tmp_path.glob("*.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert {"fm_solve", "fm_double"} <= names


@pytest.fixture
def build_dir():
    saved = _build.BUILD_DIR
    yield
    _build.BUILD_DIR = saved


def test_enable_compilation_cache(tmp_path, build_dir):
    assert T.core.compilation_cache_dir() == str(_build.BUILD_DIR)
    where = tmp_path / "kernels"
    got = T.enable_compilation_cache(str(where), min_compile_time_secs=0.0)
    assert got == str(where.resolve()) and where.is_dir()
    assert T.core.compilation_cache_dir() == got
    assert _build.library_path("sym_solve").is_relative_to(where.resolve())


def test_cache_environment_variable(tmp_path):
    env = dict(os.environ, FASTMATH_TPU_TORCH_CACHE_DIR=str(tmp_path / "env"))
    code = ("import fastmath_tpu_torch as T; from fastmath_tpu_torch.kernels import _build; "
            "print(T.core.compilation_cache_dir()); print(_build.library_path('eig'))")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=300).stdout.split()
    want = str((tmp_path / "env").resolve())
    assert out[0] == want and out[1].startswith(want + os.sep)
    assert (tmp_path / "env").is_dir()


def test_default_block():
    text = (ROOT / "fastmath_tpu_torch/kernels/csrc/sym_common.cuh").read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", text).group(1))
    assert T.kernels.DEFAULT_BLOCK == threads
    assert "DEFAULT_BLOCK" in T.kernels.__all__


def _module_all(path):
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__"
                                                for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path} has no literal __all__")


@pytest.mark.parametrize("package", ["", "core", "utils", "kernels", "parallel"])
def test_all_covers_the_reference(package):
    import importlib

    ref = _module_all(REF / package / "__init__.py")
    mod = importlib.import_module("fastmath_tpu_torch" + (f".{package}" if package else ""))
    assert [n for n in ref if n not in mod.__all__] == []
    assert [n for n in mod.__all__ if not hasattr(mod, n)] == []
