"""The PyTorch port's layouts and public compact-symmetric solves against
``fastmath_tpu`` (JAX, CPU).

On the CPU the port runs the plain PyTorch versions of its CUDA kernels;
the same seeded numpy arrays go to both packages. Tolerances: float64
results agree to ``rtol=1e-9`` (both packages run pivoted LU or the
adjugate in float64; they differ in operation order only), float32
normwise to ``1e-5`` (the main-path accuracy gate of ``bench.py``), and
the layout helpers exactly (they only move values).
"""
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastmath_tpu as F
from fastmath_tpu import layouts as JL

import fastmath_tpu_torch as T
from fastmath_tpu_torch import layouts as TL

F64_RTOL = 1e-9
F32_NORMWISE = 1e-5


def _compact(full):
    """numpy (..., n, n) symmetric -> compact (..., n(n+1)/2)."""
    n = full.shape[-1]
    rows, cols = np.triu_indices(n, k=1)
    return np.concatenate([np.diagonal(full, axis1=-2, axis2=-1),
                           full[..., rows, cols]], axis=-1)


def _spd(rng, shape, n):
    a = rng.standard_normal((*shape, n, n))
    return np.einsum("...ij,...kj->...ik", a, a) + n * np.eye(n)


def _normwise(got, want):
    return np.max(np.linalg.norm(got - want, axis=-1)
                  / np.linalg.norm(want, axis=-1))


def _jax(fn, *arrays, **kw):
    return np.asarray(fn(*(jnp.asarray(a) for a in arrays), **kw))


def _port(fn, *arrays, **kw):
    out = fn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays), **kw)
    return out.detach().numpy()


# --- layouts: every function of layouts/sym.py, exact ------------------------


def test_layout_index_helpers():
    for n in range(1, 10):
        nn = TL.compact_size(n)
        assert nn == JL.compact_size(n)
        assert TL.sym_dim(nn) == JL.sym_dim(nn) == n
        np.testing.assert_array_equal(TL.compact_index_grid(n),
                                      JL.compact_index_grid(n))
        for i in range(n):
            for j in range(n):
                assert TL.tri_index(i, j, n) == JL.tri_index(i, j, n)
    for bad in (2, 4, 5, 7):
        with pytest.raises(ValueError):
            TL.sym_dim(bad)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7])
def test_classify_layout(n):
    for nn in range(1, n * n + 3):
        try:
            want = JL.classify_layout(nn, n)
        except ValueError:
            with pytest.raises(ValueError):
                TL.classify_layout(nn, n)
            continue
        assert TL.classify_layout(nn, n).value == want.value
    assert {m.value for m in TL.MatrixLayout} == {m.value for m in JL.MatrixLayout}


@pytest.mark.parametrize("n", [1, 3, 5])
def test_layout_conversions(n, rng):
    full = rng.standard_normal((2, 3, n, n))
    np.testing.assert_array_equal(_port(TL.full_to_sym, full),
                                  _jax(JL.full_to_sym, full))
    cm = rng.standard_normal((2, 3, TL.compact_size(n)))
    np.testing.assert_array_equal(_port(TL.sym_to_full, cm),
                                  _jax(JL.sym_to_full, cm))
    np.testing.assert_array_equal(_port(TL.sym_to_full, cm, n=n),
                                  _jax(JL.sym_to_full, cm, n=n))
    np.testing.assert_array_equal(_port(TL.sym_diag, cm), _jax(JL.sym_diag, cm))
    d = rng.standard_normal((3, n))
    np.testing.assert_array_equal(_port(TL.set_sym_diag, cm, d),
                                  _jax(JL.set_sym_diag, cm, d))
    with pytest.raises(ValueError):
        TL.sym_to_full(torch.from_numpy(cm), n=n + 1)
    with pytest.raises(ValueError):
        TL.full_to_sym(torch.zeros(2, n, n + 1))


# --- public sym_solve against the reference's XLA path -----------------------


@pytest.mark.parametrize("refine", [0, 1])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 9, 16, 32])
def test_sym_solve_compact_f64(n, refine, rng):
    # batch dims broadcast: mat (1, 4, NN) against vec (3, 1, N)
    cm = _compact(_spd(rng, (1, 4), n))
    v = rng.standard_normal((3, 1, n))
    want = _jax(F.sym_solve, cm, v, refine=refine, backend="xla")
    got = _port(T.sym_solve, cm, v, refine=refine)
    assert got.shape == want.shape == (3, 4, n)
    np.testing.assert_allclose(got, want, rtol=F64_RTOL, atol=1e-12)


@pytest.mark.parametrize("eps", [0.3, (0.1, 0.7), (0.2, 0.5, 1.5, 0.4, 0.9)])
@pytest.mark.parametrize("n", [1, 3, 5, 12])
def test_sym_solve_eps(n, eps, rng):
    # a scalar eps, a short per-channel sequence (its last value repeats)
    # and a per-channel sequence at least n long
    cm = _compact(_spd(rng, (9,), n))
    v = rng.standard_normal((9, n))
    want = _jax(F.sym_solve, cm, v, eps=eps, refine=1, backend="xla")
    got = _port(T.sym_solve, cm, v, eps=eps, refine=1)
    np.testing.assert_allclose(got, want, rtol=F64_RTOL, atol=1e-12)


@pytest.mark.parametrize("n", [1, 4, 6, 16])
def test_sym_solve_f32_normwise(n, rng):
    cm = _compact(_spd(rng, (64,), n)).astype(np.float32)
    v = rng.standard_normal((64, n)).astype(np.float32)
    want = _jax(F.sym_solve, cm, v, refine=1, backend="xla")
    got = _port(T.sym_solve, cm, v)  # default refine: 1 at N <= 4, 0 above
    assert got.dtype == np.float32
    assert _normwise(got.astype(np.float64), want.astype(np.float64)) <= F32_NORMWISE
    exact = np.linalg.solve(np.asarray(_jax(JL.sym_to_full, cm), np.float64),
                            v.astype(np.float64)[..., None])[..., 0]
    assert _normwise(got.astype(np.float64), exact) <= F32_NORMWISE


@pytest.mark.parametrize("n", [1, 3, 6])
def test_sym_solve_elementwise_layouts(n, rng):
    v = rng.standard_normal((2, 5, n))
    # scaled identity (NN == 1) and diagonal (NN == N), with and without eps
    for nn in {1, n}:
        d = rng.uniform(0.5, 2.0, (5, nn))
        for eps in (None, 0.25, (0.1, 0.2)):
            want = _jax(F.sym_solve, d, v, eps=eps, backend="xla")
            got = _port(T.sym_solve, d, v, eps=eps)
            np.testing.assert_allclose(got, want, rtol=F64_RTOL, atol=0)


@pytest.mark.parametrize("op", ["sym_solve", "sym_solve_chain"])
def test_unported_layouts_raise(op, rng):
    """Full storage (a general, non-symmetric matrix) and compact N = 33,
    which the compact kernels do not take, against the reference (both
    solve them densified through batchlmdiv, with no refinement)."""
    kw = {"iters": 2} if op == "sym_solve_chain" else {}
    v = rng.standard_normal((4, 3))
    full = rng.standard_normal((4, 9)) + 3 * np.eye(3).ravel()  # FULL layout
    n = 33
    cm = _compact(_spd(rng, (2,), n))
    for mat, vec in ((full, v), (cm, rng.standard_normal((2, n)))):
        want = _jax(getattr(F, op), mat, vec, eps=0.2, **kw)
        np.testing.assert_allclose(_port(getattr(T, op), mat, vec, eps=0.2, **kw), want,
                                   rtol=F64_RTOL, atol=1e-12)


def test_sym_solve_alias_and_backends(rng):
    cm = torch.from_numpy(_compact(_spd(rng, (8,), 4)))
    v = torch.from_numpy(rng.standard_normal((8, 4)))
    x = T.sym_solve(cm, v)
    assert torch.equal(T.sym_solve_(cm, v), x)
    assert torch.equal(T.sym_solve(cm, v, backend="torch"), x)
    with pytest.raises(ValueError, match="backend"):
        T.sym_solve(cm, v, backend="xla")


# --- sym_solve_chain ---------------------------------------------------------


@pytest.mark.parametrize("iters", [0, 1, 3])
@pytest.mark.parametrize("n", [1, 3, 6, 12])
def test_sym_solve_chain_f64(n, iters, rng):
    cm = _compact(_spd(rng, (6,), n))
    v = rng.standard_normal((6, n))
    c = rng.standard_normal((2, 1, n))  # add broadcasts against the batch
    want = _jax(F.sym_solve_chain, cm, v, iters=iters, add=c, eps=0.1,
                backend="xla")
    got = _port(T.sym_solve_chain, cm, v, iters=iters, add=c, eps=0.1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=F64_RTOL, atol=1e-12)
    if iters:
        want = _jax(F.sym_solve_chain, cm, v, iters=iters, backend="xla")
        got = _port(T.sym_solve_chain, cm, v, iters=iters)
        np.testing.assert_allclose(got, want, rtol=F64_RTOL, atol=1e-12)


def test_sym_solve_chain_elementwise_and_errors(rng):
    d = rng.uniform(0.5, 2.0, (5, 3))
    v = rng.standard_normal((5, 3))
    c = rng.standard_normal((5, 3))
    want = _jax(F.sym_solve_chain, d, v, iters=4, add=c, backend="xla")
    got = _port(T.sym_solve_chain, d, v, iters=4, add=c)
    np.testing.assert_allclose(got, want, rtol=F64_RTOL, atol=0)
    with pytest.raises(ValueError, match="iters"):
        T.sym_solve_chain(torch.from_numpy(d), torch.from_numpy(v), iters=-1)


# --- dtypes ------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4, 6])
def test_bf16_in_bf16_out(n, rng):
    cm = _compact(_spd(rng, (32,), n)).astype(np.float32)
    v = rng.standard_normal((32, n)).astype(np.float32)
    jm = jnp.asarray(cm, jnp.bfloat16)
    jv = jnp.asarray(v, jnp.bfloat16)
    want = np.asarray(F.sym_solve(jm, jv, refine=1, backend="xla").astype(jnp.float32))
    tm = torch.from_numpy(np.array(jm.astype(jnp.float32))).to(torch.bfloat16)
    tv = torch.from_numpy(np.array(jv.astype(jnp.float32))).to(torch.bfloat16)
    got = T.sym_solve(tm, tv, refine=1)
    assert got.dtype == torch.bfloat16
    # both compute in float32 and round once to bf16; the float32 results
    # differ by a few ulp, which can flip one rounding: one bf16 ulp (2^-7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7, atol=0)


def test_dtype_promotion(rng):
    cm = _compact(_spd(rng, (4,), 3))
    v = rng.standard_normal((4, 3))
    # mixed f32 / f64 promotes to f64; bf16 beside f32 computes in f32
    x = T.sym_solve(torch.from_numpy(cm.astype(np.float32)), torch.from_numpy(v))
    assert x.dtype == torch.float64
    x = T.sym_solve(torch.from_numpy(cm.astype(np.float32)),
                    torch.from_numpy(v).to(torch.bfloat16))
    assert x.dtype == torch.float32
    # integers go to torch's default dtype (JAX under x64 gives float64)
    eye = torch.tensor([[2, 2, 2, 0, 0, 0]])
    x = T.sym_solve(eye, torch.tensor([[2, 4, 6]]))
    assert x.dtype == torch.get_default_dtype()
    np.testing.assert_allclose(x.numpy(), [[1.0, 2.0, 3.0]])


# --- the port stands alone; no silent fallback -------------------------------


def test_port_imports_no_jax():
    code = (
        "import sys, torch\n"
        "import fastmath_tpu_torch as T\n"
        "m = torch.tensor([[4.0, 5.0, 1.0]]); v = torch.tensor([[1.0, 2.0]])\n"
        "x = T.sym_solve(m, v); T.sym_solve_chain(m, v, 3, add=v)\n"
        "assert torch.allclose(x, torch.tensor([[3/19, 7/19]]))\n"
        "assert torch.allclose(T.sym_submatvec(v, m, x), torch.zeros(1, 2), atol=1e-6)\n"
        "T.sym_matmul(torch.ones(1, 2, 3), m); T.sym_outer(v)\n"
        "a = torch.tensor([[[4.0, 1.0], [2.0, 3.0]]])\n"
        "T.batchinv(a); T.batchrmdiv(a, a); T.batchlmdiv(a, v, backend='torch')\n"
        "T.sym_solve(a.reshape(1, 4), v); T.sym_solve(torch.eye(33).reshape(1, -1), torch.ones(1, 33))\n"
        "T.kernels.solve_full_cf(a.reshape(1, 4).t(), v.t()); T.kernels.inv_cf(a.reshape(1, 4).t())\n"
        "T.sym_matvec_chain(0.1 * m, v, 3, add=v); mu, e = T.sym_maxeig(m, return_vector=True)\n"
        "assert torch.allclose(T.sym_to_full(T.full_to_sym(a @ a.mT)), a @ a.mT)\n"
        "T.sym_diag(m); T.batchmatmul(a, a, backend='torch'); T.batchmatvec(a, v)\n"
        "T.kernels.matmul_cf(a.reshape(1, 4).t(), a.reshape(1, 4).t(), 2, 2)\n"
        "T.kernels.matvec_full_cf(a.reshape(1, 4).t(), v.t())\n"
        "T.kernels.sym_matvec_chain_cf(m.t(), v.t(), 2); T.kernels.sym_maxeig_cf(m.t(), v.t())\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'fastmath_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=pathlib.Path(__file__).resolve().parents[1])


def test_forced_cuda_on_cpu_raises(rng):
    cm = torch.from_numpy(_compact(_spd(rng, (4,), 3)))
    v = torch.from_numpy(rng.standard_normal((4, 3)))
    with pytest.raises(ValueError, match="CUDA"):
        T.sym_solve(cm, v, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        T.sym_solve_chain(cm, v, iters=5, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        T.sym_solve_chain(cm, v, iters=1, backend="cuda")
    # outside the kernel's domain: diagonal storage, complex values
    with pytest.raises(ValueError, match="kernel serves"):
        T.sym_solve(v, v, backend="cuda")
    with pytest.raises(ValueError, match="kernel serves"):
        T.sym_solve(cm.to(torch.complex128), v.to(torch.complex128),
                    backend="cuda")
