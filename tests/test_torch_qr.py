"""The port's ``ops/qr.py`` against ``fastmath_tpu.ops.qr`` (JAX, CPU).

The same arrays, made with numpy from a seed, go through both packages.

* Householder, Hessenberg, Givens and QR/RQ of Hessenberg matrices, float64
  real and complex: 1e-12 elementwise (the same arithmetic in the same
  order).
* ``eig_sym`` on every route: the closed forms (n = 1..3, against the
  reference's ``backend="analytic"``, which its ``"auto"`` takes), the
  kernel's plain version (real 4 <= n <= 32, against the reference's XLA
  path, which its ``"auto"`` takes on the CPU; the reference's cyclic
  XLA Jacobi compiles slowly, so n stays at 9 or below for it, and its
  rolled tier serves 17..32), complex Hermitian input and n = 40 (the
  same plain Jacobi, against the reference's XLA path). Eigenvalues come out unsorted, and
  eigenvectors up to sign, so the checks compare sorted eigenvalues and
  the reconstruction U diag(w) Uᴴ: 1e-10 ||A||_F in float64, 1e-5 in
  float32 with the default polish.
* Gradients against ``jax.grad`` of the same loss, invariant under the
  eigenpairs' order and signs (sum cos(w_i) (u_iᵀ g)² + sum w_i³),
  float64, 1e-8 relative.
* bf16 input computes in float32 and rounds once.
"""
import inspect
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmath_tpu.ops import qr as J
from fastmath_tpu.ops import sugar as JS

import fastmath_tpu_torch as T
from fastmath_tpu_torch.ops import qr as Q
from fastmath_tpu_torch.ops import sugar as S

from _torch_cpu import one_thread  # noqa: F401  (autouse)

TOL = 1e-12
EIG_TOL = 1e-10


def _r(rng, *shape, cplx=False):
    x = rng.standard_normal(shape)
    return x + 1j * rng.standard_normal(shape) if cplx else x


def _herm(rng, b, n, cplx=False):
    a = _r(rng, b, n, n, cplx=cplx)
    return a + np.conj(np.swapaxes(a, -1, -2))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.resolve_conj().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _recon(w, u):
    return np.einsum("...ij,...j,...kj->...ik", u, w, np.conj(u))


def _eig_close(w, u, a, w_ref, tol):
    """Sorted eigenvalues against ``w_ref`` and U diag(w) Uᴴ against ``a``,
    over ||A||_F of each problem."""
    fro = np.linalg.norm(a, axis=(-2, -1))
    dw = np.abs(np.sort(_np(w), -1) - np.sort(_np(w_ref), -1)).max(axis=-1) / fro
    assert dw.max() <= tol, dw.max()
    if u is not None:
        dr = np.linalg.norm(_recon(_np(w), _np(u)) - a, axis=(-2, -1)) / fro
        assert dr.max() <= tol, dr.max()


# ---------------------------------------------------------------------------
# Householder, Hessenberg, Givens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cplx", [False, True])
def test_householder(cplx, rng):
    x = _r(rng, 4, 6, cplx=cplx)
    x[0] = 0  # the null vector gives u = 0
    for basis in (0, 2):
        u, alpha = Q.householder(_t(x), basis=basis, return_alpha=True)
        uj, alphaj = J.householder(jnp.asarray(x), basis=basis, return_alpha=True)
        _same(u, uj)
        _same(alpha, alphaj)
    _same(Q.householder(_t(x)), J.householder(jnp.asarray(x)))


@pytest.mark.parametrize("cplx", [False, True])
def test_householder_apply(cplx, rng):
    n = 5
    a = _r(rng, 3, n, n, cplx=cplx)
    us = _r(rng, 3, 3, n, cplx=cplx)
    us /= np.linalg.norm(us, axis=-1, keepdims=True)
    short = _r(rng, 3, n - 2, cplx=cplx)
    short /= np.linalg.norm(short, axis=-1, keepdims=True)
    for side in ("both", "left", "right"):
        for inverse in (False, True):
            for k in (None, 1, [0, 1], range(3)):
                _same(Q.householder_apply(_t(a), _t(us), k=k, side=side, inverse=inverse),
                      J.householder_apply(jnp.asarray(a), jnp.asarray(us), k=k, side=side,
                                          inverse=inverse))
    as_list = [_t(us[:, 0]), _t(short)]
    _same(Q.householder_apply(_t(a), as_list),
          J.householder_apply(jnp.asarray(a), [jnp.asarray(us[:, 0]), jnp.asarray(short)]))
    _same(Q.householder_apply(_t(a), _t(short)),
          J.householder_apply(jnp.asarray(a), jnp.asarray(short)))


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("n", [2, 3, 6])
def test_hessenberg(n, cplx, rng):
    a = _r(rng, 3, n, n, cplx=cplx)
    h, u = Q.hessenberg(_t(a), compute_u=True)
    hj, uj = J.hessenberg(jnp.asarray(a), compute_u=True)
    _same(h, hj)
    _same(u, uj)
    _same(Q.hessenberg(_t(a)), hj)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("upper", [True, False])
def test_hessenberg_sym(upper, cplx, rng):
    a = _r(rng, 3, 5, 5, cplx=cplx)
    for fill in (True, False):
        h, u = Q.hessenberg_sym(_t(a), upper=upper, fill=fill, compute_u=True)
        hj, uj = J.hessenberg_sym(jnp.asarray(a), upper=upper, fill=fill, compute_u=True)
        _same(h, hj)
        _same(u, uj)


def test_givens(rng):
    x, y = _r(rng, 6), _r(rng, 6)
    x[0] = y[0] = 0
    for got, want in zip(Q.givens(_t(x), _t(y)), J.givens(jnp.asarray(x), jnp.asarray(y))):
        _same(got, want)
    a = _r(rng, 6, 4, 4)
    c, s = J.givens(jnp.asarray(x), jnp.asarray(y))
    c, s = np.asarray(c), np.asarray(s)
    for side in ("both", "left", "right"):
        for i, j in ((0, None), (1, 3)):
            _same(Q.givens_apply(_t(a), _t(c), _t(s), i, j, side=side),
                  J.givens_apply(jnp.asarray(a), jnp.asarray(c), jnp.asarray(s), i, j,
                                 side=side))


@pytest.mark.parametrize("n", [2, 5])
def test_qr_rq_hessenberg(n, rng):
    h = np.triu(_r(rng, 3, n, n), -1)
    q, r = Q.qr_hessenberg(_t(h))
    qj, rj = J.qr_hessenberg(jnp.asarray(h))
    _same(q, qj)
    _same(r, rj)
    u = _r(rng, 3, 4, n)
    r2, u2 = Q.rq_hessenberg(_t(h), _t(u))
    r2j, u2j = J.rq_hessenberg(jnp.asarray(h), jnp.asarray(u))
    _same(r2, r2j)
    _same(u2, u2j)
    _same(Q.rq_hessenberg(_t(h)), r2j)


def test_check_finite():
    a = torch.eye(3, dtype=torch.float64)
    a[0, 1] = float("nan")
    for fn in (Q.hessenberg, Q.eig_sym, lambda x: Q.qr_hessenberg(x)):
        with pytest.raises(ValueError):
            fn(a)
    with pytest.raises(ValueError):
        Q.hessenberg(torch.zeros(2, 3))
    Q.eig_sym(a.nan_to_num(), check_finite=False)


# ---------------------------------------------------------------------------
# eig_sym
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3])
def test_eig_analytic(n, rng):
    a = _herm(rng, 50, n)
    a[0] = np.eye(n)  # a degenerate spectrum
    w, u = T.eig_sym(_t(a), compute_u=True)
    wj, uj = J.eig_sym(jnp.asarray(a), compute_u=True, backend="analytic")
    _same(w, wj, 1e-12)
    _eig_close(w, u, a, wj, EIG_TOL)
    _same(T.eig_sym(_t(a), backend="analytic"), wj, 1e-12)


@pytest.mark.parametrize("n", [4, 8, 9, 17, 24, 32])
def test_eig_kernel_tier(n, rng):
    """The kernel's plain version (what "auto" and "torch" run on the CPU
    for real n <= 32) against the reference's XLA path."""
    a = _herm(rng, 6 if n > 12 else 16, n)
    fn = jax.jit(lambda x: J.eig_sym(x, compute_u=True, backend="xla"))
    wj, _ = fn(jnp.asarray(a))
    w, u = T.eig_sym(_t(a), compute_u=True)
    _eig_close(w, u, a, wj, EIG_TOL)
    wt = T.eig_sym(_t(a), backend="torch")
    np.testing.assert_array_equal(_np(wt), _np(w))


@pytest.mark.parametrize("n", [3, 5, 17])
def test_eig_complex_hermitian(n, rng):
    a = _herm(rng, 6, n, cplx=True)
    w, u = T.eig_sym(_t(a), compute_u=True)
    wj, _ = jax.jit(lambda x: J.eig_sym(x, compute_u=True, backend="xla"))(jnp.asarray(a))
    assert not w.is_complex()
    _eig_close(w, u, a, wj, EIG_TOL)
    _eig_close(w, None, a, np.linalg.eigvalsh(a), EIG_TOL)


def test_eig_xla_tier_n40(rng):
    """n > 32: the plain Jacobi (round-robin, at most 30 sweeps) against
    the reference's XLA path and float64 numpy. Its exit test
    sums the off-diagonal squares alone, so every problem converges (the
    reference's difference of two sums stops some early: ROADMAP, faults
    of the reference)."""
    a = _herm(rng, 4, 40)
    w, u = T.eig_sym(_t(a), compute_u=True)
    wj = jax.jit(lambda x: J.eig_sym(x, backend="xla"))(jnp.asarray(a))
    _eig_close(w, None, a, wj, EIG_TOL)
    _eig_close(w, u, a, np.linalg.eigvalsh(a), EIG_TOL)


@pytest.mark.parametrize("n", [3, 5, 12])
def test_eig_upper_lower(n, rng):
    """One triangle is trusted; the other may hold anything."""
    a = _r(rng, 5, n, n)
    for upper in (True, False):
        sym = np.triu(a) + np.triu(a, 1).swapaxes(-1, -2) if upper else \
            np.tril(a) + np.tril(a, -1).swapaxes(-1, -2)
        w, u = T.eig_sym(_t(a), compute_u=True, upper=upper)
        _eig_close(w, u, sym, np.linalg.eigvalsh(sym), EIG_TOL)


@pytest.mark.parametrize("n", [4, 12, 20])
def test_eig_float32_polish(n, rng):
    """float32 with vectors: the default polish brings U diag(w) Uᵀ within
    1e-5 ||A||_F and Uᵀ U within 1e-5 of I (against float64 numpy)."""
    a = _herm(rng, 64, n).astype(np.float32)
    w, u = T.eig_sym(_t(a), compute_u=True)
    assert w.dtype == u.dtype == torch.float32
    a64 = a.astype(np.float64)
    _eig_close(w.double(), u.double(), a64, np.linalg.eigvalsh(a64), 1e-5)
    u64 = _np(u).astype(np.float64)
    gram = np.einsum("bji,bjk->bik", u64, u64)
    assert np.abs(gram - np.eye(n)).max() <= 1e-5
    if n == 4:  # the reference's polish on its XLA path, float32
        wj, uj = J.eig_sym(jnp.asarray(a), compute_u=True, backend="xla")
        _eig_close(w.double(), None, a64, np.asarray(wj, np.float64), 1e-6)


def _loss_np_g(rng, n):
    return rng.standard_normal(n)


def _loss(w, u, g, lib):
    proj = (u * g[:, None]).sum(-2)  # u_i^T g
    return (lib.cos(w) * proj ** 2).sum() + (w ** 3).sum()


@pytest.mark.parametrize("n", [1, 2, 3, 4, 17, 34])
def test_eig_grad(n, rng):
    """Reverse mode through every real route (closed forms, the kernel's
    plain version at n <= 32 and above) against jax.grad."""
    a = _herm(rng, 3, n)
    g = rng.standard_normal(n)
    x = _t(a).requires_grad_()
    w, u = T.eig_sym(x, compute_u=True)
    (gt,) = torch.autograd.grad(_loss(w, u, _t(g), torch), x)
    gj = jax.jit(jax.grad(lambda y: _loss(*J.eig_sym(y, compute_u=True), jnp.asarray(g), jnp)))(
        jnp.asarray(a))
    gj = np.asarray(gj)
    assert np.linalg.norm(_np(gt) - gj) <= 1e-8 * np.linalg.norm(gj)
    if n > 4:
        return
    # eigenvalues alone (the forward computes the vectors for the backward)
    x = _t(a).requires_grad_()
    (gw,) = torch.autograd.grad((T.eig_sym(x) ** 3).sum(), x)
    gwj = np.asarray(jax.grad(lambda y: (J.eig_sym(y) ** 3).sum())(jnp.asarray(a)))
    assert np.linalg.norm(_np(gw) - gwj) <= 1e-8 * np.linalg.norm(gwj)


def test_eig_grad_lower_triangle(rng):
    """The gradient lands on the triangle that was read."""
    a = _r(rng, 2, 4, 4)
    x = _t(a).requires_grad_()
    (gt,) = torch.autograd.grad((T.eig_sym(x, upper=False) ** 2).sum(), x)
    gj = jax.grad(lambda y: (J.eig_sym(y, upper=False) ** 2).sum())(jnp.asarray(a))
    _same(gt, gj, 1e-8)
    assert np.all(np.triu(_np(gt), 1) == 0)


def test_eig_bf16(rng):
    a = _herm(rng, 8, 5).astype(np.float32)
    x = _t(a).to(torch.bfloat16)
    w, u = T.eig_sym(x, compute_u=True)
    assert w.dtype == u.dtype == torch.bfloat16
    w32, u32 = T.eig_sym(x.float(), compute_u=True)
    np.testing.assert_array_equal(_np(w.float()), _np(w32.to(torch.bfloat16).float()))
    np.testing.assert_array_equal(_np(u.float()), _np(u32.to(torch.bfloat16).float()))


def test_eig_backends(rng):
    a = _t(_herm(rng, 2, 4))
    with pytest.raises(ValueError):
        T.eig_sym(a, backend="analytic")
    with pytest.raises(ValueError):
        T.eig_sym(_t(_herm(rng, 2, 3, cplx=True)), backend="analytic")
    with pytest.raises(ValueError):
        T.eig_sym(a, backend="cuda")  # the kernel needs a CUDA tensor
    with pytest.raises(ValueError):
        T.eig_sym(a, backend="pallas")
    # "torch" on n <= 3 runs the kernel's plain version, not the closed form
    b = _herm(rng, 5, 3)
    _eig_close(T.eig_sym(_t(b), backend="torch"), None, b, np.linalg.eigvalsh(b), EIG_TOL)


def test_import_loads_no_jax():
    code = ("import sys, torch, fastmath_tpu_torch as T\n"
            "a = torch.eye(5, dtype=torch.float64)\n"
            "T.eig_sym(a, compute_u=True); T.lmdiv(a, a); T.hessenberg(a)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'fastmath_tpu' or m.startswith('fastmath_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=pathlib.Path(__file__).resolve().parents[1])


@pytest.mark.parametrize("module", ["qr", "sugar"])
def test_public_names_and_signatures(module):
    """Every public name of the reference's module, with the same
    parameters and defaults, in the port's module, ``ops`` and the top
    level."""
    ref, port = (J, Q) if module == "qr" else (JS, S)
    assert set(port.__all__) == set(ref.__all__)
    import fastmath_tpu_torch.ops as ops

    for name in ref.__all__:
        fn = getattr(port, name)
        assert getattr(T, name) is fn and getattr(ops, name) is fn and name in T.__all__
        want = [(p.name, p.default) for p in inspect.signature(getattr(ref, name)).parameters.values()]
        got = [(p.name, p.default) for p in inspect.signature(fn).parameters.values()]
        assert got == want, name
