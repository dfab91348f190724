"""The port's ``ops/special.py`` against ``fastmath_tpu.ops.special`` (JAX,
CPU, x64).

The same float64 inputs go through both packages. Tolerances (relative,
elementwise): 1e-10 for ``besseli`` (the series sums up to 50 terms of
exp) and its gradient, 1e-12 for everything else. ``besseli`` runs at
nu = 0, 1 (``i0e`` / ``i1e``), 3.7 (series below z = 2 thr = 48.45,
asymptotic expansion above) and 20 (asymptotic expansion only, its two
stabilizations split at z = 2 nu = 40), in all three modes, on both sides
of each split.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmath_tpu.ops import special as J

from fastmath_tpu_torch.ops import special as S

from _torch_cpu import one_thread  # noqa: F401  (autouse)

TOL = 1e-12
TOL_BESSEL = 1e-10
Z = np.array([0.05, 0.5, 2.0, 7.0, 7.8, 15.0, 39.5, 40.5, 48.0, 48.9, 100.0, 300.0])


def _close(got, want, tol=TOL):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=tol, atol=0)


@pytest.mark.parametrize("mode", [None, "norm", "log"])
@pytest.mark.parametrize("nu", [0, 1, 3.7, 20.0])
def test_besseli(nu, mode):
    want = jax.jit(lambda z: J.besseli(nu, z, mode=mode))(jnp.asarray(Z))
    _close(S.besseli(nu, torch.tensor(Z), mode=mode), want, TOL_BESSEL)
    # the gradient in z, double-where guarded: finite on both sides
    gwant = jax.grad(lambda z: jnp.sum(J.besseli(nu, z, mode=mode)))(jnp.asarray(Z))
    zt = torch.tensor(Z, requires_grad=True)
    S.besseli(nu, zt, mode=mode).sum().backward()
    assert torch.isfinite(zt.grad).all()
    _close(zt.grad, gwant, TOL_BESSEL)


def test_besseli_modes_by_code():
    # mode 0 / 1 / 2 are None / "norm" / "log"
    z = torch.tensor(Z[:6])
    for code, mode in ((0, None), (1, "norm"), (2, "log")):
        torch.testing.assert_close(S.besseli(3.7, z, mode=code), S.besseli(3.7, z, mode=mode),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("nu", [0.0, 2.5, 10.0])
def test_besseli_ratio(nu):
    x = np.linspace(0.1, 50, 12)
    _close(S.besseli_ratio(nu, torch.tensor(x)), J.besseli_ratio(nu, jnp.asarray(x)))


def test_mvdigamma_digamma_erfinv():
    x = np.linspace(2.1, 20, 9)
    for order in (1, 2, 3):
        _close(S.mvdigamma(torch.tensor(x), order=order), J.mvdigamma(jnp.asarray(x), order=order))
    _close(S.digamma(torch.tensor(x)), J.digamma(jnp.asarray(x)))
    p = np.linspace(-0.99, 0.99, 9)
    _close(S.erfinv(torch.tensor(p)), J.erfinv(jnp.asarray(p)))


@pytest.mark.parametrize("name", ["gammainc", "gammaincc"])
def test_gammainc(name):
    a = np.array([0.5, 1.0, 2.5, 7.0])[:, None]
    x = np.array([0.01, 0.7, 3.0, 12.0, 40.0])
    _close(getattr(S, name)(torch.tensor(a), torch.tensor(x)),
           getattr(J, name)(jnp.asarray(a), jnp.asarray(x)))
    # the gradient in x (summed over the broadcast a)
    gwant = jax.grad(lambda t: jnp.sum(getattr(J, name)(jnp.asarray(a), t)))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    getattr(S, name)(torch.tensor(a), xt).sum().backward()
    _close(xt.grad, gwant)
    # none in a: PyTorch has no derivative there, and says so
    at = torch.tensor(a, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no derivative in a"):
        getattr(S, name)(at, torch.tensor(x)).sum().backward()


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_half_types_compute_in_float32(dtype):
    x = torch.linspace(0.05, 9.0, 16).to(dtype)
    for f, arg in ((lambda t: S.besseli(0, t), x), (lambda t: S.besseli(3.5, t, mode="log"), x),
                   (S.erfinv, x / 10), (lambda t: S.mvdigamma(t, 2), x + 2),
                   (lambda t: S.besseli_ratio(1.0, t), x), (lambda t: S.gammainc(2.0, t), x)):
        got = f(arg)
        assert got.dtype == dtype
        torch.testing.assert_close(got, f(arg.float()).to(dtype), rtol=0, atol=0)
