"""The port's ``ops/simplex.py`` against ``fastmath_tpu.ops.simplex`` (JAX,
CPU, x64).

The same float64 logits go through both packages, in all four implicit
combinations ``(in, out)``, at two dims and three implicit indices.
Values and gradients (the port's ``autograd.Function`` backwards against
``jax.grad`` of the reference's ``custom_vjp``s) agree at rtol 1e-12, atol
1e-15 (for entries that cancel to about 1e-17, as the gradient through an
inserted ``1 - sum`` class can); ``softmax_lse``'s float64 total likewise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmath_tpu.ops import simplex as J

from fastmath_tpu_torch.ops import simplex as S

from _torch_cpu import one_thread  # noqa: F401  (autouse)

TOL = 1e-12
ATOL = 1e-15  # entries that cancel to zero (the gradient through 1 - sum)
IMPLICIT = [False, True, (True, False), (False, True)]


def _close(got, want):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=ATOL)


def _value_and_grad(jfn, tfn, x, w):
    """Both packages' outputs and the gradients of sum(out * w)."""
    want, vjp = jax.vjp(jfn, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = tfn(xt)
    (got * torch.tensor(w)).sum().backward()
    return got, want, xt.grad, vjp(jnp.asarray(w))[0]


@pytest.mark.parametrize("dim", [-1, 1])
@pytest.mark.parametrize("implicit", [False, True])
def test_logsumexp(implicit, dim, rng):
    x = 3 * rng.standard_normal((3, 5, 4))
    for keepdim in (False, True):
        w = rng.standard_normal(J.logsumexp(jnp.asarray(x), dim, keepdim, implicit).shape)
        got, want, g, gw = _value_and_grad(lambda t: J.logsumexp(t, dim, keepdim, implicit),
                                           lambda t: S.logsumexp(t, dim, keepdim, implicit), x, w)
        _close(got, want)
        _close(g, gw)


@pytest.mark.parametrize("index", [0, 2, -1])
@pytest.mark.parametrize("implicit", IMPLICIT, ids=str)
@pytest.mark.parametrize("name", ["softmax", "log_softmax"])
def test_softmax_and_log_softmax(name, implicit, index, rng):
    x = 3 * rng.standard_normal((3, 5, 4))
    for dim in (-1, 1):
        kw = dict(dim=dim, implicit=implicit, implicit_index=index)
        w = rng.standard_normal(getattr(J, name)(jnp.asarray(x), **kw).shape)
        got, want, g, gw = _value_and_grad(lambda t: getattr(J, name)(t, **kw),
                                           lambda t: getattr(S, name)(t, **kw), x, w)
        _close(got, want)
        _close(g, gw)


@pytest.mark.parametrize("index", [0, 2, -1])
@pytest.mark.parametrize("implicit", IMPLICIT, ids=str)
def test_logit(implicit, index, rng):
    e = np.exp(rng.standard_normal((6, 6)))
    p = e / e.sum(-1, keepdims=True)
    if implicit is True or implicit == (True, False):
        p = p[:, 1:]  # the hidden class's probability is 1 - sum
        p[0] *= 0.5 / p[0].sum()  # hidden probability 1/2
        p[1] /= p[1].sum()  # hidden probability 0: the 1e-8 clamp
    for dim in (-1, 0):
        kw = dict(dim=dim, implicit=implicit, implicit_index=index)
        w = rng.standard_normal(J.logit(jnp.asarray(p), **kw).shape)
        got, want, g, gw = _value_and_grad(lambda t: J.logit(t, **kw),
                                           lambda t: S.logit(t, **kw), p, w)
        _close(got, want)
        _close(g, gw)


@pytest.mark.parametrize("implicit", IMPLICIT, ids=str)
def test_softmax_lse(implicit, rng):
    x = 3 * rng.standard_normal((4, 6, 5))
    weights = rng.random((4, 6, 1))
    for dim, wts in ((-1, None), (-1, weights), (1, None)):
        p, lse = S.softmax_lse(torch.tensor(x), dim, None if wts is None else torch.tensor(wts),
                               implicit)
        pw, lsew = J.softmax_lse(jnp.asarray(x), dim, None if wts is None else jnp.asarray(wts),
                                 implicit)
        _close(p, pw)
        assert lse.dtype == torch.float64 and lse.shape == ()
        _close(lse, lsew)


def test_implicit_index_out_of_range(rng):
    x = torch.tensor(rng.standard_normal((2, 3)))
    with pytest.raises(ValueError, match="out of range"):
        S.softmax(x, implicit=(True, False), implicit_index=4)
