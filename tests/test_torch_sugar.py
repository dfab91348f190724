"""The port's ``ops/sugar.py`` against ``fastmath_tpu.ops.sugar`` (JAX, CPU).

Every public name, in float64, on real and complex input: the same
arrays, made with numpy from a seed, go through both packages. Tolerance:
normwise per problem (over the last two axes, or the last axis for
vectors) 1e-12 against the reference, 1e-10 for the SVD and
pseudoinverse methods (the two libraries' SVDs round differently and the
solutions divide by the singular values). Matrices are well conditioned:
``a + n I`` for LU/SVD/pseudoinverse, ``a aᴴ + n I`` for Cholesky.

``lu`` with n <= 16 runs the port's ``batchlmdiv``/``batchinv`` and
``chol`` with n <= 16 on real input its ``_chol_solve_unrolled`` (the
kernels' plain versions on the CPU); n = 18 takes ``torch.linalg``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmath_tpu.ops import sugar as J

from fastmath_tpu_torch.ops import sugar as S

from _torch_cpu import one_thread  # noqa: F401  (autouse)

TOL = 1e-12
TOL_SVD = 1e-10


def _r(rng, *shape, cplx=False):
    x = rng.standard_normal(shape)
    return x + 1j * rng.standard_normal(shape) if cplx else x


def _close(got, want, tol=TOL, axes=2):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape,
                                                                 got.dtype, want.dtype)
    if axes:
        ax = tuple(range(-axes, 0))
        err = np.linalg.norm(got - want, axis=ax) / np.linalg.norm(want, axis=ax)
    else:
        err = np.abs(got - want) / np.abs(want)
    assert err.max() <= tol, err.max()


def _well(rng, b, n, cplx, spd=False):
    a = _r(rng, b, n, n, cplx=cplx)
    if spd:
        return a @ np.conj(np.swapaxes(a, -1, -2)) + n * np.eye(n)
    return a + 2 * np.sqrt(n) * np.eye(n)


METHODS = ["lu", "chol", "svd", "pinv"]


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("n", [3, 6, 18])
@pytest.mark.parametrize("method", METHODS)
def test_lmdiv_and_inv(method, n, cplx, rng):
    a = _well(rng, 5, n, cplx, spd=method == "chol")
    b = _r(rng, 5, n, 2, cplx=cplx)
    tol = TOL_SVD if method in ("svd", "pinv") else TOL
    _close(S.lmdiv(torch.tensor(a), torch.tensor(b), method=method),
           J.lmdiv(jnp.asarray(a), jnp.asarray(b), method=method), tol)
    _close(S.inv(torch.tensor(a), method=method), J.inv(jnp.asarray(a), method=method), tol)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("method", METHODS)
def test_rmdiv_and_solvevec(method, cplx, rng):
    n = 5
    a = _well(rng, 4, n, cplx, spd=method == "chol")
    b = _r(rng, 4, 3, n, cplx=cplx)
    v = _r(rng, 4, n, cplx=cplx)
    tol = TOL_SVD if method in ("svd", "pinv") else TOL
    _close(S.rmdiv(torch.tensor(b), torch.tensor(a), method=method),
           J.rmdiv(jnp.asarray(b), jnp.asarray(a), method=method), tol)
    _close(S.solvevec(torch.tensor(a), torch.tensor(v), method=method),
           J.solvevec(jnp.asarray(a), jnp.asarray(v), method=method), tol, axes=1)


@pytest.mark.parametrize("cplx", [False, True])
def test_nonsquare_takes_pinv(cplx, rng):
    a = _r(rng, 3, 6, 4, cplx=cplx)
    b = _r(rng, 3, 6, 2, cplx=cplx)
    _close(S.lmdiv(torch.tensor(a), torch.tensor(b), method="lu", rcond=1e-12),
           J.lmdiv(jnp.asarray(a), jnp.asarray(b), rcond=1e-12), TOL_SVD)
    _close(S.inv(torch.tensor(a), method="chol"), J.inv(jnp.asarray(a), method="chol"),
           TOL_SVD)


def test_broadcast_and_vector_rhs(rng):
    """One shared matrix against a batch of right-hand sides; a vector
    right-hand side (one dim fewer than the matrix) as in batchlmdiv."""
    a = _well(rng, 1, 4, False)[0]
    b = _r(rng, 7, 4, 3)
    _close(S.lmdiv(torch.tensor(a), torch.tensor(b)), J.lmdiv(jnp.asarray(a), jnp.asarray(b)))
    a = _well(rng, 6, 4, False)
    v = _r(rng, 6, 4)
    _close(S.lmdiv(torch.tensor(a), torch.tensor(v)), J.lmdiv(jnp.asarray(a), jnp.asarray(v)),
           axes=1)


def test_unknown_method(rng):
    a = torch.tensor(_well(rng, 2, 3, False))
    with pytest.raises(ValueError):
        S.lmdiv(a, a, method="qr")
    with pytest.raises(ValueError):
        S.inv(a, method="qr")


@pytest.mark.parametrize("cplx", [False, True])
def test_products(cplx, rng):
    """kron2, matvec, outer (conjugates the second operand), trace, dot and
    mdot (conjugate the first), with and without keepdim."""
    a = _r(rng, 3, 2, 3, cplx=cplx)
    b = _r(rng, 3, 4, 2, cplx=cplx)
    _close(S.kron2(torch.tensor(a), torch.tensor(b)), J.kron2(jnp.asarray(a), jnp.asarray(b)))
    m = _r(rng, 3, 5, 4, cplx=cplx)
    x = _r(rng, 3, 4, cplx=cplx)
    y = _r(rng, 3, 4, cplx=cplx)
    _close(S.matvec(torch.tensor(m), torch.tensor(x)), J.matvec(jnp.asarray(m), jnp.asarray(x)),
           axes=1)
    _close(S.outer(torch.tensor(x), torch.tensor(y)), J.outer(jnp.asarray(x), jnp.asarray(y)))
    sq = _r(rng, 3, 4, 4, cplx=cplx)
    for keep in (False, True):
        _close(S.trace(torch.tensor(sq), keepdim=keep), J.trace(jnp.asarray(sq), keepdim=keep),
               axes=0)
        _close(S.dot(torch.tensor(x), torch.tensor(y), keepdim=keep),
               J.dot(jnp.asarray(x), jnp.asarray(y), keepdim=keep), axes=0)
        _close(S.mdot(torch.tensor(m), torch.tensor(m[::-1].copy()), keepdim=keep),
               J.mdot(jnp.asarray(m), jnp.asarray(m[::-1].copy()), keepdim=keep), axes=0)
    if cplx:  # antilinear in the first argument
        d = S.dot(torch.tensor(x), torch.tensor(y)).numpy()
        np.testing.assert_allclose(d, np.sum(np.conj(x) * y, -1), rtol=1e-14)


def test_is_orthonormal_and_round(rng):
    q, _ = np.linalg.qr(rng.standard_normal((6, 6)))
    basis = q.T.reshape(6, 2, 3)
    for b in (basis, basis * 1.01):
        ok, gram = S.is_orthonormal(torch.tensor(b), return_matrix=True)
        ok_j, gram_j = J.is_orthonormal(jnp.asarray(b), return_matrix=True)
        assert ok == ok_j and isinstance(ok, bool)
        _close(gram, gram_j)
        assert S.is_orthonormal(torch.tensor(b)) == ok
    t = rng.standard_normal((4, 5)) * 100
    t[0, :3] = [0.5, 1.5, 2.5]  # half to even, as jnp.round
    for dec in (0, 1, 2, -1):
        np.testing.assert_array_equal(S.round(torch.tensor(t), dec).numpy(),
                                      np.asarray(J.round(jnp.asarray(t), dec)))


def test_aliases_and_out(rng):
    a = _well(rng, 3, 4, False, spd=True)
    b = _r(rng, 3, 4, 2)
    _close(S.solve(torch.tensor(a), torch.tensor(b)), J.solve(jnp.asarray(a), jnp.asarray(b)))
    _close(S.pinv(torch.tensor(a)), J.pinv(jnp.asarray(a)), TOL_SVD)
    _close(S.cholesky(torch.tensor(a)), J.cholesky(jnp.asarray(a)))
    assert "solve" not in S.__all__ and sorted(S.__all__) == sorted(J.__all__)
    out = torch.empty(3, 4, 2)  # accepted and ignored, as in the JAX package
    _close(S.lmdiv(torch.tensor(a), torch.tensor(b), out=out), J.lmdiv(jnp.asarray(a),
                                                                       jnp.asarray(b)))
