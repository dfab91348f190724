"""The port's full-storage products (``batchmatvec``, ``batchmatmul`` with
its ``backend`` and the kernels' wrappers ``matvec_full_cf``,
``matmul_cf``), ``batchchol``'s triangle rule and the public names added
beside them, against ``fastmath_tpu`` (JAX, CPU).

On the CPU every kernel wrapper runs its plain PyTorch version. The
wrappers are held against the reference's Pallas kernels run in
interpret mode; the public ops against the reference on every backend
that it has (``auto``, ``xla``, ``pallas``); gradients against
``jax.grad``. ``batchchol`` reads the lower triangle for n <= 16 and the
average of the two triangles above, as the reference does: it is held
there on asymmetric input, forward and raw gradient (whose upper
triangle is exactly 0 for n <= 16). Tolerance: float64, normwise per
problem, 1e-12 (the same sums in the same or another order).

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_iterate_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastmath_tpu as FT
from fastmath_tpu.kernels.batched_pallas import matmul_cf as pallas_matmul_cf
from fastmath_tpu.kernels.batched_pallas import matvec_full_cf as pallas_matvec_full_cf
from fastmath_tpu.ops import batched as F
from fastmath_tpu.ops.batched import _chol_solve_unrolled as ref_chol_solve

import fastmath_tpu_torch as T
from fastmath_tpu_torch import kernels as K
from fastmath_tpu_torch.ops.batched import _chol_solve_unrolled

from _torch_cpu import one_thread  # noqa: F401  (autouse)

TOL = 1e-12
BLOCK = 128  # interpret-mode block of the Pallas kernels


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    got, want = got.reshape(*got.shape[:-2], -1), want.reshape(*want.shape[:-2], -1)
    err = np.linalg.norm(got - want, axis=-1)
    scale = np.maximum(np.linalg.norm(want, axis=-1), 1e-300)
    assert (err <= tol * scale).all(), (err / scale).max()


# --- matvec --------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 8, 12])
def test_matvec_full_cf_matches_pallas(n, rng):
    mat = rng.standard_normal((n * n, 1, 6))
    vec = rng.standard_normal((n, 4, 1))
    want = np.asarray(pallas_matvec_full_cf(jnp.asarray(mat), jnp.asarray(vec), block=BLOCK))
    got = K.matvec_full_cf(_t(mat), _t(vec))
    assert got.shape == (n, 4, 6)
    _close(np.moveaxis(_np(got), 0, -1)[..., None], np.moveaxis(want, 0, -1)[..., None])


@pytest.mark.parametrize("shape", [(2, 2), (4, 4), (5, 5), (9, 9), (3, 5), (6, 2)])
def test_batchmatvec_matches_reference(shape, rng):
    m, n = shape
    mat, vec = rng.standard_normal((2, 3, m, n)), rng.standard_normal((3, n))
    want = np.asarray(F.batchmatvec(jnp.asarray(mat), jnp.asarray(vec)))
    got = _np(T.batchmatvec(_t(mat), _t(vec)))
    _close(got[..., None], want[..., None])


def test_matvec_grads_match_jax(rng):
    n = 4
    mat, vec, w = (rng.standard_normal(s) for s in ((n * n, 7), (n, 7), (n, 7)))
    want = jax.grad(lambda m, v: jnp.sum(pallas_matvec_full_cf(m, v, block=BLOCK) * w),
                    argnums=(0, 1))(jnp.asarray(mat), jnp.asarray(vec))
    ins = [_t(x).requires_grad_() for x in (mat, vec)]
    got = torch.autograd.grad((K.matvec_full_cf(*ins) * _t(w)).sum(), ins)
    for g, wg in zip(got, want):
        _close(_np(g).T[..., None], np.asarray(wg).T[..., None])
    mat, vec, w = (rng.standard_normal(s) for s in ((5, 3, 3), (5, 3), (5, 3)))
    want = jax.grad(lambda m, v: jnp.sum(F.batchmatvec(m, v) * w),
                    argnums=(0, 1))(jnp.asarray(mat), jnp.asarray(vec))
    ins = [_t(x).requires_grad_() for x in (mat, vec)]
    got = torch.autograd.grad((T.batchmatvec(*ins) * _t(w)).sum(), ins)
    for g, wg in zip(got, want):
        _close(_np(g)[..., None], np.asarray(wg)[..., None])


# --- matmul --------------------------------------------------------------------


MKN = [(1, 1, 1), (2, 3, 4), (6, 6, 6), (7, 3, 5), (9, 4, 11)]


@pytest.mark.parametrize("mkn", MKN, ids=["x".join(map(str, s)) for s in MKN])
def test_matmul_cf_matches_pallas(mkn, rng):
    m, k, n = mkn
    a, b = rng.standard_normal((m * k, 1, 5)), rng.standard_normal((k * n, 3, 1))
    want = np.asarray(pallas_matmul_cf(jnp.asarray(a), jnp.asarray(b), m, n, block=BLOCK))
    got = K.matmul_cf(_t(a), _t(b), m, n)
    assert got.shape == (m * n, 3, 5)
    _close(np.moveaxis(_np(got), 0, -1)[..., None], np.moveaxis(want, 0, -1)[..., None])


BMM = [(1, 1, 1), (2, 3, 4), (6, 6, 6), (3, 7, 2), (7, 7, 7), (16, 16, 16)]


@pytest.mark.parametrize("mkn", BMM, ids=["x".join(map(str, s)) for s in BMM])
def test_batchmatmul_every_backend_matches_reference(mkn, rng):
    """The port's auto and torch (on the CPU: the unrolled tier to dims
    6, torch.matmul above) against each of the reference's backends,
    the interpreted Pallas kernel among them; "cuda" raises on the CPU."""
    m, k, n = mkn
    a, b = rng.standard_normal((2, 1, m, k)), rng.standard_normal((3, k, n))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    wants = [np.asarray(F.batchmatmul(ja, jb, backend=bk)) for bk in ("auto", "xla")]
    # the reference's kernel entry takes one batch: broadcast first
    ab, bb = np.broadcast_to(a, (2, 3, m, k)), np.broadcast_to(b, (2, 3, k, n))
    wants.append(np.asarray(F.batchmatmul(jnp.asarray(ab), jnp.asarray(bb), backend="pallas")))
    for backend in ("auto", "torch"):
        got = _np(T.batchmatmul(_t(a), _t(b), backend=backend))
        for want in wants:
            _close(got, want)
    with pytest.raises(ValueError, match="CUDA"):
        T.batchmatmul(_t(a), _t(b), backend="cuda")


def test_batchmatmul_checks(rng):
    a = _t(rng.standard_normal((2, 3, 4)))
    with pytest.raises(ValueError, match="shape mismatch"):
        T.batchmatmul(a, a)
    with pytest.raises(ValueError, match="backend"):
        T.batchmatmul(a, a.mT, backend="pallas")
    with pytest.raises(ValueError, match="kernel serves"):
        T.batchmatmul(torch.ones(2, 33, 1), torch.ones(2, 1, 1), backend="cuda")
    with pytest.raises(ValueError, match="matmul_cf expects"):
        K.matmul_cf(torch.ones(6, 2), torch.ones(5, 2), 2, 2)
    with pytest.raises(ValueError, match="matvec_full_cf expects"):
        K.matvec_full_cf(torch.ones(5, 2), torch.ones(2, 2))


def test_matmul_grads_match_jax(rng):
    m, k, n = 6, 9, 5
    a, b, w = (rng.standard_normal(s) for s in ((m * k, 8), (k * n, 8), (m * n, 8)))
    want = jax.grad(lambda x, y: jnp.sum(pallas_matmul_cf(x, y, m, n, block=BLOCK) * w),
                    argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ins = [_t(x).requires_grad_() for x in (a, b)]
    got = torch.autograd.grad((K.matmul_cf(*ins, m, n) * _t(w)).sum(), ins)
    for g, wg in zip(got, want):
        _close(_np(g).T[..., None], np.asarray(wg).T[..., None])
    for m, k, n in ((3, 4, 2), (8, 7, 9)):
        a, b, w = (rng.standard_normal(s) for s in ((4, m, k), (4, k, n), (4, m, n)))
        want = jax.grad(lambda x, y: jnp.sum(F.batchmatmul(x, y) * w),
                        argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
        for backend in ("auto", "torch"):
            ins = [_t(x).requires_grad_() for x in (a, b)]
            got = torch.autograd.grad((T.batchmatmul(*ins, backend=backend) * _t(w)).sum(), ins)
            for g, wg in zip(got, want):
                _close(_np(g), np.asarray(wg))


def test_matmul_function_transposed_operands(rng):
    """The plain version reads either operand transposed, as the kernel
    does in the backward, and its gradients agree with autograd."""
    from fastmath_tpu_torch.kernels.batched_cuda import MatmulFunction, matmul_plain

    m, k, n = 3, 4, 5
    A, B = rng.standard_normal((6, m, k)), rng.standard_normal((6, k, n))
    for ta in (False, True):
        for tb in (False, True):
            a = _t(np.swapaxes(A, 1, 2) if ta else A).reshape(6, -1).requires_grad_()
            b = _t(np.swapaxes(B, 1, 2) if tb else B).reshape(6, -1).requires_grad_()
            y = MatmulFunction.apply(a, b, m, k, n, ta, tb, False, False)
            _close(_np(y).reshape(6, m, n), A @ B)
            got = torch.autograd.grad(y.square().sum(), (a, b))
            want = torch.autograd.grad(matmul_plain(a, b, m, k, n, ta, tb).square().sum(),
                                       (a, b))
            for g, w in zip(got, want):
                _close(_np(g)[..., None], _np(w)[..., None])


# --- batchchol's triangle rule -------------------------------------------------


def _asymmetric_spd(rng, shape, n):
    """SPD a aᵀ + n I plus 0.1 G, G random: the triangles differ."""
    a = rng.standard_normal((*shape, n, n))
    return a @ np.swapaxes(a, -1, -2) + n * np.eye(n) + 0.1 * rng.standard_normal((*shape, n, n))


@pytest.mark.parametrize("n", [3, 8, 16, 17, 20])
def test_batchchol_reads_the_reference_triangle(n, rng):
    a = _asymmetric_spd(rng, (5,), n)
    want = np.asarray(FT.batchchol(jnp.asarray(a)))
    for backend in ("auto", "torch"):
        _close(_np(T.batchchol(_t(a), backend=backend)), want)


@pytest.mark.parametrize("n", [3, 8, 20])
def test_batchchol_raw_gradient_matches_jax(n, rng):
    a = _asymmetric_spd(rng, (4,), n)
    w = rng.standard_normal((4, n, n))
    want = np.asarray(jax.grad(lambda x: jnp.sum(FT.batchchol(x) * w))(jnp.asarray(a)))
    if n <= 16:
        assert (np.triu(want, 1) == 0).all()
    for backend in ("auto", "torch"):
        x = _t(a).requires_grad_()
        (got,) = torch.autograd.grad((T.batchchol(x, backend=backend) * _t(w)).sum(), x)
        _close(_np(got), want, 1e-10)
        if n <= 16:
            assert (np.triu(_np(got), 1) == 0).all()


def test_chol_solve_reads_the_lower_triangle(rng):
    for n in (3, 8):
        a = _asymmetric_spd(rng, (1, 4), n)
        rhs = rng.standard_normal((3, 1, n))
        _close(_np(_chol_solve_unrolled(_t(a), _t(rhs)))[..., None],
               np.asarray(ref_chol_solve(jnp.asarray(a), jnp.asarray(rhs)))[..., None])


# --- public names --------------------------------------------------------------


def test_public_names_match_reference():
    from fastmath_tpu import kernels as RK
    from fastmath_tpu.ops import sym as RS

    import fastmath_tpu_torch.ops.batched as TB
    import fastmath_tpu_torch.ops.sym as TS

    assert set(RS.__all__) <= set(TS.__all__)
    assert set(F.__all__) <= set(TB.__all__)
    for name in ("sym_matvec_chain", "sym_maxeig", "sym_diag", "sym_to_full", "full_to_sym"):
        assert getattr(T, name) is getattr(TS, name) and name in T.__all__
    from fastmath_tpu_torch import layouts

    for name in ("sym_diag", "sym_to_full", "full_to_sym"):
        assert getattr(TS, name) is getattr(layouts, name)
    ported = {"sym_matvec_chain_cf", "sym_maxeig_cf", "matvec_full_cf", "matmul_cf"}
    assert ported <= set(K.__all__) and ported <= set(RK.__all__)
    # every kernel entry of the reference's has its counterpart
    missing = set(RK.__all__) - set(K.__all__) - {"DEFAULT_BLOCK"}
    assert missing == set()
