"""The port's ``ops/lie.py`` against ``fastmath_tpu.ops.lie`` (JAX, CPU).

The same arrays, made with numpy from a seed, go through both packages;
the JAX results are computed once per module, with as few calls as the
cases allow (its ``logm`` compiles slowly, so it runs at d <= 4 here).

* ``expm`` (SE(3) log-matrices at four scales, general 5x5, complex,
  with a basis, extra batch dims), ``logm`` (SE(3), SPD, general),
  ``meanm`` (batched, one barycenter diverging), ``_logm_sym_eig`` and
  ``expm_derivatives`` (taylor and jacfwd, an SE(3)-sized F = 6 basis),
  float64: 1e-10 relative to the largest entry (the same algorithms; the
  port's products and exits round differently).
* The branch-cut cases of ``tests/test_lie.py`` against scipy's real-cast
  ``logm``, at that file's tolerances; complex input against scipy.
* Gradients of ``expm`` and ``logm`` against ``jax.grad`` of the same loss,
  float64, 1e-8 relative.
* The float32 roundtrip tail on 20,000 4x4 problems, at the reference's
  own bound (``tests/test_lie.py``: median < 1e-6, p99 < 3e-5), for the
  CPU route and for the kernels' plain version.
"""
import inspect
import pathlib
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from fastmath_tpu.ops import lie as JL

import fastmath_tpu_torch as T
from fastmath_tpu_torch.kernels import logm as KL
from fastmath_tpu_torch.ops import lie as L

TOL = 1e-10


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, tol=TOL):
    got = got.resolve_conj().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


def se3_batch(rng, b, scale=1.0):
    """Random se(3) log-matrices (4x4, last row zero)."""
    X = np.zeros((b, 4, 4))
    w = rng.standard_normal((b, 3)) * scale
    v = rng.standard_normal((b, 3)) * scale
    X[:, 0, 1], X[:, 0, 2], X[:, 1, 2] = -w[:, 2], w[:, 1], -w[:, 0]
    X = X - np.swapaxes(X, -1, -2)
    X[:, :3, 3] = v
    return X


def _so3_basis():
    basis = np.zeros((3, 3, 3))
    basis[0, 1, 2], basis[0, 2, 1] = -1, 1
    basis[1, 0, 2], basis[1, 2, 0] = 1, -1
    basis[2, 0, 1], basis[2, 1, 0] = -1, 1
    return basis


def _se3_basis():
    """The six generators of se(3) (F = 6, 4x4)."""
    basis = np.zeros((6, 4, 4))
    basis[:3, :3, :3] = _so3_basis()
    for i in range(3):
        basis[3 + i, i, 3] = 1.0
    return basis


# ---------------------------------------------------------------------------
# the reference's results, once per module
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def expm_cases():
    rng = np.random.default_rng(10)
    se3 = np.concatenate([se3_batch(rng, 2, s) for s in (0.1, 1.0, 5.0, 50.0)])
    cases = {
        "se3": (se3, None),
        "general5": (rng.standard_normal((6, 5, 5)), None),
        "complex3": (rng.standard_normal((4, 3, 3)) + 1j * rng.standard_normal((4, 3, 3)), None),
        "basis": (rng.standard_normal((6, 3)), _so3_basis()),
        "batch_dims": (rng.standard_normal((2, 3, 2, 2)) * 0.7, None),
    }
    return {k: (x, b, np.asarray(JL.expm(jnp.asarray(x), None if b is None else jnp.asarray(b))))
            for k, (x, b) in cases.items()}


@pytest.fixture(scope="module")
def logm_case():
    """One 4x4 batch: expm of SE(3) logs, SPD matrices and general
    matrices near the identity (one call of the reference's logm)."""
    rng = np.random.default_rng(11)
    se3 = np.stack([sla.expm(x) for x in se3_batch(rng, 6, 0.8)])
    a = rng.standard_normal((4, 4, 4))
    spd = np.einsum("...ij,...kj->...ik", a, a) + 4 * np.eye(4)
    gen = np.stack([sla.expm(x) for x in rng.standard_normal((4, 4, 4)) * 0.4])
    A = np.concatenate([se3, spd, gen])
    return A, np.asarray(JL.logm(jnp.asarray(A)))


@pytest.fixture(scope="module")
def meanm_case():
    """Three 8-matrix barycenters; the third holds a singular matrix, so its
    projections turn NaN and it diverges while the others converge."""
    rng = np.random.default_rng(12)
    X = rng.standard_normal((3, 8, 4, 4)) * 0.25
    A = np.array(JL.expm(jnp.asarray(X)))
    A[2, 3] = np.diag([1.0, 1.0, 1.0, 0.0])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = np.asarray(JL.meanm(jnp.asarray(A)))
    return A, want


@pytest.fixture(scope="module")
def deriv_case():
    rng = np.random.default_rng(13)
    basis = _se3_basis()
    coefs = rng.standard_normal((5, 6)) * 0.4
    want = JL.expm_derivatives(jnp.asarray(coefs), jnp.asarray(basis), grad_X=True,
                               grad_basis=True, hess_X=True, method="taylor")
    return coefs, basis, [np.asarray(w) for w in want]


# ---------------------------------------------------------------------------
# expm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["se3", "general5", "complex3", "basis", "batch_dims"])
def test_expm(case, expm_cases):
    x, basis, want = expm_cases[case]
    got = T.expm(_t(x), None if basis is None else _t(basis))
    _close(got, want)
    # the plain route gives the same on the CPU
    _close(T.expm(_t(x), None if basis is None else _t(basis), backend="torch"), want)


def test_expm_dtypes_and_backends(rng):
    x = rng.standard_normal((5, 3, 3)) * 0.5
    want = np.stack([sla.expm(m) for m in x])
    # integers compute in the default float; bf16 in float32, rounded once
    assert T.expm(torch.zeros(2, 3, 3, dtype=torch.int64)).dtype == torch.get_default_dtype()
    y = T.expm(_t(x).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    assert np.abs(y.double().numpy() - want).max() <= 0.05 * np.abs(want).max()
    with pytest.raises(ValueError):
        T.expm(_t(x), backend="pallas")
    with pytest.raises(ValueError):
        T.expm(_t(x), backend="cuda")  # CPU tensors
    # max_order and tol are ignored
    _close(T.expm(_t(x), max_order=3, tol=1.0), want)


def test_expm_large_norm_and_identity(rng):
    """Deep squaring (||X|| ~ 2^10) and X = 0 (exactly I)."""
    x = rng.standard_normal((4, 4, 4))
    x = 100 * (x - np.swapaxes(x, -1, -2))
    want = np.stack([sla.expm(m) for m in x])
    _close(T.expm(_t(x)), want, 1e-9)
    assert torch.equal(T.expm(torch.zeros(3, 5, 5, dtype=torch.float64)),
                       torch.eye(5, dtype=torch.float64).expand(3, 5, 5))


# ---------------------------------------------------------------------------
# logm
# ---------------------------------------------------------------------------


def test_logm(logm_case):
    A, want = logm_case
    _close(T.logm(_t(A)), want)


def test_logm_float32(logm_case):
    A, want = logm_case
    got = T.logm(_t(A).float())
    assert got.dtype == torch.float32
    err = np.linalg.norm((got.double().numpy() - want).reshape(len(A), -1), axis=-1)
    assert (err / np.linalg.norm(want.reshape(len(A), -1), axis=-1)).max() <= 1e-5


def _scipy_realcast(A):
    ref = sla.logm(A, disp=False)[0]
    return ref.real if np.iscomplexobj(ref) else ref


def _R3(axis, ang):
    axis = np.asarray(axis, float) / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)


def _collision_matrix(rng):
    t = 0.7390851332151607
    M = np.zeros((3, 3))
    M[0, 0] = -2.0
    M[1:, 1:] = [[-2.0 + t, -1.0], [1.0, -2.0 + t]]
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    return q @ M @ q.T


def _branch_cut_cases():
    rng = np.random.default_rng(14)
    v = rng.standard_normal(3)
    v /= np.linalg.norm(v)
    V = rng.standard_normal((4, 4))
    th = [np.pi - e for e in (1e-2, 1e-3, 1e-6)]
    return [
        ("minus_eye", -np.eye(2), 1e-12),
        ("diag_neg_pos", np.diag([-1.0, 2.0]), 1e-12),
        ("diag_two_neg", np.diag([-4.0, -0.25, 3.0]), 1e-12),
        ("rot_pi_z", np.diag([-1.0, -1.0, 1.0]), 1e-12),
        ("jordan_neg", np.array([[-1.0, 1.0], [0.0, -1.0]]), 1e-9),
        ("reflection", np.eye(3) - 2 * np.outer(v, v), 1e-12),
        ("rot_pi_axis", _R3(rng.standard_normal(3), np.pi), 1e-10),
        ("nonnormal", V @ np.diag([-2.0, -0.5, 1.5, 3.0]) @ np.linalg.inv(V), 1e-8),
        ("collision", _collision_matrix(rng), 1e-7),
    ] + [(f"near_pi_{i}", np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]]), 1e-6)
         for i, t in enumerate(th)]


@pytest.mark.parametrize("name,mat,tol", _branch_cut_cases(), ids=lambda v: v if isinstance(v, str) else "")
def test_logm_branch_cut_realcast(name, mat, tol):
    """Real input with eigenvalues on the negative real axis returns the
    real part of the complex principal log, as scipy real-cast (the
    reference's contract and ``tests/test_lie.py``'s tolerances)."""
    got = T.logm(_t(mat))
    want = _scipy_realcast(mat)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=max(tol, 1e-12))


def test_logm_mixed_batch_no_poisoning(rng):
    """An on-cut matrix in a batch leaves the others untouched: exactly it
    is rerouted."""
    good = sla.expm(rng.standard_normal((3, 3)) * 0.4)
    batch = np.stack([np.diag([-1.0, -1.0, 1.0]), good, np.eye(3) * 2.0])
    got = T.logm(_t(batch)).numpy()
    for i in range(3):
        np.testing.assert_allclose(got[i], _scipy_realcast(batch[i]), rtol=1e-9, atol=1e-10)
    np.testing.assert_array_equal(got[1], T.logm(_t(good[None])).numpy()[0])


@pytest.mark.parametrize("diag", [False, True])
def test_logm_complex(diag, rng):
    """Complex input: the complex principal log (also with an eigenvalue on
    the negative real axis), against scipy."""
    if diag:
        A = np.diag([-2.0 + 0j, 1.5 + 0.5j])
    else:
        A = rng.standard_normal((3, 3)) + 1j * rng.standard_normal((3, 3)) + 3 * np.eye(3)
    got = T.logm(_t(A)).numpy()
    np.testing.assert_allclose(got, sla.logm(A, disp=False)[0], rtol=1e-9, atol=1e-9)


def test_logm_exceptional_d6(rng):
    """The shift route at d = 6 (its complex ISS takes determinant-scaled
    square roots through the LU tier of ``batchdet``)."""
    V = rng.standard_normal((6, 6))
    A = V @ np.diag([-2.0, -0.5, 1.5, 3.0, 0.7, 2.2]) @ np.linalg.inv(V)
    np.testing.assert_allclose(T.logm(_t(A)).numpy(), _scipy_realcast(A), rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("n", [6, 9])
def test_batchdet_complex_lu_tier(n, rng):
    """``batchdet`` on complex input at 5 <= n <= 16 (the pivoted-LU plain
    tier, whose permutation sign is real)."""
    a = rng.standard_normal((3, n, n)) + 1j * rng.standard_normal((3, n, n))
    _close(T.batchdet(_t(a)), np.linalg.det(a), 1e-12)


def test_logm_sym_eig(rng):
    """The symmetric eig route (the card takes it for symmetric batches at
    d >= _LOGM_SYM_EIG_MIN_D) against its JAX counterpart, SPD and
    symmetric indefinite (the real-cast log)."""
    from fastmath_tpu.ops.lie import _logm_sym_eig as jax_sym

    a = rng.standard_normal((4, 6, 6))
    spd = a @ np.swapaxes(a, -1, -2) / 6 + np.eye(6)
    ind = a + np.swapaxes(a, -1, -2)
    A = np.concatenate([spd, ind])
    want, wok = jax_sym(jnp.asarray(A))
    got, ok = L._logm_sym_eig(_t(A))
    assert ok.numpy().tolist() == np.asarray(wok).tolist()
    _close(got, want)
    _close(got[:4], np.stack([_scipy_realcast(m) for m in spd]))


def test_logm_routes_on_cpu(logm_case):
    """On the CPU the regular case is the ISS core (no sym route, as JAX on
    the CPU); ``_logm_plain`` flags nothing on regular input."""
    A, want = logm_case
    Lp, ok = L._logm_plain(_t(A))
    assert ok.all()
    Li, oki = L._iss_log_core(_t(A))
    assert torch.equal(Lp, Li) and torch.equal(ok, oki)
    _close(Lp, want)


def test_logm_f32_tail(rng):
    """The reference's float32 roundtrip bound on 20,000 4x4 problems, for
    the CPU route and for the kernels' plain version."""
    X = (rng.standard_normal((20000, 4, 4)) * 0.5).astype(np.float32)
    E = T.expm(_t(X))
    for got in (T.logm(E), KL.logm_plain(E)):
        rel = np.abs(got.numpy() - X) / (np.abs(X) + 1e-30)
        assert np.median(rel) < 1e-6
        assert np.quantile(rel, 0.99) < 3e-5


# ---------------------------------------------------------------------------
# meanm
# ---------------------------------------------------------------------------


def test_meanm_batched_and_divergence(meanm_case):
    A, want = meanm_case
    with pytest.warns(RuntimeWarning, match="failed to converge"):
        got = T.meanm(_t(A))
    _close(got, want)
    # the diverged barycenter returns its best iterate (the identity here);
    # the others converge as they do alone
    assert torch.equal(got[2], torch.eye(4, dtype=torch.float64))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        alone = T.meanm(_t(A[:2]))
    _close(alone, want[:2])


def test_meanm_float32_input(meanm_case):
    """The iteration runs in float64 and the result comes back in the
    input's dtype."""
    A, want = meanm_case
    got = T.meanm(_t(A[:2]).float())
    assert got.dtype == torch.float32
    assert np.abs(got.double().numpy() - want[:2]).max() <= 1e-5


def test_meanm_rotations_including_pi(rng):
    mats = np.stack([_R3(rng.standard_normal(3), a) for a in [0.3, 2.0, np.pi, -2.8]])
    mean = T.meanm(_t(mats)).numpy()
    assert np.isfinite(mean).all()
    np.testing.assert_allclose(mean @ mean.T, np.eye(3), atol=1e-6)


# ---------------------------------------------------------------------------
# expm_derivatives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["taylor", "jacfwd"])
def test_expm_derivatives(method, deriv_case):
    coefs, basis, want = deriv_case
    got = T.expm_derivatives(_t(coefs), _t(basis), grad_X=True, grad_basis=True, hess_X=True,
                             method=method)
    for g, w in zip(got, want):
        _close(g, w)
    # one output at a time, and the derivative-free call
    _close(T.expm_derivatives(_t(coefs), _t(basis), grad_X=True, method=method)[1], want[1])
    _close(T.expm_derivatives(_t(coefs), _t(basis), method=method), want[0])


def test_expm_derivatives_one_hot(rng):
    """Without a basis: the one-hot basis over the D*D entries; dX[f] is
    the derivative along entry f."""
    x = rng.standard_normal((2, 3, 3)) * 0.3
    E, dX = T.expm_derivatives(_t(x), grad_X=True)
    _close(E, np.stack([sla.expm(m) for m in x]))
    h = 1e-6
    e = np.zeros((3, 3))
    e[1, 2] = h
    fd = (np.stack([sla.expm(m + e) for m in x]) - np.stack([sla.expm(m - e) for m in x])) / (2 * h)
    np.testing.assert_allclose(dX[:, 5].numpy(), fd, rtol=1e-6, atol=1e-8)
    with pytest.raises(ValueError):
        T.expm_derivatives(_t(x), method="pade")


# ---------------------------------------------------------------------------
# gradients against jax.grad
# ---------------------------------------------------------------------------


def test_expm_grad(rng):
    x = rng.standard_normal((3, 3, 3)) * 0.5
    g = rng.standard_normal((3, 3, 3))
    want = np.asarray(jax.grad(lambda m: jnp.sum(jnp.asarray(g) * JL.expm(m)))(jnp.asarray(x)))
    for backend in ("auto", "torch"):
        xt = _t(x).requires_grad_()
        (T.expm(xt, backend=backend) * _t(g)).sum().backward()
        _close(xt.grad, want, 1e-8)


def test_logm_grad(rng):
    """The Mathias backward (logm of the 2d x 2d block) against jax.grad of
    the reference's custom VJP, and grad of sum(logm(expm(X))) = ones."""
    a = np.stack([sla.expm(m) for m in rng.standard_normal((3, 2, 2)) * 0.4])
    g = rng.standard_normal((3, 2, 2))
    want = np.asarray(jax.grad(lambda m: jnp.sum(jnp.asarray(g) * JL.logm(m)))(jnp.asarray(a)))
    at = _t(a).requires_grad_()
    (T.logm(at) * _t(g)).sum().backward()
    _close(at.grad, want, 1e-8)
    x = _t(rng.standard_normal((2, 3, 3)) * 0.3).requires_grad_()
    T.logm(T.expm(x)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.ones((2, 3, 3)), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the package boundary
# ---------------------------------------------------------------------------


def test_public_names_and_signatures():
    """Every public name of the reference's module, with the same
    parameters and defaults, in the port's module, ``ops`` and the top
    level; the channel-first wrappers in ``kernels``."""
    import fastmath_tpu_torch.kernels as kernels
    import fastmath_tpu_torch.ops as ops

    assert set(L.__all__) == set(JL.__all__)
    for name in JL.__all__:
        fn = getattr(L, name)
        assert getattr(T, name) is fn and getattr(ops, name) is fn and name in T.__all__
        want = [(p.name, p.default) for p in inspect.signature(getattr(JL, name)).parameters.values()]
        got = [(p.name, p.default) for p in inspect.signature(fn).parameters.values()]
        assert got == want, name
    assert "expm_cf" in kernels.__all__ and "logm_cf" in kernels.__all__


def test_import_loads_no_jax():
    code = ("import sys, torch, fastmath_tpu_torch as T\n"
            "x = 0.1 * torch.ones(2, 3, 3, dtype=torch.float64)\n"
            "T.logm(T.expm(x)); T.meanm(T.expm(x)[None]); T.expm_derivatives(x, grad_X=True)\n"
            "T.kernels.logm_cf(T.kernels.expm_cf(x.reshape(2, 9).T))\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'fastmath_tpu' or m.startswith('fastmath_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=pathlib.Path(__file__).resolve().parents[1])
