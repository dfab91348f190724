"""The plain versions of the port's matrix exponential and logarithm
kernels (``kernels/expm.py``, ``kernels/logm.py``) against the Pallas
kernels they replace, ``fastmath_tpu.kernels.expm_cf`` / ``logm_cf``, run in
interpret mode on the CPU as ``tests/test_expm_pallas.py`` runs them
(small batches at d <= 5, ``expm_cf`` at d = 9 and 12 on 8 problems), and
against float64 scipy at d = 12..32, where interpret mode would take
minutes.

The port's wrappers run the plain versions on CPU tensors; the plain
versions repeat the kernels' arithmetic (the same tiers, inverses and
per-problem exits). Float64, 1e-10 relative to the largest entry: the
algorithms are the reference's, but the port's one-thread tier inverts by
cofactors where the reference's d = 5..8 tier uses a pivoted LU, its warp
tier by Gauss-Jordan, and each problem stops on its own tests (one
Denman-Beavers step past the test) where the reference iterates a block
of problems together.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from fastmath_tpu.kernels.expm_pallas import expm_cf as jax_expm_cf
from fastmath_tpu.kernels.logm_pallas import logm_cf as jax_logm_cf

from fastmath_tpu_torch.kernels import expm as KE
from fastmath_tpu_torch.kernels import expm_cf, logm_cf
from fastmath_tpu_torch.kernels import logm as KL

TOL = 1e-10


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


def _cf(x):
    """(B, d, d) -> channel-first (d*d, B), row-major channels."""
    b, d = x.shape[0], x.shape[-1]
    return np.ascontiguousarray(x.reshape(b, d * d).T)


def _expm64(x):
    return np.stack([sla.expm(m) for m in x])


@pytest.mark.parametrize("d,b", [(1, 16), (2, 16), (3, 16), (4, 16), (5, 8), (9, 8), (12, 8)])
def test_expm_cf_matches_interpret(d, b, rng):
    """Both tiers: d <= 8 the one-thread tier in float64 up to
    UNROLL_MAX[float64], the warp tier above; X at the bench scale."""
    x = rng.standard_normal((b, d, d)) * (0.5 / np.sqrt(d))
    cf = _cf(x)
    want = np.asarray(jax_expm_cf(jnp.asarray(cf), block=128, interpret=True))
    got = expm_cf(torch.from_numpy(cf))
    _close(got.numpy(), want)
    _close(got.numpy().T.reshape(b, d, d), _expm64(x))


@pytest.mark.parametrize("d,b", [(2, 16), (3, 16), (4, 16), (5, 8)])
def test_logm_cf_matches_interpret(d, b, rng):
    """logm of expm of the bench input: the one-thread tier's cofactor
    inverses at d <= 4, the warp tier's Gauss-Jordan at 5."""
    e = _expm64(rng.standard_normal((b, d, d)) * 0.5)
    cf = _cf(e)
    want = np.asarray(jax_logm_cf(jnp.asarray(cf), block=128, interpret=True))
    got = logm_cf(torch.from_numpy(cf))
    _close(got.numpy(), want)


def _mixed_batch(rng, d):
    """Problems that need 0 to 5 square roots, and two on the branch cut
    (a reflection, a rotation by pi), side by side."""
    x = rng.standard_normal((8, d, d))
    skew = x - np.swapaxes(x, -1, -2)
    rho = np.abs(np.linalg.eigvals(skew)).max(-1)
    rot = _expm64(skew * (0.9 * math.pi / rho)[:, None, None])
    near = _expm64(x * 0.02)
    far = _expm64(x * 0.5)
    refl = np.eye(d)
    refl[0, 0] = -1.0
    pi_rot = np.eye(d)
    pi_rot[:2, :2] = -np.eye(2)
    return np.concatenate([near[:3], refl[None], far[:3], rot[:3], pi_rot[None], np.eye(d)[None]])


def test_per_problem_exits(rng):
    """A batch mixing depths and on-cut matrices: the port's per-problem
    exits give the reference's block-wise result on every regular problem,
    and NaN on exactly the on-cut ones."""
    a = _mixed_batch(rng, 3)
    want = np.asarray(jax_logm_cf(jnp.asarray(_cf(a)), block=128, interpret=True)).T.reshape(a.shape)
    got = KL.logm_plain(torch.from_numpy(a)).numpy()
    bad = np.isnan(want).any(axis=(-2, -1))
    assert bad.nonzero()[0].tolist() == [3, 10]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    _close(got[~bad], want[~bad])
    # each problem alone gives its own result, bit for bit
    for i in (0, 5, 8, 11):
        np.testing.assert_array_equal(KL.logm_plain(torch.from_numpy(a[i:i + 1])).numpy()[0],
                                      got[i])


def test_float32_roundtrip_chain_tail():
    """The bench suite's roundtrip chain ``e <- expm(0.999 logm(e))``, k =
    4, on expm of 4x4 ``0.5 randn`` in float32 through the plain versions:
    within 1e-5 normwise of the float64 scipy recurrence on every one of
    1,024 problems, as the reference kernel's block-wise iteration is.
    Stopping each square root at the Denman-Beavers test, without the step
    past it, fails here (the 2^(k+1) scale multiplies the root's last
    error)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((1024, 4, 4)) * 0.5).astype(np.float32))
    e = KE.expm_plain(x)
    got = e
    for _ in range(4):
        got = KE.expm_plain(KL.logm_plain(got) * 0.999)
    want = e.double().numpy()
    for _ in range(4):
        want = np.stack([sla.expm(np.real(sla.logm(m)) * 0.999) for m in want])
    g, w = got.double().numpy().reshape(1024, -1), want.reshape(1024, -1)
    err = np.linalg.norm(g - w, axis=1) / np.linalg.norm(w, axis=1)
    assert err.max() <= 1e-5, (err.max(), int((err > 1e-5).sum()))


@pytest.mark.parametrize("d", [16, 25, 32])
def test_plain_versions_against_scipy(d, rng):
    """The warp tiers' plain versions at d where interpret mode costs
    minutes: expm at the bench scale, logm of its result (the reference's
    rolled and flat tiers run the same nested algebra)."""
    x = rng.standard_normal((3, d, d)) * (0.5 / np.sqrt(d))
    e = KE.expm_plain(torch.from_numpy(x))
    _close(e.numpy(), _expm64(x))
    lg = logm_cf(e.reshape(3, d * d).T)
    _close(lg.T.reshape(3, d, d).numpy(), np.stack([sla.logm(m) for m in e.numpy()]))


@pytest.mark.parametrize("d", [2, 3, 4])
def test_tiers_agree(d, rng):
    """The one-thread tier's algebra (cofactor inverses, squares summed in
    order) and the warp tier's (Gauss-Jordan, summed as a whole) on the
    same problems."""
    a = torch.from_numpy(_expm64(rng.standard_normal((20, d, d)) * 0.5))
    tol = torch.finfo(a.dtype).eps * 8 * d
    closed = KL.iss_log(a, tol, KL._inv_closed, ordered=True)
    gj = KL.iss_log(a, tol, KL.gj_inverse)
    assert torch.equal(closed[1], gj[1]) and torch.equal(closed[2], gj[2])
    _close(closed[0].numpy(), gj[0].numpy(), 1e-12)


def test_gj_inverse(rng):
    """The warp tier's inverse against numpy, and exact row swaps on rows of
    very different scales (an arithmetic swap would lose the small entries)."""
    a = torch.from_numpy(rng.standard_normal((10, 7, 7)))
    _close(KL.gj_inverse(a).numpy(), np.linalg.inv(a.numpy()), 1e-12)
    m = np.eye(5)
    m[0, :2] = [1e-20, 1e20]
    m[1, :2] = [1.0, 1.0]
    inv = KL.gj_inverse(torch.from_numpy(m[None])).numpy()[0]
    np.testing.assert_allclose(inv @ m, np.eye(5), atol=1e-12)


def test_iteration_counts(rng):
    """The counts the bound of a run is built from: the identity needs no
    square root; expm of the bench input a few, each a handful of
    Denman-Beavers steps."""
    a = torch.from_numpy(np.concatenate([np.eye(4)[None], _expm64(rng.standard_normal((5, 4, 4)) * 0.5)]))
    iss, db = KL.iteration_counts(a)
    assert iss[0] == 0 and db[0] == 0
    assert (iss[1:] >= 1).all() and (iss[1:] <= 6).all()
    assert (db[1:] >= 3 * iss[1:]).all() and (db[1:] <= 12 * iss[1:]).all()
    s = KE.squaring_counts(torch.from_numpy(np.stack([np.zeros((3, 3)), 3 * np.eye(3)])))
    assert s.tolist() == [0.0, 3.0]


def test_channel_first_wrappers(rng):
    """Batch dims as given, float32 computed in float32, bf16 rounded once,
    and the wrappers' checks."""
    x = rng.standard_normal((2, 3, 4, 4)) * 0.3
    cf = torch.from_numpy(np.moveaxis(x.reshape(2, 3, 16), -1, 0).copy())
    got = expm_cf(cf)
    assert tuple(got.shape) == (16, 2, 3)
    want = np.moveaxis(_expm64(x.reshape(6, 4, 4)).reshape(2, 3, 16), -1, 0)
    _close(got.numpy(), want)
    _close(logm_cf(got).numpy(), np.moveaxis(x.reshape(2, 3, 16), -1, 0))
    assert expm_cf(cf.float()).dtype == torch.float32
    assert logm_cf(cf.to(torch.bfloat16) + 1).dtype == torch.bfloat16
    for fn in (expm_cf, logm_cf):
        with pytest.raises(ValueError):
            fn(torch.zeros(15, 4))
        with pytest.raises(ValueError):
            fn(torch.zeros(33 * 33, 4))
        with pytest.raises(ValueError):
            fn(torch.zeros(9, 4, dtype=torch.complex128))


def test_expm_cf_backward(rng):
    """expm_cf is differentiable through the Mathias block (plain version on
    the CPU), against central differences."""
    x = rng.standard_normal((4, 3, 3)) * 0.5
    g = rng.standard_normal((9, 4))
    cf = torch.from_numpy(_cf(x)).requires_grad_()
    (expm_cf(cf) * torch.from_numpy(g)).sum().backward()
    h = 1e-6
    e = np.zeros((9, 4))
    e[5, 2] = h
    fd = ((np.asarray(expm_cf(torch.from_numpy(_cf(x) + e))) * g).sum()
          - (np.asarray(expm_cf(torch.from_numpy(_cf(x) - e))) * g).sum()) / (2 * h)
    assert abs(cf.grad[5, 2].item() - fd) <= 1e-7 * max(abs(fd), 1.0)
