"""The port's determinant, log-determinant, Cholesky, compact determinant
and compact inverse wrappers (``fastmath_tpu_torch.kernels``) against the
reference's Pallas kernels run in interpret mode, which fixes the kernel
path's tiers: n = 2, 3, 4 (closed forms), 5 and 8 (unrolled) and 12
(rolled).

On the CPU each wrapper runs its kernel's plain PyTorch version and
launches nothing. float64, ``1e-10`` relative (``atol = 1e-12 *
max|want|``), and ``1e-10 * max(1, |logdet|)`` absolute for ``log |det|``.
Also in float32, where the determinant overflows (an 8 x 8 with pivots
~7e4, a 3 x 3 with entries ~1e30): ``log |det|`` stays finite, within
``1e-5 * |logdet|`` of float64 numpy, as the reference kernel's does.
The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_factor_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmath_tpu import kernels as PK

import fastmath_tpu_torch as T
from fastmath_tpu_torch import kernels as K

BLOCK = 128  # interpret-mode block of the Pallas kernels


def _general(rng, b, n):
    """n I + (sqrt(n) / 4) R with shuffled rows: partial pivoting swaps
    at most steps; condition number ~3."""
    a = n * np.eye(n) + np.sqrt(n) / 4 * rng.standard_normal((b, n, n))
    perm = np.argsort(rng.random((b, n)), axis=-1)
    return np.take_along_axis(a, perm[..., None], axis=-2)


def _compact(full):
    n = full.shape[-1]
    rows, cols = np.triu_indices(n, k=1)
    return np.concatenate([np.diagonal(full, axis1=-2, axis2=-1), full[..., rows, cols]],
                          axis=-1)


def _spd(rng, b, n):
    a = rng.standard_normal((b, n, n))
    return _compact(a @ a.transpose(0, 2, 1) + n * np.eye(n))


def _indefinite(rng, b, n):
    """Symmetric, indefinite, well conditioned: pivoting swaps rows."""
    q, _ = np.linalg.qr(rng.standard_normal((b, n, n)))
    w = rng.uniform(0.5, 2.0, (b, n)) * np.where(rng.random((b, n)) < 0.5, -1, 1)
    return _compact(np.einsum("bik,bk,bjk->bij", q, w, q))


def _close_log(got, want, tol=1e-10):
    got = np.asarray(got)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= tol * np.maximum(1.0, np.abs(want))), (got, want)


# wrapper name -> its operand, (B, channels) batch-major
OPERANDS = {
    "det_cf": lambda rng, b, n: _general(rng, b, n).reshape(b, n * n),
    "logdet_cf": lambda rng, b, n: _general(rng, b, n).reshape(b, n * n),
    "chol_cf": _spd,
    "sym_det_cf": _indefinite,
    "sym_invert_cf": _indefinite,
}


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8, 12])
@pytest.mark.parametrize("name", sorted(OPERANDS))
def test_kernel_matches_pallas(name, n, rng):
    mat = np.ascontiguousarray(OPERANDS[name](rng, 64, n).T)  # channel-first
    wrapper = getattr(K, name)
    before = wrapper.launches
    got = wrapper(torch.from_numpy(mat)).numpy()
    want = np.asarray(getattr(PK, name)(jnp.asarray(mat), block=BLOCK, interpret=True))
    assert wrapper.launches == before  # CPU: the plain version
    assert got.shape == want.shape
    if name == "logdet_cf":
        _close_log(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12 * np.abs(want).max())


def test_logdet_where_det_saturates_float32(rng):
    # an 8 x 8 with pivots ~7e4 (det ~6e38) and 3 x 3 with entries ~1e30
    # (det ~1e90): the float32 determinant overflows, log|det| does not
    for n, scale in ((8, 7e4), (3, 1e30)):
        a = (scale * (np.eye(n) + 0.05 * rng.standard_normal((16, n, n)))).astype(np.float32)
        want = np.linalg.slogdet(a.astype(np.float64))[1]
        assert not np.isfinite(T.batchdet(torch.from_numpy(a)).numpy()).any()
        cf = np.ascontiguousarray(a.reshape(16, n * n).T)
        ref = np.asarray(PK.logdet_cf(jnp.asarray(cf), block=BLOCK, interpret=True))
        for got in (T.batchlogdet(torch.from_numpy(a)), K.logdet_cf(torch.from_numpy(cf))):
            assert got.dtype == torch.float32
            _close_log(got.numpy(), want, 1e-5)
        _close_log(ref, want, 1e-5)
    # a zero row: -inf, not NaN
    z = np.stack([np.eye(3), np.diag([2.0, 0.0, 1.0])])
    assert T.batchlogdet(torch.from_numpy(z)).tolist() == [0.0, -np.inf]
