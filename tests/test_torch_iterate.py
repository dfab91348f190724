"""The port's compact-symmetric iterations (``sym_matvec_chain``,
``sym_maxeig`` and their channel-first kernels' wrappers) against
``fastmath_tpu`` (JAX, CPU).

On the CPU every kernel wrapper runs its plain PyTorch version. Compact
input in the kernels' domain is held against the reference's Pallas
kernels run in interpret mode (``backend="pallas"``, the ``*_cf``
entries), which fix the kernel path's semantics (term order, the
Gershgorin pre-scale, ``renorm_every``); the other storage classes
against the reference's XLA path; the default start vector against
float64 ``eigvalsh``; gradients against ``jax.grad`` of the reference.
Tolerance: float64, normwise per problem, 1e-12 (the same sums in the
same or another order; the matrices are contractions, A / (6N) of an SPD
``a aᵀ + N I`` as ``bench/suite.py`` scales them, or have a dominant
eigenvalue well apart from the rest, so no recurrence amplifies the
roundings); the eigenvalue against ``eigvalsh`` relative 1e-10 after 120
steps, as the reference's own test.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_iterate_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmath_tpu.kernels.sym_pallas import sym_matvec_chain_cf as pallas_chain_cf
from fastmath_tpu.kernels.sym_pallas import sym_maxeig_cf as pallas_maxeig_cf
from fastmath_tpu.ops import sym as F

import fastmath_tpu_torch as T
from fastmath_tpu_torch import kernels as K

from _torch_cpu import one_thread  # noqa: F401  (autouse)

TOL = 1e-12
BLOCK = 128  # interpret-mode block of the Pallas kernels


def _compact(full):
    n = full.shape[-1]
    rows, cols = np.triu_indices(n, k=1)
    return np.concatenate([np.diagonal(full, axis1=-2, axis2=-1), full[..., rows, cols]],
                          axis=-1)


def _contraction(rng, shape, n):
    """bench/suite.py's chain input: an SPD a aᵀ + N I scaled by 1/(6N)."""
    a = rng.standard_normal((*shape, n, n))
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n)) / (6 * n)


def _gapped(rng, shape, n):
    """Symmetric matrices with a dominant eigenvalue 8 N apart (the
    reference's tests/test_maxeig.py construction) and that eigenvalue."""
    a = rng.standard_normal((*shape, n, n))
    u = rng.standard_normal((*shape, n))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    s = (a + np.swapaxes(a, -1, -2)) / 2 + 8.0 * n * u[..., :, None] * u[..., None, :]
    w = np.linalg.eigvalsh(s)
    dom = np.take_along_axis(w, np.argmax(np.abs(w), axis=-1)[..., None], -1)[..., 0]
    return s, dom


def _storage(full, layout):
    """``full`` (..., n, n) in one storage class (diagonal and scaled
    identity keep its diagonal, and its first diagonal entry)."""
    n = full.shape[-1]
    if layout == "compact":
        return _compact(full)
    if layout == "full":
        return full.reshape(*full.shape[:-2], n * n)
    diag = np.diagonal(full, axis1=-2, axis2=-1)
    return diag if layout == "diagonal" else diag[..., :1]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.ndim == 0 or got.shape[-1] == 0:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        return
    err = np.linalg.norm(got - want, axis=-1)
    scale = np.maximum(np.linalg.norm(want, axis=-1), 1e-300)
    assert (err <= tol * scale).all(), (err / scale).max()


def _port_chain(mat, vec, iters, add, backend="auto"):
    return _np(T.sym_matvec_chain(_t(mat), _t(vec), iters,
                                  add=None if add is None else _t(add), backend=backend))


def _ref_chain(mat, vec, iters, add, backend):
    return np.asarray(F.sym_matvec_chain(jnp.asarray(mat), jnp.asarray(vec), iters,
                                         add=None if add is None else jnp.asarray(add),
                                         backend=backend))


# --- sym_matvec_chain ----------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 4, 6, 9, 12])
def test_matvec_chain_compact_matches_kernel(n, rng):
    """Compact input: the fused path (iters > 1) against the interpreted
    Pallas kernel, iters 0 and 1 against the reference's XLA path."""
    mat = _compact(_contraction(rng, (2, 3), n))
    vec, add = rng.standard_normal((2, 3, n)), rng.standard_normal((3, n))
    for iters, c, ref_backend in ((3, None, "pallas"), (16, add, "pallas"),
                                  (0, add, "xla"), (1, None, "xla"), (1, add, "xla")):
        want = _ref_chain(mat, vec, iters, c, ref_backend)
        for backend in ("auto", "torch"):
            _close(_port_chain(mat, vec, iters, c, backend), want)


@pytest.mark.parametrize("layout", ["diagonal", "scaled", "full"])
@pytest.mark.parametrize("n", [3, 6])
def test_matvec_chain_other_storage_matches_reference(layout, n, rng):
    mat = _storage(_contraction(rng, (4,), n), layout)
    vec, add = rng.standard_normal((4, n)), rng.standard_normal((4, n))
    for iters, c in ((0, None), (1, add), (3, None), (16, add)):
        _close(_port_chain(mat, vec, iters, c), _ref_chain(mat, vec, iters, c, "xla"))


def test_matvec_chain_cf_matches_pallas(rng):
    for n in (4, 9):
        mat = _compact(_contraction(rng, (5,), n)).T.reshape(-1, 1, 5)
        vec, add = rng.standard_normal((n, 2, 1)), rng.standard_normal((n, 1, 5))
        want = np.asarray(pallas_chain_cf(jnp.asarray(mat), jnp.asarray(vec), 7,
                                          add=jnp.asarray(add), block=BLOCK))
        got = K.sym_matvec_chain_cf(_t(mat), _t(vec), 7, add=_t(add))
        assert got.shape == (n, 2, 5)
        _close(np.moveaxis(_np(got), 0, -1), np.moveaxis(want, 0, -1))


@pytest.mark.parametrize("n", [16, 32])
def test_matvec_chain_cf_lane_group_sizes_match_pallas(n, rng):
    """The lane-group chain's two group sizes (16 lanes to n = 16, 32
    above): 3 steps on a batch of 8 against the interpreted Pallas kernel
    and the float64 numpy recurrence."""
    full = _contraction(rng, (8,), n)
    mat = _compact(full).T
    vec, add = rng.standard_normal((n, 8)), rng.standard_normal((n, 8))
    want = np.asarray(pallas_chain_cf(jnp.asarray(mat), jnp.asarray(vec), 3,
                                      add=jnp.asarray(add), block=BLOCK))
    got = _np(K.sym_matvec_chain_cf(_t(mat), _t(vec), 3, add=_t(add)))
    x = vec.T
    for _ in range(3):
        x = np.einsum("bij,bj->bi", full, x) + add.T
    _close(got.T, want.T)
    _close(got.T, x)


@pytest.mark.parametrize("n", [3, 9])
def test_matvec_chain_grad_matches_jax(n, rng):
    mat = _compact(_contraction(rng, (6,), n))
    vec, add = rng.standard_normal((6, n)), rng.standard_normal((6, n))
    w = rng.standard_normal((6, n))

    def loss(m, v, c):
        return jnp.sum(F.sym_matvec_chain(m, v, 5, add=c) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (mat, vec, add)))
    ins = [_t(x).requires_grad_() for x in (mat, vec, add)]
    got = torch.autograd.grad((T.sym_matvec_chain(*ins[:2], 5, add=ins[2]) * _t(w)).sum(), ins)
    for g, wg in zip(got, want):
        _close(_np(g), np.asarray(wg))


def test_matvec_chain_cuda_gate_raises_on_cpu(rng):
    mat = _t(_compact(_contraction(rng, (2,), 3)))
    vec = _t(rng.standard_normal((2, 3)))
    for iters in (0, 1, 4):
        with pytest.raises(ValueError, match="CUDA"):
            T.sym_matvec_chain(mat, vec, iters, backend="cuda")
    with pytest.raises(ValueError, match="kernel serves"):
        T.sym_matvec_chain(vec, vec, 2, backend="cuda")  # diagonal storage
    with pytest.raises(ValueError, match="iters"):
        T.sym_matvec_chain(mat, vec, -1)
    with pytest.raises(ValueError, match="backend"):
        T.sym_matvec_chain(mat, vec, 2, backend="pallas")


# --- sym_maxeig ----------------------------------------------------------------


def _port_maxeig(mat, v0, **kw):
    mu, v = T.sym_maxeig(_t(mat), v0=None if v0 is None else _t(v0), return_vector=True, **kw)
    return _np(mu), _np(v)


def _ref_maxeig(mat, v0, **kw):
    mu, v = F.sym_maxeig(jnp.asarray(mat), v0=None if v0 is None else jnp.asarray(v0),
                         return_vector=True, **kw)
    return np.asarray(mu), np.asarray(v)


# (n, [(renorm_every, iters), ...]): each renorm_every and each iters at
# n = 4 (the unrolled tier) and at n = 12 (the rolled one); one pair
# each elsewhere
MAXEIG_CASES = [(1, [(8, 5)]), (2, [(1, 40)]), (6, [(16, 5)]), (9, [(8, 40)]),
                (4, [(1, 5), (8, 40), (16, 0)]), (12, [(1, 40), (8, 0), (16, 5)])]


@pytest.mark.parametrize("n,cases", MAXEIG_CASES, ids=[str(n) for n, _ in MAXEIG_CASES])
def test_maxeig_matches_kernel(n, cases, rng):
    """Compact input with an explicit v0 against the interpreted Pallas
    kernel: the (mu, v) form, every renorm_every, iters 0 included."""
    s, _ = _gapped(rng, (7,), n)
    mat, v0 = _compact(s), rng.standard_normal((7, n))
    for r, iters in cases:
        want = _ref_maxeig(mat, v0, iters=iters, renorm_every=r, backend="pallas")
        for backend in ("auto", "torch"):
            got = _port_maxeig(mat, v0, iters=iters, renorm_every=r, backend=backend)
            if iters == 0 and backend == "auto":
                continue  # the port's auto takes the other path at iters = 0, as the reference's
            for g, w in zip(got, want):
                _close(g[..., None] if g.ndim == 1 else g, w[..., None] if w.ndim == 1 else w)


def test_maxeig_zero_matrix_and_iters0(rng):
    """A zero matrix gives mu = 0 and a finite vector on both paths; at
    iters = 0 the auto path (the reference's other path) gives the
    normalized start vector's Rayleigh quotient."""
    v0 = rng.standard_normal((3, 4))
    zero = np.zeros((3, 10))
    for backend, ref in (("torch", "pallas"), ("auto", "xla")):
        mu, v = _port_maxeig(zero, v0, iters=6, backend=backend)
        rmu, rv = _ref_maxeig(zero, v0, iters=6, backend=ref)
        assert (mu == 0).all() and np.isfinite(v).all()
        _close(v, rv)
        np.testing.assert_array_equal(mu, rmu)
    s, _ = _gapped(rng, (3,), 4)
    for g, w in zip(_port_maxeig(_compact(s), v0, iters=0),
                    _ref_maxeig(_compact(s), v0, iters=0, backend="xla")):
        _close(g[..., None] if g.ndim == 1 else g, w[..., None] if w.ndim == 1 else w)


@pytest.mark.parametrize("layout", ["diagonal", "scaled", "full"])
def test_maxeig_other_storage_matches_reference(layout, rng):
    """v0 pins N and with it the storage class, served by the
    reference's other path (max |entry| pre-scale, per-step norm)."""
    n = 3
    s, _ = _gapped(rng, (5,), n)
    mat, v0 = _storage(s, layout), rng.standard_normal((5, n))
    for iters in (0, 7, 30):
        got = _port_maxeig(mat, v0, iters=iters)
        want = _ref_maxeig(mat, v0, iters=iters, backend="xla")
        for g, w in zip(got, want):
            _close(g[..., None] if g.ndim == 1 else g, w[..., None] if w.ndim == 1 else w)


@pytest.mark.parametrize("n", [2, 4, 8, 12])
def test_maxeig_default_start_converges_to_eigvalsh(n, rng):
    """The default start vector (a fixed torch.Generator draw, not the
    reference's) converges to float64 eigvalsh's dominant eigenvalue;
    the vector is a unit eigenvector."""
    s, dom = _gapped(rng, (2, 3), n)
    mu, v = T.sym_maxeig(_t(_compact(s)), iters=120, return_vector=True)
    assert mu.shape == (2, 3) and v.shape == (2, 3, n)
    np.testing.assert_allclose(_np(mu), dom, rtol=1e-10)
    res = np.linalg.norm(np.einsum("...ij,...j->...i", s, _np(v)) - _np(mu)[..., None] * _np(v),
                         axis=-1)
    assert res.max() < 1e-8 * np.abs(dom).max()
    np.testing.assert_allclose(np.linalg.norm(_np(v), axis=-1), 1.0, rtol=1e-12)
    # N read from the flat size (compact) without v0, as in the reference
    np.testing.assert_allclose(_np(T.sym_maxeig(_t(_compact(s)), iters=120)),
                               np.asarray(F.sym_maxeig(jnp.asarray(_compact(s)), iters=120)),
                               rtol=1e-10)


def test_maxeig_cf_matches_pallas(rng):
    s, _ = _gapped(rng, (6,), 4)
    mat = _compact(s).T.reshape(10, 1, 6)
    v0 = rng.standard_normal((4, 2, 1))
    want = np.asarray(pallas_maxeig_cf(jnp.asarray(mat), jnp.asarray(v0), 9, block=BLOCK,
                                       renorm_every=4))
    got = K.sym_maxeig_cf(_t(mat), _t(v0), 9, renorm_every=4)
    assert got.shape == (5, 2, 6)
    _close(np.moveaxis(_np(got), 0, -1), np.moveaxis(want, 0, -1))


@pytest.mark.parametrize("n,ref_backend", [(4, "pallas"), (9, "xla")])
def test_maxeig_grad_matches_jax(n, ref_backend, rng):
    s, _ = _gapped(rng, (5,), n)
    mat, v0 = _compact(s), rng.standard_normal((5, n))
    wmu, wv = rng.standard_normal(5), rng.standard_normal((5, n))

    def loss(m, v):
        mu, vec = F.sym_maxeig(m, iters=12, v0=v, return_vector=True, backend=ref_backend,
                               renorm_every=3)
        return jnp.sum(mu * wmu) + jnp.sum(vec * wv)

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(mat), jnp.asarray(v0))
    ins = [_t(x).requires_grad_() for x in (mat, v0)]
    mu, vec = T.sym_maxeig(ins[0], iters=12, v0=ins[1], return_vector=True, renorm_every=3)
    got = torch.autograd.grad((mu * _t(wmu)).sum() + (vec * _t(wv)).sum(), ins)
    for g, w in zip(got, want):
        _close(_np(g), np.asarray(w), 1e-10)


def test_maxeig_checks(rng):
    mat = _t(_compact(_gapped(rng, (2,), 3)[0]))
    with pytest.raises(ValueError, match="renorm_every"):
        T.sym_maxeig(mat, renorm_every=17)
    with pytest.raises(ValueError, match="renorm_every"):
        K.sym_maxeig_cf(mat.t(), torch.ones(3, 2), renorm_every=0)
    with pytest.raises(ValueError, match="iters"):
        T.sym_maxeig(mat, iters=-1)
    with pytest.raises(ValueError, match="CUDA"):
        T.sym_maxeig(mat, iters=0, backend="cuda")
    with pytest.raises(ValueError, match="kernel serves"):
        T.sym_maxeig(mat[:, :3], v0=torch.ones(3, dtype=mat.dtype), backend="cuda")
    with pytest.raises(ValueError, match="expects mat"):
        K.sym_matvec_chain_cf(mat.t(), torch.ones(4, 2))
