"""The port's CUDA-kernel wrappers (``fastmath_tpu_torch.kernels``) against
the reference's Pallas kernels, and their gradients.

On the CPU each wrapper runs its kernel's plain PyTorch version; it is
held against ``fastmath_tpu.kernels.sym_solve_cf`` / ``sym_solve_chain_cf``
run in interpret mode (as ``tests/test_sym_pallas.py`` runs them), which
fixes the kernel path's semantics: ``refine`` defaults, tiers, pivoting.
float64 throughout, ``rtol=1e-9``: the two run the same algorithm and
differ in operation order only.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_sym_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastmath_tpu as F
from fastmath_tpu.kernels import sym_solve_cf as pallas_solve_cf
from fastmath_tpu.kernels import sym_solve_chain_cf as pallas_chain_cf

import fastmath_tpu_torch as T
from fastmath_tpu_torch.kernels import _gen_adjugate, sym_cuda
from fastmath_tpu_torch.kernels import sym_solve_cf, sym_solve_chain_cf

RTOL = 1e-9
BLOCK = 256  # interpret-mode block of the Pallas kernels
NS = [1, 3, 4, 6, 12]  # N = 1, the adjugate, the unrolled and the rolled tier


def _compact(full):
    n = full.shape[-1]
    rows, cols = np.triu_indices(n, k=1)
    return np.concatenate([np.diagonal(full, axis1=-2, axis2=-1),
                           full[..., rows, cols]], axis=-1)


def _spd(rng, b, n):
    a = rng.standard_normal((b, n, n))
    return np.einsum("...ij,...kj->...ik", a, a) + n * np.eye(n)


def _indefinite(rng, b, n):
    """Symmetric, indefinite, well conditioned: partial pivoting swaps rows
    at every step, not only the first."""
    q, _ = np.linalg.qr(rng.standard_normal((b, n, n)))
    w = rng.uniform(0.5, 3.0, (b, n)) * np.where(
        rng.standard_normal((b, n)) > 0, 1.0, -1.0)
    return np.einsum("...ik,...k,...jk->...ij", q, w, q)


def _cf(a):
    """Batch-major numpy (B, K) -> channel-first (K, B) array."""
    return np.ascontiguousarray(a.T)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _oracle_chain(full, v, c, iters):
    x = v
    for _ in range(iters):
        x = np.linalg.solve(full, x[..., None])[..., 0] + c
    return x


# --- the generated cofactor header matches its generator ---------------------


def test_adjugate_header_is_generated():
    assert _gen_adjugate.HEADER.read_text() == _gen_adjugate.render()


# --- wrappers (plain path) against the interpreted Pallas kernels ------------


@pytest.mark.parametrize("n", NS)
def test_solve_cf_matches_pallas(n, rng):
    full = _spd(rng, 130, n)
    mat, vec = _cf(_compact(full)), _cf(rng.standard_normal((130, n)))
    want = np.asarray(pallas_solve_cf(jnp.asarray(mat), jnp.asarray(vec),
                                      block=BLOCK, interpret=True))
    before = sym_solve_cf.launches
    got = sym_solve_cf(_t(mat), _t(vec)).numpy()
    assert sym_solve_cf.launches == before  # CPU tensors: plain version
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12)
    exact = np.linalg.solve(full, vec.T[..., None])[..., 0].T
    np.testing.assert_allclose(got, exact, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("n,refine", [(4, 2), (6, 1), (12, 1)])
def test_solve_cf_eps_refine_batch_dims(n, refine, rng):
    # channel-first with two batch dims, per-channel eps, refinement: at
    # N = 5..8 a re-solve of the residual, above 8 the explicit inverse
    eps = (0.5, 0.1)
    mat = np.moveaxis(_compact(_spd(rng, 130, n)).reshape(2, 65, -1), -1, 0)
    vec = rng.standard_normal((n, 2, 65))
    want = np.asarray(pallas_solve_cf(jnp.asarray(mat), jnp.asarray(vec), eps=eps,
                                      refine=refine, block=BLOCK, interpret=True))
    got = sym_solve_cf(_t(mat), _t(vec), eps=eps, refine=refine).numpy()
    assert got.shape == (n, 2, 65)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("n", NS)
def test_chain_cf_matches_pallas(n, rng):
    full = _spd(rng, 130, n)
    mat = _cf(_compact(full))
    vec, add = _cf(rng.standard_normal((130, n))), _cf(rng.standard_normal((130, n)))
    want = np.asarray(pallas_chain_cf(jnp.asarray(mat), jnp.asarray(vec), iters=3,
                                      add=jnp.asarray(add), eps=0.2,
                                      block=BLOCK, interpret=True))
    got = sym_solve_chain_cf(_t(mat), _t(vec), iters=3, add=_t(add), eps=0.2).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12)
    exact = _oracle_chain(full + 0.2 * np.eye(n), vec.T, add.T, 3).T
    np.testing.assert_allclose(got, exact, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("n", [5, 6, 8])
def test_pivoting_tier_indefinite(n, rng):
    """Indefinite matrices pivot at later steps too. The solve matches the
    reference; the chain is held against the float64 numpy recurrence,
    because the reference's recorded-PLU chain replays its row swaps
    against multipliers that later swaps have moved (ROADMAP, Faults)."""
    full = _indefinite(rng, 130, n)
    mat, vec = _cf(_compact(full)), _cf(rng.standard_normal((130, n)))
    add = _cf(rng.standard_normal((130, n)))
    want = np.asarray(pallas_solve_cf(jnp.asarray(mat), jnp.asarray(vec),
                                      block=BLOCK, interpret=True))
    got = sym_solve_cf(_t(mat), _t(vec)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12)
    got = sym_solve_chain_cf(_t(mat), _t(vec), iters=4, add=_t(add)).numpy()
    exact = _oracle_chain(full, vec.T, add.T, 4).T
    np.testing.assert_allclose(got, exact, rtol=1e-8, atol=1e-10)


def test_wrapper_errors(rng):
    mat, vec = _t(_cf(_compact(_spd(rng, 4, 3)))), _t(rng.standard_normal((3, 4)))
    with pytest.raises(ValueError, match="expects mat"):
        sym_solve_cf(mat[:5], vec)
    with pytest.raises(ValueError, match="N <= 32"):
        sym_solve_cf(torch.zeros(33 * 34 // 2, 2, dtype=torch.float64),
                     torch.zeros(33, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="iters"):
        sym_solve_chain_cf(mat, vec, iters=-1)
    with pytest.raises(ValueError, match="CUDA"):
        sym_cuda.launch_solve(mat.t(), vec.t())
    with pytest.raises(ValueError, match="CUDA"):
        sym_cuda.launch_chain(mat.t(), vec.t(), None, None, 3)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    from fastmath_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)  # nothing built yet
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


# --- gradients against jax.grad of the reference's kernel path ---------------


@pytest.mark.parametrize("n", [3, 6])
def test_solve_grad_matches_jax(n, rng):
    cm, v = _compact(_spd(rng, 40, n)), rng.standard_normal((40, n))
    w = rng.standard_normal((40, n))

    def jloss(m, x):
        return jnp.sum(F.sym_solve(m, x, eps=0.1, backend="pallas") * w)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(cm), jnp.asarray(v))
    m, x = _t(cm).requires_grad_(), _t(v).requires_grad_()
    loss = (T.sym_solve(m, x, eps=0.1) * _t(w)).sum()
    got = torch.autograd.grad(loss, (m, x))
    for g, wg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("n", [3, 6])
def test_chain_grad_matches_jax(n, rng):
    cm, v = _compact(_spd(rng, 40, n)), rng.standard_normal((40, n))
    c, w = rng.standard_normal((40, n)), rng.standard_normal((40, n))

    def jloss(m, x, a):
        return jnp.sum(F.sym_solve_chain(m, x, iters=3, add=a,
                                         backend="pallas") * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(cm), jnp.asarray(v), jnp.asarray(c))
    ins = [_t(a).requires_grad_() for a in (cm, v, c)]
    loss = (T.sym_solve_chain(*ins[:2], iters=3, add=ins[2]) * _t(w)).sum()
    got = torch.autograd.grad(loss, ins)
    for g, wg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=RTOL, atol=1e-12)


def test_cf_grad_matches_finite_differences(rng):
    mat = _t(_cf(_compact(_spd(rng, 5, 3)))).requires_grad_()
    vec = _t(rng.standard_normal((3, 5))).requires_grad_()
    add = _t(rng.standard_normal((3, 5))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda m, v: sym_solve_cf(m, v, eps=0.1), (mat, vec))
    assert torch.autograd.gradcheck(
        lambda m, v, a: sym_solve_chain_cf(m, v, iters=2, add=a), (mat, vec, add))
