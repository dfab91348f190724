"""The port's batched full-storage ops (``batchinv``, ``batchlmdiv``,
``batchrmdiv``) and the solves on full storage and compact N > 32
against ``fastmath_tpu`` (JAX, CPU).

On the CPU the kernel wrappers run their plain PyTorch versions. The
public ops are held against the reference's XLA path with both port
backends: ``"auto"`` (the kernels' plain versions in their domain) and
``"torch"`` (the plain tiers, the counterpart of that XLA path). The
wrappers are held against the reference's Pallas kernels run in
interpret mode, which fixes the kernel path's tiers and pivoting; the
gradients against ``jax.grad``. Tolerances: float64 ``rtol=1e-9`` with
``atol=1e-12 * max|want|`` (entries of an inverse can be near zero; the
two packages differ in operation order only), bf16 one bf16 ulp (both
compute in float32 and round once).

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_batched_cuda.py`` and ``chip_smoke.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastmath_tpu as F
from fastmath_tpu.kernels import inv_cf as pallas_inv_cf
from fastmath_tpu.kernels import solve_full_cf as pallas_solve_full_cf

import fastmath_tpu_torch as T
from fastmath_tpu_torch import kernels as K
from fastmath_tpu_torch.kernels import _gen_adjugate

from _torch_cpu import one_thread  # noqa: F401  (autouse)

RTOL = 1e-9
BLOCK = 128  # interpret-mode block of the Pallas kernels
NS = [1, 2, 3, 4, 5, 8, 9, 12, 20]  # closed form, unrolled PLU, rolled, past 16


def _general(rng, shape, n):
    return rng.standard_normal((*shape, n, n)) + n * np.eye(n)


def _pivoting(rng, shape, n):
    """Rows of a general matrix in a random order: partial pivoting swaps
    rows at most steps, not only the first."""
    a = _general(rng, shape, n)
    perm = np.argsort(rng.random((*shape, n)), axis=-1)
    return np.take_along_axis(a, perm[..., None], axis=-2)


MATRICES = {"general": _general, "pivoting": _pivoting}


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12 * np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _jitted(fn, kw):
    return jax.jit(functools.partial(fn, **dict(kw)))


def _jax(fn, *arrays, **kw):
    """``fn`` on the arrays, jitted once per function and shape (cheaper
    than eager op-by-op dispatch); a tuple of results comes back as a
    list of numpy arrays."""
    out = _jitted(fn, tuple(sorted(kw.items())))(*(jnp.asarray(a) for a in arrays))
    return [np.asarray(o) for o in out] if isinstance(out, tuple) else np.asarray(out)


def _lm_rm(a, v, b, r):
    return F.batchlmdiv(a, v), F.batchlmdiv(a, b), F.batchrmdiv(r, a)


def _port(fn, *arrays, **kw):
    out = fn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays), **kw)
    return out.detach().numpy()


def _compact(full):
    n = full.shape[-1]
    rows, cols = np.triu_indices(n, k=1)
    return np.concatenate([np.diagonal(full, axis1=-2, axis2=-1),
                           full[..., rows, cols]], axis=-1)


def test_full_adjugate_header_is_generated():
    assert _gen_adjugate.FULL_HEADER.read_text() == _gen_adjugate.render_full()


# --- public ops against the reference's XLA path -----------------------------


@pytest.mark.parametrize("kind", sorted(MATRICES))
@pytest.mark.parametrize("n", NS)
def test_batchinv_matches_reference(n, kind, rng):
    a = MATRICES[kind](rng, (2, 3), n)
    want = _jax(F.batchinv, a)
    for backend in ("auto", "torch"):
        _close(_port(T.batchinv, a, backend=backend), want)


@pytest.mark.parametrize("kind", sorted(MATRICES))
@pytest.mark.parametrize("n", NS)
def test_batchlmdiv_rmdiv_match_reference(n, kind, rng):
    # broadcast batches: one matrix per column of the batch against
    # right-hand sides per row; a vector and a 3-column matrix
    a = MATRICES[kind](rng, (1, 4), n)
    v = rng.standard_normal((3, 1, n))
    b = rng.standard_normal((3, 1, n, 3))
    r = rng.standard_normal((3, 1, 2, n))
    want = _jax(_lm_rm, a, v, b, r)
    assert want[0].shape == (3, 4, n) and want[2].shape == (3, 4, 2, n)
    for backend in ("auto", "torch"):
        got = [_port(T.batchlmdiv, a, v, backend=backend),
               _port(T.batchlmdiv, a, b, backend=backend),
               _port(T.batchrmdiv, r, a, backend=backend)]
        for g, w in zip(got, want):
            _close(g, w)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_regularize_closed_form(n, rng):
    # a singular integer matrix (rank one from n = 2): its determinant is
    # exactly 0, so only the range regularizer keeps the inverse finite
    u = rng.integers(1, 4, (2, n))
    a = np.stack([_general(rng, (), n), np.outer(u[0], u[1]).astype(np.float64)])
    v = rng.standard_normal((2, n))
    want = _jax(F.batchinv, a, regularize=True)
    if n > 1:
        assert np.isfinite(want).all()
    for backend in ("auto", "torch"):
        _close(_port(T.batchinv, a, regularize=True, backend=backend), want)
        _close(_port(T.batchlmdiv, a, v, regularize=True, backend=backend),
               _jax(F.batchlmdiv, a, v, regularize=True))


def test_rhs_cap_and_regularize_under_cuda_backend(rng):
    a5, a9 = (torch.from_numpy(_general(rng, (4,), n)) for n in (5, 9))
    b5 = torch.from_numpy(rng.standard_normal((4, 5, 9)))  # k = 9 > 8
    b9 = torch.from_numpy(rng.standard_normal((4, 9, 17)))  # k = 17 > 16
    with pytest.raises(ValueError, match="caps RHS columns at 8"):
        T.batchlmdiv(a5, b5, backend="cuda")
    with pytest.raises(ValueError, match="caps RHS columns at 16"):
        T.batchlmdiv(a9, b9, backend="cuda")
    with pytest.raises(ValueError, match="regularize"):
        T.batchlmdiv(a5, b5[..., 0], regularize=True, backend="cuda")
    with pytest.raises(ValueError, match="regularize"):
        T.batchinv(a5, regularize=True, backend="cuda")
    # the forced kernel needs CUDA tensors and 1 <= n <= 32
    with pytest.raises(ValueError, match="CUDA"):
        T.batchinv(a5, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        T.batchlmdiv(a9, b9[..., 0], backend="cuda")
    with pytest.raises(ValueError, match="kernel serves"):
        T.batchinv(torch.eye(33, dtype=torch.float64), backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        T.batchinv(a5, backend="xla")
    # past the cap "auto" takes the plain tiers
    for a, b in ((a5, b5), (a9, b9)):
        _close(T.batchlmdiv(a, b).numpy(), _jax(F.batchlmdiv, a.numpy(), b.numpy()))


@pytest.mark.parametrize("n", [3, 6])
def test_bf16_in_bf16_out(n, rng):
    a = _general(rng, (16,), n).astype(np.float32)
    v = rng.standard_normal((16, n)).astype(np.float32)
    ja, jv = jnp.asarray(a, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    ta = torch.from_numpy(np.array(ja.astype(jnp.float32))).to(torch.bfloat16)
    tv = torch.from_numpy(np.array(jv.astype(jnp.float32))).to(torch.bfloat16)
    for got, want in ((T.batchinv(ta), _jitted(F.batchinv, ())(ja)),
                      (T.batchlmdiv(ta, tv), _jitted(F.batchlmdiv, ())(ja, jv))):
        assert got.dtype == torch.bfloat16
        want = np.asarray(want.astype(jnp.float32))
        # the float32 results differ by a few ulp, which can flip one
        # rounding to bf16: one bf16 ulp (2^-7)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                                   atol=2.0 ** -7 * np.abs(want).max())


@pytest.mark.parametrize("n", [3, 6, 12])
def test_grads_match_jax(n, rng):
    # the inverse and a two-column solve: the vector solve goes through
    # the same autograd.Function
    a = _pivoting(rng, (6,), n)
    b = rng.standard_normal((6, n, 2))
    w = [rng.standard_normal(s) for s in ((6, n, n), (6, n, 2))]

    def jloss(a_, b_):
        return jnp.sum(F.batchinv(a_) * w[0]) + jnp.sum(F.batchlmdiv(a_, b_) * w[1])

    want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(a), jnp.asarray(b))
    for backend in ("auto", "torch"):
        ins = [torch.from_numpy(x).requires_grad_() for x in (a, b)]
        ws = [torch.from_numpy(x) for x in w]
        loss = ((T.batchinv(ins[0], backend=backend) * ws[0]).sum()
                + (T.batchlmdiv(*ins, backend=backend) * ws[1]).sum())
        for g, wg in zip(torch.autograd.grad(loss, ins), want):
            _close(g.numpy(), np.asarray(wg))


@pytest.mark.parametrize("n", [5, 10])
def test_badly_scaled_rows_swap_exactly(n):
    """Rows of very different scale: the reference's XLA tier (5..16) and
    its rolled Pallas tier (9..32) swap rows by adding their difference,
    which loses the small row's entries (ROADMAP, Faults); the port swaps
    them exactly and is held against float64 numpy here."""
    a = np.eye(n)
    a[0, :2], a[1, :2] = (1e-20, 1e20), (1.0, 1.0)
    b = np.arange(1.0, n + 1)
    b[0] = 1e20  # x = (1, 1, 3, 4, ...): the lost entry of row 1 matters
    want = np.linalg.solve(a, b)
    for backend in ("auto", "torch"):
        _close(_port(T.batchlmdiv, a[None], b[None], backend=backend)[0], want)
        _close(_port(T.batchinv, a[None], backend=backend)[0], np.linalg.inv(a))
    got = K.solve_full_cf(torch.from_numpy(a.reshape(-1, 1)), torch.from_numpy(b[:, None]))
    _close(got.numpy()[:, 0], want)


# --- the wrappers (plain path) against the interpreted Pallas kernels --------


@pytest.mark.parametrize("n", [3, 5, 9])
def test_kernels_match_pallas(n, rng):
    a = _pivoting(rng, (48,), n).reshape(48, n * n)
    mat = np.ascontiguousarray(a.T)
    before = (K.solve_full_cf.launches, K.inv_cf.launches)
    want = np.asarray(pallas_inv_cf(jnp.asarray(mat), block=BLOCK, interpret=True))
    _close(K.inv_cf(torch.from_numpy(mat)).numpy(), want)
    for k in (2,):
        rhs = rng.standard_normal((n * k, 48))
        want = np.asarray(pallas_solve_full_cf(jnp.asarray(mat), jnp.asarray(rhs), k=k,
                                               block=BLOCK, interpret=True))
        got = K.solve_full_cf(torch.from_numpy(mat), torch.from_numpy(rhs), k=k).numpy()
        _close(got, want)
        exact = np.linalg.solve(a.reshape(48, n, n), rhs.T.reshape(48, n, k))
        _close(got, exact.reshape(48, n * k).T)
    assert (K.solve_full_cf.launches, K.inv_cf.launches) == before  # CPU: plain


def test_wrapper_errors(rng):
    mat = torch.from_numpy(rng.standard_normal((9, 4)))
    with pytest.raises(ValueError, match=r"\(n\*n, \.\.\.\) rows"):
        K.inv_cf(mat[:8])
    with pytest.raises(ValueError, match="n <= 32"):
        K.solve_full_cf(torch.zeros(33 * 33, 2), torch.zeros(33, 2))
    with pytest.raises(ValueError, match=r"rhs \(6, \.\.\.\) for k=2"):
        K.solve_full_cf(mat, mat[:5], k=2)
    with pytest.raises(ValueError, match="real floats"):
        K.inv_cf(mat.to(torch.complex128))
    from fastmath_tpu_torch.kernels import batched_cuda

    with pytest.raises(ValueError, match="CUDA"):
        batched_cuda.launch_inv(mat.t())
    with pytest.raises(ValueError, match="CUDA"):
        batched_cuda.launch_solve_full(mat.t(), mat.t()[:, :3], 1)


# --- sym_solve / sym_solve_chain on full storage and compact N > 32 ----------


@pytest.mark.parametrize("refine", [None, 0, 1])
@pytest.mark.parametrize("storage,n", [("full", 3), ("full", 6), ("compact", 33)])
def test_sym_solve_dense_storage(storage, n, refine, rng):
    a = _general(rng, (1, 3), n)
    full = a @ np.swapaxes(a, -1, -2) + n * np.eye(n)
    mat = full.reshape(1, 3, n * n) if storage == "full" else _compact(full)
    v, c = rng.standard_normal((2, 1, n)), rng.standard_normal((2, 3, n))
    eps = (0.3, 0.1)

    def reference(m, x, a):
        # the reference takes refine=None as 0 on these storage classes
        return (F.sym_solve(m, x, eps=eps, refine=refine or 0),
                F.sym_solve_chain(m, x, iters=3, add=a, eps=eps))

    want = _jax(reference, mat, v, c)
    _close(_port(T.sym_solve, mat, v, eps=eps, refine=refine), want[0])
    _close(_port(T.sym_solve_chain, mat, v, 3, add=c, eps=eps), want[1])
