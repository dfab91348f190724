"""The port's compact-symmetric products (``sym_matvec``, ``sym_addmatvec`` /
``sym_submatvec``, ``sym_outer``, ``sym_matmul`` JᵀHJ) against
``fastmath_tpu`` (JAX, CPU).

On the CPU every kernel wrapper runs its plain PyTorch version. The
wrappers are held against the reference's Pallas kernels run in interpret
mode, which fixes the kernel path's semantics (term order, the two JᵀHJ
tiers); the public ops against the reference's XLA path on every storage
class; gradients against ``jax.grad`` of the reference's kernel path.
Tolerances: float64 ``rtol=1e-9`` (the same sums, in the same or another
order), bf16 one bf16 ulp (both compute in float32 and round once).

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_sym_products_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastmath_tpu as F
from fastmath_tpu.kernels import sym_addmatvec_cf as pallas_addmatvec_cf
from fastmath_tpu.kernels import sym_matmul_cf as pallas_matmul_cf
from fastmath_tpu.kernels import sym_matvec_cf as pallas_matvec_cf
from fastmath_tpu.kernels import sym_outer_cf as pallas_outer_cf
from fastmath_tpu.kernels import sym_submatvec_cf as pallas_submatvec_cf

import fastmath_tpu_torch as T
from fastmath_tpu_torch import kernels as K
from fastmath_tpu_torch.kernels import sym_products

from _torch_cpu import one_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-9, 1e-12
BLOCK = 256  # interpret-mode block of the Pallas kernels
NS = [1, 3, 4, 8, 12]  # the unrolled tier up to 8, the rolled one above
JHJ_KD = [(3, 2), (4, 4), (7, 3), (12, 12)]  # both JᵀHJ tiers


def _compact(full):
    n = full.shape[-1]
    rows, cols = np.triu_indices(n, k=1)
    return np.concatenate([np.diagonal(full, axis1=-2, axis2=-1),
                           full[..., rows, cols]], axis=-1)


def _sym(rng, shape, n):
    a = rng.standard_normal((*shape, n, n))
    return a + np.swapaxes(a, -1, -2)


def _jac_cf(J):
    """``J (..., K, D)`` as the ``(K*D, B)`` channel-first operand that both
    packages' ``sym_matmul_cf`` read: row-major (a, i) -> channel a*D + i,
    the batch flattened onto the second axis."""
    k, d = J.shape[-2:]
    return np.ascontiguousarray(J.reshape(-1, k * d).T)


def _cf(a):
    """Batch-major (B, C) -> channel-first (C, B)."""
    return np.ascontiguousarray(a.T)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax(fn, *arrays, **kw):
    return np.asarray(fn(*(jnp.asarray(a) for a in arrays), **kw))


def _port(fn, *arrays, **kw):
    return fn(*(_t(a) for a in arrays), **kw).detach().numpy()


def _launches():
    return tuple(f.launches for f in (K.sym_matvec_cf, K.sym_addmatvec_cf,
                                      K.sym_submatvec_cf, K.sym_outer_cf,
                                      K.sym_matmul_cf))


# --- wrappers (plain path) against the interpreted Pallas kernels ------------


@pytest.mark.parametrize("n", NS)
def test_matvec_family_cf_matches_pallas(n, rng):
    mat = _cf(_compact(_sym(rng, (130,), n)))
    vec, acc = _cf(rng.standard_normal((130, n))), _cf(rng.standard_normal((130, n)))
    before = _launches()
    for port, ref, args in (
            (K.sym_matvec_cf, pallas_matvec_cf, (mat, vec)),
            (K.sym_addmatvec_cf, pallas_addmatvec_cf, (acc, mat, vec)),
            (K.sym_submatvec_cf, pallas_submatvec_cf, (acc, mat, vec))):
        want = _jax(ref, *args, block=BLOCK, interpret=True)
        got = _port(port, *args)
        assert got.shape == (n, 130)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert _launches() == before  # CPU tensors: the plain versions
    full = T.layouts.sym_to_full(_t(mat.T)).numpy()
    exact = np.einsum("bij,bj->ib", full, vec.T)
    np.testing.assert_allclose(_port(K.sym_matvec_cf, mat, vec), exact, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("n", NS)
def test_outer_cf_matches_pallas(n, rng):
    # two batch dims, channel-first
    x = rng.standard_normal((n, 2, 65))
    want = _jax(pallas_outer_cf, x, block=BLOCK, interpret=True)
    got = _port(K.sym_outer_cf, x)
    assert got.shape == (n * (n + 1) // 2, 2, 65)
    np.testing.assert_array_equal(got, want)  # one product per slot


@pytest.mark.parametrize("k,d", JHJ_KD)
def test_matmul_cf_matches_pallas(k, d, rng):
    J = rng.standard_normal((130, k, d))
    Hf = _sym(rng, (130,), k)
    j2, h2 = _jac_cf(J), _cf(_compact(Hf))
    want = _jax(pallas_matmul_cf, j2, h2, block=BLOCK, interpret=True)
    before = _launches()
    got = _port(K.sym_matmul_cf, j2, h2)
    assert _launches() == before
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    exact = _compact(np.einsum("bai,bac,bcj->bij", J, Hf, J)).T
    np.testing.assert_allclose(got, exact, rtol=1e-9, atol=1e-11)


def test_cf_wrapper_errors(rng):
    mat, vec = _t(_cf(_compact(_sym(rng, (4,), 3)))), _t(rng.standard_normal((3, 4)))
    with pytest.raises(ValueError, match="expects mat"):
        K.sym_matvec_cf(mat[:5], vec)
    with pytest.raises(ValueError, match="expects mat"):
        K.sym_submatvec_cf(vec, mat[:5], vec)
    with pytest.raises(ValueError, match="N <= 32"):
        K.sym_outer_cf(torch.zeros(33, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="multiple of K"):
        K.sym_matmul_cf(torch.zeros(7, 2, dtype=torch.float64), mat)
    with pytest.raises(ValueError, match="K, D <= 32"):
        K.sym_matmul_cf(torch.zeros(3 * 33, 2, dtype=torch.float64), mat)
    for launch, args in ((sym_products.launch_matvec, (mat.t(), vec.t())),
                         (sym_products.launch_accmatvec, (vec.t(), mat.t(), vec.t(), 1.0)),
                         (sym_products.launch_outer, (vec.t(),)),
                         (sym_products.launch_jhj, (vec.t(), mat.t(), 1))):
        with pytest.raises(ValueError, match="CUDA"):
            launch(*args)


def test_cf_grad_matches_finite_differences(rng):
    mat = _t(_cf(_compact(_sym(rng, (5,), 3)))).requires_grad_()
    vec = _t(rng.standard_normal((3, 5))).requires_grad_()
    acc = _t(rng.standard_normal((3, 5))).requires_grad_()
    assert torch.autograd.gradcheck(K.sym_matvec_cf, (mat, vec))
    assert torch.autograd.gradcheck(K.sym_submatvec_cf, (acc, mat, vec))
    assert torch.autograd.gradcheck(K.sym_outer_cf, (vec,))
    for k, d in ((3, 2), (3, 7)):
        j = _t(rng.standard_normal((k * d, 4))).requires_grad_()
        h = _t(_cf(_compact(_sym(rng, (4,), k)))).requires_grad_()
        assert torch.autograd.gradcheck(K.sym_matmul_cf, (j, h))


# --- public ops against the reference's XLA path, every storage class --------


def _layout_mat(rng, layout, shape):
    """(NN, matrix) for vectors of length N on each storage class."""
    n = {"compact33": 33}.get(layout, 4)
    if layout == "identity":
        return n, rng.uniform(0.5, 2.0, (*shape, 1))
    if layout == "diagonal":
        return n, rng.standard_normal((*shape, n))
    if layout == "full":
        return n, rng.standard_normal((*shape, n * n))  # not symmetric
    return n, _compact(_sym(rng, shape, n))


LAYOUTS = ["identity", "diagonal", "compact", "full", "compact33"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_matvec_family_public_matches_xla(layout, rng):
    # right-aligned batch broadcasting of every operand
    n, mat = _layout_mat(rng, layout, (1, 4))
    vec = rng.standard_normal((3, 1, n))
    acc = rng.standard_normal((4, n))
    cases = ((T.sym_matvec, F.sym_matvec, (mat, vec)),
             (T.sym_addmatvec, F.sym_addmatvec, (acc, mat, vec)),
             (T.sym_submatvec, F.sym_submatvec, (acc, mat, vec)),
             (T.sym_addmatvec_, F.sym_addmatvec, (acc, mat, vec)),
             (T.sym_submatvec_, F.sym_submatvec, (acc, mat, vec)))
    for port, ref, args in cases:
        want = _jax(ref, *args, backend="xla")
        got = _port(port, *args)
        assert got.shape == want.shape == (3, 4, n)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 9, 33])
def test_matvec_compact_every_tier(n, rng):
    # N = 1 (every storage class coincides), the unrolled and rolled
    # kernel tiers, and N = 33 outside the kernel's domain
    mat, vec = _compact(_sym(rng, (6,), n)), rng.standard_normal((6, n))
    for backend in ("auto", "torch"):
        got = _port(T.sym_matvec, mat, vec, backend=backend)
        np.testing.assert_allclose(got, _jax(F.sym_matvec, mat, vec, backend="xla"),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [1, 3, 8, 33])
def test_outer_public_matches_xla(n, rng):
    x = rng.standard_normal((2, 3, n))
    want = _jax(F.sym_outer, x, backend="xla")
    got = _port(T.sym_outer, x)
    assert got.shape == want.shape == (2, 3, n * (n + 1) // 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,d", [(1, 1), (3, 2), (4, 4), (6, 6), (7, 3), (3, 7), (12, 12),
                                 (33, 2)])
def test_matmul_public_matches_xla(k, d, rng):
    J = rng.standard_normal((2, 1, k, d))
    h = _compact(_sym(rng, (3,), k))  # broadcasts against J's batch
    want = _jax(F.sym_matmul, J, h, backend="xla")
    got = _port(T.sym_matmul, J, h)
    assert got.shape == want.shape == (2, 3, d * (d + 1) // 2)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-11)


def test_matmul_k_mismatch_raises(rng):
    with pytest.raises(ValueError, match="compact size"):
        T.sym_matmul(torch.zeros(2, 3, 4), torch.zeros(2, 10))


# --- dtypes -------------------------------------------------------------------


@pytest.mark.parametrize("n", [3, 9])
def test_bf16_in_bf16_out(n, rng):
    def bf16(a):
        j = jnp.asarray(a.astype(np.float32), jnp.bfloat16)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)

    (jm, tm), (jv, tv), (ja, ta) = (bf16(a) for a in (
        _compact(_sym(rng, (32,), n)), rng.standard_normal((32, n)),
        rng.standard_normal((32, n))))
    jj, tj = bf16(rng.standard_normal((32, n, 2)))
    cases = ((F.sym_matvec(jm, jv, backend="xla"), T.sym_matvec(tm, tv)),
             (F.sym_addmatvec(ja, jm, jv, backend="xla"), T.sym_addmatvec(ta, tm, tv)),
             (F.sym_submatvec(ja, jm, jv, backend="xla"), T.sym_submatvec(ta, tm, tv)),
             (F.sym_outer(jv, backend="xla"), T.sym_outer(tv)),
             (F.sym_matmul(jj, jm, backend="xla"), T.sym_matmul(tj, tm)))
    for want, got in cases:
        assert got.dtype == torch.bfloat16
        # float32 results a few ulp apart can round to neighbouring bf16
        # values: one bf16 ulp (2^-7)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=2.0 ** -7, atol=0)


# --- gradients against jax.grad of the reference's kernel path ---------------


@pytest.mark.parametrize("n", [2, 5])
def test_matvec_family_grad_matches_jax(n, rng):
    mat, vec = _compact(_sym(rng, (40,), n)), rng.standard_normal((40, n))
    acc, w = rng.standard_normal((40, n)), rng.standard_normal((40, n))

    def jloss(a, m, v):
        return jnp.sum((F.sym_matvec(m, v, backend="pallas")
                        + F.sym_addmatvec(a, m, v, backend="pallas")
                        - 2.0 * F.sym_submatvec(a, m, v, backend="pallas")) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (acc, mat, vec)))
    ins = [_t(a).requires_grad_() for a in (acc, mat, vec)]
    a, m, v = ins
    loss = ((T.sym_matvec(m, v) + T.sym_addmatvec(a, m, v)
             - 2.0 * T.sym_submatvec(a, m, v)) * _t(w)).sum()
    got = torch.autograd.grad(loss, ins)
    for g, wg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [1, 4])
def test_outer_grad_matches_jax(n, rng):
    x, w = rng.standard_normal((40, n)), rng.standard_normal((40, n * (n + 1) // 2))
    want = jax.grad(lambda y: jnp.sum(F.sym_outer(y, backend="pallas") * w))(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    (got,) = torch.autograd.grad((T.sym_outer(xt) * _t(w)).sum(), xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k,d", [(3, 2), (7, 3)])
def test_matmul_grad_matches_jax(k, d, rng):
    J, h = rng.standard_normal((40, k, d)), _compact(_sym(rng, (40,), k))
    w = rng.standard_normal((40, d * (d + 1) // 2))

    def jloss(jm, hm):
        return jnp.sum(F.sym_matmul(jm, hm, backend="pallas") * w)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(J), jnp.asarray(h))
    ins = [_t(a).requires_grad_() for a in (J, h)]
    got = torch.autograd.grad((T.sym_matmul(*ins) * _t(w)).sum(), ins)
    for g, wg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=RTOL, atol=1e-11)


# --- backends and the iters == 0 repair of sym_solve_chain -------------------


def test_backend_errors(rng):
    cm = torch.from_numpy(_compact(_sym(rng, (4,), 3)))
    v = torch.from_numpy(rng.standard_normal((4, 3)))
    J = torch.from_numpy(rng.standard_normal((4, 3, 2)))
    before = _launches()
    for call in (lambda b: T.sym_matvec(cm, v, backend=b),
                 lambda b: T.sym_addmatvec(v, cm, v, backend=b),
                 lambda b: T.sym_submatvec(v, cm, v, backend=b),
                 lambda b: T.sym_outer(v, backend=b),
                 lambda b: T.sym_matmul(J, cm, backend=b)):
        with pytest.raises(ValueError, match="CUDA"):
            call("cuda")
        with pytest.raises(ValueError, match="backend"):
            call("xla")
        assert torch.equal(call("torch"), call("auto"))
    assert _launches() == before
    # outside the kernels' domain: diagonal and full storage, N or K > 32,
    # complex values
    with pytest.raises(ValueError, match="kernel serves"):
        T.sym_matvec(v, v, backend="cuda")
    with pytest.raises(ValueError, match="kernel serves"):
        T.sym_submatvec(v, torch.ones(4, 9, dtype=torch.float64), v, backend="cuda")
    with pytest.raises(ValueError, match="kernel serves"):
        T.sym_outer(torch.ones(2, 33, dtype=torch.float64), backend="cuda")
    with pytest.raises(ValueError, match="kernel serves"):
        T.sym_matmul(torch.ones(2, 33, 1), torch.ones(2, 33 * 17), backend="cuda")
    with pytest.raises(ValueError, match="kernel serves"):
        T.sym_outer(v.to(torch.complex128), backend="cuda")


def test_solve_chain_iters0_returns_vec_on_every_storage(rng):
    v = rng.standard_normal((4, 3))
    for mat in (rng.standard_normal((4, 9)),  # full storage
                _compact(_sym(rng, (4,), 3)), rng.standard_normal((4, 3))):
        want = _jax(F.sym_solve_chain, mat, v, iters=0)
        got = _port(T.sym_solve_chain, mat, v, iters=0)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, v)
    half = T.sym_solve_chain(torch.ones(4, 9, dtype=torch.bfloat16),
                             _t(v).to(torch.bfloat16), 0)
    assert half.dtype == torch.bfloat16
    # one step on full storage is one densified solve, as in the reference
    full = rng.standard_normal((4, 9)) + 3 * np.eye(3).ravel()
    np.testing.assert_allclose(_port(T.sym_solve_chain, full, v, iters=1),
                               _jax(F.sym_solve_chain, full, v, iters=1), rtol=RTOL, atol=ATOL)
