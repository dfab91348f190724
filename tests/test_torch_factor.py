"""The port's determinants, Cholesky factor and compact inverse
(``batchdet``, ``batchlogdet``, ``batchchol``, ``sym_det``,
``sym_invert``) against ``fastmath_tpu`` (JAX, CPU) and float64 numpy.

On the CPU the kernel wrappers run their plain PyTorch versions. The
public ops are held against the reference's XLA path with both port
backends: ``"auto"`` (the kernels' plain versions in their domain) and
``"torch"`` (the plain tiers). The wrappers are held against the
reference's Pallas kernels run in interpret mode, which fixes the kernel
path's tiers; the gradients against ``jax.grad``. Tolerances, float64:
``1e-10`` relative (``atol = 1e-12 * max|want|`` where entries can be
near zero), and ``1e-10 * max(1, |logdet|)`` absolute for ``log |det|``;
the two packages run the same algorithms and differ in operation order
only. bf16: one bf16 ulp (both compute in float32 and round once).

The reference is no oracle where it swaps rows arithmetically (ROADMAP,
Faults) or where ``|log det|`` is near 0: there the port is held against
float64 numpy. The CUDA kernels themselves are held against these plain
versions on the card by ``tests/test_torch_factor_cuda.py`` and
``chip_smoke.py``.
"""
import functools
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastmath_tpu as F
from fastmath_tpu.ops.batched import _chol_solve_unrolled as ref_chol_solve

import fastmath_tpu_torch as T
from fastmath_tpu_torch import kernels as K
from fastmath_tpu_torch.kernels import _gen_adjugate
from fastmath_tpu_torch.ops.batched import _chol_solve_unrolled

RTOL = 1e-10
BLOCK = 128  # interpret-mode block of the Pallas kernels
# the closed forms, the unrolled and rolled kernel tiers, the plain
# pivoted LU (to 16) and the torch.linalg tier beyond
NS = [1, 2, 3, 4, 5, 8, 9, 12, 16, 20]


def _general(rng, shape, n):
    """n I + (sqrt(n) / 4) R with shuffled rows: partial pivoting swaps
    at most steps; condition number ~3."""
    a = n * np.eye(n) + np.sqrt(n) / 4 * rng.standard_normal((*shape, n, n))
    perm = np.argsort(rng.random((*shape, n)), axis=-1)
    return np.take_along_axis(a, perm[..., None], axis=-2)


def _spd(rng, shape, n):
    a = rng.standard_normal((*shape, n, n))
    s = a @ np.swapaxes(a, -1, -2) + n * np.eye(n)
    return 0.5 * (s + np.swapaxes(s, -1, -2))


def _indefinite(rng, shape, n):
    """Symmetric, indefinite, well conditioned: pivoting swaps rows."""
    q, _ = np.linalg.qr(rng.standard_normal((*shape, n, n)))
    w = rng.uniform(0.5, 2.0, (*shape, n)) * np.where(rng.random((*shape, n)) < 0.5, -1, 1)
    s = np.einsum("...ik,...k,...jk->...ij", q, w, q)
    return 0.5 * (s + np.swapaxes(s, -1, -2))


def _compact(full):
    n = full.shape[-1]
    rows, cols = np.triu_indices(n, k=1)
    return np.concatenate([np.diagonal(full, axis1=-2, axis2=-1), full[..., rows, cols]],
                          axis=-1)


def _close(got, want, rtol=RTOL):
    got = np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12 * np.abs(want).max())


def _close_log(got, want, tol=RTOL):
    got = np.asarray(got)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= tol * np.maximum(1.0, np.abs(want))), (got, want)


@functools.lru_cache(maxsize=None)
def _jitted(fn, kw):
    return jax.jit(functools.partial(fn, **dict(kw)))


def _jax(fn, *arrays, **kw):
    """``fn`` on the arrays, jitted once per function and shape; a tuple
    of results comes back as a list of numpy arrays."""
    out = _jitted(fn, tuple(sorted(kw.items())))(*(jnp.asarray(a) for a in arrays))
    return [np.asarray(o) for o in out] if isinstance(out, tuple) else np.asarray(out)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("header,render", [("HEADER", "render"),
                                           ("FULL_HEADER", "render_full")])
def test_factor_headers_are_generated(header, render):
    text = getattr(_gen_adjugate, header).read_text()
    assert text == getattr(_gen_adjugate, render)()
    names = (("compact_det", "compact_inverse") if header == "HEADER"
             else ("full_det", "full_logdet"))
    for name in names:
        assert text.count(f" {name}(const T (&") == len(_gen_adjugate.DET_ORDERS)


# --- public ops against the reference's XLA path -----------------------------


def _det_logdet(a):
    return F.batchdet(a), F.batchlogdet(a)


@pytest.mark.parametrize("n", NS)
def test_batchdet_logdet_match_reference(n, rng):
    a = _general(rng, (2, 3), n)
    det, logdet = _jax(_det_logdet, a)
    for backend in ("auto", "torch"):
        _close(T.batchdet(_t(a), backend=backend).numpy(), det)
        _close_log(T.batchlogdet(_t(a), backend=backend).numpy(), logdet)


@pytest.mark.parametrize("n", NS)
def test_batchchol_matches_reference(n, rng):
    a = _spd(rng, (2, 3), n)
    want = _jax(F.batchchol, a)
    for backend in ("auto", "torch"):
        _close(T.batchchol(_t(a), backend=backend).numpy(), want)


def _sym_det_invert(c):
    return F.sym_det(c), F.sym_invert(c), F.sym_invert(c, diag=True)


@pytest.mark.parametrize("n", NS)
def test_sym_det_invert_match_reference(n, rng):
    for make in (_spd, _indefinite):
        c = _compact(make(rng, (2, 3), n))
        want = _jax(_sym_det_invert, c)
        for backend in ("auto", "torch"):
            got = (T.sym_det(_t(c), backend=backend), T.sym_invert(_t(c), backend=backend),
                   T.sym_invert_(_t(c), diag=True, backend=backend))
            for g, w in zip(got, want):
                _close(g.numpy(), w)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_chol_solve_matches_reference(n, rng):
    a = _spd(rng, (1, 4), n)
    v, b = rng.standard_normal((3, 1, n)), rng.standard_normal((3, 4, n, 2))
    for rhs in (v, b):
        _close(_chol_solve_unrolled(_t(a), _t(rhs)).numpy(), _jax(ref_chol_solve, a, rhs))


# --- gradients -----------------------------------------------------------------


@pytest.mark.parametrize("n", [3, 6, 12])
def test_grads_match_jax(n, rng):
    a, s = _general(rng, (5,), n), _spd(rng, (5,), n)
    c = _compact(_indefinite(rng, (5,), n))
    w = [rng.standard_normal(shape) for shape in ((5,), (5,), (5, n, n), (5,), c.shape)]

    def jloss(a_, s_, c_):
        return (jnp.sum(F.batchdet(a_) * w[0]) + jnp.sum(F.batchlogdet(a_) * w[1])
                + jnp.sum(F.batchchol(s_) * w[2])
                + jnp.sum(F.sym_det(c_) * w[3]) + jnp.sum(F.sym_invert(c_) * w[4]))

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (a, s, c)))
    want = [np.asarray(x) for x in want]
    # both Cholesky paths read the lower triangle for n <= 16, as the
    # reference does, so the gradient falls on it alone
    for backend, wants in (("auto", want), ("torch", want)):
        ins = [_t(x).requires_grad_() for x in (a, s, c)]
        ws = [_t(x) for x in w]
        loss = ((T.batchdet(ins[0], backend=backend) * ws[0]).sum()
                + (T.batchlogdet(ins[0], backend=backend) * ws[1]).sum()
                + (T.batchchol(ins[1], backend=backend) * ws[2]).sum()
                + (T.sym_det(ins[2], backend=backend) * ws[3]).sum()
                + (T.sym_invert(ins[2], backend=backend) * ws[4]).sum())
        for g, wg in zip(torch.autograd.grad(loss, ins), wants):
            _close(g.numpy(), wg)


# --- half precision, saturation, and float64 numpy where the reference
# --- is no oracle --------------------------------------------------------------


@pytest.mark.parametrize("n", [3, 6])
def test_bf16_in_bf16_out(n, rng):
    a = _general(rng, (16,), n).astype(np.float32)
    s = _spd(rng, (16,), n).astype(np.float32)
    c = _compact(s)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (a, s, c)]
    tb = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16) for x in jb]
    ref = _jitted(lambda a_, s_, c_: (F.batchdet(a_), F.batchlogdet(a_), F.batchchol(s_),
                                      F.sym_det(c_), F.sym_invert(c_)), ())(*jb)
    got = (T.batchdet(tb[0]), T.batchlogdet(tb[0]), T.batchchol(tb[1]), T.sym_det(tb[2]),
           T.sym_invert(tb[2]))
    pairs = zip(got, ref)
    for got, want in pairs:
        assert got.dtype == torch.bfloat16
        want = np.asarray(want.astype(jnp.float32))
        # the float32 results differ by a few ulp, which can flip one
        # rounding to bf16: one bf16 ulp (2^-7)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                                   atol=2.0 ** -7 * np.abs(want).max())


def test_det_badly_scaled_rows_against_numpy():
    """The rows of ``test_badly_scaled_rows_swap_exactly`` (ROADMAP,
    Faults), at n = 10 (the rolled kernel tier and the plain LU tier):
    the port swaps rows exactly."""
    n = 10
    a = np.eye(n)
    a[0, :2], a[1, :2] = (1e-20, 1e20), (1.0, 1.0)
    want = np.linalg.det(a)
    for backend in ("auto", "torch"):
        _close(T.batchdet(_t(a[None]), backend=backend).numpy(), np.array([want]))
        _close(T.sym_det(_t(_compact(a + a.T)[None]), backend=backend).numpy(),
               np.array([np.linalg.det(a + a.T)]))
    _close(K.det_cf(_t(a.reshape(-1, 1))).numpy(), np.array([want]))


@pytest.mark.parametrize("n", [3, 6, 12])
def test_logdet_near_zero_against_numpy(n, rng):
    # Q diag(exp(u)) with sum(u) = 1e-9: |log det| ~ 1e-9, where a relative
    # error means nothing
    q, _ = np.linalg.qr(rng.standard_normal((8, n, n)))
    u = rng.uniform(-0.5, 0.5, (8, n))
    u[:, -1] += 1e-9 - u.sum(axis=1)
    a = q * np.exp(u)[:, None, :]
    want = np.linalg.slogdet(a)[1]
    assert np.abs(want).max() < 1e-8
    for backend in ("auto", "torch"):
        _close_log(T.batchlogdet(_t(a), backend=backend).numpy(), want)


# --- routing and errors --------------------------------------------------------


def test_forced_cuda_on_cpu_raises(rng):
    a, c = _t(_general(rng, (4,), 5)), _t(_compact(_spd(rng, (4,), 5)))
    for fn, x in ((T.batchdet, a), (T.batchlogdet, a), (T.batchchol, a), (T.sym_det, c),
                  (T.sym_invert, c)):
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, backend="cuda")
    with pytest.raises(ValueError, match="kernel serves"):
        T.batchdet(torch.eye(33, dtype=torch.float64), backend="cuda")
    with pytest.raises(ValueError, match="kernel serves"):
        T.sym_invert(torch.ones(1, 33 * 34 // 2, dtype=torch.float64), backend="cuda")
    with pytest.raises(ValueError, match="square"):
        T.batchlogdet(torch.ones(2, 3, 4))
    with pytest.raises(ValueError, match="backend"):
        T.sym_det(c, backend="xla")
    # outside the kernels' domain "auto" takes the plain tiers
    c33 = _compact(_spd(rng, (2,), 33))
    _close(T.sym_det(_t(c33)).numpy(), _jax(F.sym_det, c33))


def test_wrapper_errors(rng):
    with pytest.raises(ValueError, match=r"\(n\*n, \.\.\.\) rows"):
        K.det_cf(torch.ones(8, 4))
    with pytest.raises(ValueError, match="n <= 32"):
        K.logdet_cf(torch.ones(33 * 33, 2))
    with pytest.raises(ValueError, match="triangular"):
        K.chol_cf(torch.ones(4, 2))
    with pytest.raises(ValueError, match="1 <= N <= 32"):
        K.sym_invert_cf(torch.ones(33 * 34 // 2, 2))
    with pytest.raises(ValueError, match="real floats"):
        K.sym_det_cf(torch.ones(6, 2, dtype=torch.complex128))
    from fastmath_tpu_torch.kernels import batched_cuda, sym_factor

    full, compact = torch.ones(3, 4), torch.ones(3, 6)
    for launch, m in ((batched_cuda.launch_det, full), (batched_cuda.launch_logdet, full),
                      (batched_cuda.launch_chol, compact), (sym_factor.launch_sym_det, compact),
                      (sym_factor.launch_sym_invert, compact)):
        with pytest.raises(ValueError, match="CUDA"):
            launch(m)


def test_factor_ops_import_no_jax():
    code = (
        "import sys, torch\n"
        "import fastmath_tpu_torch as T\n"
        "a = torch.tensor([[[4.0, 1.0], [2.0, 3.0]]]); s = a @ a.mT\n"
        "assert torch.allclose(T.batchdet(a), torch.tensor([10.0]))\n"
        "T.batchlogdet(a); T.batchchol(s); T.sym_det(torch.tensor([[4.0, 5.0, 1.0]]))\n"
        "T.sym_invert(torch.tensor([[4.0, 5.0, 1.0]]), diag=True)\n"
        "T.kernels.det_cf(a.reshape(1, 4).t()); T.kernels.chol_cf(torch.ones(3, 1) + 2 * torch.eye(3)[:, :1])\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'fastmath_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=pathlib.Path(__file__).resolve().parents[1])
