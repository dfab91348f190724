"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips on a machine without an
NVIDIA GPU (the kernels have no CPU mode). This file imports neither JAX
nor ``fastmath_tpu``, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_sym_cuda.py -m cuda --noconftest -p no:cacheprovider

Tolerances (normwise): float32 1e-5 and float64 1e-12. The kernels contract
multiply-adds into FMAs and the plain version does not, which moves each
result by a few ulp per operation; the matrices are SPD with condition
number below ~10.
"""
import numpy as np
import pytest
import torch

import fastmath_tpu_torch as T
from fastmath_tpu_torch.kernels import sym_cuda, sym_solve_cf, sym_solve_chain_cf

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture(autouse=True)
def _needs_card(request):
    if request.node.get_closest_marker("cuda") and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _inputs(rng, b, n, dtype):
    a = rng.standard_normal((b, n, n))
    full = np.einsum("...ij,...kj->...ik", a, a) + n * np.eye(n)
    rows, cols = np.triu_indices(n, k=1)
    cm = np.concatenate([np.diagonal(full, axis1=-2, axis2=-1),
                         full[..., rows, cols]], axis=-1)
    return [torch.tensor(x, dtype=dtype, device="cuda")
            for x in (cm, rng.standard_normal((b, n)), rng.standard_normal((b, n)))]


def _normwise(got, want, add=None):
    # a chain x <- A \ x + add can cancel; its rounding scales with the terms
    scale = want.norm(dim=-1) + (0 if add is None else add.norm(dim=-1))
    return ((got - want).norm(dim=-1) / scale).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 8, 9, 12, 16, 17, 24, 32])
def test_kernels_match_plain(n, dtype, rng):
    mat, vec, add = _inputs(rng, 1029, n, dtype)  # ragged last block
    mat_cf, vec_cf = mat.t().contiguous().t(), vec.t().contiguous().t()
    for eps in (None, (0.3, 0.1)):
        e = sym_cuda._prep_eps(eps, n)
        for refine in (0, 1, 2):
            want = sym_cuda.solve_plain(mat, vec, e, refine)
            for m, v, cf in ((mat, vec, False), (mat_cf, vec_cf, True)):
                before = sym_solve_cf.launches
                got = sym_cuda.launch_solve(m, v, e, refine, cf_out=cf)
                assert sym_solve_cf.launches == before + 1
                torch.cuda.synchronize()
                assert _normwise(got, want) <= TOL[dtype]
        want = sym_cuda.chain_plain(mat, vec, add, e, 5)
        before = sym_solve_chain_cf.launches
        got = sym_cuda.launch_chain(mat, vec, add, e, 5)
        assert sym_solve_chain_cf.launches == before + 1
        torch.cuda.synchronize()
        assert _normwise(got, want, add) <= TOL[dtype]


def _chain64(mat, vec, add, eps, iters):
    """The float64 numpy recurrence x <- (A + diag(eps))^-1 x + add."""
    n = vec.shape[1]
    full = T.sym_to_full(mat.double(), n).cpu().numpy()
    if eps is not None:
        full = full + np.diag(eps)
    x = vec.double().cpu().numpy()
    c = np.zeros_like(x) if add is None else add.double().cpu().numpy()
    for _ in range(iters):
        x = np.linalg.solve(full, x[..., None])[..., 0] + c
    return torch.from_numpy(x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [5, 6, 7, 8])
def test_chain_inverse_tier(n, dtype, rng):
    """The 5 <= N <= 8 chain (the explicit inverse, staged): a batch of 1,
    one block and one more (129) and a ragged 1029, 16 steps with add and
    4 without (x = A^-k v then shrinks by orders of magnitude, and its
    relative rounding grows with k), with and without eps, against the
    plain version and the float64 numpy recurrence; channel-first operands
    and result give the batch-major bits, and a strided and a broadcast
    operand the bits of the same problems made contiguous."""
    mat, vec, add = _inputs(rng, 1029, n, dtype)
    for eps in (None, (0.3, 0.1)):
        e = sym_cuda._prep_eps(eps, n)
        e64 = None if e is None else np.asarray(e)
        for c, k in ((None, 4), (add, 16)):
            want = sym_cuda.chain_plain(mat, vec, c, e, k)
            oracle = _chain64(mat, vec, c, e64, k)
            for b in (1, 129, 1029):
                cb = None if c is None else c[:b]
                got = sym_cuda.launch_chain(mat[:b], vec[:b], cb, e, k)
                torch.cuda.synchronize()
                assert _normwise(got, want[:b], cb) <= TOL[dtype]
                assert _normwise(got.cpu().double(), oracle[:b],
                                 None if cb is None else cb.cpu().double()) <= TOL[dtype]
            cf = [None if t is None else t.t().contiguous().t() for t in (mat, vec, c)]
            assert torch.equal(sym_cuda.launch_chain(*cf, e, k, cf_out=True), got)
    nn = n * (n + 1) // 2
    base = _inputs(rng, 2 * 515, n, dtype)
    for m, v, a in ((base[0][::2], base[1][::2], base[2][::2]),
                    (base[0][:1].expand(515, nn), base[1][:515], base[2][:515])):
        got = sym_solve_chain_cf(m.t(), v.t(), 16, add=a.t())
        want = sym_solve_chain_cf(m.t().contiguous(), v.t().contiguous(), 16,
                                  add=a.t().contiguous())
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [5, 6, 7, 8])
def test_chain_singular_and_nan_stay_in_their_problem(n, dtype, rng):
    """A singular matrix (its first row and column zero: the first pivot is
    0) comes back NaN, as the plain version gives, and a problem holding a
    NaN non-finite; every other problem keeps the bits it has without
    them."""
    mat, vec, add = _inputs(rng, 300, n, dtype)
    bad = mat.clone()
    for j in range(n):
        bad[7, T.layouts.tri_index(0, j, n)] = 0
    bad[150, 1] = float("nan")
    got = sym_cuda.launch_chain(bad, vec, add, None, 16)
    alone = sym_cuda.launch_chain(mat, vec, add, None, 16)
    plain = sym_cuda.chain_plain(bad, vec, add, None, 16)
    torch.cuda.synchronize()
    assert torch.isnan(got[7]).all() and torch.isnan(plain[7]).all()
    assert not torch.isfinite(got[150]).all()
    keep = torch.ones(300, dtype=torch.bool, device="cuda")
    keep[[7, 150]] = False
    assert torch.equal(got[keep], alone[keep])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cf_wrappers_take_strided_operands(dtype, rng):
    # channel-first operands in neither layout the kernels read: a strided
    # batch slice, a column slice of a wider buffer, a broadcast batch dim
    n, nn = 3, 6
    mat, vec, add = _inputs(rng, 2 * 515, n, dtype)
    wide = torch.cat([vec.t(), add.t()], dim=0)  # (2N, B)
    cases = [(mat.t()[:, ::2], vec.t()[:, ::2], add.t()[:, ::2]),
             (mat.t()[:, :515], wide[:n, :515], wide[n:, :515]),
             (mat.t()[:, :1], vec.t()[:, :515], add.t()[:, :515])]
    for m, v, a in cases:
        assert not (m.is_contiguous() and v.is_contiguous())
        mc, vc, ac = m.cpu(), v.cpu(), a.cpu()
        before = (sym_solve_cf.launches, sym_solve_chain_cf.launches)
        got = sym_solve_cf(m, v, eps=0.2)
        chain = sym_solve_chain_cf(m, v, 4, add=a)
        assert (sym_solve_cf.launches, sym_solve_chain_cf.launches) == (
            before[0] + 1, before[1] + 1)
        assert got.shape == chain.shape == (n, v.shape[1])
        assert mc.shape[0] == nn
        assert _normwise(got.t().cpu(), sym_solve_cf(mc, vc, eps=0.2).t()) <= TOL[dtype]
        want = sym_solve_chain_cf(mc, vc, 4, add=ac)
        assert _normwise(chain.t().cpu(), want.t(), ac.t()) <= TOL[dtype]


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(rng):
    mat, vec, _ = _inputs(rng, 8, 3, torch.float32)
    with pytest.raises(ValueError, match="float32/float64"):
        sym_cuda.launch_solve(mat.half(), vec.half())
    with pytest.raises(ValueError, match="shape"):
        sym_cuda.launch_solve(mat[:4], vec)
    with pytest.raises(ValueError, match="dtype|float64"):
        sym_cuda.launch_solve(mat, vec.double())
    with pytest.raises(ValueError, match="contiguous"):
        sym_cuda.launch_solve(mat[:, ::1].repeat(1, 2)[:, ::2], vec)
    with pytest.raises(ValueError, match="kernel serves"):
        T.sym_solve(vec, vec, backend="cuda")  # diagonal storage


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 6, 12])
def test_public_ops_launch_and_grads(n, rng):
    mat, vec, add = _inputs(rng, 515, n, torch.float64)
    before = (sym_solve_cf.launches, sym_solve_chain_cf.launches)
    x = T.sym_solve(mat, vec)
    y = T.sym_solve_chain(mat, vec, 4, add=add)
    assert (sym_solve_cf.launches, sym_solve_chain_cf.launches) == (
        before[0] + 1, before[1] + 1)
    assert _normwise(x.cpu(), T.sym_solve(mat.cpu(), vec.cpu())) <= TOL[torch.float64]
    want = T.sym_solve_chain(mat.cpu(), vec.cpu(), 4, add=add.cpu())
    assert _normwise(y.cpu(), want, add.cpu()) <= TOL[torch.float64]

    def grads(backend):
        ins = [t.clone().requires_grad_() for t in (mat, vec, add)]
        out = (T.sym_solve(ins[0], ins[1], backend=backend).square().sum()
               + T.sym_solve_chain(*ins[:2], 3, add=ins[2], backend=backend).square().sum())
        return torch.autograd.grad(out, ins)

    for k, g in zip(grads("cuda"), grads("torch")):
        assert ((k - g).norm() / g.norm()).item() <= 1e-10
