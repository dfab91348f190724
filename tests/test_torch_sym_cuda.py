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
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 8, 9, 16, 32])
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
