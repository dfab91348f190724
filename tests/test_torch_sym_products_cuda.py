"""The port's product kernels (matvec, acc ± matvec, outer, JᵀHJ) against
their plain PyTorch versions, on the card.

Every test in this file is marked ``cuda`` and skips on a machine without an
NVIDIA GPU (the kernels have no CPU mode). This file imports neither JAX
nor ``fastmath_tpu``, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_sym_products_cuda.py -m cuda --noconftest -p no:cacheprovider

Tolerances (normwise per problem): float32 1e-5 and float64 1e-12. The
kernels contract multiply-adds into FMAs and the plain versions do not,
which moves each sum by a few ulp; the inputs are random symmetric
matrices and vectors of unit scale.
"""
import numpy as np
import pytest
import torch

import fastmath_tpu_torch as T
from fastmath_tpu_torch.kernels import (sym_addmatvec_cf, sym_matmul_cf, sym_matvec_cf,
                                        sym_outer_cf, sym_products, sym_submatvec_cf)
from fastmath_tpu_torch.kernels._launch import launch, operand

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture(autouse=True)
def _needs_card(request):
    if request.node.get_closest_marker("cuda") and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _compact_sym(rng, b, n, dtype):
    a = torch.tensor(rng.standard_normal((b, n, n)), dtype=dtype, device="cuda")
    return T.layouts.full_to_sym(a + a.mT).contiguous()


def _vecs(rng, b, n, dtype, k=2):
    return [torch.tensor(rng.standard_normal((b, n)), dtype=dtype, device="cuda")
            for _ in range(k)]


def _cf(t):
    """The same values in the channel-first layout, seen as (B, K)."""
    return t.t().contiguous().t()


def _normwise(got, want):
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 9, 16, 32])
def test_matvec_family_and_outer_match_plain(n, dtype, rng):
    mat = _compact_sym(rng, 1029, n, dtype)  # ragged last block
    vec, acc = _vecs(rng, 1029, n, dtype)
    cases = [
        (sym_matvec_cf, lambda m, v, a, cf: sym_products.launch_matvec(m, v, cf),
         sym_products.matvec_plain(mat, vec)),
        (sym_addmatvec_cf, lambda m, v, a, cf: sym_products.launch_accmatvec(a, m, v, 1.0, cf),
         sym_products.accmatvec_plain(acc, mat, vec, 1.0)),
        (sym_submatvec_cf, lambda m, v, a, cf: sym_products.launch_accmatvec(a, m, v, -1.0, cf),
         sym_products.accmatvec_plain(acc, mat, vec, -1.0)),
        (sym_outer_cf, lambda m, v, a, cf: sym_products.launch_outer(v, cf),
         sym_products.outer_plain(vec)),
    ]
    for counter, launch, want in cases:
        for cf in (False, True):
            lay = _cf if cf else (lambda t: t)
            before = counter.launches
            got = launch(lay(mat), lay(vec), lay(acc), cf)
            assert counter.launches == before + 1
            torch.cuda.synchronize()
            assert got.shape == want.shape
            assert _normwise(got, want) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k,d", [(1, 1), (3, 2), (4, 4), (6, 6), (7, 3), (3, 7), (16, 16),
                                 (32, 32), (16, 7), (7, 16), (9, 9), (13, 5), (24, 24),
                                 (32, 7)])
def test_jhj_matches_plain(k, d, dtype, rng):
    j = torch.tensor(rng.standard_normal((1029, k * d)), dtype=dtype, device="cuda")
    h = _compact_sym(rng, 1029, k, dtype)
    want = sym_products.jhj_plain(j, h, d)
    for cf in (False, True):
        lay = _cf if cf else (lambda t: t)
        before = sym_matmul_cf.launches
        got = sym_products.launch_jhj(lay(j), lay(h), d, cf)
        assert sym_matmul_cf.launches == before + 1
        torch.cuda.synchronize()
        assert _normwise(got, want) <= TOL[dtype]


def _off_by_one(t):
    """The same values, contiguous batch-major, one element past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k,d", [(7, 3), (9, 9), (16, 16), (13, 5)])
def test_jhj_staging_layouts_and_nan(k, d, dtype, rng):
    """The rolled tier's staging in each of its orders gives the bits of
    the contiguous call: a J at channel stride 2 and J and H one element
    off a 16-byte boundary (element by element), batches that are not a
    whole number of a block's problems (1, 5, 1029, 2053). A NaN in one
    problem's J stays in that problem: every other problem keeps its
    bits."""
    b = 2053
    j = torch.tensor(rng.standard_normal((b, k * d)), dtype=dtype, device="cuda")
    h = _compact_sym(rng, b, k, dtype)
    want = sym_products.launch_jhj(j, h, d)
    torch.cuda.synchronize()
    assert _normwise(want, sym_products.jhj_plain(j, h, d)) <= TOL[dtype]
    # a J at channel stride 2, which the wrappers never pass: the entry
    # point itself, which stages it element by element
    strided = torch.repeat_interleave(j, 2, dim=1)[:, ::2]
    got = torch.empty_like(want)
    launch(sym_products._library(), sym_matmul_cf, "fm_sym_jhj", h, k, d, b, *operand(strided),
           *operand(h), *operand(got))
    assert torch.equal(got, want)
    for jj, hh in ((_off_by_one(j), _off_by_one(h)), (j, _off_by_one(h))):
        assert torch.equal(sym_products.launch_jhj(jj, hh, d), want)
    for n in (1, 5, 1029):
        assert torch.equal(sym_products.launch_jhj(j[:n].contiguous(), h[:n].contiguous(), d),
                           want[:n])
    bad = j.clone()
    bad[700, k * d // 2] = float("nan")
    got = sym_products.launch_jhj(bad, h, d)
    keep = torch.ones(b, dtype=torch.bool, device="cuda")
    keep[700] = False
    assert torch.isnan(got[700]).any()
    assert torch.equal(got[keep], want[keep])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cf_wrappers_take_strided_operands(dtype, rng):
    # channel-first operands in neither layout the kernels read: a strided
    # batch slice, a row slice of a wider buffer, a broadcast batch dim
    n = 3
    mat = _compact_sym(rng, 2 * 515, n, dtype).t()
    vec, acc = (t.t() for t in _vecs(rng, 2 * 515, n, dtype))
    wide = torch.cat([vec, acc], dim=0)  # (2N, B)
    j = torch.tensor(rng.standard_normal((n * 2, 2 * 515)), dtype=dtype, device="cuda")
    cases = [(mat[:, ::2], vec[:, ::2], acc[:, ::2], j[:, ::2]),
             (mat[:, :515], wide[:n, :515], wide[n:, :515], j[:, :515]),
             (mat[:, :1], vec[:, :515], acc[:, :515], j[:, :1])]
    counters = (sym_matvec_cf, sym_addmatvec_cf, sym_submatvec_cf, sym_outer_cf,
                sym_matmul_cf)
    for m, v, a, jj in cases:
        before = [c.launches for c in counters]
        got = [sym_matvec_cf(m, v), sym_addmatvec_cf(a, m, v), sym_submatvec_cf(a, m, v),
               sym_outer_cf(v), sym_matmul_cf(jj, m)]
        assert [c.launches for c in counters] == [b + 1 for b in before]
        cpu = [t.cpu() for t in (m, v, a, jj)]
        want = [sym_matvec_cf(cpu[0], cpu[1]), sym_addmatvec_cf(cpu[2], cpu[0], cpu[1]),
                sym_submatvec_cf(cpu[2], cpu[0], cpu[1]), sym_outer_cf(cpu[1]),
                sym_matmul_cf(cpu[3], cpu[0])]
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert _normwise(g.t().cpu(), w.t()) <= TOL[dtype]


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(rng):
    mat = _compact_sym(rng, 8, 3, torch.float32)
    vec, acc = _vecs(rng, 8, 3, torch.float32)
    with pytest.raises(ValueError, match="float32/float64"):
        sym_products.launch_matvec(mat.half(), vec.half())
    with pytest.raises(ValueError, match="shape"):
        sym_products.launch_matvec(mat[:4], vec)
    with pytest.raises(ValueError, match="dtype|float64"):
        sym_products.launch_accmatvec(acc.double(), mat, vec, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        sym_products.launch_outer(vec.repeat(1, 2)[:, ::2])
    with pytest.raises(ValueError, match="shape"):
        sym_products.launch_jhj(vec, mat, 2)  # K*D = 6 values expected
    with pytest.raises(ValueError, match="kernel serves"):
        T.sym_matvec(vec, vec, backend="cuda")  # diagonal storage


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 12])
def test_public_ops_launch_and_grads(n, rng):
    dtype = torch.float64
    mat = _compact_sym(rng, 515, n, dtype)
    vec, acc = _vecs(rng, 515, n, dtype)
    j = torch.tensor(rng.standard_normal((515, n, 2)), dtype=dtype, device="cuda")
    counters = (sym_matvec_cf, sym_addmatvec_cf, sym_submatvec_cf, sym_outer_cf,
                sym_matmul_cf)

    def run(backend, ins):
        m, v, a, jj = ins
        return (T.sym_matvec(m, v, backend=backend).square().sum()
                + T.sym_addmatvec(a, m, v, backend=backend).square().sum()
                + T.sym_submatvec(a, m, v, backend=backend).square().sum()
                + T.sym_outer(v, backend=backend).square().sum()
                + T.sym_matmul(jj, m, backend=backend).square().sum())

    def grads(backend):
        ins = [t.clone().requires_grad_() for t in (mat, vec, acc, j)]
        out = run(backend, ins)
        before = sym_matvec_cf.launches
        g = torch.autograd.grad(out, ins)
        return g, sym_matvec_cf.launches - before

    before = [c.launches for c in counters]
    with torch.no_grad():
        run("auto", (mat, vec, acc, j))
    assert [c.launches for c in counters] == [b + 1 for b in before]
    kernel, bwd_launches = grads("cuda")
    plain, plain_launches = grads("torch")
    # the backward of matvec and of each accumulate applies A through the
    # matvec kernel once
    assert (bwd_launches, plain_launches) == (3, 0)
    for k, p in zip(kernel, plain):
        assert ((k - p).norm() / p.norm()).item() <= 1e-10
