"""The port's determinant, log-determinant, Cholesky, compact determinant
and compact inverse kernels against their plain PyTorch versions and
float64 numpy, on the card.

Every test here is marked ``cuda`` and skips on a machine without an
NVIDIA GPU (the kernels have no CPU mode). This file imports neither JAX
nor ``fastmath_tpu``, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_factor_cuda.py -m cuda --noconftest -p no:cacheprovider

Tolerances: float32 1e-5 and float64 1e-12, relative for a determinant,
normwise for a factor or an inverse, and ``tol * max(1, |logdet|)``
absolute for ``log |det|``. The kernels contract multiply-adds into FMAs
and the plain versions do not, which moves each result by a few ulp per
operation. The matrices are well conditioned (condition number ~3) with
determinants in range at every n: ``I + R / (4 sqrt(n))`` with shuffled
rows (pivoting swaps at most steps), symmetric ``Q diag(w) Q^T`` with
``|w|`` in [0.5, 2] and mixed signs, and SPD ``(a a^T + n I) / n``.
"""
import numpy as np
import pytest
import torch

import fastmath_tpu_torch as T
from fastmath_tpu_torch.kernels import (batched_cuda, chol_cf, det_cf, inv_cf, logdet_cf,
                                        solve_full_cf, sym_det_cf, sym_factor, sym_invert_cf)
from fastmath_tpu_torch.layouts import full_to_sym, sym_to_full

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
B = 4099  # a ragged last block


@pytest.fixture(autouse=True)
def _needs_card(request):
    if request.node.get_closest_marker("cuda") and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _general(rng, b, n):
    a = np.eye(n) + rng.standard_normal((b, n, n)) / (4 * np.sqrt(n))
    perm = np.argsort(rng.random((b, n)), axis=-1)
    return np.take_along_axis(a, perm[..., None], axis=1)


def _symmetric(rng, b, n):
    q, _ = np.linalg.qr(rng.standard_normal((b, n, n)))
    w = rng.uniform(0.5, 2.0, (b, n)) * np.where(rng.random((b, n)) < 0.5, -1, 1)
    s = np.einsum("bik,bk,bjk->bij", q, w, q)
    return 0.5 * (s + s.transpose(0, 2, 1))


def _spd(rng, b, n):
    a = rng.standard_normal((b, n, n))
    return (a @ a.transpose(0, 2, 1) + n * np.eye(n)) / n


def _cf(t):
    """The channel-first copy of a (B, K) tensor, seen as a (B, K) view."""
    return t.t().contiguous().t()


def _rel(got, want):
    """Largest per-problem error, relative for (B,) values and normwise
    for (B, K) rows."""
    got, want = got.double().cpu(), want.double().cpu()
    if got.dim() == 1:
        return ((got - want).abs() / want.abs()).max().item()
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()


def _log_err(got, want):
    got, want = got.double().cpu(), torch.as_tensor(want).double().cpu()
    return ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()


def _compact(full):
    return full_to_sym(torch.from_numpy(full)).numpy()


def _compact_lower(L):
    """Compact slots of lower factors: slot (i, j), i < j, holds L[j][i]."""
    rows, cols = np.triu_indices(L.shape[-1], k=1)
    return np.concatenate([np.diagonal(L, axis1=-2, axis2=-1), L[:, cols, rows]], axis=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", list(range(1, 33)))
def test_kernels_match_plain(n, dtype, rng):
    tol = TOL[dtype]
    a64, sym64, spd64 = _general(rng, B, n), _symmetric(rng, B, n), _spd(rng, B, n)
    a = torch.tensor(a64.reshape(B, n * n), dtype=dtype, device="cuda")
    sym = torch.tensor(_compact(sym64), dtype=dtype, device="cuda")
    spd = torch.tensor(_compact(spd64), dtype=dtype, device="cuda")
    # float64 oracles of the values the card holds
    a_ = a.double().cpu().numpy().reshape(B, n, n)
    sym_ = sym_to_full(sym.double().cpu()).numpy()
    spd_ = sym_to_full(spd.double().cpu()).numpy()
    cases = [
        (batched_cuda.launch_det, det_cf, a, batched_cuda.det_plain, np.linalg.det(a_)),
        (batched_cuda.launch_logdet, logdet_cf, a, batched_cuda.logdet_plain,
         np.linalg.slogdet(a_)[1]),
        (batched_cuda.launch_chol, chol_cf, spd, batched_cuda.chol_plain,
         _compact_lower(np.linalg.cholesky(spd_))),
        (sym_factor.launch_sym_det, sym_det_cf, sym, sym_factor.sym_det_plain,
         np.linalg.det(sym_)),
        (sym_factor.launch_sym_invert, sym_invert_cf, sym, sym_factor.invert_plain,
         _compact(np.linalg.inv(sym_))),
    ]
    for launch, wrapper, x, plain, oracle in cases:
        want = plain(x)
        for m, cf in ((x, False), (_cf(x), True)):
            before = wrapper.launches
            got = launch(m, cf_out=cf)
            assert wrapper.launches == before + 1
            torch.cuda.synchronize()
            if wrapper is logdet_cf:
                assert _log_err(got, want) <= tol
                assert _log_err(got, oracle) <= tol
            else:
                assert _rel(got, want) <= tol, (wrapper.__name__, cf)
                assert _rel(got, torch.from_numpy(oracle)) <= tol, (wrapper.__name__, cf)


# the n <= 8 tiers stage blocks of 128 problems (the inverse 64 in float64
# at n = 7, 8): one problem, a block less one, one, one more, at either
# size, and many
STAGED_BATCHES = (1, 63, 64, 65, 127, 128, 129, 1029)


def _misaligned(x):
    """A batch-major copy of ``x`` one element past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8])
def test_staged_cholesky_batches_and_views(n, dtype, rng):
    # the staged tier's three orders of device memory (16-byte vectors,
    # batch-fastest, element by element) at every edge of its blocks
    for b in STAGED_BATCHES:
        c = torch.tensor(_compact(_spd(rng, b, n)), dtype=dtype, device="cuda")
        want = batched_cuda.chol_plain(c)
        oracle = _compact_lower(np.linalg.cholesky(sym_to_full(c.double().cpu()).numpy()))
        views = ((c, False), (_cf(c), True), (_cf(c), False), (c, True), (_misaligned(c), False))
        for m, cf in views:
            before = chol_cf.launches
            got = batched_cuda.launch_chol(m, cf_out=cf)
            assert chol_cf.launches == before + 1
            torch.cuda.synchronize()
            assert _rel(got, want) <= TOL[dtype], (b, m.stride(), cf)
            assert _rel(got, torch.from_numpy(oracle)) <= TOL[dtype], (b, m.stride(), cf)
    # a broadcast batch (stride 0), through the channel-first wrapper and
    # the public op
    one = torch.tensor(_compact(_spd(rng, 1, n)).T, dtype=dtype, device="cuda")
    got = chol_cf(one.expand(-1, 515))
    assert _rel(got.t(), chol_cf(one.cpu().expand(-1, 515)).t()) <= TOL[dtype]
    full = sym_to_full(one.t())
    got = T.batchchol(full.expand(515, n, n))
    assert _rel(got.reshape(515, -1),
                T.batchchol(full.cpu()).reshape(1, -1).expand(515, -1)) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 3, 5, 8])
def test_staged_cholesky_keeps_a_bad_problem_to_itself(n, dtype, rng):
    # problems that are not SPD, either side of two block edges: their
    # factors hold NaN, and every other problem's are the bits of a batch
    # without them
    b, bad = 1029, (63, 64, 127, 128)
    c = torch.tensor(_compact(_spd(rng, b, n)), dtype=dtype, device="cuda")
    good = batched_cuda.launch_chol(c)
    c[bad[0], 0] = -1.0  # a negative first pivot
    c[bad[1], n - 1] = -float(n)  # the last pivot negative
    c[bad[2], 0] = float("nan")
    c[bad[3], 0] = -1.0
    keep = torch.ones(b, dtype=torch.bool)
    keep[list(bad)] = False
    for m, cf in ((c, False), (_cf(c), True), (_misaligned(c), False)):
        got = batched_cuda.launch_chol(m, cf_out=cf)
        torch.cuda.synchronize()
        for k in bad:
            assert torch.isnan(got[k]).any(), (k, cf)
        assert torch.equal(got.cpu()[keep], good.cpu()[keep])
        want = batched_cuda.chol_plain(c[keep.to(c.device)])
        assert _rel(got[keep.to(c.device)], want) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cf_wrappers_take_strided_operands(dtype, rng):
    # channel-first operands in neither layout the kernels read: a strided
    # batch slice, a row slice of a wider buffer, a broadcast batch dim
    n = 5
    a = torch.tensor(_general(rng, 2 * 515, n).reshape(-1, n * n).T, dtype=dtype, device="cuda")
    s = torch.tensor(_compact(_spd(rng, 2 * 515, n)).T, dtype=dtype, device="cuda")
    wide = torch.cat([s, s[:3]])
    for m, c in ((a[:, ::2], s[:, ::2]), (a[:, :515], wide[:15, :515]),
                 (a[:, :1].expand(-1, 515), s[:, :1].expand(-1, 515))):
        for wrapper, x in ((det_cf, m), (logdet_cf, m), (chol_cf, c), (sym_det_cf, c),
                           (sym_invert_cf, c)):
            before = wrapper.launches
            got = wrapper(x)
            assert wrapper.launches == before + 1
            want = wrapper(x.cpu())
            if wrapper is logdet_cf:
                assert _log_err(got, want) <= TOL[dtype]
            elif got.dim() == 1:
                assert _rel(got, want) <= TOL[dtype]
            else:
                assert _rel(got.t(), want.t()) <= TOL[dtype]


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(rng):
    a = torch.tensor(_general(rng, 8, 3).reshape(8, 9), device="cuda")
    with pytest.raises(ValueError, match="float32/float64"):
        batched_cuda.launch_det(a.half())
    with pytest.raises(ValueError, match="serves"):
        batched_cuda.launch_det(torch.ones(2, 33 * 33, device="cuda"))
    with pytest.raises(ValueError, match="must be batch-major"):
        sym_factor.launch_sym_invert(torch.ones(4, 12, device="cuda")[:, ::2])
    with pytest.raises(ValueError, match="kernel serves"):
        T.batchchol(torch.eye(33, device="cuda"), backend="cuda")
    with pytest.raises(ValueError, match="kernel serves"):
        T.sym_det(torch.ones(1, 33 * 34 // 2, device="cuda"), backend="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 6, 12])
def test_public_ops_launch_and_grads(n, rng):
    a = torch.tensor(_general(rng, 515, n), device="cuda")
    s = torch.tensor(_spd(rng, 515, n), device="cuda")
    c = full_to_sym(torch.tensor(_symmetric(rng, 515, n), device="cuda"))
    counters = (det_cf, logdet_cf, chol_cf, sym_det_cf, sym_invert_cf)
    before = [f.launches for f in counters]
    outs = (T.batchdet(a), T.batchlogdet(a), T.batchchol(s), T.sym_det(c), T.sym_invert(c))
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1, 1, 1]
    wants = (T.batchdet(a.cpu()), T.batchlogdet(a.cpu()), T.batchchol(s.cpu()),
             T.sym_det(c.cpu()), T.sym_invert(c.cpu()))
    for got, want in zip(outs, wants):
        assert _rel(got.reshape(515, -1), want.reshape(515, -1)) <= TOL[torch.float64]

    def grads(backend):
        ins = [t.clone().requires_grad_() for t in (a, s, c)]
        out = (T.batchdet(ins[0], backend=backend).square().sum()
               + T.batchlogdet(ins[0], backend=backend).square().sum()
               + T.batchchol(ins[1], backend=backend).square().sum()
               + T.sym_det(ins[2], backend=backend).square().sum()
               + T.sym_invert(ins[2], backend=backend).square().sum())
        before = [f.launches for f in (inv_cf, solve_full_cf, sym_invert_cf)]
        g = torch.autograd.grad(out, ins)
        return g, [f.launches - b for f, b in zip((inv_cf, solve_full_cf, sym_invert_cf),
                                                  before)]

    (kernel, bwd), (plain, _) = grads("auto"), grads("torch")
    # the kernel path packs the Cholesky input's triangles: compare the
    # symmetric halves of the gradients
    kernel = [kernel[0], 0.5 * (kernel[1] + kernel[1].mT), kernel[2]]
    plain = [plain[0], 0.5 * (plain[1] + plain[1].mT), plain[2]]
    for k, p in zip(kernel, plain):
        assert ((k - p).norm() / p.norm()).item() <= 1e-10
    # det's backward runs the inverse kernel above n = 4, log|det|'s the
    # solve kernel on A transposed, sym_det's the compact inverse above 4
    assert bwd == [1 if n > 4 else 0, 1, 1 if n > 4 else 0]
