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


def _entry_det(a, log, out):
    """``fm_det`` on the operands' own strides (the wrappers take channel
    stride 1 only); ``out`` is (B, 1)."""
    n = round(a.shape[1] ** 0.5)
    err = batched_cuda._library().fm_det(
        0 if a.dtype == torch.float32 else 1, n, a.shape[0], a.data_ptr(), *a.stride(), int(log),
        out.data_ptr(), *out.stride(), torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return out[:, 0]


def _stride2(x):
    """``x`` (B, K) as a view at channel stride 2."""
    view = torch.zeros(x.shape[0], 2 * x.shape[1], dtype=x.dtype, device=x.device)[:, ::2]
    view.copy_(x)
    return view


DETS = ((batched_cuda.launch_det, det_cf, batched_cuda.det_plain, False),
        (batched_cuda.launch_logdet, logdet_cf, batched_cuda.logdet_plain, True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8])
def test_staged_det_batches_and_views(n, dtype, rng):
    # det and log|det| in the staged tier's three orders of device memory
    # (16-byte vectors, batch-fastest, element by element; n >= 5) and the
    # unstaged expansion's (n <= 4), at every edge of the blocks, and a
    # channel stride of 2 through the entry point
    for b in STAGED_BATCHES + (4099,):
        a = torch.tensor(_general(rng, b, n).reshape(b, n * n), dtype=dtype, device="cuda")
        a_ = a.double().cpu().numpy().reshape(b, n, n)
        for launch, wrapper, plain, log in DETS:
            want = plain(a)
            oracle = torch.from_numpy(np.linalg.slogdet(a_)[1] if log else np.linalg.det(a_))
            err = _log_err if log else _rel
            views = ((a, False), (_cf(a), True), (_cf(a), False), (a, True),
                     (_misaligned(a), False))
            for m, cf in views:
                before = wrapper.launches
                got = launch(m, cf_out=cf)
                assert wrapper.launches == before + 1
                torch.cuda.synchronize()
                assert err(got, want) <= TOL[dtype], (b, log, m.stride(), cf)
                assert err(got, oracle) <= TOL[dtype], (b, log, m.stride(), cf)
            got = _entry_det(_stride2(a), log, torch.empty(b, 1, dtype=dtype, device="cuda"))
            torch.cuda.synchronize()
            assert torch.equal(got, launch(a)), (b, log)
    # a broadcast batch (stride 0), through the channel-first wrappers and
    # the public ops
    one = torch.tensor(_general(rng, 1, n).reshape(n * n, 1), dtype=dtype, device="cuda")
    for wrapper, public, err in ((det_cf, T.batchdet, _rel), (logdet_cf, T.batchlogdet, _log_err)):
        got = wrapper(one.expand(-1, 515))
        assert err(got, wrapper(one.cpu().expand(-1, 515))) <= TOL[dtype]
        got = public(one.reshape(1, n, n).expand(515, n, n))
        assert err(got, public(one.reshape(1, n, n).cpu()).expand(515)) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8])
def test_staged_det_keeps_a_bad_problem_to_itself(n, dtype, rng):
    # singular and NaN problems, either side of two block edges: a singular
    # problem's det is 0 or NaN and its log|det| not finite, a NaN
    # problem's both NaN, and every other problem's are the bits of a batch
    # without them
    b, bad = 1029, (63, 64, 127, 128)
    a = torch.tensor(_general(rng, b, n).reshape(b, n * n), dtype=dtype, device="cuda")
    keep = torch.ones(b, dtype=torch.bool)
    keep[list(bad)] = False
    for launch, _, plain, log in DETS:
        good = launch(a)
        m0 = a.clone()
        m0[bad[0]] = 0
        m0[bad[1], 0] = float("nan")
        m0[bad[2], -1] = float("nan")
        m0[bad[3]] = 0
        for m, cf in ((m0, False), (_cf(m0), True), (_misaligned(m0), False)):
            got = launch(m, cf_out=cf).cpu()
            torch.cuda.synchronize()
            for i in (bad[0], bad[3]):
                if log:
                    assert not torch.isfinite(got[i]), (i, cf)
                else:
                    assert got[i] == 0 or torch.isnan(got[i]), (i, cf)
            for i in (bad[1], bad[2]):
                assert torch.isnan(got[i]), (i, log, cf)
            assert torch.equal(got[keep], good.cpu()[keep]), (log, cf)
            want = plain(m0[keep.cuda()])
            assert (_log_err if log else _rel)(got[keep], want) <= TOL[dtype]


def _entry_sym_invert(m, out):
    """``fm_sym_invert`` on the operands' own strides (the wrappers take
    channel stride 1 only); returns ``out``."""
    n = round(((8 * m.shape[1] + 1) ** 0.5 - 1) / 2)
    err = sym_factor._library().fm_sym_invert(
        0 if m.dtype == torch.float32 else 1, n, m.shape[0], m.data_ptr(), *m.stride(),
        out.data_ptr(), *out.stride(), torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return out


# the staged compact inverse's blocks hold 128 problems at every N <= 8 in
# both dtypes: one problem, a few, one less and one more than a block, and
# a ragged batch of many
SYM_INVERT_BATCHES = (1, 5, 127, 129, 4099)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8])
def test_staged_sym_invert_batches_and_views(n, dtype, rng):
    # the staged tier's three orders of device memory (16-byte vectors,
    # batch-fastest, element by element) on indefinite problems (pivoting
    # at 5..8), every view the same bits, and a channel stride of 2 in and
    # out through the entry point
    for b in SYM_INVERT_BATCHES:
        c = torch.tensor(_compact(_symmetric(rng, b, n)), dtype=dtype, device="cuda")
        want = sym_factor.invert_plain(c)
        oracle = torch.from_numpy(_compact(np.linalg.inv(sym_to_full(c.double().cpu()).numpy())))
        first = sym_factor.launch_sym_invert(c)
        views = ((c, False), (_cf(c), True), (_cf(c), False), (c, True), (_misaligned(c), False))
        for m, cf in views:
            before = sym_invert_cf.launches
            got = sym_factor.launch_sym_invert(m, cf_out=cf)
            assert sym_invert_cf.launches == before + 1
            torch.cuda.synchronize()
            assert torch.equal(got, first), (b, m.stride(), cf)
            assert _rel(got, want) <= TOL[dtype], (b, m.stride(), cf)
            assert _rel(got, oracle) <= TOL[dtype], (b, m.stride(), cf)
        got = _entry_sym_invert(_stride2(c), _stride2(torch.empty_like(c)))
        torch.cuda.synchronize()
        assert torch.equal(got, first), b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8])
def test_staged_sym_invert_keeps_a_bad_problem_to_itself(n, dtype, rng):
    # a singular (zero) and a NaN problem either side of a block edge: each
    # inverse holds a value that is not finite, and every other problem's
    # is the bits of a batch without them
    b, bad = 1029, (127, 128)
    c = torch.tensor(_compact(_symmetric(rng, b, n)), dtype=dtype, device="cuda")
    good = sym_factor.launch_sym_invert(c)
    m0 = c.clone()
    m0[bad[0]] = 0
    m0[bad[1], 0] = float("nan")
    keep = torch.ones(b, dtype=torch.bool)
    keep[list(bad)] = False
    for m, cf in ((m0, False), (_cf(m0), True), (_misaligned(m0), False)):
        got = sym_factor.launch_sym_invert(m, cf_out=cf).cpu()
        torch.cuda.synchronize()
        for i in bad:
            assert not torch.isfinite(got[i]).all(), (i, cf)
        assert torch.equal(got[keep], good.cpu()[keep]), cf
        want = sym_factor.invert_plain(m0[keep.cuda()])
        assert _rel(got[keep], want) <= TOL[dtype], cf


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
