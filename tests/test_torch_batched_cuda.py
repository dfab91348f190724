"""The port's full-storage batched kernels (solve and inverse) against their
plain PyTorch versions and float64 numpy, on the card.

Every test here is marked ``cuda`` and skips on a machine without an
NVIDIA GPU (the kernels have no CPU mode). This file imports neither JAX
nor ``fastmath_tpu``, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_batched_cuda.py -m cuda --noconftest -p no:cacheprovider

Tolerances (normwise): float32 1e-5 and float64 1e-12. The kernels contract
multiply-adds into FMAs and the plain version does not, which moves each
result by a few ulp per operation; the matrices are SPD, or general with n
on the diagonal and their rows shuffled (so pivoting swaps rows at most
steps), with condition numbers below ~5.
"""
import numpy as np
import pytest
import torch

import fastmath_tpu_torch as T
from fastmath_tpu_torch.kernels import batched_cuda, inv_cf, solve_full_cf

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture(autouse=True)
def _needs_card(request):
    if request.node.get_closest_marker("cuda") and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _matrices(rng, b, n, kind):
    a = rng.standard_normal((b, n, n))
    if kind == "spd":
        return a @ a.transpose(0, 2, 1) + n * np.eye(n)
    # n I + (sqrt(n) / 4) a, rows shuffled: singular values near [n/2, 3n/2]
    perm = np.argsort(rng.random((b, n)), axis=-1)
    return np.take_along_axis(n * np.eye(n) + np.sqrt(n) / 4 * a, perm[..., None], axis=1)


def _normwise(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()


def _cf(t):
    """The channel-first copy of a (B, K) tensor, seen as a (B, K) view."""
    return t.t().contiguous().t()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 32])
def test_kernels_match_plain(n, dtype, rng):
    b = 1029  # ragged last block
    for kind in ("pivoting", "spd"):
        a64 = _matrices(rng, b, n, kind)
        a = torch.tensor(a64.reshape(b, n * n), dtype=dtype, device="cuda")
        want = batched_cuda.inv_plain(a)
        oracle = torch.from_numpy(np.linalg.inv(a.double().cpu().numpy().reshape(b, n, n)))
        for m, cf in ((a, False), (_cf(a), True)):
            before = inv_cf.launches
            got = batched_cuda.launch_inv(m, cf_out=cf)
            assert inv_cf.launches == before + 1
            torch.cuda.synchronize()
            assert _normwise(got, want) <= TOL[dtype]
            assert _normwise(got, oracle.reshape(b, n * n)) <= TOL[dtype]
        for k in ((1, 3, 8) if n <= 8 else (1, 16)):
            rhs = torch.tensor(rng.standard_normal((b, n * k)), dtype=dtype, device="cuda")
            for trans in (False, True):
                want = batched_cuda.solve_full_plain(a, rhs, k, trans)
                am = a.double().cpu().reshape(b, n, n)
                oracle = torch.linalg.solve(am.mT if trans else am,
                                            rhs.double().cpu().reshape(b, n, k))
                for m, r, cf in ((a, rhs, False), (_cf(a), _cf(rhs), True)):
                    before = solve_full_cf.launches
                    got = batched_cuda.launch_solve_full(m, r, k, trans, cf_out=cf)
                    assert solve_full_cf.launches == before + 1
                    torch.cuda.synchronize()
                    assert _normwise(got, want) <= TOL[dtype]
                    assert _normwise(got, oracle.reshape(b, n * k)) <= TOL[dtype]


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
def test_staged_inverse_batches_and_views(n, dtype, rng):
    # the staged tier's three orders of device memory (16-byte vectors,
    # batch-fastest, element by element) at every edge of its blocks
    for b in STAGED_BATCHES:
        a = torch.tensor(_matrices(rng, b, n, "pivoting").reshape(b, n * n), dtype=dtype,
                         device="cuda")
        want = batched_cuda.inv_plain(a)
        oracle = torch.from_numpy(np.linalg.inv(a.double().cpu().numpy().reshape(b, n, n)))
        views = ((a, False), (_cf(a), True), (_cf(a), False), (a, True), (_misaligned(a), False))
        for m, cf in views:
            before = inv_cf.launches
            got = batched_cuda.launch_inv(m, cf_out=cf)
            assert inv_cf.launches == before + 1
            torch.cuda.synchronize()
            assert _normwise(got, want) <= TOL[dtype], (b, m.stride(), cf)
            assert _normwise(got, oracle.reshape(b, n * n)) <= TOL[dtype], (b, m.stride(), cf)
    # a broadcast batch (stride 0), through the channel-first wrapper and
    # the public op
    one = torch.tensor(_matrices(rng, 1, n, "pivoting").reshape(n * n, 1), dtype=dtype,
                       device="cuda")
    got = inv_cf(one.expand(-1, 515))
    assert _normwise(got.t(), inv_cf(one.cpu().expand(-1, 515)).t()) <= TOL[dtype]
    got = T.batchinv(one.reshape(1, n, n).expand(515, n, n))
    assert _normwise(got.reshape(515, -1), T.batchinv(one.reshape(1, n, n).cpu()).reshape(
        1, -1).expand(515, -1)) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 3, 5, 8])
def test_staged_inverse_keeps_a_bad_problem_to_itself(n, dtype, rng):
    # singular and NaN problems, either side of two block edges: their
    # results are not finite, and every other problem's are the bits of a
    # batch without them
    b, bad = 1029, (63, 64, 127, 128)
    a = torch.tensor(_matrices(rng, b, n, "pivoting").reshape(b, n * n), dtype=dtype,
                     device="cuda")
    good = batched_cuda.launch_inv(a)
    a[bad[0]] = 0
    a[bad[1], 0] = float("nan")
    a[bad[2], -1] = float("nan")
    a[bad[3]] = 0
    keep = torch.ones(b, dtype=torch.bool)
    keep[list(bad)] = False
    for m, cf in ((a, False), (_cf(a), True), (_misaligned(a), False)):
        got = batched_cuda.launch_inv(m, cf_out=cf)
        torch.cuda.synchronize()
        for k in bad:
            assert not torch.isfinite(got[k]).all(), (k, cf)
        assert torch.equal(got.cpu()[keep], good.cpu()[keep])
        want = batched_cuda.inv_plain(a[keep.to(a.device)])
        assert _normwise(got[keep.to(a.device)], want) <= TOL[dtype]


# the n <= 8 solve stages A and up to 8 columns of B, 128 problems a block
# (64 or 32 at the wider n and in float64), and takes wider B unstaged: one
# column, the staged width and either side of it, and 40; batches of one, a
# few, either side of a block, and many
SOLVE_STAGED_KS = (1, 7, 8, 9, 40)
SOLVE_BATCHES = (1, 5, 127, 129, 4099)


def _stride2(x):
    """``x`` (B, K) as a view at channel stride 2."""
    view = torch.zeros(x.shape[0], 2 * x.shape[1], dtype=x.dtype, device=x.device)[:, ::2]
    view.copy_(x)
    return view


def _entry_solve(a, rhs, k, trans, out):
    """``fm_solve_full`` on the operands' own strides (the wrappers take
    channel stride 1 only)."""
    n = round(a.shape[1] ** 0.5)
    err = batched_cuda._library().fm_solve_full(
        0 if a.dtype == torch.float32 else 1, n, k, a.shape[0], a.data_ptr(), *a.stride(),
        int(trans), rhs.data_ptr(), *rhs.stride(), out.data_ptr(), *out.stride(),
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8])
def test_staged_solve_batches_and_views(n, dtype, rng):
    # the staged tier's three orders of device memory (16-byte vectors,
    # batch-fastest, element by element), A read as it is and transposed,
    # at every edge of its blocks and of its width
    for b in SOLVE_BATCHES:
        a = torch.tensor(_matrices(rng, b, n, "pivoting").reshape(b, n * n), dtype=dtype,
                         device="cuda")
        a64 = a.double().cpu().reshape(b, n, n)
        for k in sorted({n, *SOLVE_STAGED_KS}):
            rhs = torch.tensor(rng.standard_normal((b, n * k)), dtype=dtype, device="cuda")
            for trans in (False, True):
                want = batched_cuda.solve_full_plain(a, rhs, k, trans)
                oracle = torch.linalg.solve(a64.mT if trans else a64,
                                            rhs.double().cpu().reshape(b, n, k)).reshape(b, -1)
                views = ((a, rhs, False), (_cf(a), _cf(rhs), True), (_cf(a), _cf(rhs), False),
                         (a, rhs, True), (_misaligned(a), _misaligned(rhs), False))
                for m, r, cf in views:
                    before = solve_full_cf.launches
                    got = batched_cuda.launch_solve_full(m, r, k, trans, cf_out=cf)
                    assert solve_full_cf.launches == before + 1
                    torch.cuda.synchronize()
                    case = (b, k, trans, m.stride(), cf)
                    assert _normwise(got, want) <= TOL[dtype], case
                    assert _normwise(got, oracle) <= TOL[dtype], case
                for m, r, out in ((_stride2(a), rhs, torch.empty_like(want)),
                                  (a, _stride2(rhs), torch.empty_like(want)),
                                  (a, rhs, _stride2(want))):
                    got = _entry_solve(m, r, k, trans, out)
                    torch.cuda.synchronize()
                    case = (b, k, trans, m.stride(), r.stride(), out.stride())
                    assert torch.equal(got, batched_cuda.launch_solve_full(a, rhs, k, trans)), case
                    assert _normwise(got, want) <= TOL[dtype], case


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 3, 5, 8])
def test_staged_solve_keeps_a_bad_problem_to_itself(n, dtype, rng):
    # singular and NaN problems either side of the edges of blocks of 32,
    # 64 and 128: their solutions are not finite, and every other problem's
    # are the bits of a batch without them
    b, bad = 1029, (31, 32, 127, 128)
    a = torch.tensor(_matrices(rng, b, n, "pivoting").reshape(b, n * n), dtype=dtype,
                     device="cuda")
    keep = torch.ones(b, dtype=torch.bool)
    keep[list(bad)] = False
    for k in sorted({1, n, 8}):
        rhs = torch.tensor(rng.standard_normal((b, n * k)), dtype=dtype, device="cuda")
        for trans in (False, True):
            m0 = a.clone()
            good = batched_cuda.launch_solve_full(m0, rhs, k, trans)
            m0[bad[0]] = 0
            m0[bad[1], 0] = float("nan")
            m0[bad[2], -1] = float("nan")
            m0[bad[3]] = 0
            for m, r, cf in ((m0, rhs, False), (_cf(m0), _cf(rhs), True),
                             (_misaligned(m0), _misaligned(rhs), False)):
                got = batched_cuda.launch_solve_full(m, r, k, trans, cf_out=cf)
                torch.cuda.synchronize()
                for i in bad:
                    assert not torch.isfinite(got[i]).all(), (i, k, trans, cf)
                assert torch.equal(got.cpu()[keep], good.cpu()[keep]), (k, trans, cf)
                want = batched_cuda.solve_full_plain(m0[keep.cuda()], rhs[keep.cuda()], k, trans)
                assert _normwise(got[keep.cuda()], want) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cf_wrappers_take_strided_operands(dtype, rng):
    # channel-first operands in neither layout the kernels read: a strided
    # batch slice, a row slice of a wider buffer, a broadcast batch dim
    n, k = 5, 2
    a = torch.tensor(_matrices(rng, 2 * 515, n, "pivoting").reshape(-1, n * n).T,
                     dtype=dtype, device="cuda")
    wide = torch.tensor(rng.standard_normal((n * k + 3, 2 * 515)), dtype=dtype, device="cuda")
    cases = [(a[:, ::2], wide[:n * k, ::2]), (a[:, :515], wide[3:, :515]),
             (a[:, :1], wide[:n * k, :515])]
    for m, r in cases:
        before = (solve_full_cf.launches, inv_cf.launches)
        x, y = solve_full_cf(m, r, k=k), inv_cf(m)
        assert (solve_full_cf.launches, inv_cf.launches) == (before[0] + 1, before[1] + 1)
        assert x.shape == (n * k, r.shape[1]) and y.shape == m.shape
        assert _normwise(x.t(), solve_full_cf(m.cpu(), r.cpu(), k=k).t()) <= TOL[dtype]
        assert _normwise(y.t(), inv_cf(m.cpu()).t()) <= TOL[dtype]


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(rng):
    a = torch.tensor(_matrices(rng, 8, 3, "spd").reshape(8, 9), device="cuda")
    with pytest.raises(ValueError, match="float32/float64"):
        batched_cuda.launch_inv(a.half())
    with pytest.raises(ValueError, match="shape"):
        batched_cuda.launch_solve_full(a, a[:, :6], 1)
    with pytest.raises(ValueError, match="dtype|float32"):
        batched_cuda.launch_solve_full(a, a[:, :3].float(), 1)
    # no limit on k: 34 columns at n = 32 (a block of 32 columns and a
    # ragged block of 2) are solved, against the plain version and float64
    a32 = torch.tensor(_matrices(rng, 3, 32, "pivoting").reshape(3, -1), dtype=torch.float32,
                       device="cuda")
    r34 = torch.tensor(rng.standard_normal((3, 32 * 34)), dtype=torch.float32, device="cuda")
    x = batched_cuda.launch_solve_full(a32, r34, 34)
    assert x.shape == (3, 32 * 34)
    assert _normwise(x, batched_cuda.solve_full_plain(a32, r34, 34)) <= TOL[torch.float32]
    oracle = torch.linalg.solve(a32.double().cpu().reshape(3, 32, 32),
                                r34.double().cpu().reshape(3, 32, 34))
    assert _normwise(x, oracle.reshape(3, -1)) <= TOL[torch.float32]
    with pytest.raises(ValueError, match="regularize"):
        T.batchinv(a.reshape(8, 3, 3), regularize=True, backend="cuda")
    with pytest.raises(ValueError, match="kernel serves"):
        T.batchinv(torch.eye(33, device="cuda"), backend="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 6, 12])
def test_public_ops_launch_and_grads(n, rng):
    a = torch.tensor(_matrices(rng, 515, n, "pivoting"), device="cuda")
    v = torch.tensor(rng.standard_normal((515, n)), device="cuda")
    b = torch.tensor(rng.standard_normal((515, n, 2)), device="cuda")
    before = (solve_full_cf.launches, inv_cf.launches)
    outs = (T.batchinv(a), T.batchlmdiv(a, v), T.batchlmdiv(a, b), T.batchrmdiv(b.mT, a))
    # n <= 4: the solves multiply by the inverse kernel's output
    solves = 0 if n <= 4 else 3
    assert (solve_full_cf.launches, inv_cf.launches) == (
        before[0] + solves, before[1] + 1 + (3 - solves))
    wants = (T.batchinv(a.cpu()), T.batchlmdiv(a.cpu(), v.cpu()),
             T.batchlmdiv(a.cpu(), b.cpu()), T.batchrmdiv(b.mT.cpu(), a.cpu()))
    for got, want in zip(outs, wants):
        assert _normwise(got.reshape(515, -1), want.reshape(515, -1)) <= TOL[torch.float64]

    def grads(backend):
        ins = [t.clone().requires_grad_() for t in (a, v, b)]
        out = (T.batchinv(ins[0], backend=backend).square().sum()
               + T.batchlmdiv(ins[0], ins[1], backend=backend).square().sum()
               + T.batchlmdiv(ins[0], ins[2], backend=backend).square().sum())
        before = solve_full_cf.launches
        g = torch.autograd.grad(out, ins)
        return g, solve_full_cf.launches - before

    (kernel, bwd), (plain, _) = grads("auto"), grads("torch")
    for k, p in zip(kernel, plain):
        assert ((k - p).norm() / p.norm()).item() <= 1e-10
    # the solves' backward runs the solve kernel on A transposed
    assert bwd == (0 if n <= 4 else 2)


@pytest.mark.cuda
def test_sym_solve_dense_storage_on_the_card(rng):
    for n, storage in ((4, "full"), (6, "full"), (40, "compact")):
        full = _matrices(rng, 257, n, "spd")
        if storage == "full":
            mat = torch.tensor(full.reshape(257, n * n), device="cuda")
        else:
            mat = T.layouts.full_to_sym(torch.tensor(full, device="cuda"))
        v = torch.tensor(rng.standard_normal((257, n)), device="cuda")
        before = (solve_full_cf.launches, inv_cf.launches)
        x = T.sym_solve(mat, v, eps=0.1, refine=1)
        launched = (solve_full_cf.launches - before[0], inv_cf.launches - before[1])
        # refine=1: two batchlmdiv calls; compact N > 32 runs torch.linalg
        assert launched == {4: (0, 2), 6: (2, 0), 40: (0, 0)}[n]
        want = T.sym_solve(mat.cpu(), v.cpu(), eps=0.1, refine=1)
        assert _normwise(x, want) <= TOL[torch.float64]
