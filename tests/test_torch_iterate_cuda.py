"""The port's matvec-chain, power-iteration, full-matvec and matmul kernels
against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips on a machine without an
NVIDIA GPU (the kernels have no CPU mode). This file imports neither JAX
nor ``fastmath_tpu``, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_iterate_cuda.py -m cuda --noconftest -p no:cacheprovider

Tolerances: float32 1e-5 and float64 1e-12, normwise per problem (over
``|x| + |(vec, add)|`` for the chain, whose steps round terms as large as
``vec`` and ``add`` while ``x`` can be small; over the
Gershgorin bound ``max_i sum_j |a_ij|`` for the eigenvalue estimate, a
Rayleigh quotient whose terms cancel before the iteration converges; over
``|y| + ||A| |B||`` for the products, whose sums can cancel).
The kernels contract multiply-adds into FMAs and the plain
versions do not, which moves each result by a few ulp per operation; the
chain's matrices are contractions (eigenvalues in [-0.9, 0.9]) and the
power iteration's have a dominant eigenvalue well apart from the rest, so
neither amplifies those roundings.
"""
import numpy as np
import pytest
import torch

import fastmath_tpu_torch as T
from fastmath_tpu_torch.kernels import (batched_cuda, matmul_cf, matvec_full_cf, sym_iterate,
                                        sym_matvec_chain_cf, sym_maxeig_cf)
from fastmath_tpu_torch.layouts import full_to_sym, sym_to_full
from fastmath_tpu_torch.ops.batched import MATMUL_KERNEL_MAX

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
B = 4099  # a ragged last block
# the tiers, and the lane groups' edges and padded lanes (G = 16 to n = 16,
# 32 above)
NS = [1, 2, 3, 4, 5, 8, 9, 12, 16, 17, 24, 32]


@pytest.fixture(autouse=True)
def _needs_card(request):
    if request.node.get_closest_marker("cuda") and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _contraction(rng, b, n):
    """Compact symmetric Q diag(w) Qᵀ, w in [-0.9, 0.9]."""
    q, _ = np.linalg.qr(rng.standard_normal((b, n, n)))
    w = rng.uniform(-0.9, 0.9, (b, n))
    s = np.einsum("bik,bk,bjk->bij", q, w, q)
    return full_to_sym(torch.from_numpy(0.5 * (s + s.transpose(0, 2, 1)))).numpy()


def _gapped(rng, b, n, start=False):
    """Compact symmetric matrices with a dominant eigenvalue 8 n apart;
    with ``start``, also start vectors u + r / 2, u the boost direction and
    r a random unit vector (a start vector nearly orthogonal to the
    dominant eigenvector makes the first steps amplify every rounding, in
    the kernel and the plain version alike)."""
    a = rng.standard_normal((b, n, n))
    u, r = (x / np.linalg.norm(x, axis=-1, keepdims=True)
            for x in (rng.standard_normal((b, n)), rng.standard_normal((b, n))))
    s = (a + a.transpose(0, 2, 1)) / 2 + 8.0 * n * u[:, :, None] * u[:, None, :]
    c = full_to_sym(torch.from_numpy(s)).numpy()
    return (c, u + r / 2) if start else c


def _dev(x, dtype):
    return torch.tensor(x, dtype=dtype, device="cuda")


def _cf(t):
    """The channel-first copy of a (B, K) tensor, seen as a (B, K) view."""
    return t.t().contiguous().t()


def _gershgorin(mat, n):
    """(B, 1) Gershgorin bounds of compact ``mat`` (B, NN)."""
    return sym_to_full(mat.double().cpu(), n).abs().sum(dim=-1).amax(dim=-1, keepdim=True)


def _rel(got, want, extra=None):
    got, want = got.double().cpu(), want.double().cpu()
    scale = want.norm(dim=-1)
    if extra is not None:
        scale = scale + extra.double().cpu().norm(dim=-1)
    return ((got - want).norm(dim=-1) / scale).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", NS)
def test_matvec_chain_kernel_matches_plain(n, dtype, rng):
    mat = _dev(_contraction(rng, B, n), dtype)
    vec, add = (_dev(rng.standard_normal((B, n)), dtype) for _ in range(2))
    for iters in (0, 1, 7):
        for c in (None, add):
            want = sym_iterate.matvec_chain_plain(mat, vec, c, iters)
            for layout, lay in (("bm", lambda t: t), ("cf", _cf)):
                got = sym_iterate.launch_matvec_chain(
                    lay(mat), lay(vec), None if c is None else lay(c), iters,
                    cf_out=layout == "cf")
                torch.cuda.synchronize()
                terms = vec if c is None else torch.cat([vec, c], dim=-1)
                assert _rel(got, want, terms) <= TOL[dtype], (iters, c is None, layout)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", NS)
def test_maxeig_kernel_matches_plain(n, dtype, rng):
    mat, vec = (_dev(x, dtype) for x in _gapped(rng, B, n, start=True))
    g = _gershgorin(mat, n)
    for iters in (0, 5, 32):
        for r in (1, 8, 16):
            want = sym_iterate.maxeig_plain(mat, vec, iters, r)
            for layout, lay in (("bm", lambda t: t), ("cf", _cf)):
                got = sym_iterate.launch_maxeig(lay(mat), lay(vec), iters, r,
                                                cf_out=layout == "cf")
                torch.cuda.synchronize()
                mu_err = ((got[:, :1] - want[:, :1]).double().cpu().abs() / g).max().item()
                assert mu_err <= TOL[dtype], (iters, r, layout)
                assert _rel(got[:, 1:], want[:, 1:]) <= TOL[dtype], (iters, r, layout)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [4, 12, 24])
def test_maxeig_nan_and_zero_rows_match_plain(n, dtype, rng):
    """A NaN entry (in two rows, as the matrix is symmetric) and an
    all-zero row among nonzero problems: NaN exactly where the plain
    version has NaN, the rest within the tolerance, and the neighbours
    unchanged. The Gershgorin bound's maximum drops the NaN row sum
    (fm_max) where the plain version's torch.maximum keeps it; both scale
    the finite entries to values that the NaN then reaches."""
    gap, start = _gapped(rng, 40, n, start=True)
    full = sym_to_full(torch.from_numpy(gap), n)
    full[3, 1, :] = 0.0
    full[3, :, 1] = 0.0
    full[7, n - 1, 2] = full[7, 2, n - 1] = float("nan")
    mat, vec = _dev(full_to_sym(full).numpy(), dtype), _dev(start, dtype)
    clean = [i for i in range(40) if i != 7]
    for iters in (0, 1, 5, 32):
        want = sym_iterate.maxeig_plain(mat, vec, iters, 8)
        got = sym_iterate.launch_maxeig(mat, vec, iters, 8)
        alone = sym_iterate.launch_maxeig(mat[clean], vec[clean], iters, 8)
        torch.cuda.synchronize()
        assert torch.equal(torch.isnan(got), torch.isnan(want)), iters
        assert torch.isnan(got[7, 0]) and not torch.isnan(got[clean]).any(), iters
        assert torch.equal(got[clean], alone), iters
        g = _gershgorin(mat[clean], n)
        mu_err = ((got[clean, :1] - want[clean, :1]).double().cpu().abs() / g).max().item()
        assert mu_err <= TOL[dtype], iters
        assert _rel(got[clean, 1:], want[clean, 1:]) <= TOL[dtype], iters


@pytest.mark.cuda
def test_maxeig_zero_matrix_stays_finite():
    mat = torch.zeros(300, 10, device="cuda")
    out = sym_iterate.launch_maxeig(mat, torch.ones(300, 4, device="cuda"), 9, 4)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and (out[:, 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", NS)
def test_matvec_full_kernel_matches_plain(n, dtype, rng):
    mat = _dev(rng.standard_normal((B, n * n)), dtype)
    vec = _dev(rng.standard_normal((B, n)), dtype)
    for trans in (False, True):
        want = batched_cuda.matvec_full_plain(mat, vec, trans)
        terms = batched_cuda.matvec_full_plain(mat.abs(), vec.abs(), trans)
        for layout, lay in (("bm", lambda t: t), ("cf", _cf)):
            got = batched_cuda.launch_matvec_full(lay(mat), lay(vec), trans,
                                                  cf_out=layout == "cf")
            torch.cuda.synchronize()
            assert _rel(got, want, terms) <= TOL[dtype], (trans, layout)


# the entry tier's and each tile tier's edges: ragged tiles (13 x 5 x 17),
# k = 1 beside the largest C (32 x 1 x 32), square n = 8, 12, 17
MKN = [(1, 1, 1), (2, 3, 4), (4, 4, 4), (6, 6, 6), (7, 3, 5), (1, 32, 1), (8, 8, 8),
       (12, 12, 12), (13, 5, 17), (16, 16, 16), (17, 17, 17), (32, 1, 32), (32, 32, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mkn", MKN)
def test_matmul_kernel_matches_plain(mkn, dtype, rng):
    m, k, n = mkn
    a = _dev(rng.standard_normal((B, m * k)), dtype)
    b = _dev(rng.standard_normal((B, k * n)), dtype)
    for ta in (False, True):
        for tb in (False, True):
            want = batched_cuda.matmul_plain(a, b, m, k, n, ta, tb)
            terms = batched_cuda.matmul_plain(a.abs(), b.abs(), m, k, n, ta, tb)
            for layout, lay in (("bm", lambda t: t), ("cf", _cf)):
                got = batched_cuda.launch_matmul(lay(a), lay(b), m, k, n, ta, tb,
                                                 cf_out=layout == "cf")
                torch.cuda.synchronize()
                assert _rel(got, want, terms) <= TOL[dtype], (ta, tb, layout)


@pytest.mark.cuda
def test_cf_wrappers_strided_and_broadcast(rng):
    """Strided slices and broadcast batch dims go through the wrappers'
    copies; results match the same call on CPU tensors."""
    n = 4
    big = torch.tensor(_contraction(rng, 2 * 37, n).T.copy(), device="cuda")
    mat = big[:, None, ::2]  # (10, 1, 37), batch stride 2
    vec = torch.tensor(rng.standard_normal((n, 3, 1)), device="cuda")
    add = torch.tensor(rng.standard_normal((n, 1, 37)), device="cuda")
    cases = [
        (sym_matvec_chain_cf, (mat, vec, 4), {"add": add}),
        (sym_maxeig_cf, (torch.tensor(_gapped(rng, 37, n).T.copy(), device="cuda")[:, None],
                         vec), {"iters": 12, "renorm_every": 5}),
        (matvec_full_cf, (torch.tensor(rng.standard_normal((16, 1, 37)), device="cuda"),
                          vec), {}),
        (matmul_cf, (torch.tensor(rng.standard_normal((12, 3, 1)), device="cuda"),
                     torch.tensor(rng.standard_normal((8, 1, 5)), device="cuda"),
                     3, 2), {}),
    ]
    for fn, args, kw in cases:
        got = fn(*args, **kw)
        cpu = lambda x: x.cpu() if torch.is_tensor(x) else x  # noqa: E731
        want = fn(*map(cpu, args), **{k: cpu(v) for k, v in kw.items()})
        torch.cuda.synchronize()
        assert got.shape == want.shape, fn.__name__
        assert torch.allclose(got.cpu(), want, rtol=1e-12, atol=1e-12), fn.__name__


def _launches():
    return tuple(f.launches for f in (sym_matvec_chain_cf, sym_maxeig_cf, matvec_full_cf,
                                      matmul_cf))


@pytest.mark.cuda
def test_public_ops_route_to_kernels(rng):
    dev = "cuda"
    K = MATMUL_KERNEL_MAX
    mat = torch.tensor(_contraction(rng, 64, 4), device=dev)
    vec = torch.tensor(rng.standard_normal((64, 4)), device=dev)
    full = torch.tensor(rng.standard_normal((64, 4, 4)), device=dev)
    # (op, call, index of the counter that must move, whether it must move)
    cases = [
        (lambda: T.sym_matvec_chain(mat, vec, 1), 0, False),
        (lambda: T.sym_matvec_chain(mat, vec, 2), 0, True),
        (lambda: T.sym_matvec_chain(mat, vec, 1, backend="cuda"), 0, True),
        (lambda: T.sym_maxeig(mat, iters=0), 1, False),
        (lambda: T.sym_maxeig(mat, iters=0, backend="cuda"), 1, True),
        (lambda: T.sym_maxeig(mat, iters=3), 1, True),
        (lambda: T.batchmatvec(full, vec), 2, True),
        (lambda: T.batchmatvec(full[:, :3], vec), 2, False),
        (lambda: T.batchmatmul(full, full), 3, True),
        (lambda: T.batchmatmul(full[:, :, :3], full[:, :3]), 3, True),
        (lambda: T.batchmatmul(torch.ones(5, 7, 7, device=dev), torch.ones(5, 7, 7, device=dev),
                               backend="cuda"), 3, True),
        (lambda: T.batchmatmul(full, full, backend="torch"), 3, False),
        # auto takes the kernel at every dim up to MATMUL_KERNEL_MAX (the
        # kernel's whole domain, 32), torch.matmul beyond
        (lambda: T.batchmatmul(torch.ones(5, K, 3, device=dev), torch.ones(5, 3, K, device=dev)),
         3, True),
        (lambda: T.batchmatmul(torch.ones(5, 2, K + 1, device=dev),
                               torch.ones(5, K + 1, 2, device=dev)), 3, False),
    ]
    for i, (call, idx, moves) in enumerate(cases):
        before = _launches()
        call()
        assert (_launches()[idx] > before[idx]) == moves, i
    with pytest.raises(ValueError, match="kernel serves"):
        T.batchmatmul(torch.ones(2, 33, 1, device=dev), torch.ones(2, 1, 1, device=dev),
                      backend="cuda")


@pytest.mark.cuda
def test_public_ops_match_cpu(rng):
    """The public ops on the card (kernels) against the same on the CPU
    (plain versions), float64."""
    for n in (3, 12):
        mat = torch.tensor(_contraction(rng, 130, n))
        gap, vec = (torch.tensor(x) for x in _gapped(rng, 130, n, start=True))
        a = torch.tensor(rng.standard_normal((130, n, n)))
        b = torch.tensor(rng.standard_normal((130, n, 5)))
        calls = [
            lambda m, v, g, x, y: T.sym_matvec_chain(m, v, 9, add=v),
            lambda m, v, g, x, y: T.sym_maxeig(g, iters=20, return_vector=True)[1],
            lambda m, v, g, x, y: T.sym_maxeig(g, iters=20, v0=v),
            lambda m, v, g, x, y: T.batchmatvec(x, v),
            lambda m, v, g, x, y: T.batchmatmul(x, y, backend="cuda" if m.is_cuda else "auto"),
        ]
        for i, call in enumerate(calls):
            want = call(mat, vec, gap, a, b)
            got = call(*(t.cuda() for t in (mat, vec, gap, a, b)))
            torch.cuda.synchronize()
            assert torch.allclose(got.cpu(), want, rtol=1e-11, atol=1e-11), (n, i)


@pytest.mark.cuda
def test_gradients_match_cpu(rng):
    """Gradients through the kernels (card) against the same through the
    plain versions (CPU), float64; the chain's, the matvec's and the
    product's backward launch their kernels."""
    n = 5
    gap, start = _gapped(rng, 70, n, start=True)
    ins0 = [torch.tensor(x) for x in (_contraction(rng, 70, n), start,
                                      rng.standard_normal((70, n)), gap,
                                      rng.standard_normal((70, n, n)),
                                      rng.standard_normal((70, n, 3)))]

    def grads(device):
        ins = [t.to(device).clone().requires_grad_() for t in ins0]
        m, v, c, g, a, b = ins
        backend = "cuda" if device == "cuda" else "torch"
        loss = (T.sym_matvec_chain(m, v, 6, add=c, backend=backend).square().sum()
                + T.sym_maxeig(g, iters=40, v0=v, backend=backend).square().sum()
                + T.batchmatmul(a, b, backend=backend).square().sum())
        mv = T.batchmatvec(a[:, :4, :4], v[:, :4])
        loss = loss + mv.square().sum()
        before = _launches()
        out = torch.autograd.grad(loss, ins)
        return [t.cpu() for t in out], [x - y for x, y in zip(_launches(), before)]

    (kernel, bwd), (plain, _) = grads("cuda"), grads("cpu")
    for k, p in zip(kernel, plain):
        assert ((k - p).norm() / p.norm()).item() <= 1e-10
    assert bwd[0] >= 6 and bwd[2] >= 1 and bwd[3] >= 2, bwd


@pytest.mark.cuda
def test_batchchol_triangle_rule_on_card(rng):
    """The kernel route reads the lower triangle for n <= 16 and the
    average above, as the plain tiers on the CPU."""
    for n in (3, 8, 16, 20):
        a = rng.standard_normal((50, n, n))
        s = a @ a.transpose(0, 2, 1) + n * np.eye(n) + 0.1 * rng.standard_normal((50, n, n))
        want = T.batchchol(torch.tensor(s))
        got = T.batchchol(torch.tensor(s, device="cuda"))
        torch.cuda.synchronize()
        assert torch.allclose(got.cpu(), want, rtol=1e-12, atol=1e-12), n
