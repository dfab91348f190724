"""The lane-group tiers (9 <= n <= 32) of the determinant, log-determinant,
inverse, solve, compact determinant and compact inverse kernels
(``csrc/lu_groups.cuh``) on the inputs that exercise their pivot
bookkeeping, and of the Cholesky factor, which shares their row layout,
on the card.

Every test here is marked ``cuda`` and skips on a machine without an
NVIDIA GPU (the kernels have no CPU mode). This file imports neither JAX
nor ``fastmath_tpu``:

    python -m pytest tests/test_torch_factor_groups_cuda.py -m cuda --noconftest -p no:cacheprovider

- Ties: the pivot of a column is the first largest |a[i][k]| in the order
  left by the earlier swaps, which the kernels track without moving rows.
  Signed, row- and column-permuted Hadamard blocks (every entry of a
  column ties), row-permuted scaled identities (every step swaps) and
  small-integer matrices (ties in most columns) must give the plain
  version's determinant signs exactly and its values within ``TOL``:
  float32 1e-5, float64 1e-12, relative for a determinant, ``tol *
  max(1, |logdet|)`` for log|det|, normwise for the inverse, the solve
  (k = 1 and 3), the compact solve (refine 0 and 1, without eps and, on
  the problems it leaves at condition number <= 100, with it) and the
  Cholesky factor of A A^T + n I. The kernels
  contract multiply-adds into FMAs and the plain versions do not. The
  integer matrices are kept to condition numbers <= 60, so that these
  roundings stay within the tolerance.
- Neighbours: a group of 16 lanes shares its warp with another problem.
  A singular or NaN problem must leave its neighbours' bits as they are
  when each runs alone (the compact solve with and without eps and
  refinement too); a problem that is not SPD gives the Cholesky
  factor NaN in every slot, and its SPD neighbours their own bits.
- Ragged grids: batches of 1, 3 and 33 problems, at G = 16 and G = 32,
  give the bits of the same problems in a larger batch.
- Widths: the solve stages B in blocks of G columns, so k = 1, 3, 16, 17
  and 40 at n = 9 and k = 33 at n = 32, reading A as stored and
  transposed, batch-major and channel-first, against the plain version
  and float64 numpy.
- Chains: the compact chain solve forms its inverse with the same LU
  (``chain_groups``), then shares its step with the matvec chain
  (``lu_group_chain``): on the tie matrices it must match the plain
  version within ``TOL``, normwise over the terms (||x|| + ||c||), at 2
  steps (the plain version alone sits at up to 3.4e-6 from float64 there
  in float32); beside a singular or NaN problem, every other problem of
  both chains keeps the bits it has alone, and the poisoned compact chain
  comes back not finite.
"""
import numpy as np
import pytest
import torch

from fastmath_tpu_torch.kernels import (batched_cuda, chol_cf, det_cf, inv_cf, logdet_cf,
                                        solve_full_cf, sym_cuda, sym_det_cf, sym_factor,
                                        sym_invert_cf, sym_iterate, sym_matvec_chain_cf,
                                        sym_solve_chain_cf, sym_solve_cf)
from fastmath_tpu_torch.layouts import full_to_sym

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
DTYPES = [torch.float32, torch.float64]
NS = [9, 16, 17, 32]  # both edges of each group size
# the compact solve's eps and refine steps
EPS = 0.25
SOLVES = [(None, 0), (EPS, 0), (None, 1), (EPS, 1)]


@pytest.fixture(autouse=True)
def _needs_card(request):
    if request.node.get_closest_marker("cuda") and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _hadamard(n):
    """Sylvester's Hadamard block of the largest power of two <= n, then 2 I."""
    h = np.ones((1, 1))
    while 2 * h.shape[0] <= n:
        h = np.block([[h, h], [h, -h]])
    m = 2.0 * np.eye(n)
    m[:h.shape[0], :h.shape[0]] = h
    return m


def _signed_perm(rng, n):
    """A random signed permutation matrix."""
    return np.eye(n)[rng.permutation(n)] * rng.choice([-1.0, 1.0], n)[:, None]


def _well_conditioned_ints(rng, b, n, sym):
    """b matrices of integers in [-2, 2] (symmetric if ``sym``) with
    condition number <= 60."""
    out = []
    while len(out) < b:
        a = rng.integers(-2, 3, (4 * b, n, n)).astype(np.float64)
        if sym:
            a = np.triu(a) + np.triu(a, 1).transpose(0, 2, 1)
        out += [m for m, c in zip(a, np.linalg.cond(a)) if c <= 60]
    return np.stack(out[:b])


def _ties_general(rng, n, b=24):
    """Hadamard blocks under signed permutations of rows and columns,
    row-permuted scaled identities, small-integer matrices."""
    h = _hadamard(n)
    had = [_signed_perm(rng, n) @ h @ _signed_perm(rng, n) for _ in range(b)]
    ident = [np.eye(n)[rng.permutation(n)] * rng.choice([-3.0, -2.0, 2.0, 3.0], n)[:, None]
             for _ in range(b)]
    return np.concatenate([np.stack(had), np.stack(ident),
                           _well_conditioned_ints(rng, b, n, sym=False)])


def _involution(rng, n):
    """A symmetric permutation: disjoint transpositions."""
    p, idx = np.arange(n), rng.permutation(n)
    for q in range(0, n - 1, 2):
        if rng.random() < 0.8:
            p[idx[q]], p[idx[q + 1]] = idx[q + 1], idx[q]
    return np.eye(n)[p]


def _ties_symmetric(rng, n, b=24):
    """P H P^T and D H D for Hadamard blocks H (Sylvester's is symmetric),
    signed symmetric permutations, symmetric small-integer matrices."""
    h = _hadamard(n)
    had = []
    for _ in range(b):
        p, d = np.eye(n)[rng.permutation(n)], np.diag(rng.choice([-1.0, 1.0], n))
        had.append(d @ p @ h @ p.T @ d)
    invol = []
    for _ in range(b):
        d = np.diag(rng.choice([-1.0, 1.0], n))
        invol.append(rng.choice([2.0, 3.0]) * d @ _involution(rng, n) @ d)
    return np.concatenate([np.stack(had), np.stack(invol),
                           _well_conditioned_ints(rng, b, n, sym=True)])


def _compact_lower(L):
    """Compact slots of lower factors (the Cholesky kernel's output): the
    diagonal, then slot (i, j), i < j, holding L[j][i]."""
    rows, cols = np.triu_indices(L.shape[-1], k=1)
    return np.concatenate([np.diagonal(L, axis1=-2, axis2=-1), L[..., cols, rows]], axis=-1)


def _cf(t):
    """The channel-first copy of a (B, K) tensor, seen as a (B, K) view."""
    return t.t().contiguous().t()


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64).cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["batch_major", "channel_first"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", NS)
def test_ties_match_plain(n, dtype, layout, rng):
    tol, cf = TOL[dtype], layout == "channel_first"
    a = torch.tensor(_ties_general(rng, n).reshape(-1, n * n), dtype=dtype, device="cuda")
    sfull = _ties_symmetric(rng, n)
    s = full_to_sym(torch.tensor(sfull, dtype=dtype, device="cuda"))
    a_in, s_in = (_cf(a), _cf(s)) if cf else (a, s.contiguous())

    r = torch.tensor(rng.standard_normal((a.shape[0], 3 * n)), dtype=dtype, device="cuda")
    r1 = r[:, :n].contiguous()
    gram = full_to_sym(a.reshape(-1, n, n) @ a.reshape(-1, n, n).mT
                       + n * torch.eye(n, dtype=dtype, device="cuda")).contiguous()
    r_in, r1_in, g_in = (_cf(r), _cf(r1), _cf(gram)) if cf else (r, r1, gram)
    # the compact solve; with eps only where A + diag(eps) stays well
    # conditioned (eps shifts the diagonal, the off-diagonal ties stay)
    v = torch.tensor(rng.standard_normal((s.shape[0], n)), dtype=dtype, device="cuda")
    ok = torch.from_numpy(np.linalg.cond(sfull + EPS * np.eye(n)) <= 100).to("cuda")
    solves = [(s if e is None else s[ok], v if e is None else v[ok], sym_cuda._prep_eps(e, n),
               rf) for e, rf in SOLVES]

    wrappers = (det_cf, logdet_cf, inv_cf, sym_det_cf, sym_invert_cf, solve_full_cf, chol_cf,
                sym_solve_cf)
    before = [w.launches for w in wrappers]
    det = batched_cuda.launch_det(a_in, cf_out=cf)
    logdet = batched_cuda.launch_logdet(a_in, cf_out=cf)
    inv = batched_cuda.launch_inv(a_in, cf_out=cf)
    sdet = sym_factor.launch_sym_det(s_in, cf_out=cf)
    sinv = sym_factor.launch_sym_invert(s_in, cf_out=cf)
    x1 = batched_cuda.launch_solve_full(a_in, r1_in, 1, cf_out=cf)
    x3 = batched_cuda.launch_solve_full(a_in, r_in, 3, cf_out=cf)
    chol = batched_cuda.launch_chol(g_in, cf_out=cf)
    xs = [sym_cuda.launch_solve(_cf(sm) if cf else sm.contiguous(),
                                _cf(vm) if cf else vm.contiguous(), e, rf, cf_out=cf)
          for sm, vm, e, rf in solves]
    assert [w.launches - b for w, b in zip(wrappers, before)] == [1] * 5 + [2, 1, 4]

    det_p, logdet_p = batched_cuda.det_plain(a), batched_cuda.logdet_plain(a)
    sdet_p = sym_factor.sym_det_plain(s.contiguous())
    for got, want in ((det, det_p), (sdet, sdet_p)):
        assert torch.isfinite(want).all() and (want != 0).all()
        assert torch.equal(torch.sign(got).cpu(), torch.sign(want).cpu())
        assert ((got - want).abs() / want.abs()).max().item() <= tol
    assert ((logdet - logdet_p).abs() / logdet_p.abs().clamp_min(1.0)).max().item() <= tol
    for got, want in ((inv, batched_cuda.inv_plain(a)),
                      (sinv, sym_factor.invert_plain(s.contiguous())),
                      (x1, batched_cuda.solve_full_plain(a, r1, 1)),
                      (x3, batched_cuda.solve_full_plain(a, r, 3)),
                      (chol, batched_cuda.chol_plain(gram)),
                      *((x, sym_cuda.solve_plain(sm.contiguous(), vm.contiguous(), e, rf))
                        for x, (sm, vm, e, rf) in zip(xs, solves))):
        err = ((got - want).double().norm(dim=1) / want.double().norm(dim=1)).max().item()
        assert err <= tol


def _poisoned(rng, b, n):
    """Well-conditioned I + R / (4 sqrt(n)); every other problem singular
    (a zero row and column) or holding one NaN."""
    a = np.eye(n) + rng.standard_normal((b, n, n)) / (4 * np.sqrt(n))
    for t in range(1, b, 2):
        if t % 4 == 1:
            a[t, 2], a[t, :, 2] = 0.0, 0.0
        else:
            a[t, rng.integers(n), rng.integers(n)] = np.nan
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", NS)
def test_neighbours_keep_their_bits(n, dtype, rng):
    b = 33
    full = _poisoned(rng, b, n)
    a = torch.tensor(full.reshape(b, n * n), dtype=dtype, device="cuda")
    s = full_to_sym(torch.tensor(0.5 * (full + full.transpose(0, 2, 1)), dtype=dtype,
                                 device="cuda")).contiguous()
    r = torch.tensor(rng.standard_normal((b, 3 * n)), dtype=dtype, device="cuda")
    v = torch.tensor(rng.standard_normal((b, n)), dtype=dtype, device="cuda")
    eps = sym_cuda._prep_eps(EPS, n)
    for cf in (False, True):
        a_in, s_in, r_in, v_in = (_cf(a), _cf(s), _cf(r), _cf(v)) if cf else (a, s, r, v)
        outs = (batched_cuda.launch_det(a_in, cf_out=cf),
                batched_cuda.launch_logdet(a_in, cf_out=cf),
                batched_cuda.launch_inv(a_in, cf_out=cf),
                sym_factor.launch_sym_det(s_in, cf_out=cf),
                sym_factor.launch_sym_invert(s_in, cf_out=cf),
                batched_cuda.launch_solve_full(a_in, r_in, 3, cf_out=cf),
                batched_cuda.launch_chol(s_in, cf_out=cf),
                sym_cuda.launch_solve(s_in, v_in, None, 0, cf_out=cf),
                sym_cuda.launch_solve(s_in, v_in, eps, 1, cf_out=cf))
        for t in range(0, b, 2):
            alone = (batched_cuda.launch_det(a[t:t + 1]), batched_cuda.launch_logdet(a[t:t + 1]),
                     batched_cuda.launch_inv(a[t:t + 1]), sym_factor.launch_sym_det(s[t:t + 1]),
                     sym_factor.launch_sym_invert(s[t:t + 1]),
                     batched_cuda.launch_solve_full(a[t:t + 1], r[t:t + 1], 3),
                     batched_cuda.launch_chol(s[t:t + 1]),
                     sym_cuda.launch_solve(s[t:t + 1], v[t:t + 1], None, 0),
                     sym_cuda.launch_solve(s[t:t + 1], v[t:t + 1], eps, 1))
            for got, one in zip(outs, alone):
                assert torch.isfinite(one).all()
                assert torch.equal(_bits(got[t:t + 1]), _bits(one)), (t, cf)
        # the singular problems: det exactly 0 or NaN, never a finite nonzero
        for det in (outs[0].cpu(), outs[3].cpu()):
            assert all(det[t] == 0 or torch.isnan(det[t]) for t in range(1, b, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [9, 12, 16, 17, 24, 32])  # G = 16 to 16, 32 above
def test_ragged_batches(n, dtype, rng):
    full = np.eye(n) + rng.standard_normal((70, n, n)) / (4 * np.sqrt(n))
    a = torch.tensor(full.reshape(70, n * n), dtype=dtype, device="cuda")
    s = full_to_sym(torch.tensor(0.5 * (full + full.transpose(0, 2, 1)), dtype=dtype,
                                 device="cuda")).contiguous()
    r = torch.tensor(rng.standard_normal((70, 17 * n)), dtype=dtype, device="cuda")
    v = torch.tensor(rng.standard_normal((70, n)), dtype=dtype, device="cuda")
    eps = sym_cuda._prep_eps(EPS, n)
    whole = (batched_cuda.launch_det(a), batched_cuda.launch_logdet(a),
             batched_cuda.launch_inv(a), sym_factor.launch_sym_det(s),
             sym_factor.launch_sym_invert(s), batched_cuda.launch_solve_full(a, r, 17),
             batched_cuda.launch_chol(s), sym_cuda.launch_solve(s, v, None, 0),
             sym_cuda.launch_solve(s, v, eps, 1))
    for b in (1, 3, 33):
        for cf in (False, True):
            a_in = _cf(a[:b]) if cf else a[:b]
            s_in = _cf(s[:b]) if cf else s[:b]
            r_in = _cf(r[:b]) if cf else r[:b]
            v_in = _cf(v[:b]) if cf else v[:b]
            part = (batched_cuda.launch_det(a_in, cf_out=cf),
                    batched_cuda.launch_logdet(a_in, cf_out=cf),
                    batched_cuda.launch_inv(a_in, cf_out=cf),
                    sym_factor.launch_sym_det(s_in, cf_out=cf),
                    sym_factor.launch_sym_invert(s_in, cf_out=cf),
                    batched_cuda.launch_solve_full(a_in, r_in, 17, cf_out=cf),
                    batched_cuda.launch_chol(s_in, cf_out=cf),
                    sym_cuda.launch_solve(s_in, v_in, None, 0, cf_out=cf),
                    sym_cuda.launch_solve(s_in, v_in, eps, 1, cf_out=cf))
            for got, want in zip(part, whole):
                assert torch.equal(_bits(got), _bits(want[:b])), (b, cf)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", NS)
def test_chol_not_spd_stays_in_its_problem(n, dtype, rng):
    # SPD problems beside negated (negative definite) ones: every slot of a
    # bad problem's factor is NaN, and each good one has its own bits and
    # matches the plain version and float64 numpy
    b = 33
    x = rng.standard_normal((b, n, n))
    full = x @ x.transpose(0, 2, 1) + n * np.eye(n)
    full[1::2] *= -1.0
    s = full_to_sym(torch.tensor(full, dtype=dtype, device="cuda")).contiguous()
    for cf in (False, True):
        got = batched_cuda.launch_chol(_cf(s) if cf else s, cf_out=cf)
        assert torch.isnan(got[1::2]).all()
        good = got[0::2]
        assert torch.isfinite(good).all()
        for t in range(0, b, 2):
            assert torch.equal(_bits(got[t:t + 1]), _bits(batched_cuda.launch_chol(s[t:t + 1])))
        want = batched_cuda.chol_plain(s[0::2].contiguous())
        oracle = torch.from_numpy(_compact_lower(np.linalg.cholesky(full[0::2]))).to(dtype)
        for ref in (want, oracle):
            ref = ref.to("cuda")
            err = ((good - ref).double().norm(dim=1) / ref.double().norm(dim=1)).max().item()
            assert err <= TOL[dtype]


# (n, k): every block shape of the solve's staged right-hand sides at G = 16
# (k < G, k = G, one ragged column past G, 2.5 blocks) and at G = 32
WIDTHS = [(9, 1), (9, 3), (9, 16), (9, 17), (9, 40), (32, 33)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,k", WIDTHS)
def test_solve_any_width(n, k, dtype, rng):
    b = 37
    full = np.eye(n) + rng.standard_normal((b, n, n)) / (4 * np.sqrt(n))
    a = torch.tensor(full.reshape(b, n * n), dtype=dtype, device="cuda")
    r = torch.tensor(rng.standard_normal((b, n * k)), dtype=dtype, device="cuda")
    for trans in (False, True):
        want = batched_cuda.solve_full_plain(a, r, k, trans)
        a64 = a.double().cpu().numpy().reshape(b, n, n)
        am = np.swapaxes(a64, 1, 2) if trans else a64
        oracle = torch.from_numpy(np.linalg.solve(
            am, r.double().cpu().numpy().reshape(b, n, k)).reshape(b, n * k))
        for cf in (False, True):
            before = solve_full_cf.launches
            got = batched_cuda.launch_solve_full(_cf(a) if cf else a, _cf(r) if cf else r, k,
                                                 trans, cf_out=cf)
            assert solve_full_cf.launches == before + 1
            assert got.shape == (b, n * k)
            for ref in (want, oracle):
                ref = ref.double().cpu()
                err = ((got.double().cpu() - ref).norm(dim=1) / ref.norm(dim=1)).max().item()
                assert err <= TOL[dtype]
    # the public channel-first wrapper at this width, on the card
    x = solve_full_cf(a.t(), r.t(), k=k)
    assert x.shape == (n * k, b)
    err = ((x.t().double().cpu() - batched_cuda.solve_full_plain(a, r, k).double().cpu())
           .norm(dim=1) / batched_cuda.solve_full_plain(a, r, k).double().cpu().norm(dim=1))
    assert err.max().item() <= TOL[dtype]


def _over_terms(got, want, add):
    """max over problems of ||got - want|| / (||want|| + ||add||)."""
    got, want, add = (t.double().cpu() for t in (got, want, add))
    return ((got - want).norm(dim=1) / (want.norm(dim=1) + add.norm(dim=1))).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["batch_major", "channel_first"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", NS)
def test_chain_ties_match_plain(n, dtype, layout, rng):
    cf = layout == "channel_first"
    sfull = _ties_symmetric(rng, n)
    s = full_to_sym(torch.tensor(sfull, dtype=dtype, device="cuda")).contiguous()
    b = s.shape[0]
    v, c = (torch.tensor(rng.standard_normal((b, n)), dtype=dtype, device="cuda")
            for _ in range(2))
    ok = torch.from_numpy(np.linalg.cond(sfull + EPS * np.eye(n)) <= 100).to("cuda")
    eps = sym_cuda._prep_eps(EPS, n)
    for e, rows in ((None, slice(None)), (eps, ok)):
        sm, vm, cm = s[rows].contiguous(), v[rows].contiguous(), c[rows].contiguous()
        before = sym_solve_chain_cf.launches
        got = sym_cuda.launch_chain(_cf(sm) if cf else sm, _cf(vm) if cf else vm,
                                    _cf(cm) if cf else cm, e, 2, cf_out=cf)
        assert sym_solve_chain_cf.launches == before + 1
        assert _over_terms(got, sym_cuda.chain_plain(sm, vm, cm, e, 2), cm) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", NS)
def test_chain_neighbours_keep_their_bits(n, dtype, rng):
    b = 33
    full = _poisoned(rng, b, n)
    s = full_to_sym(torch.tensor(0.5 * (full + full.transpose(0, 2, 1)), dtype=dtype,
                                 device="cuda")).contiguous()
    v, c = (torch.tensor(rng.standard_normal((b, n)), dtype=dtype, device="cuda")
            for _ in range(2))
    eps = sym_cuda._prep_eps(EPS, n)
    # the matvec chain on contractions: A / (2 n) keeps each step's terms O(1)
    sm = s / (2 * n)
    before = (sym_solve_chain_cf.launches, sym_matvec_chain_cf.launches)
    for cf in (False, True):
        s_in, sm_in, v_in, c_in = (_cf(t) for t in (s, sm, v, c)) if cf else (s, sm, v, c)
        outs = (sym_cuda.launch_chain(s_in, v_in, c_in, None, 3, cf_out=cf),
                sym_cuda.launch_chain(s_in, v_in, c_in, eps, 3, cf_out=cf),
                sym_iterate.launch_matvec_chain(sm_in, v_in, c_in, 5, cf_out=cf))
        for t in range(0, b, 2):
            one = slice(t, t + 1)
            alone = (sym_cuda.launch_chain(s[one], v[one], c[one], None, 3),
                     sym_cuda.launch_chain(s[one], v[one], c[one], eps, 3),
                     sym_iterate.launch_matvec_chain(sm[one], v[one], c[one], 5))
            for got, want in zip(outs, alone):
                assert torch.isfinite(want).all()
                assert torch.equal(_bits(got[one]), _bits(want)), (t, cf)
        # a zero row and column pivots on 0, a NaN spreads: never a finite answer
        for t in range(1, b, 2):
            assert not torch.isfinite(outs[0][t]).all(), t
        assert torch.isnan(outs[2][3::4]).any(dim=1).all()
    alone_runs = 2 * len(range(0, b, 2))  # both layouts
    assert sym_solve_chain_cf.launches - before[0] == 2 * (2 + alone_runs)
    assert sym_matvec_chain_cf.launches - before[1] == 2 + alone_runs
