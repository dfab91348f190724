"""The lane-group LU tiers (9 <= n <= 32) of the determinant, log-determinant
and compact inverse kernels (``csrc/lu_groups.cuh``) on the inputs that
exercise their pivot bookkeeping, on the card.

Every test here is marked ``cuda`` and skips on a machine without an
NVIDIA GPU (the kernels have no CPU mode). This file imports neither JAX
nor ``fastmath_tpu``:

    python -m pytest tests/test_torch_factor_groups_cuda.py -m cuda --noconftest -p no:cacheprovider

- Ties: the pivot of a column is the first largest |a[i][k]| in the order
  left by the earlier swaps, which the kernels track without moving rows.
  Signed, row- and column-permuted Hadamard blocks (every entry of a
  column ties), row-permuted scaled identities (every step swaps) and
  small-integer matrices (ties in most columns) must give the plain
  version's determinant sign exactly and its values within ``TOL``:
  float32 1e-5, float64 1e-12, relative for a determinant, ``tol *
  max(1, |logdet|)`` for log|det|, normwise for the inverse. The kernels
  contract multiply-adds into FMAs and the plain versions do not. The
  integer matrices are kept to condition numbers <= 60, so that these
  roundings stay within the tolerance.
- Neighbours: a group of 16 lanes shares its warp with another problem.
  A singular or NaN problem must leave its neighbours' bits as they are
  when each runs alone.
- Ragged grids: batches of 1, 3 and 33 problems, at G = 16 and G = 32,
  give the bits of the same problems in a larger batch.
"""
import numpy as np
import pytest
import torch

from fastmath_tpu_torch.kernels import batched_cuda, det_cf, logdet_cf, sym_factor, sym_invert_cf
from fastmath_tpu_torch.layouts import full_to_sym

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
DTYPES = [torch.float32, torch.float64]
NS = [9, 16, 17, 32]  # both edges of each group size


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
    s = full_to_sym(torch.tensor(_ties_symmetric(rng, n), dtype=dtype, device="cuda"))
    a_in, s_in = (_cf(a), _cf(s)) if cf else (a, s.contiguous())

    before = [w.launches for w in (det_cf, logdet_cf, sym_invert_cf)]
    det = batched_cuda.launch_det(a_in, cf_out=cf)
    logdet = batched_cuda.launch_logdet(a_in, cf_out=cf)
    inv = sym_factor.launch_sym_invert(s_in, cf_out=cf)
    assert [w.launches - b for w, b in zip((det_cf, logdet_cf, sym_invert_cf), before)] == [1] * 3

    det_p, logdet_p = batched_cuda.det_plain(a), batched_cuda.logdet_plain(a)
    inv_p = sym_factor.invert_plain(s.contiguous())
    assert torch.isfinite(det_p).all() and (det_p != 0).all()
    assert torch.equal(torch.sign(det).cpu(), torch.sign(det_p).cpu())
    assert ((det - det_p).abs() / det_p.abs()).max().item() <= tol
    assert ((logdet - logdet_p).abs() / logdet_p.abs().clamp_min(1.0)).max().item() <= tol
    err = ((inv - inv_p).double().norm(dim=1) / inv_p.double().norm(dim=1)).max().item()
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
    for cf in (False, True):
        a_in, s_in = (_cf(a), _cf(s)) if cf else (a, s)
        outs = (batched_cuda.launch_det(a_in, cf_out=cf),
                batched_cuda.launch_logdet(a_in, cf_out=cf),
                sym_factor.launch_sym_invert(s_in, cf_out=cf))
        for t in range(0, b, 2):
            alone = (batched_cuda.launch_det(a[t:t + 1]), batched_cuda.launch_logdet(a[t:t + 1]),
                     sym_factor.launch_sym_invert(s[t:t + 1]))
            for got, one in zip(outs, alone):
                assert torch.isfinite(one).all()
                assert torch.equal(_bits(got[t:t + 1]), _bits(one)), (t, cf)
        # the singular problems: det exactly 0 or NaN, never a finite nonzero
        det = outs[0].cpu()
        assert all(det[t] == 0 or torch.isnan(det[t]) for t in range(1, b, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [12, 24])  # G = 16 and G = 32
def test_ragged_batches(n, dtype, rng):
    full = np.eye(n) + rng.standard_normal((70, n, n)) / (4 * np.sqrt(n))
    a = torch.tensor(full.reshape(70, n * n), dtype=dtype, device="cuda")
    s = full_to_sym(torch.tensor(0.5 * (full + full.transpose(0, 2, 1)), dtype=dtype,
                                 device="cuda")).contiguous()
    whole = (batched_cuda.launch_det(a), batched_cuda.launch_logdet(a),
             sym_factor.launch_sym_invert(s))
    for b in (1, 3, 33):
        for cf in (False, True):
            a_in = _cf(a[:b]) if cf else a[:b]
            s_in = _cf(s[:b]) if cf else s[:b]
            part = (batched_cuda.launch_det(a_in, cf_out=cf),
                    batched_cuda.launch_logdet(a_in, cf_out=cf),
                    sym_factor.launch_sym_invert(s_in, cf_out=cf))
            for got, want in zip(part, whole):
                assert torch.equal(_bits(got), _bits(want[:b])), (b, cf)
