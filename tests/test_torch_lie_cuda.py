"""The port's matrix exponential and logarithm kernels (``csrc/expm.cu``,
``csrc/logm.cu``) against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips on a machine without an
NVIDIA GPU (the kernels have no CPU mode). This file imports neither JAX
nor ``fastmath_tpu``, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_lie_cuda.py -m cuda --noconftest -p no:cacheprovider

The kernels contract multiply-adds into FMAs where the plain versions do
not, so results differ by rounding, compared normwise per problem. The
tolerances (float32 / float64): ``expm`` 1e-5 / 1e-12 at ||X|| ~ 0.5;
2e-4 / 1e-11 on skew-symmetric X of spectral radius 128, whose ten
squarings each double the relative rounding (the plain version alone sits
at 3e-5 from float64 there); ``logm`` 5e-5 / 1e-11, whose 2^(k+1) scaling
after k square roots amplifies the last rounding (the plain version alone
sits at 4e-6 from float64 on these inputs, 9e-6 on rotations by 0.9 pi).
"""
import math

import numpy as np
import pytest
import torch

import fastmath_tpu_torch as T
from fastmath_tpu_torch.kernels import expm as KE
from fastmath_tpu_torch.kernels import logm as KL

B = 4099  # ragged against both tiers' blocks
DS = [1, 2, 3, 4, 5, 8, 9, 12, 16, 17, 24, 25, 32]
# logm_unrolled's sizes, and the edges of logm_warp's lane groups (G = 8
# to d = 8, 16 to 16, 32 above)
EDGES = [2, 3, 4, 5, 8, 9, 12, 16, 17, 24, 25, 32]
TOL_EXPM = {torch.float32: 1e-5, torch.float64: 1e-12}
TOL_DEEP = {torch.float32: 2e-4, torch.float64: 1e-11}
TOL_LOGM = {torch.float32: 5e-5, torch.float64: 1e-11}


@pytest.fixture(autouse=True)
def _needs_card(request):
    if request.node.get_closest_marker("cuda") and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def gauss(rng, b, d):
    """The bench suite's input: standard normal entries times 0.5/sqrt(d)."""
    return rng.standard_normal((b, d, d)) * (0.5 / np.sqrt(d))


def skew(rng, b, d, radius):
    """Skew-symmetric matrices of spectral radius ``radius`` (expm is a
    rotation by angles up to ``radius``)."""
    r = rng.standard_normal((b, d, d))
    s = r - r.transpose(0, 2, 1)
    rho = np.abs(np.linalg.eigvals(s)).max(-1) if d > 1 else np.ones(b)
    return s * (radius / np.maximum(rho, 1e-30))[:, None, None]


def normwise(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    scale = want.flatten(1).norm(dim=1).clamp_min(1e-300)  # log I = 0 exactly
    return ((got - want).flatten(1).norm(dim=1) / scale).max().item()


def _expm_counter(d, dtype):
    return KE.expm_unrolled if KE.tier(d, dtype) == "expm_unrolled" else KE.expm_warp


def _logm_counter(d, dtype):
    return KL.logm_unrolled if KL.tier(d, dtype) == "logm_unrolled" else KL.logm_warp


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", DS)
def test_expm_matches_plain(d, dtype, rng):
    """Both scales, batch-major and channel-first on a ragged batch."""
    for x, tol in ((gauss(rng, B, d), TOL_EXPM[dtype]), (skew(rng, B, d, 128.0), TOL_DEEP[dtype])):
        a = torch.tensor(x, dtype=dtype, device="cuda")
        before = _expm_counter(d, dtype).launches
        got = KE.launch_expm(a)
        cf = KE.expm_cf(a.reshape(B, d * d).t().contiguous())
        torch.cuda.synchronize()
        assert _expm_counter(d, dtype).launches == before + 2
        want = KE.expm_plain(a)
        assert normwise(got, want) <= tol
        assert torch.equal(cf.t().reshape(B, d, d), got)


def _expm64(x):
    import scipy.linalg as sla

    return torch.tensor(np.stack([sla.expm(m) for m in x]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", range(1, 9))
def test_expm_one_thread_tier(d, dtype, rng):
    """Every d <= 8 (the staged one-thread tier to UNROLL_MAX, expm_warp
    above it in float64): a batch of 1, one block and one more (129) and
    the ragged B, against the plain version and 64 problems against float64
    scipy; channel-first in, out or both, which give the batch-major bits;
    and a strided, a broadcast and a transposed operand, which give the
    bits of the same matrices made contiguous."""
    x = gauss(rng, B, d)
    a = torch.tensor(x, dtype=dtype, device="cuda")
    want = KE.expm_plain(a)
    for b in (1, 129, B):
        ab = a[:b]
        got = KE.launch_expm(ab)
        assert normwise(got, want[:b]) <= TOL_EXPM[dtype]
        cf = ab.reshape(b, d * d).t().contiguous().t().reshape(b, d, d)
        for arg, cf_out in ((cf, True), (cf, False), (ab, True)):
            assert torch.equal(KE.launch_expm(arg, cf_out=cf_out), got)
    assert normwise(got[:64], _expm64(x[:64])) <= TOL_EXPM[dtype]
    base = torch.tensor(gauss(rng, 2 * B, d), dtype=dtype, device="cuda")
    for view in (base[::2], base[:1].expand(777, d, d), base[:1031].mT):
        assert torch.equal(KE.launch_expm(view), KE.launch_expm(view.contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", range(1, 9))
def test_expm_squaring_extremes_and_nan(d, dtype, rng):
    """s = 0: X = 0 gives I exactly, and the bench input scaled to a 1-norm
    of 0.45 matches the plain version. s = 20: X = 2^19 e_1 e_d^T (d >=
    2), nilpotent, gives I + X exactly, and X = -2^19 (d = 1) gives 0. A
    problem holding a NaN and one holding an inf come back non-finite, and
    every other problem of the batch keeps its bits."""
    zero = torch.zeros(300, d, d, dtype=dtype, device="cuda")
    assert torch.equal(KE.launch_expm(zero), torch.eye(d, dtype=dtype, device="cuda").expand(
        300, d, d))
    x = gauss(rng, 300, d)
    x = torch.tensor(x * (0.45 / np.abs(x).sum(-2).max(-1))[:, None, None], dtype=dtype,
                     device="cuda")  # |X|_1 = 0.45
    assert (KE.squaring_counts(x) == 0).all()
    assert normwise(KE.launch_expm(x), KE.expm_plain(x)) <= TOL_EXPM[dtype]
    big = torch.zeros(300, d, d, dtype=dtype, device="cuda")
    big[:, 0, d - 1] = -2.0 ** 19 if d == 1 else 2.0 ** 19
    assert (KE.squaring_counts(big) == 20).all()
    want = torch.zeros_like(big) if d == 1 else torch.eye(d, dtype=dtype, device="cuda") + big
    assert torch.equal(KE.launch_expm(big), want)
    clean = torch.tensor(gauss(rng, 300, d), dtype=dtype, device="cuda")
    bad = clean.clone()
    bad[7, 0, d - 1] = float("nan")
    bad[150, d - 1, 0] = float("inf")
    got, alone = KE.launch_expm(bad), KE.launch_expm(clean)
    keep = torch.ones(300, dtype=torch.bool, device="cuda")
    keep[[7, 150]] = False
    assert not torch.isfinite(got[7]).all() and not torch.isfinite(got[150]).all()
    assert torch.equal(got[keep], alone[keep])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", DS)
def test_logm_matches_plain(d, dtype, rng):
    """logm of expm of the bench input and of rotations by up to 0.9 pi
    (about five square roots of twenty Denman-Beavers steps in all),
    batch-major and channel-first."""
    for x in (gauss(rng, B, d), skew(rng, B, d, 0.9 * math.pi)):
        a = KE.expm_plain(torch.tensor(x, device="cuda")).to(dtype)
        before = _logm_counter(d, dtype).launches
        got = KL.launch_logm(a)
        cf = KL.logm_cf(a.reshape(B, d * d).t().contiguous())
        torch.cuda.synchronize()
        assert _logm_counter(d, dtype).launches == before + 2
        want = KL.logm_plain(a)
        assert torch.isfinite(want).all() and torch.isfinite(got).all()
        assert normwise(got, want) <= TOL_LOGM[dtype]
        assert torch.equal(cf.t().reshape(B, d, d), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", [2, 3, 4, 17, 20, 24])
def test_logm_mixed_step_counts_match_plain(d, dtype, rng):
    """d <= 4 (a thread a problem) and 17 <= d <= 24 (a group of 32 lanes
    on a padded problem): the bench input at scales 0.1 to 2 in turn, so
    that neighbouring problems take different numbers of square roots and
    Denman-Beavers steps, each against the plain version."""
    x = gauss(rng, B, d) * np.resize([0.1, 0.5, 1.0, 2.0], B)[:, None, None]
    a = KE.expm_plain(torch.tensor(x, device="cuda")).to(dtype)
    iss, db = KL.iteration_counts(a[:64])
    assert iss.unique().numel() > 1 and db.unique().numel() > 1
    got = KL.launch_logm(a)
    want = KL.logm_plain(a)
    assert torch.isfinite(want).all() and torch.isfinite(got).all()
    assert normwise(got, want) <= TOL_LOGM[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", [2, 3, 4])
def test_logm_problem_order_changes_no_value(d, dtype, rng):
    """logm_unrolled's neighbours take their own steps: the mixed-scale
    input sorted by its (square roots, Denman-Beavers steps), so that a
    warp's lanes take equal steps, and the same problems shuffled give the
    same bits after un-permuting."""
    x = gauss(rng, B, d) * np.resize([0.1, 0.5, 1.0, 2.0], B)[:, None, None]
    a = KE.expm_plain(torch.tensor(x, device="cuda")).to(dtype)
    iss, db = KL.iteration_counts(a)
    order = torch.argsort(iss.long() * 4096 + db.long())
    shuffle = torch.randperm(B, generator=torch.Generator().manual_seed(d)).cuda()
    got = KL.launch_logm(a)
    by_counts = KL.launch_logm(a[order].contiguous())
    shuffled = KL.launch_logm(a[shuffle].contiguous())
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(by_counts, got[order]) and torch.equal(shuffled, got[shuffle])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 4, 9, 16, 5, 8, 17, 32])
def test_strided_and_broadcast_batches(d, rng):
    """A strided batch (every other matrix), a transposed view and a
    broadcast batch (stride 0), against the same matrices made contiguous."""
    base = torch.tensor(gauss(rng, 2 * B, d), device="cuda")
    for launch, src in ((KE.launch_expm, base), (KL.launch_logm, KE.expm_plain(base))):
        for a in (src[::2], src[:1031].mT, src[:1].expand(777, d, d)):
            got = launch(a)
            want = launch(a.contiguous())
            torch.cuda.synchronize()
            assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", [3, 4, 9, 5, 8, 12, 16, 17, 32])
def test_branch_cut_lanes(d, dtype, rng):
    """A reflection and a rotation by pi among regular matrices: exactly
    those come back NaN, and every other problem is bit for bit what it is
    without them."""
    good = KE.expm_plain(torch.tensor(gauss(rng, 64, d)))
    refl = torch.eye(d, dtype=torch.float64)
    refl[0, 0] = -1.0
    rot = torch.eye(d, dtype=torch.float64)
    rot[:2, :2] = torch.tensor([[-1.0, 0.0], [0.0, -1.0]])
    batch = torch.cat([good[:10], refl[None], good[10:40], rot[None], good[40:]])
    a = batch.to(dtype).cuda()
    got = KL.launch_logm(a)
    alone = KL.launch_logm(good.to(dtype).cuda())
    torch.cuda.synchronize()
    nan = torch.isnan(got).any(-1).any(-1).cpu()
    assert nan.nonzero()[:, 0].tolist() == [10, 41]
    assert torch.isnan(got[10]).all() and torch.isnan(got[41]).all()
    keep = torch.ones(66, dtype=torch.bool)
    keep[[10, 41]] = False
    assert torch.equal(got[keep.cuda()], alone)
    # the public op reroutes exactly those two, to the real-cast log
    pub = T.logm(a)
    assert torch.isfinite(pub).all()
    assert torch.equal(pub[keep.cuda()], alone)
    # both real-cast logs are 0: diag(i pi, 0, ..) and i pi on the 2 x 2 block
    assert pub[[10, 41]].abs().max() <= 1e-5


def _expm64_batch(rng, b, d):
    return KE.expm_plain(torch.tensor(gauss(rng, b, d))).numpy()


def _rotation_cube(d):
    """R (x) R (x) R for the rotation R by pi/4 (every nonzero entry of
    magnitude 2^-1.5: ties in every column), then I; at d < 8 R (x) R, at
    d < 4 R, then I. Eigenvalues e^(i k pi/4), |k| <= 3: off the branch
    cut."""
    c = math.sqrt(0.5)
    r = np.array([[c, -c], [c, c]])
    k = r if d < 4 else np.kron(r, r) if d < 8 else np.kron(np.kron(r, r), r)
    out = np.eye(d)
    out[:len(k), :len(k)] = k
    return out


def _half_cycles(d):
    """0.5 (I + P), P a product of 3-cycles (fixed points past the last
    whole one): two equal entries in a column, eigenvalues 1 and e^(+-i
    pi/3) / 2."""
    idx = list(range(d))
    for s in range(0, d - d % 3, 3):
        idx[s:s + 3] = [s + 1, s + 2, s]
    return 0.5 * (np.eye(d) + np.eye(d)[idx])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", EDGES)
def test_logm_pivot_ties(d, dtype):
    """Inputs whose first inverse meets pivot ties (the first largest row
    wins, in the kernel and in the plain version) against the plain
    version, among the bench input."""
    rng = np.random.default_rng(d)
    ties = np.stack([_rotation_cube(d), _half_cycles(d)])
    x = np.concatenate([ties, _expm64_batch(rng, 5, d), ties[::-1]])
    a = torch.tensor(x, dtype=dtype, device="cuda")
    got = KL.launch_logm(a)
    want = KL.logm_plain(a)
    torch.cuda.synchronize()
    assert torch.isfinite(want).all() and torch.isfinite(got).all()
    assert normwise(got, want) <= TOL_LOGM[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", EDGES)
def test_neighbours_exit_on_their_own(d, dtype):
    """Problems that share a warp (two or four a warp up to d = 16) and
    stop at different points: I (no square root), expm of a small input
    (one or two), a rotation by 0.9 pi (five or six) and a reflection (on
    the cut: NaN), side by side in an odd batch. Each comes back bit for bit
    as it does alone, and the finite ones agree with the plain version."""
    rng = np.random.default_rng(100 + d)
    eye = np.eye(d)
    refl = np.eye(d)
    refl[0, 0] = -1.0
    near = KE.expm_plain(torch.tensor(gauss(rng, 3, d) * 0.05)).numpy()
    far = KE.expm_plain(torch.tensor(skew(rng, 3, d, 0.9 * math.pi))).numpy()
    x = np.stack([eye, far[0], near[0], refl, far[1], eye, near[1], far[2], refl, near[2], eye])
    a = torch.tensor(x, dtype=dtype, device="cuda")
    got = KL.launch_logm(a)
    alone = torch.cat([KL.launch_logm(a[i:i + 1]) for i in range(len(x))])
    want = KL.logm_plain(a)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(alone))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(alone))
    cut = torch.isnan(got).flatten(1).any(1).cpu()
    assert cut.nonzero()[:, 0].tolist() == [3, 8] and torch.isnan(got[[3, 8]]).all()
    keep = ~cut
    assert normwise(got[keep.cuda()], want[keep.cuda()]) <= TOL_LOGM[dtype]
    assert (got[[0, 5, 10]] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [4, 16, 20])
def test_expm_mathias_backward(d, rng):
    """The gradient through the kernel route against the plain route: the
    backward launches the kernel on the 2d x 2d block while 2d <= 32 (d = 4,
    16) and runs the plain version beyond (d = 20)."""
    x0 = torch.tensor(gauss(rng, 257, d), device="cuda")
    g = torch.tensor(rng.standard_normal((257, d, d)), device="cuda")
    counter = _expm_counter(2 * d, torch.float64) if 2 * d <= 32 else None
    before = counter.launches if counter else 0
    grads = []
    for backend in ("cuda", "torch"):
        x = x0.clone().requires_grad_()
        grads.append(torch.autograd.grad((T.expm(x, backend=backend) * g).sum(), x)[0])
    torch.cuda.synchronize()
    assert normwise(grads[0], grads[1]) <= 1e-10
    if counter:
        assert counter.launches > before


@pytest.mark.cuda
def test_logm_backward_through_kernel(rng):
    """logm's Mathias backward (logm of the 2d x 2d block) on the card
    against central differences."""
    a0 = KE.expm_plain(torch.tensor(gauss(rng, 33, 4), device="cuda"))
    g = torch.tensor(rng.standard_normal((33, 4, 4)), device="cuda")
    e = torch.tensor(rng.standard_normal((33, 4, 4)), device="cuda")
    a = a0.clone().requires_grad_()
    counter = _logm_counter(8, torch.float64)  # the 8 x 8 block
    before = counter.launches
    grad = torch.autograd.grad((T.logm(a) * g).sum(), a)[0]
    assert counter.launches > before
    h = 1e-6
    with torch.no_grad():
        fd = ((T.logm(a0 + h * e) * g).sum() - (T.logm(a0 - h * e) * g).sum()) / (2 * h)
    assert abs((fd - (grad * e).sum()) / fd).item() <= 1e-6


@pytest.mark.cuda
def test_public_routes(rng):
    """expm and logm on CUDA tensors go through the kernels; a symmetric
    batch at d >= _LOGM_SYM_EIG_MIN_D takes the eig route instead."""
    from fastmath_tpu_torch.kernels import eig as KEIG
    from fastmath_tpu_torch.ops import lie as L

    x = torch.tensor(gauss(rng, 100, 4), device="cuda", dtype=torch.float32)
    e0, l0 = KE.expm_unrolled.launches, KL.logm_unrolled.launches
    e = T.expm(x)
    lg = T.logm(e)
    torch.cuda.synchronize()
    assert KE.expm_unrolled.launches == e0 + 1 and KL.logm_unrolled.launches == l0 + 1
    assert normwise(lg, x) <= 1e-5
    d = L._LOGM_SYM_EIG_MIN_D
    if d <= 32:
        a = torch.tensor(rng.standard_normal((50, d, d)), device="cuda")
        spd = a @ a.mT / d + torch.eye(d, device="cuda", dtype=a.dtype)
        r0 = KEIG.eig_rolled.launches
        lw = KL.logm_warp.launches
        got = T.logm(spd)
        torch.cuda.synchronize()
        assert KEIG.eig_rolled.launches == r0 + 1 and KL.logm_warp.launches == lw
        assert normwise(got, KL.logm_plain(spd)) <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("d", [4, 16])
def test_empty_batch_launches_nothing(d):
    for launch, counters in ((KE.launch_expm, (KE.expm_unrolled, KE.expm_warp)),
                             (KL.launch_logm, (KL.logm_unrolled, KL.logm_warp))):
        before = [c.launches for c in counters]
        out = launch(torch.empty(0, d, d, device="cuda"))
        assert tuple(out.shape) == (0, d, d)
        assert [c.launches for c in counters] == before


@pytest.mark.cuda
def test_bad_arguments():
    with pytest.raises(ValueError):
        KE.launch_expm(torch.zeros(4, 33, 33, device="cuda"))
    with pytest.raises(ValueError):
        KL.launch_logm(torch.zeros(4, 3, 3, device="cuda", dtype=torch.complex64))
    with pytest.raises(ValueError):
        T.expm(torch.zeros(4, 3, 3, device="cuda", dtype=torch.complex64), backend="cuda")
    with pytest.raises(ValueError):
        KE.launch_expm(torch.zeros(4, 3, 3))
