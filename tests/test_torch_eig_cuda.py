"""The port's Jacobi eigendecomposition kernels (``csrc/eig.cu``) against
their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips on a machine without an
NVIDIA GPU (the kernels have no CPU mode). This file imports neither JAX
nor ``fastmath_tpu``, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_eig_cuda.py -m cuda --noconftest -p no:cacheprovider

Eigenvalues come out unsorted and eigenvectors up to sign, and the kernel
contracts multiply-adds into FMAs where the plain version does not, so
the checks compare sorted eigenvalues and the reconstruction U diag(w) Uᵀ
over ||A||_F of each problem, and UᵀU against I: float64 1e-12; float32
2e-5 (Jacobi in float32 sits at 4e-6..9e-6 ||A||_F at n = 32 without the
polish of ``eig_sym``, in the plain version and in the kernel alike).
"""
import numpy as np
import pytest
import torch

import fastmath_tpu_torch as T
from fastmath_tpu_torch.kernels import eig as KE
from fastmath_tpu_torch.layouts import full_to_sym
from fastmath_tpu_torch.layouts.sym import sym_from_triangle

TOL = {torch.float32: 2e-5, torch.float64: 1e-12}
B = 4099  # ragged against both tiers' blocks
NS = [1, 2, 3, 4, 5, 8, 9, 16, 17, 24, 32]


@pytest.fixture(autouse=True)
def _needs_card(request):
    if request.node.get_closest_marker("cuda") and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _counter(n):
    return KE.eig_unrolled if n <= KE.UNROLL_MAX else KE.eig_rolled


def _check(w, u, sym, w_ref, tol):
    """Sorted w against sorted w_ref, and (if u) U diag(w) Uᵀ against sym
    and UᵀU against I, over ||sym||_F per problem (float64 on the host)."""
    sym = sym.double().cpu()
    fro = torch.linalg.matrix_norm(sym)
    dw = (w.double().cpu().sort(-1).values - w_ref.double().cpu().sort(-1).values).abs()
    assert (dw.amax(-1) / fro).max() <= tol
    if u is not None:
        u = u.double().cpu().reshape(sym.shape)
        rec = torch.einsum("bij,bj,bkj->bik", u, w.double().cpu(), u)
        assert (torch.linalg.matrix_norm(rec - sym) / fro).max() <= tol
        gram = u.mT @ u
        assert (gram - torch.eye(sym.shape[-1], dtype=gram.dtype)).abs().max() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", NS)
def test_full_storage_matches_plain(n, dtype, rng):
    """Both triangles, values alone and with vectors, on a ragged batch of
    non-symmetric matrices: the kernel reads one triangle in place."""
    a = torch.tensor(rng.standard_normal((B, n, n)), dtype=dtype, device="cuda")
    sweeps = KE.sweeps_for(n)
    for upper in (True, False):
        sym = sym_from_triangle(a, upper)
        wp, up = KE.eig_plain(sym, True, sweeps)
        before = _counter(n).launches
        wk, uk = KE.launch_eig_full(a, upper, True, sweeps)
        wv, none = KE.launch_eig_full(a, upper, False, sweeps)
        torch.cuda.synchronize()
        assert _counter(n).launches == before + 2 and none is None
        # the rotations of A do not depend on V: the same values
        assert torch.equal(wv, wk)
        _check(wk, uk, sym, wp, TOL[dtype])
        _check(wp, up, sym, wk, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [3, 4, 8, 9, 32])
def test_strided_and_broadcast_batches(n, dtype, rng):
    """A strided batch (every other matrix), a transposed view (the other
    triangle through swapped strides) and a broadcast batch (stride 0)."""
    base = torch.tensor(rng.standard_normal((2 * 1031, n, n)), dtype=dtype, device="cuda")
    sweeps = KE.sweeps_for(n)
    for a in (base[::2], base[:1031].mT, base[:1].expand(777, n, n)):
        wk, uk = KE.launch_eig_full(a, True, True, sweeps)
        sym = sym_from_triangle(a, True)
        wp, _ = KE.eig_plain(sym.contiguous(), False, sweeps)
        _check(wk, uk, sym, wp, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [2, 4, 8, 9, 17, 32])
def test_compact_channel_first(n, dtype, rng):
    """eig_sym_cf on channel-first compact input (and a strided slice of
    it), against the same call on the CPU (the plain version)."""
    x = rng.standard_normal((B, n, n))
    cm = full_to_sym(torch.tensor(x + x.swapaxes(-1, -2), dtype=dtype))  # (B, NN)
    cf = cm.t().contiguous()
    for mat in (cf, cf[:, ::3]):
        w, u = KE.eig_sym_cf(mat.cuda(), compute_u=True, sweeps=KE.sweeps_for(n))
        wp, _ = KE.eig_sym_cf(mat, compute_u=True, sweeps=KE.sweeps_for(n))
        sym = T.sym_to_full(mat.t())
        _check(w.t(), u.t(), sym, wp.t(), TOL[dtype])
        assert w.shape == (n, mat.shape[1]) and u.shape == (n * n, mat.shape[1])


@pytest.mark.cuda
def test_converged_input_is_untouched():
    """Zero and diagonal matrices pass their test before the first sweep:
    the diagonal comes back exactly, V the identity."""
    for n in (4, 12):
        d = torch.arange(1.0, n + 1, device="cuda")
        a = torch.stack([torch.zeros(n, n, device="cuda"), torch.diag(d)])
        w, u = KE.launch_eig_full(a, True, True, 8)
        assert torch.equal(w[0], torch.zeros(n, device="cuda")) and torch.equal(w[1], d)
        assert torch.equal(u, torch.eye(n, device="cuda").expand(2, n, n))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 12])
def test_mixed_scale_block(n, rng):
    """A 1e6-scale problem beside an O(1) one, float32: each stops on its
    own test, so the small one is as accurate as alone."""
    x = rng.standard_normal((n, n))
    full = np.stack([1e6 * np.diag(np.arange(1.0, n + 1)), x + x.T])
    w, _ = KE.launch_eig_full(torch.tensor(full, dtype=torch.float32, device="cuda"), True,
                              False, KE.sweeps_for(n))
    want = np.sort(np.linalg.eigvalsh(full), -1)
    got = np.sort(w.double().cpu().numpy(), -1)
    assert (np.abs(got - want).max(-1) / np.abs(want).max(-1)).max() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_public_eig_sym_routes(dtype, rng):
    """eig_sym on a CUDA tensor: real 4 <= n <= 32 launches the kernel
    ("auto", the default), n <= 3 takes the closed forms (no launch) unless
    backend="cuda"; "torch" runs the plain version on the card."""
    for n in (2, 4, 9, 32):
        x = rng.standard_normal((3, 5, n, n))
        a = torch.tensor(x + x.swapaxes(-1, -2), dtype=dtype, device="cuda")
        before = _counter(n).launches
        w, u = T.eig_sym(a, compute_u=True, check_finite=False)
        assert _counter(n).launches == before + (0 if n <= 3 else 1)
        wt, ut = T.eig_sym(a, compute_u=True, backend="torch")
        assert _counter(n).launches == before + (0 if n <= 3 else 1)
        assert w.shape == (3, 5, n) and u.shape == (3, 5, n, n)
        flat = a.reshape(-1, n, n)
        _check(w.reshape(-1, n), u.reshape(-1, n, n), flat, wt.reshape(-1, n), TOL[dtype])
        T.eig_sym(a, backend="cuda")
        assert _counter(n).launches == before + (1 if n <= 3 else 2)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 6, 12])
def test_gradients_kernel_vs_plain(n, rng):
    """The Giles backward of the kernel route against the plain route,
    float64, both triangles, values and vectors."""
    x = rng.standard_normal((64, n, n))
    g = torch.tensor(rng.standard_normal(n), device="cuda")

    def grads(backend, upper):
        a = torch.tensor(x, device="cuda").requires_grad_()
        w, u = T.eig_sym(a, compute_u=True, upper=upper, backend=backend)
        loss = (torch.cos(w) * ((u * g[:, None]).sum(-2)) ** 2).sum() + (w ** 3).sum()
        return torch.autograd.grad(loss, a)[0]

    for upper in (True, False):
        k, p = grads("cuda", upper), grads("torch", upper)
        assert ((k - p).norm() / p.norm()).item() <= 1e-10


@pytest.mark.cuda
def test_bad_arguments():
    a = torch.zeros(2, 33, 33, device="cuda")
    with pytest.raises(ValueError):
        KE.launch_eig_full(a, True, False, 8)
    with pytest.raises(ValueError):
        KE.launch_eig_full(torch.zeros(2, 3, 3, device="cuda"), True, False, -1)
    with pytest.raises(ValueError):
        T.eig_sym(torch.zeros(2, 3, 3, dtype=torch.complex64, device="cuda"), backend="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 12])
def test_empty_batch_launches_nothing(n):
    """An empty batch returns empty outputs and moves no launch count."""
    before = _counter(n).launches
    w, u = KE.launch_eig_full(torch.zeros(0, n, n, device="cuda"), True, True, 8)
    assert w.shape == (0, n) and u.shape == (0, n, n)
    wc, uc = KE.eig_sym_cf(torch.zeros(n * (n + 1) // 2, 0, device="cuda"), compute_u=True)
    assert wc.shape == (n, 0) and uc.shape == (n * n, 0)
    assert _counter(n).launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("n, dtype", [(5, torch.complex128), (12, torch.complex64),
                                      (40, torch.float64)])
def test_outside_the_domain_runs_plain(n, dtype, rng):
    """Complex Hermitian input and n > 32 take the plain Jacobi on the card
    (no launch): sorted eigenvalues against torch.linalg.eigvalsh and the
    reconstruction, over ||A||_F."""
    x = rng.standard_normal((6, n, n)) + (1j * rng.standard_normal((6, n, n))
                                          if dtype.is_complex else 0)
    a = torch.tensor(x + x.conj().swapaxes(-1, -2), dtype=dtype, device="cuda")
    before = KE.eig_unrolled.launches + KE.eig_rolled.launches
    w, u = T.eig_sym(a, compute_u=True, check_finite=False)
    assert KE.eig_unrolled.launches + KE.eig_rolled.launches == before
    tol = 2e-5 if dtype == torch.complex64 else 1e-12
    a64 = a.to(torch.complex128).cpu()
    fro = torch.linalg.matrix_norm(a64)
    dw = (w.double().cpu().sort(-1).values - torch.linalg.eigvalsh(a64)).abs().amax(-1)
    assert (dw / fro).max() <= tol
    u64 = u.to(torch.complex128).cpu()
    rec = (u64 * w.double().cpu()[:, None, :]) @ u64.mH
    assert (torch.linalg.matrix_norm(rec - a64) / fro).max() <= tol
