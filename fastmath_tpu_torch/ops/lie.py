"""Lie-group matrix functions: ``expm``, ``logm``, ``meanm`` and
``expm_derivatives``.

PyTorch counterpart of ``fastmath_tpu/ops/lie.py``: the same names,
algorithms, constants and semantics.

* ``expm``: scaling and squaring with a fixed-order Taylor core, each
  matrix squaring its own number of times. Real d <= 32 on a CUDA tensor
  launches kernel #19 (``kernels/expm.py``, float32 and float64) through
  an ``autograd.Function`` with the Mathias backward; everything else runs
  the kernel's plain version, :func:`_expm_core`, on the tensors' device.
* ``logm``: inverse scaling and squaring (Denman-Beavers square roots,
  the cancellation-free ``A - I`` of Al-Mohy & Higham, a Gregory series).
  Real d <= 32 on a CUDA tensor launches kernel #20 (``kernels/logm.py``);
  symmetric batches with ``_LOGM_SYM_EIG_MIN_D <= d <= 32`` on the card
  take ``V log|w| Vᵀ`` through the eig kernel instead. Elsewhere, as JAX
  on the CPU: :func:`_iss_log_core`. Gradients by the Mathias block rule.

Branch-cut contract (the reference's): for real input whose principal log
is complex (eigenvalues on the negative real axis), ``logm`` returns the
real part of the complex principal log, like scipy real-cast. The fast
path comes back NaN for exactly those matrices; they alone are rerouted
through :func:`_logm_exceptional` (joint Hermitian diagonalization for
normal matrices, an imaginary spectral shift with a series correction
otherwise).

``backend`` of ``expm``: ``"auto"`` launches the kernel on a CUDA tensor
with real d <= 32 (float64 too: the reference's float32-only gate was its
TPU compiler's) and runs :func:`_expm_core` otherwise; ``"cuda"`` forces
the kernel (and raises outside its domain or on CPU tensors); ``"torch"``
runs :func:`_expm_core` on the tensors' device. bf16/f16 compute in
float32 and round once on output.
"""
from __future__ import annotations

import math
import warnings

import torch

from ..core.dtypes import downcast, upcast_half
from ..kernels._launch import MAX_N, in_domain
from ..kernels.expm import SQUARINGS_MAX as _SQUARINGS_MAX  # handles ||X|| up to ~2^20 * 0.5
from ..kernels.expm import ExpmFunction
# one function serves both: the kernels' plain version is the reference's
# _expm_core (kernels.expm.expm_plain)
from ..kernels.expm import expm_plain as _expm_core
from ..kernels.logm import iss_log, launch_logm
from .batched import batchdet, batchinv
from .batched import batchmatmul as _bmm
from .sugar import lmdiv
from .sym import _use_kernel

__all__ = ["expm", "logm", "meanm", "expm_derivatives"]

_LOGM_SYM_EIG_MAX_D = 32  # symmetric eig route cap = rolled Jacobi tier
#: lower bound of the symmetric eig route on the card: on an H100, the
#: public logm per call on SPD input on 15,625, the route and the kernel
#: route tie at d = 12 (1.9326 and 1.9607 ms), the route is 1.43x faster at
#: 16 and the kernel route 2.5x faster at 8 (chip_smoke.py phase 10; the
#: reference's 12 was measured on a TPU)
_LOGM_SYM_EIG_MIN_D = 12


def _as_float(x):
    """Tensor of ``x``: integers and bool to the default float, half types
    to float32; returns ``(x, half)`` as :func:`upcast_half`."""
    return upcast_half(torch.as_tensor(x))


def _reconstruct_log(X, basis):
    """Combine coefficients with a basis: ``sum_i x_i B_i``."""
    X = torch.as_tensor(X)
    basis = torch.as_tensor(basis, device=X.device)
    return torch.sum(basis * X[..., None, None], dim=-3)


def expm(X, basis=None, max_order: int = 10000, tol: float = 1e-32, backend: str = "auto"):
    """Matrix exponential (batched, differentiable).

    ``X``: log-matrix ``(..., D, D)``, or coefficients ``(..., F)`` when
    ``basis`` ``(..., F, D, D)`` is given (Lie-algebra parameterization).
    ``max_order``/``tol`` are accepted for API compatibility and ignored:
    the scaling-and-squaring core is accurate at working precision by
    construction. See the module docstring for ``backend``; the kernel
    route's backward launches the kernel on the 2D x 2D Mathias block while
    2D <= 32. For forward-mode AD (``torch.func.jvp`` / ``jacfwd``) use
    ``backend="torch"`` or :func:`expm_derivatives`.
    """
    if basis is not None:
        X = _reconstruct_log(X, basis)
    X, half = _as_float(X)
    d = X.shape[-1]
    domain, kernel = _use_kernel(backend, not X.is_complex(), d, X, "expm",
                                 f"real input with d <= {MAX_N}",
                                 f"{'complex' if X.is_complex() else 'real'} input, d={d}")
    if domain and backend != "torch":
        y = ExpmFunction.apply(X.reshape(-1, d, d), kernel).reshape(X.shape)
    else:
        y = _expm_core(X)
    return downcast(y, half)


def _expm_derivatives_taylor(coefs, basis_arr, grad_X, grad_basis, hess_X, max_order, tol):
    """One-pass coupled Taylor recursion for ``expm_derivatives``: value,
    d/dcoefs, d/dbasis and the coefficient Hessian accumulate together,
    one order per step (the reference's scheme) on broadcast-batched
    products:

    ``E_n = E_{n-1} X / n``, ``dE_n = (dE_{n-1} X + E_{n-1} B) / n``,
    ``dB_n`` likewise against the coefficient-scaled one-hot basis of the
    basis, and ``hE_n = (hE_{n-1} X + dEB + dEB^T) / n`` with ``dEB[f, g] =
    dE_{n-1}[f] B[g]``. Stops on the Frobenius sum of squares of the value
    term (one read on the host an order) or ``max_order``. Plain Taylor,
    like the reference: accurate for ||X|| up to a few; for large-norm logs
    use the jacfwd path.
    """
    X = torch.sum(basis_arr * coefs[..., None, None], dim=-3)
    d = X.shape[-1]
    f = basis_arr.shape[-3]
    dt = X.dtype
    batch = X.shape[:-2]
    eye = torch.eye(d, dtype=dt, device=X.device)
    B = basis_arr.expand(*batch, f, d, d)
    Xb = X[..., None, :, :]  # (..., 1, D, D) broadcasts over F
    s = {"E": eye + X, "En": X}
    if grad_X or hess_X:
        s["dE"] = s["dEn"] = B
    BB = None
    if grad_basis:
        # basis of the basis: d X / d B_f[k, l] = c_f e_k e_l^T
        bb = torch.eye(d * d, dtype=dt, device=X.device).reshape(d * d, d, d)
        BB = (coefs[..., :, None, None, None] * bb).reshape(*batch, f * d * d, d, d)
        s["dB"] = s["dBn"] = BB
    if hess_X:
        s["hE"] = s["hEn"] = torch.zeros(*batch, f, f, d, d, dtype=dt, device=X.device)
    numel = float(math.prod(X.shape))
    n, sos = 2, math.inf
    while n <= max_order and sos > numel * tol:
        if hess_X:
            dEB = _bmm(s["dEn"][..., :, None, :, :], B[..., None, :, :, :])
            s["hEn"] = (_bmm(s["hEn"], Xb[..., None, :, :]) + dEB + dEB.transpose(-3, -4)) / n
            s["hE"] = s["hE"] + s["hEn"]
        if grad_X or hess_X:
            s["dEn"] = (_bmm(s["dEn"], Xb) + _bmm(s["En"][..., None, :, :], B)) / n
            s["dE"] = s["dE"] + s["dEn"]
        if grad_basis:
            s["dBn"] = (_bmm(s["dBn"], Xb) + _bmm(s["En"][..., None, :, :], BB)) / n
            s["dB"] = s["dB"] + s["dBn"]
        s["En"] = _bmm(s["En"], X) / n
        s["E"] = s["E"] + s["En"]
        sos = float(torch.sum(s["En"].abs() ** 2))
        n += 1
    out = [s["E"]]
    if grad_X:
        out.append(s["dE"])
    if grad_basis:
        out.append(s["dB"].reshape(*batch, f, d, d, d, d))
    if hess_X:
        out.append(s["hE"])
    return out[0] if len(out) == 1 else tuple(out)


def expm_derivatives(X, basis=None, grad_X: bool = False, grad_basis: bool = False,
                     hess_X: bool = False, max_order: int = 10000, tol: float = 1e-32,
                     method: str = "auto"):
    """Matrix exponential and its derivatives w.r.t. the Lie-algebra
    parameterization.

    Returns ``E (..., D, D)`` plus, in order, when requested:
    ``dX (..., F, D, D)`` (derivative w.r.t. coefficients),
    ``dB (..., F, D, D, D, D)`` (derivative w.r.t. the basis),
    ``hX (..., F, F, D, D)`` (Hessian w.r.t. coefficients).

    ``method``: ``"taylor"`` accumulates everything in one coupled Taylor
    recursion (:func:`_expm_derivatives_taylor`); ``"jacfwd"`` takes exact
    forward-mode derivatives (``torch.func.vmap`` of ``torch.func.jacfwd``)
    of the scaling-and-squaring :func:`_expm_core` on plain PyTorch ops
    (norm-safe); ``"auto"`` = taylor unless no derivative is requested.
    """
    if basis is None:
        # one-hot basis over all D*D entries
        X = torch.as_tensor(X)
        d = X.shape[-1]
        coefs = X.reshape(*X.shape[:-2], d * d)
        basis_arr = torch.eye(d * d, dtype=X.dtype, device=X.device).reshape(d * d, d, d)
    else:
        coefs = torch.as_tensor(X)
        basis_arr = torch.as_tensor(basis, device=coefs.device)
    if not (coefs.is_floating_point() or coefs.is_complex()):
        coefs = coefs.to(torch.get_default_dtype())
    if basis_arr.dtype != coefs.dtype:
        dt = torch.promote_types(coefs.dtype, basis_arr.dtype)
        basis_arr, coefs = basis_arr.to(dt), coefs.to(dt)
    d = basis_arr.shape[-1]
    f = coefs.shape[-1]
    if method not in ("auto", "taylor", "jacfwd"):
        raise ValueError(f"unknown method {method!r}")
    any_grad = grad_X or grad_basis or hess_X
    if method == "taylor" or (method == "auto" and any_grad):
        return _expm_derivatives_taylor(coefs, basis_arr, grad_X, grad_basis, hess_X,
                                        max_order, tol)

    def fn(c, b):
        # per sample: c (F,), b (F, D, D); the fixed masked squarings and
        # torch.matmul only (torch.func cannot read the host or pass an
        # autograd.Function without a jvp rule)
        return _expm_core(torch.sum(b * c[..., None, None], dim=-3), _SQUARINGS_MAX)

    # jacfwd differentiates w.r.t. the whole argument: flatten the
    # broadcast batch and vmap the per-sample jacobian
    batch = torch.broadcast_shapes(coefs.shape[:-1], basis_arr.shape[:-3])
    nb = math.prod(batch)
    cb = coefs.expand(*batch, f).reshape(nb, f)
    bb = basis_arr.expand(*batch, f, d, d).reshape(nb, f, d, d)
    vmap, jacfwd = torch.func.vmap, torch.func.jacfwd
    out = [vmap(fn)(cb, bb).reshape(*batch, d, d)]
    if grad_X:
        jac = vmap(jacfwd(fn, argnums=0))(cb, bb)
        # jacfwd appends input dims; move the F axis in front of (D, D)
        out.append(torch.movedim(jac, -1, -3).reshape(*batch, f, d, d))
    if grad_basis:
        jb = vmap(jacfwd(fn, argnums=1))(cb, bb)
        # jac[i, j, f, k, l] = dE_ij / dB_fkl -> layout (f, k, l, i, j)
        out.append(torch.movedim(jb, (-5, -4), (-2, -1)).reshape(*batch, f, d, d, d, d))
    if hess_X:
        hj = vmap(jacfwd(jacfwd(fn, argnums=0), argnums=0))(cb, bb)
        # (N, D, D, F, F) -> (N, F, F, D, D)
        out.append(torch.movedim(hj, (-2, -1), (-4, -3)).reshape(*batch, f, f, d, d))
    return out[0] if len(out) == 1 else tuple(out)


# ---------------------------------------------------------------------------
# logm
# ---------------------------------------------------------------------------


def _real_dtype(x):
    return x.real.dtype if x.is_complex() else x.dtype


def _inv_small(M: torch.Tensor) -> torch.Tensor:
    """Batched inverse of the plain ISS loops: ``batchinv`` for d <= 8
    (the inverse kernel for real input on the card, the closed form or the
    pivoted LU otherwise), ``torch.linalg.inv_ex`` beyond (NaN, not an
    error, for a singular or non-finite matrix, as ``jnp.linalg.inv``)."""
    if M.shape[-1] <= 8:
        return batchinv(M)
    return torch.linalg.inv_ex(M)[0]


def _iss_log_core(A, scaled: bool = False):
    """Inverse scaling and squaring + Gregory series, real or complex
    batches (:func:`kernels.logm.iss_log` with Denman-Beavers tolerance
    4 eps d and :func:`_inv_small`; ``scaled=True`` adds determinant
    scaling to the square roots, only safe away from the negative real
    axis, where on-cut eigenvalues must diverge to NaN). Returns ``(L,
    ok)``: ``ok`` flags, per matrix, that the square-root chain reached the
    series' region and L is finite; matrices with eigenvalues on the
    negative real axis come back ``ok=False`` instead of silently wrong."""
    d = A.shape[-1]
    tol = torch.finfo(_real_dtype(A)).eps * d * 4
    L, k, ok = iss_log(A.reshape(-1, d, d), tol, _inv_small, det=batchdet if scaled else None)
    L = L * torch.exp2(k)[:, None, None]
    ok = ok & torch.isfinite(L).all(dim=-1).all(dim=-1)
    return L.reshape(A.shape), ok.reshape(A.shape[:-2])


def _logm_exceptional(A):
    """Branch-cut-capable batched logm for matrices the real ISS path
    cannot handle (eigenvalues on the negative real axis). Real or complex
    input; returns the complex principal log (the caller real-casts for
    real input).

    * normal matrices: ``C = H + i t K`` (H, K the Hermitian and
      skew-Hermitian parts) is Hermitian and shares A's eigenvectors, so
      one Hermitian Jacobi eigendecomposition (the plain
      ``eig_sym(backend="torch")``) recovers them and each eigenvalue's
      principal log is exact; accepted per matrix only where ``V diag(lam)
      V^H`` reproduces A (distinct eigenvalues can collide in C);
    * otherwise: an imaginary spectral shift ``B = A + i delta I``, the
      complex ISS with determinant scaling, then the exact commuting-series
      correction (k <= 4): error O(delta^5 + eps / delta^2), about 1e-11
      in float64.
    """
    from .qr import eig_sym

    d = A.shape[-1]
    cdt = torch.promote_types(A.dtype, torch.complex64)
    rdt = _real_dtype(torch.empty(0, dtype=cdt))
    Ah = A.conj().mT
    comm = _bmm(A, Ah) - _bmm(Ah, A)
    c2 = torch.sum(comm.abs() ** 2, dim=(-2, -1))
    a2 = torch.sum(A.abs() ** 2, dim=(-2, -1))
    eps = torch.finfo(rdt).eps
    is_normal = c2 <= (64 * eps) ** 2 * a2 ** 2
    Ac = A.to(cdt)

    # (a) normal route: joint Hermitian diagonalization
    t = 0.7390851332151607
    C = (0.5 * (A + Ah)).to(cdt) + (1j * t) * (0.5 * (A - Ah)).to(cdt)
    _, V = eig_sym(C, compute_u=True, check_finite=False, backend="torch")
    Vc = V.conj()
    lam = torch.einsum("...ij,...ij->...j", Vc, _bmm(Ac, V))
    Ln = torch.einsum("...ik,...k,...jk->...ij", V, torch.log(lam), Vc)
    recon = torch.einsum("...ik,...k,...jk->...ij", V, lam, Vc)
    r2 = torch.sum((recon - Ac).abs() ** 2, dim=(-2, -1))
    diag_ok = r2 <= (64 * eps) ** 2 * torch.clamp(a2, min=1e-30)

    # (b) shift route
    delta0 = 5e-4 if eps < 1e-10 else 2e-2
    norm1 = A.abs().sum(dim=-2).amax(dim=-1)
    dl = (delta0 * torch.clamp(norm1, min=1e-30)).to(rdt)
    eye = torch.eye(d, dtype=cdt, device=A.device)
    e = (1j * dl.to(cdt))[..., None, None]
    Ls, oks = _iss_log_core(Ac + e * eye, scaled=True)
    R1 = _inv_small(Ac)
    R2 = _bmm(R1, R1)
    bracket = e * R1 - (e ** 2 / 2) * R2 + (e ** 3 / 3) * _bmm(R2, R1) - (e ** 4 / 4) * _bmm(R2, R2)
    nan = torch.full_like(Ls, complex(math.nan, math.nan))
    Lsh = torch.where(oks[..., None, None], Ls - bracket, nan)
    return torch.where((is_normal & diag_ok)[..., None, None], Ln, Lsh)


def _logm_sym_eig(A):
    """Symmetric-input log through the eig kernel: exactly the real-cast
    principal log for real symmetric input (V real orthogonal, so the
    imaginary part ``pi V 1_{w<0} V^T`` is what real-casting discards).
    Returns ``(L, ok)``; singular input (an eigenvalue 0) comes back
    non-finite, ok=False.

    Two corrections (6 products, few beside the eig) take the float32
    Jacobi floor to second order: one Newton-Schulz polish ``V <- V (3I -
    V^T V) / 2`` and the diagonal plus first-order off-diagonal
    Daleckii-Krein term of ``log`` at ``M = V^T A V``: ``log(M)_ij ~=
    delta_ij log|m_i| + E_ij (log|m_i| - log|m_j|) / (m_i - m_j)``.
    ``torch.log``, not the reference's ``core.accmath.log``: that
    replacement works around the TPU's float32 ``log`` (about 4000 ulp);
    the card's is accurate to a few ulp.
    """
    from .qr import eig_sym

    As = 0.5 * (A + A.mT)
    # polish=False: this route carries its own Newton-Schulz and
    # Daleckii-Krein correction below
    _, V = eig_sym(As, compute_u=True, check_finite=False, polish=False)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    vtv = _bmm(V.mT, V)
    V = _bmm(V, 1.5 * eye - 0.5 * vtv)
    M = _bmm(_bmm(V.mT, As), V)
    m = torch.diagonal(M, dim1=-2, dim2=-1)
    logm_d = torch.log(m.abs())
    mi, mj = m[..., :, None], m[..., None, :]
    li, lj = logm_d[..., :, None], logm_d[..., None, :]
    den = mi - mj
    # divided difference of log|.|, limit 2 / (mi + mj) for near-equal
    # same-sign pairs
    near = den.abs() <= 1e-3 * (mi.abs() + mj.abs())
    one = torch.ones_like(den)
    dd = torch.where(near, 2.0 / torch.where(near, mi + mj, one),
                     (li - lj) / torch.where(near, one, den))
    Lm = logm_d[..., :, None] * eye + (M - m[..., :, None] * eye) * dd
    L = _bmm(_bmm(V, Lm), V.mT)
    return L, torch.isfinite(L).all(dim=-1).all(dim=-1)


def _on_card(x) -> bool:
    """Routing gate of the kernel tiers: the tensor is on a CUDA device (the
    reference's ``_on_tpu``; module-level so that a rehearsal on the CPU can
    take the card's branches)."""
    return x.is_cuda


def _symmetric_mask(A):
    """Per-matrix round-off symmetry test (the tolerance style of the
    normality test in :func:`_logm_exceptional`)."""
    d2 = torch.sum((A - A.mT) ** 2, dim=(-2, -1))
    a2 = torch.sum(A * A, dim=(-2, -1))
    eps = torch.finfo(A.dtype).eps
    return d2 <= (64 * eps) ** 2 * torch.clamp(a2, min=1e-300)


def _logm_plain(mat, sym_route: bool = True):
    """The regular-case batched log, with no branch-cut rescue: ``(L,
    ok)``, non-converged and branch-cut matrices NaN with ``ok`` False.
    On a CUDA tensor with real d <= 32 the logm kernel, or, for an
    all-symmetric batch with ``_LOGM_SYM_EIG_MIN_D <= d <= 32`` (one test
    on the host) and ``sym_route``, :func:`_logm_sym_eig`; elsewhere
    :func:`_iss_log_core`. :func:`meanm` passes ``sym_route=False``: its
    operands ``mean^-1 A`` are generically not symmetric."""
    A, _ = _as_float(mat)
    d = A.shape[-1]
    kernel = _on_card(A) and not A.is_complex() and in_domain(d, A.dtype)
    if A.numel() == 0:
        return A.clone(), torch.ones(A.shape[:-2], dtype=torch.bool, device=A.device)
    if (kernel and sym_route and _LOGM_SYM_EIG_MIN_D <= d <= _LOGM_SYM_EIG_MAX_D
            and bool(_symmetric_mask(A).all())):
        return _logm_sym_eig(A)
    if kernel:
        L = launch_logm(A.reshape(-1, d, d)).reshape(A.shape)
        return L, torch.isfinite(L).all(dim=-1).all(dim=-1)
    return _iss_log_core(A)


def _logm_impl(mat):
    A, _ = _as_float(mat)
    d = A.shape[-1]
    L, ok = _logm_plain(A)
    bad = ~ok.reshape(-1)
    # one read on the host: the exceptional path runs only for the
    # matrices on the branch cut, and only when there are some
    if bool(bad.any()):
        idx = bad.nonzero()[:, 0]
        Lx = _logm_exceptional(A.reshape(-1, d, d)[idx])
        if not A.is_complex():
            Lx = Lx.real
        L = L.reshape(-1, d, d).clone()
        L[idx] = Lx
        L = L.reshape(A.shape)
    return L


class _LogmFunction(torch.autograd.Function):
    """``logm`` with the Mathias backward: the VJP is the top-right block
    of ``logm([[Aᵀ, G], [0, Aᵀ]])`` (through this Function again, so it is
    differentiable twice)."""

    @staticmethod
    def forward(ctx, a):
        ctx.save_for_backward(a)
        return _logm_impl(a)

    @staticmethod
    def backward(ctx, g):
        (a,) = ctx.saved_tensors
        d = a.shape[-1]
        at = a.mT.to(g.dtype)
        blk = torch.cat([torch.cat([at, g], dim=-1),
                         torch.cat([torch.zeros_like(at), at], dim=-1)], dim=-2)
        return _LogmFunction.apply(blk)[..., :d, d:]


def logm(mat):
    """Batched matrix logarithm by inverse scaling and squaring (each
    matrix its own square-root depth, then an atanh Gregory series), on the
    tensors' device.

    Real inputs whose principal log is complex (eigenvalues on the
    negative real axis) return the real part of the complex principal log,
    like scipy real-cast; complex inputs return the complex principal log.
    Only the affected matrices pay for the exceptional path.

    Differentiable by the Mathias block-matrix chain rule: the VJP is the
    top-right block of ``logm([[A^T, G], [0, A^T]])``.

    float32 accuracy (the reference's contract, 4x4 expm/logm roundtrip):
    elementwise relative error median about 1e-7, p99 within 3e-5; the
    final multiply by 2^k amplifies the last rounding. Use float64 for
    1e-11-class tails.
    """
    A, half = _as_float(mat)
    return downcast(_LogmFunction.apply(A), half)


def meanm(mats, max_iter: int = 1024, tol: float = 1e-20):
    r"""Exponential barycenter of a set of invertible matrices ``(..., N,
    M, M) -> (..., M, M)`` (Pennec & Arsigny 2012), by fixed-point
    iteration: project through ``logm(mean \ A_n)``, average in the tangent
    space, ``expm`` back. Always in float64 (the reference's contract; the
    JAX package falls back to float32 when x64 is off, this one does not);
    the result is cast back to the input's dtype.

    Leading batch dims run natively: G barycenters iterate together, each
    with its own plateau and divergence masks and best iterate, and every
    inner ``logm`` / ``expm`` sees the whole ``G*N`` batch. The loop is a
    Python loop with one read on the host an iteration. It stops at
    ``max_iter``, or when every barycenter has reached ``tol``, stalled (the
    first iteration that does not improve its residual, plateau detection)
    or diverged (a NaN projection, with a warning). Returns each
    barycenter's best iterate.
    """
    mats = torch.as_tensor(mats)
    in_dtype = mats.dtype
    mats = mats.to(torch.float64)
    dim = mats.shape[-1]
    gshape = mats.shape[:-3]
    dev = mats.device
    eye = torch.eye(dim, dtype=torch.float64, device=dev).expand(*gshape, dim, dim)
    mean, best_mean = eye.clone(), eye.clone()
    sos = torch.full(gshape, math.inf, dtype=torch.float64, device=dev)
    best_sos = sos.clone()
    diverged = torch.zeros(gshape, dtype=torch.bool, device=dev)
    stalled = diverged.clone()
    n_iter = 0
    while n_iter < max_iter and bool(((sos > tol) & ~diverged & ~stalled).any()):
        # the regular-case log only: a branch-cut projection is meanm
        # divergence by contract
        log_mats, log_ok = _logm_plain(lmdiv(mean[..., None, :, :], mats), sym_route=False)
        bad = ~(torch.isfinite(log_mats).all(dim=-1).all(dim=-1) & log_ok)
        diverged = diverged | bad.any(dim=-1)
        mean_log = log_mats.mean(dim=-3)
        new_sos = torch.sum(mean_log ** 2, dim=(-2, -1))
        # plateau test against the best before this iteration
        frozen = diverged | stalled
        stalled = stalled | ((new_sos >= best_sos) & ~frozen)
        new_sos = torch.where(frozen, sos, new_sos)
        better = (new_sos < best_sos) & ~frozen
        best_mean = torch.where(better[..., None, None], mean, best_mean)
        best_sos = torch.where(better, new_sos, best_sos)
        mean = torch.where(frozen[..., None, None], mean, _bmm(mean, expm(mean_log)))
        sos = new_sos
        n_iter += 1
    # the post-update mean beats the best measured one iff the loop ended
    # while it was still improving
    mean = torch.where(((sos <= best_sos) & ~diverged)[..., None, None], mean, best_mean)
    if bool(diverged.any()):
        warnings.warn("`meanm` failed to converge (`logm` -> NaN)", RuntimeWarning)
    return mean.to(in_dtype)
