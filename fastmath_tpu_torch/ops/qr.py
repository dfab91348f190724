"""Batched QR machinery and symmetric eigendecomposition.

PyTorch counterpart of ``fastmath_tpu/ops/qr.py``: ``eig_sym``,
``qr_hessenberg``, ``rq_hessenberg``, ``hessenberg``, ``hessenberg_sym``,
``householder``, ``householder_apply``, ``givens`` and ``givens_apply``,
batched over arbitrary leading dims, with the same arguments
(``inplace`` is accepted and is a no-op, as in the JAX package).

``eig_sym`` runs batched Jacobi, with eigenvalues **unsorted**, on one of
three routes:

* real n <= 3: closed forms (one rotation at 2x2, the trigonometric
  solution of the characteristic cubic at 3x3), elementwise, no kernel;
* real 1 <= n <= 32, float32/float64: the eig kernel
  (:mod:`fastmath_tpu_torch.kernels.eig`: cyclic Jacobi in registers to
  n = 8, round-robin Jacobi a warp per problem above), which reads the
  triangle ``upper`` names straight from the batch-major input; its plain
  PyTorch version on a CPU tensor;
* complex Hermitian input and n > 32: the kernels' plain version (cyclic
  to n = 8, round-robin above), each matrix sweeping until its own test
  passes or ``max_iter`` (at most 30) sweeps ran (the reference's XLA
  path sweeps every matrix until all pass).

``backend``: ``"auto"`` takes the closed forms for real n <= 3, the
kernel for real 4 <= n <= 32 (on a CUDA tensor; its plain version on the
CPU), the plain Jacobi otherwise; ``"cuda"`` forces the kernel (real 1
<= n <= 32 on a CUDA tensor, else it raises); ``"torch"`` runs the plain
Jacobi; ``"analytic"`` forces the closed forms (real n <= 3). Every
route carries the Giles backward (reverse mode only).

The Householder, Hessenberg and Givens helpers are Python loops over the
(small) matrix dimension, each step one batched PyTorch op.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.dtypes import downcast, upcast_half
from ..layouts.sym import sym_from_triangle, triangle_mask

__all__ = [
    "eig_sym",
    "qr_hessenberg",
    "rq_hessenberg",
    "hessenberg",
    "hessenberg_sym",
    "householder",
    "householder_apply",
    "givens",
    "givens_apply",
]

BACKENDS = ("auto", "cuda", "torch", "analytic")


def _check_finite_square(a, check_finite: bool, square: bool = True, name="input"):
    a = torch.as_tensor(a)
    if check_finite and not bool(torch.isfinite(a).all()):
        raise ValueError("Input has non finite values.")
    if square and a.shape[-1] != a.shape[-2]:
        raise ValueError(f"Expected square matrix. Got ({a.shape[-2]}, {a.shape[-1]})")
    return a


def _set(a, dim, index, value):
    """``a`` with ``a.select(dim, index)`` replaced by ``value``
    (broadcast), out of place (``.at[].set``)."""
    shape = a.select(dim, index).shape
    return torch.select_scatter(a, value.to(a.dtype).expand(shape), dim, index)


# ---------------------------------------------------------------------------
# Householder
# ---------------------------------------------------------------------------


def householder(x, basis: int = 0, inplace: bool = False, check_finite: bool = True,
                return_alpha: bool = False):
    r"""Householder vector ``u`` of ``x`` such that ``(I - 2 u u^H) x =
    alpha e_basis`` with ``alpha = -||x|| exp(i angle(x_basis))``; ``u = 0``
    for a null ``x``."""
    x = torch.as_tensor(x)
    if check_finite and not bool(torch.isfinite(x).all()):
        raise ValueError("Input has non finite values.")
    nrm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    xb = x[..., basis:basis + 1]
    if x.is_complex():
        mag = xb.abs()
        phase = torch.where(mag > 0, xb / torch.clamp(mag, min=1e-300), torch.ones_like(xb))
    else:
        phase = torch.where(xb >= 0, torch.ones_like(xb), -torch.ones_like(xb))
    alpha = -phase * nrm
    e = torch.zeros(x.shape[-1], dtype=x.dtype, device=x.device)
    e[basis] = 1
    u = x - alpha * e
    unrm = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    safe = unrm > 0
    u = torch.where(safe, u / torch.where(safe, unrm, torch.ones_like(unrm)),
                    torch.zeros_like(u))
    alpha = alpha[..., 0]
    return (u, alpha) if return_alpha else u


def _apply_reflector_left(a, u):
    # A <- A - 2 u (u^H A)
    uh_a = torch.einsum("...i,...ij->...j", torch.conj(u), a)
    return a - 2.0 * u[..., :, None] * uh_a[..., None, :]


def _apply_reflector_right(a, u):
    # A <- A - 2 (A u) u^H
    a_u = torch.einsum("...ij,...j->...i", a, u)
    return a - 2.0 * a_u[..., :, None] * torch.conj(u)[..., None, :]


def householder_apply(a, u, k=None, side: str = "both", inverse: bool = False,
                      inplace: bool = False, check_finite: bool = True):
    r"""Apply a sequence of Householder reflectors ``{u_k}`` to ``a``:
    ``U A U^H`` (side='both'), ``U A`` (left) or ``A U^H`` (right), with
    ``U = P_K ... P_1``, ``P_k = I - 2 u_k u_k^H``. ``inverse`` reverses
    the list first; then ``k``'s *length* selects how many leading
    reflectors apply (an int: one; ``None``: all), as in the reference.
    Reflectors shorter than n act on the trailing rows/columns."""
    a = _check_finite_square(a, check_finite)
    n = a.shape[-1]
    if isinstance(u, (list, tuple)):
        us = list(u)
    else:
        u = torch.as_tensor(u)
        if u.dim() >= 2 and u.shape[-2] != 1 and u.dim() >= a.dim():
            us = [u[..., i, :] for i in range(u.shape[-2])]  # stacked (..., K, n)
        else:
            us = [u]
    if inverse:
        us = us[::-1]
    if k is not None:
        if isinstance(k, range):
            k = list(k)
        us = us[:len(k) if isinstance(k, (list, tuple)) else 1]
    for uk in us:
        uk = torch.as_tensor(uk)
        if uk.shape[-1] < n:
            uk = torch.nn.functional.pad(uk, (n - uk.shape[-1], 0))
        if side in ("left", "both"):
            a = _apply_reflector_left(a, uk)
        if side in ("right", "both"):
            a = _apply_reflector_right(a, uk)
    return a


# ---------------------------------------------------------------------------
# Hessenberg
# ---------------------------------------------------------------------------


def hessenberg(a, inplace: bool = False, check_finite: bool = True, compute_u: bool = False):
    """Reduce to (upper) Hessenberg form by n-2 Householder similarity
    transforms. Returns ``h`` (and the stacked reflectors ``u (..., n-2,
    n)`` when ``compute_u``)."""
    a = _check_finite_square(a, check_finite)
    n = a.shape[-1]
    idx = torch.arange(n, device=a.device)
    us = []
    for k in range(n - 2):
        # zero out entries <= k so the reflector acts on rows k+1..n-1
        col = a[..., :, k]
        u = householder(torch.where(idx >= k + 1, col, torch.zeros_like(col)), basis=k + 1,
                        check_finite=False)
        a = _apply_reflector_left(a, u)
        a = _apply_reflector_right(a, u)
        us.append(u)
    keep = triangle_mask(n, True, a.device, -1)  # rows <= cols + 1
    h = torch.where(keep, a, torch.zeros((), dtype=a.dtype, device=a.device))
    if compute_u:
        ustack = (torch.stack(us, dim=-2) if us
                  else torch.zeros(*a.shape[:-2], 0, n, dtype=a.dtype, device=a.device))
        return h, ustack
    return h


def hessenberg_sym(a, upper: bool = True, fill: bool = True, inplace: bool = False,
                   check_finite: bool = True, compute_u: bool = False):
    """Tridiagonalize a Hermitian matrix using only its ``upper`` or lower
    triangle. ``fill=False`` returns only the requested triangle of the
    tridiagonal result."""
    a = _check_finite_square(a, check_finite)
    n = a.shape[-1]
    out = hessenberg(sym_from_triangle(a, upper), check_finite=False, compute_u=compute_u)
    h, us = out if compute_u else (out, None)
    if not fill:
        h = torch.where(triangle_mask(n, upper, a.device), h,
                        torch.zeros((), dtype=h.dtype, device=h.device))
    return (h, us) if compute_u else h


# ---------------------------------------------------------------------------
# Givens
# ---------------------------------------------------------------------------


def givens(x, y):
    """Givens rotation aligning ``(x, y)`` with the first axis: ``c = x /
    r``, ``s = -y / r``, and (1, 0) where r = 0."""
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    r = torch.hypot(x, y)
    safe = r > 0
    rs = torch.where(safe, r, torch.ones_like(r))
    c = torch.where(safe, x / rs, torch.ones_like(r))
    s = torch.where(safe, -y / rs, torch.zeros_like(r))
    return c, s


def _givens_rows(a, c, s, i, j):
    """Left-multiply by G^T acting on rows i, j: rows <- [c ri - s rj;
    s ri + c rj] (the rotation convention of :func:`givens`)."""
    ri, rj = a[..., i, :], a[..., j, :]
    c, s = c[..., None], s[..., None]
    a = _set(a, -2, i, c * ri - s * rj)
    return _set(a, -2, j, s * ri + c * rj)


def _givens_cols(a, c, s, i, j):
    ci, cj = a[..., :, i], a[..., :, j]
    c = c[..., None] if c.dim() == ci.dim() - 1 else c
    s = s[..., None] if s.dim() == cj.dim() - 1 else s
    a = _set(a, -1, i, c * ci - s * cj)
    return _set(a, -1, j, s * ci + c * cj)


def givens_apply(a, c, s, i: int = 0, j: Optional[int] = None, side: str = "both",
                 inplace: bool = False, check_finite: bool = True):
    """Apply a Givens rotation in the (i, j) plane to rows and/or columns
    of ``a``."""
    a = _check_finite_square(a, check_finite)
    j = i + 1 if j is None else j
    c, s = torch.as_tensor(c), torch.as_tensor(s)
    if side in ("left", "both"):
        a = _givens_rows(a, c, s, i, j)
    if side in ("right", "both"):
        a = _givens_cols(a, c, s, i, j)
    return a


# ---------------------------------------------------------------------------
# QR / RQ of Hessenberg matrices (n-1 Givens rotations)
# ---------------------------------------------------------------------------


def qr_hessenberg(h, inplace: bool = False, check_finite: bool = True):
    """QR decomposition of a Hessenberg matrix via n-1 Givens rotations.
    Returns ``(q, r)``."""
    h = _check_finite_square(h, check_finite)
    n = h.shape[-1]
    r = h
    q = torch.eye(n, dtype=h.dtype, device=h.device).expand(h.shape)
    for k in range(n - 1):
        c, s = givens(r[..., k, k], r[..., k + 1, k])
        r = _givens_rows(r, c, s, k, k + 1)
        q = _givens_cols(q, c, s, k, k + 1)
    return q, r


def rq_hessenberg(h, u=None, inplace: bool = False, check_finite: bool = True):
    """Fused ``R @ Q`` of the QR decomposition of a Hessenberg matrix (one
    pass of 2(n-1) Givens applications, the QR-iteration step); optionally
    rotates vector batches ``u`` by ``Q`` too."""
    h = _check_finite_square(h, check_finite)
    n = h.shape[-1]
    r = h
    rots = []
    for k in range(n - 1):
        c, s = givens(r[..., k, k], r[..., k + 1, k])
        r = _givens_rows(r, c, s, k, k + 1)
        rots.append((c, s))
    for k, (c, s) in enumerate(rots):
        r = _givens_cols(r, c, s, k, k + 1)
        if u is not None:
            u = _givens_cols(torch.as_tensor(u), c, s, k, k + 1)
    return (r, u) if u is not None else r


# ---------------------------------------------------------------------------
# eig_sym outside the kernels' domain: the plain Jacobi, the Giles backward
# ---------------------------------------------------------------------------

_JACOBI_SWEEPS_MAX = 30


def _real(x):
    return x.real if x.is_complex() else x


def _real_dtype(x):
    return x.real.dtype if x.is_complex() else x.dtype


def _giles_da(w, u, dw, du):
    """Giles (2008) eigendecomposition backward: dA = U (diag(dw) + F o
    (U^T dU)) U^T, F_ij = 1/(w_j - w_i) off the diagonal and 0 on it,
    symmetrized; ``du`` may be None (eigenvalues-only cotangent). The
    products go through :func:`batchmatmul`."""
    from .batched import batchmatmul as _bmm

    n = w.shape[-1]
    eye = torch.eye(n, dtype=w.dtype, device=w.device)
    inner = eye * dw[..., :, None]
    if du is not None:
        inner = inner.to(u.dtype)
        ut_du = _bmm(u.transpose(-1, -2), du)
        diff = w[..., None, :] - w[..., :, None]
        f = torch.where(diff.abs() > 1e-300,
                        1.0 / torch.where(diff == 0, torch.ones_like(diff), diff),
                        torch.zeros_like(diff))
        inner = inner + (f * (1.0 - eye)) * ut_du
    inner = inner.to(u.dtype)
    da = _bmm(_bmm(u, inner), u.transpose(-1, -2))
    return 0.5 * (da + da.transpose(-1, -2))


class _JacobiFunction(torch.autograd.Function):
    """Jacobi outside the kernels' domain (complex Hermitian input, n > 32)
    with the Giles backward: ``apply(sym, max_sweeps, tol)`` -> (w, v), the
    kernels' plain version with ``tol`` as an absolute floor under each
    matrix's test."""

    @staticmethod
    def forward(ctx, sym, max_sweeps, tol):
        from ..kernels.eig import eig_plain

        batch, n = sym.shape[:-2], sym.shape[-1]
        w, v = eig_plain(sym.reshape(-1, n, n), True, max_sweeps, tol)
        w, v = w.reshape(*batch, n), v.reshape(*batch, n, n)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(w, v)
        return w, v

    @staticmethod
    def backward(ctx, dw, dv):
        w, v = ctx.saved_tensors
        if dw is None:
            dw = torch.zeros_like(w)
        return _giles_da(w, v, dw, dv), None, None


# ---------------------------------------------------------------------------
# closed forms (real symmetric, n <= 3)
# ---------------------------------------------------------------------------

_TWO_PI_3 = 2.0943951023931953  # 2*pi/3


def _analytic_prescale(sym):
    s = sym.abs().amax(dim=(-2, -1))
    safe = torch.where(s > 0, s, torch.ones_like(s))
    return sym / safe[..., None, None], safe


def _eig2_analytic_rot(sym):
    """2x2 closed form: the single Jacobi rotation that diagonalizes.
    Returns ``(w, (c, s))``, ``w`` paired to the columns ``(c, s)`` and
    ``(-s, c)``."""
    a, b, d = sym[..., 0, 0], sym[..., 1, 1], sym[..., 0, 1]
    one = torch.ones_like(d)
    zero_d = d == 0
    tau = (a - b) / (2 * torch.where(zero_d, one, d))
    sgn = torch.where(tau >= 0, one, -one)
    t = torch.where(zero_d, torch.zeros_like(d), sgn / (tau.abs() + torch.sqrt(1 + tau * tau)))
    c = 1.0 / torch.sqrt(1 + t * t)
    s = t * c
    return torch.stack([a + t * d, b - t * d], dim=-1), (c, s)


def _eig3_analytic_w(sym, want_u: bool = False):
    """3x3 closed form (descending): trigonometric roots of the trace-free
    characteristic cubic as seeds, then a deflation pass (projector of the
    best-separated root, Rayleigh quotient, and the exact 2x2 restriction
    for the other pair) for ~eps |A| accuracy; with ``want_u`` the exactly
    orthogonal eigenvector matrix too (columns)."""
    a, b, c = sym[..., 0, 0], sym[..., 1, 1], sym[..., 2, 2]
    d, e, f = sym[..., 0, 1], sym[..., 0, 2], sym[..., 1, 2]
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    q = (a + b + c) / 3
    x, y, z = a - q, b - q, c - q
    p2 = x * x + y * y + z * z + 2 * (d * d + e * e + f * f)
    p = torch.sqrt(p2 / 6)
    safe_p = torch.where(p > 0, p, one)
    xb, yb, zb = x / safe_p, y / safe_p, z / safe_p
    db, eb, fb = d / safe_p, e / safe_p, f / safe_p
    det_b = (xb * (yb * zb - fb * fb) - db * (db * zb - fb * eb) + eb * (db * fb - yb * eb))
    r = torch.clamp(det_b / 2, -1.0, 1.0)
    phi = torch.arccos(r) / 3
    w0 = q + 2 * p * torch.cos(phi)
    w2 = q + 2 * p * torch.cos(phi + _TWO_PI_3)
    w1 = 3 * q - w0 - w2

    top_sep = (w0 - w1) >= (w1 - w2)
    lsep = torch.where(top_sep, w0, w2)
    la = torch.where(top_sep, w1, w0)
    lb = torch.where(top_sep, w2, w1)
    a1, b1, c1 = a - la, b - la, c - la
    a2, b2, c2 = a - lb, b - lb, c - lb
    p00 = a1 * a2 + d * d + e * e
    p10 = d * a2 + b1 * d + f * e
    p20 = e * a2 + f * d + c1 * e
    p01 = a1 * d + d * b2 + e * f
    p11 = d * d + b1 * b2 + f * f
    p21 = e * d + f * b2 + c1 * f
    p02 = a1 * e + d * f + e * c2
    p12 = d * e + b1 * f + f * c2
    p22 = e * e + f * f + c1 * c2
    n0 = p00 * p00 + p10 * p10 + p20 * p20
    n1 = p01 * p01 + p11 * p11 + p21 * p21
    n2 = p02 * p02 + p12 * p12 + p22 * p22
    use0 = (n0 >= n1) & (n0 >= n2)
    use1 = ~use0 & (n1 >= n2)
    ux = torch.where(use0, p00, torch.where(use1, p01, p02))
    uy = torch.where(use0, p10, torch.where(use1, p11, p12))
    uz = torch.where(use0, p20, torch.where(use1, p21, p22))
    bestn = torch.where(use0, n0, torch.where(use1, n1, n2))
    # (near-)triple cluster: the projector vanishes, any direction works
    degen = bestn <= 0
    ux = torch.where(degen, one, ux)
    uy = torch.where(degen, zero, uy)
    uz = torch.where(degen, zero, uz)
    un = torch.sqrt(ux * ux + uy * uy + uz * uz)
    ux, uy, uz = ux / un, uy / un, uz / un
    # orthonormal basis (v, s) of the complement: subtract u from the
    # least-aligned coordinate axis
    ax_, ay_, az_ = ux.abs(), uy.abs(), uz.abs()
    use_x = (ax_ <= ay_) & (ax_ <= az_)
    use_y = ~use_x & (ay_ <= az_)
    ek_x = torch.where(use_x, one, zero)
    ek_y = torch.where(use_y, one, zero)
    ek_z = torch.where(use_x | use_y, zero, one)
    uk = torch.where(use_x, ux, torch.where(use_y, uy, uz))
    tx, ty, tz = ek_x - uk * ux, ek_y - uk * uy, ek_z - uk * uz
    tn = torch.sqrt(tx * tx + ty * ty + tz * tz)  # >= sqrt(2/3): safe
    vx, vy, vz = tx / tn, ty / tn, tz / tn
    sx = uy * vz - uz * vy
    sy = uz * vx - ux * vz
    sz = ux * vy - uy * vx

    def _amv(px, py, pz):  # A @ (px, py, pz), elementwise
        return (a * px + d * py + e * pz, d * px + b * py + f * pz, e * px + f * py + c * pz)

    avx, avy, avz = _amv(vx, vy, vz)
    asx, asy, asz = _amv(sx, sy, sz)
    aux, auy, auz = _amv(ux, uy, uz)
    q11 = vx * avx + vy * avy + vz * avz
    q12 = sx * avx + sy * avy + sz * avz
    q22 = sx * asx + sy * asy + sz * asz
    lsep_r = ux * aux + uy * auy + uz * auz  # Rayleigh quotient
    # 2x2 closed form on the restriction (backward stable)
    zero_q = q12 == 0
    tau = (q11 - q22) / (2 * torch.where(zero_q, one, q12))
    sgn = torch.where(tau >= 0, one, -one)
    t = torch.where(zero_q, zero, sgn / (tau.abs() + torch.sqrt(1 + tau * tau)))
    wa = q11 + t * q12
    wb = q22 - t * q12
    if not want_u:
        hi, lo = torch.maximum(wa, wb), torch.minimum(wa, wb)
        o0, o2 = torch.maximum(lsep_r, hi), torch.minimum(lsep_r, lo)
        o1 = lsep_r + hi + lo - o0 - o2
        return torch.stack([o0, o1, o2], dim=-1)

    ct = 1.0 / torch.sqrt(1 + t * t)
    st = t * ct
    ya = torch.stack([ct * vx + st * sx, ct * vy + st * sy, ct * vz + st * sz], dim=-1)
    yb = torch.stack([-st * vx + ct * sx, -st * vy + ct * sy, -st * vz + ct * sz], dim=-1)
    usep = torch.stack([ux, uy, uz], dim=-1)

    def cswap(lam1, vec1, lam2, vec2):  # descending compare-swap
        cond = lam1 >= lam2
        cv = cond[..., None]
        return (torch.where(cond, lam1, lam2), torch.where(cv, vec1, vec2),
                torch.where(cond, lam2, lam1), torch.where(cv, vec2, vec1))

    l0, v0, l1, v1 = lsep_r, usep, wa, ya
    l2, v2 = wb, yb
    l0, v0, l1, v1 = cswap(l0, v0, l1, v1)
    l1, v1, l2, v2 = cswap(l1, v1, l2, v2)
    l0, v0, l1, v1 = cswap(l0, v0, l1, v1)
    return torch.stack([l0, l1, l2], dim=-1), torch.stack([v0, v1, v2], dim=-1)


def _rot2(c, s):
    return torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)


def _eig_analytic_w_impl(sym):
    n = sym.shape[-1]
    sym_s, scale = _analytic_prescale(sym)
    if n == 1:
        w = sym_s[..., 0, :]
    elif n == 2:
        w, _ = _eig2_analytic_rot(sym_s)
    else:
        w = _eig3_analytic_w(sym_s)
    return w * scale[..., None]


class _AnalyticW(torch.autograd.Function):
    """Closed-form eigenvalues; backward: dA = sum_i dw_i u_i u_i^T with the
    closed-form eigenvectors (paired with the output order)."""

    @staticmethod
    def forward(ctx, sym):
        ctx.save_for_backward(sym)
        return _eig_analytic_w_impl(sym)

    @staticmethod
    def backward(ctx, dw):
        (sym,) = ctx.saved_tensors
        n = sym.shape[-1]
        if n == 1:
            return dw[..., None]
        sym_s, _ = _analytic_prescale(sym)
        if n == 2:
            _, (c, s) = _eig2_analytic_rot(sym_s)
            u = _rot2(c, s)
        else:
            _, u = _eig3_analytic_w(sym_s, want_u=True)
        da = torch.einsum("...i,...ji,...ki->...jk", dw, u, u)
        return 0.5 * (da + da.transpose(-1, -2))


class _AnalyticWU(torch.autograd.Function):
    """Closed-form eigenpairs at n = 2, 3, with the Giles backward."""

    @staticmethod
    def forward(ctx, sym):
        sym_s, scale = _analytic_prescale(sym)
        if sym.shape[-1] == 2:
            w, (c, s) = _eig2_analytic_rot(sym_s)
            u = _rot2(c, s)
        else:
            w, u = _eig3_analytic_w(sym_s, want_u=True)
        w = w * scale[..., None]
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(w, u)
        return w, u

    @staticmethod
    def backward(ctx, dw, du):
        w, u = ctx.saved_tensors
        if dw is None:
            dw = torch.zeros_like(w)
        return _giles_da(w, u, dw, du)


def _polish_wu(sym, w, u):
    """Second-order eigen-pair polish of an approximate eigendecomposition
    ``(w, u)`` of ``sym`` (9 batched matmuls): a Newton-Schulz step ``U <-
    U (3I - U^H U) / 2``, the first-order Rayleigh-Schroedinger correction
    at ``M = U^H A U`` (eigenvalues the Rayleigh quotients diag(M), ``U <-
    U (I + Y)`` with the Tikhonov-damped ``Y_ij = E_ij (w_j - w_i) /
    ((w_j - w_i)^2 + theta^2)``, theta = 1e-3 of the spectral scale), and a
    second Newton-Schulz step. Differentiable by ordinary autograd."""
    from .batched import batchmatmul as _bmm

    n = u.shape[-1]
    eye = torch.eye(n, dtype=u.dtype, device=u.device)

    def uh_of(x):
        return torch.conj(x).transpose(-1, -2)

    u = _bmm(u, 1.5 * eye - 0.5 * _bmm(uh_of(u), u))
    M = _bmm(_bmm(uh_of(u), sym), u)
    w2 = _real(M.diagonal(dim1=-2, dim2=-1))
    den = w2[..., None, :] - w2[..., :, None]
    scale = w2.abs().amax(dim=-1)
    tiny = torch.finfo(w2.dtype).tiny
    theta = (1e-3 * scale + tiny)[..., None, None]
    corr = den / (den * den + theta * theta)
    E = M - w2[..., :, None].to(u.dtype) * eye
    u = _bmm(u, eye + E * corr)
    u = _bmm(u, 1.5 * eye - 0.5 * _bmm(uh_of(u), u))
    return w2.to(_real(w).dtype), u


def eig_sym(a, compute_u: bool = False, upper: bool = True, inplace: bool = False,
            check_finite: bool = True, max_iter: int = 1024, tol: float = 1e-32,
            backend: str = "auto", polish: Optional[bool] = None):
    """Batched eigendecomposition of symmetric (Hermitian) matrices by
    Jacobi rotations; returns ``w`` or ``(w, u)``, eigenvalues **not
    sorted**, ``u``'s columns the eigenvectors. ``upper`` selects the
    triangle to trust. See the module docstring for the routes and
    ``backend``.

    ``max_iter`` (capped at 30) and ``tol`` (an absolute floor on each
    matrix's off-diagonal mass) govern complex input and n > 32 only; the
    kernel route caps its sweeps at 8 (n <= 4), 10 (n <= 8) or 14 and
    stops each problem on its own Frobenius-relative test; the closed
    forms do not iterate.

    ``polish`` (needs ``compute_u=True``): one Newton-Schulz step, a
    damped first-order Rayleigh correction and a second Newton-Schulz
    step (:func:`_polish_wu`, 9 batched matmuls). ``None`` = on for the
    single-precision iterative routes (their U loses orthogonality at
    ~1e-5), off for float64 and the closed forms. bf16/f16 compute in
    float32 and round once on output.
    """
    from ..kernels import eig as K
    from ..kernels._launch import MAX_N
    from .sym import _use_kernel

    a = _check_finite_square(a, check_finite)
    a, half = upcast_half(a)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    is_complex = a.is_complex()
    n = a.shape[-1]
    single = torch.finfo(_real_dtype(a)).eps > 1e-10
    analytic_ok = not is_complex and n <= 3
    if backend == "analytic" and not analytic_ok:
        raise ValueError("backend='analytic' requires real input with n <= 3")
    use_analytic = backend == "analytic" or (backend == "auto" and analytic_ok)
    # the eig kernel's domain (real float32/float64, 1 <= n <= 32), and whether
    # this call launches it (a CUDA tensor under "auto" or "cuda")
    domain, kernel = (False, False) if backend == "analytic" else _use_kernel(
        backend, not is_complex, n, a, "eig_sym", f"real symmetric input with n <= {MAX_N}",
        f"{'complex' if is_complex else 'real'} input, n={n}")
    use_kernel_tier = domain and not use_analytic
    if polish is None:
        polish = compute_u and n >= 2 and not use_analytic and single

    def out(w, u=None):
        if u is not None and polish and n >= 2:
            w, u = _polish_wu(sym_from_triangle(a, upper), w, u)
        w = downcast(w, half)
        return w if u is None else (w, downcast(u, half))

    if use_analytic:
        sym = sym_from_triangle(a, upper)
        if compute_u:
            if n == 1:
                return out(_AnalyticW.apply(sym), torch.ones_like(sym))
            return out(*_AnalyticWU.apply(sym))
        return out(_AnalyticW.apply(sym))

    if use_kernel_tier:
        # the eig kernel on a CUDA tensor (backend "auto"/"cuda"), its plain
        # version otherwise; both read a's triangle in place
        batch = a.shape[:-2]
        a3 = a.reshape(-1, n, n)
        res = K.EigFunction.apply(a3, upper, compute_u, K.sweeps_for(n), kernel)
        if compute_u:
            w, u = res
            return out(w.reshape(*batch, n), u.reshape(*batch, n, n))
        return out(res.reshape(*batch, n))

    max_sweeps = int(min(max_iter, _JACOBI_SWEEPS_MAX))
    w, u = _JacobiFunction.apply(sym_from_triangle(a, upper), max_sweeps,
                                 float(tol) if tol else 0.0)
    return out(w, u) if compute_u else out(w)
