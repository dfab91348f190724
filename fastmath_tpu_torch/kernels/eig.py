"""CUDA symmetric eigendecomposition by Jacobi rotations, with its plain
PyTorch versions and autograd.

Two kernels of ``csrc/eig.cu`` replace the Pallas ``_eig_kernel`` (n <= 8,
cyclic Jacobi in registers) and ``_eig_rolled_kernel`` (9 <= n <= 32,
round-robin Jacobi) of ``fastmath_tpu/kernels/eig_pallas.py``: the first
runs one thread per problem, the second a group of 16 lanes a problem to
n = 16 and 32 above, the matrix in the circle method's seat order so that
each round's pairs are constant; the source's header gives the design and
what bounds it. Each problem stops sweeping on its own Frobenius-relative
test (off^2 <= 16 eps^2 |A|_F^2) or after ``sweeps`` sweeps; the TPU
kernels test a whole block of problems at once (``ROADMAP.md``, faults of
the reference).

Entry points:

* :func:`eig_sym_cf`, the counterpart's channel-first compact contract:
  ``(NN, ...)`` in, eigenvalues ``(n, ...)`` out (unsorted), plus
  eigenvectors ``(n*n, ...)`` with ``u[i*n + j]`` component i of
  eigenvector j;
* :class:`EigFunction`, what ``ops.qr.eig_sym`` calls: batch-major full
  matrices ``(B, n, n)`` read from one triangle through their strides (no
  symmetrized or packed copy), ``w (B, n)`` and ``u (B, n, n)`` out, with
  the Giles backward.

Each launches a kernel on a CUDA tensor and runs the plain version, which
repeats the kernel's arithmetic in PyTorch (same rotations, same order,
converged problems frozen by a per-problem mask, so both run the same
sweeps; the unrolled kernel takes each rotation's reciprocals and square
roots from special-function instructions, a few ulp from the plain
version's divisions and square roots), on a CPU tensor. ``eig_unrolled.launches`` and
``eig_rolled.launches`` count the launches of each kernel, and nothing
else.
"""
from __future__ import annotations

import ctypes
import types

import torch

from ..core.dtypes import downcast, upcast_half
from ..layouts.sym import sym_dim, sym_from_triangle, sym_to_full, triangle_mask
from ._launch import cf_flat, empty, launch, require_domain

__all__ = ["eig_sym_cf", "eig_plain", "eig_unrolled_plain", "eig_rolled_plain",
           "sweep_counts", "round_robin", "sweeps_for",
           "launch_eig_full", "launch_eig_compact", "EigFunction", "eig_unrolled",
           "eig_rolled", "UNROLL_MAX"]

_LIB = "eig"
#: n up to this runs the unrolled (cyclic, one thread a problem) tier
UNROLL_MAX = 8
_DEFAULT_SWEEPS = 8

#: launch counts of the two kernels of ``csrc/eig.cu``
eig_unrolled = types.SimpleNamespace(launches=0)
eig_rolled = types.SimpleNamespace(launches=0)


def sweeps_for(n: int) -> int:
    """The sweep cap ``eig_sym`` gives the kernels (``qr.py:1165``): 8 for
    n <= 4, 10 for n <= 8, 14 above. Both tiers exit earlier on their
    convergence test."""
    return 8 if n <= 4 else (10 if n <= UNROLL_MAX else 14)


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic in PyTorch)
# ---------------------------------------------------------------------------


def _sq(x):
    """|x|^2 entrywise, real or complex."""
    return x.real * x.real + x.imag * x.imag if x.is_complex() else x * x


def _rotation(app, aqq, apq):
    """(c, s) of the stable rotation of each pair (Golub & Van Loan 8.4.1),
    ``J = [[c, -conj(s)], [s, c]]`` with ``s = t c conj(a_pq / |a_pq|)``:
    for real input the sign of a_pq folded into s. c = 1, s = 0 where a_pq
    = 0; ``app``, ``aqq`` real."""
    r = apq.abs()
    one = torch.ones_like(r)
    active = r > 0
    rsafe = torch.where(active, r, one)
    tau = (aqq - app) / (2.0 * rsafe)
    sgn = torch.where(tau >= 0, one, -one)
    t = torch.where(active, -sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau)),
                    torch.zeros_like(r))
    c = 1.0 / torch.sqrt(1.0 + t * t)
    if not apq.is_complex():
        return c, t * c * torch.where(apq >= 0, one, -one)
    # each part over |a_pq|: a complex division squares a tiny |a_pq| to 0
    phase = torch.complex(apq.real / rsafe, -apq.imag / rsafe)
    return c.to(apq.dtype), (t * c) * phase


def _tol(A):
    """16 eps^2 |A|_F^2 of each problem (B, n, n)."""
    eps = torch.finfo(A.real.dtype).eps
    return _sq(A).sum(dim=(1, 2)) * (16.0 * eps * eps)


def _off2(A):
    """Off-diagonal squares of each problem, summed without the diagonal
    (a difference of two sums would leave rounding far above the test)."""
    off = ~torch.eye(A.shape[1], dtype=torch.bool, device=A.device)
    return (_sq(A) * off).sum(dim=(1, 2))


def _squares_in_order(A, diag):
    """Squares of (B, n, n) summed row by row from the first term, as the
    unrolled kernel sums them: all, or the off-diagonal ones."""
    n = A.shape[1]
    acc = torch.zeros_like(A[:, 0, 0].real)
    for i in range(n):
        for j in range(n):
            if i != j or diag:
                acc = acc + _sq(A[:, i, j])
    return acc


def _cyclic_sweep(A, V):
    """One cyclic sweep of the unrolled kernel (``_jacobi_sweep_registers``)
    on the full grid, in place: rows p, q by J^H, then columns p, q by J,
    then a_pq = 0, then V's columns by J."""
    n = A.shape[1]
    for p in range(n - 1):
        for q in range(p + 1, n):
            c, s = _rotation(A[:, p, p].real, A[:, q, q].real, A[:, p, q])
            c1, s1, sc = c[:, None], s[:, None], s.conj()[:, None]
            rp, rq = A[:, p, :].clone(), A[:, q, :].clone()
            A[:, p, :] = c1 * rp + sc * rq
            A[:, q, :] = c1 * rq - s1 * rp
            cp, cq = A[:, :, p].clone(), A[:, :, q].clone()
            A[:, :, p] = c1 * cp + s1 * cq
            A[:, :, q] = c1 * cq - sc * cp
            A[:, p, q] = 0
            A[:, q, p] = 0
            if V is not None:
                vp, vq = V[:, :, p].clone(), V[:, :, q].clone()
                V[:, :, p] = c1 * vp + s1 * vq
                V[:, :, q] = c1 * vq - sc * vp


def round_robin(n: int):
    """The rolled kernel's schedule (``eig_pallas._round_robin``): n - 1
    rounds (n for odd n) of disjoint (p, q) pairs, p < q, every pair once a
    sweep. Seat 0 keeps player 0; the others rotate by one seat a round."""
    m = n if n % 2 == 0 else n + 1
    players = list(range(m))
    rounds = []
    for _ in range(m - 1):
        pairs = []
        for i in range(m // 2):
            a, b = players[i], players[m - 1 - i]
            if a < n and b < n:
                pairs.append((min(a, b), max(a, b)))
        rounds.append(pairs)
        players = [players[0]] + [players[-1]] + players[1:-1]
    return rounds


def _schedule(n, device):
    """Per round of :func:`round_robin`: the pairs' p and q as index
    tensors, and each row's partner (itself where it sits out)."""
    out = []
    for pairs in round_robin(n):
        perm = list(range(n))
        for x, y in pairs:
            perm[x], perm[y] = y, x
        out.append((torch.tensor([x for x, _ in pairs], device=device),
                    torch.tensor([y for _, y in pairs], device=device), perm))
    return out


def _round_robin_sweep(A, V, schedule):
    """One sweep of the rolled kernel (``_apply_round`` per round): each
    round's rotations from the matrix as the round found it, rows then
    columns then V's columns, ``X <- C X + S X[perm]`` (rows by conj(S)).
    Returns (A, V)."""
    for p, q, perm in schedule:
        c, s = _rotation(A[:, p, p].real, A[:, q, q].real, A[:, p, q])
        C = torch.ones_like(A[:, 0])
        S = torch.zeros_like(A[:, 0])
        C[:, p], C[:, q], S[:, p], S[:, q] = c, c, s, -s.conj()
        A = C[:, :, None] * A + S.conj()[:, :, None] * A[:, perm, :]
        A = C[:, None, :] * A + S[:, None, :] * A[:, :, perm]
        if V is not None:
            V = C[:, None, :] * V + S[:, None, :] * V[:, :, perm]
    return A, V


def _jacobi(E, compute_u, sweeps, rolled, floor=0.0):
    """(w, V or None, sweeps each problem ran) of the cyclic or rolled tier;
    ``floor``: an absolute floor under each problem's test."""
    A = E.clone()
    V = (torch.eye(A.shape[1], dtype=A.dtype, device=A.device).expand_as(A).clone()
         if compute_u else None)
    schedule = _schedule(A.shape[1], A.device) if rolled else None
    tol = _tol(A) if rolled else _squares_in_order(A, True) * (
        16.0 * torch.finfo(A.real.dtype).eps ** 2)
    if floor:
        tol = tol.clamp(min=floor)
    ran = torch.zeros(A.shape[0], dtype=torch.int32, device=A.device)
    for _ in range(sweeps):
        off = _off2(A) if rolled else _squares_in_order(A, False)
        # a problem stops at its own test; converged problems are frozen
        idx = (off > tol).nonzero()[:, 0]
        if idx.numel() == 0:
            break
        a = A[idx]
        v = V[idx] if compute_u else None
        if rolled:
            a, v = _round_robin_sweep(a, v, schedule)
        else:
            _cyclic_sweep(a, v)
        A[idx] = a
        if compute_u:
            V[idx] = v
        ran[idx] += 1
    return A.diagonal(dim1=1, dim2=2).real.clone(), V, ran


def eig_unrolled_plain(E, compute_u, sweeps):
    """Plain version of the unrolled kernel: symmetric ``E`` (B, n, n) ->
    ``(w (B, n), u (B, n, n) or None)``, cyclic sweeps."""
    return _jacobi(E, compute_u, sweeps, rolled=False)[:2]


def eig_rolled_plain(E, compute_u, sweeps):
    """Plain version of the rolled kernel: round-robin sweeps."""
    return _jacobi(E, compute_u, sweeps, rolled=True)[:2]


def eig_plain(E, compute_u, sweeps, floor=0.0):
    """The plain version of the tier the kernels give size n: cyclic to n =
    8, round-robin above. It takes any n and complex Hermitian ``E`` too
    (``eig_sym``'s route outside the kernels' domain); ``floor`` is an
    absolute floor under each problem's convergence test."""
    return _jacobi(E, compute_u, sweeps, E.shape[1] > UNROLL_MAX, floor)[:2]


def sweep_counts(E, sweeps):
    """The sweeps each problem of symmetric ``E`` (B, n, n) runs in the
    tier of size n before its test stops it (at most ``sweeps``): the
    operation count of a run, for its bound."""
    return _jacobi(E, False, sweeps, rolled=E.shape[1] > UNROLL_MAX)[2]


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

_lib = None


def _library():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load(_LIB)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fm_eig_sym.argtypes = [i, i, i, i, ll, p, ll, ll, ll, i, p, ll, ll, p, ll, ll, p]
        lib.fm_eig_sym.restype = i
        lib.fm_error_string.argtypes = [i]
        lib.fm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(a, n, sweeps):
    if not a.is_cuda:
        raise ValueError(f"the CUDA kernel needs CUDA tensors (got {a.device})")
    require_domain("the eig kernel", n, a.dtype)
    if sweeps < 0:
        raise ValueError("sweeps must be >= 0")


def _launch(like, n, compute_u, sweeps, b, a_args, w, u):
    counter = eig_unrolled if n <= UNROLL_MAX else eig_rolled
    u_args = [u.data_ptr(), *u.stride()] if u is not None else [None, 0, 0]
    launch(_library(), counter, "fm_eig_sym", like, n, int(sweeps), int(compute_u), b, *a_args,
           w.data_ptr(), *w.stride(), *u_args)


def launch_eig_full(a, upper, compute_u, sweeps):
    """Launch on a CUDA tensor ``a`` (B, n, n) of any strides, reading the
    ``upper`` (else lower) triangle: ``(w (B, n), u (B, n, n) or None)``."""
    b, n = a.shape[0], a.shape[-1]
    _check(a, n, sweeps)
    sb, rs, cs = a.stride()
    if not upper:  # the lower triangle is the upper one of the transpose
        rs, cs = cs, rs
    w = torch.empty(b, n, dtype=a.dtype, device=a.device)
    u = torch.empty(b, n, n, dtype=a.dtype, device=a.device) if compute_u else None
    if b == 0:  # nothing to launch
        return w, u
    _launch(a, n, compute_u, sweeps, b, [a.data_ptr(), sb, rs, cs, 0], w,
            None if u is None else u.view(b, n * n))
    return w, u


def launch_eig_compact(mat, n, compute_u, sweeps, cf_out=False):
    """Launch on a CUDA (B, NN) compact operand (batch-major, or the
    transpose of a channel-first (NN, B) tensor): ``(w (B, n), u (B, n*n)
    or None)``, transposed views of (n, B) and (n*n, B) if ``cf_out``."""
    b = mat.shape[0]
    _check(mat, n, sweeps)
    w = empty(mat, b, n, cf_out)
    u = empty(mat, b, n * n, cf_out) if compute_u else None
    if b == 0:  # nothing to launch
        return w, u
    sb, sc = mat.stride()
    _launch(mat, n, compute_u, sweeps, b, [mat.data_ptr(), sb, 0, sc, 1], w, u)
    return w, u


# ---------------------------------------------------------------------------
# autograd (the reference's Giles VJP, ``qr.py:656-690``)
# ---------------------------------------------------------------------------


class EigFunction(torch.autograd.Function):
    """Differentiable eigendecomposition of batch-major full matrices read
    from one triangle: ``apply(a (B, n, n), upper, compute_u, sweeps,
    kernel)`` -> ``w`` or ``(w, u)``; the kernel if ``kernel``, else the
    plain version. When a gradient is needed the forward computes the
    eigenvectors too (``_eig_pallas_w_fwd``); the backward is the Giles
    formula, mapped back onto the triangle that was read."""

    @staticmethod
    def forward(ctx, a, upper, compute_u, sweeps, kernel):
        want_u = compute_u or ctx.needs_input_grad[0]
        if kernel:
            w, u = launch_eig_full(a, upper, want_u, sweeps)
        else:
            w, u = eig_plain(sym_from_triangle(a, upper), want_u, sweeps)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(w, u)
        ctx.opts = (upper, compute_u)
        return (w, u) if compute_u else w

    @staticmethod
    def backward(ctx, dw, du=None):
        from ..ops.qr import _giles_da

        w, u = ctx.saved_tensors
        upper, _ = ctx.opts
        if dw is None:
            dw = torch.zeros_like(w)
        dsym = _giles_da(w, u, dw, du)
        # a's triangle t enters as sym = t + t^T - diag(t)
        n = w.shape[-1]
        keep = triangle_mask(n, upper, w.device)
        da = torch.where(keep, dsym + dsym.mT, torch.zeros_like(dsym))
        da = da - torch.diag_embed(dsym.diagonal(dim1=-2, dim2=-1))
        return da, None, None, None, None


# ---------------------------------------------------------------------------
# channel-first wrapper (the counterpart of eig_pallas.eig_sym_cf)
# ---------------------------------------------------------------------------


def eig_sym_cf(mat: torch.Tensor, compute_u: bool = False, sweeps: int = _DEFAULT_SWEEPS):
    """Channel-first batched symmetric eigendecomposition: ``mat (N(N+1)/2,
    ...)`` compact -> eigenvalues ``(N, ...)`` (unsorted), plus eigenvector
    rows ``(N*N, ...)`` when ``compute_u`` (``u[i*n+j]`` = component i of
    eigenvector j); batch dims as given, N <= 32, real floats. Launches
    the CUDA kernel on CUDA tensors and runs the plain version on CPU
    tensors. Not differentiable, as the counterpart's Pallas call; for
    gradients use :func:`fastmath_tpu_torch.ops.qr.eig_sym`."""
    (mat, half) = upcast_half(mat)
    nn = mat.shape[0]
    n = sym_dim(nn)
    require_domain("eig_sym_cf", n, mat.dtype)
    if sweeps < 0:
        raise ValueError("sweeps must be >= 0")
    batch = mat.shape[1:]
    m2 = cf_flat(mat, nn, batch).t()
    if m2.is_cuda:
        w, u = launch_eig_compact(m2, n, compute_u, sweeps, cf_out=True)
        w, u = w.t(), (None if u is None else u.t())
    else:
        with torch.no_grad():
            w, u = eig_plain(sym_to_full(m2, n), compute_u, sweeps)
        w, u = w.t(), (None if u is None else u.reshape(-1, n * n).t())
    w = downcast(w.reshape(n, *batch), half)
    if not compute_u:
        return w
    return w, downcast(u.reshape(n * n, *batch), half)
