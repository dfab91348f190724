"""CUDA batched matrix logarithm (inverse scaling and squaring with
Denman-Beavers square roots and a Gregory series), with its plain
PyTorch version.

Two kernels of ``csrc/logm.cu`` replace the Pallas ``_logm_kernel``
(d <= 8), ``_logm_rolled_kernel`` (9 <= d <= 24) and ``_logm_flat_kernel``
(25 <= d <= 32) of ``fastmath_tpu/kernels/logm_pallas.py``, whose three
tiers differ only in how their loops nest: ``logm_unrolled`` runs one
thread a problem with the matrices in registers up to :data:`UNROLL_MAX`
(by dtype), ``logm_warp`` a group of 8, 16 or 32 lanes a problem with the
matrices in shared memory above, both the nested algebra; the source's
header gives the design and what bounds it. Each problem runs its own iterations and stops
on its own tests. A problem whose square-root chain never reaches the
series region (eigenvalues on the negative real axis) comes back NaN.

Entry points: :func:`logm_cf`, the counterpart's channel-first contract
(``(d*d, ...)`` in and out, real d <= 32, forward only, as the
counterpart's), :func:`launch_logm` (batch-major ``(B, d, d)`` read
through its strides) and :func:`logm_plain`. ``logm_unrolled.launches``
and ``logm_warp.launches`` count the launches of each kernel, and nothing
else.

:func:`iss_log` is the algebra in PyTorch, per-problem exits and all,
for real and complex batches; the plain version runs it with the kernels'
inverses and tolerance, and ``ops.lie._iss_log_core`` with its own.
"""
from __future__ import annotations

import ctypes
import math
import types

import torch

from ..core.dtypes import downcast, upcast_half
from ._launch import MAX_N, _pivot, _swap_rows, cf_flat, empty, launch, require_domain

__all__ = ["logm_cf", "logm_plain", "launch_logm", "iss_log", "sqrt_db", "gj_inverse",
           "logm_unrolled", "logm_warp", "tier", "iteration_counts", "UNROLL_MAX",
           "ISS_MAX", "DB_ITERS"]

_LIB = "logm"
#: d up to this runs the one-thread tier (``logm_unroll_max`` of
#: ``csrc/logm.cu``), by dtype; above, the warp tier
UNROLL_MAX = {torch.float32: 4, torch.float64: 4}
#: inverse-scaling steps, and Denman-Beavers iterations per square root
ISS_MAX = 12
DB_ITERS = 36
#: |A - I|_F below which the Gregory series runs
THRESH = 0.25

#: launch counts of the two kernels of ``csrc/logm.cu``
logm_unrolled = types.SimpleNamespace(launches=0)
logm_warp = types.SimpleNamespace(launches=0)


def tier(d: int, dtype) -> str:
    """Name of the kernel that serves size d in ``dtype``."""
    return "logm_unrolled" if d <= UNROLL_MAX[dtype] else "logm_warp"


def _real_dtype(x):
    return x.real.dtype if x.is_complex() else x.dtype


# ---------------------------------------------------------------------------
# the algebra (the kernels' arithmetic in PyTorch)
# ---------------------------------------------------------------------------


def gj_inverse(M: torch.Tensor) -> torch.Tensor:
    """Inverse of (B, d, d) by the warp tier's Gauss-Jordan elimination:
    first-max partial pivoting with exact row swaps, the pivot row divided
    by the pivot, its multiple subtracted from every other row."""
    W = M.clone()
    d = W.shape[-1]
    R = torch.eye(d, dtype=M.dtype, device=M.device).expand_as(W).clone()
    for k in range(d):
        p = _pivot(W, k)
        _swap_rows(W, k, p, k)
        _swap_rows(R, k, p, 0)
        piv = W[:, k, k, None]
        wk = W[:, k, k + 1:] / piv
        rk = R[:, k, :] / piv
        f = W[:, :, k].clone()
        f[:, k] = 0
        W[:, :, k + 1:] -= f[:, :, None] * wk[:, None, :]
        R -= f[:, :, None] * rk[:, None, :]
        W[:, k, k + 1:] = wk
        R[:, k, :] = rk
    return R


def _inv_closed(M: torch.Tensor) -> torch.Tensor:
    """Inverse of (B, d, d), d <= 4, as the one-thread tier forms it:
    cofactors times 1/det (``batched_adjugate.cuh``'s ``full_inverse``)."""
    d = M.shape[-1]
    if d == 1:
        return 1.0 / M
    from .batched_cuda import inv_plain

    return inv_plain(M.reshape(-1, d * d)).reshape(M.shape)


def _dist2(M, ordered):
    """|M - I|_F^2 of each problem (B, d, d); ``ordered`` sums the squares
    row by row from the first term, as the one-thread tier does."""
    d = M.shape[-1]
    eye = torch.eye(d, dtype=M.dtype, device=M.device)
    q = (M - eye).abs() ** 2 if M.is_complex() else (M - eye) ** 2
    if not ordered:
        return q.sum(dim=(-2, -1))
    acc = q[:, 0, 0]
    for e in range(1, d * d):
        acc = acc + q[:, e // d, e % d]
    return acc


def sqrt_db(A, tol, inv, det=None, ordered=False, counts=None):
    """Principal square root of (B, d, d) by the product-form
    Denman-Beavers iteration, real or complex: M = Y = A, then while
    |M - I|_F > tol (and finite), at most :data:`DB_ITERS` times, and once
    more where that test passed, T = mu M + I, Y = Y M^-1 T / (2 sqrt(mu)),
    M = M^-1 (T T) / (4 mu). mu = 1 (the kernels: on-cut eigenvalues must
    diverge to NaN), or, given ``det``, |det M|^(-1/d) (determinant
    scaling, only safe off the cut). Each problem stops on its own tests
    (finished problems are frozen); a root counts only where |M - I|_F <= 8
    tol, else it comes back NaN. ``inv`` inverts a (b, d, d) batch;
    ``counts`` (B,), if given, gains each problem's iterations.

    The step past the test stands in for the reference's batch-global
    loop, which steps every problem until the slowest passes: at |M - I|_F
    ~ tol the root still carries about tol / 2 of error, and in float32
    that fails the roundtrip ``expm(0.999 logm(e))`` on some 4x4 problems
    (``csrc/logm.cu``'s header)."""
    d = A.shape[-1]
    eye = torch.eye(d, dtype=A.dtype, device=A.device)
    M, Y = A.clone(), A.clone()
    polished = torch.zeros(A.shape[0], dtype=torch.bool, device=A.device)
    for j in range(DB_ITERS + 1):
        e2 = _dist2(M, ordered)
        passed = e2 <= tol * tol
        step = torch.isfinite(e2) & ((passed & ~polished) | (~passed & (j < DB_ITERS)))
        polished |= passed & step
        idx = step.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        m, y = M[idx], Y[idx]
        minv = inv(m)
        if det is None:
            t = m + eye
            y = 0.5 * torch.matmul(torch.matmul(y, minv), t)
            m = 0.25 * torch.matmul(minv, torch.matmul(t, t))
        else:
            dm = det(m).abs()
            safe = torch.isfinite(dm) & (dm > 0)
            mu = torch.where(safe, torch.where(safe, dm, 1.0) ** (-1.0 / d), 1.0)[:, None, None]
            t = mu * m + eye
            y = (0.5 / torch.sqrt(mu)) * torch.matmul(torch.matmul(y, minv), t)
            m = (0.25 / mu) * torch.matmul(minv, torch.matmul(t, t))
        M[idx], Y[idx] = m, y
        if counts is not None:
            counts[idx] += 1
    e2 = _dist2(M, ordered)
    conv = torch.isfinite(e2) & (e2 <= (8 * tol) ** 2)
    return torch.where(conv[:, None, None], Y, torch.full_like(Y, math.nan))


def iss_log(A, db_tol, inv, det=None, ordered=False, counts=None):
    """Inverse scaling and squaring of (B, d, d), real or complex:
    ``(L, k, ok)`` with log A = L 2^k where ``ok``.

    D = A - I; while |A - I|_F > 0.25 (and finite), at most 12 times, each
    problem on its own: A_s = sqrt_db(A), D = D (A_s + I)^-1 (the
    cancellation-free A - I of Al-Mohy & Higham), A = A_s, k = k + 1. Then
    Z = D (A + I)^-1 and L = 2 Z (I/1 + Z^2/3 + ... + Z^(o-1)/o) by Horner
    in Z^2 (o = 21 in double precision, 9 otherwise). ``ok``: the chain
    reached |A - I|_F <= 0.25 (never where an eigenvalue sits on the
    negative real axis). ``db_tol``, ``inv``, ``det`` and ``ordered`` go to
    :func:`sqrt_db`; ``counts``, if a dict, gets each problem's square
    roots (``"iss"``) and Denman-Beavers iterations (``"db"``)."""
    d = A.shape[-1]
    eye = torch.eye(d, dtype=A.dtype, device=A.device)
    rdt = _real_dtype(A)
    A = A.clone()
    D = A - eye
    k = torch.zeros(A.shape[0], dtype=rdt, device=A.device)
    db = torch.zeros(A.shape[0], dtype=torch.int32, device=A.device)
    for _ in range(ISS_MAX):
        d2 = _dist2(A, ordered)
        idx = (torch.isfinite(d2) & (d2 > THRESH * THRESH)).nonzero()[:, 0]
        if idx.numel() == 0:
            break
        sub = torch.zeros(idx.numel(), dtype=torch.int32, device=A.device)
        As = sqrt_db(A[idx], db_tol, inv, det=det, ordered=ordered, counts=sub)
        D[idx] = torch.matmul(D[idx], inv(As + eye))
        A[idx] = As
        k[idx] += 1
        db[idx] += sub
    d2 = _dist2(A, ordered)
    ok = torch.isfinite(d2) & (d2 <= THRESH * THRESH)
    Z = torch.matmul(D, inv(A + eye))
    Z2 = torch.matmul(Z, Z)
    order = 21 if torch.finfo(rdt).eps < 1e-10 else 9
    acc = (eye * (1.0 / order)).expand_as(Z)
    for m in range(order - 2, 0, -2):
        acc = eye * (1.0 / m) + torch.matmul(Z2, acc)
    if counts is not None:
        counts["iss"], counts["db"] = k, db
    return 2.0 * torch.matmul(Z, acc), k, ok


def logm_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernels: ``logm`` of real (B, d, d), NaN where
    the square-root chain never reached the series region. The tier's
    inverses (cofactors to the unrolled bound, Gauss-Jordan above) and
    tolerance db_tol = 8 eps d."""
    L, k, ok = _run(a)
    scale = torch.where(ok, torch.exp2(k), torch.full_like(k, math.nan))
    return L * scale[:, None, None]


def _run(a, counts=None):
    d = a.shape[-1]
    unrolled = tier(d, a.dtype) == "logm_unrolled"
    return iss_log(a, torch.finfo(a.dtype).eps * 8 * d, _inv_closed if unrolled else gj_inverse,
                   ordered=unrolled, counts=counts)


def iteration_counts(a: torch.Tensor):
    """(square roots, Denman-Beavers iterations) each problem of real
    ``a`` (B, d, d) runs in the kernels (the plain version's count): the
    operation count of a run, for its bound."""
    counts = {}
    _run(a, counts)
    return counts["iss"], counts["db"]


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------

_lib = None


def _library():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load(_LIB)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fm_logm.argtypes = [i, i, ll, p, ll, ll, ll, p, ll, ll, p]
        lib.fm_logm.restype = i
        lib.fm_error_string.argtypes = [i]
        lib.fm_error_string.restype = ctypes.c_char_p
        lib.fm_logm_unroll_max.argtypes = [i]
        lib.fm_logm_unroll_max.restype = i
        for code, dtype in enumerate((torch.float32, torch.float64)):
            if lib.fm_logm_unroll_max(code) != UNROLL_MAX[dtype]:
                raise RuntimeError(f"csrc/logm.cu serves d <= {lib.fm_logm_unroll_max(code)} in its "
                                   f"one-thread tier for {dtype}; UNROLL_MAX says "
                                   f"{UNROLL_MAX[dtype]}")
        _lib = lib
    return _lib


def launch_logm(a: torch.Tensor, cf_out: bool = False) -> torch.Tensor:
    """Launch on a CUDA tensor ``a`` (B, d, d) of any strides: ``logm`` of
    each problem (NaN on the cut), (B, d, d) contiguous, or a view of a
    channel-first (d*d, B) tensor if ``cf_out``."""
    if not a.is_cuda:
        raise ValueError(f"the CUDA kernel needs CUDA tensors (got {a.device})")
    b, d = a.shape[0], a.shape[-1]
    require_domain("the logm kernel", d, a.dtype, "d")
    out = empty(a, b, d * d, cf_out)
    if b == 0:  # nothing to launch
        return out.reshape(b, d, d)
    counter = logm_unrolled if tier(d, a.dtype) == "logm_unrolled" else logm_warp
    launch(_library(), counter, "fm_logm", a, d, b, a.data_ptr(), *a.stride(),
           out.data_ptr(), *out.stride())
    return out.reshape(b, d, d)


def logm_cf(mat: torch.Tensor) -> torch.Tensor:
    """Channel-first batched matrix logarithm ``(d*d, ...) -> (d*d,
    ...)``: row-major channels, real d <= 32, batch dims as given. Real
    input whose principal log is complex gives NaN (``ops.lie.logm``
    reroutes those). Launches the CUDA kernel on CUDA tensors (read in
    place, written channel-first) and runs the plain version on CPU
    tensors. Forward only, as the counterpart: for gradients use
    :func:`fastmath_tpu_torch.ops.lie.logm`. bf16/f16 compute in float32
    and round once on output."""
    (mat, half) = upcast_half(mat)
    d = math.isqrt(mat.shape[0])
    if d * d != mat.shape[0] or d > MAX_N:
        raise ValueError(f"logm_cf expects (d*d, ...) rows with d <= {MAX_N}; "
                         f"got {mat.shape[0]} channels")
    require_domain("logm_cf", d, mat.dtype, "d")
    batch = mat.shape[1:]
    x = cf_flat(mat, d * d, batch).t().reshape(-1, d, d)
    with torch.no_grad():
        if x.is_cuda:
            y = launch_logm(x, cf_out=True).reshape(-1, d * d).t()
        else:
            y = logm_plain(x).reshape(-1, d * d).t()
    return downcast(y.reshape(d * d, *batch), half)
