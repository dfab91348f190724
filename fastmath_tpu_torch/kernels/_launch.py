"""What the kernel modules share: the kernels' domain, the checks of a
launch, its output, the ``ctypes`` call with its launch count, the
channel-first operands of the ``*_cf`` wrappers, the pivoted LU of the
plain versions (``csrc/sym_common.cuh``'s ``plu_factor``,
``plu_substitute``, ``plu_sign``, ``rolled_factor`` and
``rolled_backsub`` in PyTorch) and their two Cholesky forms.

Operands of a launch are 2-D ``(B, K)`` views, either batch-major
contiguous (the public ops) or transposes of channel-first contiguous
``(K, B)`` tensors (the ``*_cf`` wrappers); the kernels take a batch and
a channel stride per operand, so neither layout is transposed.
"""
from __future__ import annotations

import torch

from ..layouts.sym import compact_size

__all__ = ["MAX_N", "KERNEL_DTYPES", "in_domain", "require_domain", "check", "operand",
           "empty", "launch", "cf_flat", "cf_prepare", "plu_factor", "plu_substitute",
           "plu_sign", "rolled_factor", "rolled_solve", "diag_product", "diag_log_sum",
           "chol_rows", "chol_rolled"]

#: largest N (for the congruence product, max(K, D)) the kernels serve
MAX_N = 32
_CODES = {torch.float32: 0, torch.float64: 1}
#: dtypes the kernels take
KERNEL_DTYPES = tuple(_CODES)


def in_domain(n: int, dtype: torch.dtype) -> bool:
    """Whether the kernels take size ``n`` (1 <= n <= MAX_N) in ``dtype``."""
    return 1 <= n <= MAX_N and dtype in _CODES


def require_domain(op: str, n: int, dtype: torch.dtype, what: str = "N"):
    """Raise the ``ValueError`` of wrapper ``op`` called outside the
    kernels' domain (``what`` names the size ``n``)."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"{op} implements 1 <= {what} <= {MAX_N}, got {n}")
    if dtype not in _CODES:
        raise ValueError(f"{op} takes real floats, got {dtype}")


def _check_operand(t, name, b, width, like):
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, mat on {like.device}")
    if t.dtype != like.dtype:
        raise ValueError(f"{name} is {t.dtype}, mat is {like.dtype}")
    if tuple(t.shape) != (b, width):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(b, width)}")
    if not (t.is_contiguous() or t.t().is_contiguous()):
        raise ValueError(
            f"{name} must be batch-major (B, {width}) contiguous or the "
            f"transpose of a contiguous ({width}, B) tensor")


def check(first, n, *operands):
    """Device, dtype and size checks of a launch; each operand is (name,
    tensor, width) and must be (B, width) in a layout the kernels read, B
    the first operand's batch. Returns B."""
    if not first.is_cuda:
        raise ValueError(f"the CUDA kernel needs CUDA tensors (got {first.device})")
    if first.dtype not in _CODES:
        raise ValueError(f"the CUDA kernel takes float32/float64, got {first.dtype}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"the CUDA kernel serves 1 <= N <= {MAX_N}, got {n}")
    b = first.shape[0]
    for name, t, width in operands:
        if t is not None:
            _check_operand(t, name, b, width, first)
    return b


def operand(t):
    """A launch's (pointer, batch stride, channel stride) of ``t``."""
    if t is None:
        return [None, 0, 0]
    return [t.data_ptr(), *t.stride()]


def empty(like, b, width, cf_out):
    """A (B, width) output; a transposed view of (width, B) if ``cf_out``."""
    if cf_out:
        return torch.empty(width, b, dtype=like.dtype, device=like.device).t()
    return torch.empty(b, width, dtype=like.dtype, device=like.device)


#: the tripwire of ``core.checks.debug_nans`` while one is on: it checks
#: what each launch wrote, which no torch function sees
_watch = None


def launch(lib, wrapper, name, like, *args):
    """Call entry point ``name`` of ``lib`` with the dtype code first and
    the current stream last, raise on a launch error, and count the
    launch on ``wrapper``."""
    with torch.cuda.device(like.device):
        err = getattr(lib, name)(_CODES[like.dtype], *args,
                                 torch.cuda.current_stream().cuda_stream)
    if err:
        msg = lib.fm_error_string(err).decode()
        raise RuntimeError(f"{name} failed to launch: CUDA error {err} ({msg})")
    wrapper.launches += 1
    if _watch is not None:
        _watch.launched(name, args)


def cf_flat(t, rows, batch):
    """``t`` broadcast to ``(rows, B)``: a view where it is ``(rows, B)``
    or ``(B, rows)`` contiguous already (the layouts the kernels read),
    else a contiguous copy (a strided slice, a broadcast batch dim)."""
    f = t.expand(rows, *batch).reshape(rows, -1)
    return f if f.is_contiguous() or f.t().is_contiguous() else f.contiguous()


def cf_prepare(mat, vec, *extra, op):
    """Checks of a channel-first ``mat (NN, ...)``, ``vec (N, ...)`` call
    and its operands, ``mat`` and ``vec`` first, as (B, rows) views."""
    n = vec.shape[0]
    if mat.shape[0] != compact_size(n):
        raise ValueError(
            f"channel-first {op} expects mat ({compact_size(n)}, ...) for "
            f"vec ({n}, ...); got {mat.shape[0]}")
    require_domain(op, n, mat.dtype)
    batch = torch.broadcast_shapes(*(t.shape[1:] for t in (mat, vec, *extra)))
    flat = [cf_flat(mat, mat.shape[0], batch).t(), cf_flat(vec, n, batch).t()]
    flat += [cf_flat(t, n, batch).t() for t in extra]
    return n, batch, flat


# ---------------------------------------------------------------------------
# pivoted LU of the plain versions
# ---------------------------------------------------------------------------


def _swap_rows(A, k, p, c0):
    """Swap rows k and p[b] of every A[b] in columns c0..; (B, n[, w])."""
    rows = torch.arange(A.shape[0], device=A.device)
    rk = A[:, k, c0:].clone()
    A[:, k, c0:] = A[rows, p, c0:]
    A[rows, p, c0:] = rk


def _pivot(A, k):
    """First-max partial pivot of column k: lowest row >= k of the
    largest |A[:, i, k]|."""
    return k + torch.argmax(A[:, k:, k].abs(), dim=1)


def plu_factor(A):
    """Unrolled-tier LU with partial pivoting, in place on a copy: U on
    and above the diagonal, multipliers (by the reciprocal pivot) below
    it, kept in the row they were computed for; returns (LU, piv, 1/U_ii)."""
    A = A.clone()
    n = A.shape[1]
    piv = torch.empty(A.shape[0], n, dtype=torch.long, device=A.device)
    for k in range(n):
        p = _pivot(A, k)
        piv[:, k] = p
        _swap_rows(A, k, p, k)
        inv_p = 1.0 / A[:, k, k]
        l = A[:, k + 1:, k] * inv_p[:, None]
        A[:, k + 1:, k] = l
        A[:, k + 1:, k + 1:] -= l[:, :, None] * A[:, k, None, k + 1:]
    inv_d = 1.0 / A.diagonal(dim1=1, dim2=2)
    return A, piv, inv_d


def plu_substitute(LU, piv, inv_d, rhs):
    """Solve with plu_factor's output, replaying its swaps and
    eliminations on ``rhs``: (B, n), or (B, n, c) for c columns at once."""
    n = LU.shape[1]
    vector = rhs.dim() == 2
    r = (rhs[:, :, None] if vector else rhs).clone()
    rows = torch.arange(r.shape[0], device=r.device)
    for k in range(n - 1):
        p = piv[:, k]
        rk = r[:, k].clone()
        r[:, k] = r[rows, p]
        r[rows, p] = rk
        r[:, k + 1:] -= LU[:, k + 1:, k, None] * r[:, k, None]
    x = torch.empty_like(r)
    for i in range(n - 1, -1, -1):
        acc = r[:, i]
        for j in range(i + 1, n):
            acc = acc - LU[:, i, j, None] * x[:, j]
        x[:, i] = acc * inv_d[:, i, None]
    return x[:, :, 0] if vector else x


def plu_sign(piv):
    """Sign of the row permutation of :func:`plu_factor`'s pivots (B, n):
    +1 or -1 per problem."""
    moved = piv != torch.arange(piv.shape[1], device=piv.device)
    return 1 - 2 * (moved.sum(dim=1) % 2)


def _rolled_eliminate(W, n):
    """The rolled tier's elimination of the local array ``W`` (B, n, w),
    in place: swaps of columns k.. and multipliers by division, as the
    rolled kernel; returns the sign of the row permutation."""
    sign = torch.ones(W.shape[0], dtype=torch.long, device=W.device)
    for k in range(n):
        p = _pivot(W, k)
        sign = torch.where(p == k, sign, -sign)
        _swap_rows(W, k, p, k)
        l = W[:, k + 1:, k] / W[:, k, k, None]
        W[:, k + 1:, k + 1:] -= l[:, :, None] * W[:, k, None, k + 1:]
    return sign


def rolled_factor(A):
    """Rolled-tier LU with partial pivoting of ``A`` alone (no
    right-hand side): ``(U, sign)``, U on and above the diagonal."""
    U = A.clone()
    return U, _rolled_eliminate(U, A.shape[1])


def diag_product(U, sign):
    """``sign * U_00 * U_11 * ...`` of (..., n, n) factors, multiplied in
    order, as the kernels form a determinant."""
    det = U[..., 0, 0]
    for i in range(1, U.shape[-1]):
        det = det * U[..., i, i]
    return torch.where(sign < 0, -det, det)


def diag_log_sum(U):
    """``log|U_00| + log|U_11| + ...`` of (..., n, n) factors, summed in
    order: log|det| without forming the determinant, which can overflow."""
    acc = torch.log(torch.abs(U[..., 0, 0]))
    for i in range(1, U.shape[-1]):
        acc = acc + torch.log(torch.abs(U[..., i, i]))
    return acc


def rolled_solve(A, R):
    """Rolled-tier LU with partial pivoting of ``[A | R]`` (multipliers
    by division, as the rolled kernel) and back-substitution; returns
    the solutions (B, n, c) of the c right-hand-side columns."""
    n = A.shape[1]
    W = torch.cat([A, R], dim=2)
    _rolled_eliminate(W, n)
    X = W[:, :, n:].clone()
    for i in range(n - 1, -1, -1):
        s = torch.zeros_like(X[:, i])
        for j in range(i + 1, n):
            s = s + W[:, i, j, None] * X[:, j]
        X[:, i] = (X[:, i] - s) / W[:, i, i, None]
    return X


# ---------------------------------------------------------------------------
# Cholesky of the plain versions (no pivoting: input that is not SPD
# gives NaN, as in the reference)
# ---------------------------------------------------------------------------


def chol_rows(E, n):
    """Unrolled Cholesky-Banachiewicz on an entry grid ``E`` (lists of
    batch tensors), the reference's ``_chol_rows``: ``L_jj = sqrt(s)``,
    then ``L_ij = s * (1 / L_jj)``, each ``s`` summed from the first
    term. Returns the lower grid (``L[i][j]`` for j <= i, None above)."""
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = E[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(s)
        inv_ljj = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = E[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_ljj
    return L


def chol_rolled(A):
    """The rolled tier's right-looking outer-product Cholesky of full
    symmetric ``A`` (B, n, n), the reference's ``_chol_rolled``: step k
    scales column k (rows >= k) by ``rsqrt(W_kk)`` and subtracts the
    rank-1 update from the trailing block. Returns L (B, n, n), zeros
    above the diagonal."""
    n = A.shape[1]
    W = A.clone()
    L = torch.zeros_like(A)
    for k in range(n):
        lk = W[:, k:, k] * torch.rsqrt(W[:, k, k, None])
        L[:, k:, k] = lk
        below = lk[:, 1:]
        W[:, k + 1:, k + 1:] -= below[:, :, None] * below[:, None, :]
    return L
