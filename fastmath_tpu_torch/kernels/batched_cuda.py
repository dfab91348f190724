"""CUDA full-storage batched solve and inverse, with their plain PyTorch
versions and autograd.

``solve_full_cf`` replaces the Pallas ``_solve_full_kernel`` and
``inv_cf`` replaces ``_inv_kernel``
(``fastmath_tpu/kernels/batched_pallas.py``). Both kernels live in
``csrc/batched.cu``; one thread owns one problem, and the source's
header gives the tiers and what bounds them.

A matrix is full n x n storage, row-major in n*n channels (entry (i, j)
is channel ``i * n + j``); right-hand sides and solutions are n x k,
row-major in n*k channels. Each wrapper launches its kernel on a CUDA
tensor and runs its plain version, which repeats the kernel's
arithmetic in PyTorch, on a CPU tensor. ``solve_full_cf.launches`` and
``inv_cf.launches`` count kernel launches, and nothing else. Operands
are 2-D views, as :mod:`._launch` describes.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..core.dtypes import downcast, upcast_half
from ..ops.sym import _cofactors
from ._launch import (MAX_N, cf_flat, check, empty, launch, operand, plu_factor,
                      plu_substitute, require_domain, rolled_solve)

__all__ = ["solve_full_cf", "inv_cf", "solve_full_plain", "inv_plain",
           "SolveFullFunction", "InvFunction"]

_LIB = "batched"
#: n up to this runs the unrolled tiers in registers; above, the rolled
#: tier over a per-thread local array
_PLU_UNROLL_N = 8
#: row width of the rolled tier's local array (``kRolledWidth`` of
#: ``csrc/sym_common.cuh``): it holds [A | B] with n + k columns
_ROLLED_WIDTH = 2 * MAX_N + 1


def _order(channels: int) -> int:
    """n of a matrix stored in ``channels`` = n*n channels (or 0)."""
    n = math.isqrt(channels)
    return n if n * n == channels else 0


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic in PyTorch)
# ---------------------------------------------------------------------------


def _grid(mat, n, trans):
    """(B, n, n) view of the row-major ``mat`` (B, n*n), or of its
    transpose."""
    A = mat.reshape(-1, n, n)
    return A.transpose(1, 2) if trans else A


def solve_full_plain(mat, rhs, k, trans=False):
    r"""Plain version of the solve kernel: ``mat`` (B, n*n), ``rhs``
    (B, n*k) -> ``A \ B`` (B, n*k), or ``Aᵀ \ B`` if ``trans``. Unrolled
    PLU (multipliers by the reciprocal pivot, back-substitution times
    1/U_ii) for n <= 8, rolled PLU (multipliers by division) above."""
    n = _order(mat.shape[1])
    A = _grid(mat, n, trans)
    R = rhs.reshape(-1, n, k)
    if n <= _PLU_UNROLL_N:
        X = plu_substitute(*plu_factor(A), R)
    else:
        X = rolled_solve(A, R)
    return X.reshape(-1, n * k)


def inv_plain(mat):
    """Plain version of the inverse kernel: ``mat`` (B, n*n) -> A⁻¹
    (B, n*n). Cofactors times 1/det for n <= 4, ``inv[i][j] =
    cofactor(j, i) / det``; PLU against the identity's columns above
    (unrolled to 8, rolled beyond)."""
    n = _order(mat.shape[1])
    if n <= 4:
        E = [[mat[:, i * n + j] for j in range(n)] for i in range(n)]
        adj, det = _cofactors(E, n)
        inv_det = 1.0 / det
        return torch.stack([adj[i][j] * inv_det for i in range(n) for j in range(n)], dim=1)
    A = mat.reshape(-1, n, n)
    eye = torch.eye(n, dtype=mat.dtype, device=mat.device).expand(A.shape[0], n, n)
    if n <= _PLU_UNROLL_N:
        X = plu_substitute(*plu_factor(A), eye)
    else:
        X = rolled_solve(A, eye)
    return X.reshape(-1, n * n)


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
        strided = [p, ll, ll]  # pointer, batch stride, channel stride
        lib.fm_solve_full.argtypes = [i, i, i, ll, *strided, i, *strided, *strided, p]
        lib.fm_solve_full.restype = i
        lib.fm_inv.argtypes = [i, i, ll, *strided, *strided, p]
        lib.fm_inv.restype = i
        lib.fm_error_string.argtypes = [i]
        lib.fm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch_solve_full(mat, rhs, k, trans=False, cf_out=False):
    """Launch the solve kernel on CUDA tensors ``mat`` (B, n*n), ``rhs``
    (B, n*k); reads A transposed if ``trans``. Returns (B, n*k), a
    transposed view of (n*k, B) if ``cf_out``."""
    n = _order(mat.shape[-1])
    b = check(mat, n, ("mat", mat, n * n), ("rhs", rhs, n * k))
    if n > _PLU_UNROLL_N and n + k > _ROLLED_WIDTH:
        raise ValueError(f"the rolled tier (n > {_PLU_UNROLL_N}) holds [A | B] in "
                         f"n + k <= {_ROLLED_WIDTH} columns; got n={n}, k={k}")
    out = empty(rhs, b, n * k, cf_out)
    launch(_library(), solve_full_cf, "fm_solve_full", mat, n, k, b, *operand(mat),
           int(trans), *operand(rhs), *operand(out))
    return out


def launch_inv(mat, cf_out=False):
    """Launch the inverse kernel on a CUDA tensor ``mat`` (B, n*n)."""
    n = _order(mat.shape[-1])
    b = check(mat, n, ("mat", mat, n * n))
    out = empty(mat, b, n * n, cf_out)
    launch(_library(), inv_cf, "fm_inv", mat, n, b, *operand(mat), *operand(out))
    return out


# ---------------------------------------------------------------------------
# autograd (the reference's custom VJPs)
# ---------------------------------------------------------------------------


class SolveFullFunction(torch.autograd.Function):
    r"""Differentiable ``A \ B`` (``Aᵀ \ B`` if ``trans``) of 2-D
    operands: ``apply(mat, rhs, k, trans, kernel, cf_out)``; the kernel
    if ``kernel``, else the plain version."""

    @staticmethod
    def forward(ctx, mat, rhs, k, trans, kernel, cf_out):
        if kernel:
            x = launch_solve_full(mat, rhs, k, trans, cf_out)
        else:
            x = solve_full_plain(mat, rhs, k, trans)
        ctx.save_for_backward(mat, x)
        ctx.opts = (k, trans, kernel)
        return x

    @staticmethod
    def backward(ctx, g):
        # X = A^-1 B: dB = A^-T G, the same kernel reading A transposed;
        # dA = -dB X^T (for X = A^-T B, dA = -X dB^T)
        mat, x = ctx.saved_tensors
        k, trans, kernel = ctx.opts
        db = SolveFullFunction.apply(mat, g.contiguous(), k, not trans, kernel, False)
        n = _order(mat.shape[1])
        DB, X = db.reshape(-1, n, k), x.reshape(-1, n, k)
        da = -torch.matmul(X, DB.mT) if trans else -torch.matmul(DB, X.mT)
        return da.reshape(-1, n * n), db, None, None, None, None


class InvFunction(torch.autograd.Function):
    """Differentiable A⁻¹ of a 2-D operand: ``apply(mat, kernel, cf_out)``."""

    @staticmethod
    def forward(ctx, mat, kernel, cf_out):
        y = launch_inv(mat, cf_out) if kernel else inv_plain(mat)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        # Y = A^-1: dA = -Y^T G Y^T
        (y,) = ctx.saved_tensors
        n = _order(y.shape[1])
        YT = y.reshape(-1, n, n).mT
        da = -torch.matmul(torch.matmul(YT, g.reshape(-1, n, n)), YT)
        return da.reshape(-1, n * n), None, None


# ---------------------------------------------------------------------------
# channel-first wrappers (the counterparts of batched_pallas.solve_full_cf
# and inv_cf)
# ---------------------------------------------------------------------------


def _check_order(op, channels):
    n = _order(channels)
    if not 1 <= n <= MAX_N:
        raise ValueError(f"{op} expects (n*n, ...) rows with n <= {MAX_N}; "
                         f"got {channels} channels")
    return n


def solve_full_cf(mat: torch.Tensor, rhs: torch.Tensor, k: int = 1) -> torch.Tensor:
    r"""Channel-first batched full-matrix solve ``A \ B``: ``mat (n*n,
    ...)`` row-major, ``rhs (n*k, ...)`` row-major ``(i, c) -> i*k + c``
    -> ``(n*k, ...)``; batch dims broadcast, n <= 32. All k columns are
    solved with one factorization. Launches the CUDA kernel on CUDA
    tensors, and runs the plain version on CPU tensors."""
    mat, rhs, half = upcast_half(mat, rhs)
    n = _check_order("solve_full_cf", mat.shape[0])
    if rhs.shape[0] != n * k:
        raise ValueError(f"solve_full_cf expects rhs ({n * k}, ...) for k={k}; "
                         f"got {rhs.shape[0]}")
    require_domain("solve_full_cf", n, mat.dtype)
    batch = torch.broadcast_shapes(mat.shape[1:], rhs.shape[1:])
    m2, r2 = cf_flat(mat, n * n, batch).t(), cf_flat(rhs, n * k, batch).t()
    x = SolveFullFunction.apply(m2, r2, int(k), False, m2.is_cuda, True)
    return downcast(x.t().reshape(n * k, *batch), half)


def inv_cf(mat: torch.Tensor) -> torch.Tensor:
    """Channel-first batched inverse ``(n*n, ...) -> (n*n, ...)``,
    row-major channels, n <= 32. Launches the CUDA kernel on CUDA
    tensors, and runs the plain version on CPU tensors."""
    mat, half = upcast_half(mat)
    n = _check_order("inv_cf", mat.shape[0])
    require_domain("inv_cf", n, mat.dtype)
    batch = mat.shape[1:]
    m2 = cf_flat(mat, n * n, batch).t()
    y = InvFunction.apply(m2, m2.is_cuda, True)
    return downcast(y.t().reshape(n * n, *batch), half)


solve_full_cf.launches = 0
inv_cf.launches = 0
