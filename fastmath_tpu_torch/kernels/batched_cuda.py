"""CUDA full-storage batched solve, inverse, determinant and
log-determinant, the batched Cholesky factor, and the batched
matrix-vector and matrix-matrix products, with their plain PyTorch
versions and autograd.

``solve_full_cf`` replaces the Pallas ``_solve_full_kernel``, ``inv_cf``
``_inv_kernel``, ``det_cf`` and ``logdet_cf`` the two modes of
``_det_kernel``, ``chol_cf`` ``_chol_kernel``, ``matvec_full_cf``
``_matvec_full_kernel`` and ``matmul_cf`` ``_matmul_kernel``
(``fastmath_tpu/kernels/batched_pallas.py``). The first five kernels live
in ``csrc/batched.cu``, where one thread owns one problem (a group of 16
or 32 lanes in the 9 <= n <= 32 tiers, ``csrc/lu_groups.cuh``; the n <= 8
inverse and Cholesky stage their blocks' problems in shared memory,
``csrc/tile_stage.cuh``);
the two products in ``csrc/batched_products.cu``, where one thread owns a
problem (matvec), and a block stages its problems' operands in shared
memory and each thread accumulates a 4 x 4 tile of C (matmul; one thread
an entry at up to 8 multiply-adds a problem, ``matmul_tier``). Each
source's header gives the tiers and what bounds them.

A matrix is full n x n storage, row-major in n*n channels (entry (i, j)
is channel ``i * n + j``); right-hand sides and solutions are n x k,
row-major in n*k channels. The Cholesky factor takes and gives compact
storage (the diagonal first, then the upper rows; slot (i, j) of the
factor holds ``L[max(i,j)][min(i,j)]``). Each wrapper launches its
kernel on a CUDA tensor and runs its plain version, which repeats the
kernel's arithmetic in PyTorch, on a CPU tensor.
``solve_full_cf.launches``, ``inv_cf.launches``, ``det_cf.launches``,
``logdet_cf.launches`` (the one determinant kernel, counted by mode) and
``chol_cf.launches``, ``matvec_full_cf.launches`` and ``matmul_cf.launches``
count kernel launches, and nothing else. Operands are 2-D views, as
:mod:`._launch` describes.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..core.dtypes import downcast, upcast_half
from ..layouts.sym import compact_size, sym_dim, sym_to_full
from ..ops.sym import _cofactors, _det_expand, _entries
from ._launch import (MAX_N, cf_flat, check, chol_rolled, chol_rows, diag_log_sum,
                      diag_product, empty, launch, operand, plu_factor, plu_sign,
                      plu_substitute, require_domain, rolled_factor, rolled_solve)
from .sym_products import _mm_ordered

__all__ = ["solve_full_cf", "inv_cf", "det_cf", "logdet_cf", "chol_cf", "matvec_full_cf",
           "matmul_cf", "solve_full_plain", "inv_plain", "det_plain", "logdet_plain",
           "chol_plain", "matvec_full_plain", "matmul_plain", "SolveFullFunction",
           "InvFunction", "DetFunction", "LogdetFunction", "CholFunction",
           "MatvecFullFunction", "MatmulFunction"]

_LIB = "batched"
_PRODUCTS_LIB = "batched_products"
#: n up to this runs the unrolled tiers in registers; above, the rolled
#: tier (lane groups on the card; the same pivots and arithmetic)
_PLU_UNROLL_N = 8
#: the Cholesky factor is unrolled up to this n; above, the rolled
#: outer-product form
_CHOL_UNROLL_N = 8


def _order(channels: int) -> int:
    """n of a matrix stored in ``channels`` = n*n channels (or 0)."""
    n = math.isqrt(channels)
    return n if n * n == channels else 0


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic in PyTorch)
# ---------------------------------------------------------------------------


def _grid(x, rows, cols, trans=False):
    """(B, rows, cols) view of ``x``: row-major rows x cols, or the
    transpose of a row-major cols x rows if ``trans``."""
    return x.reshape(-1, cols, rows).transpose(1, 2) if trans else x.reshape(-1, rows, cols)


def solve_full_plain(mat, rhs, k, trans=False):
    r"""Plain version of the solve kernel: ``mat`` (B, n*n), ``rhs``
    (B, n*k) -> ``A \ B`` (B, n*k), or ``Aᵀ \ B`` if ``trans``. Unrolled
    PLU (multipliers by the reciprocal pivot, back-substitution times
    1/U_ii) for n <= 8, rolled PLU (multipliers by division) above."""
    n = _order(mat.shape[1])
    A = _grid(mat, n, n, trans)
    R = rhs.reshape(-1, n, k)
    if n <= _PLU_UNROLL_N:
        X = plu_substitute(*plu_factor(A), R)
    else:
        X = rolled_solve(A, R)
    return X.reshape(-1, n * k)


def _full_grid(mat, n):
    """Entry grid E[i][j] of the row-major ``mat`` (B, n*n)."""
    return [[mat[:, i * n + j] for j in range(n)] for i in range(n)]


def inv_plain(mat):
    """Plain version of the inverse kernel: ``mat`` (B, n*n) -> A⁻¹
    (B, n*n). Cofactors times 1/det for n <= 4, ``inv[i][j] =
    cofactor(j, i) / det``; PLU against the identity's columns above
    (unrolled to 8, rolled beyond)."""
    n = _order(mat.shape[1])
    if n <= 4:
        adj, det = _cofactors(_full_grid(mat, n), n)
        inv_det = 1.0 / det
        return torch.stack([adj[i][j] * inv_det for i in range(n) for j in range(n)], dim=1)
    A = mat.reshape(-1, n, n)
    eye = torch.eye(n, dtype=mat.dtype, device=mat.device).expand(A.shape[0], n, n)
    if n <= _PLU_UNROLL_N:
        X = plu_substitute(*plu_factor(A), eye)
    else:
        X = rolled_solve(A, eye)
    return X.reshape(-1, n * n)


def det_plain(mat):
    """Plain version of the determinant kernel: ``mat`` (B, n*n) -> det
    (B,). The expansion for n <= 4; ``sign * U_00 * U_11 * ...`` of the
    unrolled PLU to 8 and of the rolled PLU above."""
    n = _order(mat.shape[1])
    if n <= 4:
        idx = tuple(range(n))
        det = _det_expand(_full_grid(mat, n), idx, idx, {})
        return det if n > 1 else det.clone()
    A = mat.reshape(-1, n, n)
    if n <= _PLU_UNROLL_N:
        LU, piv, _ = plu_factor(A)
        return diag_product(LU, plu_sign(piv))
    return diag_product(*rolled_factor(A))


def logdet_plain(mat):
    """Plain version of the log-determinant kernel: ``mat`` (B, n*n) ->
    log|det| (B,). For n <= 4 each row is scaled by its largest
    magnitude r_i first: ``sum_i log r_i + log|det(S A)|`` (a zero row
    gives -inf); above, ``sum_i log|U_ii|`` of the PLU, never the log of
    the product."""
    n = _order(mat.shape[1])
    if n <= 4:
        E = _full_grid(mat, n)
        logs, scaled = None, []
        for row in E:
            r = torch.abs(row[0])
            for e in row[1:]:
                r = torch.maximum(r, torch.abs(e))
            q = torch.where(r > 0, 1.0 / r, torch.zeros_like(r))
            scaled.append([e * q for e in row])
            li = torch.log(torch.where(r > 0, r, torch.ones_like(r)))
            logs = li if logs is None else logs + li
        idx = tuple(range(n))
        return logs + torch.log(torch.abs(_det_expand(scaled, idx, idx, {})))
    A = mat.reshape(-1, n, n)
    return diag_log_sum(plu_factor(A)[0] if n <= _PLU_UNROLL_N else rolled_factor(A)[0])


def _lower_to_compact(L):
    """Compact slots of a lower factor (B, n, n): the diagonal, then slot
    (i, j), i < j, holding ``L[j][i]``."""
    rows, cols = np.triu_indices(L.shape[1], k=1)
    return torch.cat([L.diagonal(dim1=1, dim2=2), L[:, cols, rows]], dim=1)


def chol_plain(mat):
    """Plain version of the Cholesky kernel: compact ``mat`` (B, NN) ->
    compact lower factor (B, NN). Cholesky-Banachiewicz for n <= 8, the
    rolled outer-product form with ``rsqrt`` above."""
    n = sym_dim(mat.shape[1])
    if n > _CHOL_UNROLL_N:
        return _lower_to_compact(chol_rolled(sym_to_full(mat, n)))
    L = chol_rows(_entries(mat, n), n)
    return torch.stack([L[i][i] for i in range(n)]
                       + [L[j][i] for i in range(n) for j in range(i + 1, n)], dim=1)


def matvec_full_plain(mat, vec, trans=False):
    """Plain version of the matvec kernel: ``mat`` (B, n*n), ``vec``
    (B, n) -> ``A v`` (B, n), or ``Aᵀ v`` if ``trans``; each row summed
    left to right from the first term."""
    n = vec.shape[1]
    A = _grid(mat, n, n, trans)
    y = A[:, :, 0] * vec[:, 0, None]
    for j in range(1, n):
        y = y + A[:, :, j] * vec[:, j, None]
    return y


def matmul_plain(a, b, m, k, n, trans_a=False, trans_b=False):
    """Plain version of the product kernel: ``a`` (B, m*k) and ``b``
    (B, k*n) row-major (stored transposed where ``trans_a`` /
    ``trans_b``) -> ``A B`` (B, m*n), each entry summed over k in order
    from the first term."""
    C = _mm_ordered(_grid(a, m, k, trans_a), _grid(b, k, n, trans_b))
    return C.reshape(-1, m * n)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

_lib = None
_products_lib = None


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
        lib.fm_det.argtypes = [i, i, ll, *strided, i, *strided, p]
        lib.fm_det.restype = i
        lib.fm_chol.argtypes = [i, i, ll, *strided, *strided, p]
        lib.fm_chol.restype = i
        lib.fm_error_string.argtypes = [i]
        lib.fm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _products_library():
    global _products_lib
    if _products_lib is None:
        from . import _build

        lib = _build.load(_PRODUCTS_LIB)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        strided = [p, ll, ll]  # pointer, batch stride, channel stride
        lib.fm_matvec_full.argtypes = [i, i, ll, *strided, i, *strided, *strided, p]
        lib.fm_matmul.argtypes = [i, i, i, i, ll, *strided, i, *strided, i, *strided, p]
        lib.fm_matmul_tier.argtypes = [i, i, i]
        for fn in (lib.fm_matvec_full, lib.fm_matmul, lib.fm_matmul_tier):
            fn.restype = i
        lib.fm_error_string.argtypes = [i]
        lib.fm_error_string.restype = ctypes.c_char_p
        _products_lib = lib
    return _products_lib


def launch_matvec_full(mat, vec, trans=False, cf_out=False):
    """Launch the matvec kernel on CUDA tensors ``mat`` (B, n*n), ``vec``
    (B, n); reads A transposed if ``trans``. Returns (B, n), a transposed
    view of (n, B) if ``cf_out``."""
    n = vec.shape[-1]
    nb = check(mat, n, ("mat", mat, n * n), ("vec", vec, n))
    out = empty(vec, nb, n, cf_out)
    launch(_products_library(), matvec_full_cf, "fm_matvec_full", mat, n, nb, *operand(mat),
           int(trans), *operand(vec), *operand(out))
    return out


def launch_matmul(a, b, m, k, n, trans_a=False, trans_b=False, cf_out=False):
    """Launch the product kernel on CUDA tensors ``a`` (B, m*k) and ``b``
    (B, k*n), each read transposed (stored k x m, n x k) if its flag is
    set. Returns ``A B`` (B, m*n), a transposed view of (m*n, B) if
    ``cf_out``."""
    nb = check(a, max(m, k, n), ("a", a, m * k), ("b", b, k * n))
    out = empty(a, nb, m * n, cf_out)
    launch(_products_library(), matmul_cf, "fm_matmul", a, m, k, n, nb, *operand(a),
           int(trans_a), *operand(b), int(trans_b), *operand(out))
    return out


def matmul_tier(m, k, n):
    """The name of the CUDA tier the product kernel takes for an m x k x n
    product (the launcher's own rule, read from the library)."""
    return ("matmul_entries", "matmul_tiles")[_products_library().fm_matmul_tier(m, k, n)]


def launch_solve_full(mat, rhs, k, trans=False, cf_out=False):
    """Launch the solve kernel on CUDA tensors ``mat`` (B, n*n), ``rhs``
    (B, n*k); reads A transposed if ``trans``. Returns (B, n*k), a
    transposed view of (n*k, B) if ``cf_out``."""
    n = _order(mat.shape[-1])
    b = check(mat, n, ("mat", mat, n * n), ("rhs", rhs, n * k))
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


def launch_det(mat, cf_out=False, log=False):
    """Launch the determinant kernel on a CUDA tensor ``mat`` (B, n*n):
    det (B,), or log|det| if ``log``; ``cf_out`` writes it as a view of
    a (1, B) tensor."""
    n = _order(mat.shape[-1])
    b = check(mat, n, ("mat", mat, n * n))
    out = empty(mat, b, 1, cf_out)
    launch(_library(), logdet_cf if log else det_cf, "fm_det", mat, n, b, *operand(mat),
           int(log), *operand(out))
    return out[:, 0]


def launch_logdet(mat, cf_out=False):
    """Launch the determinant kernel in its log|det| mode."""
    return launch_det(mat, cf_out, log=True)


def launch_chol(mat, cf_out=False):
    """Launch the Cholesky kernel on a CUDA tensor ``mat`` (B, NN)
    compact; returns the compact lower factor (B, NN)."""
    n = sym_dim(mat.shape[-1])
    b = check(mat, n, ("mat", mat, compact_size(n)))
    out = empty(mat, b, compact_size(n), cf_out)
    launch(_library(), chol_cf, "fm_chol", mat, n, b, *operand(mat), *operand(out))
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


class DetFunction(torch.autograd.Function):
    """Differentiable det of a 2-D operand (B, n*n): ``apply(mat, kernel,
    cf_out)``."""

    @staticmethod
    def forward(ctx, mat, kernel, cf_out):
        det = launch_det(mat, cf_out) if kernel else det_plain(mat)
        ctx.save_for_backward(mat, det)
        ctx.kernel = kernel
        return det

    @staticmethod
    def backward(ctx, g):
        # d det / dA_ij = cofactor(i, j): the cofactor grid for n <= 4;
        # det * (A^-1)^T above, A^-1 from the inverse kernel (NaN at an
        # exactly singular A, as in the reference)
        mat, det = ctx.saved_tensors
        n = _order(mat.shape[1])
        if n <= 4:
            adj, _ = _cofactors(_full_grid(mat, n), n)  # adj[j][i] = cofactor(i, j)
            return torch.stack([g * adj[j][i] for i in range(n) for j in range(n)],
                               dim=1), None, None
        inv = InvFunction.apply(mat, ctx.kernel, False)
        inv_t = inv.reshape(-1, n, n).mT.reshape(-1, n * n)
        return g[:, None] * (det[:, None] * inv_t), None, None


class LogdetFunction(torch.autograd.Function):
    """Differentiable log|det| of a 2-D operand (B, n*n): ``apply(mat,
    kernel, cf_out)``."""

    @staticmethod
    def forward(ctx, mat, kernel, cf_out):
        y = launch_logdet(mat, cf_out) if kernel else logdet_plain(mat)
        ctx.save_for_backward(mat)
        ctx.kernel = kernel
        return y

    @staticmethod
    def backward(ctx, g):
        # d log|det A| / dA = A^-T: the solve kernel reading A transposed
        # against the identity's n columns
        (mat,) = ctx.saved_tensors
        n = _order(mat.shape[1])
        eye = torch.eye(n, dtype=mat.dtype, device=mat.device).reshape(1, n * n)
        inv_t = SolveFullFunction.apply(mat, eye.expand(mat.shape[0], -1).contiguous(), n,
                                        True, ctx.kernel, False)
        return g[:, None] * inv_t, None, None


class CholFunction(torch.autograd.Function):
    """Differentiable compact Cholesky factor of a 2-D operand (B, NN):
    ``apply(mat, kernel, cf_out)``."""

    @staticmethod
    def forward(ctx, mat, kernel, cf_out):
        y = launch_chol(mat, cf_out) if kernel else chol_plain(mat)
        ctx.save_for_backward(mat)
        return y

    @staticmethod
    def backward(ctx, g):
        # the reference's VJP: autograd through the unrolled form for
        # n <= 8, through torch.linalg.cholesky of the densified matrix
        # above (its jnp.linalg.cholesky)
        (mat,) = ctx.saved_tensors
        n = sym_dim(mat.shape[1])
        with torch.enable_grad():
            m = mat.detach().requires_grad_()
            if n <= _CHOL_UNROLL_N:
                y = chol_plain(m)
            else:
                y = _lower_to_compact(torch.linalg.cholesky(sym_to_full(m, n)))
            (dm,) = torch.autograd.grad(y, m, g)
        return dm, None, None


class MatvecFullFunction(torch.autograd.Function):
    """Differentiable ``A v`` (``Aᵀ v`` if ``trans``) of 2-D operands:
    ``apply(mat, vec, trans, kernel, cf_out)``."""

    @staticmethod
    def forward(ctx, mat, vec, trans, kernel, cf_out):
        if kernel:
            y = launch_matvec_full(mat, vec, trans, cf_out)
        else:
            y = matvec_full_plain(mat, vec, trans)
        ctx.save_for_backward(mat, vec)
        ctx.opts = (trans, kernel)
        return y

    @staticmethod
    def backward(ctx, g):
        # y = A v: dA = g vᵀ, dv = Aᵀ g, the same kernel reading A
        # transposed (for y = Aᵀ v: dA = v gᵀ, dv = A g)
        mat, vec = ctx.saved_tensors
        trans, kernel = ctx.opts
        g = g.contiguous()
        dv = MatvecFullFunction.apply(mat, g, not trans, kernel, False)
        rows, cols = (vec, g) if trans else (g, vec)
        return (rows[:, :, None] * cols[:, None, :]).reshape(mat.shape[0], -1), dv, None, \
            None, None


class MatmulFunction(torch.autograd.Function):
    """Differentiable ``op(A) op(B)`` of 2-D operands, ``op`` the
    transpose where ``trans_a`` / ``trans_b`` is set: ``apply(a, b, m, k,
    n, trans_a, trans_b, kernel, cf_out)``, op(A) m x k, op(B) k x n."""

    @staticmethod
    def forward(ctx, a, b, m, k, n, trans_a, trans_b, kernel, cf_out):
        if kernel:
            y = launch_matmul(a, b, m, k, n, trans_a, trans_b, cf_out)
        else:
            y = matmul_plain(a, b, m, k, n, trans_a, trans_b)
        ctx.save_for_backward(a, b)
        ctx.opts = (m, k, n, trans_a, trans_b, kernel)
        return y

    @staticmethod
    def backward(ctx, g):
        # C = P Q, P = op(A), Q = op(B): dP = G Qᵀ, dQ = Pᵀ G, two more
        # launches of the same kernel reading their operands transposed
        # through strides; a transposed operand takes the transpose of its
        # cotangent (dA = dPᵀ = Q Gᵀ, dB = dQᵀ = Gᵀ P)
        a, b = ctx.saved_tensors
        m, k, n, ta, tb, kernel = ctx.opts
        g = g.contiguous()
        mm = MatmulFunction.apply
        if ta:
            da = mm(b, g, k, n, m, tb, True, kernel, False)
        else:
            da = mm(g, b, m, n, k, False, not tb, kernel, False)
        if tb:
            db = mm(g, a, n, m, k, True, ta, kernel, False)
        else:
            db = mm(a, g, k, m, n, not ta, False, kernel, False)
        return da, db, None, None, None, None, None, None, None


# ---------------------------------------------------------------------------
# channel-first wrappers (the counterparts of batched_pallas.solve_full_cf,
# inv_cf, det_cf, logdet_cf, chol_cf, matvec_full_cf and matmul_cf)
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
    -> ``(n*k, ...)``; batch dims broadcast, n <= 32, any k. All k columns
    are solved with one factorization. Launches the CUDA kernel on CUDA
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


def _det_cf(mat, function, op):
    mat, half = upcast_half(mat)
    n = _check_order(op, mat.shape[0])
    require_domain(op, n, mat.dtype)
    batch = mat.shape[1:]
    m2 = cf_flat(mat, n * n, batch).t()
    y = function.apply(m2, m2.is_cuda, True)
    return downcast(y.reshape(batch), half)


def det_cf(mat: torch.Tensor) -> torch.Tensor:
    """Channel-first batched determinant ``(n*n, ...) -> (...)``,
    row-major channels, n <= 32. Launches the CUDA kernel on CUDA
    tensors, and runs the plain version on CPU tensors."""
    return _det_cf(mat, DetFunction, "det_cf")


def logdet_cf(mat: torch.Tensor) -> torch.Tensor:
    """Channel-first batched ``log |det A|`` ``(n*n, ...) -> (...)``:
    per-pivot logs summed, so it stays finite where det overflows."""
    return _det_cf(mat, LogdetFunction, "logdet_cf")


def chol_cf(mat: torch.Tensor) -> torch.Tensor:
    """Channel-first batched Cholesky ``(NN, ...) -> (NN, ...)``: compact
    SPD in, compact lower factor out (slot (i, j) holds
    ``L[max(i,j)][min(i,j)]``), N <= 32, no pivoting (input that is not
    SPD gives NaN). Launches the CUDA kernel on CUDA tensors, and runs
    the plain version on CPU tensors."""
    mat, half = upcast_half(mat)
    nn = mat.shape[0]
    require_domain("chol_cf", sym_dim(nn), mat.dtype)
    batch = mat.shape[1:]
    m2 = cf_flat(mat, nn, batch).t()
    y = CholFunction.apply(m2, m2.is_cuda, True)
    return downcast(y.t().reshape(nn, *batch), half)


def matvec_full_cf(mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Channel-first batched full matvec ``(n*n, ...) @ (n, ...) -> (n,
    ...)``, row-major channels, batch dims broadcast, n <= 32. Launches
    the CUDA kernel on CUDA tensors, and runs the plain version on CPU
    tensors."""
    mat, vec, half = upcast_half(mat, vec)
    n = vec.shape[0]
    if mat.shape[0] != n * n:
        raise ValueError(f"matvec_full_cf expects mat ({n * n}, ...) for vec ({n}, ...); "
                         f"got {mat.shape[0]}")
    require_domain("matvec_full_cf", n, mat.dtype, what="n")
    batch = torch.broadcast_shapes(mat.shape[1:], vec.shape[1:])
    m2, v2 = cf_flat(mat, n * n, batch).t(), cf_flat(vec, n, batch).t()
    y = MatvecFullFunction.apply(m2, v2, False, m2.is_cuda, True)
    return downcast(y.t().reshape(n, *batch), half)


def matmul_cf(a: torch.Tensor, b: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Channel-first batched matmul ``(m*k, ...) @ (k*n, ...) -> (m*n,
    ...)``, row-major channels, batch dims broadcast, every dim <= 32; k
    is inferred from ``a``'s channel count. Launches the CUDA kernel on
    CUDA tensors, and runs the plain version on CPU tensors."""
    a, b, half = upcast_half(a, b)
    if m <= 0 or n <= 0 or a.shape[0] % m:
        raise ValueError(f"matmul_cf expects a ({m}*k, ...); got {a.shape[0]} channels")
    k = a.shape[0] // m
    if b.shape[0] != k * n:
        raise ValueError(f"matmul_cf expects b ({k}*{n}, ...); got {b.shape[0]} channels")
    require_domain("matmul_cf", max(m, k, n), a.dtype, what="every dim")
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    a2, b2 = cf_flat(a, m * k, batch).t(), cf_flat(b, k * n, batch).t()
    y = MatmulFunction.apply(a2, b2, int(m), int(k), int(n), False, False, a2.is_cuda, True)
    return downcast(y.t().reshape(m * n, *batch), half)


for _fn in (solve_full_cf, inv_cf, det_cf, logdet_cf, chol_cf, matvec_full_cf, matmul_cf):
    _fn.launches = 0
