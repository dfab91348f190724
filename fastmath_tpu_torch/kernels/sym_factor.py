"""CUDA compact-symmetric determinant and inverse, with their plain
PyTorch versions and autograd.

``sym_det_cf`` replaces the Pallas ``_det_sym_kernel`` and
``sym_invert_cf`` replaces ``_invert_kernel``
(``fastmath_tpu/kernels/sym_pallas.py``). Both kernels live in
``csrc/sym_factor.cu``; one thread owns one problem (a group of 16 or 32
lanes in the 9 <= N <= 32 tiers, ``csrc/lu_groups.cuh``), and the source's
header gives the tiers and what bounds them.

Matrices and inverses are compact (the diagonal first, then the upper
rows). Each wrapper launches its kernel on a CUDA tensor and runs its
plain version, which repeats the kernel's arithmetic in PyTorch, on a
CPU tensor. ``sym_det_cf.launches`` and ``sym_invert_cf.launches`` count
kernel launches, and nothing else. Operands are 2-D views, as
:mod:`._launch` describes.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.dtypes import downcast, upcast_half
from ..layouts.sym import compact_size, full_to_sym, sym_dim, sym_to_full
from ..ops.sym import _det_expand, _entries
from ._launch import (cf_flat, check, diag_product, empty, launch, operand, plu_factor,
                      plu_sign, plu_substitute, require_domain, rolled_factor, rolled_solve)

__all__ = ["sym_det_cf", "sym_invert_cf", "sym_det_plain", "invert_plain",
           "SymDetFunction", "InvertFunction"]

_LIB = "sym_factor"
#: N up to this runs the unrolled PLU in registers; above, the rolled tier
_PLU_UNROLL_N = 8


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic in PyTorch)
# ---------------------------------------------------------------------------


def sym_det_plain(mat):
    """Plain version of the determinant kernel: compact ``mat`` (B, NN)
    -> det (B,). The expansion on the compact entries for N <= 4;
    ``sign * U_00 * U_11 * ...`` of the unrolled PLU to 8 and of the
    rolled PLU above."""
    n = sym_dim(mat.shape[1])
    if n <= 4:
        idx = tuple(range(n))
        det = _det_expand(_entries(mat, n), idx, idx, {})
        return det if n > 1 else det.clone()
    A = sym_to_full(mat, n)
    if n <= _PLU_UNROLL_N:
        LU, piv, _ = plu_factor(A)
        return diag_product(LU, plu_sign(piv))
    return diag_product(*rolled_factor(A))


def invert_plain(mat):
    """Plain version of the inverse kernel: compact ``mat`` (B, NN) ->
    compact A⁻¹ (B, NN). Slot (i, j) = ``cofactor(j, i) * (1 / det)``
    for N <= 4; above, PLU against the identity's columns (unrolled to 8,
    rolled beyond) with the upper slots symmetrized, ``0.5 (X_ij +
    X_ji)``."""
    n = sym_dim(mat.shape[1])
    if n <= 4:
        E = _entries(mat, n)
        cache = {}
        idx = tuple(range(n))
        inv_det = 1.0 / _det_expand(E, idx, idx, cache)
        diag, upper = [], []
        for i in range(n):
            for j in range(i, n):
                minor = _det_expand(E, tuple(r for r in idx if r != j),
                                    tuple(c for c in idx if c != i), cache)
                cof = -minor if (i + j) % 2 else minor
                (diag if i == j else upper).append(cof * inv_det)
        return torch.stack(diag + upper, dim=1)
    A = sym_to_full(mat, n)
    eye = torch.eye(n, dtype=mat.dtype, device=mat.device).expand(A.shape[0], n, n)
    if n <= _PLU_UNROLL_N:
        X = plu_substitute(*plu_factor(A), eye)
    else:
        X = rolled_solve(A, eye)
    return full_to_sym(X)  # the upper slots 0.5 (X_ij + X_ji), as the kernel


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
        for fn in (lib.fm_sym_det, lib.fm_sym_invert):
            fn.argtypes = [i, i, ll, *strided, *strided, p]
            fn.restype = i
        lib.fm_error_string.argtypes = [i]
        lib.fm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch_sym_det(mat, cf_out=False):
    """Launch the determinant kernel on a CUDA tensor ``mat`` (B, NN);
    returns det (B,), a view of a (1, B) tensor if ``cf_out``."""
    n = sym_dim(mat.shape[-1])
    b = check(mat, n, ("mat", mat, compact_size(n)))
    out = empty(mat, b, 1, cf_out)
    launch(_library(), sym_det_cf, "fm_sym_det", mat, n, b, *operand(mat), *operand(out))
    return out[:, 0]


def launch_sym_invert(mat, cf_out=False):
    """Launch the inverse kernel on a CUDA tensor ``mat`` (B, NN); returns
    the compact inverse (B, NN)."""
    n = sym_dim(mat.shape[-1])
    b = check(mat, n, ("mat", mat, compact_size(n)))
    out = empty(mat, b, compact_size(n), cf_out)
    launch(_library(), sym_invert_cf, "fm_sym_invert", mat, n, b, *operand(mat),
           *operand(out))
    return out


# ---------------------------------------------------------------------------
# autograd (the reference's custom VJPs)
# ---------------------------------------------------------------------------


class InvertFunction(torch.autograd.Function):
    """Differentiable compact A⁻¹ of a 2-D operand (B, NN): ``apply(mat,
    kernel, cf_out)``; the kernel if ``kernel``, else the plain version."""

    @staticmethod
    def forward(ctx, mat, kernel, cf_out):
        y = launch_sym_invert(mat, cf_out) if kernel else invert_plain(mat)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        # Y = A^-1 read from its upper slots: with G the cotangent on the
        # upper triangle (zero below), Abar = -Y G Y, and each
        # off-diagonal slot takes Abar_ij + Abar_ji
        (y,) = ctx.saved_tensors
        n = sym_dim(y.shape[1])
        Y = sym_to_full(y, n)
        Ab = full_to_sym(-torch.matmul(torch.matmul(Y, torch.triu(sym_to_full(g, n))), Y))
        return torch.cat([Ab[:, :n], 2.0 * Ab[:, n:]], dim=1), None, None


class SymDetFunction(torch.autograd.Function):
    """Differentiable compact det of a 2-D operand (B, NN): ``apply(mat,
    kernel, cf_out)``."""

    @staticmethod
    def forward(ctx, mat, kernel, cf_out):
        det = launch_sym_det(mat, cf_out) if kernel else sym_det_plain(mat)
        ctx.save_for_backward(mat, det)
        ctx.kernel = kernel
        return det

    @staticmethod
    def backward(ctx, g):
        # d det / d compact: diagonal slot i takes cof(i, i), slot (i, j)
        # 2 cof(i, j) (the entry stands at (i, j) and (j, i)); cof =
        # det * A^-1 from the inverse kernel for N > 4
        mat, det = ctx.saved_tensors
        n = sym_dim(mat.shape[1])
        if n > 4:
            inv = InvertFunction.apply(mat, ctx.kernel, False)
            gd = (g * det)[:, None]
            return torch.cat([gd * inv[:, :n], 2.0 * gd * inv[:, n:]], dim=1), None, None
        E = _entries(mat, n)
        idx = tuple(range(n))
        cache = {}

        def cof(i, j):
            minor = _det_expand(E, tuple(r for r in idx if r != i),
                                tuple(c for c in idx if c != j), cache)
            return -minor if (i + j) % 2 else minor

        rows = [g * cof(i, i) for i in range(n)]
        rows += [2.0 * g * cof(i, j) for i in range(n) for j in range(i + 1, n)]
        return torch.stack(rows, dim=1), None, None


# ---------------------------------------------------------------------------
# channel-first wrappers (the counterparts of sym_pallas.sym_det_cf and
# sym_invert_cf)
# ---------------------------------------------------------------------------


def _compact_cf(mat, op):
    """Checks of a channel-first compact ``mat (NN, ...)``: (n, batch, its
    (B, NN) view)."""
    nn = mat.shape[0]
    n = sym_dim(nn)
    require_domain(op, n, mat.dtype)
    batch = mat.shape[1:]
    return n, batch, cf_flat(mat, nn, batch).t()


def sym_det_cf(mat: torch.Tensor) -> torch.Tensor:
    """Channel-first compact-symmetric determinant ``(NN, ...) -> (...)``,
    N <= 32. Launches the CUDA kernel on CUDA tensors, and runs the plain
    version on CPU tensors."""
    mat, half = upcast_half(mat)
    _, batch, m2 = _compact_cf(mat, "sym_det_cf")
    y = SymDetFunction.apply(m2, m2.is_cuda, True)
    return downcast(y.reshape(batch), half)


def sym_invert_cf(mat: torch.Tensor) -> torch.Tensor:
    """Channel-first compact-symmetric inverse ``(NN, ...) -> (NN, ...)``,
    N <= 32 (symmetrized above N = 4). Launches the CUDA kernel on CUDA
    tensors, and runs the plain version on CPU tensors."""
    mat, half = upcast_half(mat)
    _, batch, m2 = _compact_cf(mat, "sym_invert_cf")
    y = InvertFunction.apply(m2, m2.is_cuda, True)
    return downcast(y.t().reshape(mat.shape[0], *batch), half)


sym_det_cf.launches = 0
sym_invert_cf.launches = 0
