"""CUDA compact-symmetric products (``A v``, ``acc ± A v``, ``x xᵀ`` and
``Jᵀ H J``), with their plain PyTorch versions and autograd.

``sym_matvec_cf`` replaces the Pallas ``_matvec_kernel``,
``sym_addmatvec_cf`` / ``sym_submatvec_cf`` replace ``_accmatvec_kernel``,
``sym_outer_cf`` replaces ``_outer_kernel`` and ``sym_matmul_cf``
replaces ``_jhj_kernel`` (``fastmath_tpu/kernels/sym_pallas.py``). The
four kernels live in ``csrc/sym_products.cu``; its header says how each
is laid out and what bounds it.

Each wrapper launches its kernel on a CUDA tensor and runs its plain
version, which repeats the kernel's arithmetic in PyTorch in the same
term order, on a CPU tensor. ``sym_matvec_cf.launches``,
``sym_addmatvec_cf.launches``, ``sym_submatvec_cf.launches`` (the one
accumulate kernel, counted by sign), ``sym_outer_cf.launches`` and
``sym_matmul_cf.launches`` count kernel launches, and nothing else.
Operands are 2-D views, as :mod:`._launch` describes.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.dtypes import downcast, upcast_half
from ..layouts.sym import compact_size, sym_dim, sym_to_full
from ._launch import cf_flat, cf_prepare, check, empty, launch, operand, require_domain

__all__ = ["sym_matvec_cf", "sym_addmatvec_cf", "sym_submatvec_cf", "sym_outer_cf",
           "sym_matmul_cf", "matvec_plain", "accmatvec_plain", "outer_plain",
           "jhj_plain", "sym_outer_sum", "MatvecFunction", "AccMatvecFunction",
           "OuterFunction", "JhjFunction", "JHJ_UNROLL_MAX"]

_LIB = "sym_products"
#: K, D up to this run the congruence product unrolled on the upper slots;
#: above, the full G is formed and its off-diagonal averaged
JHJ_UNROLL_MAX = 6


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic in PyTorch)
# ---------------------------------------------------------------------------


def _upper(n, device):
    """Row and column indices of the strict upper triangle, row by row
    (the compact order after the diagonal)."""
    rows, cols = np.triu_indices(n, k=1)
    return torch.as_tensor(rows, device=device), torch.as_tensor(cols, device=device)


def matvec_plain(mat, vec):
    """Plain version of the matvec kernel: ``mat`` (B, NN), ``vec`` (B, N)
    -> ``A v`` (B, N), each row summed as the reference's kernel sums it:
    the diagonal term, then ``j != i`` in order."""
    n = vec.shape[1]
    A = sym_to_full(mat, n)
    out = mat[:, :n] * vec
    for j in range(n):
        col = A[:, :, j] * vec[:, j, None]
        col[:, j] = 0  # row j's own term came first
        out = out + col
    return out


def accmatvec_plain(acc, mat, vec, sign):
    """Plain version of the accumulate kernel: ``acc + sign * (A v)``,
    ``sign`` +1.0 or -1.0."""
    return acc + sign * matvec_plain(mat, vec)


def outer_plain(x):
    """Plain version of the outer-product kernel: ``x`` (B, N) -> compact
    ``x xᵀ`` (B, NN), the diagonal first, then the upper rows."""
    rows, cols = _upper(x.shape[1], x.device)
    return torch.cat([x * x, x[:, rows] * x[:, cols]], dim=1)


def sym_outer_sum(a, b):
    """Compact ``a bᵀ + b aᵀ`` with the diagonal taken once: diag
    ``a_i b_i``, upper ``a_i b_j + a_j b_i`` ((B, n) each). It is the
    gradient of a symmetric matrix that multiplies a vector."""
    rows, cols = _upper(a.shape[1], a.device)
    return torch.cat([a * b, a[:, rows] * b[:, cols] + a[:, cols] * b[:, rows]], dim=1)


def _mm_ordered(A, B):
    """``A @ B`` for (b, m, k) and (b, k, n), each entry summed over k in
    order from the first term (the reference's unrolled order)."""
    acc = A[:, :, 0, None] * B[:, None, 0, :]
    for t in range(1, A.shape[2]):
        acc = acc + A[:, :, t, None] * B[:, None, t, :]
    return acc


def jhj_plain(j, h, d):
    """Plain version of the congruence kernel: ``j`` (B, K*D) row-major,
    ``h`` (B, K(K+1)/2) compact -> compact ``Jᵀ H J`` (B, D(D+1)/2).

    ``G = Jᵀ (H J)``; up to K, D <= 6 the output is G's upper slots, as
    the reference's unrolled tier; above, ``0.5 (G_ij + G_ji)`` off the
    diagonal, as its rolled tier."""
    k = sym_dim(h.shape[1])
    J = j.reshape(-1, k, d)
    G = _mm_ordered(J.transpose(1, 2), _mm_ordered(sym_to_full(h, k), J))
    rows, cols = _upper(d, j.device)
    upper = G[:, rows, cols]
    if max(k, d) > JHJ_UNROLL_MAX:
        upper = 0.5 * (upper + G[:, cols, rows])
    return torch.cat([G.diagonal(dim1=1, dim2=2), upper], dim=1)


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
        lib.fm_sym_matvec.argtypes = [i, i, ll, *(strided * 3), p]
        lib.fm_sym_accmatvec.argtypes = [i, i, ll, ctypes.c_double, *(strided * 4), p]
        lib.fm_sym_outer.argtypes = [i, i, ll, *(strided * 2), p]
        lib.fm_sym_jhj.argtypes = [i, i, i, ll, *(strided * 3), p]
        for fn in (lib.fm_sym_matvec, lib.fm_sym_accmatvec, lib.fm_sym_outer,
                   lib.fm_sym_jhj):
            fn.restype = i
        lib.fm_error_string.argtypes = [i]
        lib.fm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch_matvec(mat, vec, cf_out=False):
    """Launch the matvec kernel on CUDA tensors ``mat`` (B, NN), ``vec``
    (B, N); returns (B, N), a transposed view of (N, B) if ``cf_out``."""
    n = vec.shape[-1]
    b = check(mat, n, ("mat", mat, compact_size(n)), ("vec", vec, n))
    out = empty(vec, b, n, cf_out)
    launch(_library(), sym_matvec_cf, "fm_sym_matvec", mat, n, b, *operand(mat),
           *operand(vec), *operand(out))
    return out


def launch_accmatvec(acc, mat, vec, sign, cf_out=False):
    """Launch the accumulate kernel: ``acc + sign * (A v)``, sign +1/-1."""
    n = vec.shape[-1]
    b = check(mat, n, ("acc", acc, n), ("mat", mat, compact_size(n)), ("vec", vec, n))
    out = empty(vec, b, n, cf_out)
    launch(_library(), sym_addmatvec_cf if sign > 0 else sym_submatvec_cf,
           "fm_sym_accmatvec", mat, n, b, float(sign), *operand(acc), *operand(mat),
           *operand(vec), *operand(out))
    return out


def launch_outer(x, cf_out=False):
    """Launch the outer-product kernel on a CUDA tensor ``x`` (B, N)."""
    n = x.shape[-1]
    b = check(x, n, ("x", x, n))
    out = empty(x, b, compact_size(n), cf_out)
    launch(_library(), sym_outer_cf, "fm_sym_outer", x, n, b, *operand(x), *operand(out))
    return out


def launch_jhj(j, h, d, cf_out=False):
    """Launch the congruence kernel: ``j`` (B, K*D), ``h`` (B, K(K+1)/2)
    -> (B, D(D+1)/2)."""
    k = sym_dim(h.shape[-1])
    b = check(h, max(k, d), ("j", j, k * d), ("h", h, compact_size(k)))
    out = empty(h, b, compact_size(d), cf_out)
    launch(_library(), sym_matmul_cf, "fm_sym_jhj", h, k, d, b, *operand(j),
           *operand(h), *operand(out))
    return out


# ---------------------------------------------------------------------------
# autograd (the reference's custom VJPs)
# ---------------------------------------------------------------------------


class MatvecFunction(torch.autograd.Function):
    """Differentiable ``A v`` of 2-D operands: ``apply(mat, vec, kernel,
    cf_out)``; the kernel if ``kernel``, else the plain version."""

    @staticmethod
    def forward(ctx, mat, vec, kernel, cf_out):
        y = launch_matvec(mat, vec, cf_out) if kernel else matvec_plain(mat, vec)
        ctx.save_for_backward(mat, vec)
        ctx.kernel = kernel
        return y

    @staticmethod
    def backward(ctx, g):
        # y = A v, A symmetric: dv = A g (the kernel again); dA compact:
        # diag g_i v_i, upper g_i v_j + g_j v_i
        mat, vec = ctx.saved_tensors
        g = g.contiguous()
        dv = MatvecFunction.apply(mat, g, ctx.kernel, False)
        return sym_outer_sum(g, vec), dv, None, None


class AccMatvecFunction(torch.autograd.Function):
    """Differentiable ``acc + sign * (A v)``: ``apply(acc, mat, vec, sign,
    kernel, cf_out)``, ``sign`` +1.0 or -1.0."""

    @staticmethod
    def forward(ctx, acc, mat, vec, sign, kernel, cf_out):
        if kernel:
            y = launch_accmatvec(acc, mat, vec, sign, cf_out)
        else:
            y = accmatvec_plain(acc, mat, vec, sign)
        ctx.save_for_backward(mat, vec)
        ctx.opts = (sign, kernel)
        return y

    @staticmethod
    def backward(ctx, g):
        # y = acc + sign A v: dacc = g, dv = sign A g, dA = sign (matvec's)
        mat, vec = ctx.saved_tensors
        sign, kernel = ctx.opts
        g = g.contiguous()
        dv = MatvecFunction.apply(mat, g, kernel, False)
        if sign < 0:
            dv = -dv
        return g, sign * sym_outer_sum(g, vec), dv, None, None, None


class OuterFunction(torch.autograd.Function):
    """Differentiable compact ``x xᵀ``: ``apply(x, kernel, cf_out)``."""

    @staticmethod
    def forward(ctx, x, kernel, cf_out):
        y = launch_outer(x, cf_out) if kernel else outer_plain(x)
        ctx.save_for_backward(x)
        return y

    @staticmethod
    def backward(ctx, g):
        # y_ii = x_i^2, y_ij = x_i x_j: dx_i = 2 g_ii x_i + sum_{j != i}
        # g_ij x_j, which is the matvec of g with its diagonal doubled
        (x,) = ctx.saved_tensors
        n = x.shape[1]
        return matvec_plain(torch.cat([2.0 * g[:, :n], g[:, n:]], dim=1), x), None, None


class JhjFunction(torch.autograd.Function):
    """Differentiable compact ``Jᵀ H J``: ``apply(j, h, d, kernel, cf_out)``."""

    @staticmethod
    def forward(ctx, j, h, d, kernel, cf_out):
        y = launch_jhj(j, h, d, cf_out) if kernel else jhj_plain(j, h, d)
        ctx.save_for_backward(j, h)
        ctx.d = d
        return y

    @staticmethod
    def backward(ctx, g):
        # out = Jᵀ H J, H symmetric. Gf is the symmetric expansion of the
        # compact cotangent with its off-diagonal halved (each compact
        # slot stands for two entries): dH folds J Gf Jᵀ back to compact,
        # dJ = 2 H J Gf.
        j, h = ctx.saved_tensors
        d = ctx.d
        k = sym_dim(h.shape[1])
        J = j.reshape(-1, k, d)
        Gf = sym_to_full(torch.cat([g[:, :d], 0.5 * g[:, d:]], dim=1), d)
        JG = _mm_ordered(J, Gf)
        Hbar = _mm_ordered(J, JG.transpose(1, 2))
        rows, cols = _upper(k, j.device)
        dh = torch.cat([Hbar.diagonal(dim1=1, dim2=2),
                        Hbar[:, rows, cols] + Hbar[:, cols, rows]], dim=1)
        dj = 2.0 * _mm_ordered(sym_to_full(h, k), JG)
        return dj.reshape(-1, k * d), dh, None, None, None


# ---------------------------------------------------------------------------
# channel-first wrappers (the counterparts of sym_pallas.sym_matvec_cf,
# sym_addmatvec_cf, sym_submatvec_cf, sym_outer_cf and sym_matmul_cf)
# ---------------------------------------------------------------------------


def sym_matvec_cf(mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Channel-first compact-symmetric matvec ``A v``: ``mat (NN, ...)``,
    ``vec (N, ...)`` -> ``(N, ...)``; batch dims broadcast. Launches the
    CUDA kernel on CUDA tensors, and runs the plain version on CPU tensors.
    """
    mat, vec, half = upcast_half(mat, vec)
    n, batch, (m2, v2) = cf_prepare(mat, vec, op="sym_matvec_cf")
    y = MatvecFunction.apply(m2, v2, m2.is_cuda, True)
    return downcast(y.t().reshape(n, *batch), half)


def _accmatvec_cf(acc, mat, vec, sign, op):
    acc, mat, vec, half = upcast_half(acc, mat, vec)
    n, batch, (m2, v2, a2) = cf_prepare(mat, vec, acc, op=op)
    y = AccMatvecFunction.apply(a2, m2, v2, sign, m2.is_cuda, True)
    return downcast(y.t().reshape(n, *batch), half)


def sym_addmatvec_cf(acc: torch.Tensor, mat: torch.Tensor,
                     vec: torch.Tensor) -> torch.Tensor:
    """Channel-first fused ``acc + A v`` (``(N, ...)`` each, ``mat``
    ``(NN, ...)``): one pass over memory on the card."""
    return _accmatvec_cf(acc, mat, vec, 1.0, "sym_addmatvec_cf")


def sym_submatvec_cf(acc: torch.Tensor, mat: torch.Tensor,
                     vec: torch.Tensor) -> torch.Tensor:
    """Channel-first fused ``acc - A v``: one pass over memory on the card."""
    return _accmatvec_cf(acc, mat, vec, -1.0, "sym_submatvec_cf")


def sym_outer_cf(x: torch.Tensor) -> torch.Tensor:
    """Channel-first compact outer product ``x xᵀ``: ``(N, ...)`` ->
    ``(N(N+1)/2, ...)``."""
    x, half = upcast_half(x)
    n = x.shape[0]
    require_domain("sym_outer_cf", n, x.dtype)
    batch = x.shape[1:]
    x2 = cf_flat(x, n, batch).t()
    y = OuterFunction.apply(x2, x2.is_cuda, True)
    return downcast(y.t().reshape(compact_size(n), *batch), half)


def sym_matmul_cf(j: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Channel-first congruence product ``Jᵀ H J``: ``j (K*D, ...)``
    row-major, ``h (K(K+1)/2, ...)`` compact -> ``(D(D+1)/2, ...)``
    compact; batch dims broadcast, K, D <= 32. Launches the CUDA kernel
    on CUDA tensors, and runs the plain version on CPU tensors."""
    j, h, half = upcast_half(j, h)
    k = sym_dim(h.shape[0])
    if j.shape[0] % k:
        raise ValueError(f"j channel count {j.shape[0]} is not a multiple of K={k}")
    d = j.shape[0] // k
    require_domain("sym_matmul_cf", max(k, d), h.dtype, what="K, D")
    batch = torch.broadcast_shapes(j.shape[1:], h.shape[1:])
    j2, h2 = cf_flat(j, k * d, batch).t(), cf_flat(h, h.shape[0], batch).t()
    y = JhjFunction.apply(j2, h2, d, h2.is_cuda, True)
    return downcast(y.t().reshape(compact_size(d), *batch), half)


for _fn in (sym_matvec_cf, sym_addmatvec_cf, sym_submatvec_cf, sym_outer_cf,
            sym_matmul_cf):
    _fn.launches = 0
