"""CUDA compact-symmetric solve and fused chain solve, with their plain
PyTorch versions and autograd.

``sym_solve_cf`` replaces the Pallas ``_solve_kernel`` and
``sym_solve_chain_cf`` replaces ``_solve_chain_kernel``
(``fastmath_tpu/kernels/sym_pallas.py``). Both kernels live in
``csrc/sym_solve.cu``; one thread owns one problem. The single solve at
N <= 4 is bound by device memory (it moves ``NN + 2N`` values for a few
hundred flops): it reads each operand once and keeps the cofactors and
the refinement step in registers. The chain is bound by arithmetic
(``iters`` solves per matrix read): it factors once and loops in
registers. See the source's header for the tiers.

Each wrapper launches its kernel on a CUDA tensor and runs its plain
version, which repeats the kernel's arithmetic in PyTorch, on a CPU
tensor. ``sym_solve_cf.launches`` and ``sym_solve_chain_cf.launches``
count kernel launches, and nothing else. Operands are 2-D views, as
:mod:`._launch` describes.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.dtypes import downcast, upcast_half
from ..layouts.sym import compact_size, sym_to_full
from ..ops.sym import _adjugate_apply, _cofactors, _entries, _prep_eps
from ._launch import (cf_prepare, check, empty, launch, operand, plu_factor,
                      plu_substitute, rolled_solve)
from .sym_products import sym_outer_sum

__all__ = ["sym_solve_cf", "sym_solve_chain_cf", "solve_plain", "chain_plain",
           "SolveFunction", "ChainFunction"]

_LIB = "sym_solve"


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic in PyTorch)
# ---------------------------------------------------------------------------


def _eps_tensor(eps, like):
    """``eps`` (a tuple of N floats) as a tensor on ``like``'s device; the
    upload does not wait for the work already queued on the stream."""
    if eps is None:
        return None
    return torch.tensor(eps, dtype=like.dtype).to(like.device, non_blocking=True)


def _dense(mat, n, eps):
    """(B, n, n) entry grid of compact ``mat`` (B, NN), eps on the diagonal."""
    A = sym_to_full(mat, n)  # a gathered copy
    if eps is not None:
        A.diagonal(dim1=1, dim2=2).add_(eps)
    return A


def _residual(A, v, x):
    """v - A x, summed diagonal first, then the other columns in order."""
    r = v - A.diagonal(dim1=1, dim2=2) * x
    for j in range(A.shape[1]):
        col = A[:, :, j] * x[:, j, None]
        col[:, j] = 0
        r = r - col
    return r


def _matvec_rows(M, x):
    """M x with each row summed left to right (M (B, n, n), x (B, n))."""
    acc = M[:, :, 0] * x[:, 0, None]
    for j in range(1, M.shape[2]):
        acc = acc + M[:, :, j] * x[:, j, None]
    return acc


def solve_plain(mat, vec, eps=None, refine=None):
    r"""Plain version of the solve kernel: ``mat`` (B, NN), ``vec``
    (B, N) -> ``A \ v`` (B, N); ``eps`` a tuple of N floats or None."""
    n = vec.shape[1]
    if refine is None:
        refine = 1 if n <= 4 else 0
    e = _eps_tensor(eps, mat)
    if n == 1:
        a = mat[:, 0] if e is None else mat[:, 0] + e[0]
        return vec / a[:, None]
    if n <= 4:
        E = _entries(mat, n)
        if e is not None:
            for i in range(n):
                E[i][i] = E[i][i] + e[i]
        v = [vec[:, j] for j in range(n)]
        adj, det = _cofactors(E, n)
        inv_det = 1.0 / det
        x = [y * inv_det for y in _adjugate_apply(adj, v)]
        for _ in range(refine):
            r = []
            for i in range(n):
                acc = v[i] - E[i][i] * x[i]
                for j in range(n):
                    if j != i:
                        acc = acc - E[i][j] * x[j]
                r.append(acc)
            dx = _adjugate_apply(adj, r)
            x = [xi + d * inv_det for xi, d in zip(x, dx)]
        return torch.stack(x, dim=1)
    A = _dense(mat, n, e)
    if n <= 8:
        LU, piv, inv_d = plu_factor(A)
        x = plu_substitute(LU, piv, inv_d, vec)
        for _ in range(refine):
            x = x + plu_substitute(LU, piv, inv_d, _residual(A, vec, x))
        return x
    rhs = vec[:, :, None]
    if refine:
        eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape[0], n, n)
        rhs = torch.cat([rhs, eye], dim=2)
    X = rolled_solve(A, rhs)
    x = X[:, :, 0]
    for _ in range(refine):
        x = x + _matvec_rows(X[:, :, 1:], _residual(A, vec, x))
    return x


def chain_plain(mat, vec, add, eps, iters):
    r"""Plain version of the chain kernel: ``x <- A \ x + add``, ``iters``
    times from ``x = vec``, factoring once (``add`` may be None)."""
    n = vec.shape[1]
    e = _eps_tensor(eps, mat)
    c = torch.zeros_like(vec) if add is None else add
    x = vec
    if n == 1:
        a = mat[:, 0] if e is None else mat[:, 0] + e[0]
        inv = (1.0 / a)[:, None]
        for _ in range(iters):
            x = x * inv + c
        return x.clone()
    if n <= 4:
        E = _entries(mat, n)
        if e is not None:
            for i in range(n):
                E[i][i] = E[i][i] + e[i]
        adj, det = _cofactors(E, n)
        inv_det = 1.0 / det
        xs = [x[:, j] for j in range(n)]
        for _ in range(iters):
            xs = [y * inv_det + c[:, i]
                  for i, y in enumerate(_adjugate_apply(adj, xs))]
        return torch.stack(xs, dim=1)
    A = _dense(mat, n, e)
    if n <= 8:
        LU, piv, inv_d = plu_factor(A)
        for _ in range(iters):
            x = plu_substitute(LU, piv, inv_d, x) + c
        return x.clone()
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape[0], n, n)
    inv = rolled_solve(A, eye)
    for _ in range(iters):
        x = _matvec_rows(inv, x) + c
    return x.clone()


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
        lib.fm_sym_solve.argtypes = [i, i, ll, *(strided * 3), p, i, p]
        lib.fm_sym_solve.restype = i
        lib.fm_sym_solve_chain.argtypes = [i, i, ll, *(strided * 4), p, i, p]
        lib.fm_sym_solve_chain.restype = i
        lib.fm_error_string.argtypes = [i]
        lib.fm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch_solve(mat, vec, eps=None, refine=0, cf_out=False):
    """Launch the solve kernel on CUDA tensors ``mat`` (B, NN), ``vec``
    (B, N); returns (B, N), a transposed view of (N, B) if ``cf_out``."""
    n = vec.shape[-1]
    b = check(mat, n, ("mat", mat, compact_size(n)), ("vec", vec, n))
    out = empty(vec, b, n, cf_out)
    e = _eps_tensor(eps, mat)
    launch(_library(), sym_solve_cf, "fm_sym_solve", mat, n, b, *operand(mat),
           *operand(vec), *operand(out), None if e is None else e.data_ptr(),
           int(refine))
    return out


def launch_chain(mat, vec, add, eps, iters, cf_out=False):
    """Launch the chain kernel on CUDA tensors (``add`` may be None)."""
    n = vec.shape[-1]
    b = check(mat, n, ("mat", mat, compact_size(n)), ("vec", vec, n), ("add", add, n))
    out = empty(vec, b, n, cf_out)
    e = _eps_tensor(eps, mat)
    launch(_library(), sym_solve_chain_cf, "fm_sym_solve_chain", mat, n, b,
           *operand(mat), *operand(vec), *operand(add), *operand(out),
           None if e is None else e.data_ptr(), int(iters))
    return out


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class SolveFunction(torch.autograd.Function):
    """Differentiable solve of 2-D operands: ``apply(mat, vec, eps,
    refine, kernel, cf_out)``; the kernel if ``kernel``, else the plain
    version."""

    @staticmethod
    def forward(ctx, mat, vec, eps, refine, kernel, cf_out):
        if kernel:
            x = launch_solve(mat, vec, eps, refine, cf_out)
        else:
            x = solve_plain(mat, vec, eps, refine)
        ctx.save_for_backward(mat, x)
        ctx.opts = (eps, refine, kernel)
        return x

    @staticmethod
    def backward(ctx, g):
        # x = A^-1 v, A symmetric: dv = A^-1 g, dA = -dv x^T (compacted)
        mat, x = ctx.saved_tensors
        eps, refine, kernel = ctx.opts
        dv = SolveFunction.apply(mat, g.contiguous(), eps, refine, kernel, False)
        return -sym_outer_sum(dv, x), dv, None, None, None, None


class ChainFunction(torch.autograd.Function):
    """Differentiable fused chain of 2-D operands: ``apply(mat, vec, add,
    eps, iters, kernel, cf_out)`` (``add`` may be None)."""

    @staticmethod
    def forward(ctx, mat, vec, add, eps, iters, kernel, cf_out):
        if kernel:
            x = launch_chain(mat, vec, add, eps, iters, cf_out)
        else:
            x = chain_plain(mat, vec, add, eps, iters)
        ctx.save_for_backward(mat, vec, add)
        ctx.opts = (eps, iters, kernel)
        return x

    @staticmethod
    def backward(ctx, g):
        # replay the chain as `iters` differentiable solves (refine=0)
        mat, vec, add = ctx.saved_tensors
        eps, iters, kernel = ctx.opts
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (mat, vec, add)
                   if t is not None]
            m, x = ins[0], ins[1]
            for _ in range(iters):
                x = SolveFunction.apply(m, x, eps, 0, kernel, False)
                if add is not None:
                    x = x + ins[2]
            grads = torch.autograd.grad(x, ins, g, allow_unused=True)
        grads = [torch.zeros_like(t) if gr is None else gr
                 for t, gr in zip(ins, grads)]
        da = grads[2] if add is not None else None
        return grads[0], grads[1], da, None, None, None, None


# ---------------------------------------------------------------------------
# channel-first wrappers (the counterparts of sym_pallas.sym_solve_cf /
# sym_solve_chain_cf)
# ---------------------------------------------------------------------------


def sym_solve_cf(
    mat: torch.Tensor,
    vec: torch.Tensor,
    eps=None,
    refine: Optional[int] = None,
) -> torch.Tensor:
    r"""Channel-first compact-symmetric solve ``A \ v``: ``mat (NN, ...)``,
    ``vec (N, ...)`` -> ``(N, ...)``; batch dims broadcast.

    ``eps`` is added to the diagonal; ``refine`` adds iterative
    refinement steps (default 1 for N <= 4, 0 above). Launches the CUDA
    kernel on CUDA tensors, and runs the plain version on CPU tensors.
    """
    mat, vec, half = upcast_half(mat, vec)
    n, batch, (m2, v2) = cf_prepare(mat, vec, op="sym_solve_cf")
    if refine is None:
        refine = 1 if n <= 4 else 0
    x = SolveFunction.apply(m2, v2, _prep_eps(eps, n), int(refine), m2.is_cuda, True)
    return downcast(x.t().reshape(n, *batch), half)


sym_solve_cf.launches = 0


def sym_solve_chain_cf(
    mat: torch.Tensor,
    vec: torch.Tensor,
    iters: int = 1,
    add: Optional[torch.Tensor] = None,
    eps=None,
) -> torch.Tensor:
    r"""Channel-first fused iterated solve: ``x_0 = vec``,
    ``x_{t+1} = A \ x_t + add``, returning ``x_iters`` ``(N, ...)``.

    One launch runs the whole chain, reading A once and factoring it
    once. Launches the CUDA kernel on CUDA tensors, and runs the plain
    version on CPU tensors.
    """
    if iters < 0:
        raise ValueError("iters must be >= 0")
    arrays = (mat, vec) if add is None else (mat, vec, add)
    *arrays, half = upcast_half(*arrays)
    n, batch, flat = cf_prepare(*arrays, op="sym_solve_chain_cf")
    a2 = flat[2] if add is not None else None
    x = ChainFunction.apply(flat[0], flat[1], a2, _prep_eps(eps, n), int(iters),
                            flat[0].is_cuda, True)
    return downcast(x.t().reshape(n, *batch), half)


sym_solve_chain_cf.launches = 0
