"""CUDA compact-symmetric iterations (the fused matvec chain ``x <- A x +
c`` and the fused power iteration), with their plain PyTorch versions and
autograd.

``sym_matvec_chain_cf`` replaces the Pallas ``_matvec_chain_kernel`` and
``sym_maxeig_cf`` replaces ``_maxeig_kernel``
(``fastmath_tpu/kernels/sym_pallas.py``). Both kernels live in
``csrc/sym_iterate.cu``; one thread owns one problem and keeps its matrix
on chip for every step, and the source's header gives the tiers and what
bounds them.

Each wrapper launches its kernel on a CUDA tensor and runs its plain
version, which repeats the kernel's arithmetic in PyTorch in the same
term order, on a CPU tensor. ``sym_matvec_chain_cf.launches`` and
``sym_maxeig_cf.launches`` count kernel launches (the chain's backward
launches the chain kernel too), and nothing else. Operands are 2-D views,
as :mod:`._launch` describes.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..core.dtypes import downcast, upcast_half
from ..layouts.sym import compact_size, sym_to_full, tri_index
from ._launch import cf_prepare, check, empty, launch, operand
from .sym_products import sym_outer_sum

__all__ = ["sym_matvec_chain_cf", "sym_maxeig_cf", "matvec_chain_plain", "maxeig_plain",
           "maxeig_replay", "unit", "inv_scale", "MatvecChainFunction", "MaxeigFunction",
           "RENORM_MAX"]

_LIB = "sym_iterate"
#: largest number of matvecs between two renormalizations of the power
#: iteration (more could leave float32 range under the Gershgorin scale)
RENORM_MAX = 16


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic in PyTorch)
# ---------------------------------------------------------------------------


def _rows_matvec(A, x):
    """``A x`` for (B, n, n) and (B, n), each row summed over j left to
    right from the first term."""
    y = A[:, :, 0] * x[:, 0, None]
    for j in range(1, x.shape[1]):
        y = y + A[:, :, j] * x[:, j, None]
    return y


def matvec_chain_plain(mat, vec, add, iters):
    """Plain version of the chain kernel: ``mat`` (B, NN), ``vec`` (B, N),
    ``add`` (B, N) or None -> ``x_iters`` of ``x_{t+1} = A x_t + add``."""
    A = sym_to_full(mat, vec.shape[1])
    x = vec.clone()
    for _ in range(iters):
        x = _rows_matvec(A, x)
        if add is not None:
            x = x + add
    return x


def _guarded_rsqrt(nrm2):
    """1/sqrt(x) with 0 -> 0 (zero problems stay finite)."""
    safe = torch.where(nrm2 > 0, nrm2, torch.ones_like(nrm2))
    return torch.where(nrm2 > 0, torch.rsqrt(safe), torch.zeros_like(nrm2))


def _sum_in_order(terms):
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def _renorm(v):
    """``v`` times the guarded rsqrt of ``|v|^2``, summed in index order."""
    n = v.shape[1]
    return v * _guarded_rsqrt(_sum_in_order([v[:, i] * v[:, i] for i in range(n)]))[:, None]


def unit(v):
    """``v`` over its norm along the last axis, 0 where the norm is 0."""
    return v * _guarded_rsqrt((v * v).sum(dim=-1, keepdim=True))


def inv_scale(g):
    """1/g, or 0 where g = 0."""
    return torch.where(g > 0, 1.0 / torch.where(g > 0, g, torch.ones_like(g)),
                       torch.zeros_like(g))


def maxeig_plain(mat, vec, iters, renorm_every):
    """Plain version of the power-iteration kernel: ``mat`` (B, NN),
    ``vec`` (B, N) -> (B, 1 + N), ``mu`` then the unit vector. Scales A by
    its Gershgorin bound g (each row's |entries| summed left to right, the
    rows' maximum in order), renormalizes every ``renorm_every`` matvecs,
    then once more, and takes ``mu = (v . A v) * g``."""
    n = vec.shape[1]
    A = sym_to_full(mat, n)
    absA = A.abs()
    g = _sum_in_order([absA[:, 0, j] for j in range(n)])
    for i in range(1, n):
        g = torch.maximum(g, _sum_in_order([absA[:, i, j] for j in range(n)]))
    As = A * inv_scale(g)[:, None, None]
    v = _renorm(vec)
    for _ in range(iters // renorm_every):
        for _ in range(renorm_every):
            v = _rows_matvec(As, v)
        v = _renorm(v)
    for _ in range(iters % renorm_every):
        v = _rows_matvec(As, v)
    v = _renorm(v)
    w = _rows_matvec(As, v)
    mu = _sum_in_order([v[:, i] * w[:, i] for i in range(n)]) * g
    return torch.cat([mu[:, None], v], dim=1)


def maxeig_replay(mat, vec, iters):
    """The reference's ``_maxeig_replay`` (its VJP): the power iteration
    renormalized at every step, differentiable, with the Gershgorin bound
    g (diagonal first, then j != i) held constant. The dominant eigenvalue
    is 1-homogeneous in A, so g's own derivative terms cancel; holding it
    constant gives the exact pullback without the huge intermediate
    cotangent that 1/g would route through. (B, NN), (B, N) -> (B, 1 + N)."""
    n = vec.shape[1]

    def row(m, v, i):  # sum_j m_ij v_j, the diagonal term first
        return _sum_in_order([m[:, i] * v[:, i]] + [m[:, tri_index(i, j, n)] * v[:, j]
                                                    for j in range(n) if j != i])

    ones, absm = torch.ones_like(vec), mat.abs()
    g = row(absm, ones, 0)
    for i in range(1, n):
        g = torch.maximum(g, row(absm, ones, i))
    g = g.detach()
    ms = mat * inv_scale(g)[:, None]

    def mv(v):
        return torch.stack([row(ms, v, i) for i in range(n)], dim=1)

    v = unit(vec)
    for _ in range(iters):
        v = unit(mv(v))
    mu = (v * mv(v)).sum(dim=1) * g
    return torch.cat([mu[:, None], v], dim=1)


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
        lib.fm_sym_matvec_chain.argtypes = [i, i, i, ll, *(strided * 4), p]
        lib.fm_sym_maxeig.argtypes = [i, i, i, i, ll, *(strided * 3), p]
        for fn in (lib.fm_sym_matvec_chain, lib.fm_sym_maxeig):
            fn.restype = i
        lib.fm_error_string.argtypes = [i]
        lib.fm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch_matvec_chain(mat, vec, add, iters, cf_out=False):
    """Launch the chain kernel on CUDA tensors ``mat`` (B, NN), ``vec``
    and ``add`` (B, N; ``add`` may be None): ``x_iters``, (B, N), a
    transposed view of (N, B) if ``cf_out``."""
    n = vec.shape[-1]
    b = check(mat, n, ("mat", mat, compact_size(n)), ("vec", vec, n), ("add", add, n))
    if iters < 0:
        raise ValueError("iters must be >= 0")
    out = empty(vec, b, n, cf_out)
    launch(_library(), sym_matvec_chain_cf, "fm_sym_matvec_chain", mat, n, int(iters), b,
           *operand(mat), *operand(vec), *operand(add), *operand(out))
    return out


def launch_maxeig(mat, vec, iters, renorm_every, cf_out=False):
    """Launch the power-iteration kernel on CUDA tensors ``mat`` (B, NN),
    ``vec`` (B, N): (B, 1 + N), ``mu`` then the unit vector."""
    n = vec.shape[-1]
    b = check(mat, n, ("mat", mat, compact_size(n)), ("vec", vec, n))
    if iters < 0 or not 1 <= renorm_every <= RENORM_MAX:
        raise ValueError(f"iters must be >= 0 and renorm_every in 1..{RENORM_MAX}")
    out = empty(vec, b, n + 1, cf_out)
    launch(_library(), sym_maxeig_cf, "fm_sym_maxeig", mat, n, int(iters), int(renorm_every),
           b, *operand(mat), *operand(vec), *operand(out))
    return out


# ---------------------------------------------------------------------------
# autograd (the reference's custom VJPs)
# ---------------------------------------------------------------------------


class MatvecChainFunction(torch.autograd.Function):
    """Differentiable fused chain of 2-D operands: ``apply(mat, vec, add,
    iters, kernel, cf_out)`` (``add`` may be None); the kernel if
    ``kernel``, else the plain version."""

    @staticmethod
    def forward(ctx, mat, vec, add, iters, kernel, cf_out):
        if kernel:
            x = launch_matvec_chain(mat, vec, add, iters, cf_out)
        else:
            x = matvec_chain_plain(mat, vec, add, iters)
        ctx.save_for_backward(mat, vec, add)
        ctx.opts = (iters, kernel)
        return x

    @staticmethod
    def backward(ctx, g):
        # x_{t+1} = A x_t + c, A symmetric: g_t = A g_{t+1}, dA = sum_t
        # sym_outer_sum(g_{t+1}, x_t), dc = sum_t g_{t+1}, dvec = g_0. The
        # iterates are recomputed from ceil(sqrt(iters)) checkpoints, one
        # segment at a time, so the backward holds O(sqrt(iters)) batches
        # of vectors (all iters of them at 1M x 4, k = 128, would be 2 GB
        # in float32). Every step runs the chain kernel (or its plain
        # version): k steps from a checkpoint, or one step of A g.
        mat, vec, add = ctx.saved_tensors
        iters, kernel = ctx.opts
        run = launch_matvec_chain if kernel else matvec_chain_plain
        seg = max(1, math.isqrt(max(iters - 1, 0)) + 1)
        starts = list(range(0, iters, seg))
        checkpoints = [vec]
        for _ in starts[1:]:
            checkpoints.append(run(mat, checkpoints[-1], add, seg))
        g = g.contiguous()
        dmat = torch.zeros_like(mat)
        dadd = None if add is None else torch.zeros_like(add)
        for s0, x0 in zip(reversed(starts), reversed(checkpoints)):
            xs = [x0]
            for _ in range(s0 + 1, min(s0 + seg, iters)):
                xs.append(run(mat, xs[-1], add, 1))
            for x in reversed(xs):
                dmat = dmat + sym_outer_sum(g, x)
                if dadd is not None:
                    dadd = dadd + g
                g = run(mat, g, None, 1)
        return dmat, g, dadd, None, None, None


class MaxeigFunction(torch.autograd.Function):
    """Differentiable fused power iteration of 2-D operands: ``apply(mat,
    vec, iters, renorm_every, kernel, cf_out)`` -> (B, 1 + N)."""

    @staticmethod
    def forward(ctx, mat, vec, iters, renorm_every, kernel, cf_out):
        if kernel:
            y = launch_maxeig(mat, vec, iters, renorm_every, cf_out)
        else:
            y = maxeig_plain(mat, vec, iters, renorm_every)
        ctx.save_for_backward(mat, vec)
        ctx.iters = iters
        return y

    @staticmethod
    def backward(ctx, g):
        # the reference's VJP: autograd through the replay, renormalized at
        # every step (power iteration is scale-invariant, so both share
        # their limit, and at convergence the pullback of mu is v v^T);
        # plain PyTorch on the tensors' device, as the reference runs it
        # in XLA
        mat, vec = ctx.saved_tensors
        with torch.enable_grad():
            m, v = mat.detach().requires_grad_(), vec.detach().requires_grad_()
            y = maxeig_replay(m, v, ctx.iters)
            dm, dv = torch.autograd.grad(y, (m, v), g)
        return dm, dv, None, None, None, None


# ---------------------------------------------------------------------------
# channel-first wrappers (the counterparts of sym_pallas.sym_matvec_chain_cf
# and sym_maxeig_cf)
# ---------------------------------------------------------------------------


def sym_matvec_chain_cf(mat: torch.Tensor, vec: torch.Tensor, iters: int = 1,
                        add=None) -> torch.Tensor:
    r"""Channel-first fused iterated matvec: ``x_0 = vec``, ``x_{t+1} = A
    x_t + add``, returning ``x_iters``; ``mat (NN, ...)``, ``vec`` and
    ``add`` ``(N, ...)``, batch dims broadcast, N <= 32. The recurrence
    diverges where the spectral radius of A exceeds 1 (the caller scales,
    as in classical Richardson iteration). Launches the CUDA kernel on
    CUDA tensors, and runs the plain version on CPU tensors."""
    arrays = (mat, vec) if add is None else (mat, vec, add)
    *arrays, half = upcast_half(*arrays)
    if iters < 0:
        raise ValueError("iters must be >= 0")
    n, batch, flat = cf_prepare(*arrays, op="sym_matvec_chain_cf")
    a2 = flat[2] if add is not None else None
    y = MatvecChainFunction.apply(flat[0], flat[1], a2, int(iters), flat[0].is_cuda, True)
    return downcast(y.t().reshape(n, *batch), half)


def sym_maxeig_cf(mat: torch.Tensor, vec: torch.Tensor, iters: int = 32,
                  renorm_every: int = 8) -> torch.Tensor:
    """Channel-first fused batched power iteration: ``mat (NN, ...)``,
    start vectors ``vec (N, ...)`` -> ``(1 + N, ...)``, row 0 the Rayleigh
    quotient estimate of the dominant (largest-|λ|) eigenvalue, rows 1..
    the unit eigenvector estimate; batch dims broadcast, N <= 32.

    A one-time Gershgorin pre-scale keeps the iterates in range for up to
    ``renorm_every`` (1..16) matvecs between normalizations;
    ``renorm_every=1`` is textbook per-step normalization. Launches the
    CUDA kernel on CUDA tensors, and runs the plain version on CPU
    tensors."""
    mat, vec, half = upcast_half(mat, vec)
    if iters < 0:
        raise ValueError("iters must be >= 0")
    if not 1 <= int(renorm_every) <= RENORM_MAX:
        raise ValueError(f"renorm_every must be in 1..{RENORM_MAX}")
    n, batch, (m2, v2) = cf_prepare(mat, vec, op="sym_maxeig_cf")
    y = MaxeigFunction.apply(m2, v2, int(iters), int(renorm_every), m2.is_cuda, True)
    return downcast(y.t().reshape(n + 1, *batch), half)


for _fn in (sym_matvec_chain_cf, sym_maxeig_cf):
    _fn.launches = 0
