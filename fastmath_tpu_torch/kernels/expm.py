"""CUDA batched matrix exponential (scaling and squaring, Taylor-Horner
core), with its plain PyTorch version and autograd.

Two kernels of ``csrc/expm.cu`` replace the Pallas ``_expm_kernel``
(d <= 8) and ``_expm_rolled_kernel`` (9 <= d <= 32) of
``fastmath_tpu/kernels/expm_pallas.py``: ``expm_unrolled`` runs one thread
a problem up to :data:`UNROLL_MAX` (by dtype), the problems staged through
shared memory in tiles, the matrices in registers to d = 6 and Y in the
thread's shared region above; ``expm_warp`` a group of 16 or 32 lanes a
problem above, the matrices in shared memory and each lane a register
block of every product; the source's header gives the design and what
bounds it.
Each problem squares exactly its own s times.

Entry points:

* :func:`expm_cf`, the counterpart's channel-first contract: ``(d*d, ...)``
  row-major in, ``(d*d, ...)`` out, real d <= 32, differentiable;
* :class:`ExpmFunction`, what ``ops.lie.expm`` calls: batch-major
  ``(B, d, d)`` read through its strides, with the Mathias backward (the
  top-right block of ``expm([[Xᵀ, G], [0, Xᵀ]])``), which launches the
  kernel on the 2d x 2d block while 2d <= 32;
* :func:`launch_expm` and :func:`expm_plain`.

Each launches a kernel on a CUDA tensor and runs :func:`expm_plain` on a
CPU tensor. ``expm_unrolled.launches`` and ``expm_warp.launches`` count
the launches of each kernel, and nothing else.
"""
from __future__ import annotations

import ctypes
import math
import types

import torch

from ..core.dtypes import downcast, upcast_half
from ._launch import MAX_N, cf_flat, empty, launch, require_domain

__all__ = ["expm_cf", "expm_plain", "launch_expm", "ExpmFunction", "expm_unrolled",
           "expm_warp", "tier", "squaring_counts", "UNROLL_MAX", "SQUARINGS_MAX"]

_LIB = "expm"
#: d up to this runs the one-thread tier (``expm_unroll_max`` of
#: ``csrc/expm.cu``), by dtype; above, the warp tier
UNROLL_MAX = {torch.float32: 8, torch.float64: 8}
SQUARINGS_MAX = 20
_ORDER_F32 = 9
_ORDER_F64 = 16

#: launch counts of the two kernels of ``csrc/expm.cu``
expm_unrolled = types.SimpleNamespace(launches=0)
expm_warp = types.SimpleNamespace(launches=0)


def taylor_order(dtype) -> int:
    """Order of the Taylor core: 16 in double precision, 9 otherwise
    (truncation theta^(m+1)/(m+1)! at theta = 0.5)."""
    eps = torch.finfo(dtype).eps
    return _ORDER_F64 if eps < 1e-10 else _ORDER_F32


def tier(d: int, dtype) -> str:
    """Name of the kernel that serves size d in ``dtype``."""
    return "expm_unrolled" if d <= UNROLL_MAX[dtype] else "expm_warp"


# ---------------------------------------------------------------------------
# plain version (the kernels' arithmetic in PyTorch)
# ---------------------------------------------------------------------------


def squaring_counts(X: torch.Tensor) -> torch.Tensor:
    """Each problem's squaring count s = clip(ceil(log2(max(|X|_1, 1e-30) /
    0.5)), 0, 20), |X|_1 the largest column sum of |x_ij|, each column
    summed over i in order (as the kernels do); also the operation count
    of a run, for its bound."""
    ax = X.abs()
    col = ax[..., 0, :]
    for i in range(1, X.shape[-1]):
        col = col + ax[..., i, :]
    norm = col.amax(dim=-1)
    s = torch.ceil(torch.log2(torch.clamp(norm, min=1e-30) / 0.5))
    return torch.clamp(s, 0, SQUARINGS_MAX)


def expm_plain(X: torch.Tensor, squarings=None) -> torch.Tensor:
    """Scaling-and-squaring ``expm`` of ``(..., d, d)``, real or complex: the
    kernels' arithmetic in PyTorch, and ``ops.lie._expm_core``.

    Y = X 2^-s, R = I + Y / order, R = I + (Y R) / m for m = order - 1 .. 1
    (each division a product by the reciprocal), then each problem squares
    R exactly its own s times (a masked pass per squaring).

    ``squarings`` is the number of masked passes: ``None`` stops at the
    largest s of the batch (one read of it on the host), as the kernels
    stop each problem at its own; an int runs that many (the reference's
    fixed 20 passes, which ``torch.func`` transforms need, since they
    cannot read a value on the host). Both give the same values. Only
    ``torch.matmul`` and elementwise ops: it is differentiable by
    autograd and by ``torch.func``.
    """
    d = X.shape[-1]
    rdt = X.real.dtype if X.is_complex() else X.dtype
    s = squaring_counts(X)
    Y = X * torch.exp2(-s)[..., None, None].to(X.dtype)
    order = taylor_order(rdt)
    eye = torch.eye(d, dtype=X.dtype, device=X.device)
    R = eye + Y * (1.0 / order)
    for m in range(order - 1, 0, -1):
        R = eye + torch.matmul(Y, R) * (1.0 / m)
    if squarings is None:  # NaN input has s = NaN and squares no time
        squarings = int(torch.nan_to_num(s, nan=0.0).max().item()) if s.numel() else 0
    for i in range(squarings):
        R = torch.where((i < s)[..., None, None], torch.matmul(R, R), R)
    return R


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
        lib.fm_expm.argtypes = [i, i, ll, p, ll, ll, ll, p, ll, ll, p]
        lib.fm_expm.restype = i
        lib.fm_error_string.argtypes = [i]
        lib.fm_error_string.restype = ctypes.c_char_p
        lib.fm_expm_unroll_max.argtypes = [i]
        lib.fm_expm_unroll_max.restype = i
        for code, dtype in enumerate((torch.float32, torch.float64)):
            if lib.fm_expm_unroll_max(code) != UNROLL_MAX[dtype]:
                raise RuntimeError(f"csrc/expm.cu serves d <= {lib.fm_expm_unroll_max(code)} in its "
                                   f"one-thread tier for {dtype}; UNROLL_MAX says "
                                   f"{UNROLL_MAX[dtype]}")
        _lib = lib
    return _lib


def launch_expm(a: torch.Tensor, cf_out: bool = False) -> torch.Tensor:
    """Launch on a CUDA tensor ``a`` (B, d, d) of any strides: ``expm`` of
    each problem, (B, d, d) contiguous, or a view of a channel-first
    (d*d, B) tensor if ``cf_out``."""
    if not a.is_cuda:
        raise ValueError(f"the CUDA kernel needs CUDA tensors (got {a.device})")
    b, d = a.shape[0], a.shape[-1]
    require_domain("the expm kernel", d, a.dtype, "d")
    out = empty(a, b, d * d, cf_out)
    if b == 0:  # nothing to launch
        return out.reshape(b, d, d)
    counter = expm_unrolled if tier(d, a.dtype) == "expm_unrolled" else expm_warp
    launch(_library(), counter, "fm_expm", a, d, b, a.data_ptr(), *a.stride(),
           out.data_ptr(), *out.stride())
    return out.reshape(b, d, d)


# ---------------------------------------------------------------------------
# autograd (the reference's Mathias VJP, ``expm_pallas.py:190-226``)
# ---------------------------------------------------------------------------


class ExpmFunction(torch.autograd.Function):
    """Differentiable ``expm`` of batch-major ``(B, d, d)``: ``apply(x,
    kernel)``, the kernel if ``kernel``, else the plain version. The
    backward is the top-right block of ``expm([[Xᵀ, G], [0, Xᵀ]])``: through
    this same Function (so the kernel on the card) while 2d <= 32, through
    the plain version beyond; either way differentiable again."""

    @staticmethod
    def forward(ctx, x, kernel):
        ctx.save_for_backward(x)
        ctx.kernel = kernel
        return launch_expm(x) if kernel else expm_plain(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        d = x.shape[-1]
        xt = x.mT.to(g.dtype)
        blk = torch.cat([torch.cat([xt, g], dim=-1),
                         torch.cat([torch.zeros_like(xt), xt], dim=-1)], dim=-2)
        if 2 * d <= MAX_N:
            e = ExpmFunction.apply(blk, ctx.kernel)
        else:
            e = expm_plain(blk)
        return e[..., :d, d:], None


# ---------------------------------------------------------------------------
# channel-first wrapper (the counterpart of expm_pallas.expm_cf)
# ---------------------------------------------------------------------------


def expm_cf(mat: torch.Tensor) -> torch.Tensor:
    """Channel-first batched matrix exponential ``(d*d, ...) -> (d*d,
    ...)``: row-major channels (entry (i, j) on channel ``i*d + j``), real
    d <= 32, batch dims as given. Launches the CUDA kernel on CUDA tensors
    (read in place through their strides, written channel-first) and runs
    the plain version on CPU tensors. Differentiable (Mathias backward).
    bf16/f16 compute in float32 and round once on output."""
    (mat, half) = upcast_half(mat)
    d = math.isqrt(mat.shape[0])
    if d * d != mat.shape[0] or d > MAX_N:
        raise ValueError(f"expm_cf expects (d*d, ...) rows with d <= {MAX_N}; "
                         f"got {mat.shape[0]} channels")
    require_domain("expm_cf", d, mat.dtype, "d")
    batch = mat.shape[1:]
    x = cf_flat(mat, d * d, batch).t().reshape(-1, d, d)
    y = ExpmFunction.apply(x, x.is_cuda)
    return downcast(y.reshape(-1, d * d).t().reshape(d * d, *batch), half)
