"""Simplex utilities: softmax / log_softmax / logsumexp / logit /
softmax_lse with **implicit class** conventions.

PyTorch counterpart of ``fastmath_tpu/ops/simplex.py``: the same names and
semantics, as plain torch ops on the input's device (the JAX package has
no kernel here). Discrete probabilities live on a K-1-dimensional simplex,
so one class ("the implicit class", default index 0) may be represented
implicitly: its logit is fixed to zero, or its probability to ``1 -
sum(others)``. Every function takes ``implicit`` as one bool or an
``(input_implicit, output_implicit)`` pair, plus ``implicit_index``.

* ``logsumexp`` and the softmax core are ``torch.autograd.Function``s
  that save only their input, resp. only the probabilities; the backward
  of both the explicit and the implicit softmax is ``p * (g - <g, p>)``.
* Class insertion and removal are slicing and concatenation, which
  autograd differentiates exactly.
* ``softmax_lse`` returns the softmax and the (weighted) total log-sum-exp
  accumulated in float64; it appends or drops the **last** class, not
  ``implicit_index``.
* Logs are ``torch.log`` (the JAX package's ``core/accmath.py`` works
  around the TPU's inaccurate float32 ``log``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.shapes import ensure_tuple

__all__ = [
    "logsumexp",
    "softmax",
    "log_softmax",
    "logit",
    "softmax_lse",
]


def _norm_index(index: int, k: int) -> int:
    """Normalize an implicit-class index against axis length k."""
    if index < 0:
        index += k
    if not 0 <= index < k:
        raise ValueError(f"implicit_index {index} out of range for {k} classes")
    return index


def _insert_class(x, value, dim: int, index: int):
    """Insert a channel (scalar or tensor broadcastable to one slice) at
    ``index`` along ``dim``."""
    dim = dim % x.ndim
    index = _norm_index(index, x.shape[dim] + 1)
    shape = list(x.shape)
    shape[dim] = 1
    value = torch.as_tensor(value, dtype=x.dtype, device=x.device).expand(shape)
    return torch.cat([x.narrow(dim, 0, index), value,
                      x.narrow(dim, index, x.shape[dim] - index)], dim=dim)


def _drop_class(x, dim: int, index: int):
    """Drop the channel at ``index`` along ``dim``."""
    dim = dim % x.ndim
    k = x.shape[dim]
    index = _norm_index(index, k)
    return torch.cat([x.narrow(dim, 0, index), x.narrow(dim, index + 1, k - index - 1)], dim=dim)


def _max_exp_sum(x, dim: int, implicit: bool):
    """(m, e, s): the shift, exp(x - m) and its sum over ``dim`` (with the
    hidden zero logit when ``implicit``)."""
    m = torch.amax(x, dim=dim, keepdim=True)
    if implicit:
        m = torch.clamp(m, min=0.0)
    e = torch.exp(x - m)
    s = torch.sum(e, dim=dim, keepdim=True)
    if implicit:
        s = s + torch.exp(-m)
    return m, e, s


class _LogSumExp(torch.autograd.Function):
    """log-sum-exp over ``dim`` (kept); saves only its input and
    recomputes the softmax in the backward."""

    @staticmethod
    def forward(ctx, x, dim, implicit):
        ctx.save_for_backward(x)
        ctx.dim, ctx.implicit = dim, implicit
        m, _, s = _max_exp_sum(x, dim, implicit)
        return m + torch.log(s)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _Softmax.apply(x, ctx.dim, ctx.implicit) * g, None, None


class _Softmax(torch.autograd.Function):
    """Probabilities of the *explicit* channels. With ``implicit`` the
    normalizer includes the hidden zero-logit class, so the output sums to
    < 1 and the hidden probability is ``1 - sum``. Saves only the
    probabilities."""

    @staticmethod
    def forward(ctx, x, dim, implicit):
        _, e, s = _max_exp_sum(x, dim, implicit)
        p = e / s
        ctx.save_for_backward(p)
        ctx.dim = dim
        return p

    @staticmethod
    def backward(ctx, g):
        # Jacobian of both explicit and implicit softmax: diag(p) - p p^T
        (p,) = ctx.saved_tensors
        dot = torch.sum(g * p, dim=ctx.dim, keepdim=True)
        return p * (g - dot), None, None


def logsumexp(input, dim: int = -1, keepdim: bool = False, implicit: bool = False):
    """Stable log-sum-exp along ``dim``; ``implicit=True`` folds in a
    hidden zero-logit class."""
    out = _LogSumExp.apply(torch.as_tensor(input), dim, bool(implicit))
    return out if keepdim else out.squeeze(dim)


def softmax(input, dim: int = -1, implicit=False, implicit_index: int = 0):
    """Safe softmax with implicit-class handling.

    ``implicit = (in_implicit, out_implicit)`` (one bool serves both): an
    implicit input has a hidden zero-logit class; an implicit output
    drops the class at ``implicit_index``.
    """
    implicit_in, implicit_out = ensure_tuple(implicit, 2)
    p = _Softmax.apply(torch.as_tensor(input), dim, bool(implicit_in))
    if implicit_in and not implicit_out:
        p = _insert_class(p, 1.0 - torch.sum(p, dim=dim, keepdim=True), dim, implicit_index)
    elif implicit_out and not implicit_in:
        p = _drop_class(p, dim, implicit_index)
    return p


def log_softmax(input, dim: int = -1, implicit=False, implicit_index: int = 0):
    """Log-softmax with implicit-class handling."""
    x = torch.as_tensor(input)
    implicit_in, implicit_out = ensure_tuple(implicit, 2)
    lse = _LogSumExp.apply(x, dim, bool(implicit_in))
    if implicit_in and not implicit_out:
        return _insert_class(x, 0.0, dim, implicit_index) - lse
    if implicit_out and not implicit_in:
        return _drop_class(x, dim, implicit_index) - lse
    return x - lse


def logit(input, dim: int = -1, implicit=False, implicit_index: int = 0):
    r"""(Multiclass) logit, the inverse of :func:`softmax`:
    ``logit(p)_k = log(p_k) - log(p_ref)`` with the reference channel at
    ``implicit_index`` (the hidden probability is clamped at ``1e-8``)."""
    x = torch.as_tensor(input)
    implicit_in, implicit_out = ensure_tuple(implicit, 2)
    if implicit_in:
        hidden = 1.0 - torch.sum(x, dim=dim, keepdim=True)
        out = torch.log(x) - torch.log(torch.clamp(hidden, min=1e-8))
        if not implicit_out:
            out = _insert_class(out, 0.0, dim, implicit_index)
        return out
    logx = torch.log(x)
    axis = dim % x.ndim
    ref = logx.narrow(axis, _norm_index(implicit_index, x.shape[axis]), 1)
    if implicit_out:
        logx = _drop_class(logx, dim, implicit_index)
    return logx - ref


def softmax_lse(input, dim: int = -1, weights: Optional[torch.Tensor] = None,
                implicit=False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused softmax + total (weighted) log-sum-exp, the EM-style model
    evidence accumulator. Returns ``(softmax, lse_total)`` where
    ``lse_total`` is a float64 scalar sum over all positions; the implicit
    class is the **last** one, not ``implicit_index``."""
    x = torch.as_tensor(input)
    implicit_in, implicit_out = ensure_tuple(implicit, 2)
    m, e, s = _max_exp_sum(x, dim, bool(implicit_in))
    p = e / s
    lse = m + torch.log(s)
    if weights is not None:
        lse = lse * torch.as_tensor(weights, device=x.device)
    lse_total = torch.sum(lse, dtype=torch.float64)
    if implicit_in and not implicit_out:
        p = torch.cat([p, 1.0 - torch.sum(p, dim=dim, keepdim=True)], dim=dim)
    elif implicit_out and not implicit_in:
        p = p.narrow(dim, 0, p.shape[dim] - 1)
    return p, lse_total
