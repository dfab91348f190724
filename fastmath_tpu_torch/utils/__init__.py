"""General helpers: ``ensure_list``, ``slice_tensor`` /
``fast_slice_tensor``, ``cumprod``, ``sub2ind`` / ``ind2sub``, ``eps``,
``broadcast_backward``.

PyTorch counterpart of ``fastmath_tpu/utils/__init__.py``. The AMP
decorators ``custom_fwd`` / ``custom_bwd`` are no-ops, as in the JAX
package: the ops here choose their compute dtype themselves.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.dtypes import eps
from ..core.shapes import ensure_tuple, ind2sub, sub2ind

__all__ = [
    "ensure_list",
    "ensure_tuple",
    "fast_slice_tensor",
    "slice_tensor",
    "cumprod",
    "sub2ind",
    "ind2sub",
    "eps",
    "broadcast_backward",
    "custom_fwd",
    "custom_bwd",
]


def custom_fwd(fn):
    """No-op AMP decorator."""
    return fn


def custom_bwd(fn):
    """No-op AMP decorator."""
    return fn


def ensure_list(x, n: Optional[int] = None) -> list:
    """Make ``x`` a list; if ``n`` is given, pad with its last element or
    truncate to length n."""
    return list(ensure_tuple(x, n))


def fast_slice_tensor(x, index, dim: int = -1):
    """Index a single dimension with an int or a slice."""
    x = torch.as_tensor(x)
    idx = [slice(None)] * x.ndim
    idx[dim] = index
    return x[tuple(idx)]


def slice_tensor(x, index, dim=None):
    """Index one or several dimensions with ints or slices (by default the
    last ``len(index)`` dimensions)."""
    x = torch.as_tensor(x)
    if dim is None:
        index = ensure_tuple(index)
        dim = tuple(range(-len(index), 0))
    dims = ensure_tuple(dim)
    indices = ensure_tuple(index, len(dims))
    idx = [slice(None)] * x.ndim
    for d, i in zip(dims, indices):
        idx[d] = i
    return x[tuple(idx)]


def cumprod(sequence, reverse: bool = False, exclusive: bool = False) -> list:
    """Cumulative product of a python sequence."""
    seq = list(sequence)
    if reverse:
        seq = seq[::-1]
    out = []
    acc = 1
    for v in seq:
        if exclusive:
            out.append(acc)
            acc = acc * v
        else:
            acc = acc * v
            out.append(acc)
    if reverse:
        out = out[::-1]
    return out


def broadcast_backward(grad, shape) -> torch.Tensor:
    """Sum-reduce a gradient over broadcast dimensions so it matches
    ``shape``."""
    grad = torch.as_tensor(grad)
    shape = tuple(shape)
    extra = grad.ndim - len(shape)
    if extra:
        grad = torch.sum(grad, dim=tuple(range(extra)))
    axes = tuple(i for i, (g, s) in enumerate(zip(grad.shape, shape)) if s == 1 and g != 1)
    if axes:
        grad = torch.sum(grad, dim=axes, keepdim=True)
    return grad
