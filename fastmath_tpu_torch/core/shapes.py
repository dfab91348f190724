"""Shape and index helpers shared across ops.

PyTorch counterpart of ``fastmath_tpu/core/shapes.py``: the same names and
semantics. ``ind2sub`` / ``sub2ind`` work on tensors of flat indices (the
reductions' ``return_indices`` path); the rest is static shape arithmetic.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "ensure_tuple",
    "normalize_axes",
    "sub2ind",
    "ind2sub",
    "broadcast_batch_shapes",
]


def ensure_tuple(x, n: int | None = None) -> tuple:
    """Make ``x`` a tuple; if ``n`` is given, pad with its last element or
    truncate to length n. A tensor or array of one or more dimensions
    becomes the tuple of its values."""
    if isinstance(x, (list, tuple)):
        x = tuple(x)
    elif isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim > 0:
        x = tuple(x.tolist())
    else:
        x = (x,)
    if n is not None:
        if len(x) == 0:
            raise ValueError("cannot cycle an empty sequence")
        if len(x) < n:
            x = x + (x[-1],) * (n - len(x))
        elif len(x) > n:
            x = x[:n]
    return x


def normalize_axes(axes, ndim: int) -> Tuple[int, ...]:
    """Canonicalize an int-or-sequence ``axes`` argument to a sorted tuple
    of unique non-negative axes."""
    if axes is None:
        return tuple(range(ndim))
    axes = ensure_tuple(axes)
    out = []
    for ax in axes:
        ax = int(ax)
        if ax < 0:
            ax += ndim
        if not 0 <= ax < ndim:
            raise ValueError(f"axis {ax} out of range for ndim {ndim}")
        out.append(ax)
    if len(set(out)) != len(out):
        raise ValueError(f"duplicate axes in {axes}")
    return tuple(sorted(out))


def _row_major_strides(shape: Sequence[int]) -> Tuple[int, ...]:
    strides = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * shape[i + 1]
    return tuple(strides)


def sub2ind(subs, shape: Sequence[int]):
    """Convert multi-indices (stacked along the first axis of ``subs``, or
    a sequence of tensors) into row-major flat indices."""
    strides = _row_major_strides(shape)
    parts = subs if isinstance(subs, (list, tuple)) else [subs[i] for i in range(subs.shape[0])]
    if len(parts) != len(shape):
        raise ValueError("number of index arrays must match len(shape)")
    flat = 0
    for sub, stride in zip(parts, strides):
        flat = flat + torch.as_tensor(sub) * stride
    return flat


def ind2sub(flat, shape: Sequence[int]):
    """Convert row-major flat indices to multi-indices, stacked along a new
    leading axis (shape ``(len(shape), *flat.shape)``)."""
    rem = torch.as_tensor(flat)
    subs = []
    for stride in _row_major_strides(shape):
        subs.append(torch.div(rem, stride, rounding_mode="floor"))
        rem = rem % stride
    return torch.stack(subs, dim=0)


def broadcast_batch_shapes(*shapes: Sequence[int]) -> Tuple[int, ...]:
    """NumPy-style broadcast of batch shapes (static)."""
    return tuple(torch.broadcast_shapes(*[tuple(s) for s in shapes]))
