"""NaN-omitting multi-dim reductions with keepdim / return_indices.

PyTorch counterpart of ``fastmath_tpu/ops/reduce.py``: ``min max nanmin
nanmax median sum nansum mean nanmean var nanvar std nanstd`` with the
uniform API ``fn(input, dim=None, keepdim=False, omitnan=False,
inplace=False, out=None)`` (+ ``return_indices`` for the picking
reductions, + ``unbiased`` / ``dtype`` for the moments). Plain torch ops on
the input's device: the JAX package has no kernel here.

* ``dim`` is one dimension or several. ``dim=None`` reduces everything and
  returns the value alone, also with ``return_indices=True``.
* ``return_indices`` collapses the reduced dims into one, takes the flat
  argmin / argmax / median position and converts it with
  :func:`fastmath_tpu_torch.core.ind2sub`: indices come back stacked in
  the **last** axis, ``(..., len(dim))``, that axis dropped for a scalar
  ``dim``.
* NaN handling is masked ``torch.where``: ``nanmax`` / ``nanmin`` mask NaN
  to -inf / +inf first, so an all-NaN slice gives -inf / +inf.
* ``median`` always omits NaN and returns the *lower* median: the k-th
  entry, k = (count - 1) // 2, of a **stable** sort with NaN masked to
  +inf, so ties give the first position; an all-NaN slice gives NaN.
* ``nanvar`` is ``E[x^2] - E[x]^2`` over the non-NaN entries, times
  ``w / (w - 1)`` when ``unbiased``.
* ``mean`` and ``var`` of an integer tensor compute in
  :func:`fastmath_tpu_torch.core.as_float` of its dtype.
* ``inplace`` and ``out`` are accepted and ignored, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtypes import as_float
from ..core.shapes import ensure_tuple, ind2sub

__all__ = [
    "min",
    "max",
    "nanmin",
    "nanmax",
    "median",
    "sum",
    "nansum",
    "mean",
    "nanmean",
    "var",
    "nanvar",
    "std",
    "nanstd",
]


def _canon_axes(dim, ndim):
    scalar = not isinstance(dim, (list, tuple, np.ndarray))
    axes = tuple(d if d >= 0 else ndim + d for d in ensure_tuple(dim))
    for d in axes:
        if not 0 <= d < ndim:
            raise ValueError(f"dim {d} out of range for ndim {ndim}")
    return axes, scalar


def _axes_or_none(dim, ndim):
    return None if dim is None else _canon_axes(dim, ndim)[0]


def _collapse_last(x, axes):
    """Move ``axes`` to the end and collapse them into one axis; returns
    (collapsed, keptshape, redshape)."""
    keep = tuple(d for d in range(x.ndim) if d not in axes)
    keptshape = tuple(1 if d in axes else x.shape[d] for d in range(x.ndim))
    redshape = tuple(x.shape[d] for d in axes)
    x = x.permute(keep + axes).reshape(tuple(x.shape[d] for d in keep) + (-1,))
    return x, keptshape, redshape


def _indices(flat_idx, keepdim, keptshape, redshape, scalar):
    """Flat positions in the collapsed axis -> indices stacked last."""
    idx = torch.movedim(ind2sub(flat_idx, redshape), 0, -1)
    if keepdim:
        idx = idx.reshape(keptshape + (len(redshape),))
    return idx[..., 0] if scalar else idx


def _pick_reduce(x, dim, keepdim, return_indices, kind):
    """Shared machinery for min/max picking reductions (post NaN masking)."""
    amin_amax = torch.amin if kind == "min" else torch.amax
    if dim is None:
        return amin_amax(x)
    axes, scalar = _canon_axes(dim, x.ndim)
    if not return_indices:
        return amin_amax(x, dim=axes, keepdim=keepdim)
    xc, keptshape, redshape = _collapse_last(x, axes)
    flat_idx = (torch.argmin if kind == "min" else torch.argmax)(xc, dim=-1)
    val = torch.gather(xc, -1, flat_idx[..., None])[..., 0]
    if keepdim:
        val = val.reshape(keptshape)
    return val, _indices(flat_idx, keepdim, keptshape, redshape, scalar)


def max(input, dim=None, keepdim: bool = False, omitnan: bool = False, inplace: bool = False,
        return_indices: bool = False, out=None):
    """Multi-dim max; ``omitnan`` masks NaNs to -inf first."""
    x = torch.as_tensor(input)
    if omitnan and x.is_floating_point():
        x = torch.where(torch.isnan(x), -torch.inf, x)
    return _pick_reduce(x, dim, keepdim, return_indices, "max")


def min(input, dim=None, keepdim: bool = False, omitnan: bool = False, inplace: bool = False,
        return_indices: bool = False, out=None):
    """Multi-dim min; ``omitnan`` masks NaNs to +inf first."""
    x = torch.as_tensor(input)
    if omitnan and x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.inf, x)
    return _pick_reduce(x, dim, keepdim, return_indices, "min")


def nanmax(input, dim=None, keepdim=False, inplace=False, return_indices=False, out=None):
    """``max(..., omitnan=True)``."""
    return max(input, dim=dim, keepdim=keepdim, omitnan=True, return_indices=return_indices)


def nanmin(input, dim=None, keepdim=False, inplace=False, return_indices=False, out=None):
    """``min(..., omitnan=True)``."""
    return min(input, dim=dim, keepdim=keepdim, omitnan=True, return_indices=return_indices)


def median(input, dim=None, keepdim: bool = False, omitnan: bool = False, inplace: bool = False,
           return_indices: bool = False, out=None):
    """Multi-dim lower median. **Always** omits NaNs (``omitnan`` is
    accepted for the uniform API); all-NaN slices return NaN."""
    x = torch.as_tensor(input)
    isfloat = x.is_floating_point()
    if dim is None:
        flat = x.reshape(-1)
        if isfloat:
            valid = ~torch.isnan(flat)
            cnt = valid.sum()
            flat = torch.where(valid, flat, torch.inf)
        else:
            cnt = torch.tensor(flat.numel(), device=x.device)
        k = torch.div(torch.clamp(cnt - 1, min=0), 2, rounding_mode="floor")
        val = torch.sort(flat).values[k]
        return torch.where(cnt == 0, torch.nan, val) if isfloat else val
    axes, scalar = _canon_axes(dim, x.ndim)
    xc, keptshape, redshape = _collapse_last(x, axes)
    if isfloat:
        valid = ~torch.isnan(xc)
        cnt = valid.sum(dim=-1)
        xm = torch.where(valid, xc, torch.inf)
    else:
        cnt = torch.full(xc.shape[:-1], xc.shape[-1], device=x.device)
        xm = xc
    order = torch.argsort(xm, dim=-1, stable=True)
    k = torch.div(torch.clamp(cnt - 1, min=0), 2, rounding_mode="floor")
    flat_idx = torch.gather(order, -1, k[..., None])
    val = torch.gather(xc, -1, flat_idx)[..., 0]
    flat_idx = flat_idx[..., 0]
    if isfloat:
        val = torch.where(cnt == 0, torch.nan, val)
    if keepdim:
        val = val.reshape(keptshape)
    if return_indices:
        return val, _indices(flat_idx, keepdim, keptshape, redshape, scalar)
    return val


def sum(input, dim=None, keepdim: bool = False, omitnan: bool = False, inplace: bool = False,
        dtype=None, out=None):
    """Multi-dim sum; ``omitnan`` treats NaN as 0."""
    x = torch.as_tensor(input)
    if omitnan and x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.zeros((), dtype=x.dtype, device=x.device), x)
    axes = _axes_or_none(dim, x.ndim)
    return torch.sum(x, dim=axes, keepdim=keepdim, dtype=dtype)


def nansum(input, dim=None, keepdim=False, inplace=False, dtype=None, out=None):
    """``sum(..., omitnan=True)``."""
    return sum(input, dim=dim, keepdim=keepdim, omitnan=True, dtype=dtype)


def mean(input, dim=None, keepdim: bool = False, omitnan: bool = False, inplace: bool = False,
         dtype=None, out=None):
    """Multi-dim mean; ``omitnan`` divides by the non-NaN count."""
    x = torch.as_tensor(input)
    axes = _axes_or_none(dim, x.ndim)
    if omitnan and x.is_floating_point():
        isnan = torch.isnan(x)
        num = torch.sum(torch.where(isnan, torch.zeros((), dtype=x.dtype, device=x.device), x),
                        dim=axes, keepdim=keepdim, dtype=dtype)
        den = torch.sum(~isnan, dim=axes, keepdim=keepdim).to(num.dtype)
        return num / den
    return torch.mean(x, dim=axes, keepdim=keepdim, dtype=dtype or as_float(x.dtype))


def nanmean(input, dim=None, keepdim=False, inplace=False, dtype=None, out=None):
    """``mean(..., omitnan=True)``."""
    return mean(input, dim=dim, keepdim=keepdim, omitnan=True, dtype=dtype)


def var(input, dim=None, keepdim: bool = False, unbiased: bool = True, omitnan: bool = False,
        inplace: bool = False, dtype=None, out=None):
    """Multi-dim variance (``unbiased`` = Bessel correction)."""
    x = torch.as_tensor(input)
    if omitnan:
        return nanvar(x, dim=dim, keepdim=keepdim, unbiased=unbiased, dtype=dtype)
    axes = _axes_or_none(dim, x.ndim)
    x = x.to(dtype or as_float(x.dtype))
    return torch.var(x, dim=axes, keepdim=keepdim, correction=1 if unbiased else 0)


def nanvar(input, dim=None, keepdim: bool = False, unbiased: bool = True, inplace: bool = False,
           dtype=None, out=None):
    """NaN-omitting variance by masked moments: ``E[x^2] - E[x]^2`` over
    the non-NaN entries, with the ``w / (w - 1)`` Bessel correction."""
    x = torch.as_tensor(input)
    axes = _axes_or_none(dim, x.ndim)
    if dtype is not None:
        x = x.to(dtype)
    isnan = torch.isnan(x)
    xz = torch.where(isnan, torch.zeros((), dtype=x.dtype, device=x.device), x)
    w = torch.sum(~isnan, dim=axes, keepdim=keepdim).to(xz.dtype)
    m1 = torch.sum(xz, dim=axes, keepdim=keepdim) / w
    m2 = torch.sum(xz * xz, dim=axes, keepdim=keepdim) / w
    v = m2 - m1 * m1
    if unbiased:
        v = v * (w / (w - 1))
    return v


def std(input, dim=None, keepdim: bool = False, unbiased: bool = True, omitnan: bool = False,
        inplace: bool = False, dtype=None, out=None):
    """Standard deviation."""
    return torch.sqrt(var(input, dim=dim, keepdim=keepdim, unbiased=unbiased, omitnan=omitnan,
                          dtype=dtype))


def nanstd(input, dim=None, keepdim=False, unbiased=True, inplace=False, dtype=None, out=None):
    """NaN-omitting standard deviation."""
    return torch.sqrt(nanvar(input, dim=dim, keepdim=keepdim, unbiased=unbiased, dtype=dtype))
