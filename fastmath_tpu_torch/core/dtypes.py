"""Dtype utilities: machine epsilon, promotion rules, float checks.

PyTorch counterpart of ``fastmath_tpu/core/dtypes.py``: the same names and
rules. One difference is deliberate, and holds for ``upcast_half`` and
``as_float`` (the linalg tier, the reductions and the special functions):
where every input is an integer or bool, JAX under x64 promotes to
float64, while this package promotes to ``torch.get_default_dtype()``
(float32 unless the caller changed it). ``promote_transform_dtype`` keeps
scipy's rule instead (integers to float64), as the JAX package does.
"""
from __future__ import annotations

import torch

__all__ = [
    "eps",
    "as_float",
    "result_real_dtype",
    "promote_transform_dtype",
    "upcast_half",
    "downcast",
]

_HALF_DTYPES = (torch.float16, torch.bfloat16)


def upcast_half(*tensors):
    """Upcast half-precision inputs to float32 and report the dtype to
    round the result back to.

    Returns ``(*tensors, half)``. The result dtype is the promotion of
    all input dtypes (``torch.promote_types``, which is what
    ``torch.result_type`` gives for tensors of one or more dimensions;
    a zero-dimensional tensor counts the same as any other, as in JAX).
    Mixed half/full inputs promote to the full precision; only when the
    promoted dtype is itself half does the op compute in float32 and
    round once on the way out (``half`` is then that dtype, else
    ``None``). Bool and integer inputs promote to the default float.
    """
    tensors = [torch.as_tensor(t) for t in tensors]
    out = tensors[0].dtype
    for t in tensors[1:]:
        out = torch.promote_types(out, t.dtype)
    if not (out.is_floating_point or out.is_complex):
        out = torch.get_default_dtype()
    if out in _HALF_DTYPES:
        return (*[t.to(torch.float32) for t in tensors], out)
    return (*[t.to(out) for t in tensors], None)


def downcast(x, half):
    """Round ``x`` back to the ``half`` dtype reported by
    :func:`upcast_half` (identity when ``half`` is ``None``)."""
    return x if half is None else x.to(half)


def eps(dtype) -> float:
    """Machine epsilon of a floating dtype; for a complex dtype, that of
    its real component."""
    if not (dtype.is_floating_point or dtype.is_complex):
        raise TypeError(f"eps() requires a floating dtype, got {dtype}")
    return float(torch.finfo(dtype).eps)


def as_float(dtype):
    """The floating dtype arithmetic should happen in: floats and complex
    pass through, integers and bool give ``torch.get_default_dtype()``."""
    if dtype.is_floating_point or dtype.is_complex:
        return dtype
    return torch.get_default_dtype()


def result_real_dtype(dtype):
    """The real dtype underlying ``dtype`` (identity for real floats)."""
    return dtype.to_real() if dtype.is_complex else dtype


def promote_transform_dtype(dtype):
    """Promotion rule for DCT/DST inputs, scipy's: integers and bool give
    float64 (not the default dtype: this rule is the transforms' own),
    float16 and bfloat16 give float32, everything else is unchanged."""
    if not (dtype.is_floating_point or dtype.is_complex):
        return torch.float64
    if dtype in _HALF_DTYPES:
        return torch.float32
    return dtype
