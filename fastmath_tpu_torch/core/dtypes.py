"""Dtype promotion for the linalg tier: half types compute in float32.

PyTorch counterpart of ``fastmath_tpu/core/dtypes.py`` (``upcast_half``
and ``downcast``). One difference is deliberate: where every input is
an integer or bool, JAX under x64 promotes to float64, while this
package promotes to ``torch.get_default_dtype()`` (float32 unless the
caller changed it).
"""
from __future__ import annotations

import torch

__all__ = ["upcast_half", "downcast"]

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
