"""Core utilities: dtypes, shapes and indices, broadcasting."""
from .dtypes import as_float, downcast, eps, promote_transform_dtype, result_real_dtype, upcast_half
from .shapes import broadcast_batch_shapes, ensure_tuple, ind2sub, normalize_axes, sub2ind

__all__ = ["eps", "as_float", "result_real_dtype", "promote_transform_dtype", "ensure_tuple",
           "normalize_axes", "sub2ind", "ind2sub", "broadcast_batch_shapes", "upcast_half",
           "downcast"]
