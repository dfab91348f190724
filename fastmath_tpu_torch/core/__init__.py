"""Core utilities: dtypes, shapes and indices, broadcasting, the kernels'
build directory."""
from .cache import compilation_cache_dir, enable_compilation_cache
from .dtypes import as_float, downcast, eps, promote_transform_dtype, result_real_dtype, upcast_half
from .shapes import broadcast_batch_shapes, ensure_tuple, ind2sub, normalize_axes, sub2ind

__all__ = ["enable_compilation_cache", "compilation_cache_dir", "eps", "as_float",
           "result_real_dtype", "promote_transform_dtype", "ensure_tuple", "normalize_axes",
           "sub2ind", "ind2sub", "broadcast_batch_shapes", "upcast_half", "downcast"]
