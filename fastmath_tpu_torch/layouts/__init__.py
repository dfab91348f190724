"""Storage layout specs (compact symmetric packing)."""
from .sym import (
    MatrixLayout,
    classify_layout,
    sym_dim,
    compact_size,
    tri_index,
    compact_index_grid,
    sym_to_full,
    full_to_sym,
    sym_diag,
    set_sym_diag,
)

__all__ = [
    "MatrixLayout",
    "classify_layout",
    "sym_dim",
    "compact_size",
    "tri_index",
    "compact_index_grid",
    "sym_to_full",
    "full_to_sym",
    "sym_diag",
    "set_sym_diag",
]
