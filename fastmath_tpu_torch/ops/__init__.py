"""Public ops (PyTorch counterparts of ``fastmath_tpu.ops``)."""
from .sym import sym_solve, sym_solve_, sym_solve_chain

__all__ = ["sym_solve", "sym_solve_", "sym_solve_chain"]
