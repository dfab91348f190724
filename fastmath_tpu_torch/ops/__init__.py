"""Public ops (PyTorch counterparts of ``fastmath_tpu.ops``)."""
from .batched import (batchchol, batchdet, batchinv, batchlmdiv, batchlogdet, batchmatmul,
                      batchmatvec, batchrmdiv)
from .sym import (sym_addmatvec, sym_addmatvec_, sym_det, sym_invert, sym_invert_, sym_matmul,
                  sym_matvec, sym_outer, sym_solve, sym_solve_, sym_solve_chain, sym_submatvec,
                  sym_submatvec_)

__all__ = ["sym_solve", "sym_solve_", "sym_solve_chain", "sym_matvec",
           "sym_addmatvec", "sym_addmatvec_", "sym_submatvec", "sym_submatvec_",
           "sym_outer", "sym_matmul", "sym_det", "sym_invert", "sym_invert_", "batchinv",
           "batchmatvec", "batchmatmul", "batchlmdiv", "batchrmdiv", "batchdet",
           "batchlogdet", "batchchol"]
