"""fastmath_tpu_torch: the PyTorch / CUDA (NVIDIA H100) port of
``fastmath_tpu``, fast math for huge batches of tiny matrix problems.

Same public names, storage layouts and semantics as the JAX package;
every Pallas TPU kernel becomes a CUDA kernel written for Hopper
(``kernels/csrc``), with a plain PyTorch version beside it that serves
CPU tensors. This package imports neither JAX nor ``fastmath_tpu``.
"""
from . import core, kernels, layouts
from .kernels import sym_invert_cf, sym_matvec_cf, sym_solve_cf
from .ops import batched, lie, qr, sugar, sym
from .ops.batched import (batchchol, batchdet, batchinv, batchlmdiv, batchlogdet,
                          batchmatmul, batchmatvec, batchrmdiv)
from .ops.lie import expm, expm_derivatives, logm, meanm
from .ops.qr import (eig_sym, givens, givens_apply, hessenberg, hessenberg_sym, householder,
                     householder_apply, qr_hessenberg, rq_hessenberg)
from .ops.sugar import (dot, inv, is_orthonormal, kron2, lmdiv, matvec, mdot, outer, rmdiv,
                        round, solvevec, trace)
from .ops.sym import (full_to_sym, sym_addmatvec, sym_addmatvec_, sym_det, sym_diag,
                      sym_invert, sym_invert_, sym_matmul, sym_matvec, sym_matvec_chain,
                      sym_maxeig, sym_outer, sym_solve, sym_solve_, sym_solve_chain,
                      sym_submatvec, sym_submatvec_, sym_to_full)

__all__ = ["sym_to_full", "full_to_sym", "sym_diag", "sym_solve", "sym_solve_",
           "sym_solve_chain", "sym_matvec", "sym_addmatvec", "sym_addmatvec_", "sym_submatvec",
           "sym_submatvec_", "sym_outer", "sym_matmul", "sym_matvec_chain", "sym_maxeig",
           "sym_det", "sym_invert", "sym_invert_", "batchinv", "batchmatvec", "batchmatmul",
           "batchlmdiv", "batchrmdiv", "batchdet", "batchlogdet", "batchchol", "eig_sym",
           "qr_hessenberg", "rq_hessenberg", "hessenberg", "hessenberg_sym", "householder",
           "householder_apply", "givens", "givens_apply", "kron2", "lmdiv", "rmdiv", "inv",
           "matvec", "solvevec", "outer", "trace", "dot", "mdot", "is_orthonormal", "round",
           "expm", "logm", "meanm", "expm_derivatives", "core", "layouts", "kernels", "batched",
           "lie", "qr", "sugar", "sym", "sym_solve_cf", "sym_matvec_cf", "sym_invert_cf"]
