"""Hand-written CUDA kernels for Hopper (sm_90a), built with ``nvcc`` at
first use (:mod:`._build`), each with a plain PyTorch version beside it.

Importing this package needs neither CUDA nor ``nvcc``: nothing is built
until a kernel is launched on a CUDA tensor.
"""
from .batched_cuda import (chol_cf, det_cf, inv_cf, logdet_cf, matmul_cf, matvec_full_cf,
                           solve_full_cf)
from .eig import eig_sym_cf
from .expm import expm_cf
from .logm import logm_cf
from .sym_cuda import sym_solve_cf, sym_solve_chain_cf
from .sym_factor import sym_det_cf, sym_invert_cf
from .sym_iterate import sym_matvec_chain_cf, sym_maxeig_cf
from .sym_products import (sym_addmatvec_cf, sym_matmul_cf, sym_matvec_cf,
                           sym_outer_cf, sym_submatvec_cf)

__all__ = ["sym_solve_cf", "sym_solve_chain_cf", "sym_matvec_cf", "sym_matvec_chain_cf",
           "sym_maxeig_cf", "sym_invert_cf", "sym_addmatvec_cf", "sym_submatvec_cf",
           "sym_outer_cf", "sym_det_cf", "sym_matmul_cf", "det_cf", "inv_cf", "logdet_cf",
           "chol_cf", "solve_full_cf", "matvec_full_cf", "matmul_cf", "eig_sym_cf", "expm_cf",
           "logm_cf"]
