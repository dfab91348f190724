"""Public ops (PyTorch counterparts of ``fastmath_tpu.ops``)."""
from .batched import (batchchol, batchdet, batchinv, batchlmdiv, batchlogdet, batchmatmul,
                      batchmatvec, batchrmdiv)
from .lie import expm, expm_derivatives, logm, meanm
from .qr import (eig_sym, givens, givens_apply, hessenberg, hessenberg_sym, householder,
                 householder_apply, qr_hessenberg, rq_hessenberg)
from .realtransforms import dct, dctn, dst, dstn, idct, idctn, idst, idstn
from .reduce import (max, mean, median, min, nanmax, nanmean, nanmin, nanstd, nansum, nanvar, std,
                     sum, var)
from .simplex import log_softmax, logit, logsumexp, softmax, softmax_lse
from .special import besseli, besseli_ratio, digamma, erfinv, gammainc, gammaincc, mvdigamma
from .stochastic import maxeig_power, trapprox, vbald
from .sugar import (dot, inv, is_orthonormal, kron2, lmdiv, matvec, mdot, outer, rmdiv, round,
                    solvevec, trace)
from .sym import (full_to_sym, sym_addmatvec, sym_addmatvec_, sym_det, sym_diag, sym_invert,
                  sym_invert_, sym_matmul, sym_matvec, sym_matvec_chain, sym_maxeig, sym_outer,
                  sym_solve, sym_solve_, sym_solve_chain, sym_submatvec, sym_submatvec_,
                  sym_to_full)

__all__ = ["sym_to_full", "full_to_sym", "sym_diag", "sym_solve", "sym_solve_",
           "sym_solve_chain", "sym_matvec", "sym_addmatvec", "sym_addmatvec_", "sym_submatvec",
           "sym_submatvec_", "sym_outer", "sym_matmul", "sym_matvec_chain", "sym_maxeig",
           "sym_det", "sym_invert", "sym_invert_", "batchinv", "batchmatvec", "batchmatmul",
           "batchlmdiv", "batchrmdiv", "batchdet", "batchlogdet", "batchchol", "eig_sym",
           "qr_hessenberg", "rq_hessenberg", "hessenberg", "hessenberg_sym", "householder",
           "householder_apply", "givens", "givens_apply", "kron2", "lmdiv", "rmdiv", "inv",
           "matvec", "solvevec", "outer", "trace", "dot", "mdot", "is_orthonormal", "round",
           "expm", "logm", "meanm", "expm_derivatives", "dct", "idct", "dst", "idst", "dctn",
           "idctn", "dstn", "idstn", "min", "max", "nanmin", "nanmax", "median", "sum", "nansum",
           "mean", "nanmean", "var", "nanvar", "std", "nanstd", "logsumexp", "softmax",
           "log_softmax", "logit", "softmax_lse", "mvdigamma", "besseli", "besseli_ratio",
           "erfinv", "gammainc", "gammaincc", "digamma", "trapprox", "vbald", "maxeig_power"]
