"""fastmath_tpu_torch: the PyTorch / CUDA (NVIDIA H100) port of
``fastmath_tpu``, fast math for huge batches of tiny matrix problems.

Same public names, storage layouts and semantics as the JAX package;
every Pallas TPU kernel becomes a CUDA kernel written for Hopper
(``kernels/csrc``), with a plain PyTorch version beside it that serves
CPU tensors. The modules that have no kernel in the JAX package
(``reduce``, ``special``, ``simplex``, ``realtransforms``, ``stochastic``)
are plain PyTorch on the input's device. Whether a call on the card runs
its kernel or the plain version is the policy of :mod:`.ops._routing`.
``parallel`` splits a batch over a mesh of devices. This package imports
neither JAX nor ``fastmath_tpu``.
"""
__version__ = "0.1.0"

from . import core, kernels, layouts, typing, utils
from .core.cache import enable_compilation_cache

# honour FASTMATH_TPU_TORCH_CACHE_DIR at import (core/cache.py)
from .core.cache import _maybe_enable_from_env as _cache_env_hook

_cache_env_hook()
del _cache_env_hook
from . import parallel  # noqa: E402
from .kernels import sym_invert_cf, sym_matvec_cf, sym_solve_cf
from .ops import batched, lie, qr, realtransforms, reduce, simplex, special, stochastic, sugar, sym
from .ops.batched import (batchchol, batchdet, batchinv, batchlmdiv, batchlogdet,
                          batchmatmul, batchmatvec, batchrmdiv)
from .ops.lie import expm, expm_derivatives, logm, meanm
from .ops.qr import (eig_sym, givens, givens_apply, hessenberg, hessenberg_sym, householder,
                     householder_apply, qr_hessenberg, rq_hessenberg)
from .ops.realtransforms import dct, dctn, dst, dstn, idct, idctn, idst, idstn
from .ops.reduce import (max, mean, median, min, nanmax, nanmean, nanmin, nanstd, nansum, nanvar,
                         std, sum, var)
from .ops.simplex import log_softmax, logit, logsumexp, softmax, softmax_lse
from .ops.special import (besseli, besseli_ratio, digamma, erfinv, gammainc, gammaincc,
                          mvdigamma)
from .ops.stochastic import maxeig_power, trapprox, vbald
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
           "expm", "logm", "meanm", "expm_derivatives", "dct", "idct", "dst", "idst", "dctn",
           "idctn", "dstn", "idstn", "min", "max", "nanmin", "nanmax", "median", "sum", "nansum",
           "mean", "nanmean", "var", "nanvar", "std", "nanstd", "logsumexp", "softmax",
           "log_softmax", "logit", "softmax_lse", "mvdigamma", "besseli", "besseli_ratio",
           "erfinv", "gammainc", "gammaincc", "digamma", "trapprox", "vbald", "maxeig_power",
           "core", "layouts", "typing", "utils", "kernels", "batched", "lie", "qr",
           "realtransforms", "reduce", "simplex", "special", "stochastic", "sugar", "sym",
           "sym_solve_cf", "sym_matvec_cf", "sym_invert_cf", "parallel",
           "enable_compilation_cache", "__version__"]
