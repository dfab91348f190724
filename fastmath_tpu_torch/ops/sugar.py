"""Batched linear-algebra sugar (lmdiv/rmdiv/inv/matvec/outer/dot/...).

PyTorch counterpart of ``fastmath_tpu/ops/sugar.py``: thin,
broadcast-friendly wrappers over batched linalg primitives, with the same
names, methods and complex conventions. ``lmdiv``/``inv`` route as the
reference does: ``lu`` with n <= 16 goes to :func:`batchlmdiv` /
:func:`batchinv` (their kernels on a CUDA tensor), ``chol`` with n <= 16
on real input to the unrolled Cholesky solve, everything else to
``torch.linalg`` (the reference leaves those to XLA's library calls).

Complex conventions: ``dot``/``mdot`` conjugate the **first** argument and
``outer`` the second, unlike ``torch.dot``. ``out=`` is accepted and
ignored, as in the JAX package.
"""
from __future__ import annotations

from typing import Literal, Tuple, Union

import torch

from .batched import _chol_solve_unrolled, batchinv, batchlmdiv

__all__ = [
    "kron2",
    "lmdiv",
    "rmdiv",
    "inv",
    "matvec",
    "solvevec",
    "outer",
    "trace",
    "dot",
    "mdot",
    "is_orthonormal",
    "round",
]

# module-level aliases, as in the reference (not in __all__ there either)
solve = torch.linalg.solve
pinv = torch.linalg.pinv
cholesky = torch.linalg.cholesky

Method = Literal["lu", "chol", "svd", "pinv"]

#: largest n that the LU and Cholesky methods send to the batched tiers
_SMALL_N = 16


def _ht(a: torch.Tensor) -> torch.Tensor:
    """Conjugate transpose of the two last dims."""
    return a.mH if a.is_complex() else a.mT


def kron2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched Kronecker product of the two last dims:
    ``(..., m, n) x (..., p, q) -> (..., m*p, n*q)``."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    m, n = a.shape[-2:]
    p, q = b.shape[-2:]
    out = a[..., :, None, :, None] * b[..., None, :, None, :]
    return out.reshape(*out.shape[:-4], m * p, n * q)


def _solve_triangular(l, b, upper):
    """``jax.scipy.linalg.solve_triangular`` for a vector or matrix ``b``."""
    vector = b.dim() == l.dim() - 1
    x = torch.linalg.solve_triangular(l, b[..., None] if vector else b, upper=upper)
    return x[..., 0] if vector else x


def _chol_solve(a, b):
    if a.shape[-1] <= _SMALL_N and not (a.is_complex() or b.is_complex()):
        # the unrolled Cholesky (batchchol: its kernel on a CUDA tensor) and
        # unrolled substitutions, as the reference's small-n fast path
        return _chol_solve_unrolled(a, b)
    l = torch.linalg.cholesky(a)
    y = _solve_triangular(l, b, upper=False)
    return _solve_triangular(_ht(l), y, upper=True)


def lmdiv(a: torch.Tensor, b: torch.Tensor, method: Method = "lu", rcond: float = 1e-15,
          out=None) -> torch.Tensor:
    r"""Left matrix division ``A \ B`` for batched matrices.

    ``a``: ``(..., m, n)``, ``b``: ``(..., m, k)`` -> ``(..., n, k)``.
    Non-square ``a`` always uses the pseudoinverse. Methods: ``lu``
    (default), ``chol`` (A SPD, its lower triangle), ``svd``, ``pinv``
    (thresholded SVD with ``rcond``)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.shape[-1] != a.shape[-2]:
        method = "pinv"
    method = method.lower()
    if method.startswith("lu"):
        if a.shape[-1] <= _SMALL_N:
            return batchlmdiv(a, b)
        return torch.linalg.solve(a, b)
    if method.startswith("chol"):
        return _chol_solve(a, b)
    if method.startswith("svd"):
        u, s, vh = torch.linalg.svd(a, full_matrices=False)
        return torch.matmul(_ht(vh), torch.matmul(_ht(u), b) / s[..., None])
    if method.startswith("pinv"):
        return torch.matmul(torch.linalg.pinv(a, rtol=rcond), b)
    raise ValueError(f"Unknown inversion method {method}.")


def rmdiv(a: torch.Tensor, b: torch.Tensor, method: Method = "lu", rcond: float = 1e-15,
          out=None) -> torch.Tensor:
    r"""Right matrix division ``A / B`` (i.e. ``A @ inv(B)``).

    ``a``: ``(..., k, m)``, ``b``: ``(..., n, m)`` -> ``(..., k, n)``,
    as a left division of the conjugate transposes."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return _ht(lmdiv(_ht(b), _ht(a), method=method, rcond=rcond)).resolve_conj()


def inv(a: torch.Tensor, method: Method = "lu", rcond: float = 1e-15,
        out=None) -> torch.Tensor:
    """Batched matrix inverse (pseudoinverse when non-square)."""
    a = torch.as_tensor(a)
    if a.shape[-1] != a.shape[-2]:
        method = "pinv"
    method = method.lower()
    if method.startswith("lu"):
        if a.shape[-1] <= _SMALL_N:
            return batchinv(a)
        return torch.linalg.inv(a)
    if method.startswith("chol"):
        eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
        return _chol_solve(a, eye.expand(a.shape))
    if method.startswith("svd"):
        u, s, vh = torch.linalg.svd(a, full_matrices=False)
        return torch.matmul(_ht(vh), _ht(u) / s[..., None])
    if method.startswith("pinv"):
        return torch.linalg.pinv(a, rtol=rcond)
    raise ValueError(f"Unknown inversion method {method}.")


def matvec(mat: torch.Tensor, vec: torch.Tensor, out=None) -> torch.Tensor:
    """Batched matrix-vector product ``(..., m, n) @ (..., n) -> (..., m)``."""
    mat, vec = torch.as_tensor(mat), torch.as_tensor(vec)
    return torch.matmul(mat, vec[..., None])[..., 0]


def solvevec(mat: torch.Tensor, vec: torch.Tensor, method: Method = "lu",
             rcond: float = 1e-15, out=None) -> torch.Tensor:
    r"""Solve ``A x = v`` for a batched vector right-hand side."""
    vec = torch.as_tensor(vec)
    return lmdiv(mat, vec[..., None], method=method, rcond=rcond)[..., 0]


def outer(a: torch.Tensor, b: torch.Tensor, out=None) -> torch.Tensor:
    """Batched outer product ``a b^H``: ``(..., n) x (..., m) -> (..., n, m)``;
    conjugates the second operand for complex inputs."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a[..., :, None] * torch.conj(b)[..., None, :]


def trace(a: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Batched trace ``(..., m, m) -> (..., [1, 1])``."""
    t = torch.as_tensor(a).diagonal(dim1=-2, dim2=-1).sum(dim=-1)
    return t[..., None, None] if keepdim else t


def dot(a: torch.Tensor, b: torch.Tensor, keepdim: bool = False, out=None):
    r"""Batched dot product ``a^H b`` over the last axis, antilinear in the
    **first** argument for complex inputs (unlike ``torch.dot``)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    res = (torch.conj(a) * b).sum(dim=-1)
    return res[..., None] if keepdim else res


def mdot(a: torch.Tensor, b: torch.Tensor, keepdim: bool = False, out=None):
    r"""Frobenius inner product ``tr(A^H B)`` over the two last axes,
    antilinear in the first argument."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    res = (torch.conj(a) * b).sum(dim=(-2, -1))
    return res[..., None, None] if keepdim else res


def is_orthonormal(basis: torch.Tensor,
                   return_matrix: bool = False) -> Union[bool, Tuple[bool, torch.Tensor]]:
    """Check that a basis ``(F, N, [M])`` is orthonormal under the (matrix)
    inner product; optionally return the F x F Gram matrix. Returns a
    Python bool, so it waits for the device."""
    basis = torch.as_tensor(basis)
    f = basis.shape[0]
    flat = basis.reshape(f, -1)
    gram = torch.matmul(torch.conj(flat), flat.T)
    eye = torch.eye(f, dtype=gram.dtype, device=gram.device)
    check = bool(torch.allclose(gram, eye, rtol=1e-5, atol=1e-8))
    return (check, gram) if return_matrix else check


def round(t: torch.Tensor, decimals: int = 0) -> torch.Tensor:
    """Round to ``decimals`` decimal places (half to even)."""
    t = torch.as_tensor(t)
    scale = 10 ** decimals
    return torch.round(t * scale) / scale
