"""Compact symmetric matrix layout.

An N x N symmetric matrix is stored as ``N*(N+1)//2`` flat values in the
last axis: the **diagonal first** (N values), then the strict upper
triangle **row by row** (row 0 has N-1 values, row 1 has N-2, ...).
A 3x3 symmetric matrix ``[[a, d, e], [d, b, f], [e, f, c]]`` is stored
as ``[a, b, c, d, e, f]``. This is the storage of
``fastmath_tpu.layouts`` (both packages hand the same arrays around).

Ops that accept a "matrix" argument detect the storage class from the
size ``NN`` of the last axis given the vector length ``N``:

* ``NN == 1``           -> scaled identity
* ``NN == N``           -> diagonal matrix
* ``NN == N*(N+1)//2``  -> compact symmetric (this layout)
* ``NN == N*N``         -> full (possibly non-symmetric) matrix
"""
from __future__ import annotations

import enum
import functools
import math

import numpy as np
import torch

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


class MatrixLayout(enum.Enum):
    """Storage class of the flat matrix axis (see module docstring)."""

    SCALED_IDENTITY = "scaled_identity"  # NN == 1
    DIAGONAL = "diagonal"                # NN == N
    COMPACT_SYM = "compact_sym"          # NN == N*(N+1)//2
    FULL = "full"                        # NN == N*N


def compact_size(n: int) -> int:
    """Number of stored values for an n x n compact symmetric matrix."""
    return n * (n + 1) // 2


def sym_dim(nn: int) -> int:
    """Matrix dimension N such that ``nn == N*(N+1)//2``.

    Raises if ``nn`` is not a triangular number.
    """
    n = int((math.isqrt(8 * nn + 1) - 1) // 2)
    if compact_size(n) != nn:
        raise ValueError(f"{nn} is not a triangular number N*(N+1)/2")
    return n


def classify_layout(nn: int, n: int) -> MatrixLayout:
    """Classify the flat matrix axis of size ``nn`` against vector dim ``n``.

    Precedence: identity, then diagonal, then compact, then full; for the
    ambiguous sizes (``n == 1``, where all four coincide) earlier classes
    win.
    """
    if nn == 1:
        return MatrixLayout.SCALED_IDENTITY
    if nn == n:
        return MatrixLayout.DIAGONAL
    if nn == compact_size(n):
        return MatrixLayout.COMPACT_SYM
    if nn == n * n:
        return MatrixLayout.FULL
    raise ValueError(
        f"matrix axis of size {nn} is not compatible with vectors of "
        f"length {n}: expected 1, {n}, {compact_size(n)} or {n * n}"
    )


def tri_index(i: int, j: int, n: int) -> int:
    """Flat compact index of entry (i, j) of an n x n symmetric matrix."""
    if i == j:
        return i
    if i > j:
        i, j = j, i
    # diagonal block (n values), then upper rows: row r holds n-1-r values
    return n + i * (n - 1) - i * (i - 1) // 2 + (j - i - 1)


def compact_index_grid(n: int) -> np.ndarray:
    """(n, n) int array mapping dense (i, j) -> compact flat index."""
    idx = np.empty((n, n), dtype=np.int32)
    for i in range(n):
        for j in range(n):
            idx[i, j] = tri_index(i, j, n)
    return idx


# The index tensors on each device, made once: a copy from host memory
# waits for the work queued on the device, which a public op on CUDA
# tensors must not do at every call. Read-only; a few per N and device.


@functools.lru_cache(maxsize=256)
def _index_grid(n: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(compact_index_grid(n), dtype=torch.long, device=device)


@functools.lru_cache(maxsize=256)
def _upper_rows_cols(n: int, device: torch.device):
    rows, cols = np.triu_indices(n, k=1)
    return torch.as_tensor(rows, device=device), torch.as_tensor(cols, device=device)


def sym_to_full(mat: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Expand compact ``(..., N*(N+1)/2)`` storage to full ``(..., N, N)``
    (one gather)."""
    nn = mat.shape[-1]
    if n is None:
        n = sym_dim(nn)
    elif compact_size(n) != nn:
        raise ValueError(f"last axis {nn} != {compact_size(n)} for N={n}")
    return mat[..., _index_grid(n, mat.device)]


def full_to_sym(full: torch.Tensor, check: bool = False) -> torch.Tensor:
    """Compress full ``(..., N, N)`` storage to compact, averaging the two
    triangles (exact when the input is symmetric). ``check`` is accepted
    for API parity; averaging already enforces symmetry."""
    n = full.shape[-1]
    if full.shape[-2] != n:
        raise ValueError("full_to_sym expects a square matrix")
    sym = 0.5 * (full + full.transpose(-1, -2))
    rows, cols = _upper_rows_cols(n, full.device)
    diag = torch.diagonal(sym, dim1=-2, dim2=-1)
    return torch.cat([diag, sym[..., rows, cols]], dim=-1)


def sym_diag(mat: torch.Tensor) -> torch.Tensor:
    """Diagonal of a compact symmetric matrix (first N stored values)."""
    n = sym_dim(mat.shape[-1])
    return mat[..., :n]


def set_sym_diag(mat: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
    """Return a copy of ``mat`` with its diagonal replaced by ``diag``
    (broadcast to the diagonal's shape); ``mat`` itself is unchanged."""
    n = sym_dim(mat.shape[-1])
    out = mat.clone()
    out[..., :n] = diag
    return out


def triangle_mask(n: int, upper: bool, device, offset: int = 0) -> torch.Tensor:
    """Boolean (n, n) mask of the upper (j >= i + offset) or lower
    (j <= i - offset) triangle, made on ``device`` (no host copy)."""
    ones = torch.ones(n, n, dtype=torch.bool, device=device)
    return torch.triu(ones, offset) if upper else torch.tril(ones, -offset)


def sym_from_triangle(a: torch.Tensor, upper: bool = True) -> torch.Tensor:
    """The symmetric (Hermitian) matrix ``t + t^H - diag(Re t)`` that the
    upper (or lower) triangle t of ``a`` (..., n, n) names; the other
    triangle of ``a`` is not read."""
    tri = torch.where(triangle_mask(a.shape[-1], upper, a.device), a,
                      torch.zeros((), dtype=a.dtype, device=a.device))
    diag = tri.diagonal(dim1=-2, dim2=-1)
    diag = (diag.real if a.is_complex() else diag).to(a.dtype)
    return tri + torch.conj(tri).transpose(-1, -2) - torch.diag_embed(diag)
