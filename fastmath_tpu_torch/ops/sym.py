"""Compact symmetric solves: ``sym_solve`` and the fused ``sym_solve_chain``.

PyTorch counterpart of the solve half of ``fastmath_tpu/ops/sym.py``.
Layout auto-detection (scaled identity / diagonal / compact / full) is
the same. Compact input, and N == 1, goes through one
``torch.autograd.Function`` (:mod:`fastmath_tpu_torch.kernels.sym_cuda`)
that launches the hand-written CUDA kernel on a CUDA tensor and runs the
kernel's plain PyTorch version otherwise. Diagonal and scaled-identity
storage are elementwise PyTorch on any device.

The port has one semantics on both devices, that of the reference's
kernel path: ``refine=None`` means one refinement step for N <= 4 and
none above (the reference's fused-XLA path defaults to 0).

``backend``:

* ``"auto"``: a CUDA tensor in the kernel's domain (compact layout or
  N == 1, real float, N <= 32) always launches the kernel; everything
  else runs plain PyTorch on the tensors' device.
* ``"cuda"``: forces the kernel; raises outside its domain or on CPU
  tensors.
* ``"torch"``: the plain version, on whatever device holds the tensors.

Full storage (``NN == N*N``) and compact N > 32 are not ported yet and
raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..core.dtypes import downcast, upcast_half
from ..layouts.sym import MatrixLayout, classify_layout, tri_index

__all__ = ["sym_solve", "sym_solve_", "sym_solve_chain", "BACKENDS"]

BACKENDS = ("auto", "cuda", "torch")

# N <= this solves by the closed-form adjugate
_CLOSED_FORM_MAX = 4

_NOT_PORTED = (
    "is not ported yet: the reference solves it through batchlmdiv / the "
    "Pallas solve_full_cf kernel (ROADMAP 'Modules to port', item 3, and "
    "'TPU kernels to port', #11)"
)


def _entries(mat: torch.Tensor, n: int):
    """Full-matrix view of compact storage as an n x n grid of last-axis
    slices."""
    return [[mat[..., tri_index(i, j, n)] for j in range(n)] for i in range(n)]


def _det_expand(E, rows, cols, cache):
    """Determinant of the submatrix E[rows][cols] by Laplace expansion
    along the first remaining row, memoized on the index sets so shared
    minors are computed once."""
    key = (rows, cols)
    if key in cache:
        return cache[key]
    k = len(rows)
    if k == 0:
        out = 1.0  # det of the empty matrix (0x0 minor for n=1)
    elif k == 1:
        out = E[rows[0]][cols[0]]
    elif k == 2:
        out = (
            E[rows[0]][cols[0]] * E[rows[1]][cols[1]]
            - E[rows[0]][cols[1]] * E[rows[1]][cols[0]]
        )
    else:
        out = None
        r0 = rows[0]
        sub_rows = rows[1:]
        for pos, c in enumerate(cols):
            sub_cols = cols[:pos] + cols[pos + 1:]
            minor = _det_expand(E, sub_rows, sub_cols, cache)
            term = E[r0][c] * minor
            if pos % 2:
                term = -term
            out = term if out is None else out + term
    cache[key] = out
    return out


def _det_full(E, n: int, cache=None):
    cache = {} if cache is None else cache
    idx = tuple(range(n))
    return _det_expand(E, idx, idx, cache)


def _cofactors(E, n: int):
    """Cofactor grid ``adj[i][j] = cofactor(j, i)`` and ``det(A)`` of the
    entry grid ``E``, by the memoized Laplace expansion."""
    cache = {}
    idx = tuple(range(n))
    det = _det_expand(E, idx, idx, cache)
    adj = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(n):
            minor = _det_expand(E, tuple(r for r in idx if r != j),
                                tuple(c for c in idx if c != i), cache)
            adj[i][j] = -minor if (i + j) % 2 else minor
    return adj, det


def _adjugate_apply(adj, vec_parts):
    """``adj(A) @ v`` from :func:`_cofactors`' grid, each row summed left
    to right (the reference's term order)."""
    out = []
    for row in adj:
        acc = row[0] * vec_parts[0]
        for a, v in zip(row[1:], vec_parts[1:]):
            acc = acc + a * v
        out.append(acc)
    return out


def _prep_eps(eps, n: int):
    """``eps`` as a tuple of n floats (a scalar or a short sequence; its
    last value repeats to length n), or None."""
    if eps is None:
        return None
    if isinstance(eps, torch.Tensor):
        eps = eps.detach().cpu().numpy()
    e = np.asarray(eps, dtype=np.float64).ravel()
    if e.size < n:
        e = np.concatenate([e, np.full(n - e.size, e[-1])])
    return tuple(float(x) for x in e[:n])


def _apply_eps(diag_parts, eps, n, dtype):
    """Add the diagonal smoothing term to a list of n diagonal entries."""
    e = torch.tensor(_prep_eps(eps, n), dtype=dtype,
                     device=diag_parts[0].device)
    return [d + e[i] for i, d in enumerate(diag_parts)]


def _route(backend, layout, n, x: torch.Tensor, op: str):
    """``(compact, kernel)``: whether the compact solve machinery serves
    this input, and whether it runs as the CUDA kernel."""
    from ..kernels.sym_cuda import KERNEL_DTYPES, MAX_N

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if layout is MatrixLayout.FULL:
        raise NotImplementedError(f"{op} on full storage {_NOT_PORTED}")
    if layout is MatrixLayout.COMPACT_SYM and n > MAX_N:
        raise NotImplementedError(f"{op} on compact N={n} > {MAX_N} {_NOT_PORTED}")
    compact = layout is MatrixLayout.COMPACT_SYM or (
        n == 1 and layout is MatrixLayout.SCALED_IDENTITY)
    real = x.dtype in KERNEL_DTYPES
    if backend == "cuda":
        if not (compact and real):
            raise ValueError(
                f"backend='cuda': the {op} kernel serves compact-symmetric "
                f"storage (or N == 1), N <= {MAX_N}, float32/float64 "
                f"(got layout={layout.name}, N={n}, {x.dtype})")
        if not x.is_cuda:
            raise ValueError(f"backend='cuda' needs CUDA tensors (got {x.device})")
        return True, True
    return compact, backend == "auto" and compact and real and x.is_cuda


def _flat(t: torch.Tensor, batch, width):
    return t.expand(*batch, width).contiguous().reshape(-1, width)


def _sym_solve_impl(mat, vec, eps, refine, backend, op="sym_solve"):
    """sym_solve without the dtype handling (the caller upcasts)."""
    n = vec.shape[-1]
    layout = classify_layout(mat.shape[-1], n)
    compact, kernel = _route(backend, layout, n, mat, op)
    if not compact:
        # elementwise: scaled identity (N > 1) or diagonal
        d = mat[..., 0:1] if layout is MatrixLayout.SCALED_IDENTITY else mat
        if eps is not None:
            parts = _apply_eps([d[..., i] for i in range(d.shape[-1])], eps,
                               d.shape[-1], d.dtype)
            d = torch.stack(parts, dim=-1)
        return vec / d
    from ..kernels.sym_cuda import solve_function

    if refine is None:
        refine = 1 if n <= _CLOSED_FORM_MAX else 0
    batch = torch.broadcast_shapes(mat.shape[:-1], vec.shape[:-1])
    x = solve_function(_flat(mat, batch, mat.shape[-1]), _flat(vec, batch, n),
                       _prep_eps(eps, n), int(refine), kernel)
    return x.reshape(*batch, n)


def sym_solve(
    mat: torch.Tensor,
    vec: torch.Tensor,
    eps: Optional[Union[float, Sequence[float]]] = None,
    refine: Optional[int] = None,
    backend: str = "auto",
) -> torch.Tensor:
    r"""Left matrix division ``A \ v`` for auto-detected storage.

    ``mat`` is ``(..., NN)`` with ``NN`` in ``{1, N, N(N+1)/2}``, ``vec``
    is ``(..., N)``; batch dims broadcast. ``eps`` (a scalar or
    per-channel sequence, the last value repeated) is added to the
    diagonal before solving. ``refine`` adds iterative-refinement steps
    ``x += A \ (v - A x)`` (default 1 for N <= 4, 0 above). bf16/f16
    compute in float32 and round once on output. Differentiable in
    ``mat`` and ``vec``. See the module docstring for ``backend``.
    """
    mat, vec, half = upcast_half(mat, vec)
    return downcast(_sym_solve_impl(mat, vec, eps, refine, backend), half)


def sym_solve_chain(
    mat: torch.Tensor,
    vec: torch.Tensor,
    iters: int = 1,
    add: Optional[torch.Tensor] = None,
    eps: Optional[Union[float, Sequence[float]]] = None,
    backend: str = "auto",
) -> torch.Tensor:
    r"""Iterated left division: ``x_0 = vec``, ``x_{t+1} = A \ x_t``
    (``+ add`` when given); returns ``x_iters``.

    ``iters == 0`` returns ``vec``; ``iters == 1`` is one
    :func:`sym_solve` (default ``refine``) plus ``add``. From two
    iterations on, compact input runs the fused chain: the matrix is
    read and factored once (cofactors and 1/det for N <= 4, pivoted LU
    for 5..8, explicit inverse for 9..32) and every iteration applies
    the solve to the new right-hand side, without refinement. The
    gradient replays ``iters`` solves (memory O(iters * batch)).

    Error growth (float32): the normwise error against the exact
    recurrence is a random walk of per-step roundings, median
    ~``sqrt(iters) * eps`` and p99 ~``iters * eps``, as in the
    reference (``fastmath_tpu/ops/sym.py``, ``sym_solve_chain``).
    """
    if iters < 0:
        raise ValueError("iters must be >= 0")
    arrays = (mat, vec) if add is None else (mat, vec, add)
    *arrays, half = upcast_half(*arrays)
    mat, vec = arrays[0], arrays[1]
    add_ = arrays[2] if add is not None else None
    n = vec.shape[-1]
    layout = classify_layout(mat.shape[-1], n)
    compact, kernel = _route(backend, layout, n, mat, "sym_solve_chain")
    if iters == 0:
        return downcast(vec, half)
    if iters == 1:
        x = _sym_solve_impl(mat, vec, eps, None, backend, "sym_solve_chain")
        return downcast(x if add_ is None else x + add_, half)
    batch = torch.broadcast_shapes(*(a.shape[:-1] for a in arrays))
    if not compact:
        x = vec.expand(*batch, n)
        for _ in range(iters):
            x = _sym_solve_impl(mat, x, eps, 0, backend, "sym_solve_chain")
            if add_ is not None:
                x = x + add_
        return downcast(x, half)
    from ..kernels.sym_cuda import chain_function

    x = chain_function(
        _flat(mat, batch, mat.shape[-1]), _flat(vec, batch, n),
        None if add_ is None else _flat(add_, batch, n),
        _prep_eps(eps, n), int(iters), kernel)
    return downcast(x.reshape(*batch, n), half)


# functional alias for the reference's in-place variant
sym_solve_ = sym_solve
