"""Compact symmetric ops: the solves (``sym_solve``, the fused
``sym_solve_chain``), the products (``sym_matvec``,
``sym_addmatvec`` / ``sym_submatvec``, ``sym_outer``, ``sym_matmul``),
the iterations (the fused ``sym_matvec_chain`` and the power iteration
``sym_maxeig``), the determinant ``sym_det`` and the inverse
``sym_invert``; and the layout conversions ``sym_to_full``,
``full_to_sym`` and ``sym_diag``, re-exported from
:mod:`fastmath_tpu_torch.layouts`.

PyTorch counterpart of ``fastmath_tpu/ops/sym.py``. Layout
auto-detection (scaled identity / diagonal / compact / full) and
right-aligned broadcasting of the batch dims are the same. Input in a
kernel's domain goes through one ``torch.autograd.Function`` per kernel
(:mod:`fastmath_tpu_torch.kernels.sym_cuda`,
:mod:`fastmath_tpu_torch.kernels.sym_products`,
:mod:`fastmath_tpu_torch.kernels.sym_factor`,
:mod:`fastmath_tpu_torch.kernels.sym_iterate`) that launches the
hand-written CUDA kernel on a CUDA tensor and runs the kernel's plain
PyTorch version otherwise. Everything else is plain PyTorch on the
tensors' device: diagonal and scaled-identity storage elementwise, full
storage and compact N > 32 of the products through ``torch.matmul``.
The solves take full storage and compact N > 32 as the reference does:
densified, ``eps`` on the diagonal, then
:func:`fastmath_tpu_torch.ops.batched.batchlmdiv` (whose own kernels
serve n <= 32) with ``refine`` steps through ``batchmatvec``.

The port has one semantics on both devices, that of the reference's
kernel path: ``refine=None`` means one refinement step for compact
N <= 4 and none above (the reference's fused-XLA path defaults to 0).
On full storage and compact N > 32 it means none: the reference has no
compact kernel for those and solves them on that XLA path.

``backend``:

* ``"auto"``: a CUDA tensor in the kernel's domain always launches the
  kernel; everything else runs plain PyTorch on the tensors' device.
  The domain is real float32/float64 and compact storage (or N == 1)
  with N <= 32; for ``sym_outer`` N <= 32, for ``sym_matmul``
  max(K, D) <= 32. (The reference never auto-routes the matvec family,
  outer or small JᵀHJ to its TPU kernels, because fused XLA beats them
  there; eager PyTorch has no such fusion.) The iterations keep the
  reference's gates: ``sym_matvec_chain`` takes its kernel for
  ``iters > 1`` only, ``sym_maxeig`` for ``iters >= 1``.
* ``"cuda"``: forces the kernel (at any ``iters``); raises outside its
  domain or on CPU tensors.
* ``"torch"``: the plain version, on whatever device holds the tensors.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..core.dtypes import downcast, upcast_half
from ..layouts.sym import (MatrixLayout, classify_layout, compact_size, full_to_sym,
                           sym_diag, sym_dim, sym_to_full, tri_index)

__all__ = ["sym_to_full", "full_to_sym", "sym_diag", "sym_solve", "sym_solve_",
           "sym_solve_chain", "sym_matvec", "sym_addmatvec", "sym_addmatvec_",
           "sym_submatvec", "sym_submatvec_", "sym_outer", "sym_matmul", "sym_matvec_chain",
           "sym_maxeig", "sym_det", "sym_invert", "sym_invert_", "BACKENDS"]

BACKENDS = ("auto", "cuda", "torch")

# N <= this solves by the closed-form adjugate
_CLOSED_FORM_MAX = 4


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


def _check_backend(backend):
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def _use_kernel(backend, storage: bool, n: int, x: torch.Tensor, op: str, serves: str,
                got: str):
    """``(domain, kernel)``: whether a kernel takes this call (a storage
    class it reads, ``storage``, and the kernels' size ``n`` and dtypes),
    and whether the call launches it (see the module docstring).
    ``serves`` (what the kernel takes) and ``got`` word the error of a
    forced ``backend="cuda"``."""
    from ..kernels._launch import in_domain

    _check_backend(backend)
    domain = storage and in_domain(n, x.dtype)
    if backend == "cuda":
        if not domain:
            raise ValueError(f"backend='cuda': the {op} kernel serves {serves}, "
                             f"float32/float64 (got {got}, {x.dtype})")
        if not x.is_cuda:
            raise ValueError(f"backend='cuda' needs CUDA tensors (got {x.device})")
    return domain, backend == "cuda" or (backend == "auto" and domain and x.is_cuda)


def _is_compact(layout, n) -> bool:
    """Compact storage; at N == 1 every storage class is compact."""
    return layout is MatrixLayout.COMPACT_SYM or (
        n == 1 and layout is MatrixLayout.SCALED_IDENTITY)


def _compact_route(backend, layout, n, x, op):
    """:func:`_use_kernel` for the kernels of compact storage (or N == 1),
    N <= 32."""
    from ..kernels._launch import MAX_N

    return _use_kernel(backend, _is_compact(layout, n), n, x, op,
                       f"compact-symmetric storage (or N == 1), N <= {MAX_N}",
                       f"layout={layout.name}, N={n}")


def _is_dense(layout, n) -> bool:
    """Full storage, or compact N > MAX_N: solved densified through
    ``batchlmdiv``."""
    from ..kernels._launch import MAX_N

    return layout is MatrixLayout.FULL or (layout is MatrixLayout.COMPACT_SYM and n > MAX_N)


def _route(backend, layout, n, x: torch.Tensor, op: str):
    """``(compact, kernel)``: whether the compact solve machinery serves
    this input, and whether it runs as the CUDA kernel (neither for the
    dense classes, whose ``batchlmdiv`` routes itself)."""
    _check_backend(backend)
    if _is_dense(layout, n):
        return False, False
    return _is_compact(layout, n), _compact_route(backend, layout, n, x, op)[1]


def _flat(t: torch.Tensor, batch, width):
    return t.expand(*batch, width).contiguous().reshape(-1, width)


def _dense_solve(mat, vec, layout, n, eps, refine, backend):
    """Full storage or compact N > 32: densify, add eps to the diagonal,
    broadcast, then ``batchlmdiv`` with ``refine`` steps (the
    reference's ``_refined_lmdiv``)."""
    from .batched import batchlmdiv, batchmatvec

    if layout is MatrixLayout.FULL:
        full = mat.reshape(*mat.shape[:-1], n, n)
    else:
        full = sym_to_full(mat, n)
    if eps is not None:
        e = torch.tensor(_prep_eps(eps, n), dtype=full.dtype, device=full.device)
        full = full + torch.diag(e)
    batch = torch.broadcast_shapes(full.shape[:-2], vec.shape[:-1])
    full, v = full.expand(*batch, n, n), vec.expand(*batch, n)
    x = batchlmdiv(full, v, backend=backend)
    for _ in range(refine or 0):
        x = x + batchlmdiv(full, v - batchmatvec(full, x), backend=backend)
    return x


def _sym_solve_impl(mat, vec, eps, refine, backend, op="sym_solve"):
    """sym_solve without the dtype handling (the caller upcasts)."""
    n = vec.shape[-1]
    layout = classify_layout(mat.shape[-1], n)
    if _is_dense(layout, n):
        return _dense_solve(mat, vec, layout, n, eps, refine, backend)
    compact, kernel = _route(backend, layout, n, mat, op)
    if not compact:
        # elementwise: scaled identity (N > 1) or diagonal
        d = mat[..., 0:1] if layout is MatrixLayout.SCALED_IDENTITY else mat
        if eps is not None:
            parts = _apply_eps([d[..., i] for i in range(d.shape[-1])], eps,
                               d.shape[-1], d.dtype)
            d = torch.stack(parts, dim=-1)
        return vec / d
    from ..kernels.sym_cuda import SolveFunction

    if refine is None:
        refine = 1 if n <= _CLOSED_FORM_MAX else 0
    batch = torch.broadcast_shapes(mat.shape[:-1], vec.shape[:-1])
    x = SolveFunction.apply(_flat(mat, batch, mat.shape[-1]), _flat(vec, batch, n),
                            _prep_eps(eps, n), int(refine), kernel, False)
    return x.reshape(*batch, n)


def sym_solve(
    mat: torch.Tensor,
    vec: torch.Tensor,
    eps: Optional[Union[float, Sequence[float]]] = None,
    refine: Optional[int] = None,
    backend: str = "auto",
) -> torch.Tensor:
    r"""Left matrix division ``A \ v`` for auto-detected storage.

    ``mat`` is ``(..., NN)`` with ``NN`` in ``{1, N, N(N+1)/2, N*N}``,
    ``vec`` is ``(..., N)``; batch dims broadcast. ``eps`` (a scalar or
    per-channel sequence, the last value repeated) is added to the
    diagonal before solving. ``refine`` adds iterative-refinement steps
    ``x += A \ (v - A x)`` (default 1 for compact N <= 4, 0 otherwise).
    bf16/f16 compute in float32 and round once on output.
    Differentiable in ``mat`` and ``vec``. See the module docstring for
    ``backend`` and for full storage and compact N > 32.
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
    iterations on, compact input with N <= 32 runs the fused chain: the
    matrix is read and factored once (cofactors and 1/det for N <= 4,
    pivoted LU for 5..8, explicit inverse for 9..32) and every iteration
    applies the solve to the new right-hand side, without refinement;
    other storage runs ``iters`` solves without refinement. The
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
    _check_backend(backend)
    if iters == 0:  # before routing: any storage class returns vec, as in JAX
        return downcast(vec, half)
    compact, kernel = _route(backend, layout, n, mat, "sym_solve_chain")
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
    from ..kernels.sym_cuda import ChainFunction

    x = ChainFunction.apply(
        _flat(mat, batch, mat.shape[-1]), _flat(vec, batch, n),
        None if add_ is None else _flat(add_, batch, n),
        _prep_eps(eps, n), int(iters), kernel, False)
    return downcast(x.reshape(*batch, n), half)


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------


def _batch(*arrays):
    return torch.broadcast_shapes(*(a.shape[:-1] for a in arrays))


def _matvec_torch(mat, vec, layout, n):
    """``A v`` outside the kernel's domain, plain PyTorch."""
    if layout is MatrixLayout.SCALED_IDENTITY or layout is MatrixLayout.DIAGONAL:
        return mat * vec
    if layout is MatrixLayout.FULL:
        full = mat.reshape(*mat.shape[:-1], n, n)
    else:  # compact, N > 32, or a dtype the kernel does not take
        full = sym_to_full(mat, n)
    return torch.matmul(full, vec[..., None])[..., 0]


def sym_matvec(mat: torch.Tensor, vec: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """Matrix-vector product ``A v`` for auto-detected storage.

    ``mat`` is ``(..., NN)`` with ``NN`` in ``{1, N, N(N+1)/2, N*N}``,
    ``vec`` is ``(..., N)``; batch dims broadcast. bf16/f16 compute in
    float32 and round once on output. Differentiable in both. See the
    module docstring for ``backend``.
    """
    mat, vec, half = upcast_half(mat, vec)
    n = vec.shape[-1]
    layout = classify_layout(mat.shape[-1], n)
    domain, kernel = _compact_route(backend, layout, n, mat, "sym_matvec")
    if not domain:
        return downcast(_matvec_torch(mat, vec, layout, n), half)
    from ..kernels.sym_products import MatvecFunction

    batch = _batch(mat, vec)
    y = MatvecFunction.apply(_flat(mat, batch, mat.shape[-1]), _flat(vec, batch, n), kernel,
                             False)
    return downcast(y.reshape(*batch, n), half)


def _accmatvec(acc, mat, vec, sign, backend, op):
    acc, mat, vec, half = upcast_half(acc, mat, vec)
    n = vec.shape[-1]
    layout = classify_layout(mat.shape[-1], n)
    domain, kernel = _compact_route(backend, layout, n, mat, op)
    if not domain:
        mv = _matvec_torch(mat, vec, layout, n)
        return downcast(acc + mv if sign > 0 else acc - mv, half)
    from ..kernels.sym_products import AccMatvecFunction

    batch = _batch(acc, mat, vec)
    y = AccMatvecFunction.apply(_flat(acc, batch, n), _flat(mat, batch, mat.shape[-1]),
                                _flat(vec, batch, n), sign, kernel, False)
    return downcast(y.reshape(*batch, n), half)


def sym_addmatvec(acc: torch.Tensor, mat: torch.Tensor, vec: torch.Tensor,
                  backend: str = "auto") -> torch.Tensor:
    """``acc + A v`` in one pass (the kernel reads each operand once);
    storage, broadcasting, dtypes and ``backend`` as in :func:`sym_matvec`."""
    return _accmatvec(acc, mat, vec, 1.0, backend, "sym_addmatvec")


def sym_submatvec(acc: torch.Tensor, mat: torch.Tensor, vec: torch.Tensor,
                  backend: str = "auto") -> torch.Tensor:
    """``acc - A v`` in one pass; as :func:`sym_addmatvec`."""
    return _accmatvec(acc, mat, vec, -1.0, backend, "sym_submatvec")


def sym_outer(x: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """Symmetric outer product ``x xᵀ`` in compact storage:
    ``(..., N) -> (..., N(N+1)/2)``. See the module docstring for
    ``backend``."""
    from ..kernels._launch import MAX_N
    from ..kernels.sym_products import OuterFunction, outer_plain

    x, half = upcast_half(x)
    n = x.shape[-1]
    domain, kernel = _use_kernel(backend, True, n, x, "sym_outer", f"N <= {MAX_N}",
                                 f"N={n}")
    flat = x.reshape(-1, n)
    y = OuterFunction.apply(flat.contiguous(), kernel, False) if domain else outer_plain(flat)
    return downcast(y.reshape(*x.shape[:-1], compact_size(n)), half)


def sym_matmul(j: torch.Tensor, h: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """Congruence product ``Jᵀ H J`` with compact-symmetric ``H``.

    ``j`` is ``(..., K, D)`` full, ``h`` is ``(..., K(K+1)/2)`` compact;
    returns ``(..., D(D+1)/2)`` compact; batch dims broadcast. Up to
    max(K, D) = 6 the output takes the upper slots of ``G = Jᵀ (H J)``;
    above, ``0.5 (G_ij + G_ji)``, as the reference's kernel tiers. See
    the module docstring for ``backend`` (the kernel's domain is
    max(K, D) <= 32); beyond it, ``einsum`` on full storage.
    """
    from ..kernels._launch import MAX_N

    j, h, half = upcast_half(j, h)
    k, d = j.shape[-2], j.shape[-1]
    if h.shape[-1] != compact_size(k):
        raise ValueError(
            f"h last axis {h.shape[-1]} does not match compact size "
            f"{compact_size(k)} for K={k}")
    domain, kernel = _use_kernel(backend, True, max(k, d), j, "sym_matmul",
                                 f"max(K, D) <= {MAX_N}", f"K={k}, D={d}")
    if not domain:
        out = torch.einsum("...ki,...kl,...lj->...ij", j, sym_to_full(h, k), j)
        return downcast(full_to_sym(out), half)
    from ..kernels.sym_products import JhjFunction

    batch = torch.broadcast_shapes(j.shape[:-2], h.shape[:-1])
    j2 = j.expand(*batch, k, d).contiguous().reshape(-1, k * d)
    y = JhjFunction.apply(j2, _flat(h, batch, h.shape[-1]), d, kernel, False)
    return downcast(y.reshape(*batch, compact_size(d)), half)


# ---------------------------------------------------------------------------
# iterations
# ---------------------------------------------------------------------------


def sym_matvec_chain(
    mat: torch.Tensor,
    vec: torch.Tensor,
    iters: int = 1,
    add: Optional[torch.Tensor] = None,
    backend: str = "auto",
) -> torch.Tensor:
    r"""Iterated matvec: ``x_0 = vec``, ``x_{t+1} = A x_t`` (``+ add``
    when given); returns ``x_iters``.

    Richardson iteration: with ``add`` given and the spectral radius of
    A below 1 it sums the Neumann series for ``(I - A) \ add``; above 1
    the recurrence diverges (the caller scales). Storage and
    broadcasting as in :func:`sym_matvec`. ``iters == 0`` returns
    ``vec`` (after ``backend`` is validated). From two iterations on,
    compact input with N <= 32 runs the fused chain kernel (the matrix
    read once and held on chip for every step; ``backend="cuda"`` at any
    ``iters``); other storage, N > 32 and single steps run ``iters``
    :func:`sym_matvec` calls plus ``add``. Differentiable; the chain's
    backward recomputes the iterates from ``ceil(sqrt(iters))``
    checkpoints.

    Error growth (float32): the normwise error against the exact
    recurrence is a random walk of per-step roundings, median
    ~``sqrt(iters) * eps`` and p99 ~``iters * eps``, as in the reference
    (``fastmath_tpu/ops/sym.py``, ``sym_matvec_chain``).
    """
    if iters < 0:
        raise ValueError("iters must be >= 0")
    arrays = (mat, vec) if add is None else (mat, vec, add)
    *arrays, half = upcast_half(*arrays)
    mat, vec = arrays[0], arrays[1]
    add_ = arrays[2] if add is not None else None
    n = vec.shape[-1]
    layout = classify_layout(mat.shape[-1], n)
    domain, kernel = _compact_route(backend, layout, n, mat, "sym_matvec_chain")
    if iters == 0:
        return downcast(vec, half)
    batch = torch.broadcast_shapes(*(a.shape[:-1] for a in arrays))
    if domain and (iters > 1 or backend == "cuda"):
        from ..kernels.sym_iterate import MatvecChainFunction

        x = MatvecChainFunction.apply(
            _flat(mat, batch, mat.shape[-1]), _flat(vec, batch, n),
            None if add_ is None else _flat(add_, batch, n), int(iters), kernel, False)
        return downcast(x.reshape(*batch, n), half)
    x = vec.expand(*batch, n)
    for _ in range(iters):
        x = sym_matvec(mat, x, backend=backend)
        if add_ is not None:
            x = x + add_
    return downcast(x, half)


@functools.lru_cache(maxsize=256)
def _default_start(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The default start vector of :func:`sym_maxeig`: N standard normal
    values from a ``torch.Generator`` seeded 0, made once per device (a
    copy from host memory would wait for the device at every call)."""
    gen = torch.Generator().manual_seed(0)
    return torch.randn(n, generator=gen, dtype=torch.float64).to(device=device, dtype=dtype)


def sym_maxeig(
    mat: torch.Tensor,
    iters: int = 32,
    v0: Optional[torch.Tensor] = None,
    return_vector: bool = False,
    backend: str = "auto",
    renorm_every: int = 8,
):
    r"""Dominant (largest-``|λ|``) eigenvalue of every matrix in a batch by
    fused power iteration; optionally also the unit eigenvector.

    ``mat`` is compact-symmetric storage ``(..., N(N+1)/2)`` (N derived
    from the flat size); returns the Rayleigh-quotient estimate ``mu``
    ``(...)``, and ``(mu, v)`` with ``v`` ``(..., N)`` when
    ``return_vector``. Convergence is ``O((λ2/λ1)^iters)``: ``iters`` is
    a fixed count, not a tolerance. Differentiable (the backward replays
    the iteration renormalized at every step; at convergence the
    eigenvalue's pullback is ``v vᵀ``).

    ``v0``: start vectors ``(..., N)``. The default is one fixed
    direction for every problem: N standard normal values drawn from a
    ``torch.Generator`` seeded 0 (not the reference's ``random.key(0)``
    draw, which PyTorch cannot reproduce; results agree, start vectors
    do not). A ``v0`` orthogonal to the dominant eigenvector converges to
    a subdominant pair. ``v0`` also pins N, and with it the storage:
    without it an ambiguous flat size (3, 6, 10, ... are diagonal and
    compact sizes) reads as compact; pass ``v0`` for diagonal,
    scaled-identity or full storage.

    Compact N <= 32 runs the fused kernel (for ``iters >= 1``;
    ``backend="cuda"`` also at ``iters = 0``): A is pre-scaled once by
    its Gershgorin bound and renormalized every ``renorm_every`` (1..16)
    matvecs, identical to per-step normalization in exact arithmetic.
    Other storage, N > 32 and ``iters = 0`` under ``"auto"`` or
    ``"torch"`` run the reference's other path: A pre-scaled by its
    largest |entry|, renormalized at every step (``renorm_every`` is
    validated and not used). bf16/f16 compute in float32 and round once
    on output. See the module docstring for ``backend``.
    """
    from ..kernels.sym_iterate import RENORM_MAX, MaxeigFunction, inv_scale, unit

    if iters < 0:
        raise ValueError("iters must be >= 0")
    if not 1 <= int(renorm_every) <= RENORM_MAX:
        raise ValueError(f"renorm_every must be in 1..{RENORM_MAX}")
    mat, half = upcast_half(mat)
    nn = mat.shape[-1]
    if v0 is not None:
        v0 = torch.as_tensor(v0).to(device=mat.device, dtype=mat.dtype)
        n = v0.shape[-1]
        layout = classify_layout(nn, n)  # raises if inconsistent
    else:
        n = sym_dim(nn)
        layout = classify_layout(nn, n)
        v0 = _default_start(n, mat.dtype, mat.device)
    domain, kernel = _compact_route(backend, layout, n, mat, "sym_maxeig")
    batch = torch.broadcast_shapes(mat.shape[:-1], v0.shape[:-1])
    if domain and (iters > 0 or backend == "cuda"):
        out = MaxeigFunction.apply(_flat(mat, batch, nn), _flat(v0, batch, n), int(iters),
                                   int(renorm_every), kernel, False)
        mu, v = out[:, 0].reshape(batch), out[:, 1:].reshape(*batch, n)
    else:
        # pre-scale by the largest |entry| (any storage), so one matvec's
        # norm^2 stays in range; the scale's own derivative terms cancel
        # (the dominant eigenvalue is 1-homogeneous), hence detached
        g = mat.abs().amax(dim=-1).detach()
        ms = mat * inv_scale(g)[..., None]
        v = unit(v0.expand(*batch, n))
        for _ in range(iters):
            v = unit(sym_matvec(ms, v, backend="torch"))
        mu = (v * sym_matvec(ms, v, backend="torch")).sum(dim=-1) * g
    mu, v = downcast(mu, half), downcast(v, half)
    return (mu, v) if return_vector else mu


# ---------------------------------------------------------------------------
# determinant and inverse
# ---------------------------------------------------------------------------


def sym_det(mat: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """Determinant of compact symmetric matrices ``(..., N(N+1)/2) ->
    (...)``.

    The kernel serves N <= 32 (the closed form for N <= 4, pivoted LU
    above: ``sign * prod U_ii``). The plain tiers: the closed form for
    N <= 4, :func:`~fastmath_tpu_torch.ops.batched.batchdet` of the
    densified matrix beyond (with the same ``backend``). bf16/f16 compute
    in float32 and round once on output. Differentiable. See the module
    docstring for ``backend``.
    """
    mat, half = upcast_half(mat)
    n = sym_dim(mat.shape[-1])
    domain, kernel = _compact_route(backend, MatrixLayout.COMPACT_SYM, n, mat, "sym_det")
    if domain and backend != "torch":
        from ..kernels.sym_factor import SymDetFunction

        det = SymDetFunction.apply(mat.reshape(-1, mat.shape[-1]).contiguous(), kernel, False)
        return downcast(det.reshape(mat.shape[:-1]), half)
    if n <= _CLOSED_FORM_MAX:
        return downcast(_det_full(_entries(mat, n), n), half)
    from .batched import batchdet

    return downcast(batchdet(sym_to_full(mat, n), backend=backend), half)


def sym_invert(mat: torch.Tensor, diag: bool = False, backend: str = "auto") -> torch.Tensor:
    """Inverse of compact symmetric matrices, in compact storage
    ``(..., N(N+1)/2) -> (..., N(N+1)/2)``; ``diag=True`` returns only
    its diagonal ``(..., N)``.

    The kernel serves N <= 32 (cofactors for N <= 4, pivoted LU against
    the identity above, with the upper slots symmetrized). The plain
    tiers: cofactors for N <= 4,
    :func:`~fastmath_tpu_torch.ops.batched.batchinv` of the densified
    matrix beyond (with the same ``backend``). bf16/f16 compute in
    float32 and round once on output. Differentiable. See the module
    docstring for ``backend``.
    """
    mat, half = upcast_half(mat)
    n = sym_dim(mat.shape[-1])
    domain, kernel = _compact_route(backend, MatrixLayout.COMPACT_SYM, n, mat, "sym_invert")
    if domain and backend != "torch":
        from ..kernels.sym_factor import InvertFunction

        out = InvertFunction.apply(mat.reshape(-1, mat.shape[-1]).contiguous(), kernel, False)
        out = out.reshape(mat.shape)
    elif n <= _CLOSED_FORM_MAX:
        from ..kernels.sym_factor import invert_plain

        out = invert_plain(mat.reshape(-1, mat.shape[-1])).reshape(mat.shape)
    else:
        from .batched import batchinv

        full = batchinv(sym_to_full(mat, n), backend=backend)
        out = full_to_sym(full)
    return downcast(out[..., :n] if diag else out, half)


# functional aliases for the reference's in-place variants
sym_solve_ = sym_solve
sym_invert_ = sym_invert
sym_addmatvec_ = sym_addmatvec
sym_submatvec_ = sym_submatvec
