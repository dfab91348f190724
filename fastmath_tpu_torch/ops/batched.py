"""Batched small-matrix linear algebra on full storage: ``batchinv``,
``batchlmdiv``, ``batchrmdiv``, ``batchdet``, ``batchlogdet``,
``batchchol``, ``batchmatvec`` and ``batchmatmul``.

PyTorch counterpart of ``fastmath_tpu/ops/batched.py``: the same names,
tiers, constants and semantics, on matrices ``(..., n, n)`` with
right-aligned broadcasting of the batch dims. Input in a kernel's domain
goes through one ``torch.autograd.Function`` per kernel
(:mod:`fastmath_tpu_torch.kernels.batched_cuda`) that launches the
hand-written CUDA kernel on a CUDA tensor and runs the kernel's plain
PyTorch version otherwise. The rest runs the reference's plain tiers in
PyTorch on the tensors' device: closed forms up to n = 4, pivoted LU
(unrolled to n = 8, rolled to 16), and ``torch.linalg`` above, where the
reference itself calls ``jnp.linalg``.

``backend``:

* ``"auto"``: a CUDA tensor in the kernel's domain always launches the
  kernel; everything else runs on the tensors' device as above. The
  domain is real float32/float64, 1 <= n <= 32, ``regularize=False``
  and, for the solves, at most ``k_cap`` right-hand-side columns (8 up
  to n = 8, 16 above). ``batchlmdiv`` takes its solve kernel for n > 4
  only; for n <= 4 it multiplies by ``batchinv``'s inverse, as the
  reference does. (The reference's batch-size thresholds were measured
  on a TPU and are not copied; ``batchchol`` takes its kernel at every
  n <= 32, where the TPU's takes it for n > 16 only.)
* ``"cuda"``: forces the kernel (``batchlmdiv`` the solve kernel at any
  n); raises outside its domain or on CPU tensors.
* ``"torch"``: the plain tiers, on whatever device holds the tensors.

The products route by their own rules (the reference never routes them
to its kernels by default; these follow the card's measurements, see
``ROADMAP.md``): ``batchmatvec`` (no ``backend`` argument) launches the
matvec kernel on a CUDA tensor for square n <= ``MATVEC_KERNEL_MAX``, and
``batchmatmul`` for every dim <= ``MATMUL_KERNEL_MAX`` under ``"auto"``
(32, the kernel's whole domain: its tiles beat ``torch.matmul`` there),
at every dim <= 32 under ``"cuda"``. bf16/f16 compute in float32 and
round once on output.
"""
from __future__ import annotations

import torch

from ..core.dtypes import downcast, upcast_half
from ..kernels._launch import MAX_N, chol_rows, diag_log_sum, diag_product
from ..layouts.sym import _upper_rows_cols, sym_to_full
from .sym import _check_backend, _det_expand, _flat, _use_kernel

__all__ = ["batchdet", "batchinv", "batchmatvec", "batchmatmul", "batchlmdiv", "batchrmdiv",
           "batchchol", "batchlogdet"]

_CLOSED_FORM_MAX = 4
#: largest n of the plain pivoted-LU tier (above: torch.linalg)
LU_UNROLL_MAX = 16
#: the plain LU multiplies by the reciprocal pivot up to this n and
#: divides above (the reference's unrolled and rolled forms); the solve
#: kernel's RHS-column cap is 8 up to it and 16 above
_PLU_UNROLL_N = 8
_MATMUL_UNROLL_MAX = 6
#: ``batchmatvec`` on a CUDA tensor launches the matvec kernel for square
#: n up to this: on an H100 it ran faster than torch.matmul at n = 4..12
#: and slower from n = 16 (chip_smoke.py's routing sweep, ROADMAP.md)
MATVEC_KERNEL_MAX = 12
#: ``batchmatmul(backend="auto")`` on a CUDA tensor launches the product
#: kernel where every dim is up to this: it replaces the unrolled tier's
#: m n (2k - 1) elementwise launches to 6, and on an H100 its staged tiles
#: ran faster than torch.matmul on square n = 4..32, every size it takes
#: (the same sweep)
MATMUL_KERNEL_MAX = 32

_NO_REGULARIZE = ("backend='cuda' does not implement regularize=True (the "
                  "reference's det smoothing is a closed-form-path knob)")


# ---------------------------------------------------------------------------
# plain tiers
# ---------------------------------------------------------------------------


def _plu(a: torch.Tensor):
    """Batched LU with partial pivoting (first-max pivots, whole-row
    swaps): ``(lu, perm, parity)`` with unit-lower L below the diagonal
    of ``lu`` and U on and above it, ``(P A)[i] = A[perm[i]]``, and the
    permutation's sign. Multipliers by the reciprocal pivot up to
    n = 8, by division above, as the reference's two forms."""
    n = a.shape[-1]
    batch = a.shape[:-2]
    lu = a.reshape(-1, n, n).clone()
    nb = lu.shape[0]
    rows = torch.arange(nb, device=a.device)
    perm = torch.arange(n, device=a.device).repeat(nb, 1)
    # the sign is real for complex input too (a complex one cannot be compared)
    parity = torch.ones(nb, dtype=a.real.dtype, device=a.device)
    for k in range(n):
        p = k + torch.argmax(lu[:, k:, k].abs(), dim=1)
        row_k, row_p = lu[:, k].clone(), lu[rows, p]
        lu[:, k], lu[rows, p] = row_p, row_k
        perm_k, perm_p = perm[:, k].clone(), perm[rows, p]
        perm[:, k], perm[rows, p] = perm_p, perm_k
        parity = torch.where(p == k, parity, -parity)
        if k < n - 1:
            # copies: autograd keeps them, and lu changes in place below
            col, pv, row = (t.clone() for t in (lu[:, k + 1:, k], lu[:, k, k, None],
                                                lu[:, k, None, k + 1:]))
            l = col * (1.0 / pv) if n <= _PLU_UNROLL_N else col / pv
            lu[:, k + 1:, k + 1:] -= l[:, :, None] * row
            lu[:, k + 1:, k] = l
    return lu.reshape(*batch, n, n), perm.reshape(*batch, n), parity.reshape(batch)


def _lu_solve_unrolled(lu, perm, b):
    """Solve ``A x = b`` from :func:`_plu`'s factors; ``b`` is ``(..., n)``
    or ``(..., n, m)`` with the factors' batch."""
    vector = b.dim() == lu.dim() - 1
    if vector:
        b = b[..., None]
    n = lu.shape[-1]
    y = torch.gather(b, -2, perm[..., None].expand(*perm.shape, b.shape[-1]))
    ys = [y[..., i, :] for i in range(n)]
    for i in range(n):  # unit-lower L
        for j in range(i):
            ys[i] = ys[i] - lu[..., i, j, None] * ys[j]
    for i in range(n - 1, -1, -1):  # U
        for j in range(i + 1, n):
            ys[i] = ys[i] - lu[..., i, j, None] * ys[j]
        ys[i] = ys[i] / lu[..., i, i, None]
    x = torch.stack(ys, dim=-2)
    return x[..., 0] if vector else x


def _full_entries(a: torch.Tensor, n: int):
    """n x n grid of last-axes slices of a full (..., n, n) batch."""
    return [[a[..., i, j] for j in range(n)] for i in range(n)]


def _range_regularizer(a: torch.Tensor):
    """The reference's dynamic-range regularizer: ``(max|A| - min|A|) *
    1e-12`` per matrix."""
    aabs = a.abs().flatten(-2)
    return (aabs.amax(dim=-1) - aabs.amin(dim=-1)) * 1e-12


def _inv_torch(a, regularize):
    n = a.shape[-1]
    if n > LU_UNROLL_MAX:
        return torch.linalg.inv(a)
    if n > _CLOSED_FORM_MAX:
        lu, perm, _ = _plu(a)
        eye = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape)
        return _lu_solve_unrolled(lu, perm, eye)
    E = _full_entries(a, n)
    idx = tuple(range(n))
    cache = {}
    det = _det_expand(E, idx, idx, cache)
    if regularize:
        det = det + _range_regularizer(a)
    inv_det = 1.0 / det
    entries = []
    for i in range(n):
        for j in range(n):
            # inv[i][j] = cofactor(j, i) / det
            minor = _det_expand(E, tuple(r for r in idx if r != j),
                                tuple(c for c in idx if c != i), cache)
            entries.append((-minor if (i + j) % 2 else minor) * inv_det)
    return torch.stack(entries, dim=-1).reshape(a.shape)


def _det_torch(a):
    n = a.shape[-1]
    if n > LU_UNROLL_MAX:
        return torch.linalg.det(a)
    if n > _CLOSED_FORM_MAX:
        lu, _, parity = _plu(a)
        return diag_product(lu, parity)
    idx = tuple(range(n))
    return _det_expand(_full_entries(a, n), idx, idx, {})


def _logdet_torch(a):
    n = a.shape[-1]
    if n <= _CLOSED_FORM_MAX:
        return torch.log(torch.abs(_det_torch(a)))
    if n > LU_UNROLL_MAX:
        return torch.linalg.slogdet(a)[1]
    return diag_log_sum(_plu(a)[0])


def _chol_torch(a):
    n = a.shape[-1]
    if n > LU_UNROLL_MAX:
        # NaN where the matrix is not SPD, as jnp.linalg.cholesky (and no
        # wait for the device, as torch.linalg.cholesky's check would);
        # ``a`` is symmetrized by the caller
        L, info = torch.linalg.cholesky_ex(a)
        return torch.where(info[..., None, None] == 0, L, torch.nan)
    L = chol_rows(_full_entries(a, n), n)
    zero = torch.zeros_like(a[..., 0, 0])
    return torch.stack([torch.stack([L[i][j] if j <= i else zero for j in range(n)], dim=-1)
                        for i in range(n)], dim=-2)


# ---------------------------------------------------------------------------
# public ops
# ---------------------------------------------------------------------------


def _kernel_route(backend, n, a, op):
    """``(domain, kernel)`` of :func:`ops.sym._use_kernel` for the
    full-storage kernels."""
    return _use_kernel(backend, True, n, a, op, f"square matrices with 1 <= n <= {MAX_N}",
                       f"n={n}")


def _square(a, op):
    n = a.shape[-1]
    if a.shape[-2] != n:
        raise ValueError(f"{op} expects square matrices")
    return n


def batchdet(a: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """Batched determinant ``(..., n, n) -> (...)``.

    The kernel serves 1 <= n <= 32 (the closed form for n <= 4, pivoted
    LU above: ``sign * prod U_ii``). The plain tiers: the closed form for
    n <= 4, pivoted LU for n <= 16, ``torch.linalg.det`` beyond. In
    float32 the determinant of a large well-conditioned matrix can
    overflow; :func:`batchlogdet` is for that. Differentiable (``det *
    A^-T``, NaN at an exactly singular matrix above n = 4, as in the
    reference). See the module docstring for ``backend``.
    """
    a, half = upcast_half(a)
    n = _square(a, "batchdet")
    domain, kernel = _kernel_route(backend, n, a, "batchdet")
    if domain and backend != "torch":
        from ..kernels.batched_cuda import DetFunction

        det = DetFunction.apply(a.reshape(-1, n * n).contiguous(), kernel, False)
        return downcast(det.reshape(a.shape[:-2]), half)
    return downcast(_det_torch(a), half)


def batchlogdet(a: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """Batched ``log |det A|`` ``(..., n, n) -> (...)``.

    The kernel serves 1 <= n <= 32: for n <= 4 each row is scaled by its
    largest magnitude before the closed form (any scale stays in range;
    a zero row gives -inf), above it sums ``log |U_ii|`` of the pivoted
    LU, never the log of the product, so it stays finite where the
    determinant overflows. The plain tiers: ``log |det|`` of the closed
    form for n <= 4, the sum over the LU's pivots for n <= 16,
    ``torch.linalg.slogdet`` beyond. The logs are the device's
    ``torch.log`` (the reference's ``accmath.log`` works around the TPU's
    inaccurate one). Differentiable (``A^-T``). See the module docstring
    for ``backend``.
    """
    a, half = upcast_half(a)
    n = _square(a, "batchlogdet")
    domain, kernel = _kernel_route(backend, n, a, "batchlogdet")
    if domain and backend != "torch":
        from ..kernels.batched_cuda import LogdetFunction

        y = LogdetFunction.apply(a.reshape(-1, n * n).contiguous(), kernel, False)
        return downcast(y.reshape(a.shape[:-2]), half)
    return downcast(_logdet_torch(a), half)


def _lower_to_sym(a):
    """Compact storage of the lower triangle of ``a`` (..., n, n): the
    diagonal, then slot (i, j), i < j, holding ``a[j][i]``; the upper
    triangle is not read."""
    rows, cols = _upper_rows_cols(a.shape[-1], a.device)
    return torch.cat([a.diagonal(dim1=-2, dim2=-1), a[..., cols, rows]], dim=-1)


def batchchol(a: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """Batched lower Cholesky factor of SPD matrices ``(..., n, n) ->
    (..., n, n)``, zeros above the diagonal.

    Which entries are read follows the reference on every backend: for
    n <= 16 the lower triangle only (the upper triangle is never read,
    and its gradient is exactly 0); above, the average ``(A + Aᵀ)/2`` of
    the two triangles. On symmetric input the two rules agree.

    The kernel serves 1 <= n <= 32 on compact storage: the lower
    triangle is packed, factored (Cholesky-Banachiewicz for n <= 8, the
    outer-product form with ``rsqrt`` above) and the factor unpacked. On
    the card ``"auto"`` takes it at every n <= 32 (the reference's TPU
    routing takes it only for n > 16). The plain tiers: unrolled
    Cholesky-Banachiewicz for n <= 16, ``torch.linalg.cholesky_ex``
    beyond. No pivoting: a matrix that is not SPD gives NaN, with no
    error raised. Differentiable. See the module docstring for
    ``backend``.
    """
    a, half = upcast_half(a)
    n = _square(a, "batchchol")
    domain, kernel = _kernel_route(backend, n, a, "batchchol")
    if n > LU_UNROLL_MAX:
        a = (a + a.mT) / 2
    if domain and backend != "torch":
        from ..kernels.batched_cuda import CholFunction

        comp = _lower_to_sym(a).reshape(-1, n * (n + 1) // 2).contiguous()
        lc = CholFunction.apply(comp, kernel, False)
        return downcast(torch.tril(sym_to_full(lc, n)).reshape(a.shape), half)
    return downcast(_chol_torch(a), half)


def batchinv(a: torch.Tensor, regularize: bool = False, backend: str = "auto") -> torch.Tensor:
    """Batched inverse ``(..., n, n) -> (..., n, n)``.

    The kernel serves 1 <= n <= 32 (cofactors for n <= 4, pivoted LU
    against the identity above). The plain tiers: the closed form
    (adjugate / det) for n <= 4, pivoted LU for n <= 16, ``torch.linalg.inv``
    beyond. ``regularize=True`` adds the reference's range-scaled
    ``1e-12`` determinant smoothing on the closed-form tier (it has no
    effect above n = 4) and takes the plain tiers. Differentiable. See
    the module docstring for ``backend``.
    """
    a, half = upcast_half(a)
    n = _square(a, "batchinv")
    _check_backend(backend)
    if regularize and backend == "cuda":
        raise ValueError(_NO_REGULARIZE)
    domain, kernel = _kernel_route(backend, n, a, "batchinv")
    if domain and not regularize and backend != "torch":
        from ..kernels.batched_cuda import InvFunction

        y = InvFunction.apply(a.reshape(-1, n * n).contiguous(), kernel, False)
        return downcast(y.reshape(a.shape), half)
    return downcast(_inv_torch(a, regularize), half)


def batchmatvec(mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product ``(..., m, n) @ (..., n) -> (..., m)``;
    batch dims broadcast. On a CUDA tensor, square n <=
    ``MATVEC_KERNEL_MAX`` launches the matvec kernel. Otherwise: unrolled
    (each row summed left to right) for m, n <= 4, ``torch.matmul``
    beyond. Handles non-square. Differentiable."""
    mat, vec, half = upcast_half(mat, vec)
    m, n = mat.shape[-2:]
    if vec.shape[-1] != n:
        raise ValueError(f"matvec shape mismatch: {tuple(mat.shape)} @ {tuple(vec.shape)}")
    _, kernel = _use_kernel("auto", m == n, n, mat, "batchmatvec", "", "")
    if kernel and n <= MATVEC_KERNEL_MAX:
        from ..kernels.batched_cuda import MatvecFullFunction

        batch = torch.broadcast_shapes(mat.shape[:-2], vec.shape[:-1])
        y = MatvecFullFunction.apply(_flat(mat.flatten(-2), batch, n * n), _flat(vec, batch, n),
                                     False, True, False)
        return downcast(y.reshape(*batch, n), half)
    if m <= _CLOSED_FORM_MAX and n <= _CLOSED_FORM_MAX:
        rows = []
        for i in range(m):
            acc = mat[..., i, 0] * vec[..., 0]
            for j in range(1, n):
                acc = acc + mat[..., i, j] * vec[..., j]
            rows.append(acc)
        return downcast(torch.stack(rows, dim=-1), half)
    return downcast(torch.matmul(mat, vec[..., None])[..., 0], half)


def batchmatmul(a: torch.Tensor, b: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """Batched matmul ``(..., m, k) @ (..., k, n) -> (..., m, n)``; batch
    dims broadcast.

    The kernel (4 x 4 tiles of C a thread from operands staged in shared
    memory, each entry summed over k in order from the first term)
    serves real float32/float64 with every dim <= 32. ``"auto"`` launches it on a CUDA tensor where every dim is
    <= ``MATMUL_KERNEL_MAX``; ``"cuda"`` at every dim <= 32 (and raises
    outside that domain or on CPU tensors). Otherwise, and under
    ``"torch"``: unrolled (each entry summed over k in order) when every
    dim is <= 6, ``torch.matmul`` beyond. Differentiable.
    """
    a, b, half = upcast_half(a, b)
    m, k = a.shape[-2:]
    k2, n = b.shape[-2:]
    if k != k2:
        raise ValueError(f"matmul shape mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    dims = max(m, k, n)
    _, kernel = _use_kernel(backend, True, dims, a, "batchmatmul",
                            f"real-float batches with every dim <= {MAX_N}",
                            f"dims {(m, k, n)}")
    if kernel and (backend == "cuda" or dims <= MATMUL_KERNEL_MAX):
        from ..kernels.batched_cuda import MatmulFunction

        batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        y = MatmulFunction.apply(_flat(a.flatten(-2), batch, m * k),
                                 _flat(b.flatten(-2), batch, k * n), m, k, n, False, False, True,
                                 False)
        return downcast(y.reshape(*batch, m, n), half)
    if dims > _MATMUL_UNROLL_MAX:
        return downcast(torch.matmul(a, b), half)
    rows = []
    for i in range(m):
        row = []
        for j in range(n):
            acc = a[..., i, 0] * b[..., 0, j]
            for kk in range(1, k):
                acc = acc + a[..., i, kk] * b[..., kk, j]
            row.append(acc)
        rows.append(torch.stack(row, dim=-1))
    return downcast(torch.stack(rows, dim=-2), half)


def batchlmdiv(a: torch.Tensor, b: torch.Tensor, regularize: bool = False,
               backend: str = "auto") -> torch.Tensor:
    r"""Batched left division ``A \ b`` for small full matrices.

    ``b`` is a vector ``(..., n)`` or a matrix ``(..., n, k)``; batch
    dims broadcast. The solve kernel (pivoted LU, all k columns on one
    factorization) serves 1 <= n <= 32 with k <= 8 columns up to n = 8
    and k <= 16 above; ``"auto"`` takes it for n > 4. For n <= 4 the
    answer is :func:`batchinv` times ``b`` (the inverse kernel on a CUDA
    tensor). The plain tiers: pivoted LU for n <= 16,
    ``torch.linalg.solve`` beyond. ``regularize`` as in :func:`batchinv`.
    Differentiable. See the module docstring for ``backend``.
    """
    _check_backend(backend)
    a, b, half = upcast_half(a, b)
    n = a.shape[-1]
    vector = b.dim() == a.dim() - 1
    k = 1 if vector else b.shape[-1]
    k_cap = 16 if n > _PLU_UNROLL_N else 8
    if backend == "cuda":
        if regularize:
            raise ValueError(_NO_REGULARIZE)
        if k > k_cap:
            raise ValueError(f"backend='cuda' lmdiv caps RHS columns at {k_cap} for "
                             f"n={n}; got k={k}")
    # the broadcast batch: one shared matrix against many right-hand sides
    nbd = b.dim() - (1 if vector else 2)
    bshape = torch.broadcast_shapes(a.shape[:-2], b.shape[:nbd])
    domain, kernel = _kernel_route(backend, n, a, "batchlmdiv")
    if (domain and not regularize and k <= k_cap
            and (backend == "cuda" or (backend == "auto" and n > _CLOSED_FORM_MAX))):
        from ..kernels.batched_cuda import SolveFullFunction

        a2 = a.expand(*bshape, n, n).reshape(-1, n * n).contiguous()
        rhs = (b[..., None] if vector else b).expand(*bshape, n, k)
        x = SolveFullFunction.apply(a2, rhs.reshape(-1, n * k).contiguous(), k, False,
                                    kernel, False).reshape(*bshape, n, k)
        return downcast(x[..., 0] if vector else x, half)
    if n <= _CLOSED_FORM_MAX:
        inv = batchinv(a, regularize=regularize, backend=backend)
        return downcast(batchmatvec(inv, b) if vector else batchmatmul(inv, b), half)
    if n <= LU_UNROLL_MAX:
        lu, perm, _ = _plu(a.expand(*bshape, n, n))
        return downcast(_lu_solve_unrolled(lu, perm, b.expand(*bshape, *b.shape[nbd:])), half)
    if vector:
        return downcast(torch.linalg.solve(a, b[..., None])[..., 0], half)
    return downcast(torch.linalg.solve(a, b), half)


def batchrmdiv(a: torch.Tensor, b: torch.Tensor, regularize: bool = False,
               backend: str = "auto") -> torch.Tensor:
    """Batched right division ``a @ inv(b)``: the transpose of
    :func:`batchlmdiv` (``backend`` as there)."""
    return batchlmdiv(b.mT, a.mT, regularize=regularize, backend=backend).mT


def _chol_solve_unrolled(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SPD solve through :func:`batchchol` and unrolled triangular
    substitutions (real dtypes, n <= 8); ``b`` is ``(..., n)`` or
    ``(..., n, k)``, batch dims broadcast. ``sugar.lmdiv``/``inv`` take it
    for ``method="chol"``. It reads ``a`` as :func:`batchchol` does: the
    lower triangle only."""
    n = a.shape[-1]
    vector = b.dim() == a.dim() - 1
    if vector:
        b = b[..., None]
    bshape = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a = a.expand(*bshape, n, n)
    b = b.expand(*bshape, *b.shape[-2:])
    L = batchchol(a)
    ys = [b[..., i, :] for i in range(n)]
    for i in range(n):
        for j in range(i):
            ys[i] = ys[i] - L[..., i, j, None] * ys[j]
        ys[i] = ys[i] / L[..., i, i, None]
    for i in range(n - 1, -1, -1):
        for j in range(i + 1, n):
            ys[i] = ys[i] - L[..., j, i, None] * ys[j]
        ys[i] = ys[i] / L[..., i, i, None]
    x = torch.stack(ys, dim=-2)
    return x[..., 0] if vector else x
