"""Generate the straight-line cofactor headers of the closed-form tiers:
``csrc/sym_adjugate.cuh`` (for the compact kernels: cofactor grids for
N = 2, 3, 4, for the solve and chain; determinants and compact inverses
for N = 1 .. 4, for the determinant and inverse kernels) and
``csrc/batched_adjugate.cuh`` (for the full-storage kernels: inverses of
n x n matrices, n = 2, 3, 4; determinants and the row-scaled log|det|,
n = 1 .. 4).

All come from one expansion, the memoized Laplace expansion of
:func:`fastmath_tpu_torch.ops.sym._det_expand` (first remaining row,
columns in order, alternating signs), written out as C++ so that the
kernels compute the same terms in the same order as the plain versions.
They differ in their entry map only: the compact solves expand an entry
grid ``E[i][j]``, the compact determinant and inverse the compact
entries ``c[k]`` as the channels hold them (the diagonal first, then the
upper rows), the full-storage kernels the row-major entries
``a[i * n + j]``. The headers are committed;
``tests/test_torch_sym_kernels.py``, ``tests/test_torch_batched.py`` and
``tests/test_torch_factor.py`` check them against this generator.
Regenerate with::

    python -m fastmath_tpu_torch.kernels._gen_adjugate
"""
from __future__ import annotations

import pathlib

CSRC = pathlib.Path(__file__).parent / "csrc"
HEADER = CSRC / "sym_adjugate.cuh"
FULL_HEADER = CSRC / "batched_adjugate.cuh"
ORDERS = (2, 3, 4)
#: orders of the determinant-only and compact-inverse functions
DET_ORDERS = (1, 2, 3, 4)


def _grid(i, j, n):
    return f"E[{i}][{j}]"


def _row_major(i, j, n):
    return f"a[{i * n + j}]"


def _scaled(i, j, n):
    return f"s[{i * n + j}]"


def _compact(i, j, n):
    from ..layouts.sym import tri_index

    return f"c[{tri_index(i, j, n)}]"


def _det_code(rows, cols, cache, lines, entry, n):
    """Name of (or expression for) det(E[rows][cols]); emits one
    ``const T`` line per memoized minor of order >= 2. ``entry(i, j, n)``
    spells entry (i, j)."""
    key = (rows, cols)
    if key in cache:
        return cache[key]
    if not rows:  # the 0 x 0 minor of a 1 x 1 matrix
        return "T(1)"
    if len(rows) == 1:
        return entry(rows[0], cols[0], n)
    r0 = rows[0]
    if len(rows) == 2:
        r1 = rows[1]
        c0, c1 = cols
        expr = (f"{entry(r0, c0, n)} * {entry(r1, c1, n)} - "
                f"{entry(r0, c1, n)} * {entry(r1, c0, n)}")
    else:
        expr = ""
        for pos, c in enumerate(cols):
            sub_cols = cols[:pos] + cols[pos + 1:]
            minor = _det_code(rows[1:], sub_cols, cache, lines, entry, n)
            term = f"{entry(r0, c, n)} * {minor}"
            if pos == 0:
                expr = term
            else:
                expr = f"{expr} {'-' if pos % 2 else '+'} {term}"
    name = f"m{len(cache)}"
    lines.append(f"  const T {name} = {expr};")
    cache[key] = name
    return name


def _expansion(n, entry, emit):
    """The determinant, then ``emit(i, j, sign, minor)`` for each
    cofactor(j, i) in row-major (i, j) order; returns (lines, det)."""
    cache, lines = {}, []
    idx = tuple(range(n))
    det = _det_code(idx, idx, cache, lines, entry, n)
    for i in range(n):
        for j in range(n):
            rows = tuple(r for r in idx if r != j)
            cols = tuple(c for c in idx if c != i)
            minor = _det_code(rows, cols, cache, lines, entry, n)
            lines.append(emit(i, j, "-" if (i + j) % 2 else "", minor))
    return lines, det


def cofactor_body(n: int):
    """C++ statements computing ``adj`` (adj[i][j] = cofactor(j, i)) and
    the name of the determinant, for an n x n entry grid ``E``."""
    return _expansion(n, _grid, lambda i, j, s, m: f"  adj[{i}][{j}] = {s}{m};")


def inverse_body(n: int):
    """C++ statements computing the inverse ``inv[i * n + j] =
    cofactor(j, i) * (1 / det)`` of the row-major entries ``a``; the
    determinant comes first and its reciprocal is named ``inv_det``."""
    lines, det = _expansion(
        n, _row_major, lambda i, j, s, m: f"  inv[{i * n + j}] = {s}{m} * inv_det;")
    first = next(k for k, line in enumerate(lines) if line.startswith(f"  const T {det} "))
    lines.insert(first + 1, f"  const T inv_det = T(1) / {det};")
    return lines


def det_body(n: int, entry):
    """C++ statements and the name (or expression) of the determinant
    alone of order n, entries spelled by ``entry``."""
    lines = []
    det = _det_code(tuple(range(n)), tuple(range(n)), {}, lines, entry, n)
    return lines, det


def logdet_body(n: int):
    """C++ statements returning ``log |det A|`` of the row-major entries
    ``a`` with each row first scaled by its largest magnitude, as the
    reference's kernel does it: ``log |det A| = sum_i log r_i + log
    |det(S A)|`` keeps the expansion in range at any scale; a zero row
    scales to zero and gives -inf."""
    lines = []
    for i in range(n):
        r = f"fm_abs(a[{i * n}])"
        for j in range(1, n):
            r = f"fm_max({r}, fm_abs(a[{i * n + j}]))"
        lines.append(f"  const T r{i} = {r};")
        lines.append(f"  const T q{i} = r{i} > T(0) ? T(1) / r{i} : T(0);")
    scaled = ", ".join(f"a[{i * n + j}] * q{i}" for i in range(n) for j in range(n))
    lines.append(f"  const T s[{n * n}] = {{{scaled}}};")
    body, det = det_body(n, _scaled)
    logs = " + ".join(f"fm_log(r{i} > T(0) ? r{i} : T(1))" for i in range(n))
    return [*lines, *body, f"  return {logs} + fm_log(fm_abs({det}));"]


def compact_inverse_body(n: int):
    """C++ statements writing the compact inverse ``inv`` of the compact
    entries ``c``, in the reference kernel's slot order (the diagonal
    first, then the upper rows): slot (i, j), i <= j, holds
    ``cofactor(j, i) * (1 / det)``."""
    from ..layouts.sym import tri_index

    cache, lines = {}, []
    idx = tuple(range(n))
    det = _det_code(idx, idx, cache, lines, _compact, n)
    lines.append(f"  const T inv_det = T(1) / {det};")
    for i in range(n):
        for j in range(i, n):
            rows = tuple(r for r in idx if r != j)
            cols = tuple(c for c in idx if c != i)
            minor = _det_code(rows, cols, cache, lines, _compact, n)
            sign = "-" if (i + j) % 2 else ""
            lines.append(f"  inv[{tri_index(i, j, n)}] = {sign}{minor} * inv_det;")
    return lines


def _count_ops(lines) -> int:
    ops = 0
    for line in lines:
        if line.lstrip().startswith("const T"):
            rhs = line.split("=", 1)[1]
            ops += rhs.count("*") + rhs.count(" + ") + rhs.count(" - ")
    return ops


def cofactor_ops(n: int) -> int:
    """Arithmetic operations (multiplies, adds, subtracts) of the
    cofactor grid and determinant of order n; negations are free."""
    return _count_ops(cofactor_body(n)[0])


def det_ops(n: int) -> int:
    """Arithmetic operations of the determinant alone of order n."""
    return _count_ops(det_body(n, _row_major)[0])


def compact_inverse_ops(n: int) -> int:
    """Arithmetic operations of the compact inverse of order n: its
    cofactors and determinant, 1/det and the n(n+1)/2 scaled slots."""
    return _count_ops(compact_inverse_body(n)) + 1 + n * (n + 1) // 2


def _render(intro, functions, includes=()):
    out = [
        "// Generated by fastmath_tpu_torch/kernels/_gen_adjugate.py; do not edit.",
        *intro,
        "#pragma once",
        "",
        *includes,
        *([""] if includes else []),
        "namespace fm {",
    ]
    for signature, body in functions:
        out += ["", "template <typename T>", *signature, *body, "}"]
    out += ["", "}  // namespace fm", ""]
    return "\n".join(out)


def render() -> str:
    functions = []
    for n in ORDERS:
        lines, det = cofactor_body(n)
        functions.append((
            [f"__host__ __device__ __forceinline__ T sym_cofactors(const T (&E)[{n}][{n}],",
             f"                                                    T (&adj)[{n}][{n}]) {{"],
            [*lines, f"  return {det};"]))
    for n in DET_ORDERS:
        nn = n * (n + 1) // 2
        lines, det = det_body(n, _compact)
        functions.append(
            ([f"__host__ __device__ __forceinline__ T compact_det(const T (&c)[{nn}]) {{"],
             [*lines, f"  return {det};"]))
    for n in DET_ORDERS:
        nn = n * (n + 1) // 2
        functions.append((
            [f"__host__ __device__ __forceinline__ void compact_inverse(const T (&c)[{nn}],",
             f"                                                       T (&inv)[{nn}]) {{"],
            compact_inverse_body(n)))
    return _render(
        ["// Cofactor grid adj (adj[i][j] = cofactor(j, i), so adj * v = det * A^-1 v)",
         "// and determinant of a small entry grid; determinant and inverse of a small",
         "// compact matrix from its compact entries c (inverse slot (i, j), i <= j:",
         "// cofactor(j, i) * (1 / det)); by memoized Laplace expansion."],
        functions)


def render_full() -> str:
    functions = []
    for n in ORDERS:
        functions.append((
            [f"__host__ __device__ __forceinline__ void full_inverse(const T (&a)[{n * n}],",
             f"                                                    T (&inv)[{n * n}]) {{"],
            inverse_body(n)))
    for n in DET_ORDERS:
        lines, det = det_body(n, _row_major)
        functions.append(
            ([f"__host__ __device__ __forceinline__ T full_det(const T (&a)[{n * n}]) {{"],
             [*lines, f"  return {det};"]))
    for n in DET_ORDERS:
        functions.append(
            ([f"__device__ __forceinline__ T full_logdet(const T (&a)[{n * n}]) {{"],
             logdet_body(n)))
    return _render(
        ["// Inverse of a small full matrix from its row-major entries a[i * n + j]:",
         "// inv[i * n + j] = cofactor(j, i) * (1 / det); its determinant; and",
         "// log|det| with each row scaled by its largest magnitude first; by memoized",
         "// Laplace expansion."],
        functions, ['#include "sym_common.cuh"  // fm_abs, fm_max, fm_log'])


if __name__ == "__main__":
    HEADER.write_text(render())
    FULL_HEADER.write_text(render_full())
