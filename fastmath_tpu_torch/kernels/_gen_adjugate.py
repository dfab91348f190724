"""Generate the straight-line cofactor headers of the closed-form tiers:
``csrc/sym_adjugate.cuh`` (cofactor grids for N = 2, 3, 4, for the
compact solve and chain kernels) and ``csrc/batched_adjugate.cuh``
(inverses of full n x n matrices, n = 2, 3, 4, for the inverse kernel).

Both come from one expansion, the memoized Laplace expansion of
:func:`fastmath_tpu_torch.ops.sym._det_expand` (first remaining row,
columns in order, alternating signs), written out as C++ so that the
kernels compute the same terms in the same order as the plain versions.
The two differ in their entry map only: the compact kernels expand an
entry grid ``E[i][j]``, the inverse kernel the row-major entries
``a[i * n + j]`` of a full matrix as its channels hold them. The headers
are committed; ``tests/test_torch_sym_kernels.py`` and
``tests/test_torch_batched.py`` check them against this generator.
Regenerate with::

    python -m fastmath_tpu_torch.kernels._gen_adjugate
"""
from __future__ import annotations

import pathlib

CSRC = pathlib.Path(__file__).parent / "csrc"
HEADER = CSRC / "sym_adjugate.cuh"
FULL_HEADER = CSRC / "batched_adjugate.cuh"
ORDERS = (2, 3, 4)


def _grid(i, j, n):
    return f"E[{i}][{j}]"


def _row_major(i, j, n):
    return f"a[{i * n + j}]"


def _det_code(rows, cols, cache, lines, entry, n):
    """Name of (or expression for) det(E[rows][cols]); emits one
    ``const T`` line per memoized minor of order >= 2. ``entry(i, j, n)``
    spells entry (i, j)."""
    key = (rows, cols)
    if key in cache:
        return cache[key]
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


def cofactor_ops(n: int) -> int:
    """Arithmetic operations (multiplies, adds, subtracts) of the
    cofactor grid and determinant of order n; negations are free."""
    lines, _ = cofactor_body(n)
    ops = 0
    for line in lines:
        if line.lstrip().startswith("const T"):
            rhs = line.split("=", 1)[1]
            ops += rhs.count("*") + rhs.count(" + ") + rhs.count(" - ")
    return ops


def _render(intro, functions):
    out = [
        "// Generated by fastmath_tpu_torch/kernels/_gen_adjugate.py; do not edit.",
        *intro,
        "#pragma once",
        "",
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
    return _render(
        ["// Cofactor grid adj (adj[i][j] = cofactor(j, i), so adj * v = det * A^-1 v)",
         "// and determinant of a small entry grid, by memoized Laplace expansion."],
        functions)


def render_full() -> str:
    functions = []
    for n in ORDERS:
        functions.append((
            [f"__host__ __device__ __forceinline__ void full_inverse(const T (&a)[{n * n}],",
             f"                                                    T (&inv)[{n * n}]) {{"],
            inverse_body(n)))
    return _render(
        ["// Inverse of a small full matrix from its row-major entries a[i * n + j]:",
         "// inv[i * n + j] = cofactor(j, i) * (1 / det), by memoized Laplace expansion."],
        functions)


if __name__ == "__main__":
    HEADER.write_text(render())
    FULL_HEADER.write_text(render_full())
