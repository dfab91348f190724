"""Generate ``csrc/sym_adjugate.cuh``: straight-line cofactor grids for
N = 2, 3, 4, for the closed-form tier of the solve and chain kernels.

The expansion is the memoized Laplace expansion of
:func:`fastmath_tpu_torch.ops.sym._det_expand` (first remaining row,
columns in order, alternating signs), written out as C++ so that the
kernel computes the same terms in the same order as the plain version.
The header is committed; ``tests/test_torch_sym_kernels.py`` checks it
against this generator. Regenerate with::

    python -m fastmath_tpu_torch.kernels._gen_adjugate
"""
from __future__ import annotations

import pathlib

HEADER = pathlib.Path(__file__).parent / "csrc" / "sym_adjugate.cuh"
ORDERS = (2, 3, 4)


def _det_code(rows, cols, cache, lines):
    """Name of (or expression for) det(E[rows][cols]); emits one
    ``const T`` line per memoized minor of order >= 2."""
    key = (rows, cols)
    if key in cache:
        return cache[key]
    if len(rows) == 1:
        return f"E[{rows[0]}][{cols[0]}]"
    r0 = rows[0]
    if len(rows) == 2:
        r1 = rows[1]
        c0, c1 = cols
        expr = (f"E[{r0}][{c0}] * E[{r1}][{c1}] - "
                f"E[{r0}][{c1}] * E[{r1}][{c0}]")
    else:
        expr = ""
        for pos, c in enumerate(cols):
            sub_cols = cols[:pos] + cols[pos + 1:]
            minor = _det_code(rows[1:], sub_cols, cache, lines)
            term = f"E[{r0}][{c}] * {minor}"
            if pos == 0:
                expr = term
            else:
                expr = f"{expr} {'-' if pos % 2 else '+'} {term}"
    name = f"m{len(cache)}"
    lines.append(f"  const T {name} = {expr};")
    cache[key] = name
    return name


def cofactor_body(n: int):
    """C++ statements computing ``adj`` (adj[i][j] = cofactor(j, i)) and
    the name of the determinant, for an n x n entry grid ``E``."""
    cache, lines = {}, []
    idx = tuple(range(n))
    det = _det_code(idx, idx, cache, lines)
    for i in range(n):
        for j in range(n):
            rows = tuple(r for r in idx if r != j)
            cols = tuple(c for c in idx if c != i)
            minor = _det_code(rows, cols, cache, lines)
            sign = "-" if (i + j) % 2 else ""
            lines.append(f"  adj[{i}][{j}] = {sign}{minor};")
    return lines, det


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


def render() -> str:
    out = [
        "// Generated by fastmath_tpu_torch/kernels/_gen_adjugate.py; do not edit.",
        "// Cofactor grid adj (adj[i][j] = cofactor(j, i), so adj * v = det * A^-1 v)",
        "// and determinant of a small entry grid, by memoized Laplace expansion.",
        "#pragma once",
        "",
        "namespace fm {",
    ]
    for n in ORDERS:
        lines, det = cofactor_body(n)
        out += [
            "",
            "template <typename T>",
            f"__host__ __device__ __forceinline__ T sym_cofactors(const T (&E)[{n}][{n}],",
            f"                                                    T (&adj)[{n}][{n}]) {{",
            *lines,
            f"  return {det};",
            "}",
        ]
    out += ["", "}  // namespace fm", ""]
    return "\n".join(out)


if __name__ == "__main__":
    HEADER.write_text(render())
