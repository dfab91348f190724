"""The rolled tier's first-max partial pivoting (9 <= n <= 32) on inputs
whose pivot columns tie: the port's plain versions of the determinant,
log-determinant and compact inverse (``det_plain``, ``logdet_plain``,
``invert_plain``, which the lane-group CUDA kernels of
``csrc/lu_groups.cuh`` mirror) against the reference's Pallas kernels run
in interpret mode, at n = 9 and 16.

The pivot of column k is the first largest |a[i][k]| in the order left by
the earlier swaps. On ties a wrong rule shows as a flipped determinant
sign, or as other roundings. The inputs: Hadamard blocks under signed
permutations (every entry of a column ties), scaled permutation matrices
(every step swaps) and matrices of integers in [-2, 2] with condition
number <= 60, 66 problems each, float64. The determinant's sign must
match exactly; the values within ``1e-10`` relative (``1e-10 * max(1,
|logdet|)`` absolute for log|det|). The kernels are held against these
plain versions on the card by ``tests/test_torch_factor_groups_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmath_tpu import kernels as PK

from fastmath_tpu_torch import kernels as K

BLOCK = 128  # interpret-mode block of the Pallas kernels


def _compact(full):
    n = full.shape[-1]
    rows, cols = np.triu_indices(n, k=1)
    return np.concatenate([np.diagonal(full, axis1=-2, axis2=-1), full[..., rows, cols]],
                          axis=-1)


def _hadamard(n):
    """Sylvester's Hadamard block of the largest power of two <= n, then 2 I
    (symmetric)."""
    h = np.ones((1, 1))
    while 2 * h.shape[0] <= n:
        h = np.block([[h, h], [h, -h]])
    m = 2.0 * np.eye(n)
    m[:h.shape[0], :h.shape[0]] = h
    return m


def _tie_heavy(rng, n, sym, b=22):
    """Inputs whose pivot columns tie: a Hadamard block under signed
    permutations (P D H D P^T if ``sym``), scaled permutation matrices
    (symmetric: scaled, signed involutions), and matrices of integers in
    [-2, 2] with condition number <= 60."""
    h, out = _hadamard(n), []
    for _ in range(b):
        p = np.eye(n)[rng.permutation(n)]
        d = np.diag(rng.choice([-1.0, 1.0], n))
        out.append(p @ d @ h @ d @ p.T if sym else d @ p @ h @ p.T[::-1])
    for _ in range(b):
        if sym:
            perm, idx = np.arange(n), rng.permutation(n)
            for q in range(0, n - 1, 2):
                perm[idx[q]], perm[idx[q + 1]] = idx[q + 1], idx[q]
            d = np.diag(rng.choice([-1.0, 1.0], n))
            out.append(rng.choice([2.0, 3.0]) * d @ np.eye(n)[perm] @ d)
        else:
            out.append(np.eye(n)[rng.permutation(n)] * rng.choice([-3.0, 2.0, 3.0], n)[:, None])
    ints = []
    while len(ints) < b:
        a = rng.integers(-2, 3, (4 * b, n, n)).astype(np.float64)
        if sym:
            a = np.triu(a) + np.triu(a, 1).transpose(0, 2, 1)
        ints += [m for m, c in zip(a, np.linalg.cond(a)) if c <= 60]
    return np.stack(out + ints[:b])


@pytest.mark.parametrize("n", [9, 16])
@pytest.mark.parametrize("name", ["det_cf", "logdet_cf", "sym_invert_cf"])
def test_rolled_pivots_on_ties_match_pallas(name, n, rng):
    # the rolled tier's first-max pivoting on tie-heavy input: the plain
    # versions (which the lane-group kernels mirror) against the reference
    # kernel in interpret mode, the determinant's sign exactly
    full = _tie_heavy(rng, n, sym=name == "sym_invert_cf")
    b = len(full)
    mat = _compact(full) if name == "sym_invert_cf" else full.reshape(b, n * n)
    mat = np.ascontiguousarray(mat.T)
    wrapper = getattr(K, name)
    got = wrapper(torch.from_numpy(mat)).numpy()
    want = np.asarray(getattr(PK, name)(jnp.asarray(mat), block=BLOCK, interpret=True))
    assert got.shape == want.shape
    if name == "logdet_cf":
        assert np.all(np.abs(got - want) <= 1e-10 * np.maximum(1.0, np.abs(want)))
    elif name == "det_cf":
        assert np.all(np.abs(want) > 0.5)  # nonsingular integer-valued determinants
        np.testing.assert_array_equal(np.sign(got), np.sign(want))
        np.testing.assert_allclose(got, want, rtol=1e-10)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12 * np.abs(want).max())
