"""The port's ``ops/stochastic.py`` against ``fastmath_tpu.ops.stochastic``
(JAX, CPU, x64).

The two packages draw their probes from different generators, so they are
compared where the result does not depend on the draw, or statistically:

* Hutchinson with Rademacher probes on a diagonal operator is exact,
  zᵢ² = 1: ``trapprox`` equals tr(Aʲ) for every moment, 1e-12 relative,
  in both packages; Hutch++ is exact on an operator of rank <= its
  ceil(samples / 3) basis vectors (1e-12 relative);
* ``maxeig_power`` on a gapped block-diagonal operator converges to the
  same eigenvalue: within 1e-6 relative of the reference;
* ``vbald`` within the reference test's rtol 0.35 of ``slogdet``
  (``tests/test_stochastic.py``), Gaussian Hutchinson within its 0.15;
* the same ``generator`` seed gives the same result, another seed another,
  and no estimator touches torch's global random state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmath_tpu.ops import stochastic as J

from fastmath_tpu_torch.ops import stochastic as ST

from _torch_cpu import one_thread  # noqa: F401  (autouse)

TOL = 1e-12
F64 = torch.float64


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _spd(rng, n, cond):
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (q * np.linspace(1.0, cond, n)) @ q.T


def _rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


def test_hutchinson_exact_on_diagonal(rng):
    d = rng.random(40) + 0.5
    want = np.array([np.sum(d ** j) for j in (1, 2, 3, 4)])
    ref = J.trapprox(lambda x: jnp.asarray(d) * x, shape=(40,), moments=4, samples=3,
                     key=jax.random.key(1))
    dt = torch.tensor(d)
    for got in (ST.trapprox(lambda x: dt * x, shape=(40,), moments=4, samples=3,
                            generator=_gen(1), dtype=F64, device="cpu"),
                ST.trapprox(torch.diag(dt), moments=4, samples=3, generator=_gen(2))):
        assert got.shape == (4,) and got.dtype == F64
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL)
    # moments=None is the scalar trace; a batch is one block-diagonal operator
    got = ST.trapprox(torch.diag_embed(dt.reshape(4, 10)), samples=2, generator=_gen(3))
    assert got.shape == () and _rel(got, d.sum()) <= TOL


def test_hutchpp_exact_at_low_rank(rng):
    v, _ = np.linalg.qr(rng.standard_normal((30, 3)))
    a = (v * np.array([5.0, 2.0, 0.5])) @ v.T  # rank 3 <= ceil(12 / 3)
    want = [np.trace(np.linalg.matrix_power(a, j)) for j in (1, 2)]
    ref = J.trapprox(jnp.asarray(a), moments=2, samples=12, hutchpp=True, key=jax.random.key(4))
    got = ST.trapprox(torch.tensor(a), moments=2, samples=12, hutchpp=True, generator=_gen(4))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL)
    at = torch.tensor(a)
    got = ST.trapprox(lambda x: at @ x, shape=(30,), samples=12, hutchpp=True,
                      generator=_gen(5), dtype=F64, device="cpu")
    assert _rel(got, want[0]) <= TOL


def test_maxeig_power_block_diagonal(rng):
    # 4 blocks of 8 x 8, spectra in [1, 10] and one block's top at 20:
    # the global max eigenvalue, gap 2
    blocks = np.stack([_spd(rng, 8, 10.0) for _ in range(4)])
    w, u = np.linalg.eigh(blocks[2])
    w[-1] = 20.0
    blocks[2] = (u * w) @ u.T
    kw = dict(max_iter=2000, tol=1e-12)
    ref = J.maxeig_power(jnp.asarray(blocks), key=jax.random.key(6), **kw)
    bt = torch.tensor(blocks)
    got = ST.maxeig_power(bt, generator=_gen(6), **kw)
    assert got.shape == () and got.dtype == F64
    assert _rel(got, ref) <= 1e-6 and _rel(got, 20.0) <= 1e-6
    got = ST.maxeig_power(lambda x: (bt @ x[..., None])[..., 0], shape=(4, 8),
                          generator=_gen(7), dtype=F64, device="cpu", **kw)
    assert _rel(got, ref) <= 1e-6


def test_maxeig_power_stops_as_the_while_loop(rng):
    # the step the reference's while_loop stops at: max_iter, or the first
    # |mu - mu_prev| < tol; counted by the operator's calls
    a = torch.tensor(_spd(rng, 12, 3.0))
    calls = []

    def mv(x):
        calls.append(1)
        return a @ x

    for max_iter, tol, steps in ((5, 0.0, 5), (11, 0.0, 11), (0, 1.0, 0)):
        calls.clear()
        mu = ST.maxeig_power(mv, shape=(12,), max_iter=max_iter, tol=tol, dtype=F64,
                             device="cpu", generator=_gen(0))
        assert len(calls) >= steps
        # the result is the Rayleigh quotient after exactly `steps` steps
        v = ST._sample(_gen(0), "r", (12,), F64, "cpu")
        want = torch.inf
        for _ in range(steps):
            w = a @ v
            want = float(v @ w)
            v = w / w.norm()
        assert float(mu) == want
    # a tolerance: the first step whose change is below it
    mus, v = [], ST._sample(_gen(0), "r", (12,), F64, "cpu")
    for _ in range(40):
        w = a @ v
        mus.append(float(v @ w))
        v = w / w.norm()
    tol = 1e-3
    stop = next(i for i in range(1, 40) if abs(mus[i] - mus[i - 1]) < tol)
    mu = ST.maxeig_power(a, tol=tol, generator=_gen(0))
    assert float(mu) == mus[stop]


def test_vbald(rng):
    a = _spd(rng, 60, 20.0)
    want = np.linalg.slogdet(a)[1]
    got = ST.vbald(torch.tensor(a), mc_samples=512, samples=20, generator=_gen(8))
    assert got.shape == () and _rel(got, want) <= 0.35


def test_gaussian_probes(rng):
    a = _spd(rng, 30, 10.0)
    got = ST.trapprox(torch.tensor(a), samples=2000, method="gaussian", generator=_gen(5))
    assert _rel(got, np.trace(a)) <= 0.15


def test_generator_reproducible_and_global_state_untouched(rng):
    a = torch.tensor(_spd(rng, 20, 5.0))
    torch.manual_seed(123)
    state = torch.get_rng_state()
    runs = {
        "trapprox": lambda g: ST.trapprox(a, samples=5, generator=g),
        "hutchpp": lambda g: ST.trapprox(a, samples=6, hutchpp=True, generator=g),
        "maxeig_power": lambda g: ST.maxeig_power(a, max_iter=3, generator=g),
        "vbald": lambda g: ST.vbald(a, generator=g),
    }
    for name, run in runs.items():
        first, again, other = run(_gen(9)), run(_gen(9)), run(_gen(10))
        assert float(first) == float(again), name
        assert float(first) != float(other), name
        assert float(run(None)) == float(run(_gen(0))), name  # the default: seeded 0
        assert torch.equal(torch.get_rng_state(), state), name


def test_callable_needs_shape():
    with pytest.raises(ValueError, match="shape="):
        ST.trapprox(lambda x: x)
