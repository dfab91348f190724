"""The port's ``parallel`` against ``fastmath_tpu.parallel`` (JAX, the
conftest's 8-device CPU mesh), with the same inputs; the port's mesh is
``torch.device("cpu")`` four times, which runs the split, the per-shard
call and the gather.

* ``shard_batch(sym_solve)`` at 1e-12 relative, also on shards from
  ``put_batch``;
* ``shard_reduce`` of ``nansum``, ``sum`` and ``mean_weighted``, at 1e-12;
* ``trapprox_sharded`` within the reference test's 0.1 of the trace (the
  draws differ, so both packages are held to the trace);
* ``donating`` returns the result in the donated tensor's storage;
* ``make_mesh``'s errors: too few devices, and no CUDA device with no
  ``devices`` given.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmath_tpu import parallel as JP
from fastmath_tpu.layouts import full_to_sym as j_full_to_sym
from fastmath_tpu.ops import reduce as JR
from fastmath_tpu.ops import sym as JS

import fastmath_tpu_torch as T
from fastmath_tpu_torch import parallel as PAR

from _torch_cpu import one_thread  # noqa: F401  (autouse)

TOL = 1e-12
CPU4 = [torch.device("cpu")] * 4


@pytest.fixture(scope="module")
def mesh():
    return PAR.make_mesh(devices=CPU4)


def test_make_mesh(mesh):
    assert mesh.shape["dp"] == 4 and mesh.devices.ravel().tolist() == CPU4
    m2 = PAR.make_mesh((2, 2), axis_names=("dp", "mp"), devices=CPU4)
    assert m2.shape == {"dp": 2, "mp": 2}
    assert PAR.batch_sharding(mesh, 3, batch_axis=1).spec == (None, "dp", None)
    with pytest.raises(ValueError, match=r"mesh \(8,\) needs 8 devices, have 4"):
        PAR.make_mesh(8, devices=CPU4)


def test_make_mesh_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PAR.make_mesh()


def test_shard_batch_sym_solve(rng, mesh):
    b, n = 64, 3
    a = rng.standard_normal((b, n, n))
    full = np.einsum("...ij,...kj->...ik", a, a) + n * np.eye(n)
    vec = rng.standard_normal((b, n))
    jmesh = JP.make_mesh()
    jc = JP.put_batch(j_full_to_sym(jnp.asarray(full)), jmesh)
    want = np.asarray(jax.jit(JP.shard_batch(JS.sym_solve, jmesh))(jc, JP.put_batch(
        jnp.asarray(vec), jmesh)))
    c, v = T.full_to_sym(torch.tensor(full)), torch.tensor(vec)
    solve = PAR.shard_batch(T.sym_solve, mesh)
    for args in ((c, v), (PAR.put_batch(c, mesh), PAR.put_batch(v, mesh))):
        got = solve(*args)
        assert got.shape == (b, n)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=0)
    with pytest.raises(ValueError, match="does not split"):
        solve(c[:63], v[:63])


def test_shard_reduce_nansum(rng, mesh):
    x = rng.standard_normal((64, 5))
    x[rng.random((64, 5)) < 0.2] = np.nan
    jmesh = JP.make_mesh()
    xs = JP.put_batch(jnp.asarray(x), jmesh)
    j_sum = float(JP.shard_reduce(lambda s: JR.nansum(s), combine="sum", mesh=jmesh)(xs))
    j_mean = float(JP.shard_reduce(lambda s: (JR.nansum(s), jnp.sum(~jnp.isnan(s))),
                                   combine="mean_weighted", mesh=jmesh)(xs))
    t = torch.tensor(x)
    got_sum = PAR.shard_reduce(T.nansum, combine="sum", mesh=mesh)(t)
    got_mean = PAR.shard_reduce(lambda s: (T.nansum(s), (~torch.isnan(s)).sum()),
                                combine="mean_weighted", mesh=mesh)(t)
    np.testing.assert_allclose(got_sum.item(), j_sum, rtol=TOL)
    np.testing.assert_allclose(got_mean.item(), j_mean, rtol=TOL)
    np.testing.assert_allclose(got_mean.item(), np.nanmean(x), rtol=TOL)
    with pytest.raises(ValueError, match="mesh is required"):
        PAR.shard_reduce(T.nansum)
    with pytest.raises(ValueError, match="unknown combine"):
        PAR.shard_reduce(T.nansum, combine="concat", mesh=mesh)


def test_trapprox_sharded(rng, mesh):
    a = rng.standard_normal((40, 40))
    a = a @ a.T + 40 * np.eye(40)
    aj, at = jnp.asarray(a), torch.tensor(a)
    jmesh = JP.make_mesh()
    want = np.trace(a)
    j_t = float(JP.trapprox_sharded(lambda x: aj @ x, (40,), jmesh, samples=512,
                                    key=jax.random.key(0)))
    np.testing.assert_allclose(j_t, want, rtol=0.1)
    got = PAR.trapprox_sharded(lambda x: at @ x, (40,), mesh, samples=512,
                               generator=torch.Generator().manual_seed(0), dtype=at.dtype)
    np.testing.assert_allclose(got.item(), want, rtol=0.1)
    # the tensor operator gives the same draws; moments have their shape
    same = PAR.trapprox_sharded(at, None, mesh, samples=512,
                                generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(same.item(), got.item(), rtol=TOL)
    mom = PAR.trapprox_sharded(at, None, mesh, moments=2, samples=512)
    assert mom.shape == (2,)
    np.testing.assert_allclose(mom[1].item(), np.trace(a @ a), rtol=0.1)


def test_donating(rng):
    b, n = 16, 3
    a = rng.standard_normal((b, n, n))
    c = T.full_to_sym(torch.tensor(np.einsum("...ij,...kj->...ik", a, a) + n * np.eye(n)))
    v = torch.tensor(rng.standard_normal((b, n)))
    want = T.sym_solve(c, v)
    v2 = v.clone()
    got = PAR.donating(T.sym_solve_, argnums=(1,))(c, v2)
    assert got.data_ptr() == v2.data_ptr()
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # no donated argument of the result's shape: returned as it is
    out = PAR.donating(T.sym_outer)(v)
    np.testing.assert_array_equal(out.numpy(), T.sym_outer(v).numpy())
