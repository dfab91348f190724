"""The port's ``ops/reduce.py``, ``core/shapes.py``, ``core`` dtype helpers
and ``utils`` against ``fastmath_tpu`` (JAX, CPU, x64).

The same float64 arrays, made with numpy from a seed, go through both
packages. Values agree at rtol 1e-12 (NaN where the reference has NaN,
inf where it has inf); indices, shapes and dtypes agree exactly. The
arrays hold ties (small integers), scattered NaN and all-NaN slices along
every reduced dim tested.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmath_tpu import core as JC
from fastmath_tpu import utils as JU
from fastmath_tpu.ops import reduce as J

from fastmath_tpu_torch import core as TC
from fastmath_tpu_torch import utils as TU
from fastmath_tpu_torch.ops import reduce as R

from _torch_cpu import one_thread  # noqa: F401  (autouse)

TOL = 1e-12


def _laced(rng):
    """(3, 4, 5) float64 with ties, 30% NaN, the slice [:, 1, :] all NaN
    (dims (0, 2) and -1) and [2, :, 3] all NaN (dim 1)."""
    x = rng.integers(0, 4, (3, 4, 5)).astype(np.float64)
    x[rng.random(x.shape) < 0.3] = np.nan
    x[:, 1, :] = np.nan
    x[2, :, 3] = np.nan
    return x


def _same(got, want, exact=False):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        _same(got[0], want[0])
        _same(got[1], want[1], exact=True)
        return
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape,
                                                                 got.dtype, want.dtype)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=0)


DIMS = [None, 1, -1, (0, 2), (2, 0), [1]]


@pytest.mark.parametrize("dim", DIMS, ids=str)
@pytest.mark.parametrize("name", ["min", "max", "nanmin", "nanmax", "median"])
def test_picking(name, dim, rng):
    # ties pick the first position; all-NaN slices give -inf / +inf
    # (nanmax / nanmin) and NaN (median); dim=None returns the value alone
    x = _laced(rng)
    for keepdim in (False, True):
        for ri in (False, True):
            want = getattr(J, name)(jnp.asarray(x), dim=dim, keepdim=keepdim, return_indices=ri)
            got = getattr(R, name)(torch.tensor(x), dim=dim, keepdim=keepdim, return_indices=ri)
            _same(got, want)


@pytest.mark.parametrize("dim", [None, 1, (0, 2)], ids=str)
@pytest.mark.parametrize("name", ["sum", "nansum", "mean", "nanmean", "var", "nanvar", "std",
                                  "nanstd"])
def test_moments(name, dim, rng):
    x = _laced(rng)
    x[0, 2, :] = [np.nan, np.nan, 1.5, np.nan, np.nan]  # one value: w = 1
    kws = [{}] if "var" not in name and "std" not in name else [{"unbiased": True},
                                                                 {"unbiased": False}]
    for keepdim in (False, True):
        for kw in kws:
            want = getattr(J, name)(jnp.asarray(x), dim=dim, keepdim=keepdim, **kw)
            got = getattr(R, name)(torch.tensor(x), dim=dim, keepdim=keepdim, **kw)
            _same(got, want)


@pytest.mark.parametrize("name", ["sum", "mean", "var", "std"])
def test_omitnan_flag(name, rng):
    # omitnan=True on the plain name is the nan-variant, and inplace / out
    # are accepted and ignored
    x = _laced(rng)
    want = getattr(J, name)(jnp.asarray(x), dim=(0, 2), omitnan=True)
    _same(getattr(R, name)(torch.tensor(x), dim=(0, 2), omitnan=True, inplace=True, out=None),
          want)


def test_nanvar_is_corrected_second_moment(rng):
    # E[x^2] - E[x]^2 (the reference's E[x^2] - E[x] is not kept)
    x = rng.standard_normal((6, 9)) + 3.0
    x[rng.random(x.shape) < 0.2] = np.nan
    got = R.nanvar(torch.tensor(x), dim=1, unbiased=False).numpy()
    np.testing.assert_allclose(got, np.nanvar(x, axis=1), rtol=1e-12)


def test_integer_input():
    # integers reduce without raising; mean / var compute in the default
    # float dtype (float64 here, to compare with the x64 reference)
    x = np.arange(12).reshape(3, 4)
    xt = torch.tensor(x)
    for name, kw in (("sum", {}), ("median", {"dim": None}), ("max", {"dim": 1,
                                                                      "return_indices": True}),
                     ("median", {"dim": 0, "return_indices": True}), ("nanmin", {"dim": 1})):
        _same(getattr(R, name)(xt, **kw), getattr(J, name)(jnp.asarray(x), **kw))
    assert R.mean(xt).dtype == torch.get_default_dtype()
    assert R.var(xt, dim=1).dtype == torch.get_default_dtype()
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        for name in ("mean", "var", "std", "nanvar"):
            _same(getattr(R, name)(xt, dim=1), getattr(J, name)(jnp.asarray(x), dim=1))
    finally:
        torch.set_default_dtype(default)


@pytest.mark.parametrize("name", ["nansum", "nanmean", "nanvar", "nanmax", "median"])
def test_gradients(name, rng):
    x = rng.standard_normal((4, 6))
    x[rng.random(x.shape) < 0.25] = np.nan
    x[1, 2] = x[1, 4] = 7.0  # a tie of the row max
    want = jax.grad(lambda t: jnp.nansum(getattr(J, name)(t, dim=1) * jnp.arange(1.0, 5.0)))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    torch.nansum(getattr(R, name)(xt, dim=1) * torch.arange(1.0, 5.0, dtype=torch.float64)
                 ).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=TOL, atol=0)


def test_shapes(rng):
    for x, n in (([1, 2], None), ((3,), 3), (5, 2), (np.arange(4), 2), ([1, 2, 3], 2)):
        assert TC.ensure_tuple(x, n) == JC.ensure_tuple(x, n)
    assert TC.ensure_tuple(torch.arange(3)) == (0, 1, 2)
    for axes in (None, 1, -1, (2, 0), [-3, 1]):
        assert TC.normalize_axes(axes, 3) == JC.normalize_axes(axes, 3)
    for bad in ((0, -3), 3):
        with pytest.raises(ValueError):
            TC.normalize_axes(bad, 3)
    shape = (3, 4, 5)
    flat = rng.integers(0, 60, (2, 7))
    subs = TC.ind2sub(torch.tensor(flat), shape)
    _same(subs, JC.ind2sub(jnp.asarray(flat), shape), exact=True)
    _same(TC.sub2ind(subs, shape), JC.sub2ind(jnp.asarray(subs.numpy()), shape), exact=True)
    _same(TC.sub2ind(list(subs), shape), jnp.asarray(flat), exact=True)
    assert TC.broadcast_batch_shapes((3, 1), (1, 4), ()) == JC.broadcast_batch_shapes(
        (3, 1), (1, 4), ())


DTYPES = ["float16", "bfloat16", "float32", "float64", "complex64", "complex128", "int32",
          "int64", "bool"]


@pytest.mark.parametrize("name", DTYPES)
def test_dtype_helpers(name):
    td, jd = getattr(torch, name), jnp.dtype(name)
    names = lambda d: str(d).replace("torch.", "")  # noqa: E731
    assert names(TC.promote_transform_dtype(td)) == str(JC.promote_transform_dtype(jd))
    assert names(TC.result_real_dtype(td)) == str(JC.result_real_dtype(jd))
    if td.is_floating_point or td.is_complex:
        assert TC.eps(td) == JC.eps(jd)
        assert TC.as_float(td) is td
    else:
        with pytest.raises(TypeError):
            TC.eps(td)
        # the port's rule: the default dtype (the reference under x64: float64)
        assert TC.as_float(td) == torch.get_default_dtype()


def test_utils(rng):
    x = rng.standard_normal((3, 4, 5))
    assert TU.ensure_list(3, 2) == JU.ensure_list(3, 2)
    for index, dim in ((1, -1), (slice(1, 3), 0)):
        _same(TU.fast_slice_tensor(torch.tensor(x), index, dim),
              JU.fast_slice_tensor(jnp.asarray(x), index, dim))
    for index, dim in (((1, slice(0, 2)), None), ((slice(None, None, 2), 0), (0, 2)),
                       (2, (1, -1))):
        _same(TU.slice_tensor(torch.tensor(x), index, dim),
              JU.slice_tensor(jnp.asarray(x), index, dim))
    for rev in (False, True):
        for exc in (False, True):
            assert TU.cumprod([2, 3, 4], rev, exc) == JU.cumprod([2, 3, 4], rev, exc)
    g = rng.standard_normal((2, 3, 4, 5))
    for shape in ((3, 1, 5), (1, 4, 1), (4, 5)):
        _same(TU.broadcast_backward(torch.tensor(g), shape),
              JU.broadcast_backward(jnp.asarray(g), shape))
    f = lambda t: t  # noqa: E731
    assert TU.custom_fwd(f) is f and TU.custom_bwd(f) is f
    assert TU.eps(torch.float32) == JU.eps(jnp.float32)
