"""The port's ``ops/realtransforms.py`` against
``fastmath_tpu.ops.realtransforms`` (JAX, CPU, x64).

The same float64 arrays go through both packages. Every DCT/DST type (I-IV)
and norm runs through both of the port's paths, the basis product
(``_matmul_last``) and the FFT (``_fft_last``), called directly at the same
small n, values and gradients; the public 1-D and N-D transforms and their
inverses run at several dims. Tolerance: normwise over the transformed
axis (over the whole array for N-D), 1e-12 relative to the reference's
result.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmath_tpu.ops import realtransforms as J

from fastmath_tpu_torch.ops import realtransforms as RT

from _torch_cpu import one_thread  # noqa: F401  (autouse)

TOL = 1e-12
NORMS = ["backward", "ortho", "forward", "ortho_scipy"]


def _close(got, want, axis=-1):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape,
                                                                 got.dtype, want.dtype)
    err = np.linalg.norm(got - want, axis=axis) / np.linalg.norm(want, axis=axis)
    assert err.max() <= TOL, err.max()


@pytest.mark.parametrize("type", [1, 2, 3, 4])
@pytest.mark.parametrize("fam", ["dct", "dst"])
def test_both_paths(fam, type, rng):
    # n = 2 (DCT-I's least), odd and even n
    for n in (2, 7, 8):
        x = rng.standard_normal((3, n))
        w = rng.standard_normal((3, n))
        for norm in NORMS:
            want, vjp = jax.vjp(lambda t: getattr(J, fam)(t, norm=norm, type=type),
                                jnp.asarray(x))
            gwant = vjp(jnp.asarray(w))[0]
            for path in (RT._matmul_last, RT._fft_last):
                xt = torch.tensor(x, requires_grad=True)
                got = path(xt, fam, type, norm)
                (got * torch.tensor(w)).sum().backward()
                _close(got, want)
                _close(xt.grad, gwant)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("fam", ["dct", "dst"])
def test_public_1d(fam, inverse, rng):
    name = ("i" if inverse else "") + fam
    x = rng.standard_normal((4, 5, 6))
    for type in (1, 2, 3, 4):
        for norm in NORMS:
            for dim in (-1, 0, 1, None):
                want = getattr(J, name)(jnp.asarray(x), dim, norm, type)
                _close(getattr(RT, name)(torch.tensor(x), dim, norm, type), want,
                       axis=-1 if dim is None else dim)


@pytest.mark.parametrize("fam", ["dct", "dst"])
def test_public_past_the_cut(fam, rng):
    # an axis longer than MATMUL_MAX_N takes the FFT path (the reference's
    # cut is its own, so there it is still its basis product)
    n = RT.MATMUL_MAX_N + 3
    x = rng.standard_normal((2, n))
    for type in (1, 2, 3, 4):
        for norm in NORMS:
            _close(getattr(RT, fam)(torch.tensor(x), -1, norm, type),
                   getattr(J, fam)(jnp.asarray(x), -1, norm, type))


@pytest.mark.parametrize("name", ["dctn", "idctn", "dstn", "idstn"])
def test_public_nd(name, rng):
    x = rng.standard_normal((3, 4, 5))
    for type in (1, 2, 3, 4):
        for dim in (None, (0, 2), [-1]):
            for norm in ("ortho", "forward"):
                want = getattr(J, name)(jnp.asarray(x), dim, norm, type)
                _close(getattr(RT, name)(torch.tensor(x), dim, norm, type), want, axis=None)


def test_complex_and_promotion(rng):
    z = rng.standard_normal((3, 6)) + 1j * rng.standard_normal((3, 6))
    _close(RT.dst(torch.tensor(z), norm="ortho", type=3), J.dst(jnp.asarray(z), norm="ortho",
                                                                  type=3))
    k = np.arange(12).reshape(2, 6)
    _close(RT.dct(torch.tensor(k)), J.dct(jnp.asarray(k)))  # int -> float64
    for dtype in (torch.float16, torch.bfloat16):
        assert RT.dct(torch.ones(2, 4, dtype=dtype)).dtype == torch.float32
    assert RT.idst(torch.ones(4, dtype=torch.complex64)).dtype == torch.complex64


def test_errors():
    with pytest.raises(ValueError, match="n >= 2"):
        RT.dct(torch.ones(3, 1), type=1)
    with pytest.raises(ValueError, match="types I-IV"):
        RT.dst(torch.ones(4), type=5)
    with pytest.raises(ValueError, match="Unknown norm"):
        RT.dct(torch.ones(4), norm="unitary")


def test_basis_is_made_once():
    RT._basis_t.cache_clear()
    x = torch.ones(2, 16, dtype=torch.float64)
    RT._matmul_last(x, "dct", 2, "ortho")
    RT._matmul_last(2 * x, "dct", 2, "ortho")
    info = RT._basis_t.cache_info()
    assert (info.misses, info.hits) == (1, 1)
