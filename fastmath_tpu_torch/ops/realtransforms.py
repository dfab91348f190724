"""DCT / DST types I-IV with backward / ortho / forward / ortho_scipy
norms, 1-D and N-D, plus inverses.

PyTorch counterpart of ``fastmath_tpu/ops/realtransforms.py``: the same
names, definitions (scipy's, type 4 included), norms and dtype promotion,
as plain torch ops on the input's device (the JAX package has no kernel
here). ``ortho`` is the truly orthogonal variant of all eight transforms;
``ortho_scipy`` is the legacy scipy/cupy "ortho", which differs from it
only for DST-II/III. Inverses are the flipped type with the flipped norm.

Two paths, cut at :data:`MATMUL_MAX_N`:

* **Basis product** (axis length <= ``MATMUL_MAX_N``): the normalized
  transform as an (n, n) matrix, built in float64 from the scipy
  definitions and kept on the device per (family, type, n, norm, dtype,
  device), applied by one ``torch.matmul``. It runs at the dtype's full
  precision: the port turns on no TF32 (a caller who enables
  ``torch.backends.cuda.matmul.allow_tf32`` gets TF32 here too).
* **FFT** (longer axes): ``torch.fft`` real FFTs of symmetric and
  antisymmetric extensions; DCT-II via ``rfft`` of ``[x, reverse(x)]``,
  DCT-III as the exact inverse of that pipeline, DCT-I / DST-I via
  ``rfft`` of the mirrored / odd extension, DST-II / III by the
  sign-and-reversal duality, types IV from the odd bins of a length-4n
  FFT.

Both are linear, so autograd gives exact gradients. ``precision`` (the
JAX package's TPU matmul pass precision) is accepted and not used.
Integers and bool promote to float64, float16 / bfloat16 to float32;
complex input transforms its real and imaginary parts apart.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.dtypes import promote_transform_dtype
from ..core.shapes import ensure_tuple

__all__ = [
    "dct",
    "idct",
    "dst",
    "idst",
    "dctn",
    "idctn",
    "dstn",
    "idstn",
]

_IMPLEMENTED_TYPES = (1, 2, 3, 4)

flipnorm = {
    "forward": "backward",
    "backward": "forward",
    "ortho": "ortho",
    "ortho_scipy": "ortho_scipy",
}
fliptype = {1: 1, 2: 3, 3: 2, 4: 4}

#: Axis lengths up to this take the basis product, longer ones the FFT.
#: DCT-II ortho, float32, on 256 MB batches (``chip_smoke.py`` phase 11,
#: NVIDIA H100 80GB HBM3 at 700 W), device ms of the product / the FFT:
#: n = 256 0.7525 / 1.8492, n = 512 1.4066 / 1.8415, n = 1024 2.7279 /
#: 1.8371, n = 2048 5.5337 / 1.8373. The product's work grows with n, the
#: FFT path's traffic does not.
MATMUL_MAX_N = 512


# ---------------------------------------------------------------------------
# normalization tables: y = diag(dout) @ T_backward( diag(din) @ x )
# ---------------------------------------------------------------------------


def _norm_scales(family: str, type: int, n: int, norm: str):
    """Pre/post diagonal scalings relative to the 'backward' transform.

    Returns (din, dout) as float64 numpy arrays of shape (n,) (or the
    scalars 1.0 / 1 / full)."""
    norm = norm or "backward"
    delta = -1 if type == 1 else 0
    full = 2 * (n + delta) if family == "dct" else 2 * (n - delta)
    # (dct1: 2(n-1); dst1: 2(n+1); types 2/3: 2n)
    if norm == "backward":
        return 1.0, 1.0
    if norm == "forward":
        return 1.0, 1.0 / full
    if norm not in ("ortho", "ortho_scipy"):
        raise ValueError(f"Unknown norm {norm!r}")
    s = 1.0 / math.sqrt(full)
    din = np.ones(n)
    dout = np.full(n, s)
    if family == "dct":
        # scipy's dct ortho was always truly orthogonal; ortho_scipy == ortho
        if type == 1:
            din[0] = din[-1] = math.sqrt(2)
            dout[0] *= 1 / math.sqrt(2)
            dout[-1] *= 1 / math.sqrt(2)
        elif type == 2:
            dout[0] *= 1 / math.sqrt(2)
        elif type == 3:
            din[0] = math.sqrt(2)
        # type 4: uniform scaling only (truly orthogonal as-is)
    elif norm == "ortho":
        # dst1 and dst4 are orthogonal under uniform scaling; dst2/3 need
        # the endpoint fix that legacy scipy omits
        if type == 2:
            dout[-1] *= 1 / math.sqrt(2)
        elif type == 3:
            din[-1] = math.sqrt(2)
    return din, dout


# ---------------------------------------------------------------------------
# basis product
# ---------------------------------------------------------------------------


def _basis_matrix(family: str, type: int, n: int, norm: str) -> np.ndarray:
    """(n, n) float64 matrix M with y = M @ x for the normalized
    transform along a length-n axis (built from the scipy definitions)."""
    j = np.arange(n)[None, :]
    k = np.arange(n)[:, None]
    if family == "dct":
        if type == 1:
            m = 2.0 * np.cos(np.pi * j * k / (n - 1))
            m[:, 0] = 1.0
            m[:, -1] = np.cos(np.pi * k[:, 0])  # (-1)^k
        elif type == 2:
            m = 2.0 * np.cos(np.pi * k * (2 * j + 1) / (2 * n))
        elif type == 3:
            m = 2.0 * np.cos(np.pi * j * (2 * k + 1) / (2 * n))
            m[:, 0] = 1.0
        else:
            m = 2.0 * np.cos(np.pi * (2 * j + 1) * (2 * k + 1) / (4 * n))
    else:
        if type == 1:
            m = 2.0 * np.sin(np.pi * (j + 1) * (k + 1) / (n + 1))
        elif type == 2:
            m = 2.0 * np.sin(np.pi * (k + 1) * (2 * j + 1) / (2 * n))
        elif type == 3:
            m = 2.0 * np.sin(np.pi * (j + 1) * (2 * k + 1) / (2 * n))
            m[:, -1] = np.cos(np.pi * k[:, 0])  # (-1)^k
        else:
            m = 2.0 * np.sin(np.pi * (2 * j + 1) * (2 * k + 1) / (4 * n))
    din, dout = _norm_scales(family, type, n, norm)
    return np.asarray(dout).reshape(-1, 1) * m * np.asarray(din).reshape(1, -1)


@functools.lru_cache(maxsize=16)
def _basis_t(family: str, type: int, n: int, norm: str, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """Mᵀ of :func:`_basis_matrix` on the device, made once: a copy from
    the host at every call would move n² values (16 MB at n = 2048)."""
    return torch.from_numpy(_basis_matrix(family, type, n, norm).T.copy()).to(device=device,
                                                                             dtype=dtype)


def _matmul_last(x, family: str, type: int, norm: str):
    """The normalized transform along the last axis by the basis product."""
    return torch.matmul(x, _basis_t(family, type, x.shape[-1], norm, x.dtype, x.device))


# ---------------------------------------------------------------------------
# backward-norm transforms: FFT path (real FFTs of symmetric extensions)
# ---------------------------------------------------------------------------


def _twiddle(n: int, x, sign: float, odd: bool):
    """exp(sign i pi k / (2n)) (``odd``: exp(sign i pi (2k+1) / (4n))),
    k = 0..n-1, computed on x's device in x's precision."""
    k = torch.arange(n, device=x.device, dtype=x.dtype)
    angle = sign * math.pi * ((2 * k + 1) / (4 * n) if odd else k / (2 * n))
    return torch.polar(torch.ones_like(angle), angle)


def _dct2_back_fft(x):
    """DCT-II, backward norm, along the last axis via rfft of [x, rev x]."""
    n = x.shape[-1]
    zf = torch.fft.rfft(torch.cat([x, x.flip(-1)], dim=-1))[..., :n]
    return (zf * _twiddle(n, x, -1.0, False)).real


def _dct3_back_fft(x):
    """DCT-III, backward norm = 2n * (DCT-II backward)^{-1}: invert the
    rfft pipeline of :func:`_dct2_back_fft` exactly."""
    n = x.shape[-1]
    zf = x * _twiddle(n, x, 1.0, False)
    zf = torch.cat([zf, torch.zeros_like(zf[..., :1])], dim=-1)  # Z_n = 0
    return (2 * n) * torch.fft.irfft(zf, n=2 * n)[..., :n]


def _dct1_back_fft(x):
    """DCT-I, backward norm: rfft of the mirrored extension
    [x_0..x_{n-1}, x_{n-2}..x_1] (length 2(n-1))."""
    return torch.fft.rfft(torch.cat([x, x.flip(-1)[..., 1:-1]], dim=-1)).real


def _dst1_back_fft(x):
    """DST-I, backward norm: rfft of the odd extension
    [0, x, 0, -rev(x)] (length 2(n+1))."""
    n = x.shape[-1]
    zero = torch.zeros_like(x[..., :1])
    zf = torch.fft.rfft(torch.cat([zero, x, zero, -x.flip(-1)], dim=-1))
    return -zf.imag[..., 1:n + 1]


def _alt_signs(x):
    k = torch.arange(x.shape[-1], device=x.device)
    return x * (1 - 2 * (k % 2)).to(x.dtype)


def _dst2_back_fft(x):
    # DST-II(x)_k = DCT-II((-1)^j x_j)_{n-1-k}
    return _dct2_back_fft(_alt_signs(x)).flip(-1)


def _dst3_back_fft(x):
    # transpose duality: DST-III = S o DCT-III o R
    return _alt_signs(_dct3_back_fft(x.flip(-1)))


def _odd_bins(x):
    """F_{2k+1}, k = 0..n-1, of the length-4n FFT of the zero-padded x,
    times exp(-i pi (2k+1) / (4n))."""
    n = x.shape[-1]
    return torch.fft.rfft(x, n=4 * n)[..., 1:2 * n:2] * _twiddle(n, x, -1.0, True)


def _dct4_back_fft(x):
    """DCT-IV, backward norm: X_k = 2 Re[e^{-i pi (2k+1)/(4n)} F_{2k+1}]."""
    return 2.0 * _odd_bins(x).real


def _dst4_back_fft(x):
    """DST-IV, backward norm: the same odd bins, -2 Im."""
    return -2.0 * _odd_bins(x).imag


_FFT_BACK = {
    ("dct", 1): _dct1_back_fft,
    ("dct", 2): _dct2_back_fft,
    ("dct", 3): _dct3_back_fft,
    ("dct", 4): _dct4_back_fft,
    ("dst", 1): _dst1_back_fft,
    ("dst", 2): _dst2_back_fft,
    ("dst", 3): _dst3_back_fft,
    ("dst", 4): _dst4_back_fft,
}


@functools.lru_cache(maxsize=64)
def _scales(family: str, type: int, n: int, norm: str, dtype: torch.dtype,
            device: torch.device):
    """(din, dout) of :func:`_norm_scales` as device tensors (None where 1),
    made once per device."""
    return tuple(None if np.isscalar(d) and d == 1.0
                 else torch.as_tensor(np.broadcast_to(d, (n,)).copy(), dtype=dtype, device=device)
                 for d in _norm_scales(family, type, n, norm))


def _fft_last(x, family: str, type: int, norm: str):
    """The normalized transform along the last axis by the FFT path."""
    din, dout = _scales(family, type, x.shape[-1], norm, x.dtype, x.device)
    y = _FFT_BACK[(family, type)](x if din is None else x * din)
    return y if dout is None else y * dout


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def _transform(x, family: str, type: int, dim: int, norm: str):
    if type not in _IMPLEMENTED_TYPES:
        raise ValueError(f"{family.upper()} only implemented for types I-IV")
    x = torch.as_tensor(x)
    if x.is_complex():
        return torch.complex(_transform(x.real, family, type, dim, norm),
                             _transform(x.imag, family, type, dim, norm))
    x = x.to(promote_transform_dtype(x.dtype))
    dim = dim % x.ndim
    n = x.shape[dim]
    if family == "dct" and type == 1 and n < 2:
        raise ValueError("DCT-I requires n >= 2")
    x = x.movedim(dim, -1)
    y = (_matmul_last if n <= MATMUL_MAX_N else _fft_last)(x, family, type, norm)
    return y.movedim(-1, dim)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def dct(x, dim: int = -1, norm: str = "backward", type: int = 2, precision=None):
    """Discrete Cosine Transform, types I-IV, along ``dim``."""
    return _transform(x, "dct", type, -1 if dim is None else dim, norm or "backward")


def idct(x, dim: int = -1, norm: str = "backward", type: int = 2, precision=None):
    """Inverse DCT = flipped-type, flipped-norm DCT."""
    return dct(x, dim, flipnorm[norm or "backward"], fliptype[type])


def dst(x, dim: int = -1, norm: str = "backward", type: int = 2, precision=None):
    """Discrete Sine Transform, types I-IV, along ``dim``. ``norm='ortho'``
    is truly orthogonal; ``norm='ortho_scipy'`` is legacy scipy/cupy."""
    return _transform(x, "dst", type, -1 if dim is None else dim, norm or "backward")


def idst(x, dim: int = -1, norm: str = "backward", type: int = 2, precision=None):
    """Inverse DST = flipped-type, flipped-norm DST."""
    return dst(x, dim, flipnorm[norm or "backward"], fliptype[type])


def _norm_dims(x, dim):
    ndim = torch.as_tensor(x).ndim
    if dim is None:
        return tuple(range(ndim))
    return tuple(d % ndim for d in ensure_tuple(dim))


def dctn(x, dim=None, norm: str = "backward", type: int = 2, precision=None):
    """N-D DCT: 1-D transforms over each requested dim (all by default)."""
    for d in _norm_dims(x, dim):
        x = dct(x, d, norm, type)
    return x


def idctn(x, dim=None, norm: str = "backward", type: int = 2, precision=None):
    """N-D inverse DCT."""
    for d in _norm_dims(x, dim):
        x = idct(x, d, norm, type)
    return x


def dstn(x, dim=None, norm: str = "backward", type: int = 2, precision=None):
    """N-D DST."""
    for d in _norm_dims(x, dim):
        x = dst(x, d, norm, type)
    return x


def idstn(x, dim=None, norm: str = "backward", type: int = 2, precision=None):
    """N-D inverse DST."""
    for d in _norm_dims(x, dim):
        x = idst(x, d, norm, type)
    return x
