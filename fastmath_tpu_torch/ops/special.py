"""Special functions: Bessel-I family, multivariate digamma, erfinv,
gammainc.

PyTorch counterpart of ``fastmath_tpu/ops/special.py``: the same names,
branches, thresholds and coefficients, as plain torch ops on the input's
device (the JAX package has no kernel here).

* ``besseli``: ``nu = 0`` and ``1`` through ``torch.special.i0e`` /
  ``i1e``; any other ``nu`` takes the log-space ascending series at small z
  and the uniform asymptotic expansion (A&S 9.7.7, six-term u-series) at
  large z. Both branches are evaluated everywhere and blended with
  ``torch.where`` on inputs clamped into each branch's region (the
  "double where"), so no inf or NaN of the unselected branch reaches the
  values or the gradients.
* Logs are ``torch.log``. The JAX package takes its logs from
  ``core/accmath.py``, which works around the TPU's inaccurate float32
  ``log``; the GPU's is accurate.
* bfloat16 / float16 inputs compute in float32 and round back; integers
  and bool compute in :func:`fastmath_tpu_torch.core.as_float`.
* ``gammainc`` / ``gammaincc`` differentiate in ``x`` only:
  ``torch.special.gammainc`` has no derivative in ``a``, so asking for one
  raises ``NotImplementedError`` (the JAX package has it).
"""
from __future__ import annotations

import math

import torch

from ..core.dtypes import as_float

__all__ = [
    "mvdigamma",
    "besseli",
    "besseli_ratio",
    "erfinv",
    "gammainc",
    "gammaincc",
    "digamma",
]

digamma = torch.special.digamma  # convenience re-export

_HALF = (torch.float16, torch.bfloat16)


def _upcast(z):
    z = torch.as_tensor(z)
    if z.dtype in _HALF:
        return z.to(torch.float32), z.dtype
    z = z.to(as_float(z.dtype))
    return z, z.dtype


def mvdigamma(input, order: int = 1):
    r"""Multivariate digamma: ``sum_{p=1..order} psi(x + (1-p)/2)``."""
    x, out_dtype = _upcast(input)
    dg = torch.special.digamma(x)
    for p in range(2, order + 1):
        dg = dg + torch.special.digamma(x + (1 - p) / 2)
    return dg.to(out_dtype)


def _mode_code(mode) -> int:
    if isinstance(mode, int):
        return mode
    return 2 if mode == "log" else 1 if mode == "norm" else 0


def _besseli_01(nu: int, z, code: int):
    """nu in {0, 1} via the exponentially scaled i0e / i1e."""
    ie = torch.special.i0e(z) if nu == 0 else torch.special.i1e(z)
    if code == 1:  # norm: I_nu(z) / e^z  (z >= 0)
        return ie
    if code == 2:  # log
        return torch.log(ie) + z
    return ie * torch.exp(z)


def _besseli_series_log(nu: float, z, m_terms: int):
    """log I_nu(z) by the ascending series, log-sum-exp pivoted on the
    first term."""
    lgamma_nu_1 = math.lgamma(nu + 1)
    x = torch.log(0.5 * z)
    # sum_{m>=1} exp(2m*x - (lgamma(m+1) + lgamma(m+1+nu) - lgamma(nu+1)))
    f = torch.exp(2 * x - (math.lgamma(2) + math.lgamma(nu + 2) - lgamma_nu_1))
    for m in range(2, max(m_terms, 2)):
        f = f + torch.exp(2 * m * x - (math.lgamma(m + 1) + math.lgamma(m + 1 + nu) - lgamma_nu_1))
    f = f + 1.0
    return torch.log(f) + nu * x - lgamma_nu_1


def _besseli_large_log(nu: float, z, minus_z: bool = False):
    """log I_nu(z) (or log I_nu(z) - z when ``minus_z``) by the uniform
    asymptotic expansion, branch-blended with double where.

    ``minus_z`` computes the exponent of the exp-scaled Bessel without
    large-argument cancellation: ``nu*T - z`` is evaluated as
    ``nu^2 / (z (T + 1))`` (branch 1) / ``nu / (T + w)`` (branch 2).
    """
    # With w = z/nu and T = sqrt(1 + w^2) (A&S 9.7.7):
    #   log I_nu ~ nu*(T + log(w/(1+T))) - log(sqrt(2 pi nu)) + 0.5*log(t)
    #             + log(u-series(t)),   t = 1/T.
    # Two stabilizations of the same formula: for large w compute T via
    # z*sqrt(1+(nu/z)^2)/nu (avoids w^2 overflow); for small w directly.
    big = (z / nu) ** 2 > 4.0
    z1 = torch.clamp(z, min=2.0 * nu)  # double-where guards
    tmp1 = torch.sqrt(1.0 + (nu / z1) ** 2)
    t1 = z1 * tmp1 / nu
    z2 = torch.clamp(z, max=2.0 * nu)
    t2 = torch.sqrt(1.0 + (z2 / nu) ** 2)
    if minus_z:
        # nu*t1 - z1 = z1*(sqrt(1+(nu/z1)^2) - 1) = nu^2/(z1*(tmp1+1))
        e1 = nu * nu / (z1 * (tmp1 + 1.0)) - nu * torch.log(nu / z1 + tmp1)
        # nu*t2 - z2 = nu*(sqrt(1+w^2) - w) = nu/(t2 + w),  w = z2/nu
        e2 = nu / (t2 + z2 / nu) + nu * torch.log(z2 / (nu * (1.0 + t2)))
    else:
        e1 = nu * (t1 - torch.log(nu / z1 + tmp1))
        e2 = nu * (t2 + torch.log(z2 / (nu * (1.0 + t2))))
    t = torch.where(big, 1.0 / t1, 1.0 / t2)
    expo = torch.where(big, e1, e2)

    tt = t * t
    # u-series in 1/nu with Debye polynomials u_k(t) (A&S 9.3.9-9.3.10)
    us = 1.0
    den = nu
    us = us + t * (0.125 - tt * 0.2083333333333333) / den
    den = den * nu
    us = us + tt * (0.0703125 + tt * (-0.4010416666666667 + tt * 0.3342013888888889)) / den
    den = den * nu
    us = us + t * tt * (
        0.0732421875 + tt * (-0.8912109375 + tt * (1.846462673611111 - tt * 1.025812596450617))
    ) / den
    den = den * nu
    us = us + tt * tt * (
        0.112152099609375
        + tt * (-2.3640869140625 + tt * (8.78912353515625 + tt * (-11.20700261622299 + tt * 4.669584423426248)))
    ) / den
    den = den * nu
    us = us + tt * tt * t * (
        0.2271080017089844
        + tt * (-7.368794359479632 + tt * (42.53499874638846 + tt * (-91.81824154324002 + tt * (84.63621767460074 - tt * 28.21207255820025))))
    ) / den
    den = den * nu
    us = us + tt * tt * tt * (
        0.5725014209747314
        + tt * (-26.49143048695155 + tt * (218.1905117442116 + tt * (-699.5796273761326 + tt * (1059.990452528 + tt * (-765.2524681411817 + tt * 212.5701300392171)))))
    ) / den

    half_log_2pi = 0.9189385332046727
    return expo + 0.5 * (torch.log(t) - math.log(nu)) - half_log_2pi + torch.log(us)


def besseli(nu: float, z, mode=None):
    """Modified Bessel function of the first kind ``I_nu(z)`` for z >= 0.

    ``mode``: ``None``/0 -> ``I_nu(z)``; ``'norm'``/1 -> ``I_nu(z)/e^z``;
    ``'log'``/2 -> ``log I_nu(z)``.
    """
    z, out_dtype = _upcast(z)
    code = _mode_code(mode)
    if nu == 0 or nu == 1:
        return _besseli_01(int(nu), z, code).to(out_dtype)
    norm = code == 1  # exp-scaled: compute log I - z cancellation-free
    if nu >= 15.0:
        log_i = _besseli_large_log(float(nu), z, minus_z=norm)
    else:
        thr = 5.0 * math.sqrt(15.0 - nu) * math.sqrt(nu + 15.0) / 3.0
        m_terms = int(math.ceil(thr * 1.9 + 2.0))
        small = z < 2.0 * thr
        z_small = torch.clamp(z, max=2.0 * thr)  # double-where guards
        z_large = torch.clamp(z, min=2.0 * thr)
        log_small = _besseli_series_log(float(nu), torch.clamp(z_small, min=1e-30), m_terms)
        if norm:
            log_small = log_small - z_small
        log_large = _besseli_large_log(float(nu), z_large, minus_z=norm)
        log_i = torch.where(small, log_small, log_large)
    out = log_i if code == 2 else torch.exp(log_i)
    return out.to(out_dtype)


def besseli_ratio(nu: float, x, N: int = 4, K: int = 10):
    """Ratio ``I_{nu+1}(x) / I_nu(x)`` by Amos (1974) bounds: lower-bound
    seed (eq. 20a), N refinement sweeps (eq. 20b) at shifted order
    ``nu+K``, then K steps of backward recursion (eq. 2)."""
    x, out_dtype = _upcast(x)
    nu1 = nu + K
    xx = x * x
    # seed: lower bound for orders nu1 .. nu1+N (Amos eq. 20a)
    rk = [x / ((nu1 + k + 0.5) + torch.sqrt(xx + (nu1 + k + 1.5) ** 2)) for k in range(N + 1)]
    # refinement sweeps (Amos eq. 20b), consuming the ladder top-down
    for m in range(N, 0, -1):
        for k in range(1, m + 1):
            ratio = rk[k] / rk[k - 1]
            rk[k - 1] = x / ((nu1 + k) + torch.sqrt(ratio * xx + (nu1 + k) ** 2))
        rk.pop()
    result = rk[0]
    # backward recursion in order (Amos eq. 2): r_{k-1} = 1 / (2 k / x + r_k)
    for k in range(K, 0, -1):
        result = 1.0 / (2.0 * (nu + k) / x + result)
    return result.to(out_dtype)


def erfinv(x):
    """Inverse error function."""
    x, out_dtype = _upcast(x)
    return torch.special.erfinv(x).to(out_dtype)


class _GammaInc(torch.autograd.Function):
    """P(a, x) or Q(a, x) with the derivative in x; none in a."""

    @staticmethod
    def forward(ctx, a, x, upper):
        ctx.save_for_backward(a, x)
        ctx.upper = upper
        return (torch.special.gammaincc if upper else torch.special.gammainc)(a, x)

    @staticmethod
    def backward(ctx, g):
        if ctx.needs_input_grad[0]:
            raise NotImplementedError(
                f"{'gammaincc' if ctx.upper else 'gammainc'}: PyTorch has no derivative in a "
                "(torch.special.gammainc defines none); detach a")
        a, x = ctx.saved_tensors
        # dP/dx = x^(a-1) e^-x / Gamma(a) = -dQ/dx
        d = g * torch.exp((a - 1) * torch.log(x) - x - torch.lgamma(a))
        return None, (-d if ctx.upper else d).sum_to_size(x.shape), None


def _gammainc(a, x, upper):
    a, _ = _upcast(a)
    x, out_dtype = _upcast(x)
    dtype = torch.promote_types(a.dtype, x.dtype)
    return _GammaInc.apply(a.to(device=x.device, dtype=dtype), x.to(dtype), upper).to(out_dtype)


def gammainc(a, x):
    """Regularized lower incomplete gamma ``P(a, x)``."""
    return _gammainc(a, x, False)


def gammaincc(a, x):
    """Regularized upper incomplete gamma ``Q(a, x)``."""
    return _gammainc(a, x, True)
