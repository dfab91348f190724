"""Matrix-free stochastic estimators: Hutchinson / Hutch++ trace, VBALD
log-determinant, power-iteration max-eigenvalue.

PyTorch counterpart of ``fastmath_tpu/ops/stochastic.py``: the same names,
algorithms and outputs, as plain torch ops (the JAX package has no kernel
here; a callable operator may launch the port's kernels, e.g.
``sym_matvec``'s).

* **Randomness is explicit.** Every estimator takes a
  ``generator: torch.Generator`` in place of the JAX package's ``key``;
  the default is a new one seeded 0 on the op's device. Draws are made on
  the generator's device and moved to the op's. No call touches torch's
  global random state. ``vbald``'s Beta draw (which ``torch.distributions``
  cannot take from a generator) comes from a numpy ``Generator`` seeded by
  one draw of the given generator.
* **The operator** is a tensor ``(..., n, n)``, or a callable with
  ``shape=``. A batched tensor is ONE block-diagonal operator: the outputs
  are scalars (the sum of the per-matrix traces or log-determinants, the
  global max eigenvalue). A tensor operator runs on its own device and
  applies to all probes in one batched product. A callable is applied to
  one probe at a time (the JAX package vmaps it over the probe axis;
  ``torch.func.vmap`` cannot pass through the port's ctypes-launched
  kernels), on ``device`` (default ``"cuda"``; give ``device="cpu"`` for
  CPU tensors), in ``dtype`` (default ``torch.get_default_dtype()``).
* ``maxeig_power`` stops where the JAX package's ``while_loop`` stops:
  ``|mu - mu_prev| < tol`` or ``max_iter`` steps. It reads the Rayleigh
  quotients on the host once every :data:`_POWER_CHUNK` steps and returns
  the first one at which the loop would have stopped.
* ``vbald`` keeps the JAX package's host loop: Gauss-Newton with Armijo
  backtracking.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

__all__ = ["trapprox", "vbald", "maxeig_power"]

# power-iteration steps run between two reads of the Rayleigh quotients
_POWER_CHUNK = 8


def _as_operator(matvec, shape, dtype, device):
    """Normalize the (tensor | callable) operator to ``(mv, mv_probes,
    shape, dtype, device)``: ``mv`` maps one vector of ``shape``,
    ``mv_probes`` a stack ``(p, numel)`` of flattened ones."""
    if isinstance(matvec, (torch.Tensor, np.ndarray)) and not callable(matvec):
        mat = torch.as_tensor(matvec)
        shape = (*mat.shape[:-2], mat.shape[-1])

        def mv(x):
            return torch.matmul(mat, x[..., None])[..., 0]

        def mv_probes(x):
            return mv(x.reshape(-1, *shape)).reshape(x.shape[0], -1)

        return mv, mv_probes, tuple(shape), mat.dtype, mat.device
    if shape is None:
        raise ValueError("shape= is required when matvec is a callable")
    shape = tuple(shape)

    def mv_probes(x):
        return torch.stack([matvec(v.reshape(shape)).reshape(-1) for v in x])

    return (matvec, mv_probes, shape, dtype or torch.get_default_dtype(),
            torch.device(device))


def _generator(generator, device):
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return generator


def _sample(generator, method, shape, dtype, device):
    """Rademacher (``method`` starting with "r") or standard normal."""
    if method[0].lower() == "r":
        bits = torch.randint(0, 2, shape, generator=generator, device=generator.device)
        return (2 * bits - 1).to(device=device, dtype=dtype)
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=dtype).to(device)


def _trace(mv_probes, numel, moments, samples, method, hutchpp, generator, dtype, device):
    nmom = moments or 1
    if hutchpp:
        s = int(math.ceil(samples / 3))
        q = _sample(generator, method, (s, numel), dtype, device)
        g = _sample(generator, method, (s, numel), dtype, device)
        # orthonormal basis of the probe image: deflate the top subspace
        qbasis = torch.linalg.qr(mv_probes(q).T)[0].T  # (s, numel)
        g = g - (g @ qbasis.T) @ qbasis
        t = []
        mq, mg = qbasis, g
        for _ in range(nmom):
            mq = mv_probes(mq)
            mg = mv_probes(mg)
            t.append(torch.sum(qbasis * mq) + torch.sum(g * mg) / s)
        t = torch.stack(t)
    else:
        probes = _sample(generator, method, (samples, numel), dtype, device)
        m, t = probes, []
        for _ in range(nmom):
            m = mv_probes(m)
            t.append(torch.sum(m * probes, dim=-1))
        t = torch.mean(torch.stack(t, dim=-1), dim=0)
    return t[0] if moments is None else t


def trapprox(
    matvec: Union[torch.Tensor, Callable],
    shape: Optional[Sequence[int]] = None,
    moments: Optional[int] = None,
    samples: int = 10,
    method: str = "rademacher",
    hutchpp: bool = False,
    generator: Optional[torch.Generator] = None,
    dtype=None,
    device="cuda",
):
    r"""Stochastic trace approximation ``tr(A^j), j = 1..moments``.

    Hutchinson (1989) by default; ``hutchpp=True`` uses the Hutch++
    low-rank-deflation variant (Meyer et al. 2021): QR of the probe
    image + residual correction. Returns a scalar if ``moments is None``
    else a ``(moments,)`` vector. See the module docstring for the
    operator, ``generator``, ``dtype`` and ``device``.
    """
    _, mv_probes, shape, dtype, device = _as_operator(matvec, shape, dtype, device)
    generator = _generator(generator, device)
    return _trace(mv_probes, math.prod(shape), moments, samples, method, hutchpp, generator,
                  dtype, device)


def _power(mv, shape, max_iter, tol, generator, dtype, device):
    v = _sample(generator, "rademacher", shape, dtype, device)
    mu, mu_prev = math.inf, 0.0
    step = 0
    while abs(mu - mu_prev) >= tol and step < max_iter:
        chunk = []
        for _ in range(min(_POWER_CHUNK, max_iter - step)):
            w = v
            v = mv(v)
            chunk.append(torch.sum(w * v))
            v = v / torch.sqrt(torch.sum(v * v))
        chunk = torch.stack(chunk)
        for i, value in enumerate(chunk.tolist()):
            mu, mu_prev = value, mu
            step += 1
            if not (abs(mu - mu_prev) >= tol and step < max_iter):
                return chunk[i]
    return torch.tensor(mu, dtype=dtype, device=device)


def maxeig_power(
    matvec: Union[torch.Tensor, Callable],
    shape: Optional[Sequence[int]] = None,
    max_iter: int = 512,
    tol: float = 1e-6,
    generator: Optional[torch.Generator] = None,
    dtype=None,
    device="cuda",
):
    """Largest eigenvalue by power iteration with Rayleigh-quotient
    convergence. A batched tensor is ONE block-diagonal operator: the
    result is the scalar **global** max eigenvalue across the batch (for
    per-matrix dominant eigenvalues of compact-symmetric batches use
    :func:`fastmath_tpu_torch.sym_maxeig`). See the module docstring for
    the operator, ``generator``, ``dtype`` and ``device``.
    """
    mv, _, shape, dtype, device = _as_operator(matvec, shape, dtype, device)
    return _power(mv, shape, max_iter, tol, _generator(generator, device), dtype, device)


def _factexp(lam, coeff):
    """exp(-1 - sum_i coeff[i] lam^(i+1)) for a batch of lam."""
    powers = lam[..., None] ** torch.arange(1, coeff.shape[0] + 1, device=lam.device)
    return torch.exp(-1.0 - powers @ coeff)


def _vbald_moments_mc(coeff, lam):
    """Monte-Carlo moments s_j = E[lam^j * factexp(lam)], j=0..2m."""
    q = _factexp(lam, coeff)
    s = [torch.mean(q)]
    p = q
    for _ in range(2 * coeff.shape[0]):
        p = p * lam
        s.append(torch.mean(p))
    return torch.stack(s)


def vbald(
    matvec: Union[torch.Tensor, Callable],
    shape: Optional[Sequence[int]] = None,
    upper: Optional[float] = None,
    moments: int = 5,
    samples: int = 5,
    mc_samples: int = 64,
    method: str = "rademacher",
    generator: Optional[torch.Generator] = None,
    dtype=None,
    max_iter: int = 512,
    tol: float = 1e-6,
    device="cuda",
):
    """Variational Bayesian Approximation of Log Determinants (Granziol
    et al. 2018): normalize by the max eigenvalue, estimate moments of
    the eigenvalue density, fit a Beta prior by ML, Gauss-Newton fit of
    the exponential-family coefficients (with Armijo backtracking), then
    Monte-Carlo ``E[log lam]``. Runs a host-controlled loop.

    A batched tensor is ONE block-diagonal operator: the result is the
    scalar **sum** of the per-matrix log-determinants. See the module
    docstring for the operator, ``generator``, ``dtype`` and ``device``.
    """
    mv, mv_probes, shape, dtype, device = _as_operator(matvec, shape, dtype, device)
    generator = _generator(generator, device)
    numel = math.prod(shape)

    if not upper:
        upper = _power(mv, shape, 512, 1e-6, generator, dtype, device)
    upper = torch.as_tensor(upper, dtype=dtype, device=device)
    mom = _trace(lambda x: mv_probes(x) / upper, numel, moments, samples, method, False,
                 generator, dtype, device) / numel

    # Beta prior by maximum likelihood on the first two moments
    m1, m2 = float(mom[0]), float(mom[1])
    denom = m2 - m1 * m1
    alpha = m1 * (m1 - m2) / denom if denom != 0 else -1.0
    beta = alpha * (1.0 / m1 - 1.0) if m1 != 0 else -1.0
    if alpha > 0 and beta > 0:
        seed = int(torch.randint(0, 2 ** 62, (), generator=generator, device=generator.device))
        lam_mc = torch.as_tensor(np.random.default_rng(seed).beta(alpha, beta, mc_samples),
                                 dtype=dtype, device=device)
    else:
        lam_mc = torch.empty(mc_samples, dtype=dtype, device=generator.device).uniform_(
            1e-8, 1.0, generator=generator).to(device)

    # Gauss-Newton fit of the exponential-family coefficients
    coeff = torch.zeros_like(mom)

    def mc_loss(c):
        return float(torch.mean(_factexp(lam_mc, c)) + torch.dot(c, mom))

    loss = mc_loss(coeff)
    for _ in range(max_iter):
        s = _vbald_moments_mc(coeff, lam_mc)
        grad = mom - s[1:moments + 1]
        H = torch.stack([s[2 + i:2 + i + moments] for i in range(moments)])
        diag = torch.diagonal(H)
        H = H + torch.diag(1e-3 * torch.max(torch.abs(diag)) * torch.ones_like(diag))
        delta = torch.linalg.solve(H, grad)
        # Armijo backtracking
        success = False
        armijo = 1.0
        for _ in range(12):
            cand = coeff - armijo * delta
            cand_loss = mc_loss(cand)
            if cand_loss < loss:
                success = True
                break
            armijo /= 2
        if not success:
            break
        gain = abs(cand_loss - loss)
        coeff, loss = cand, cand_loss
        if gain < tol:
            break

    # logdet(A) = N * (E[log lam] + log(upper))
    elog = torch.mean(torch.log(lam_mc) * _factexp(lam_mc, coeff))
    return numel * (elog + torch.log(upper))
