"""Batch sharding over a mesh: ``shard_batch``, ``shard_reduce``,
``trapprox_sharded`` and ``donating``.

PyTorch counterpart of ``fastmath_tpu/parallel/shard.py``. Every op of
the port maps independently over its batch, so each device runs the op
unchanged on its shard, with no communication; only a global reduction
combines the devices' partial results, once, on the mesh's first device.

Where this differs from JAX: ``shard_map`` returns arrays that stay
distributed over the mesh; here the host calls the op once a device (the
launches are asynchronous, so the devices overlap) and the outputs are
gathered, concatenated on the mesh's first device. On one card the mesh
has one device and the op runs on the whole batch as it is.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from .mesh import BATCH_AXIS, Mesh, Shards, split

__all__ = ["shard_batch", "shard_reduce", "trapprox_sharded", "donating"]


def _shards(x, devices, axis):
    """The shards of one argument: as given (:class:`Shards`), split
    (a tensor), or the same object for every device (anything else)."""
    if isinstance(x, Shards):
        if len(x) != len(devices):
            raise ValueError(f"{len(x)} shards for {len(devices)} devices")
        return x
    if isinstance(x, torch.Tensor):
        return split(x, devices, axis % max(x.dim(), 1))
    return [x] * len(devices)


def _per_arg(axes, n):
    return (axes,) * n if isinstance(axes, int) else tuple(axes)


def shard_batch(fn: Callable, mesh: Mesh, mesh_axis: str = BATCH_AXIS, batch_axes=0,
                out_batch_axes=0):
    """Wrap ``fn`` so that each tensor argument is split along its batch
    axis over ``mesh_axis`` (shards from :func:`~.mesh.put_batch` are taken
    as they are), ``fn`` runs unchanged on each device's shard, and the
    outputs are concatenated along their batch axes on the mesh's first
    device. The batch must split evenly over the devices.

    ``batch_axes``: int or per-argument tuple of ints. ``out_batch_axes``:
    the same for the outputs (a tensor or a tuple of them).
    """
    devices = mesh.axis_devices(mesh_axis)

    @functools.wraps(fn)
    def wrapped(*args):
        per = [_shards(a, devices, ax)
               for a, ax in zip(args, _per_arg(batch_axes, len(args)))]
        outs = [fn(*(p[i] for p in per)) for i in range(len(devices))]
        if len(outs) == 1:
            return outs[0]
        leaves, spec = tree_flatten(outs[0])
        columns = list(zip(*(tree_flatten(o)[0] for o in outs)))
        axes = _per_arg(out_batch_axes, len(leaves))
        return tree_unflatten([torch.cat([t.to(devices[0]) for t in col], dim=ax)
                               for col, ax in zip(columns, axes)], spec)

    return wrapped


def shard_reduce(reduce_fn: Callable, combine: str = "sum", mesh: Optional[Mesh] = None,
                 mesh_axis: str = BATCH_AXIS, batch_axis: int = 0):
    """Lift a full reduction ``x -> scalar or small tensor`` into a sharded
    one: ``reduce_fn`` on each device's shard, then one sum on the mesh's
    first device.

    ``combine="sum"``: the per-shard results add. ``"mean_weighted"``:
    ``reduce_fn`` returns per-shard ``(sum, count)`` and the wrapper returns
    the summed sums over the summed counts (a mean that omits NaN).
    """
    if mesh is None:
        raise ValueError("mesh is required")
    if combine not in ("sum", "mean_weighted"):
        raise ValueError(f"unknown combine {combine!r}")
    devices = mesh.axis_devices(mesh_axis)

    def total(parts):
        return torch.stack([p.to(devices[0]) for p in parts]).sum(dim=0)

    def wrapped(x):
        parts = [reduce_fn(s) for s in _shards(x, devices, batch_axis)]
        if combine == "sum":
            return total([torch.as_tensor(p) for p in parts])
        num = total([torch.as_tensor(p[0]) for p in parts])
        return num / total([torch.as_tensor(p[1]) for p in parts])

    return wrapped


def trapprox_sharded(matvec, shape: Optional[Sequence[int]], mesh: Mesh,
                     moments: Optional[int] = None, samples: int = 10,
                     method: str = "rademacher", generator: Optional[torch.Generator] = None,
                     dtype=None, mesh_axis: str = BATCH_AXIS):
    """Hutchinson trace estimation with the probes split over the mesh:
    each device draws ``ceil(samples / n)`` probes from its own generator
    (seeded by one draw of ``generator``, default one seeded 0) and
    applies the operator to them; the moment sums are added on the mesh's
    first device and divided by ``per_device * n``.

    The operator is a tensor ``(..., n, n)`` (copied to each device; a
    batch is one block-diagonal operator) or a callable with ``shape=``,
    given probes on each device, as in
    :func:`fastmath_tpu_torch.ops.stochastic.trapprox`. Returns a scalar if
    ``moments is None``, else a ``(moments,)`` vector.
    """
    from ..ops.stochastic import _as_operator, _sample

    devices = mesh.axis_devices(mesh_axis)
    n = len(devices)
    per = -(-samples // n)
    nmom = moments or 1
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    seeds = torch.randint(0, 2**62, (n,), generator=generator,
                          device=generator.device).tolist()
    local = []
    for seed, dev in zip(seeds, devices):
        op = matvec.to(dev) if isinstance(matvec, torch.Tensor) else matvec
        _, mv_probes, shp, dt, _ = _as_operator(op, shape, dtype, dev)
        probes = _sample(torch.Generator(device=dev).manual_seed(seed), method,
                         (per, math.prod(shp)), dt, dev)
        m, sums = probes, []
        for _ in range(nmom):
            m = mv_probes(m)
            sums.append(torch.sum(m * probes))
        local.append(torch.stack(sums).to(devices[0]))
    t = torch.stack(local).sum(dim=0) / (per * n)
    return t[0] if moments is None else t


def donating(fn: Callable, argnums=(0,)):
    """Wrap ``fn`` so that its result comes back in the storage of a
    donated argument: the first of ``argnums`` whose tensor has the
    result's shape, dtype and device gets the result copied in, and is
    returned (``out.data_ptr() == arg.data_ptr()``).

    The JAX package's ``jit(donate_argnums=...)`` aliases the buffers, so
    a donated array is invalid after the call. Torch has no buffer
    donation: the donated tensor stays valid and holds the result, and the
    call still allocates its own output for the time of the copy. The
    port's ``_`` variants (``sym_solve_``, ...) are functional aliases, as
    in the JAX package. A result that requires grad, or that no donated
    argument matches, is returned as it is.
    """
    argnums = (argnums,) if isinstance(argnums, int) else tuple(argnums)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        if not isinstance(out, torch.Tensor) or out.requires_grad:
            return out
        for i in argnums:
            a = args[i]
            if (isinstance(a, torch.Tensor) and a.shape == out.shape and a.dtype == out.dtype
                    and a.device == out.device):
                if a.data_ptr() != out.data_ptr():
                    a.copy_(out)
                return a
        return out

    return wrapped
