"""Device meshes and batch shardings.

PyTorch counterpart of ``fastmath_tpu/parallel/mesh.py``. A :class:`Mesh`
is an array of ``torch.device`` with named axes; ``mesh.shape[axis]`` is
the axis' size, as in JAX. Every op of the port maps independently over
its batch, so sharding the batch over a mesh needs no communication:
:func:`put_batch` splits a tensor along its batch axis and puts each
shard on its device, and :mod:`.shard` runs an op on each shard.

On one card the default mesh has one device, ``cuda:0``. A mesh of
``torch.device("cpu")`` repeated k times stands for k devices on a
machine without them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Union

import numpy as np
import torch

__all__ = ["make_mesh", "batch_sharding", "put_batch", "BATCH_AXIS", "Mesh", "Shards"]

BATCH_AXIS = "dp"


class Mesh:
    """Devices in an array with named axes (``devices``, ``axis_names``,
    ``shape`` as a dict of axis sizes, ``size``)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices with axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.size = devices.size

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis`` at index 0 of every other axis: one a
        shard of a batch split over ``axis``."""
        if axis not in self.shape:
            raise ValueError(f"mesh has axes {self.axis_names}, not {axis!r}")
        k = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[k] = slice(None)
        return list(self.devices[tuple(index)])

    def __repr__(self):
        return f"Mesh({self.shape}, devices={self.devices.ravel().tolist()})"


def make_mesh(shape: Union[int, Sequence[int], None] = None,
              axis_names: Sequence[str] = (BATCH_AXIS,), devices=None) -> Mesh:
    """A mesh over ``devices`` (default: every CUDA device; without one it
    raises, and a mesh on the CPU needs its devices named).

    ``shape=None`` puts all devices on one axis; an int uses that many; a
    tuple builds a multi-axis mesh (e.g. ``(4, 2)`` with
    ``axis_names=('dp', 'mp')``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; name the devices to build a mesh "
                               "elsewhere, e.g. devices=[torch.device('cpu')] * 4")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape required for multi-axis meshes")
        shape = (len(devices),)
    elif isinstance(shape, int):
        shape = (shape,)
    else:
        shape = tuple(shape)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh {shape} needs {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(shape), axis_names)


@dataclass(frozen=True)
class BatchSharding:
    """Axis ``spec.index(mesh_axis)`` of a tensor split over that mesh
    axis, the other axes whole (JAX's ``NamedSharding`` of one
    ``PartitionSpec``)."""

    mesh: Mesh
    spec: tuple


def batch_sharding(mesh: Mesh, ndim: int, batch_axis: int = 0,
                   mesh_axis: str = BATCH_AXIS) -> BatchSharding:
    """The sharding of an ``ndim``-d tensor split along ``batch_axis`` over
    ``mesh_axis``."""
    spec = [None] * ndim
    spec[batch_axis] = mesh_axis
    return BatchSharding(mesh, tuple(spec))


class Shards(list):
    """The per-device shards of one tensor (:func:`put_batch`), in mesh
    order; :mod:`.shard` takes them as they are."""

    def __init__(self, shards, batch_axis: int):
        super().__init__(shards)
        self.batch_axis = batch_axis


def split(x: torch.Tensor, devices: list, batch_axis: int) -> Shards:
    """``x`` in ``len(devices)`` equal pieces along ``batch_axis``, each on
    its device (the batch must divide, as in JAX's ``shard_map``)."""
    k = len(devices)
    size = x.shape[batch_axis]
    if size % k:
        raise ValueError(f"batch axis {batch_axis} of size {size} does not split over "
                         f"{k} devices")
    pieces = x.tensor_split(k, dim=batch_axis)
    return Shards([c.to(d) for c, d in zip(pieces, devices)], batch_axis)


def put_batch(x, mesh: Mesh, batch_axis: int = 0, mesh_axis: str = BATCH_AXIS) -> Shards:
    """``x`` split along its batch axis over ``mesh_axis``: one shard a
    device, each on its device."""
    x = torch.as_tensor(x)
    return split(x, mesh.axis_devices(mesh_axis), batch_axis % max(x.dim(), 1))
