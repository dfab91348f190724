"""Batch sharding over a mesh of devices (PyTorch counterpart of
``fastmath_tpu/parallel``): the batch of every op splits over the mesh
with no communication; only global reductions combine the devices'
results. See :mod:`.shard` for how this differs from JAX's distributed
arrays."""
from .mesh import BATCH_AXIS, batch_sharding, make_mesh, put_batch
from .shard import donating, shard_batch, shard_reduce, trapprox_sharded

__all__ = ["make_mesh", "batch_sharding", "put_batch", "BATCH_AXIS", "donating", "shard_batch",
           "shard_reduce", "trapprox_sharded"]
