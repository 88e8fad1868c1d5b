"""Parallelism over ``torch.distributed`` (counterpart of s2t_tpu/parallel/): one process
a device, the JAX mesh's axes ("data", "model", "seq", "pipe") as process groups."""

from s2t_tpu_torch.parallel.mesh import (  # noqa: F401
    AXES, Mesh, batch_sharding, make_mesh, shard_batch)
