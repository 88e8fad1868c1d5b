"""The device mesh over ``torch.distributed`` (counterpart of s2t_tpu/parallel/mesh.py).

One process a device, launched by ``torchrun`` (or spawned).  The JAX mesh's axes
("data", "model", "seq", "pipe") factor the world size the same way (``make_mesh``),
with ranks laid out as JAX lays out devices, row-major over (data, model, seq, pipe).
Each axis of size above 1 gets the process groups of the ranks that differ only in
that coordinate (``Mesh.group``).  The port keeps its own small mesh class and not
``torch.distributed.device_mesh.DeviceMesh``: the card checks run two ranks on one
device over gloo, which DeviceMesh's one-device-a-rank placement refuses.

* data:  every rank collates the same global batch and keeps its contiguous rows
  (``shard_batch``); gradients and counts are summed over the group.
* model: tensor parallelism by ``tp_rules``' table (``parallel/tensor_parallel.py``).
* seq:   the encoder's frames split over the group, attention through the ring.
* pipe:  the encoder's layer stages, one block of stages a rank.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

AXES = ("data", "model", "seq", "pipe")


def factor(cfg=None, n: int = 1) -> Dict[str, int]:
    """The mesh shape for ``n`` processes, as JAX's ``make_mesh`` factors its devices
    (s2t_tpu/parallel/mesh.py:42-57): ``data_parallel`` -1 fills the data axis."""
    from s2t_tpu_torch.config import DistributedConfig

    cfg = cfg or DistributedConfig()
    model = max(cfg.model_parallel, 1)
    seq = max(cfg.seq_parallel, 1)
    pipe = max(cfg.pipeline_parallel, 1)
    data = cfg.data_parallel if cfg.data_parallel > 0 else n // (model * seq * pipe)
    if data * model * seq * pipe != n:
        raise ValueError(
            f"mesh {data}x{model}x{seq}x{pipe} != {n} devices; set "
            "data_parallel=-1 to auto-fill the data axis")
    return {"data": data, "model": model, "seq": seq, "pipe": pipe}


class Mesh:
    """``shape`` {axis: size}; this process's ``rank`` and its coordinate on each axis;
    ``group(axis)``: the process group of the ranks that differ from this one only on
    ``axis`` (None for an axis of size 1)."""

    def __init__(self, shape: Dict[str, int], rank: int = 0,
                 groups: Optional[Dict[str, Any]] = None):
        self.shape = {a: int(shape[a]) for a in AXES}
        self.rank = int(rank)
        sizes = tuple(self.shape[a] for a in AXES)
        self.coords = dict(zip(AXES, (int(c) for c in np.unravel_index(self.rank, sizes))))
        self.groups = groups or {}

    @property
    def world_size(self) -> int:
        return int(np.prod([self.shape[a] for a in AXES]))

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups.get(axis)

    def ranks(self, axis: str):
        """The global ranks of this rank's group on ``axis``, in axis order."""
        grid = np.arange(self.world_size).reshape(tuple(self.shape[a] for a in AXES))
        idx = tuple(slice(None) if a == axis else self.coords[a] for a in AXES)
        return [int(r) for r in grid[idx]]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def _groups(shape: Dict[str, int]) -> Dict[str, Any]:
    """Every rank creates every group, in one order (``new_group`` is collective)."""
    import torch.distributed as dist

    rank = dist.get_rank()
    grid = np.arange(dist.get_world_size()).reshape(tuple(shape[a] for a in AXES))
    out = {}
    for i, axis in enumerate(AXES):
        if shape[axis] == 1:
            continue
        lines = np.moveaxis(grid, i, -1).reshape(-1, shape[axis])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                out[axis] = g
    return out


def make_mesh(cfg=None, world_size: Optional[int] = None) -> Mesh:
    """The mesh of the initialised process group (world size 1 without one), factored
    by ``cfg`` (a ``DistributedConfig``); ``world_size`` without a process group gives
    the shape alone (no groups), for tools and tests."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        n, rank = dist.get_world_size(), dist.get_rank()
        shape = factor(cfg, n)
        return Mesh(shape, rank, _groups(shape) if n > 1 else {})
    return Mesh(factor(cfg, world_size or 1), 0)


def init_distributed(device: str = "cuda") -> None:
    """Join the process group that ``torchrun``'s environment names (RANK,
    WORLD_SIZE, MASTER_ADDR / MASTER_PORT), NCCL on the card and gloo on the CPU,
    and pin this process to ``cuda:{LOCAL_RANK}``.  Nothing without WORLD_SIZE > 1."""
    import torch.distributed as dist

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return
    cuda = str(device).startswith("cuda")
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if cuda else "gloo")


def batch_sharding(mesh: Mesh, n: int):
    """The rows [start, stop) of a global batch of ``n`` rows that this rank keeps
    (JAX shards the leading dim over "data", s2t_tpu/parallel/mesh.py:60-62)."""
    d = mesh.size("data")
    if n % d:
        raise ValueError(f"batch dim {n} not divisible by the {d} data-parallel ranks")
    per = n // d
    start = mesh.index("data") * per
    return start, start + per


def shard_batch(batch: Dict[str, Any], mesh: Mesh, batch_dim: int = 0) -> Dict[str, Any]:
    """This rank's contiguous rows of every leaf with a batch dim (``batch_dim``, 1
    under ``update_freq`` > 1); scalars stay whole."""
    if mesh.size("data") == 1:
        return batch
    out = {}
    for key, val in batch.items():
        if isinstance(val, dict):
            out[key] = shard_batch(val, mesh, batch_dim)
        elif getattr(val, "ndim", 0) > batch_dim:
            start, stop = batch_sharding(mesh, val.shape[batch_dim])
            out[key] = val.narrow(batch_dim, start, stop - start) if isinstance(
                val, torch.Tensor) else np.asarray(val)[(slice(None),) * batch_dim +
                                                        (slice(start, stop),)]
        else:
            out[key] = val
    return out
