"""The device mesh and the rules that split a batch over it.

Port of ``havatar_tpu/parallel/mesh.py``. JAX places one global array on
the mesh with a ``NamedSharding``; here each rank is a process that holds
only its own block, so a sharding becomes a ``ShardSpec`` (which axis is
split over the ``data`` mesh axis, or none) and placing an array becomes
taking this rank's slice of the host array (``local_shard``). The rules are
JAX's: training splits the frame axis when the world size divides it, else
the ray axis of the ray-carrying keys; inference splits the ray axis of a
frame.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from havatar_tpu_torch.device import DeviceLike, resolve_device


def make_mesh(axis_names: Sequence[str] = ("data",),
              device: DeviceLike = None) -> DeviceMesh:
    """A 1-D ``DeviceMesh`` over the whole process group, on ``device``'s
    type (None: CUDA). Needs a process group (``comm.initialize``)."""
    if len(axis_names) != 1:
        raise ValueError(f"one mesh axis is supported, got {axis_names}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "havatar_tpu_torch.parallel.comm.initialize() "
                           "(torchrun sets its environment)")
    return init_device_mesh(resolve_device(device).type,
                            (dist.get_world_size(),),
                            mesh_dim_names=tuple(axis_names))


class ShardSpec(NamedTuple):
    """How an array is split over ``mesh``'s one axis: on ``axis``, or
    replicated (``axis`` None)."""
    mesh: DeviceMesh
    axis: Optional[int]

    @property
    def is_fully_replicated(self) -> bool:
        return self.axis is None


def replicated(mesh: DeviceMesh) -> ShardSpec:
    return ShardSpec(mesh, None)


def batch_sharding(mesh: DeviceMesh, axis: str = "data") -> ShardSpec:
    """Split the leading (batch / frame) axis."""
    return ShardSpec(mesh, 0)


def ray_sharding(mesh: DeviceMesh, axis: str = "data") -> ShardSpec:
    """Split the ray axis of [B, R, ...] arrays."""
    return ShardSpec(mesh, 1)


def local_shard(x, spec: Optional[ShardSpec]):
    """This rank's block of ``x`` (a numpy array or a tensor) under
    ``spec``: ``x`` itself when replicated. The split axis must divide by
    the world size."""
    if spec is None or spec.axis is None:
        return x
    n, rank = spec.mesh.size(), spec.mesh.get_local_rank()
    size = x.shape[spec.axis]
    if size % n:
        raise ValueError(f"axis {spec.axis} of shape {tuple(x.shape)} does "
                         f"not split over {n} ranks")
    k = size // n
    return x[(slice(None),) * spec.axis + (slice(rank * k, (rank + 1) * k),)]


def shard_batch(tree, mesh: DeviceMesh, axis: str = "data"):
    """This rank's block of every array of a dict / list / tuple of host
    arrays, split on the leading axis."""
    spec = batch_sharding(mesh, axis)
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh, axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(v, mesh, axis) for v in tree)
    return local_shard(tree, spec)


#: batch keys carrying a [B, R, ...] ray axis: safe to split on axis 1 when
#: the frame axis does not divide the world size (the image tensors are not
#: listed: splitting their spatial axes would need halo exchanges)
RAY_AXIS_KEYS = ("mv_rays", "gt_color")


def auto_batch_shardings(mesh: DeviceMesh, example: dict, axis: str = "data",
                         ray_keys=RAY_AXIS_KEYS) -> dict:
    """Per-key ``ShardSpec`` of a training batch, JAX's rule: the leading
    (frame) axis when the world size divides it, else axis 1 for
    ``ray_keys`` when it divides, else replicated."""
    n = mesh.size()
    out = {}
    for k, v in example.items():
        shape = getattr(v, "shape", ())
        if len(shape) >= 1 and shape[0] % n == 0 and shape[0] > 0:
            out[k] = ShardSpec(mesh, 0)
        elif k in ray_keys and len(shape) >= 2 and shape[1] % n == 0:
            out[k] = ShardSpec(mesh, 1)
        else:
            out[k] = ShardSpec(mesh, None)
    return out


def pad_to_multiple(x, multiple: int, axis: int):
    """Pad an axis up to a multiple (static shapes for even sharding)."""
    size = x.shape[axis]
    rem = (-size) % multiple
    if rem == 0:
        return x, size
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return np.pad(np.asarray(x), pad), size


def sharded_keys(shardings: dict) -> list:
    """The keys whose spec splits an axis (the CLIs print them)."""
    return [k for k, s in shardings.items() if not s.is_fully_replicated]


def mesh_rank_size(mesh: Optional[DeviceMesh]) -> tuple:
    """(rank, world size) on ``mesh``; (0, 1) without one."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank(), mesh.size()

