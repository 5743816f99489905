"""Multi-GPU: the process group, the mesh, its sharding rules and the
collectives (``torch.distributed``; one process a GPU under torchrun)."""

from havatar_tpu_torch.parallel.mesh import (
    auto_batch_shardings,
    batch_sharding,
    make_mesh,
    pad_to_multiple,
    ray_sharding,
    replicated,
    shard_batch,
)
from havatar_tpu_torch.parallel import comm

__all__ = ["auto_batch_shardings", "batch_sharding", "make_mesh",
           "pad_to_multiple", "ray_sharding", "replicated", "shard_batch",
           "comm"]
