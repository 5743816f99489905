"""Data layer: JSON-split dataset + host-side ray/condition pipeline."""

from havatar_tpu_torch.data.dataset import (
    AvatarDataset,
    Loader,
    infinite,
    inv_head_transform,
    load_render_cond,
)
from havatar_tpu_torch.data.prefetch import device_prefetch

__all__ = ["AvatarDataset", "Loader", "infinite", "inv_head_transform",
           "load_render_cond", "device_prefetch"]
