"""Shared CLI plumbing: config lookup, seeding, host batch to device."""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from havatar_tpu_torch.device import DeviceLike
from havatar_tpu_torch.utils.cfgnode import CfgNode, load_config

# the entries of a dataset batch that the models consume
BATCH_KEYS = frozenset({
    "mv_rays", "gt_color", "gt_hr_img", "gt_lr_mask", "inv_head_T",
    "front_render_cond", "left_render_cond", "right_render_cond",
    "dataset_idx"})

_CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "config")


def resolve_config(path_or_name: str) -> CfgNode:
    """A config file by path, or a built-in one by name."""
    if os.path.exists(path_or_name):
        return load_config(path_or_name)
    builtin = os.path.join(_CONFIG_DIR, path_or_name)
    if os.path.exists(builtin):
        return load_config(builtin)
    raise FileNotFoundError(f"config not found: {path_or_name}")


def seed_everything(seed: int, device: DeviceLike = "cpu") -> torch.Generator:
    """Seed numpy and torch's global generators, and return a generator of
    the run's own on ``device``, seeded the same: what the run draws its
    sample jitter and noise from."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def to_device_batch(batch: Dict[str, Any], device: DeviceLike
                    ) -> Dict[str, Any]:
    """A host batch with its model inputs (``BATCH_KEYS``) as tensors on
    ``device``; the other entries pass through as they are."""
    out = {}
    for k, v in batch.items():
        if k in BATCH_KEYS:
            v = torch.as_tensor(np.asarray(v)).to(device)
        out[k] = v
    return out
