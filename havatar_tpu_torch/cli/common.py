"""Shared CLI plumbing: config lookup and seeding."""

from __future__ import annotations

import os

import numpy as np
import torch

from havatar_tpu_torch.utils.cfgnode import CfgNode, load_config

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


def seed_everything(seed: int) -> torch.Generator:
    np.random.seed(seed)
    return torch.manual_seed(seed)
