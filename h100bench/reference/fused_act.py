"""Bias + leaky ReLU + sqrt(2) gain (StyleGAN's fused_leaky_relu).

Frozen here in plain PyTorch from the program's module of the same name
(``havatar_tpu_torch``); the benchmark's reference imports nothing of it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)


def fused_leaky_relu(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     negative_slope: float = 0.2, scale: float = SQRT2,
                     channel_axis: int = 1) -> torch.Tensor:
    """leaky_relu(x + bias) * scale, bias broadcast along ``channel_axis``."""
    if bias is not None:
        shape = [1] * x.ndim
        shape[channel_axis] = bias.shape[0]
        x = x + bias.to(x.dtype).reshape(shape)
    return F.leaky_relu(x, negative_slope) * scale
