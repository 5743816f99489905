"""NeRF positional encoding without the identity term: frequencies 2^0 ..
2^(F-1), features ordered [F, (sin, sin + pi/2), C].

Frozen here in plain PyTorch from the program's module of the same name
(``havatar_tpu_torch``); the benchmark's reference imports nothing of it.
"""

from __future__ import annotations

import math

import torch


def positional_encoding(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """[..., C] -> [..., 2 * num_freqs * C]."""
    freq = 2.0 ** torch.linspace(0.0, num_freqs - 1, num_freqs,
                                 dtype=x.dtype, device=x.device)
    angles = x[..., None, :] * freq[:, None]                 # [..., F, C]
    feats = torch.sin(torch.stack((angles, angles + math.pi / 2), dim=-2))
    return feats.reshape(*x.shape[:-1], -1)


def posenc_dim(num_freqs: int, input_dims: int = 3) -> int:
    return input_dims * 2 * num_freqs
