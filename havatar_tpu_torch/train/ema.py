"""Parameter EMA of the stage-2 generator.

Port of ``havatar_tpu/train/ema.py`` (the reference's ``accumulate``, used
with decay 0.5^(32/10k) after every generator step).
"""

from __future__ import annotations

import torch


@torch.no_grad()
def ema_update(ema: torch.nn.Module, model: torch.nn.Module,
               decay: float) -> None:
    """ema <- ema * decay + model * (1 - decay), parameter by parameter, in
    place (the two modules have the same structure)."""
    for e, p in zip(ema.parameters(), model.parameters(), strict=True):
        e.mul_(decay).add_(p.detach(), alpha=1.0 - decay)
