"""Uniform box warp: a world AABB onto the [-1, 1]^3 sampling cube.

Frozen here in plain PyTorch from the program's module of the same name
(``havatar_tpu_torch``); the benchmark's reference imports nothing of it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def get_box_warp_param(
    x_bound: Sequence[float], y_bound: Sequence[float],
    z_bound: Sequence[float],
) -> Tuple[Tuple[float, float, float], Tuple[float, float, float]]:
    """scales/trans such that scale * x + trans maps each bound to [-1, 1]."""
    out_s, out_t = [], []
    for lo, hi in (x_bound, y_bound, z_bound):
        f = 2.0 / (hi - lo)
        c = f * (lo + hi) * 0.5
        out_s.append(float(f))
        out_t.append(float(-c))
    return tuple(out_s), tuple(out_t)


class BoxWarp:
    """coordinates * scale + trans, with float32 scale/trans."""

    def __init__(self, scales, trans):
        self.scales = tuple(float(s) for s in scales)
        self.trans = tuple(float(t) for t in trans)

    @classmethod
    def from_bounds(cls, xyz_bounding) -> "BoxWarp":
        return cls(*get_box_warp_param(*xyz_bounding))

    def __call__(self, coords: torch.Tensor) -> torch.Tensor:
        scale = torch.tensor(self.scales, dtype=torch.float32,
                             device=coords.device)
        trans = torch.tensor(self.trans, dtype=torch.float32,
                             device=coords.device)
        return coords * scale + trans

    def inv(self, coords: torch.Tensor) -> torch.Tensor:
        """The sampling cube back to world space: (coords - trans) / scale."""
        scale = torch.tensor(self.scales, dtype=torch.float32,
                             device=coords.device)
        trans = torch.tensor(self.trans, dtype=torch.float32,
                             device=coords.device)
        return (coords - trans) / scale
