"""Uniform box warp: world AABB -> the [-1, 1]^3 sampling cube.

Port of ``havatar_tpu/ops/boxwarp.py`` (``get_box_warp_param``, ``BoxWarp``,
``BoxWarpLegacy``). Scale and offset are float32 tensors made on each device
once (``utils/profiling.py:device_numbers``), never copied from the host in a
step.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from havatar_tpu_torch.utils.profiling import device_numbers


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

    def _on(self, device: torch.device):
        """(scale, trans) float32 on ``device``."""
        return (device_numbers(self.scales, device, torch.float32),
                device_numbers(self.trans, device, torch.float32))

    def __call__(self, coords: torch.Tensor) -> torch.Tensor:
        scale, trans = self._on(coords.device)
        return coords * scale + trans

    def inv(self, coords: torch.Tensor) -> torch.Tensor:
        """The sampling cube back to world space: (coords - trans) / scale."""
        scale, trans = self._on(coords.device)
        return (coords - trans) / scale


class BoxWarpLegacy(BoxWarp):
    """2 * (coordinates * scale + trans): the reference's older
    ``UniformBoxWarp`` (utils/util.py:207-211)."""

    def __call__(self, coords: torch.Tensor) -> torch.Tensor:
        return 2.0 * super().__call__(coords)

    def inv(self, coords: torch.Tensor) -> torch.Tensor:
        return super().inv(coords * 0.5)
