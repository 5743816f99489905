"""Head-pose skinning: ``VolumeDecoder`` (a fixed seed decoded by six
upsample-conv-instance-norm-relu blocks to a sigmoid volume),
``fix_canonical_volume`` (the inference clamping) and ``SkinningField``
(each point under the identity and the inverse head transform, blended by
the volume sampled there).

Frozen here in plain PyTorch from the program's module of the same name
(``havatar_tpu_torch``); the benchmark's reference imports nothing of it.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from .boxwarp import BoxWarp
from .grid_sample import grid_sample_3d


class _UpBlock(nn.Module):
    """``up`` = [trilinear x2 upsample, Conv3d 3^3, InstanceNorm3d, ReLU]."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.up = nn.Sequential(
            nn.Upsample(scale_factor=2, mode="trilinear", align_corners=False),
            nn.Conv3d(in_ch, out_ch, 3, padding=1),
            nn.InstanceNorm3d(out_ch, affine=False),
            nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.up(x)


class VolumeDecoder(nn.Module):
    """Fixed seed ``init_lc`` -> [1, 2, R, R, R] weight volume (x, 1-x)."""

    def __init__(self, num_in: int = 1024, num_out: int = 1,
                 final_res: int = 64):
        super().__init__()
        self.register_buffer("init_lc", torch.rand(1, num_in, 1, 1, 1))
        init_log2 = int(math.log2(num_in))
        chans = [num_in] + [2 ** (init_log2 - i - 1)
                            for i in range(int(math.log2(final_res)))]
        self.filters = nn.ModuleList(
            _UpBlock(a, b) for a, b in zip(chans[:-1], chans[1:]))
        self.final_conv = nn.Conv3d(chans[-1], num_out, 3, padding=1)

    def forward(self) -> torch.Tensor:
        x = self.init_lc
        for f in self.filters:
            x = f(x)
        x = torch.sigmoid(self.final_conv(x))
        return torch.cat([x, 1.0 - x], dim=1)


def fix_canonical_volume(vol: torch.Tensor) -> torch.Tensor:
    """Inference clamping of a [1, 2, D, H, W] volume: the head-follow weight
    (channel 1) is forced to 1 on the y = 0 slab and on the z = 0,
    y < W/8 corner; channel 0 becomes 1 - channel 1."""
    w1 = vol[:, 1:2].clone()
    w1[:, :, :, 0, :] = 1.0
    w1[:, :, 0, :vol.shape[4] // 8, :] = 1.0
    return torch.cat([1.0 - w1, w1], dim=1)


class SkinningField(nn.Module):
    """Blend points between the identity and the inverse-head transform by
    the canonical weight volume (border-padded trilinear lookups)."""

    def __init__(self, scales: Tuple[float, float, float],
                 trans: Tuple[float, float, float], vol_res: int = 64):
        super().__init__()
        self.canonical_Wvolume = VolumeDecoder(final_res=vol_res)
        self.warp = BoxWarp(scales, trans)

    def volume(self) -> torch.Tensor:
        return self.canonical_Wvolume()

    def forward(self, pts: torch.Tensor, inv_head_T: torch.Tensor,
                volume: Optional[torch.Tensor] = None,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """pts [B, N, 3] f32; inv_head_T [B, 4, 3] (rows 0-2 a
        right-multiplied rotation, row 3 a translation); volume the decoded
        [1, 2, D, H, W] (decoded here when None). ``dtype`` is the dtype the
        volume is sampled in (its values are rounded to it; weights and the
        blend stay f32). Returns canonical points [B, N, 3]."""
        B = pts.shape[0]
        vol = self.volume() if volume is None else volume
        vol = vol.permute(0, 2, 3, 4, 1).to(dtype or vol.dtype)  # [1,D,H,W,2]
        vol = vol.expand(B, *vol.shape[1:])
        eye = torch.cat([torch.eye(3, dtype=pts.dtype, device=pts.device),
                         torch.zeros(1, 3, dtype=pts.dtype,
                                     device=pts.device)], 0)
        pts_inv, weights = [], []
        for i, T in enumerate((eye.expand(B, 4, 3), inv_head_T)):
            p = torch.matmul(pts + T[:, 3:], T[:, :3, :3])
            pts_inv.append(p)
            weights.append(grid_sample_3d(vol[..., i:i + 1].contiguous(),
                                          self.warp(p)))
        w = torch.cat(weights, dim=-1).to(pts.dtype)             # [B, N, 2]
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-8)
        return w[..., 0:1] * pts_inv[0] + w[..., 1:2] * pts_inv[1]
