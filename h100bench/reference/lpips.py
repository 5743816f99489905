"""LPIPS perceptual loss (VGG16 backbone) on the JAX package's parameter
tree ``{"conv": {"b{i}_c{j}": {"weight" HWIO, "bias"}}, "lin":
{"l{i}": [1, 1, C, 1]}}``: inputs scaled to [-1, 1], features at relu1_2 /
2_2 / 3_3 / 4_3 / 5_3, unit-normalised, through the lin heads, averaged.

Frozen here in plain PyTorch from the program's module of the same name
(``havatar_tpu_torch``); the benchmark's reference imports nothing of it.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F


# VGG16 conv plan: (out_channels, layers_per_block), a max-pool between blocks
_VGG_PLAN = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]

# LPIPS input normalisation (the lpips package's scaling layer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

Params = Dict[str, Any]


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


def _vgg_features(params: Params, x: torch.Tensor) -> List[torch.Tensor]:
    """x NCHW -> the five blocks' relu outputs, NCHW."""
    feats, h = [], x
    for bi, (_, n) in enumerate(_VGG_PLAN):
        for li in range(n):
            p = params["conv"][f"b{bi}_c{li}"]
            h = torch.relu(F.conv2d(h, _oihw(p["weight"]), p["bias"],
                                    padding=1))
        feats.append(h)
        if bi < len(_VGG_PLAN) - 1:
            h = F.max_pool2d(h, 2, 2)
    return feats


def lpips(params: Params, img0: torch.Tensor,
          img1: torch.Tensor) -> torch.Tensor:
    """img0, img1: [B, H, W, 3] in [-1, 1]. Returns the scalar mean
    distance."""
    shift = torch.tensor(_SHIFT, dtype=img0.dtype, device=img0.device)
    scale = torch.tensor(_SCALE, dtype=img0.dtype, device=img0.device)

    def features(x):
        return _vgg_features(params, ((x - shift) / scale)
                             .permute(0, 3, 1, 2))

    total = 0.0
    for bi, (a, b) in enumerate(zip(features(img0), features(img1))):
        a = a * torch.rsqrt(a.square().sum(1, keepdim=True) + 1e-10)
        b = b * torch.rsqrt(b.square().sum(1, keepdim=True) + 1e-10)
        d = F.conv2d((a - b).square(), _oihw(params["lin"][f"l{bi}"]))
        total = total + d.mean(dim=(1, 2, 3))
    return total.mean()


def lpips_loss(params: Params, img0_01: torch.Tensor,
               img1_01: torch.Tensor) -> torch.Tensor:
    """[0, 1]-ranged NHWC images."""
    return lpips(params, img0_01 * 2.0 - 1.0, img1_01 * 2.0 - 1.0)
