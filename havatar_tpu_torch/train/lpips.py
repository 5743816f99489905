"""LPIPS perceptual loss (VGG16 backbone).

Counterpart of ``havatar_tpu/train/lpips_jax.py``: inputs scaled to [-1, 1],
VGG16 features at relu1_2 / 2_2 / 3_3 / 4_3 / 5_3, unit-normalised per
channel, squared difference through learned 1x1 "lin" heads, spatially
averaged and summed over layers. Images are NHWC at this module's functions;
the convolutions run NCHW inside (``F.conv2d`` and ``F.max_pool2d``: the JAX
file computes them outside any hand-written kernel too).

The parameter tree is the JAX one: ``{"conv": {"b{i}_c{j}": {"weight" HWIO,
"bias"}}, "lin": {"l{i}": [1, 1, C, 1]}}``, so ``load_lpips_file`` reads the
``.npz`` that ``lpips_jax.save_lpips_file`` writes. Pretrained weights are
not bundled; the trainer switches the perceptual term off when the file is
absent.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from havatar_tpu_torch.device import resolve_device
from havatar_tpu_torch.utils.profiling import device_numbers, span

# VGG16 conv plan: (out_channels, layers_per_block), a max-pool between blocks
_VGG_PLAN = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]

# LPIPS input normalisation (the lpips package's scaling layer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

Params = Dict[str, Any]


def init_lpips_params(rng: torch.Generator) -> Params:
    """Random LPIPS parameters (the structure only; see the module
    docstring)."""
    params: Params = {"conv": {}, "lin": {}}
    in_ch = 3
    for bi, (out_ch, n) in enumerate(_VGG_PLAN):
        for li in range(n):
            params["conv"][f"b{bi}_c{li}"] = {
                "weight": torch.randn(3, 3, in_ch, out_ch,
                                      generator=rng) * 0.05,
                "bias": torch.zeros(out_ch)}
            in_ch = out_ch
        params["lin"][f"l{bi}"] = torch.randn(1, 1, out_ch, 1,
                                              generator=rng).abs() * 0.01
    return params


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
    shift = device_numbers(_SHIFT, img0.device, img0.dtype)
    scale = device_numbers(_SCALE, img0.device, img0.dtype)

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
    with span("lpips"):
        return lpips(params, img0_01 * 2.0 - 1.0, img1_01 * 2.0 - 1.0)


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def save_lpips_file(params: Params, path: str) -> None:
    """Write the ``.npz`` that ``load_lpips_file`` (here and in the JAX
    package) reads."""
    tree = _map_leaves(lambda t: t.detach().cpu().numpy(), params)
    np.savez(path, params=np.asarray(tree, dtype=object))


def load_lpips_file(path: str, device=None) -> Optional[Params]:
    """Converted LPIPS weights (the ``.npz`` of ``save_lpips_file``) as
    tensors on ``device`` (default: the CUDA device; raises without one),
    or None if the file is absent: callers gate the perceptual term on
    this."""
    device = resolve_device(device)
    if not path or not os.path.exists(path):
        return None
    data = np.load(path, allow_pickle=True)
    return _map_leaves(
        lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device),
        data["params"].item())


def convert_torch_lpips(vgg_state_dict, lin_state_dict) -> Params:
    """torchvision ``vgg16.features`` + the lpips package's lin heads -> the
    parameter tree. The convolutions sit at feature indices [0, 2, 5, 7, 10,
    12, 14, 17, 19, 21, 24, 26, 28]; lin weights are
    ``lin{i}.model.1.weight`` [1, C, 1, 1]."""
    idx = [[0, 2], [5, 7], [10, 12, 14], [17, 19, 21], [24, 26, 28]]
    params: Params = {"conv": {}, "lin": {}}

    def t(a):
        return torch.as_tensor(a).detach().float().cpu()

    for bi, block in enumerate(idx):
        for li, layer in enumerate(block):
            params["conv"][f"b{bi}_c{li}"] = {
                "weight": t(vgg_state_dict[f"features.{layer}.weight"])
                .permute(2, 3, 1, 0).contiguous(),
                "bias": t(vgg_state_dict[f"features.{layer}.bias"])}
        params["lin"][f"l{bi}"] = t(
            lin_state_dict[f"lin{bi}.model.1.weight"]).permute(
                2, 3, 1, 0).contiguous()
    return params
