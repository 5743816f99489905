"""Reenactment inference: the per-frame pipeline and the flagship model.

Port of ``havatar_tpu/infer/reenact.py`` (``make_reenact_fn``,
``mean_style``) and of the bench flagship (``__graft_entry__.py:
_build_flagship``): two plane generators (256^2 conditions -> 128^2 x 64
planes), the fused gated march (16 coarse + 16 fine samples a ray by
default), and StyleUNetSR lifting the 128^2 feature image to 512^2 RGB.

Public layout is the JAX package's: rays [B, R, 8], bg [B, R, 3],
latent [B, 32], inv_head_T [B, 4, 3], conditions NHWC [B, 256, 256, 7],
frames NHWC [B, 512, 512, 3].
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch
import torch.nn as nn

from havatar_tpu_torch.device import DeviceLike, resolve_device
from havatar_tpu_torch.models.blocks import (
    ConstantInput,
    EqualConv2d,
    EqualLinear,
    ModulatedConv2d,
)
from havatar_tpu_torch.models.generators import StyleUNetSR
from havatar_tpu_torch.models.renderer import AvatarRenderer
from havatar_tpu_torch.models.skinning import VolumeDecoder
from havatar_tpu_torch.ops.rays import get_rays_np, tighten_ray_near_far


def mean_style(style_dim: int, n: int = 1000, seed: int = 42,
               device: DeviceLike = None) -> torch.Tensor:
    """Mean of n raw normal latents [1, style_dim] (mapped inside the
    generator at call time), drawn from a seeded ``torch.Generator``."""
    dev = resolve_device(device)
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(n, 1, style_dim, generator=g).mean(0).to(dev)


def make_reenact_fn(renderer: AvatarRenderer, generator: StyleUNetSR, *,
                    num_coarse: int = 64, num_fine: int = 16,
                    gated: bool = False, to_uint8: bool = True) -> Callable:
    """The per-frame pipeline: (fixed_volume, style, rays, bg, latent,
    inv_head_T, front, left, right) -> frame [B, H, W, 3], uint8 or (with
    ``to_uint8=False``) float in [0, 1] scale.

    ``gated`` cuts each ray's near/far to the avatar's world AABB plus the
    one-texel halo (``renderer.gate_aabb``) before the march; pair it with
    a smaller ``num_coarse``.
    """
    def frame_fn(fixed_volume, style, rays, bg, latent, inv_head_T, front,
                 left, right):
        with torch.inference_mode():
            if gated:
                rays = tighten_ray_near_far(rays, renderer.gate_aabb,
                                            inv_head_T)
            render, _ = renderer.render_full_image(
                rays, bg, latent, inv_head_T, front, left, right,
                num_coarse=num_coarse, num_fine=num_fine,
                fixed_volume=fixed_volume)
            style_b = style.expand(render.shape[0], style.shape[-1])
            img = generator(style_b, render[..., 3:].permute(0, 3, 1, 2))
            img = img.permute(0, 2, 3, 1)
            if to_uint8:
                img = torch.clamp(img * 255.0, 0.0, 255.0).to(torch.uint8)
            return img

    return frame_fn


@torch.no_grad()
def seeded_init_(module: nn.Module, seed: int) -> nn.Module:
    """Re-draw every random parameter of ``module`` from a numpy seed, with
    the JAX package's initializers: N(0, 1) for equalized-lr weights
    (EqualLinear's divided by lr_mul) and constant inputs, LeCun normal for
    the field's dense layers, Xavier normal for the volume decoder's convs,
    U(0, 1) for its seed. Constant initializations (biases) stay."""
    rng = np.random.RandomState(seed)

    def normal(shape, std=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * std).astype(np.float32))

    for m in module.modules():
        if isinstance(m, EqualLinear):
            m.weight.copy_(normal(m.weight.shape) / m.lr_mul)
        elif isinstance(m, (EqualConv2d, ModulatedConv2d)):
            m.weight.copy_(normal(m.weight.shape))
        elif isinstance(m, ConstantInput):
            m.input.copy_(normal(m.input.shape))
        elif isinstance(m, nn.Linear):
            m.weight.copy_(normal(m.weight.shape, 1 / math.sqrt(m.in_features)))
            m.bias.zero_()
        elif isinstance(m, nn.Conv3d):
            fan_in = m.weight[0].numel()
            fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
            m.weight.copy_(normal(m.weight.shape,
                                  math.sqrt(2.0 / (fan_in + fan_out))))
            m.bias.zero_()
        elif isinstance(m, VolumeDecoder):
            m.init_lc.copy_(torch.from_numpy(
                rng.rand(*m.init_lc.shape).astype(np.float32)))
    return module


class Flagship(NamedTuple):
    frame_fn: Callable
    renderer: AvatarRenderer
    generator: StyleUNetSR
    inputs: Dict[str, torch.Tensor]   # frame_fn's keyword arguments


def flagship_rays(render_size: int = 128) -> np.ndarray:
    """The flagship's portrait camera: at (0, -0.1, 3) looking down -z,
    focal 1.2 * render_size, near/far 1.4/4.0 -> rays [1, R, 8]."""
    c2w = np.array([[1.0, 0.0, 0.0, 0.0],
                    [0.0, -1.0, 0.0, -0.1],
                    [0.0, 0.0, -1.0, 3.0]], dtype=np.float32)
    ro, rd = get_rays_np(render_size, render_size,
                         (1.2 * render_size, 1.2 * render_size, 0.5, 0.5),
                         c2w)
    R = render_size * render_size
    return np.concatenate([ro.reshape(1, R, 3), rd.reshape(1, R, 3),
                           np.full((1, R, 1), 1.4, np.float32),
                           np.full((1, R, 1), 4.0, np.float32)], -1)


def build_flagship(device: DeviceLike = None, seed: int = 0,
                   num_coarse: int = 16, num_fine: int = 16,
                   gated: bool = True, render_size: int = 128,
                   cond_res: int = 256, plane_res: int = 128,
                   plane_middle_size: int = 16, sr_out: int = 512
                   ) -> Flagship:
    """The flagship reenactment model in bf16 with weights drawn from
    ``seed`` (``seeded_init_``) and the flagship's inputs for one frame: its
    camera, white background, zero latent and style, identity head pose and
    0.5 conditions. Sizes default to the full width (the tests pass tiny
    ones); on CUDA unless ``device`` says otherwise."""
    dev = resolve_device(device)
    renderer = AvatarRenderer(render_size=render_size, cond_res=cond_res,
                              plane_res=plane_res,
                              plane_middle_size=plane_middle_size,
                              compute_dtype=torch.bfloat16)
    generator = StyleUNetSR(inp_size=render_size, inp_ch=64, out_ch=3,
                            out_size=sr_out, style_dim=64, n_mlp=4,
                            compute_dtype=torch.bfloat16)
    seeded_init_(renderer, seed)
    seeded_init_(generator, seed + 1)
    renderer = renderer.to(dev).eval()
    generator = generator.to(dev).eval()
    B, R = 1, render_size * render_size
    with torch.inference_mode():
        skin_vol = renderer.skin_volume()
    eye = torch.cat([torch.eye(3), torch.zeros(1, 3)], 0)
    inputs = {
        "fixed_volume": skin_vol,
        "style": torch.zeros(B, 64, device=dev),
        "rays": torch.from_numpy(flagship_rays(render_size)).to(dev),
        "bg": torch.ones(B, R, 3, device=dev),
        "latent": torch.zeros(B, 32, device=dev),
        "inv_head_T": eye.expand(B, 4, 3).contiguous().to(dev),
        **{k: torch.full((B, cond_res, cond_res, 7), 0.5, device=dev)
           for k in ("front", "left", "right")},
    }
    frame_fn = make_reenact_fn(renderer, generator, num_coarse=num_coarse,
                               num_fine=num_fine, gated=gated, to_uint8=False)
    return Flagship(frame_fn, renderer, generator, inputs)
