"""Wavelet (SWAGAN-style) discriminator of stage-2 training.

Port of ``havatar_tpu/models/discriminator.py:WaveletDiscriminator``: the
image goes to the Haar wavelet domain, then down a pyramid of FromRGB
adapters (each takes the wavelet image down a level, through
inverse transform, blur-downsample and transform, and adds its features to
the trunk's) and downsampling ConvBlocks to 4 x 4, gets the
minibatch-stddev channel, a 3x3 conv and a two-layer head to one score an
image. With ``c_dim > 0`` the score is projected on the pose: a
four-layer mapping of the flat pose (64 wide, lr_mul 0.01), RMS-normalised,
dotted with the score and divided by sqrt(c_dim) (the stage-2 trainer
builds ``c_dim = 0``).

NCHW, with the reference's ``state_dict`` names: ``from_rgbs.{i}``,
``convs.{i}``, ``final_conv``, ``final_linear.{0,1}``, ``mapping.{i}``, so
``havatar_tpu.checkpoints.convert.convert_discriminator`` reads it.
Every op is differentiable twice (the FIR filters are convolutions), which
the R1 penalty needs.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from havatar_tpu_torch.models.blocks import (
    ConvBlock,
    ConvLayer,
    EqualLinear,
    FromRGB,
    minibatch_stddev,
)
from havatar_tpu_torch.models.generators import channel_map
from havatar_tpu_torch.ops.upfirdn2d import haar_transform
from havatar_tpu_torch.utils.profiling import span


class WaveletDiscriminator(nn.Module):
    """forward(img [B, img_channel, size, size], flat_pose [B, c_dim] when
    ``c_dim > 0``) -> scores [B, 1] float32.
    ``compute_dtype`` is the dtype the convolutions run in; parameters stay
    float32. The minibatch-stddev groups are 4 items (or the batch), one
    feature."""

    def __init__(self, size: int = 512, img_channel: int = 3,
                 channel_multiplier: int = 2, c_dim: int = 0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        ch = channel_map(channel_multiplier)
        log_size = int(math.log2(size)) - 1
        self.compute_dtype = compute_dtype
        self.c_dim = c_dim
        self.from_rgbs = nn.ModuleList()
        self.convs = nn.ModuleList()
        in_channel = ch[size]
        for i in range(log_size, 2, -1):
            out_channel = ch[2 ** (i - 1)]
            self.from_rgbs.append(FromRGB(img_channel * 4, in_channel,
                                          downsample=i != log_size))
            self.convs.append(ConvBlock(in_channel, out_channel))
            in_channel = out_channel
        self.from_rgbs.append(FromRGB(img_channel * 4, ch[4]))
        self.final_conv = ConvLayer(ch[4] + 1, ch[4], 3)
        self.final_linear = nn.Sequential(
            EqualLinear(ch[4] * 4 * 4, ch[4], activation="fused_lrelu"),
            EqualLinear(ch[4], 1))
        if c_dim > 0:
            self.mapping = nn.ModuleList(
                EqualLinear(c_dim if i == 0 else 64, 64, lr_mul=0.01,
                            activation="fused_lrelu") for i in range(4))

    def forward(self, img: torch.Tensor,
                flat_pose: Optional[torch.Tensor] = None) -> torch.Tensor:
        with span("disc"):
            x = haar_transform(img.to(self.compute_dtype))
            out = None
            for from_rgb, conv in zip(self.from_rgbs, self.convs):
                x, out = from_rgb(x, out)
                out = conv(out)
            _, out = self.from_rgbs[-1](x, out)
            out = self.final_conv(minibatch_stddev(out, 4, 1))
            out = self.final_linear(out.reshape(out.shape[0], -1)).float()
            if self.c_dim == 0:
                return out
            if flat_pose is None:
                raise ValueError(
                    "a discriminator with c_dim > 0 needs flat_pose")
            h = flat_pose
            for layer in self.mapping:
                h = layer(h)
            h = h * torch.rsqrt(h.square().mean(dim=1, keepdim=True) + 1e-8)
            return (out * h).sum(dim=1, keepdim=True) / math.sqrt(self.c_dim)
