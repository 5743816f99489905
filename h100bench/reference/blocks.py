"""StyleGAN2 / SWAGAN building blocks, NCHW, in the reference's
``state_dict`` layout (OIHW convolutions, ``[1, out, in, k, k]`` modulated
weights, EqualLinear stored divided by lr_mul); float32 parameters, compute
in the input's dtype.

Frozen here in plain PyTorch from the program's module of the same name
(``havatar_tpu_torch``); the benchmark's reference imports nothing of it.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .fused_act import fused_leaky_relu
from .upfirdn2d import (
    blur,
    downsample2d,
    haar_transform,
    inverse_haar_transform,
    make_kernel,
    upsample2d,
)

BLUR_KERNEL = (1, 3, 3, 1)


class PixelNorm(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-8)


class Blur(nn.Module):
    """StyleGAN ``Blur``; the FIR kernel is a constant, not state."""

    def __init__(self, kernel: Sequence[int], pad, upsample_factor: int = 1):
        super().__init__()
        self.register_buffer("kernel", make_kernel(kernel), persistent=False)
        self.pad = tuple(pad)
        self.upsample_factor = upsample_factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return blur(x, self.kernel, self.pad, self.upsample_factor)


class FusedLeakyReLU(nn.Module):
    def __init__(self, channel: int, bias: bool = True):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channel)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_leaky_relu(x, self.bias)


class EqualConv2d(nn.Module):
    """Conv with a He-scaled runtime weight [out, in, k, k]."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(
            torch.randn(out_channel, in_channel, kernel_size, kernel_size))
        self.scale = 1.0 / math.sqrt(in_channel * kernel_size ** 2)
        self.stride, self.padding = stride, padding
        self.bias = nn.Parameter(torch.zeros(out_channel)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.conv2d(x, (self.weight * self.scale).to(x.dtype),
                       stride=self.stride, padding=self.padding)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)[None, :, None, None]
        return out


class EqualLinear(nn.Module):
    """Linear with equalized lr; weight [out, in] stored divided by lr_mul."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 bias_init: float = 0.0, lr_mul: float = 1.0,
                 activation: Optional[str] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(out_dim, in_dim) / lr_mul)
        self.bias = (nn.Parameter(torch.full((out_dim,), float(bias_init)))
                     if bias else None)
        self.scale = (1.0 / math.sqrt(in_dim)) * lr_mul
        self.lr_mul = lr_mul
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x @ (self.weight * self.scale).to(x.dtype).T
        b = (self.bias * self.lr_mul).to(out.dtype) if self.bias is not None else None
        if self.activation == "fused_lrelu":
            return fused_leaky_relu(out, b, channel_axis=-1)
        return out if b is None else out + b


class ModulatedConv2d(nn.Module):
    """Style-modulated (optionally demodulated) conv with up/down resampling;
    weight [1, out, in, k, k], modulation EqualLinear(style_dim -> in)."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 style_dim: int, demodulate: bool = True,
                 upsample: bool = False, downsample: bool = False,
                 blur_kernel: Sequence[int] = BLUR_KERNEL):
        super().__init__()
        k = kernel_size
        self.kernel_size, self.in_channel = k, in_channel
        self.demodulate, self.upsample, self.downsample = (
            demodulate, upsample, downsample)
        self.weight = nn.Parameter(
            torch.randn(1, out_channel, in_channel, k, k))
        self.scale = 1.0 / math.sqrt(in_channel * k ** 2)
        self.modulation = EqualLinear(style_dim, in_channel, bias_init=1.0)
        factor = 2
        if upsample:
            p = (len(blur_kernel) - factor) - (k - 1)
            self.blur = Blur(blur_kernel, ((p + 1) // 2 + factor - 1,
                                           p // 2 + 1), upsample_factor=factor)
        elif downsample:
            p = (len(blur_kernel) - factor) + (k - 1)
            self.blur = Blur(blur_kernel, ((p + 1) // 2, p // 2))

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        style = self.modulation(style)                         # [B, in]
        w = self.weight[0] * self.scale                        # [out, in, k, k]
        if self.demodulate:
            w2 = (w.float() ** 2).sum(dim=(2, 3))              # [out, in]
            demod = torch.rsqrt(style.float() ** 2 @ w2.T + 1e-8)  # [B, out]
        x = x * style.to(x.dtype)[:, :, None, None]
        w_c = w.to(x.dtype)
        if self.upsample:
            out = self.blur(F.conv_transpose2d(x, w_c.transpose(0, 1),
                                               stride=2))
        elif self.downsample:
            out = F.conv2d(self.blur(x), w_c, stride=2)
        else:
            out = F.conv2d(x, w_c, padding=self.kernel_size // 2)
        if self.demodulate:
            out = out * demod.to(out.dtype)[:, :, None, None]
        return out


class NoiseInjection(nn.Module):
    """x + weight * noise; with no noise tensor (inference) adds nothing."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if noise is None:
            return x
        return x + self.weight.to(x.dtype) * noise.to(x.dtype)


class ConstantInput(nn.Module):
    def __init__(self, channel: int, size: int = 4):
        super().__init__()
        self.input = nn.Parameter(torch.randn(1, channel, size, size))

    def forward(self, batch: int) -> torch.Tensor:
        return self.input.repeat(batch, 1, 1, 1)


class ConvLayer(nn.Sequential):
    """[Blur] + EqualConv2d + [FusedLeakyReLU]: the reference's Sequential,
    so its children are named 0, 1(, 2)."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 downsample: bool = False, bias: bool = True,
                 activate: bool = True,
                 blur_kernel: Sequence[int] = BLUR_KERNEL):
        layers = []
        if downsample:
            p = (len(blur_kernel) - 2) + (kernel_size - 1)
            layers.append(Blur(blur_kernel, ((p + 1) // 2, p // 2)))
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        layers.append(EqualConv2d(in_channel, out_channel, kernel_size,
                                  stride=stride, padding=padding,
                                  bias=bias and not activate))
        if activate:
            layers.append(FusedLeakyReLU(out_channel, bias=bias))
        super().__init__(*layers)


class ConvBlock(nn.Module):
    """3x3 conv + 3x3 downsampling conv."""

    def __init__(self, in_channel: int, out_channel: int):
        super().__init__()
        self.conv1 = ConvLayer(in_channel, in_channel, 3)
        self.conv2 = ConvLayer(in_channel, out_channel, 3, downsample=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class FromRGB(nn.Module):
    """Image-pyramid input adapter: downsamples the image (optionally through
    the wavelet domain), 1x1 conv to features, adds the skip."""

    def __init__(self, in_channel: int, out_channel: int,
                 downsample: bool = True, use_wt: bool = True,
                 blur_kernel: Sequence[int] = BLUR_KERNEL):
        super().__init__()
        self.downsample, self.use_wt = downsample, use_wt
        self.register_buffer("blur_kernel", make_kernel(blur_kernel),
                             persistent=False)
        self.conv = ConvLayer(in_channel, out_channel, 1)

    def forward(self, img: torch.Tensor, skip: Optional[torch.Tensor] = None):
        if self.downsample:
            if self.use_wt:
                img = haar_transform(downsample2d(
                    inverse_haar_transform(img), self.blur_kernel))
            else:
                img = downsample2d(img, self.blur_kernel)
        out = self.conv(img)
        if skip is not None:
            out = out + skip
        return img, out


class StyledConv(nn.Module):
    """ModulatedConv2d + noise + fused leaky ReLU."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 style_dim: int, upsample: bool = False,
                 demodulate: bool = True,
                 blur_kernel: Sequence[int] = BLUR_KERNEL):
        super().__init__()
        self.conv = ModulatedConv2d(in_channel, out_channel, kernel_size,
                                    style_dim, demodulate=demodulate,
                                    upsample=upsample,
                                    blur_kernel=blur_kernel)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(out_channel)

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.activate(self.noise(self.conv(x, style), noise))


class ToRGB(nn.Module):
    """1x1 modulated conv to output channels, plus the upsampled skip
    (through the wavelet domain when ``use_wt``)."""

    def __init__(self, in_channel: int, out_channel: int, style_dim: int,
                 upsample: bool = True, use_wt: bool = True,
                 blur_kernel: Sequence[int] = BLUR_KERNEL):
        super().__init__()
        self.use_wt = use_wt
        self.register_buffer("blur_kernel", make_kernel(blur_kernel),
                             persistent=False)
        self.conv = ModulatedConv2d(in_channel, out_channel, 1, style_dim,
                                    demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, out_channel, 1, 1))

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = self.conv(x, style)
        out = out + self.bias.to(out.dtype)
        if skip is not None:
            if self.use_wt:
                skip = haar_transform(upsample2d(
                    inverse_haar_transform(skip), self.blur_kernel))
            else:
                skip = upsample2d(skip, self.blur_kernel)
            out = out + skip
        return out


def minibatch_stddev(x: torch.Tensor, group_size: int = 4,
                     num_features: int = 1) -> torch.Tensor:
    """Append the minibatch-stddev channel(s): x [B, C, H, W] ->
    [B, C + num_features, H, W]. Batch items b, b + B/g, ... form a group;
    the channels split as [num_features, C / num_features]; each feature's
    stddev over the group (biased variance + 1e-8), averaged over its
    channels and the image, is broadcast over H x W. B must be a multiple
    of min(B, group_size)."""
    B, C, H, W = x.shape
    group = min(B, group_size)
    y = x.reshape(group, -1, num_features, C // num_features, H, W)
    std = torch.sqrt(y.var(dim=0, unbiased=False) + 1e-8)   # [B/g, F, C/F, H, W]
    std = std.mean(dim=(2, 3, 4)).repeat(group, 1)          # [B, F]
    return torch.cat([x, std[:, :, None, None].expand(B, num_features, H, W)
                      .to(x.dtype)], 1)
