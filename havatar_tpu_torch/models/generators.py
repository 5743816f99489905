"""Condition-plane generator and StyleUNet super-resolution generator.

Port of ``havatar_tpu/models/generators.py`` (``StyleMLP``,
``PlaneGenerator``, ``TwoHeadPlaneGenerator``, ``StyleUNetSR``), NCHW
inside, with the reference ``state_dict`` names (``style.{i}``, ``conv_in``,
``from_rgbs``, ``cond_convs``, ``comb_convs``, ``input``, ``conv1``,
``convs``, ``to_rgbs``, ``conv_out``; the two-head generator's second head
carries the suffix ``1``: ``conv_in1``, ``cond_convs1``, ``comb_convs1``,
``convs_head1``, ``conv_out1``). The plane generators run with zero noise
and one style; ``StyleUNetSR`` also takes two styles with an injection index
(style mixing) and a noise tensor for each of its StyledConvs, as stage-2
training calls it.

``compute_dtype`` is the dtype the convolutions run in (bfloat16 for the
GPU frame); parameters stay float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn

from havatar_tpu_torch.models.blocks import (
    ConstantInput,
    ConvBlock,
    ConvLayer,
    EqualLinear,
    FromRGB,
    PixelNorm,
    StyledConv,
    ToRGB,
)
from havatar_tpu_torch.ops.upfirdn2d import inverse_haar_transform
from havatar_tpu_torch.utils.profiling import span


def channel_map(channel_multiplier: int = 2) -> Dict[int, int]:
    """StyleGAN2 per-resolution channel widths."""
    return {
        4: 512, 8: 512, 16: 512, 32: 512,
        64: 256 * channel_multiplier,
        128: 128 * channel_multiplier,
        256: 64 * channel_multiplier,
        512: 32 * channel_multiplier,
        1024: 16 * channel_multiplier,
    }


class StyleMLP(nn.Sequential):
    """PixelNorm + n_mlp EqualLinear(fused lrelu, lr_mul): children 0..n_mlp
    as in the reference's Sequential."""

    def __init__(self, in_dim: int, hidden_dim: int, n_mlp: int,
                 lr_mul: float = 0.01):
        super().__init__(PixelNorm(), *[
            EqualLinear(in_dim if i == 0 else hidden_dim, hidden_dim,
                        lr_mul=lr_mul, activation="fused_lrelu")
            for i in range(n_mlp)])


class _CondEncoder(nn.Module):
    """The conditioning-image encoder shared by both generators:
    a strided conv-in, then per stage a FromRGB image-pyramid adapter and a
    downsampling ConvBlock. ``cond_list`` holds every stage's features."""

    def _build_encoder(self, ch, inp_size: int, inp_ch: int, enc_stages):
        in_channel = ch[inp_size // 2]
        self.conv_in = ConvLayer(inp_ch, in_channel, 3, downsample=True)
        self.from_rgbs = nn.ModuleList()
        self.cond_convs = nn.ModuleList()
        comb_channels = [in_channel]
        for i in enc_stages:
            out_channel = ch[2 ** i]
            self.from_rgbs.append(FromRGB(inp_ch, in_channel,
                                          downsample=True, use_wt=False))
            self.cond_convs.append(ConvBlock(in_channel, out_channel))
            comb_channels.append(out_channel)
            in_channel = out_channel
        return comb_channels

    def _encode(self, cond_img: torch.Tensor):
        cond_out = self.conv_in(cond_img)
        cond_list = [cond_out]
        img = cond_img
        for from_rgb, cond_conv in zip(self.from_rgbs, self.cond_convs):
            img, cond_out = from_rgb(img, cond_out)
            cond_out = cond_conv(cond_out)
            cond_list.append(cond_out)
        return cond_list


class PlaneGenerator(_CondEncoder):
    """Conditioned StyleGAN feature-plane generator (reference
    ``StyleGAN_zxc`` with no_skip and zero noise).

    forward(styles [B, style_dim], cond_img [B, inp_ch, S, S])
      -> plane [B, out_ch, out_size, out_size] in ``compute_dtype``.
    """

    def __init__(self, out_ch: int, out_size: int = 128, style_dim: int = 44,
                 mlp_dim: int = 32, n_mlp: int = 4, middle_size: int = 16,
                 inp_size: int = 256, inp_ch: int = 7,
                 channel_multiplier: int = 2, lr_mlp: float = 0.01,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        ch = channel_map(channel_multiplier)
        self.compute_dtype = compute_dtype
        log_size, mid_log = int(math.log2(out_size)), int(math.log2(middle_size))
        self.style = StyleMLP(style_dim, mlp_dim, n_mlp, lr_mlp)
        comb_channels = self._build_encoder(
            ch, inp_size, inp_ch, range(int(math.log2(inp_size)) - 2,
                                        mid_log, -1))
        n_cond = len(comb_channels)
        self.input = ConstantInput(ch[middle_size], size=middle_size)
        self.conv1 = StyledConv(ch[middle_size], ch[middle_size], 3, mlp_dim)
        self.comb_convs = nn.ModuleDict()
        self.convs = nn.ModuleList()
        # injection plan: before upsample stage k (trunk index i = 2k+1),
        # concat cond_list[ci] and fuse it with comb_convs[ci]
        self.inject = []
        in_channel, i = ch[middle_size], 1
        for res_log in range(mid_log + 1, log_size + 1):
            out_channel = ch[2 ** res_log]
            ci = None
            if 1 < i <= 2 * n_cond + 1:
                ci = n_cond - i // 2
                self.comb_convs[str(ci)] = ConvLayer(
                    in_channel + comb_channels[ci], comb_channels[ci], 3)
            self.inject.append(ci)
            self.convs.append(StyledConv(in_channel, out_channel, 3, mlp_dim,
                                         upsample=True))
            self.convs.append(StyledConv(out_channel, out_channel, 3,
                                         mlp_dim))
            in_channel, i = out_channel, i + 2
        self.conv_out = ConvLayer(in_channel, out_ch, 1)

    def forward(self, styles: torch.Tensor,
                cond_img: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        w = self.style(styles.to(cdt))
        cond_list = self._encode(cond_img.to(cdt))
        out = self.conv1(self.input(cond_img.shape[0]).to(cdt), w)
        for k, ci in enumerate(self.inject):
            if ci is not None:
                out = self.comb_convs[str(ci)](
                    torch.cat([out, cond_list[ci]], dim=1))
            out = self.convs[2 * k](out, w)
            out = self.convs[2 * k + 1](out, w)
        return self.conv_out(out)


class TwoHeadPlaneGenerator(nn.Module):
    """One latent-driven trunk up to ``split_size``, then two heads that
    each inject their own condition encoder's features and upsample to
    ``out_size`` (reference ``StyleGAN_zxc_twoHead`` with no_skip and zero
    noise; its per-head FromRGB pyramids are never called and are not built).

    forward(styles [B, style_dim], cond_front [B, inp_ch[0], S, S],
            cond_side [B, inp_ch[1], S, S])
      -> (plane0, plane1), each [B, out_ch, out_size, out_size].
    """

    def __init__(self, out_ch: int, out_size: int = 128, style_dim: int = 44,
                 mlp_dim: int = 32, n_mlp: int = 4, middle_size: int = 8,
                 split_size: int = 32, inp_size: int = 256,
                 inp_ch=(7, 13), channel_multiplier: int = 2,
                 lr_mlp: float = 0.01,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if out_size <= split_size:
            raise ValueError(
                f"TwoHeadPlaneGenerator: out_size ({out_size}) must exceed "
                f"split_size ({split_size}) or the per-plane heads are empty "
                f"and the condition images have no effect")
        if inp_size // 2 < split_size:
            raise ValueError(
                f"TwoHeadPlaneGenerator: inp_size ({inp_size}) must be >= "
                f"2*split_size ({2 * split_size}) for a non-empty condition "
                f"encoder")
        ch = channel_map(channel_multiplier)
        self.compute_dtype = compute_dtype
        log_size, mid_log = int(math.log2(out_size)), int(math.log2(middle_size))
        split_log = int(math.log2(split_size))
        self.style = StyleMLP(style_dim, mlp_dim, n_mlp, lr_mlp)
        self.input = ConstantInput(ch[middle_size], size=middle_size)
        self.conv1 = StyledConv(ch[middle_size], ch[middle_size], 3, mlp_dim)
        self.convs = nn.ModuleList()
        in_channel = ch[middle_size]
        for res_log in range(mid_log + 1, split_log + 1):
            out_channel = ch[2 ** res_log]
            self.convs.append(StyledConv(in_channel, out_channel, 3, mlp_dim,
                                         upsample=True))
            self.convs.append(StyledConv(out_channel, out_channel, 3,
                                         mlp_dim))
            in_channel = out_channel
        trunk_channel = in_channel
        enc_stages = range(int(math.log2(inp_size)) - 2, split_log - 1, -1)
        self.inject = []      # the same plan for both heads
        for k, sfx in enumerate(("", "1")):
            in_channel = ch[inp_size // 2]
            conv_in = ConvLayer(inp_ch[k], in_channel, 3, downsample=True)
            cond_convs = nn.ModuleList()
            comb_channels = [in_channel]
            for i in enc_stages:
                cond_convs.append(ConvBlock(in_channel, ch[2 ** i]))
                comb_channels.append(ch[2 ** i])
                in_channel = ch[2 ** i]
            comb_convs, convs_head = nn.ModuleDict(), nn.ModuleList()
            in_channel, inject = trunk_channel, []
            for stage, res_log in enumerate(range(split_log + 1,
                                                  log_size + 1)):
                out_channel = ch[2 ** res_log]
                ci = len(comb_channels) - 1 - stage
                comb_convs[str(ci)] = ConvLayer(
                    in_channel + comb_channels[ci], comb_channels[ci], 3)
                convs_head.append(StyledConv(comb_channels[ci], out_channel,
                                             3, mlp_dim, upsample=True))
                convs_head.append(StyledConv(out_channel, out_channel, 3,
                                             mlp_dim))
                inject.append(ci)
                in_channel = out_channel
            self.inject = inject
            setattr(self, f"conv_in{sfx}", conv_in)
            setattr(self, f"cond_convs{sfx}", cond_convs)
            setattr(self, f"comb_convs{sfx}", comb_convs)
            setattr(self, f"convs_head{sfx}", convs_head)
            setattr(self, f"conv_out{sfx}", ConvLayer(in_channel, out_ch, 1))

    def forward(self, styles: torch.Tensor, cond_front: torch.Tensor,
                cond_side: torch.Tensor):
        cdt = self.compute_dtype
        w = self.style(styles.to(cdt))
        out = self.conv1(self.input(cond_front.shape[0]).to(cdt), w)
        for conv in self.convs:
            out = conv(out, w)
        trunk_out, planes = out, []
        for sfx, cond in (("", cond_front), ("1", cond_side)):
            cond_out = getattr(self, f"conv_in{sfx}")(cond.to(cdt))
            cond_list = [cond_out]
            for cond_conv in getattr(self, f"cond_convs{sfx}"):
                cond_out = cond_conv(cond_out)
                cond_list.append(cond_out)
            comb_convs = getattr(self, f"comb_convs{sfx}")
            convs_head = getattr(self, f"convs_head{sfx}")
            out = trunk_out
            for stage, ci in enumerate(self.inject):
                out = comb_convs[str(ci)](
                    torch.cat([out, cond_list[ci]], dim=1))
                out = convs_head[2 * stage](out, w)
                out = convs_head[2 * stage + 1](out, w)
            planes.append(getattr(self, f"conv_out{sfx}")(out))
        return planes[0], planes[1]


class StyleUNetSR(_CondEncoder):
    """StyleUNet super-resolution generator (reference ``SWGAN_unet``):
    U-Net encoder over the feature image + wavelet StyleGAN2 decoder.

    forward(styles [B, style_dim] or a list of one or two,
            cond_img [B, inp_ch, inp_size, inp_size], noise=None,
            inject_index=None) -> [B, out_ch, out_size, out_size] float32.

    With two styles, decoder layer i (of ``n_latent``) takes the first
    style's latent where i < inject_index (default n_latent // 2) and the
    second's from there on. ``noise`` is None (no noise) or one tensor
    [B, 1, r, r] for each StyledConv in order (``noise_shapes``;
    ``draw_noise`` draws them).
    """

    def __init__(self, inp_size: int = 128, inp_ch: int = 64,
                 out_ch: int = 3, out_size: int = 512, style_dim: int = 64,
                 n_mlp: int = 4, middle_size: int = 8,
                 channel_multiplier: int = 2, lr_mlp: float = 0.01,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        ch = channel_map(channel_multiplier)
        self.compute_dtype = compute_dtype
        self.style_dim = style_dim
        log_size = int(math.log2(out_size)) - 1
        mid_log = int(math.log2(middle_size))
        self.n_latent = log_size * 2 - (mid_log * 2 - 1) + 1
        self.noise_res = [2 ** r for r in range(mid_log + 1, log_size + 1)
                          for _ in range(2)]
        self.style = StyleMLP(style_dim, style_dim, n_mlp, lr_mlp)
        comb_channels = self._build_encoder(
            ch, inp_size, inp_ch, range(int(math.log2(inp_size)) - 2,
                                        mid_log - 1, -1))
        n_comb = len(comb_channels)
        self.comb_convs = nn.ModuleDict()
        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        self.inject = []
        in_channel, i = ch[middle_size], 0
        for res_log in range(mid_log + 1, log_size + 1):
            out_channel = ch[2 ** res_log]
            ci = None
            if i == 0:
                ci = n_comb - 1
                self.comb_convs[str(ci)] = ConvLayer(
                    comb_channels[ci], comb_channels[ci], 3)
            elif i < 2 * n_comb:
                ci = n_comb - 1 - i // 2
                self.comb_convs[str(ci)] = ConvLayer(
                    in_channel + comb_channels[ci], comb_channels[ci], 3)
            self.inject.append(ci)
            self.convs.append(StyledConv(in_channel, out_channel, 3,
                                         style_dim, upsample=True))
            self.convs.append(StyledConv(out_channel, out_channel, 3,
                                         style_dim))
            self.to_rgbs.append(ToRGB(out_channel, out_ch * 4, style_dim))
            in_channel, i = out_channel, i + 2

    def noise_shapes(self, batch: int) -> List[tuple]:
        """The shape of each StyledConv's noise tensor, in call order."""
        return [(batch, 1, r, r) for r in self.noise_res]

    def draw_noise(self, batch: int, rng: torch.Generator, device,
                   dtype: torch.dtype = torch.float32) -> List[torch.Tensor]:
        """Standard normal noise for every StyledConv, from ``rng``."""
        return [torch.randn(s, generator=rng, device=device, dtype=dtype)
                for s in self.noise_shapes(batch)]

    def forward(self, styles, cond_img: torch.Tensor,
                noise: Optional[Sequence[torch.Tensor]] = None,
                inject_index: Optional[int] = None) -> torch.Tensor:
        cdt = self.compute_dtype
        with span("sr"):
            if isinstance(styles, torch.Tensor):
                styles = [styles]
            ws = [self.style(s.to(cdt)) for s in styles]
            if len(ws) == 1:
                split = self.n_latent
            elif inject_index is None:
                split = self.n_latent // 2
            else:
                split = int(inject_index)

            def latent(i):
                return ws[0] if i < split else ws[-1]

            noise = [None] * len(self.convs) if noise is None else list(noise)
            cond_list = self._encode(cond_img.to(cdt))
            out, skip = None, None
            for k, ci in enumerate(self.inject):
                i = 2 * k
                if k == 0:
                    out = self.comb_convs[str(ci)](cond_list[ci])
                elif ci is not None:
                    out = self.comb_convs[str(ci)](
                        torch.cat([out, cond_list[ci]], dim=1))
                out = self.convs[i](out, latent(i), noise[i])
                out = self.convs[i + 1](out, latent(i + 1), noise[i + 1])
                skip = self.to_rgbs[k](out, latent(i + 2), skip)
            return inverse_haar_transform(skip.float())
